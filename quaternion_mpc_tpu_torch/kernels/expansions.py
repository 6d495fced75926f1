"""K8: the knot expansions of the quaternion SRB's backward pass as a
hand-written CUDA kernel, one launch an iLQR iteration.

Replaces the region XLA fused for the JAX package at
`quaternion_mpc_tpu/solver/fleet.py:642` (`knot_expansions`: a `jax.vmap`
over the knots of the structured error-state Jacobian, models/srb.py:350-473,
and the cost expansion :471) and its `terminal_expansion` (:484). Eager
PyTorch runs it (the plain version: `solver.fleet.knot_expansions` and
`terminal_expansion`) as ~360 launches an iteration; the kernel writes the
same eight slabs, the inputs of K1 (`kernels.riccati_sweep`) and of K4's
fused entry (`kernels.assoc_scan.assoc_backward`), in one.

What bounds it on the H100: bytes (`work`). A stage knot writes 600 values
at 12 inputs, the dense slabs with their zeros, and reads ~80; the
operations, most of them ρ·Cuᵀ·diag(active)·Cu, take less time at the card's
peak.

Design (csrc/expansions.cu): a block takes one knot and 32 scenarios, a lane
each; its warps are the knot's pieces (the dynamics to As, the dynamics to
Bs, the state cost, and the AL rows over the tile's Cu in shared memory),
then, after a barrier that hands on λ̄ and the active rows, luu's rows and
lu's Cuᵀλ̄ dealt over every warp; blocks past the stage knots take the
terminal term, a tile of scenarios a warp. Batch-last outputs, so that a
warp's store is one row of neighbouring scenarios; the leaves every
scenario shares staged in shared memory once a block; everything in
registers in the block form of `models.srb.SrbEdjBlocks`. The inputs are
read through a row and a batch stride each (`c_tables`), so that the
batch-first model parameters (`models.srb.params_to_fleet`'s `movedim`) are
read in place, not copied. Built with -fmad=false (`FLAGS`); every value by
the operations PyTorch does for the plain version on the card, in its order
(long sums over four accumulators, the moment's cross products fused), so
that there at B > 1 the outputs equal the plain version's bit for bit: the
closed loops then take the steps they took before K8 (their f32 fate is set
by rounding: PERF.md).

Which spec runs it is a tag on the model (`FleetModelSpec.expansions`:
"quat_srb", set by the quaternion-MPC fleet spec and carried from the model
function by `solver.al_ilqr.fleet_spec` where the spec keeps its structured
Jacobian); `solver.fleet.backward_expansions` calls it for such a spec when
the problem has no state rows Cx (whose cross term the kernel does not
write). A tagged problem the kernel does not take (more than four feet, more
than `MAX_ROWS` inequality rows) raises on the card.

Source `csrc/expansions.cu`, compiled at first use with nvcc into `build/`
(`kernels.build`) and bound with ctypes. `knot_expansions` takes the plain
version `knot_expansions_ref` for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quaternion_mpc_tpu_torch.kernels import build as _build
from quaternion_mpc_tpu_torch.kernels import line_search as _k2

# Module import (not names): solver.fleet imports this module too.
from quaternion_mpc_tpu_torch.solver import fleet as _fl

SOURCE = _build.CSRC / "expansions.cu"
_ENTRY = {torch.float32: "expansions_f32", torch.float64: "expansions_f64"}
MODELS = ("quat_srb",)  # the tags K8 runs
NX, NE, QI = 13, 12, 3  # the quaternion SRB's state, error state, quaternion
MAX_FEET = 4
MAX_ROWS = 64  # inequality rows: the kernel keeps which are active as the bits of a word
INPUTS = 19  # the kernel's input table (enum Input)
OUTPUTS = 8
_W_PER_KNOT, _CB_PER_KNOT = 1, 2
_PARAMS = ("foot_pos", "inertia", "mass", "com_offset", "com_mass", "rot_body_to_world")

# No fused multiply-add but where PyTorch's own kernels fuse (the cross
# product): each operation rounds as the plain version's do on the card.
# With the index order of a sum (as on the CPU) K8 met its checks against the
# plain version, but the held f32 walking fleet of chip_smoke.py missed its
# bounds where the plain version's meets them (PERF.md, PR 16).
FLAGS = ("-fmad=false",)


def build():
    """Compile the kernel (kernels.build) with FLAGS; returns the library's path."""
    return _build.build(SOURCE, FLAGS)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel built and loaded (`bind`)."""
    return bind(build())


def bind(path) -> ctypes.CDLL:
    """A build of the kernel (this source with other flags, or another source
    with the same C interface) loaded, its entries' argument types set and
    its tables' sizes checked against the wrapper's."""
    lib = ctypes.CDLL(str(path))
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    table = (ctypes.c_int * 3)()
    lib.expansions_table(table)
    if tuple(table) != (INPUTS, OUTPUTS, MAX_ROWS):
        raise RuntimeError(f"{path} takes {tuple(table)} inputs, outputs and rows, the "
                           f"wrapper {(INPUTS, OUTPUTS, MAX_ROWS)}")
    return lib


def _strides(t):
    """(row stride, batch stride) of ``t`` (leading axes, then a batch axis)
    as the kernel reads it: element (row i of the leading axes flattened,
    scenario b) at i·row stride + b·batch stride; the batch stride 0 where the
    batch axis is 1. None where the leading axes do not step through memory
    evenly (the kernel then reads a contiguous copy). An empty ``t`` (no
    inequality rows) is never read."""
    if t.numel() == 0:
        return 1, 0
    extent, lead = t.shape[-1], list(zip(t.shape[:-1], t.stride()[:-1]))
    row, inner = None, 1
    for size, stride in reversed(lead):
        if size == 1:
            continue
        if row is None:
            row = stride
        if stride <= 0 or stride != row * inner:
            return None
        inner *= size
    return (1 if row is None else row), (t.stride(-1) if extent > 1 else 0)


def _view(t, B, name, like):
    """`line_search._layout` without its copy: ``t`` of the right shape as
    the kernel reads it, in place wherever `_strides` can describe it (a
    batch axis of B broadcast with stride 0 is cut to 1), else contiguous;
    with its batch extent."""
    if t.dtype != like[0] or t.device != like[1]:
        raise ValueError(f"{name} is {t.dtype} on {t.device}; xs is {like[0]} on {like[1]}")
    if t.shape[-1] == B and B > 1 and t.stride(-1) == 0:
        t = t[..., :1]
    if _strides(t) is None:
        t = t.contiguous()
    return t, t.shape[-1]


def check_inputs(spec, prob, xs, us, lam, rho):
    """Raise ValueError on a problem the kernel does not take; returns the
    kernel's input table (INPUTS (tensor, batch extent) pairs in the order
    of csrc/expansions.cu enum Input, each tensor read in place where its
    strides allow: `c_tables`) and (N, B, n_feet, nc, flags)."""
    if spec.expansions not in MODELS:
        raise ValueError(f"K8 runs the specs tagged {MODELS}, not {spec.expansions!r}")
    if (spec.nx, spec.ne, spec.quat_idx, spec.integrator) != (NX, NE, QI, "midpoint"):
        raise ValueError(
            f"K8 runs the quaternion SRB (nx {NX}, quaternion at {QI}, midpoint rule); the spec "
            f"has nx {spec.nx}, quat_idx {spec.quat_idx}, {spec.integrator!r}")
    if prob.Cx is not None:
        raise ValueError("K8 does not take state rows Cx in the inequality (their cross term "
                         "lux): the plain expansions run such a problem")
    if xs.dtype not in _ENTRY:
        raise ValueError(f"K8 takes float32 or float64, got {xs.dtype}")
    p = prob.params
    n_feet = p.foot_pos.shape[0]
    nu = 3 * n_feet
    if not 1 <= n_feet <= MAX_FEET or spec.nu != nu:
        raise ValueError(f"K8 takes 1 to {MAX_FEET} feet of 3 forces each, got {n_feet} feet "
                         f"for nu = {spec.nu}")
    if xs.dim() != 3 or xs.shape[1] != NX:
        raise ValueError(f"xs must be (N+1, {NX}, B), got {tuple(xs.shape)}")
    N, B = xs.shape[0] - 1, xs.shape[-1]
    if N < 1:
        raise ValueError("K8 needs at least one knot")
    nc = prob.Cu.shape[0]
    if nc > MAX_ROWS:
        raise ValueError(f"K8 takes at most {MAX_ROWS} inequality rows, got {nc}")
    w_per_knot = prob.w.dim() == 2
    cb_per_knot = prob.cb.dim() == 3
    E, L, S = _k2._EXACT, _k2._LEAD, _k2._SCALAR
    operands = [
        (xs, E, (N + 1, NX, B), "xs"),
        (us, E, (N, nu, B), "us"),
        (prob.x_ref, L, (N + 1, NX), "x_ref"),
        (prob.u_ref, L, (N + 1, nu), "u_ref"),
        (prob.Qd, L, (NX,), "Qd"),
        (prob.Qd if prob.Qdf is None else prob.Qdf, L, (NX,), "Qdf"),
        (prob.Rd, L, (nu,), "Rd"),
        (prob.w, L, (N + 1,), "w") if w_per_knot else (prob.w, S, None, "w"),
        (prob.Cu, L, (nc, nu), "Cu"),
        (prob.cb, L, (N + 1, nc) if cb_per_knot else (nc,), "cb"),
        (lam if lam.shape[0] == N else lam[:N], L, (N, nc), "lam"),
        *_k2.param_operands(p, _PARAMS, n_feet),
        (prob.h, S, None, "h"),
        (rho, S, None, "rho"),
    ]
    table = _k2.input_table(operands, B, (xs.dtype, xs.device), _view)
    flags = (_W_PER_KNOT if w_per_knot else 0) | (_CB_PER_KNOT if cb_per_knot else 0)
    return table, (N, B, n_feet, nc, flags)


def new_outputs(dims, like):
    """The kernel's eight outputs for a launch of ``dims`` (`check_inputs`'
    last item), uninitialised and carved out of one allocation: As (N, 12,
    12, B), Bs (N, 12, nu, B), lxs (N, 12, B), lxxs (N, 12, 12, B), lus (N,
    nu, B), luus (N, nu, nu, B), lxN (12, B), lxxN (12, 12, B)."""
    N, B, n_feet, _, _ = dims
    nu = 3 * n_feet
    shapes = ((N, NE, NE, B), (N, NE, nu, B), (N, NE, B), (N, NE, NE, B), (N, nu, B),
              (N, nu, nu, B), (NE, B), (NE, NE, B))
    sizes = [torch.Size(s).numel() for s in shapes]
    flat = torch.empty(sum(sizes), dtype=like.dtype, device=like.device)
    return tuple(t.view(s) for t, s in zip(flat.split(sizes), shapes))


# Floating-point operations of the device code (each add, subtract,
# multiply and divide once; a negation or a select none), recounted from the
# code by tests/test_torch_expansions_emulation.py on a counting number type.
# The state cost's expansion (`_state_expansion_structured`): 148, at every
# stage knot and at the terminal. A stage knot's dynamics: the inverse
# inertia 41 and 1/m, the moment 12·n_feet − 3 and the CoM moment 18, the
# midpoint pieces q_m and ω_m 53 and ½h, ½h², the two ½R 24 and two ½G 24,
# D_qq 176, D_qq·G 84, D_qω 120, A_phi and A_pw 126, then Bs 69 a column.
STATE_FLOPS = 148
_DYNAMICS_FLOPS = 666
# Operations that the Bs piece of a stage knot computes again beside the As
# piece's (the inverse inertia 41, ½h and ½h², q_m 32, ½G(q_m) 12): on the
# card, not in `flops_per_knot` or `work`, which count the function's.
RECOMPUTED_FLOPS = 87


def flops_per_knot(n_feet: int, nc: int) -> int:
    """Floating-point operations of one stage knot of one scenario: the
    dynamics, the state cost, and the input cost with its AL terms (c, λ̄ and
    Cuᵀλ̄ nc·(4·nu + 2) − nu, lu 2·nu or 3·nu, luu nu·(nc·(2·nu + 1) + nu))."""
    nu = 3 * n_feet
    dynamics = _DYNAMICS_FLOPS + 219 * n_feet
    if nc == 0:
        return dynamics + STATE_FLOPS + 2 * nu
    inputs = nc * (4 * nu + 2) - nu + 3 * nu + nu * (nc * (2 * nu + 1) + nu)
    return dynamics + STATE_FLOPS + inputs


def work(spec, prob, xs, us, lam, rho) -> dict:
    """Bytes and floating-point operations that the function needs on these
    inputs (`knot_expansions`' arguments), for its bound on the card. Bytes:
    every input read once, a leaf of batch extent 1 once for all scenarios
    (of u_ref and a per-knot cb only the N stage rows, of the rotation its
    third row; Qdf only where the problem has one), and every output written
    once. Operations: N stage knots and the terminal (`flops_per_knot`,
    `STATE_FLOPS`) a scenario."""
    table, (N, B, n_feet, nc, flags) = check_inputs(spec, prob, xs, us, lam, rho)
    nu = 3 * n_feet
    rows = ((N + 1) * NX, N * nu, (N + 1) * NX, N * nu, NX,
            NX if prob.Qdf is not None else 0, nu, N + 1 if flags & _W_PER_KNOT else 1,
            nc * nu, N * nc if flags & _CB_PER_KNOT else nc, N * nc,
            3 * n_feet, 9, 1, 3, 1, 3, 1, 1)
    read = sum(r * ld for r, (_, ld) in zip(rows, table))
    written = (N * (2 * NE * NE + NE * nu + NE + nu + nu * nu) + NE + NE * NE) * B
    return {"bytes": xs.element_size() * (read + written),
            "flops": B * (N * flops_per_knot(n_feet, nc) + STATE_FLOPS)}


_IN_TABLE = ctypes.c_void_p * INPUTS
_STRIDE_TABLE = ctypes.c_longlong * (2 * INPUTS)
_OUT_TABLE = ctypes.c_void_p * OUTPUTS


def c_tables(table, outputs):
    """The C interface's three tables: the input pointers, each input's
    (row stride, batch stride) (`_strides`) and the output pointers."""
    return (_IN_TABLE(*[t.data_ptr() for t, _ in table]),
            _STRIDE_TABLE(*[s for t, _ in table for s in _strides(t)]),
            _OUT_TABLE(*[t.data_ptr() for t in outputs]))


def knot_expansions(spec, prob, xs, us, lam, rho):
    """The backward pass's expansions of a quaternion-SRB problem without
    state rows at (xs, us): (As, Bs, lxs, lxxs, lus, luus, lxN, lxxN), the
    stage knots' and the terminal's. Tensors on the CPU take the plain
    version; on the card one launch."""
    device = xs.device
    if device.type == "cpu":
        return knot_expansions_ref(spec, prob, xs, us, lam, rho)
    if device.type != "cuda":
        raise ValueError(f"knot_expansions runs on cpu or cuda tensors, not {device}")
    table, dims = check_inputs(spec, prob, xs, us, lam, rho)
    outputs = new_outputs(dims, xs)
    fn = getattr(_lib(), _ENTRY[xs.dtype])
    tables = c_tables(table, outputs)
    if device.index == torch.cuda.current_device():
        err = fn(*tables, *dims, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*tables, *dims, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"expansions kernel launch failed with CUDA error {err}")
    knot_expansions.launches += 1
    return outputs


knot_expansions.launches = 0


def knot_expansions_ref(spec, prob, xs, us, lam, rho):
    """The plain version: `solver.fleet.knot_expansions` and
    `terminal_expansion`, in plain PyTorch."""
    return (*_fl.knot_expansions(spec, prob, xs, us, lam, rho),
            *_fl.terminal_expansion(spec, xs[-1], prob))
