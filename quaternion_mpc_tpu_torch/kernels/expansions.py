"""K8: the knot expansions of the backward pass as a hand-written CUDA
kernel, one launch an iLQR iteration, instantiated for the quaternion SRB,
the Euler SRB of the convex baseline and the attitude model of falling_cat.

Replaces the region XLA fused for the JAX package at
`quaternion_mpc_tpu/solver/fleet.py:642` (`knot_expansions`: a `jax.vmap`
over the knots of the error-state Jacobian, the quaternion SRB's structured
one, models/srb.py:350-473, or the generic discretise-then-project path
:491-502, and the cost expansion :471) and its `terminal_expansion` (:484).
Eager PyTorch runs it (the plain version: `solver.fleet.knot_expansions` and
`terminal_expansion`) as ~360 launches an iteration for the quaternion SRB,
~1k for the Euler SRB and ~1.5k for the attitude model, whose Jacobian
`torch.func.jacfwd` computes; the kernel writes the same eight slabs, the
inputs of K1 (`kernels.riccati_sweep`) and of K4's fused entry
(`kernels.assoc_scan.assoc_backward`), in one.

What bounds it on the H100: bytes (`work`). A stage knot of an SRB writes
600 values at 12 inputs, the dense slabs with their zeros, and reads ~80;
the operations, most of them ρ·Cuᵀ·diag(active)·Cu (the attitude model's
its dense 7-wide products), take less time at the card's peak.

Design (csrc/expansions.cu): a block takes one knot and 32 scenarios, a lane
each; its warps are the knot's pieces (the dynamics to As, the dynamics to
Bs, the state cost, and the AL rows over the tile's Cu in shared memory),
then, after a barrier that hands on λ̄ and the active rows, luu's rows and
lu's Cuᵀλ̄ dealt over every warp; blocks past the stage knots take the
terminal term, a tile of scenarios a warp. Batch-last outputs, so that a
warp's store is one row of neighbouring scenarios; the leaves every
scenario shares staged in shared memory once a block; everything in
registers. The model is a template argument: its sizes, its two dynamics
pieces and its block's shape. The inputs are read through a row and a batch
stride each (`c_tables`), so that the batch-first model parameters
(`models.srb.params_to_fleet`'s `movedim`) are read in place, not copied.
Built with -fmad=false (`FLAGS`); every value by the operations PyTorch does
for the plain version on the card, in its order (long sums over four
accumulators, cross products fused), so that there at B > 1 the SRBs'
outputs equal the plain version's bit for bit: the closed loops then take
the steps they took before K8 (their f32 fate is set by rounding: PERF.md).
The attitude model's Jacobian is written by hand as forward-mode
differentiation computes it, and its products dense, zeros included: its
outputs are the plain version's to rounding, with non-finite values in the
same elements.

Which spec runs it is a tag on the model (`FleetModelSpec.expansions`:
"quat_srb", "euler_srb" or "attitude", set by the fleet controllers' specs
and carried from the model function by `solver.al_ilqr.fleet_spec` where
K8 has an instantiation for the spec's integrator and the spec's Jacobian
is the one it computes: `jacobian_is_the_models`); the tag and the
integrator pick the instantiation (`INSTANTIATIONS`, `instantiation`).
`solver.fleet.backward_expansions` calls it for such a spec when the
problem has no state rows Cx (whose cross term the kernel does not write).
A tagged problem the kernel does not take (more than four feet, more than
`MAX_ROWS` inequality rows) raises on the card.

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
# The kernel's instantiations, "<tag>_<integrator>", in the order of the
# source's enum Model (its index goes to the kernel in the flags). The models
# and their sizes are K2's (`line_search.MODELS`: nx, ne, the quaternion's
# index, the parameters in the input table).
INSTANTIATIONS = ("quat_srb_midpoint", "euler_srb_midpoint", "euler_srb_euler",
                  "attitude_midpoint")
MODELS = _k2.MODELS
MAX_FEET = 4
MAX_ROWS = 64  # inequality rows: the kernel keeps which are active as the bits of a word
INPUTS = 19  # the kernel's input table (enum Input)
OUTPUTS = 8
_W_PER_KNOT, _CB_PER_KNOT, _MODEL_SHIFT = 1, 2, 8


def instantiation(tag, integrator):
    """The name of the kernel's instantiation for a model ``tag`` stepped by
    ``integrator``, or None where the kernel has none (the plain version
    runs that spec)."""
    name = f"{tag}_{integrator}"
    return name if name in INSTANTIATIONS else None


def jacobian_is_the_models(tag, fj, edj) -> bool:
    """Whether a spec of the model ``tag`` with continuous Jacobian ``fj``
    and structured Jacobian ``edj`` asks for the Jacobian K8 computes: the
    quaternion SRB's structured one (``edj`` given), the Euler SRB's
    reference approximation (``fj`` is `models.srb.euler_srb_jacobian`, or
    its fleet form), the attitude model's derivative (no ``fj``: the plain
    version differentiates f). A spec with another Jacobian keeps the plain
    expansions: K8 would compute one the spec did not ask for."""
    from quaternion_mpc_tpu_torch.models import srb

    if tag == "quat_srb":
        return edj is not None
    if tag == "euler_srb":
        return fj is srb.euler_srb_jacobian or fj is srb.euler_srb_jacobian_fleet
    return tag == "attitude" and fj is None


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
    with the same C interface) loaded, its entries' argument types set, its
    tables' sizes checked against the wrapper's and its instantiations' tags
    against `INSTANTIATIONS` (a source without `expansions_tags`, the
    quaternion SRB's kernel before the others, has the first alone); they
    are kept as ``lib.instantiations``."""
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
    tags = INSTANTIATIONS[:1]
    if hasattr(lib, "expansions_tags"):
        lib.expansions_tags.restype = ctypes.c_char_p
        tags = tuple(lib.expansions_tags().decode().split())
    if tags != INSTANTIATIONS[:len(tags)]:
        raise RuntimeError(f"{path} has the instantiations {tags}, the wrapper {INSTANTIATIONS}")
    lib.instantiations = tags
    return lib


def _model(flags):
    """(instantiation, nx, ne, quaternion index) of a launch's flags."""
    name = INSTANTIATIONS[flags >> _MODEL_SHIFT]
    nx, ne, qi, _ = MODELS[name.rsplit("_", 1)[0]]
    return name, nx, ne, qi


def check_inputs(spec, prob, xs, us, lam, rho):
    """Raise ValueError on a problem the kernel does not take; returns the
    kernel's input table (INPUTS (tensor, batch extent) pairs in the order
    of csrc/expansions.cu enum Input, each tensor read in place where its
    strides allow: `c_tables`; (None, 1) for a parameter the model has not)
    and (N, B, n_feet, nc, flags), the flags holding the instantiation's
    index. n_feet is 1 for the attitude model (its three torques)."""
    tag = spec.expansions
    if tag not in MODELS:
        raise ValueError(f"K8 runs the specs tagged {tuple(MODELS)}, not {tag!r}")
    name = instantiation(tag, spec.integrator)
    if name is None:
        raise ValueError(f"K8 has no instantiation for {tag!r} under the {spec.integrator!r} "
                         f"integrator (it has {INSTANTIATIONS})")
    nx, ne, qi, params = MODELS[tag]
    if (spec.nx, spec.ne, spec.quat_idx) != (nx, ne, qi):
        raise ValueError(
            f"K8 runs {tag!r} with nx {nx}, quaternion at {qi}; the spec has nx {spec.nx}, "
            f"quat_idx {spec.quat_idx}")
    if prob.Cx is not None:
        raise ValueError("K8 does not take state rows Cx in the inequality (their cross term "
                         "lux): the plain expansions run such a problem")
    if xs.dtype not in _ENTRY:
        raise ValueError(f"K8 takes float32 or float64, got {xs.dtype}")
    p = prob.params
    if tag == "attitude":
        n_feet, nu = 1, 3
        if spec.nu != nu:
            raise ValueError(f"K8 runs the attitude model with three torques, got nu = {spec.nu}")
    else:
        n_feet = p.foot_pos.shape[0]
        nu = 3 * n_feet
        if not 1 <= n_feet <= MAX_FEET or spec.nu != nu:
            raise ValueError(f"K8 takes 1 to {MAX_FEET} feet of 3 forces each, got {n_feet} "
                             f"feet for nu = {spec.nu}")
    if xs.dim() != 3 or xs.shape[1] != nx:
        raise ValueError(f"xs must be (N+1, {nx}, B), got {tuple(xs.shape)}")
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
        (xs, E, (N + 1, nx, B), "xs"),
        (us, E, (N, nu, B), "us"),
        (prob.x_ref, L, (N + 1, nx), "x_ref"),
        (prob.u_ref, L, (N + 1, nu), "u_ref"),
        (prob.Qd, L, (nx,), "Qd"),
        (prob.Qd if prob.Qdf is None else prob.Qdf, L, (nx,), "Qdf"),
        (prob.Rd, L, (nu,), "Rd"),
        (prob.w, L, (N + 1,), "w") if w_per_knot else (prob.w, S, None, "w"),
        (prob.Cu, L, (nc, nu), "Cu"),
        (prob.cb, L, (N + 1, nc) if cb_per_knot else (nc,), "cb"),
        (lam if lam.shape[0] == N else lam[:N], L, (N, nc), "lam"),
        *_k2.param_operands(p, params, n_feet),
        (prob.h, S, None, "h"),
        (rho, S, None, "rho"),
    ]
    table = _k2.input_table(operands, B, (xs.dtype, xs.device), _k2.view)
    flags = ((_W_PER_KNOT if w_per_knot else 0) | (_CB_PER_KNOT if cb_per_knot else 0)
             | INSTANTIATIONS.index(name) << _MODEL_SHIFT)
    return table, (N, B, n_feet, nc, flags)


def new_outputs(dims, like):
    """The kernel's eight outputs for a launch of ``dims`` (`check_inputs`'
    last item), uninitialised and carved out of one allocation: As (N, ne,
    ne, B), Bs (N, ne, nu, B), lxs (N, ne, B), lxxs (N, ne, ne, B), lus (N,
    nu, B), luus (N, nu, nu, B), lxN (ne, B), lxxN (ne, ne, B)."""
    N, B, n_feet, _, flags = dims
    ne, nu = _model(flags)[2], 3 * n_feet
    shapes = ((N, ne, ne, B), (N, ne, nu, B), (N, ne, B), (N, ne, ne, B), (N, nu, B),
              (N, nu, nu, B), (ne, B), (ne, ne, B))
    sizes = [torch.Size(s).numel() for s in shapes]
    flat = torch.empty(sum(sizes), dtype=like.dtype, device=like.device)
    return tuple(t.view(s) for t, s in zip(flat.split(sizes), shapes))


# Floating-point operations of the device code (each add, subtract,
# multiply, divide, sine and cosine once; a negation or a select none),
# recounted from the code by tests/test_torch_expansions_emulation.py on a
# counting number type.
# The state cost's expansion (`_state_expansion_structured`), at every stage
# knot and at the terminal: the quaternion SRB 148, the Euler SRB 24 (g
# alone), the attitude model 136.
STATE_FLOPS = {"quat_srb": 148, "euler_srb": 24, "attitude": 136}
# A stage knot's dynamics (As and Bs) at n_feet feet:
# - the quaternion SRB: the inverse inertia 41 and 1/m, the moment 12·n_feet
#   − 3 and the CoM moment 18, the midpoint pieces q_m and ω_m 53 and ½h,
#   ½h², the two ½R 24 and two ½G 24, D_qq 176, D_qq·G 84, D_qω 120, A_phi
#   and A_pw 126, then Bs 69 a column;
# - the Euler SRB, midpoint: As 12·n_feet + 105 (the moment, the inverse
#   inertia, ½h, two sines and cosines, W's first two rows 30, ω_m 14, the
#   midpoint's yaw, Am's two yaw rows and their eight products by h), Bs 43
#   (W's last row, W at the midpoint 36, 1/m) and 48 a column (W·S at both
#   yaws 30, the rows 0..2 12, then 6);
# - the Euler SRB, forward Euler: As 14 (a sine and cosine, the yaw rows, six
#   products by h), Bs 78 (the inverse inertia, W 36, 1/m) and 19 a column;
# - the attitude model: As 2,105 (the inverse inertia, f and x_m 81, the
#   Jacobian at x and at x_m 120 each, I + ½h·A 36, Ad 693, Ad·E(x) 546,
#   E(x1)ᵀ·(Ad·E(x)) 468), Bs 570 (Bd 336, E(x1)ᵀ·Bd 234).
_DYNAMICS_FLOPS = {
    "quat_srb_midpoint": lambda n_feet: 666 + 219 * n_feet,
    "euler_srb_midpoint": lambda n_feet: 148 + 156 * n_feet,
    "euler_srb_euler": lambda n_feet: 92 + 57 * n_feet,
    "attitude_midpoint": lambda n_feet: 2675,
}
# Operations that the Bs piece of a stage knot computes again beside the As
# piece's: on the card, not in `flops_per_knot` or `work`, which count the
# function's. The quaternion SRB: the inverse inertia 41, ½h and ½h², q_m 32,
# ½G(q_m) 12; the Euler SRB, midpoint: the inverse inertia, ½h, both yaws'
# sines and cosines and the midpoint's yaw, W's first two rows 30; forward
# Euler: the sine and cosine; the attitude model: the inverse inertia, f and
# x_m, the Jacobian at x_m.
RECOMPUTED_FLOPS = {"quat_srb_midpoint": 87, "euler_srb_midpoint": 78, "euler_srb_euler": 2,
                    "attitude_midpoint": 242}


def flops_per_knot(name: str, n_feet: int, nc: int) -> int:
    """Floating-point operations of one stage knot of one scenario in
    instantiation ``name``: the dynamics, the state cost, and the input cost
    with its AL terms (c, λ̄ and Cuᵀλ̄ nc·(4·nu + 2) − nu, lu 2·nu or 3·nu,
    luu nu·(nc·(2·nu + 1) + nu)); n_feet 1 for the attitude model."""
    nu = 3 * n_feet
    fixed = _DYNAMICS_FLOPS[name](n_feet) + STATE_FLOPS[name.rsplit("_", 1)[0]]
    if nc == 0:
        return fixed + 2 * nu
    return fixed + nc * (4 * nu + 2) - nu + 3 * nu + nu * (nc * (2 * nu + 1) + nu)


def work(spec, prob, xs, us, lam, rho) -> dict:
    """Bytes and floating-point operations that the function needs on these
    inputs (`knot_expansions`' arguments), for its bound on the card. Bytes:
    every input read once, a leaf of batch extent 1 once for all scenarios
    (of u_ref and a per-knot cb only the N stage rows, of the rotation its
    third row; Qdf only where the problem has one; w only where the state
    holds a quaternion), and every output written once. Operations: N stage
    knots and the terminal (`flops_per_knot`, `STATE_FLOPS`) a scenario."""
    table, (N, B, n_feet, nc, flags) = check_inputs(spec, prob, xs, us, lam, rho)
    name, nx, ne, qi = _model(flags)
    nu = 3 * n_feet
    w_rows = 0 if qi is None else N + 1 if flags & _W_PER_KNOT else 1
    rows = ((N + 1) * nx, N * nu, (N + 1) * nx, N * nu, nx,
            nx if prob.Qdf is not None else 0, nu, w_rows,
            nc * nu, N * nc if flags & _CB_PER_KNOT else nc, N * nc,
            3 * n_feet, 9, 1, 3, 1, 3, 1, 1)
    read = sum(r * ld for r, (t, ld) in zip(rows, table) if t is not None)
    written = (N * (2 * ne * ne + ne * nu + ne + nu + nu * nu) + ne + ne * ne) * B
    state = STATE_FLOPS[name.rsplit("_", 1)[0]]
    return {"bytes": xs.element_size() * (read + written),
            "flops": B * (N * flops_per_knot(name, n_feet, nc) + state)}


_IN_TABLE = ctypes.c_void_p * INPUTS
_STRIDE_TABLE = ctypes.c_longlong * (2 * INPUTS)
_OUT_TABLE = ctypes.c_void_p * OUTPUTS


def c_tables(table, outputs):
    """The C interface's three tables: the input pointers (null for a
    parameter the model has not), each input's (row stride, batch stride)
    (`line_search.strides`) and the output pointers."""
    return (_IN_TABLE(*[None if t is None else t.data_ptr() for t, _ in table]),
            _STRIDE_TABLE(*[s for t, _ in table for s in _k2.strides(t)]),
            _OUT_TABLE(*[t.data_ptr() for t in outputs]))


def knot_expansions(spec, prob, xs, us, lam, rho):
    """The backward pass's expansions of a problem of a K8 model without
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
