"""K2: the line search of an iLQR iteration as a hand-written CUDA kernel,
instantiated for the quaternion SRB, the Euler SRB of the convex baseline
and the attitude model of falling_cat.

Replaces the region XLA fused for the JAX package at
`quaternion_mpc_tpu/solver/fleet.py:757-799`: `jax.vmap` of `rollout`
(:662-676) and `total_cost` (:388) over the alphas, the Armijo test, the
accept and the NaN-safe select. Eager PyTorch runs it (`solver.fleet.
line_search`, the plain version) as about a thousand launches an iteration;
the kernel runs it in one.

What bounds it on the H100: bytes at the fleet's sizes (`work`): the gains
Ks (N·nu·ne values a scenario) are most of what the function reads, and the
K rollouts' operations take less time at the card's peak. Each rollout is a
serial chain of N knots, so at small B latency sets the time.

Design (csrc/line_search.cu): a thread per (alpha, scenario), or two below
a full wave of blocks, a scenario's lanes side by side in a warp; each block
stages its scenarios' constants once and each knot's slab (xs_bar, us_bar,
K, d, the references, the multipliers) double-buffered into shared memory
with cp.async while its lanes roll the knot before; the pricing of xs_bar
spread over the scenario's lanes; every alpha's rollout kept as it is rolled
(in shared memory where it fits, else in a device-memory scratch this
wrapper allocates), and the selected one, or the old trajectory, written by
the whole block. The first passing alpha comes from a `__ballot_sync`.

Which spec runs it is a tag on the model that names it
(`FleetModelSpec.line_search`: "quat_srb", "euler_srb" or "attitude", set by
the fleet controllers' specs and carried from the model functions by
`solver.al_ilqr.fleet_spec`); the tag and the spec's integrator pick the
instantiation (`INSTANTIATIONS`, `instantiation`). Every other spec runs the
plain version. A tagged problem the kernel does not take (state rows Cx,
more than four feet, more than 32 alphas) raises on the card.

Source `csrc/line_search.cu`, compiled at first use with nvcc into `build/`
(`kernels.build`, keyed by a hash of source and flags) and bound with
ctypes. `line_search` takes the plain version `line_search_ref` for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quaternion_mpc_tpu_torch.kernels import build as _build

# Module import (not names): solver.fleet imports this module too.
from quaternion_mpc_tpu_torch.solver import fleet as _fl

SOURCE = _build.CSRC / "line_search.cu"
_ENTRY = {torch.float32: "line_search_f32", torch.float64: "line_search_f64"}
# The models K2 runs, by the tag their specs carry: (nx, ne, the quaternion's
# index in x or None, the model's parameters in the kernel's input table).
MODELS = {
    "quat_srb": (13, 12, 3, ("foot_pos", "inertia", "mass", "com_offset", "com_mass",
                             "rot_body_to_world")),
    "euler_srb": (12, 12, None, ("foot_pos", "inertia", "mass")),
    "attitude": (7, 6, 0, ("inertia",)),
}
# The kernel's instantiations, "<tag>_<integrator>", in the order of the
# source's enum Model (its index goes to the kernel in the flags).
INSTANTIATIONS = ("quat_srb_midpoint", "euler_srb_midpoint", "euler_srb_euler",
                  "attitude_midpoint")
MAX_FEET = 4
MAX_ALPHAS = 32  # the lanes of a warp
INPUTS = 24  # the kernel's input table (enum Input), then the alphas, done and the scratch
OUTPUTS = 7
_W_PER_KNOT, _CB_PER_KNOT, _PRICE, _MODEL_SHIFT = 1, 2, 4, 8
# the parameters, in their places in the input table (enum Input: IN_FOOT ...
# IN_ROT), and how each is read: its leading shape (n: the feet) or one value
_PARAM_SHAPES = {"foot_pos": ("n", 3), "inertia": (3, 3), "mass": None, "com_offset": (3,),
                 "com_mass": None, "rot_body_to_world": (3, 3)}


def instantiation(tag, integrator):
    """The name of the kernel's instantiation for a model ``tag`` stepped by
    ``integrator``, or None where the kernel has none (the plain version
    runs that spec)."""
    name = f"{tag}_{integrator}"
    return name if name in INSTANTIATIONS else None


# No fused multiply-add: each operation rounds as the plain version's do.
# Contracted, K2 met its checks against the plain version, but the f32
# walking fleet (chip_smoke.py, 300 ticks at 0.4 m/s, robots alike) fell
# where the plain version's stands; that loop's fate is set by rounding: with
# starts moved by 1e-6 m about half its robots stand, plain or kernel
# (PERF.md, K2's findings).
FLAGS = ("-fmad=false",)


def build():
    """Compile the kernel (kernels.build) with FLAGS; returns the library's path."""
    return _build.build(SOURCE, FLAGS)


def bind(path) -> ctypes.CDLL:
    """A build of the kernel (this source with other flags, or another source
    with the same C interface) loaded, its entries' argument types set, its
    tables' sizes checked against the wrapper's and its instantiations' tags
    against `INSTANTIATIONS` (a source without `line_search_tags`, the
    quaternion SRB's kernel before the others, has the first alone); they
    are kept as ``lib.instantiations``."""
    lib = ctypes.CDLL(str(path))
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    table = (ctypes.c_int * 2)()
    lib.line_search_table(table)
    if tuple(table) != (INPUTS, OUTPUTS):
        raise RuntimeError(f"{path} takes {tuple(table)} inputs and outputs, the "
                           f"wrapper {(INPUTS, OUTPUTS)}")
    tags = INSTANTIATIONS[:1]
    if hasattr(lib, "line_search_tags"):
        lib.line_search_tags.restype = ctypes.c_char_p
        tags = tuple(lib.line_search_tags().decode().split())
    if tags != INSTANTIATIONS[:len(tags)]:
        raise RuntimeError(f"{path} has the instantiations {tags}, the wrapper {INSTANTIATIONS}")
    lib.instantiations = tags
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build())


# Floating-point operations of the device code by model (each add, subtract,
# multiply, divide, sine and cosine once): the state difference x ⊖ x̄, and
# the step at n_feet feet (the quaternion SRB: forces and moment 15·n_feet − 6,
# the CoM moment, v̇, ω̇, two quaternion rates and the midpoint sums; the
# Euler SRB: forces and moment, v̇, then each evaluation of f 59 (sin, cos,
# the rpy rate, Rz·I⁻¹·Rzᵀ and ω̇) and the Euler or midpoint sums; the
# attitude model: each evaluation of f 66), and the constants a scenario
# stages (the inverse inertia 41; the quaternion SRB's g_body and CoM moment
# 15 more).
_OPS = {
    "quat_srb_midpoint": (40, lambda n_feet: 15 * n_feet + 113, 56),
    "euler_srb_midpoint": (12, lambda n_feet: 15 * n_feet + 167, 41),
    "euler_srb_euler": (12, lambda n_feet: 15 * n_feet + 83, 41),
    "attitude_midpoint": (34, lambda n_feet: 161, 41),
}


def _stage_ops(nx, nu, nc, quat):
    """Operations of a stage knot's AL cost: the state and input terms
    4·nx + 4·nu + 3 (+ 11 with a quaternion: the dot product and the
    geodesic term), the AL term nc·(2·nu + 7) + 5."""
    return 4 * nx + 4 * nu + 3 + 11 * quat + nc * (2 * nu + 7) + 5


def flops_per_knot(name: str, n_feet: int, nc: int) -> int:
    """Floating-point operations of one knot of one alpha's rollout and cost
    in instantiation ``name`` of the device code: the state difference, the
    input (2·ne + 3)·nu, the stage's AL cost (`_stage_ops`) and the step
    (`_OPS`). The quaternion SRB's: 224 + 31·nu + 15·n_feet + nc·(2·nu + 7)."""
    nx, ne, qi, _ = MODELS[name.rsplit("_", 1)[0]]
    nu = 3 * n_feet  # the attitude model's torques: one group of three
    diff, step, _ = _OPS[name]
    return diff + (2 * ne + 3) * nu + _stage_ops(nx, nu, nc, qi is not None) + step(n_feet)


def work(spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho, alphas) -> dict:
    """Bytes and floating-point operations that the function needs on these
    inputs (`line_search`'s arguments), for its bound on the card. Bytes:
    every input read once, a leaf of batch extent 1 once for all scenarios
    (of u_ref, cb and w only the rows the kernel reads, of the rotation its
    third row), and every output written once (xs, us, J, J_out, and a byte
    each of accepted and improved). Operations: K rollouts of N knots with
    their costs (`flops_per_knot`), each alpha's terminal cost and Armijo
    test (4·nx + 8, + 11 with a quaternion), the model's constants once a
    scenario (`_OPS`), and with J None the cost of xs_bar and us_bar (N
    stages and the terminal)."""
    table, (alphas, done), (N, B, K, n_feet, nc, flags) = check_inputs(
        spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho, alphas)
    name = INSTANTIATIONS[flags >> _MODEL_SHIFT]
    nx, ne, qi, _ = MODELS[spec.line_search]
    nu, quat, priced = us.shape[1], qi is not None, J is None
    w_rows = N + 1 if flags & _W_PER_KNOT else 1
    cb_rows = N * nc if flags & _CB_PER_KNOT else nc
    rows = ((N + 1) * nx, N * nu, N * nu * ne, N * nu, (N + 1) * nx, N * nu, nx, nx, nu,
            w_rows, nc * nu, cb_rows, N * nc, 3 * n_feet, 9, 1, 3, 1, 3, 1, 1, 1, 1, 1)
    itemsize = xs.element_size()
    read = sum(r * ld for r, (t, ld) in zip(rows, table) if t is not None)
    written = ((N + 1) * nx + N * nu + 2) * B
    stage, terminal = _stage_ops(nx, nu, nc, quat), 4 * nx + 2 + 11 * quat
    price = priced * (N * stage + terminal)
    return {
        "bytes": itemsize * (read + written + K) + 3 * B,  # + done, accepted, improved
        "flops": B * (K * (N * flops_per_knot(name, n_feet, nc) + terminal + 6)
                      + _OPS[name][2] + price),
    }


def _operand(t, lead, B, name, like, layout=None):
    """``t`` as the kernel reads it: contiguous, its batch axis B or 1 (a
    value every scenario shares; an axis of B broadcast with stride 0 is cut
    to 1), with the batch extent. Raises on another shape, type or device.
    ``like``: (dtype, device) every operand shares; ``layout``: how a
    tensor of the right shape is laid out for the kernel (`_layout`)."""
    shape = t.shape if isinstance(t, torch.Tensor) else None
    if shape is None or len(shape) != len(lead) + 1 or shape[-1] not in (1, B) \
            or shape[:-1] != lead:
        shape = tuple(shape) if shape is not None else type(t).__name__
        raise ValueError(f"{name} must have shape {tuple(lead)} + (B|1,) with B = {B}, got {shape}")
    return (layout or _layout)(t, B, name, like)


def _exact(t, shape, name, like, layout=None):
    """An operand with its batch axis always B: ``shape`` exactly."""
    if not isinstance(t, torch.Tensor) or t.shape != shape:
        got = tuple(t.shape) if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {got}")
    return (layout or _layout)(t, shape[-1], name, like)


def _scalar(t, B, name, like, layout=None):
    """A value a scenario (h, mass, ρ, ...): one shared value of any shape, or
    B values."""
    layout = layout or _layout
    if isinstance(t, torch.Tensor):
        n = t.numel()
        if n == 1:
            return layout(t if t.dim() == 1 else t.reshape(1), B, name, like)
        if n == B and t.shape[-1] == B:
            return layout(t if t.dim() == 1 else t.reshape(B), B, name, like)
    shape = tuple(t.shape) if isinstance(t, torch.Tensor) else type(t).__name__
    raise ValueError(f"{name} must be a tensor of one value or of B = {B}, got {shape}")


def _layout(t, B, name, like):
    """The type and device checks and the batch extent of an operand whose
    shape is right."""
    if t.dtype != like[0] or t.device != like[1]:
        raise ValueError(f"{name} is {t.dtype} on {t.device}; xs is {like[0]} on {like[1]}")
    if t.is_contiguous():  # a batch axis of B > 1 broadcast with stride 0 is not
        return t, t.shape[-1]
    if t.shape[-1] == B and B > 1 and t.stride(-1) == 0:
        t = t[..., :1]
    return t.contiguous(), t.shape[-1]


# How check_inputs takes each operand: its whole shape with the batch axis
# B, its leading axes with a batch axis of B or 1, or one value a scenario.
_EXACT, _LEAD, _SCALAR = 0, 1, 2


def param_operands(p, fields, n_feet):
    """The model's parameters ``p`` as operands (`input_table`), in the order
    of `_PARAM_SHAPES` (the kernels' input tables); those not in ``fields``
    (the model has none of them) are absent."""
    operands = []
    for field, shape in _PARAM_SHAPES.items():
        if field not in fields:
            operands.append((None, None, None, field))
        elif shape is None:
            operands.append((getattr(p, field), _SCALAR, None, field))
        else:
            shape = tuple(n_feet if n == "n" else n for n in shape)
            operands.append((getattr(p, field), _LEAD, shape, field))
    return operands


def input_table(operands, B, like, layout=None):
    """A kernel's input table from its operands, each (tensor or None, how it
    is taken: _EXACT, _LEAD or _SCALAR, or None for an operand absent from
    this launch; its shape; its name): (tensor as the kernel reads it, batch
    extent) pairs, (None, 1) for an absent operand. Raises ValueError on an
    operand of another shape, type or device than ``like`` = (dtype,
    device). ``layout`` lays a tensor out for the kernel (default `_layout`:
    contiguous)."""
    table = []
    for t, kind, shape, name in operands:
        if kind is None:
            table.append((None, 1))
        elif kind == _EXACT:
            table.append(_exact(t, shape, name, like, layout))
        elif kind == _LEAD:
            table.append(_operand(t, shape, B, name, like, layout))
        else:
            table.append(_scalar(t, B, name, like, layout))
    return table


def check_inputs(spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho, alphas):
    """Raise ValueError on a problem the kernel does not take; returns the
    kernel's input table (INPUTS (tensor, batch extent) pairs in the order of
    csrc/line_search.cu enum Input; J None, to be priced, and the parameters
    a model does not have are (None, 1)), then alphas and done, and (N, B, K,
    n_feet, nc, flags), the flags holding the instantiation's index. n_feet
    is 1 for the attitude model (its three torques)."""
    tag = spec.line_search
    if tag not in MODELS:
        raise ValueError(f"K2 runs the specs tagged {tuple(MODELS)}, not {tag!r}")
    name = instantiation(tag, spec.integrator)
    if name is None:
        raise ValueError(f"K2 has no instantiation for {tag!r} under the {spec.integrator!r} "
                         f"integrator (it has {INSTANTIATIONS})")
    nx, ne, qi, params = MODELS[tag]
    if (spec.nx, spec.ne, spec.quat_idx) != (nx, ne, qi):
        raise ValueError(
            f"K2 runs {tag!r} with nx {nx}, quaternion at {qi}; the spec has nx {spec.nx}, "
            f"quat_idx {spec.quat_idx}")
    if prob.Cx is not None:
        raise ValueError("K2 does not take state rows Cx in the inequality")
    if xs.dtype not in _ENTRY:
        raise ValueError(f"K2 takes float32 or float64, got {xs.dtype}")
    p = prob.params
    if tag == "attitude":
        n_feet, nu = 1, 3
        if spec.nu != nu:
            raise ValueError(f"K2 runs the attitude model with three torques, got nu = {spec.nu}")
    else:
        n_feet = p.foot_pos.shape[0]
        nu = 3 * n_feet
        if not 1 <= n_feet <= MAX_FEET or spec.nu != nu:
            raise ValueError(f"K2 takes 1 to {MAX_FEET} feet of 3 forces each, got {n_feet} "
                             f"feet for nu = {spec.nu}")
    if xs.dim() != 3 or xs.shape[1] != nx:
        raise ValueError(f"xs must be (N+1, {nx}, B), got {tuple(xs.shape)}")
    N, B = xs.shape[0] - 1, xs.shape[-1]
    K = alphas.shape[0] if alphas.dim() == 1 else 0
    if not 1 <= K <= MAX_ALPHAS:
        raise ValueError(f"K2 takes 1 to {MAX_ALPHAS} alphas (K,), got {tuple(alphas.shape)}")
    if N < 1:
        raise ValueError("K2 needs at least one knot")
    nc = prob.Cu.shape[0]
    w_per_knot = prob.w.dim() == 2
    cb_per_knot = prob.cb.dim() == 3
    like = (xs.dtype, xs.device)
    operands = [
        (xs, _EXACT, (N + 1, nx, B), "xs"),
        (us, _EXACT, (N, nu, B), "us"),
        (Ks, _EXACT, (N, nu, ne, B), "Ks"),
        (ds, _EXACT, (N, nu, B), "ds"),
        (prob.x_ref, _LEAD, (N + 1, nx), "x_ref"),
        (prob.u_ref, _LEAD, (N + 1, nu), "u_ref"),
        (prob.Qd, _LEAD, (nx,), "Qd"),
        (prob.Qd if prob.Qdf is None else prob.Qdf, _LEAD, (nx,), "Qdf"),
        (prob.Rd, _LEAD, (nu,), "Rd"),
        (prob.w, _LEAD, (N + 1,), "w") if w_per_knot else (prob.w, _SCALAR, None, "w"),
        (prob.Cu, _LEAD, (nc, nu), "Cu"),
        (prob.cb, _LEAD, (N + 1, nc) if cb_per_knot else (nc,), "cb"),
        (lam if lam.shape[0] == N else lam[:N], _LEAD, (N, nc), "lam"),
    ]
    operands += param_operands(p, params, n_feet)
    operands += [
        (prob.h, _SCALAR, None, "h"),
        (rho, _SCALAR, None, "rho"),
        (J, _EXACT if J is not None else None, (B,), "J"),
        (dV1, _EXACT, (B,), "dV1"),
        (dV2, _EXACT, (B,), "dV2"),
    ]
    table = input_table(operands, B, like)
    if tuple(done.shape) != (B,) or done.dtype != torch.bool or done.device != xs.device:
        raise ValueError(f"done must be ({B},) bool on {xs.device}, got {tuple(done.shape)} "
                         f"{done.dtype} on {done.device}")
    if alphas.dtype != xs.dtype or alphas.device != xs.device:
        raise ValueError(f"alphas are {alphas.dtype} on {alphas.device}; xs is {xs.dtype} on "
                         f"{xs.device}")
    flags = ((_W_PER_KNOT if w_per_knot else 0) | (_CB_PER_KNOT if cb_per_knot else 0)
             | (_PRICE if J is None else 0) | INSTANTIATIONS.index(name) << _MODEL_SHIFT)
    return table, (alphas.contiguous(), done.contiguous()), (N, B, K, n_feet, nc, flags)


def group_lanes(K):
    """The lanes a scenario takes in the kernel: the least power of two >= K."""
    return 1 << (K - 1).bit_length()


def new_outputs(dims, like, with_costs):
    """The kernel's outputs for a launch of ``dims`` (`check_inputs`' last
    item), uninitialised: xs (N+1, nx, B), us (N, nu, B), J and J_out (B,),
    accepted and improved (B,) bool, and the rollouts' costs (K, B) or None,
    carved out of one allocation of the type and one of bytes; then, in an
    allocation of its own that is freed once the launch is done with it, the
    trajectory scratch ((N+1)·nx + N·nu rows x B x G values, G =
    group_lanes(K)), where the kernel keeps every alpha's rollout when its
    block's shared memory cannot."""
    N, B, K, n_feet, _, flags = dims
    nx = MODELS[INSTANTIATIONS[flags >> _MODEL_SHIFT].rsplit("_", 1)[0]][0]
    nu = 3 * n_feet
    sizes = [(N + 1) * nx * B, N * nu * B, B, B, K * B if with_costs else 0]
    xs, us, J, J_out, costs = torch.empty(
        sum(sizes), dtype=like.dtype, device=like.device).split(sizes)
    accepted, improved = torch.empty(2 * B, dtype=torch.bool, device=like.device).split(B)
    scratch = torch.empty(((N + 1) * nx + N * nu) * B * group_lanes(K), dtype=like.dtype,
                          device=like.device)
    return (xs.view(N + 1, nx, B), us.view(N, nu, B), J, J_out, accepted, improved,
            costs.view(K, B) if with_costs else None), scratch


_IN_TABLE = ctypes.c_void_p * (INPUTS + 3)
_LD_TABLE = ctypes.c_longlong * INPUTS
_OUT_TABLE = ctypes.c_void_p * OUTPUTS


def c_tables(table, extras, outputs):
    """The C interface's three tables: the input pointers (the table's, then
    the alphas', done's and the scratch's), the inputs' batch extents and the
    output pointers (null for costs not asked for)."""
    pointers, extents = [], []
    for t, ld in table:
        pointers.append(None if t is None else t.data_ptr())
        extents.append(ld)
    pointers.extend(t.data_ptr() for t in extras)
    return (_IN_TABLE(*pointers), _LD_TABLE(*extents),
            _OUT_TABLE(*[None if t is None else t.data_ptr() for t in outputs]))


def line_search(spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho, alphas,
                with_costs=False):
    """The line search of one iLQR iteration (`solver.fleet.line_search`):
    with ``J`` None the AL cost of (xs, us) first, then the rollouts over
    every alpha, their AL costs, the Armijo test and the select. Returns
    (xs, us, J, J_out, accepted, improved), with ``with_costs`` also the
    rollouts' costs J_m (K, B). Tensors on the CPU take the plain version;
    on the card one launch."""
    device = xs.device
    if device.type == "cpu":
        return line_search_ref(spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho,
                               alphas, with_costs=with_costs)
    if device.type != "cuda":
        raise ValueError(f"line_search runs on cpu or cuda tensors, not {device}")
    outputs = launch(_lib(), spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho, alphas,
                     with_costs)
    line_search.launches += 1
    return outputs if with_costs else outputs[:6]


def launch(lib, spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho, alphas, with_costs):
    """One launch of the kernel in ``lib`` (`bind`) on the current stream,
    uncounted: (xs, us, J, J_out, accepted, improved, costs or None)."""
    table, (alphas, done), dims = check_inputs(
        spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho, alphas)
    N, B, K, n_feet, nc, flags = dims
    name = INSTANTIATIONS[flags >> _MODEL_SHIFT]
    if name not in lib.instantiations:
        raise ValueError(f"this build of K2 has {lib.instantiations}, not {name!r}")
    outputs, scratch = new_outputs(dims, xs, with_costs)
    tables = c_tables(table, (alphas, done, scratch), outputs)
    fn = getattr(lib, _ENTRY[xs.dtype])
    if xs.device.index == torch.cuda.current_device():
        err = fn(*tables, N, B, K, n_feet, nc, flags, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(xs.device):
            err = fn(*tables, N, B, K, n_feet, nc, flags, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"line_search kernel launch failed with CUDA error {err}")
    return outputs


line_search.launches = 0


def line_search_ref(spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho, alphas,
                    with_costs=False):
    """The plain version: `solver.fleet.line_search`, in plain PyTorch."""
    return _fl.line_search(spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho, alphas,
                           with_costs=with_costs)


def _cast(tree, dtype):
    """A problem, its parameters or a tensor with every floating leaf cast."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, tuple):
        return type(tree)(*(_cast(t, dtype) for t in tree))
    return tree


# A rollout whose quaternion leaves the unit sphere by more than this has run
# away: the reference's own bound on | |q| - 1 | for a held falling_cat start
# (tests/test_branch_configs.py). The exact dynamics keep |q| = 1; the
# midpoint rule inflates it at high rates, and the geodesic cost is unbounded
# below in |q|, so such a rollout amplifies rounding without bound (at the
# falling_cat fleet's first iteration, B=4096, the plain version's own f32
# and f64 costs part by up to 6.6e4 of scale there, and by more than 1e-4 of
# scale nowhere else; no quaternion-SRB rollout of the checked problems leaves
# the sphere by 1e-4).
RUNAWAY = 5e-3


def conditioned(spec, prob, kw):
    """The results of the line search on these inputs (``kw``:
    `line_search`'s arguments after spec and prob) that an implementation
    rounding in another order can be held to, from the plain version's
    rollouts in f32 and in f64 (the inputs cast both ways). A rollout runs
    away where its quaternion, while finite, leaves the unit sphere by more
    than `RUNAWAY` (never, for a state without a quaternion): in the inputs'
    type, or in the other where the inputs' type ends with a finite cost.
    Even the sign of its cost then depends on the rounding. Returns, on the
    CPU, ((K, B) bool: the costs J_k of the rollouts that do not run away;
    one that overflows at once, at a huge alpha, does not run away, and its
    cost must be non-finite on both sides; (B,) bool: the scenarios where
    the alpha the plain version selects in either type does not run away).
    `compare` takes a flip at a runaway rollout as a runaway case."""
    qi = spec.quat_idx
    runs = {}
    for dtype in (torch.float32, torch.float64):
        cast = {k: _cast(v, dtype) for k, v in kw.items()}
        p = _cast(prob, dtype)
        out = [t.detach().cpu() for t in line_search_ref(spec, p, **cast, with_costs=True)]
        ok = _fl.armijo_ok(out[2], out[6], *(cast[k].cpu() for k in ("dV1", "dV2", "alphas")))
        away = torch.zeros_like(ok)
        if qi is not None:
            xs, _ = _fl.rollout(spec, p, cast["xs"], cast["us"], cast["Ks"], cast["ds"],
                                cast["alphas"][:, None, None])
            off = (torch.linalg.vector_norm(xs[:, :, qi:qi + 4, :], dim=2) - 1.0).abs()
            away = (torch.where(torch.isfinite(off), off, 0.0) > RUNAWAY).any(1).cpu()
        # the first alpha that passes: no pass before it
        selected = ok & (torch.cumsum(ok.to(torch.int32), 0) == 1)
        runs[dtype] = (away, selected, torch.isfinite(out[6]))
    (away, sel, finite), (away_other, sel_other, _) = (
        runs[t] for t in sorted(runs, key=lambda t: t != kw["xs"].dtype))
    away = away | (away_other & finite)
    return ~away, ~((away & (sel | sel_other)).any(0))


def compare(got, want, dV1, dV2, alphas, rtol, held=None):
    """How one run of the line search stands against another on the same
    inputs (``got``, ``want``: (xs, us, J, J_out, accepted, improved,
    costs), as `line_search(..., with_costs=True)` returns them; ``want`` the
    plain version's), in the costs and the scenarios that ``held`` names
    (`conditioned`'s pair of masks; None: all of them). The costs are
    compared first, J (of the scenarios held) and each rollout's J_k (those
    held): the same ones non-finite, each finite one within ``rtol`` of
    max(|J_k|, |J|) of the plain version. Then, in the scenarios held, the
    decisions, each side's
    from its own J and costs by `solver.fleet.armijo_ok`: a scenario whose
    selected alpha or improvement differs is a flip, and a flip is a margin
    case when, at every alpha whose test differs, both sides' costs lie
    within that tolerance of their Armijo threshold (or, for the
    improvement, of their J), or that alpha's cost is not held (a runaway
    rollout: a runaway case). The outputs are compared in the other
    scenarios: xs and us relative to their largest magnitude there, J_out
    relative to max(|J_out|, |J|) of its scenario.

    Returns a dict: costs_err (J and J_k, relative, as held), xs_err,
    us_err, J_err, flips (scenario indices), margin_cases (bool: every flip
    is a margin or runaway case), runaway_cases (the flips at runaway
    rollouts), nonfinite_same and decisions_same (bool: accepted and improved
    agree outside the flips), set_aside (the costs not held) and
    set_aside_scenarios (the scenarios not held)."""
    xs_g, us_g, J_g, Jo_g, acc_g, imp_g, costs_g = got
    xs_w, us_w, J_w, Jo_w, acc_w, imp_w, costs_w = want
    to64 = lambda t: t.detach().to("cpu", torch.float64)
    cg, cw, Jg, Jw = to64(costs_g), to64(costs_w), to64(J_g), to64(J_w)
    fin_g, fin_w = torch.isfinite(cg), torch.isfinite(cw)
    if held is None:
        held = (torch.ones_like(fin_w), torch.ones_like(Jw, dtype=torch.bool))
    held, held_s = held[0].cpu(), held[1].cpu()
    scale = torch.maximum(cw.abs().nan_to_num(0.0, 0.0, 0.0), Jw.abs()[None, :])
    tol = rtol * scale
    both = fin_g & fin_w & held
    costs_err = max(float(torch.where(both, (cg - cw).abs() / scale.clamp(min=1e-300), 0.0).max()),
                    float(torch.where(held_s, (Jg - Jw).abs() / scale.max(0).values.clamp(min=1e-300),
                                      0.0).max()))
    a64, d1, d2 = to64(alphas), to64(dV1), to64(dV2)
    ok_g = _fl.armijo_ok(J_g, costs_g, dV1, dV2, alphas).cpu()
    ok_w = _fl.armijo_ok(J_w, costs_w, dV1, dV2, alphas).cpu()
    K = ok_g.shape[0]
    first = lambda ok: torch.where(ok.any(0), torch.argmax(ok.to(torch.int32), 0), K)
    f_g, f_w = first(ok_g), first(ok_w)
    flips = (((f_g != f_w) | (imp_g.cpu() != imp_w.cpu())) & held_s).nonzero().flatten().tolist()
    expected = -(a64[:, None] * d1[None, :] + (a64**2)[:, None] * d2[None, :])
    margin = lambda c, J: torch.where(expected > 0, (J[None, :] - c - 1e-4 * expected).abs(),
                                      (c - J[None, :]).abs()) <= tol
    margin_cases, runaway_cases = True, 0
    for b in flips:
        differ = (ok_g[:, b] != ok_w[:, b]).nonzero().flatten()
        runaway_cases += bool(len(differ)) and not bool(held[differ, b].all())
        for k in differ.tolist():
            margin_cases &= bool(not held[k, b] or (fin_g[k, b] and fin_w[k, b]
                                                    and margin(cg, Jg)[k, b]
                                                    and margin(cw, Jw)[k, b]))
        if len(differ) == 0:  # the same alpha, J_k < J decided otherwise
            k = int(f_w[b])
            margin_cases &= bool(abs(cg[k, b] - Jg[b]) <= tol[k, b]
                                 and abs(cw[k, b] - Jw[b]) <= tol[k, b])
    keep = held_s.clone()
    keep[flips] = False

    def err(g, w):
        g, w = to64(g)[..., keep], to64(w)[..., keep]
        return float((g - w).abs().max() / w.abs().max().clamp(min=1e-300)) if w.numel() else 0.0

    same = bool((acc_g.cpu() == acc_w.cpu())[keep].all() and (imp_g.cpu() == imp_w.cpu())[keep].all())
    og, ow = to64(Jo_g)[keep], to64(Jo_w)[keep]  # each relative to max(|J_out|, |J|), as the costs
    J_err = float(((og - ow).abs() / torch.maximum(ow.abs(), Jw[keep].abs()).clamp(min=1e-300))
                  .max()) if ow.numel() else 0.0
    return dict(costs_err=costs_err, xs_err=err(xs_g, xs_w), us_err=err(us_g, us_w),
                J_err=J_err, flips=flips, margin_cases=margin_cases, runaway_cases=runaway_cases,
                nonfinite_same=bool(((fin_g == fin_w) | ~held).all()), decisions_same=same,
                set_aside=int((~held).sum()), set_aside_scenarios=int((~held_s).sum()))
