"""K9: the solve's open-loop rollout and the AL pricing of a trajectory (its
final cost and the multiplier update) as a hand-written CUDA kernel,
instantiated for K2's models: the quaternion SRB, the Euler SRB of the
convex baseline and the attitude model of falling_cat.

Replaces the regions XLA fused for the JAX package at
`quaternion_mpc_tpu/solver/fleet.py:728-732` (the `init_step` `lax.scan` of
the open-loop rollout), `:829-831` (`total_cost`, :388, of the final
trajectory) and `:815-818` (the multiplier update). Eager PyTorch runs them
(the plain versions: `solver.fleet.open_loop_rollout`, `total_cost` and
`constraint_values`) as ~130 launches a knot of the rollout and ~200-530 a
pricing; together they were ~86% of a fleet solve's launches outside K1, K2
and K8 (PERF.md). Two entries:

- `rollout(spec, prob, us)`: xs (N+1, nx, B) from prob.x0, one launch;
- `price(spec, prob, xs, us, lam, rho, cost=True, lam_bar=False)`: the AL
  cost J (B,) of (xs, us) and, where asked, the updated multipliers λ̄ =
  max(λ + ρ·(Cu·u + cb), 0) (N, nc, B), one launch. ``lam`` None prices
  with zero multipliers (the solver's final cost, at ρ = 1e-30).

What bounds it on the H100: bytes (`rollout_work`, `price_work`); below
them the rollout's latency floor is one scenario's serial chain of N
`advance`s, which the bytes bound does not state (PERF.md records it from
`k1_phase_clocks.py k9`).

Design (csrc/rollout.cu): the rollout splits each model's step
(csrc/step_models.cuh `drive` and `advance`), computes every knot's drive,
what the inputs set alone, at once off the chain, a thread a (knot,
scenario), and then runs each scenario's chain of advances from shared
memory, x in registers, each xs row written coalesced along the batch; the
pricing gives a knot of a scenario four lanes of a warp, lane q the
inequality rows r ≡ q (mod 4) (torch_sum's accumulators, combined by
shuffles), with the tile's Cu, cb and λ staged in shared memory by cp.async;
the final cost sums a tile's knots in one block, the multiplier update runs
a grid over (tile, knot group). Blocks are planned from B and the card's
SMs (`plans` reads a build's plans). Built with -fmad=false (`FLAGS`); the
models' steps are K2's with PyTorch's rounding of the cross products and
its sine and cosine, and every sum in the order of PyTorch's CUDA
reduction, so that at B > 1 xs, λ̄ and J equal the plain versions' bit for
bit on the card: the closed loops, whose f32 fate is set by rounding, take
the steps they took before (PERF.md). Every input is read through a row and
a batch stride (`line_search.strides`): the batch-first model parameters
are read in place.

Which spec runs it: one tagged for K2 (`FleetModelSpec.line_search`) whose
instantiation exists (`instantiation`), solving a problem without state rows
Cx; `solver.fleet.make_fleet_solver` calls it there and the plain versions
for every other. Source `csrc/rollout.cu`, compiled at first use with nvcc
into `build/` (`kernels.build`) and bound with ctypes. Tensors on the CPU
take the plain versions; on the card each entry launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from quaternion_mpc_tpu_torch.kernels import build as _build
from quaternion_mpc_tpu_torch.kernels import line_search as _k2

# Module import (not names): solver.fleet imports this module too.
from quaternion_mpc_tpu_torch.solver import fleet as _fl

SOURCE = _build.CSRC / "rollout.cu"
_ENTRY = {(False, torch.float32): "rollout_f32", (False, torch.float64): "rollout_f64",
          (True, torch.float32): "price_f32", (True, torch.float64): "price_f64"}
# The kernel's instantiations, "<tag>_<integrator>", in the order of
# csrc/step_models.cuh enum Model (its index goes to the kernel in the
# flags): K2's, the same structs. The models and their sizes are K2's
# (`line_search.MODELS`).
INSTANTIATIONS = ("quat_srb_midpoint", "euler_srb_midpoint", "euler_srb_euler",
                  "attitude_midpoint")
MAX_FEET = 4
INPUTS = 19  # the kernel's input table (enum Input)
OUTPUTS = 3  # xs, J, λ̄
_W_PER_KNOT, _CB_PER_KNOT, _MODEL_SHIFT = 1, 2, 8

# No fused multiply-add but where PyTorch's own kernels fuse (the cross
# product): each operation rounds as the plain version's do on the card, so
# that the closed loops fed by xs and λ̄ keep their steps (K2's and K8's
# findings, PERF.md).
FLAGS = ("-fmad=false",)


def instantiation(tag, integrator):
    """The name of the kernel's instantiation for a model ``tag`` stepped by
    ``integrator``, or None where the kernel has none."""
    name = f"{tag}_{integrator}"
    return name if name in INSTANTIATIONS else None


def build():
    """Compile the kernel (kernels.build) with FLAGS; returns the library's path."""
    return _build.build(SOURCE, FLAGS)


def bind(path) -> ctypes.CDLL:
    """A build of the kernel loaded, its entries' argument types set, its
    tables' sizes and instantiations' tags checked against the wrapper's."""
    lib = ctypes.CDLL(str(path))
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    table = (ctypes.c_int * 2)()
    lib.rollout_table(table)
    if tuple(table) != (INPUTS, OUTPUTS):
        raise RuntimeError(f"{path} takes {tuple(table)} inputs and outputs, the wrapper "
                           f"{(INPUTS, OUTPUTS)}")
    lib.rollout_tags.restype = ctypes.c_char_p
    tags = tuple(lib.rollout_tags().decode().split())
    if tags != INSTANTIATIONS:
        raise RuntimeError(f"{path} has the instantiations {tags}, the wrapper {INSTANTIATIONS}")
    bind_plans(lib)
    return lib


def bind_plans(lib):
    """Set the argument types of a build's `rollout_plans` (a build before
    the plans has none: False)."""
    if not hasattr(lib, "rollout_plans"):
        return False
    lib.rollout_plans.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                                  + [ctypes.c_void_p])
    lib.rollout_plans.restype = ctypes.c_int
    return True


PLAN_KEYS = ("roll_S", "roll_threads", "roll_chunk", "roll_blocks", "roll_bytes", "price_S",
             "price_rows", "price_knots", "price_groups", "price_blocks", "price_threads",
             "price_bytes", "cu_at", "cb_at", "lam_at")


def plans(lib, table, dims, outputs, dtype, sms=132):
    """The launch plans a build makes of these tables (`check_rollout` or
    `check_price`'s) for a card of ``sms`` SMs: {PLAN_KEYS: value}."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    err = lib.rollout_plans(int(dtype == torch.float64), *c_tables(table, outputs), *dims, sms,
                            out)
    if err != 0:
        raise ValueError(f"no K9 instantiation for the flags {dims[-1]}")
    return dict(zip(PLAN_KEYS, out))


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel built and loaded (`bind`)."""
    return bind(build())


def _model(spec, prob):
    """(instantiation, nx, n_feet, nu) of a problem the kernel takes; raises
    ValueError on one it does not."""
    tag = spec.line_search
    if tag not in _k2.MODELS:
        raise ValueError(f"K9 runs the specs tagged {tuple(_k2.MODELS)}, not {tag!r}")
    name = instantiation(tag, spec.integrator)
    if name is None:
        raise ValueError(f"K9 has no instantiation for {tag!r} under the {spec.integrator!r} "
                         f"integrator (it has {INSTANTIATIONS})")
    nx, ne, qi, _ = _k2.MODELS[tag]
    if (spec.nx, spec.ne, spec.quat_idx) != (nx, ne, qi):
        raise ValueError(f"K9 runs {tag!r} with nx {nx}, quaternion at {qi}; the spec has nx "
                         f"{spec.nx}, quat_idx {spec.quat_idx}")
    if prob.Cx is not None:
        raise ValueError("K9 does not take state rows Cx in the inequality (their terminal "
                         "row): the plain versions run such a problem")
    if tag == "attitude":
        n_feet, nu = 1, 3
    else:
        n_feet = prob.params.foot_pos.shape[0]
        nu = 3 * n_feet
        if not 1 <= n_feet <= MAX_FEET:
            raise ValueError(f"K9 takes 1 to {MAX_FEET} feet, got {n_feet}")
    if spec.nu != nu:
        raise ValueError(f"K9 runs {tag!r} with {nu} inputs, the spec has {spec.nu}")
    return name, nx, n_feet, nu


def check_rollout(spec, prob, us):
    """The rollout's input table (INPUTS (tensor, batch extent) pairs in the
    order of csrc/rollout.cu enum Input, (None, 1) for what it does not
    read) and (N, B, n_feet, nc, flags); raises ValueError on inputs the
    kernel does not take."""
    name, nx, n_feet, nu = _model(spec, prob)
    if us.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K9 takes float32 or float64, got {us.dtype}")
    if us.dim() != 3 or us.shape[1] != nu or us.shape[0] < 1:
        raise ValueError(f"us must be (N >= 1, {nu}, B), got {tuple(us.shape)}")
    N, B = us.shape[0], us.shape[-1]
    E, S = _k2._EXACT, _k2._SCALAR
    none = lambda n: (None, None, None, n)
    operands = [(prob.x0, E, (nx, B), "x0"), (us, E, (N, nu, B), "us"),
                *map(none, ("x_ref", "u_ref", "Qd", "Qdf", "Rd", "w", "Cu", "cb", "lam")),
                *_k2.param_operands(prob.params, _k2.MODELS[spec.line_search][3], n_feet),
                (prob.h, S, None, "h"), none("rho")]
    table = _k2.input_table(operands, B, (us.dtype, us.device), _k2.view)
    return table, (N, B, n_feet, 0, INSTANTIATIONS.index(name) << _MODEL_SHIFT)


def check_price(spec, prob, xs, us, lam, rho):
    """The pricing's input table (as `check_rollout`'s) and (N, B, n_feet,
    nc, flags); ``lam`` None is zero multipliers."""
    name, nx, n_feet, nu = _model(spec, prob)
    if xs.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K9 takes float32 or float64, got {xs.dtype}")
    if xs.dim() != 3 or xs.shape[1] != nx or xs.shape[0] < 2:
        raise ValueError(f"xs must be (N+1 >= 2, {nx}, B), got {tuple(xs.shape)}")
    N, B = xs.shape[0] - 1, xs.shape[-1]
    nc = prob.Cu.shape[0]
    w_per_knot, cb_per_knot = prob.w.dim() == 2, prob.cb.dim() == 3
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
        (None, None, None, "lam") if lam is None
        else (lam if lam.shape[0] == N else lam[:N], L, (N, nc), "lam"),
        *((None, None, None, field) for field in _k2._PARAM_SHAPES),
        (None, None, None, "h"),
        (rho, S, None, "rho"),
    ]
    table = _k2.input_table(operands, B, (xs.dtype, xs.device), _k2.view)
    flags = ((_W_PER_KNOT if w_per_knot else 0) | (_CB_PER_KNOT if cb_per_knot else 0)
             | INSTANTIATIONS.index(name) << _MODEL_SHIFT)
    return table, (N, B, n_feet, nc, flags)


_IN_TABLE = ctypes.c_void_p * INPUTS
_STRIDE_TABLE = ctypes.c_longlong * (2 * INPUTS)
_OUT_TABLE = ctypes.c_void_p * OUTPUTS


def c_tables(table, outputs):
    """The C interface's three tables: the input pointers (null for what the
    entry does not read), each input's (row stride, batch stride) and the
    output pointers (xs, J, λ̄; null where not asked for)."""
    return (_IN_TABLE(*[None if t is None else t.data_ptr() for t, _ in table]),
            _STRIDE_TABLE(*[s for t, _ in table for s in _k2.strides(t)]),
            _OUT_TABLE(*[None if t is None else t.data_ptr() for t in outputs]))


def _launch(lib, priced, table, dims, outputs, like):
    """One launch of an entry on the current stream of ``like``'s card."""
    fn = getattr(lib, _ENTRY[(priced, like.dtype)])
    tables = c_tables(table, outputs)
    if like.device.index == torch.cuda.current_device():
        err = fn(*tables, *dims, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(like.device):
            err = fn(*tables, *dims, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K9 {'price' if priced else 'rollout'} launch failed with CUDA "
                           f"error {err}")


def _on_card(t, what):
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {t.device}")
    return True


def rollout(spec, prob, us):
    """States (N+1, nx, B) of the inputs ``us`` (N, nu, B) from prob.x0
    (`solver.fleet.open_loop_rollout`). Tensors on the CPU take the plain
    version; on the card one launch."""
    if not _on_card(us, "rollout"):
        return open_loop_rollout_ref(spec, prob, us)
    table, dims = check_rollout(spec, prob, us)
    N, B = dims[:2]
    xs = torch.empty((N + 1, spec.nx, B), dtype=us.dtype, device=us.device)
    _launch(_lib(), False, table, dims, (xs, None, None), us)
    rollout.launches += 1
    return xs


rollout.launches = 0


def price(spec, prob, xs, us, lam, rho, cost=True, lam_bar=False):
    """(J (B,) or None, λ̄ (N, nc, B) or None): with ``cost`` the AL cost of
    (xs, us) under the multipliers ``lam`` (None: zero) and penalty ``rho``
    (`solver.fleet.total_cost`), with ``lam_bar`` the multipliers' update
    max(λ + ρ·(Cu·u + cb), 0) (the solver's after an AL iteration). Tensors
    on the CPU take the plain version; on the card one launch."""
    if not (cost or lam_bar):
        raise ValueError("price computes J, λ̄ or both: ask for one")
    if not _on_card(xs, "price"):
        return price_ref(spec, prob, xs, us, lam, rho, cost, lam_bar)
    table, dims = check_price(spec, prob, xs, us, lam, rho)
    N, B, _, nc, _ = dims
    J = torch.empty((B,), dtype=xs.dtype, device=xs.device) if cost else None
    bar = torch.empty((N, nc, B), dtype=xs.dtype, device=xs.device) if lam_bar else None
    _launch(_lib(), True, table, dims, (None, J, bar), xs)
    price.launches += 1
    return J, bar


price.launches = 0


def open_loop_rollout_ref(spec, prob, us):
    """The plain rollout: `solver.fleet.open_loop_rollout`."""
    return _fl.open_loop_rollout(spec, prob, us)


def price_ref(spec, prob, xs, us, lam, rho, cost=True, lam_bar=False):
    """The plain pricing: `solver.fleet.total_cost` (``lam`` None: zero
    multipliers) and the solver's multiplier update through
    `solver.fleet.constraint_values`."""
    N, nc, B = us.shape[0], prob.Cu.shape[0], xs.shape[-1]
    if lam is None:
        lam = torch.zeros((N, nc, B), dtype=xs.dtype, device=xs.device)
    J = _fl.total_cost(spec, xs, us, prob, lam, rho) if cost else None
    bar = (torch.clamp(lam[:N] + rho * _fl.constraint_values(prob, xs, us), min=0.0)
           if lam_bar else None)
    return J, bar


# Floating-point operations of the device code (each add, subtract,
# multiply, divide, sine and cosine once; a fused multiply-add two, an
# absolute value none), counted from csrc/rollout.cu:
# - a stage knot's cost: the state's sum 4·nx + 4 (with ½), the input's
#   4·nu + 5, the geodesic term 14 where the state holds a quaternion, the
#   rows nc·(2·nu + 10) (c, λ̄, the squares and their accumulators) and the
#   AL term 10; the multiplier update alone nc·(2·nu + 6) a knot;
# - the terminal: 4·nx + 4, + 14 with a quaternion; the sum over the knots
#   N + 4;
# - the rollout's step and the constants a scenario computes once are K2's
#   (`line_search._OPS`: the same structs).
def _stage_flops(nx, nu, nc, quat):
    return 4 * nx + 4 + 4 * nu + 5 + 14 * quat + nc * (2 * nu + 10) + 10


def rollout_work(spec, prob, us) -> dict:
    """Bytes and floating-point operations of the rollout on these inputs,
    for its bound on the card: x0, us and the parameters read once (a shared
    leaf once for all scenarios, of the rotation its third row), xs written
    once; N steps and the constants a scenario."""
    table, (N, B, n_feet, _, flags) = check_rollout(spec, prob, us)
    name = INSTANTIATIONS[flags >> _MODEL_SHIFT]
    nx, nu = spec.nx, us.shape[1]
    rows = [nx, N * nu] + [0] * 9 + [3 * n_feet, 9, 1, 3, 1, 3, 1, 0]
    read = sum(r * ld for r, (t, ld) in zip(rows, table) if t is not None)
    _, step, constants = _k2._OPS[name]
    return {"bytes": us.element_size() * (read + (N + 1) * nx * B),
            "flops": B * (N * step(n_feet) + constants)}


def price_work(spec, prob, xs, us, lam, rho, cost=True, lam_bar=False) -> dict:
    """Bytes and floating-point operations of a pricing on these inputs:
    every input it needs read once (a shared leaf once for all scenarios;
    with ``cost`` xs, us, the references and weights, with ``lam_bar`` alone
    us, Cu, cb, λ), J and λ̄ written where asked; the operations as
    counted above."""
    table, (N, B, _, nc, flags) = check_price(spec, prob, xs, us, lam, rho)
    nx, nu, quat = spec.nx, us.shape[1], spec.quat_idx is not None
    w_rows = (N + 1 if flags & _W_PER_KNOT else 1) if quat else 0
    cb_rows = N * nc if flags & _CB_PER_KNOT else nc
    rows = ([(N + 1) * nx, N * nu, (N + 1) * nx, N * nu, nx,
             nx if prob.Qdf is not None else 0, nu, w_rows] if cost
            else [0, N * nu] + [0] * 6) + [nc * nu, cb_rows, N * nc] + [0] * 7 + [1]
    read = sum(r * ld for r, (t, ld) in zip(rows, table) if t is not None)
    written = B * cost + N * nc * B * lam_bar
    if cost:
        flops = N * _stage_flops(nx, nu, nc, quat) + 4 * nx + 4 + 14 * quat + N + 4
    else:
        flops = N * nc * (2 * nu + 6)
    return {"bytes": xs.element_size() * (read + written), "flops": B * flops}
