"""K2: the line search of an iLQR iteration of the quaternion SRB as a
hand-written CUDA kernel.

Replaces the region XLA fused for the JAX package at
`quaternion_mpc_tpu/solver/fleet.py:757-799`: `jax.vmap` of `rollout`
(:662-676) and `total_cost` (:388) over the alphas, the Armijo test, the
accept and the NaN-safe select. Eager PyTorch runs it (`solver.fleet.
line_search`, the plain version) as about a thousand launches an iteration;
the kernel runs it in one.

What bounds it on the H100: bytes at the fleet's sizes (`work`): the gains
Ks (N·nu·12 values a scenario) are most of what the function reads, and the
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

Which spec runs it is a tag on the model (`FleetModelSpec.line_search ==
TAG`, set by `control.quat_mpc.FLEET_MODEL_SPEC` and carried from
`models.srb.quat_srb_dynamics` by `solver.al_ilqr.fleet_spec`); every other
spec runs the plain version. A tagged problem the kernel does not take
(state rows Cx, more than four feet, more than 32 alphas) raises on the
card.

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

TAG = "quat_srb_midpoint"
SOURCE = _build.CSRC / "line_search.cu"
_ENTRY = {torch.float32: "line_search_f32", torch.float64: "line_search_f64"}
NX = 13
NE = 12
MAX_FEET = 4
MAX_ALPHAS = 32  # the lanes of a warp
INPUTS = 24  # the kernel's input table (enum Input), then the alphas, done and the scratch
OUTPUTS = 7
_W_PER_KNOT, _CB_PER_KNOT, _PRICE = 1, 2, 4


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
    with the same C interface) loaded, its entries' argument types set and
    its tables' sizes checked against the wrapper's."""
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
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build())


def flops_per_knot(n_feet: int, nc: int) -> int:
    """Floating-point operations of one knot of one alpha's rollout and cost
    in the device code (each add, subtract, multiply and divide once): the
    state difference 40, the input 27·nu, the stage's state and input terms
    66 + 4·nu, the AL term nc·(2·nu + 7) + 5, the midpoint step
    15·n_feet + 113."""
    nu = 3 * n_feet
    return 224 + 31 * nu + 15 * n_feet + nc * (2 * nu + 7)


def work(N: int, B: int, K: int, n_feet: int, nc: int, dtype, priced: bool = False) -> dict:
    """Bytes and floating-point operations that the function needs, for its
    bound on the card, with every leaf of the problem per scenario (the
    fleet's case). Bytes: every input read once (of u_ref and the per-knot
    rows only those the stage knots use, of the rotation its third row) and
    every output written once. Operations: K rollouts of N knots with their
    costs (`flops_per_knot`), each alpha's terminal cost and Armijo test (71),
    the model's constants once a scenario (56), and with ``priced`` (no J
    given) the cost of xs_bar and us_bar (N stages and the terminal)."""
    nu = 3 * n_feet
    per_scenario = (
        2 * (N + 1) * NX              # xs_bar, x_ref
        + N * nu * (NE + 3)           # Ks, us_bar, ds, u_ref
        + 2 * NX + nu + 1             # Qd, Qdf, Rd, w
        + nc * nu + nc + N * nc       # Cu, cb, lam
        + 3 * n_feet + 9 + 1 + 3 + 1 + 3  # foot_pos, inertia, mass, com_offset, com_mass, rot row
        + 1 + 3 - priced              # h; J, dV1, dV2
        + (N + 1) * NX + N * nu + 2   # out: xs, us, J, J_out
    )
    price = priced * (N * (71 + 4 * nu + nc * (2 * nu + 7)) + 65)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return {
        "bytes": B * (itemsize * per_scenario + 3) + itemsize * (K + 1),  # + done, accepted,
        # improved (a byte each), the alphas and rho
        "flops": B * (K * (N * flops_per_knot(n_feet, nc) + 71) + 56 + price),
    }


def _operand(t, lead, B, name, like):
    """``t`` as the kernel reads it: contiguous, its batch axis B or 1 (a
    value every scenario shares; an axis of B broadcast with stride 0 is cut
    to 1), with the batch extent. Raises on another shape, type or device.
    ``like``: (dtype, device) every operand shares."""
    shape = t.shape if isinstance(t, torch.Tensor) else None
    if shape is None or len(shape) != len(lead) + 1 or shape[-1] not in (1, B) \
            or shape[:-1] != lead:
        shape = tuple(shape) if shape is not None else type(t).__name__
        raise ValueError(f"{name} must have shape {tuple(lead)} + (B|1,) with B = {B}, got {shape}")
    return _layout(t, B, name, like)


def _exact(t, shape, name, like):
    """An operand with its batch axis always B: ``shape`` exactly."""
    if not isinstance(t, torch.Tensor) or t.shape != shape:
        got = tuple(t.shape) if isinstance(t, torch.Tensor) else type(t).__name__
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {got}")
    return _layout(t, shape[-1], name, like)


def _scalar(t, B, name, like):
    """A value a scenario (h, mass, ρ, ...): one shared value of any shape, or
    B values."""
    if isinstance(t, torch.Tensor):
        n = t.numel()
        if n == 1:
            return _layout(t if t.dim() == 1 else t.reshape(1), B, name, like)
        if n == B and t.shape[-1] == B:
            return _layout(t if t.dim() == 1 else t.reshape(B), B, name, like)
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


def check_inputs(spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho, alphas):
    """Raise ValueError on a problem the kernel does not take; returns the
    kernel's input table (INPUTS (tensor, batch extent) pairs in the order of
    csrc/line_search.cu enum Input; J None, to be priced, is (None, 1)), then
    alphas and done, and (N, B, K, n_feet, nc, flags)."""
    if spec.line_search != TAG:
        raise ValueError(f"K2 runs the spec tagged {TAG!r}, not {spec.line_search!r}")
    if (spec.nx, spec.quat_idx, spec.integrator) != (NX, 3, "midpoint"):
        raise ValueError(
            f"K2 runs the quaternion SRB (nx 13, quaternion at 3) under the midpoint rule, got "
            f"nx {spec.nx}, quat_idx {spec.quat_idx}, integrator {spec.integrator!r}")
    if prob.Cx is not None:
        raise ValueError("K2 does not take state rows Cx in the inequality")
    if xs.dtype not in _ENTRY:
        raise ValueError(f"K2 takes float32 or float64, got {xs.dtype}")
    p = prob.params
    n_feet = p.foot_pos.shape[0]
    nu = 3 * n_feet
    if not 1 <= n_feet <= MAX_FEET or spec.nu != nu:
        raise ValueError(f"K2 takes 1 to {MAX_FEET} feet of 3 forces each, got {n_feet} feet "
                         f"for nu = {spec.nu}")
    if xs.dim() != 3 or xs.shape[1] != NX:
        raise ValueError(f"xs must be (N+1, {NX}, B), got {tuple(xs.shape)}")
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
    operands = (
        (xs, _EXACT, (N + 1, NX, B), "xs"),
        (us, _EXACT, (N, nu, B), "us"),
        (Ks, _EXACT, (N, nu, NE, B), "Ks"),
        (ds, _EXACT, (N, nu, B), "ds"),
        (prob.x_ref, _LEAD, (N + 1, NX), "x_ref"),
        (prob.u_ref, _LEAD, (N + 1, nu), "u_ref"),
        (prob.Qd, _LEAD, (NX,), "Qd"),
        (prob.Qd if prob.Qdf is None else prob.Qdf, _LEAD, (NX,), "Qdf"),
        (prob.Rd, _LEAD, (nu,), "Rd"),
        (prob.w, _LEAD, (N + 1,), "w") if w_per_knot else (prob.w, _SCALAR, None, "w"),
        (prob.Cu, _LEAD, (nc, nu), "Cu"),
        (prob.cb, _LEAD, (N + 1, nc) if cb_per_knot else (nc,), "cb"),
        (lam if lam.shape[0] == N else lam[:N], _LEAD, (N, nc), "lam"),
        (p.foot_pos, _LEAD, (n_feet, 3), "foot_pos"),
        (p.inertia, _LEAD, (3, 3), "inertia"),
        (p.mass, _SCALAR, None, "mass"),
        (p.com_offset, _LEAD, (3,), "com_offset"),
        (p.com_mass, _SCALAR, None, "com_mass"),
        (p.rot_body_to_world, _LEAD, (3, 3), "rot_body_to_world"),
        (prob.h, _SCALAR, None, "h"),
        (rho, _SCALAR, None, "rho"),
        (J, _EXACT, (B,), "J"),
        (dV1, _EXACT, (B,), "dV1"),
        (dV2, _EXACT, (B,), "dV2"),
    )
    table = []
    for t, kind, shape, name in operands:
        if kind == _EXACT:
            table.append((None, 1) if t is None and name == "J" else _exact(t, shape, name, like))
        elif kind == _LEAD:
            table.append(_operand(t, shape, B, name, like))
        else:
            table.append(_scalar(t, B, name, like))
    if tuple(done.shape) != (B,) or done.dtype != torch.bool or done.device != xs.device:
        raise ValueError(f"done must be ({B},) bool on {xs.device}, got {tuple(done.shape)} "
                         f"{done.dtype} on {done.device}")
    if alphas.dtype != xs.dtype or alphas.device != xs.device:
        raise ValueError(f"alphas are {alphas.dtype} on {alphas.device}; xs is {xs.dtype} on "
                         f"{xs.device}")
    flags = ((_W_PER_KNOT if w_per_knot else 0) | (_CB_PER_KNOT if cb_per_knot else 0)
             | (_PRICE if J is None else 0))
    return table, (alphas.contiguous(), done.contiguous()), (N, B, K, n_feet, nc, flags)


def group_lanes(K):
    """The lanes a scenario takes in the kernel: the least power of two >= K."""
    return 1 << (K - 1).bit_length()


def new_outputs(N, B, K, n_feet, like, with_costs):
    """The kernel's outputs, uninitialised: xs (N+1, 13, B), us (N, nu, B),
    J and J_out (B,), accepted and improved (B,) bool, and the rollouts'
    costs (K, B) or None, carved out of one allocation of the type and one
    of bytes; then the trajectory scratch ((N+1)·13 + N·nu rows x B x G
    values, G = group_lanes(K)), where the kernel keeps every alpha's rollout
    when its block's shared memory cannot."""
    nu = 3 * n_feet
    sizes = [(N + 1) * NX * B, N * nu * B, B, B, K * B if with_costs else 0,
             ((N + 1) * NX + N * nu) * B * group_lanes(K)]
    xs, us, J, J_out, costs, scratch = torch.empty(
        sum(sizes), dtype=like.dtype, device=like.device).split(sizes)
    accepted, improved = torch.empty(2 * B, dtype=torch.bool, device=like.device).split(B)
    return (xs.view(N + 1, NX, B), us.view(N, nu, B), J, J_out, accepted, improved,
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
    table, (alphas, done), (N, B, K, n_feet, nc, flags) = check_inputs(
        spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho, alphas)
    outputs, scratch = new_outputs(N, B, K, n_feet, xs, with_costs)
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


def compare(got, want, dV1, dV2, alphas, rtol):
    """How one run of the line search stands against another on the same
    inputs (``got``, ``want``: (xs, us, J, J_out, accepted, improved,
    costs), as `line_search(..., with_costs=True)` returns them; ``want`` the
    plain version's). The costs are compared first, J and each rollout's
    J_k: the same ones non-finite, each finite one within ``rtol`` of
    max(|J_k|, |J|) of the plain version. Then the decisions, each side's
    from its own J and costs by `solver.fleet.armijo_ok`: a scenario whose
    selected alpha or improvement differs is a flip, and a flip is a margin
    case when, at every alpha whose test differs, both sides' costs lie
    within that tolerance of their Armijo threshold (or, for the
    improvement, of their J). The outputs are compared in the other
    scenarios: xs and us relative to their largest magnitude there, J_out
    relative to max(|J_out|, |J|) of its scenario.

    Returns a dict: costs_err (J and J_k, relative, as held), xs_err,
    us_err, J_err, flips (scenario indices), margin_cases (bool: every flip
    is one), nonfinite_same and decisions_same (bool: accepted and improved
    agree outside the flips)."""
    xs_g, us_g, J_g, Jo_g, acc_g, imp_g, costs_g = got
    xs_w, us_w, J_w, Jo_w, acc_w, imp_w, costs_w = want
    to64 = lambda t: t.detach().to("cpu", torch.float64)
    cg, cw, Jg, Jw = to64(costs_g), to64(costs_w), to64(J_g), to64(J_w)
    fin_g, fin_w = torch.isfinite(cg), torch.isfinite(cw)
    scale = torch.maximum(cw.abs().nan_to_num(0.0, 0.0, 0.0), Jw.abs()[None, :])
    tol = rtol * scale
    both = fin_g & fin_w
    costs_err = max(float(torch.where(both, (cg - cw).abs() / scale.clamp(min=1e-300), 0.0).max()),
                    float(((Jg - Jw).abs() / scale.max(0).values.clamp(min=1e-300)).max()))
    a64, d1, d2 = to64(alphas), to64(dV1), to64(dV2)
    ok_g = _fl.armijo_ok(J_g, costs_g, dV1, dV2, alphas).cpu()
    ok_w = _fl.armijo_ok(J_w, costs_w, dV1, dV2, alphas).cpu()
    K = ok_g.shape[0]
    first = lambda ok: torch.where(ok.any(0), torch.argmax(ok.to(torch.int32), 0), K)
    f_g, f_w = first(ok_g), first(ok_w)
    flips = ((f_g != f_w) | (imp_g.cpu() != imp_w.cpu())).nonzero().flatten().tolist()
    expected = -(a64[:, None] * d1[None, :] + (a64**2)[:, None] * d2[None, :])
    margin = lambda c, J: torch.where(expected > 0, (J[None, :] - c - 1e-4 * expected).abs(),
                                      (c - J[None, :]).abs()) <= tol
    margin_cases = True
    for b in flips:
        differ = (ok_g[:, b] != ok_w[:, b]).nonzero().flatten()
        for k in differ.tolist():
            margin_cases &= bool(fin_g[k, b] and fin_w[k, b] and margin(cg, Jg)[k, b]
                                 and margin(cw, Jw)[k, b])
        if len(differ) == 0:  # the same alpha, J_k < J decided otherwise
            k = int(f_w[b])
            margin_cases &= bool(abs(cg[k, b] - Jg[b]) <= tol[k, b]
                                 and abs(cw[k, b] - Jw[b]) <= tol[k, b])
    keep = torch.ones(Jw.shape[0], dtype=torch.bool)
    keep[flips] = False

    def err(g, w):
        g, w = to64(g)[..., keep], to64(w)[..., keep]
        return float((g - w).abs().max() / w.abs().max().clamp(min=1e-300)) if w.numel() else 0.0

    same = bool((acc_g.cpu() == acc_w.cpu())[keep].all() and (imp_g.cpu() == imp_w.cpu())[keep].all())
    og, ow = to64(Jo_g)[keep], to64(Jo_w)[keep]  # each relative to max(|J_out|, |J|), as the costs
    J_err = float(((og - ow).abs() / torch.maximum(ow.abs(), Jw[keep].abs()).clamp(min=1e-300))
                  .max()) if ow.numel() else 0.0
    return dict(costs_err=costs_err, xs_err=err(xs_g, xs_w), us_err=err(us_g, us_w),
                J_err=J_err, flips=flips, margin_cases=margin_cases,
                nonfinite_same=bool((fin_g == fin_w).all()), decisions_same=same)
