"""K7: the articulated plant's control period as a hand-written CUDA kernel.

Replaces the region XLA fused for the JAX package at
`quaternion_mpc_tpu/sim/articulated.py:283`: `step`, a `lax.scan` of
n_sub calls of `substep` (foot kinematics, terrain contact with stick-slip
friction, clamped PD torques, the leg chains' dynamics, the torso SRB and the
semi-implicit integration). Eager PyTorch runs each substep as thousands
of launches; the kernel runs the whole period in one.

What bounds it on the H100: operations, `FLOPS_PER_SUBSTEP` a scenario and
substep (`work`), against a few hundred values read and written once a
scenario. One scenario is a serial chain of n_sub substeps, though, and the
CLI's B = 64 is a few warps on a card of 132 SMs: latency, not the bound,
sets its time.

Design (csrc/articulated.cu): a lane per leg, four lanes a scenario, THREADS
lanes a block. Each lane keeps its leg's state and targets and the torso's
state in registers for the whole loop and computes its leg alone (foot
kinematics, contact, torque, M and c, the 3x3 solve, the step); the torso's
sums over the legs are a butterfly of `__shfl_xor_sync` that leaves the same
bits in the four lanes, and each lane updates the torso itself. The block's
parameter rows are staged into shared memory once a launch. M(q) and c(q, q̇)
of each leg are computed in closed form (composite inertias; Newton-Euler at
q̈ = 0), where the plain version differentiates the leg Lagrangian with
torch.func, so the two check each other.

The wrapper packs each scenario into three rows (`STATE`, `TARGETS`,
`PARAMS` values; `pack`) and reads the new state back as views of the
output (`unpack`). It takes any leading batch axes and parameters that are
shared or per scenario, as `sim.articulated.step` does.

Source `csrc/articulated.cu`, compiled at first use with nvcc into
`build/` (`kernels.build`) and bound with ctypes. `articulated_step` takes
the plain version (`sim.articulated.step(..., backend="plain")`) for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from quaternion_mpc_tpu_torch.kernels import build as _build
from quaternion_mpc_tpu_torch.sim import articulated as _art
from quaternion_mpc_tpu_torch.sim import plant as _plant

SOURCE = _build.CSRC / "articulated.cu"
_ENTRY = {torch.float32: "articulated_step_f32", torch.float64: "articulated_step_f64"}
STATE, TARGETS, PARAMS = 49, 36, 231
THREADS = 64  # lanes a block (csrc/articulated.cu K7_THREADS): 16 scenarios
# The phases of a substep, in the order the device code stamps them
# (K7_STAMP; the -DK7_PHASE_CLOCKS build sums each one's clocks).
PHASES = ("attitude", "contact", "dynamics", "sums", "torso")
# Floating-point operations of one substep of one scenario in the device
# code: each add, subtract, multiply, divide, comparison-free min / max,
# square root, sine, cosine, exponential and floor counted once; the torso's
# attitude and update once (every lane of the scenario repeats them), each
# leg once, and the sums over the legs as 3 adds a value
# (tests/test_torch_articulated_emulation.py counts them by running the
# device code on a counting number type).
FLOPS_PER_SUBSTEP = 5922


# No fused multiply-add: each operation rounds as the plain version's do, so
# that in f32 the kernel's stick / slip decisions at the friction cone's edge
# fall where the plain step's fall (contracted, its f32 run left the f64 plain
# step by 1.8e-2 of scale in a perturbed scenario where the f32 plain step
# stays within 1e-3; PERF.md).
FLAGS = ("-fmad=false",)


def build(extra_flags=()):
    """Compile the kernel (kernels.build) with FLAGS and ``extra_flags``;
    returns the library's path."""
    return _build.build(SOURCE, FLAGS + tuple(extra_flags))


def bind(path) -> ctypes.CDLL:
    """A build of the kernel (this source with other flags, or another source
    with the same C interface) loaded, its entries' argument types set and
    its row widths checked against the wrapper's."""
    lib = ctypes.CDLL(str(path))
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    widths = (ctypes.c_int * 3)()
    lib.articulated_widths(widths)
    if tuple(widths) != (STATE, TARGETS, PARAMS):
        raise RuntimeError(
            f"{path} packs {tuple(widths)} values, the wrapper "
            f"{(STATE, TARGETS, PARAMS)}"
        )
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build())


def work(n_sub: int, B: int, dtype) -> dict:
    """Bytes and floating-point operations of one call, for its bound on the
    card: the state (49 values), targets (36) and parameters (231) of each
    scenario read once and its new state (49) written once; the operations
    of n_sub substeps."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return {
        "bytes": B * itemsize * (2 * STATE + TARGETS + PARAMS),
        "flops": FLOPS_PER_SUBSTEP * n_sub * B,
    }


def _rows(t, lead, tail, dtype):
    """``t`` broadcast to lead + tail, cast, as (B, prod(tail)) rows."""
    return torch.broadcast_to(t.to(dtype), lead + tail).reshape(-1, math.prod(tail))


def pack(s: _art.ArticulatedState, targets, p: _art.ArticulatedParams, dt_ctrl, ext=None):
    """The kernel's three input rows per scenario: (state (B, 49), targets
    (B, 36), params (B, 231)) with B the product of the state's leading
    axes. ``dt_ctrl``: a Python float or a per-scenario tensor; ``ext``: a
    `plant.ExtWrench` or None (no push)."""
    lead = tuple(s.q.shape[:-2])
    dtype, device = s.q.dtype, s.q.device
    if dtype not in _ENTRY:
        raise ValueError(f"articulated_step takes float32 or float64, got {dtype}")
    t = s.torso
    state = torch.cat([
        _rows(t.pos, lead, (3,), dtype), _rows(t.quat, lead, (4,), dtype),
        _rows(t.vel, lead, (3,), dtype), _rows(t.omega, lead, (3,), dtype),
        _rows(s.q, lead, (4, 3), dtype), _rows(s.dq, lead, (4, 3), dtype),
        _rows(s.anchor, lead, (4, 3), dtype),
    ], dim=1)
    tgt = torch.cat([_rows(x, lead, (4, 3), dtype) for x in targets], dim=1)
    if not isinstance(dt_ctrl, torch.Tensor):
        dt_ctrl = torch.full((), float(dt_ctrl), dtype=dtype, device=device)
    if ext is None:
        ext = _plant.ExtWrench(force_world=torch.zeros((3,), dtype=dtype, device=device),
                               torque_body=torch.zeros((3,), dtype=dtype, device=device))
    tp, lp, tr = p.terrain, p.leg_params, p.torso
    scalar = lambda x: _rows(x[..., None], lead, (1,), dtype)  # per-scenario (...) or shared ()
    params = torch.cat([
        scalar(tr.mass), _rows(tr.inertia, lead, (3, 3), dtype),
        _rows(tr.com_offset, lead, (3,), dtype), scalar(tr.com_mass),
        _rows(p.rho_fix, lead, (4, 5), dtype),
        _rows(lp.mass, lead, (4, 3), dtype), _rows(lp.com, lead, (4, 3, 3), dtype),
        _rows(lp.inertia, lead, (4, 3, 3, 3), dtype),
        scalar(tp.kind), scalar(tp.slope_grade), scalar(tp.stair_rise), scalar(tp.stair_run),
        scalar(p.contact_kp), scalar(p.contact_kd), scalar(p.contact_kt),
        scalar(p.contact_kt_spring), scalar(p.mu),
        _rows(_art.joint_gains(p.kp_joint, s.q), lead, (4, 3), dtype),
        _rows(_art.joint_gains(p.kd_joint, s.q), lead, (4, 3), dtype),
        scalar(p.tau_max), scalar(dt_ctrl),
        _rows(ext.force_world, lead, (3,), dtype), _rows(ext.torque_body, lead, (3,), dtype),
    ], dim=1)
    return state, tgt, params


def unpack(out: torch.Tensor, lead: tuple) -> _art.ArticulatedState:
    """The new state from the kernel's (B, 49) output, as views of it."""
    part = lambda a, b, tail: out[:, a:b].reshape(lead + tail)
    return _art.ArticulatedState(
        torso=_plant.PlantState(pos=part(0, 3, (3,)), quat=part(3, 7, (4,)),
                                vel=part(7, 10, (3,)), omega=part(10, 13, (3,))),
        q=part(13, 25, (4, 3)), dq=part(25, 37, (4, 3)), anchor=part(37, 49, (4, 3)),
    )


def launch(state: torch.Tensor, targets: torch.Tensor, params: torch.Tensor,
           n_sub: int) -> torch.Tensor:
    """The kernel on packed rows (`pack`) on the card: the new state rows
    (B, 49). Counts one launch (`articulated_step.launches`)."""
    if state.device.type != "cuda":
        raise ValueError(f"the kernel runs on cuda tensors, not {state.device}")
    if n_sub < 1:
        raise ValueError(f"n_sub must be at least 1, got {n_sub}")
    B = state.shape[0]
    for name, t, width in (("state", state, STATE), ("targets", targets, TARGETS),
                           ("params", params, PARAMS)):
        if tuple(t.shape) != (B, width) or t.dtype != state.dtype or t.device != state.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({B}, {width}) {state.dtype} on "
                             f"{state.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    out = torch.empty_like(state)
    fn = getattr(_lib(), _ENTRY[state.dtype])
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(state.data_ptr(), targets.data_ptr(), params.data_ptr(), out.data_ptr(),
                 n_sub, B, stream)
    if err != 0:
        raise RuntimeError(f"articulated_step kernel launch failed with CUDA error {err}")
    articulated_step.launches += 1
    return out


def articulated_step(s: _art.ArticulatedState, targets, p: _art.ArticulatedParams, dt_ctrl,
                     n_sub: int = 80, ext=None) -> _art.ArticulatedState:
    """One control period of n_sub substeps (`sim.articulated.step`), every
    scenario in one launch. Tensors on the CPU take the plain version."""
    device = s.q.device
    if device.type == "cpu":
        return _art.step(s, targets, p, dt_ctrl, n_sub, ext, backend="plain")
    if device.type != "cuda":
        raise ValueError(f"articulated_step runs on cpu or cuda tensors, not {device}")
    return unpack(launch(*pack(s, targets, p, dt_ctrl, ext), n_sub), tuple(s.q.shape[:-2]))


articulated_step.launches = 0
