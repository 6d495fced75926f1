"""K10: the walking tick's stage before the solve (`runtime/step`'s `pre`:
feedback, Raibert footholds, terrain snap, gait FSM, contact schedule, goal
and terrain updates) as one hand-written CUDA kernel.

Replaces the region XLA fused for the JAX package at
`quaternion_mpc_tpu/runtime/step.py:1516-1580` (`pre`, under `jax.vmap`;
its estimated twin at :996-1063). Eager PyTorch runs the plain version
(`runtime.step._walking_pre_plain`) as ~1,100 launches a tick at B = 4096,
the largest region of plain ops left on the walking tick (PERF.md).

What bounds it on the H100: bytes (`work`): every input read once, every
output written once, of which the goal's two 3-channel window filters and
the terrain's angle filter (100 slots each) are most.

Design (csrc/walking_pre.cu): four lanes a scenario, eight scenarios a
warp. Every input is read before the first store: a scenario's values into
registers, the window buffers of a warp's scenarios into shared memory by
cp.async while the chain runs, written out from there coalesced and summed
from there over the group's four lanes in PyTorch's reduction order. Lane g
of a group runs leg g (IK, J⁻¹, foothold, FSM, swing, its contact schedule);
the scenario's chain runs in the group, its divisions and half-angle
cosines and sines dealt over the lanes. Built with -fmad=false (`FLAGS`),
its operations round as the plain version's do on the card: its libdevice
functions, PyTorch's reduction order for each sum and norm over a last axis,
and cuBLAS's order for each einsum product at a fleet's size, so that the
outputs equal the plain version's bit for bit there (chip_smoke.py holds
them so; PERF.md).

Every input is read through its batch stride (0 for a leaf every scenario
shares: the terrain's scalars, the default leg geometry and stance, the
pattern tables, the gait frequency), with any leading batch shape, one
unbatched robot included. The outputs are views of two new buffers (float
and int32), each output contiguous; the inputs are never written.

`walking_pre` runs on the card only: it launches the kernel once or raises.
`runtime.step._walking_pre` picks by device, the plain version on the CPU.
Source `csrc/walking_pre.cu`, compiled at first use with nvcc into `build/`
(`kernels.build`) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from quaternion_mpc_tpu_torch.control import goals as _goals
from quaternion_mpc_tpu_torch.control.types import Command, RobotFeedback
from quaternion_mpc_tpu_torch.gait import schedule as _sched
from quaternion_mpc_tpu_torch.kernels import build as _build
from quaternion_mpc_tpu_torch.kin import terrain as _kterr
from quaternion_mpc_tpu_torch.sim import terrain as _terrain
from quaternion_mpc_tpu_torch.utils import filters as _filters

SOURCE = _build.CSRC / "walking_pre.cu"
_ENTRY = {torch.float32: "walking_pre_f32", torch.float64: "walking_pre_f64"}
# -fmad=false: each operation rounds as the plain version's do on the card
# (the fused multiply-adds of torch.linalg.cross and cuBLAS are written out).
FLAGS = ("-fmad=false",)
LEGS = 4
MAX_WINDOW = 127  # the reduction order the kernel follows holds below 128 slots
MAX_SEG = 4  # a leg's pattern segments the kernel holds (gait.schedule.MAX_SEG)

# The input table, in the order of csrc/walking_pre.cu enum Input: (name,
# the scenario's shape, kind: "f" the state's dtype, "i" int32, "b" bool,
# "d" float64).
INPUTS = (
    ("pos", (3,), "f"), ("quat", (4,), "f"), ("vel", (3,), "f"), ("omega", (3,), "f"),
    ("est_pos", (3,), "f"), ("est_vel", (3,), "f"), ("feet", (LEGS, 3), "f"),
    ("phase", (LEGS,), "f"), ("seg_idx", (LEGS,), "i"), ("seg_start", (LEGS,), "f"),
    ("swing_start", (LEGS, 3), "f"), ("target_pos", (LEGS, 3), "f"),
    ("target_vel", (LEGS, 3), "f"), ("terrain_h", (LEGS,), "f"), ("foothold", (LEGS, 3), "f"),
    ("pos_d", (3,), "f"), ("quat_d", (4,), "f"),
    ("vel_buf", (3, "w"), "f"), ("vel_idx", (3,), "i"), ("vel_count", (3,), "i"),
    ("pos_buf", (3, "w"), "f"), ("pos_idx", (3,), "i"), ("pos_count", (3,), "i"),
    ("att_count", (), "f"),
    ("angle_buf", ("wt",), "f"), ("angle_idx", (), "i"), ("angle_count", (), "i"),
    ("terrain_angle", (), "f"),
    ("h", (), "f"), ("target_height", (), "f"),
    ("kind", (), "i"), ("grade", (), "f"), ("rise", (), "f"), ("run", (), "f"),
    ("rho_fix", (LEGS, 5), "f"), ("default_rel", (LEGS, 3), "f"),
    ("velx", (), "f"), ("vely", (), "f"), ("body_height", (), "f"), ("roll_rate", (), "f"),
    ("pitch_rate", (), "f"), ("yaw_rate", (), "f"), ("sin_ang_vel", (), "b"),
    ("states", (LEGS, "S"), "i"), ("switch_time", (LEGS, "S"), "d"), ("n_seg", (LEGS,), "i"),
    ("gf", (), "f"),
)
# The outputs, in the order of enum Out (the state's dtype) and enum OutInt
# (int32): (name, the scenario's shape).
OUTPUTS = (
    ("foot_pos_body", (LEGS, 3)), ("contacts_now", (LEGS,)), ("joint_pos", (3 * LEGS,)),
    ("joint_vel", (3 * LEGS,)), ("pos_body_d", (3,)), ("lin_vel_body_d", (3,)),
    ("quat_cmd", (4,)), ("ang_vel_body_d", (3,)), ("schedule", ("K", LEGS)),
    ("pos_d", (3,)), ("quat_d", (4,)), ("vel_buf", (3, "w")), ("pos_buf", (3, "w")),
    ("att_count", ()), ("phase", (LEGS,)), ("seg_start", (LEGS,)),
    ("swing_start", (LEGS, 3)), ("target_pos", (LEGS, 3)), ("target_vel", (LEGS, 3)),
    ("target_acc", (LEGS, 3)), ("terrain_h", (LEGS,)), ("foothold", (LEGS, 3)),
    ("plan_contacts", (LEGS,)), ("angle_buf", ("wt",)), ("terrain_angle", ()),
    ("surf_coef", (3,)), ("ground_z", ()),
)
OUTPUTS_INT = (
    ("vel_idx", (3,)), ("vel_count", (3,)), ("pos_idx", (3,)), ("pos_count", (3,)),
    ("seg_idx", (LEGS,)), ("angle_idx", ()), ("angle_count", ()),
)

# The einsum products of the plain version, in the order of enum Site: the
# body-frame feet, their velocity, J⁻¹·v; Raibert's three products with Rz;
# the goal's Rz·v_d, Rᵀ·v_d, Rᵀ(p_d − p) and G(q)·ω; the plane fit's WᵀW,
# Wᵀz and solve.
SITES = ("foot", "vrel", "dq", "rz_vel", "rz_delta", "rz_rel", "rz_vd", "vbody", "pbody",
         "quat_rate", "wtw", "wtz", "sol")
CHAIN, HALVES, PARITY, SUMS = 0, 1, 2, 3  # csrc/walking_pre.cu enum Order
# The products by cuBLAS's kernel family: Mᵀ·v (a transposed matrix-vector
# product), M·v (J⁻¹·v too, over four times the batch), and the products
# with several columns (the feet's two, WᵀW).
_TRANSPOSED = ("rz_vel", "vbody", "pbody", "wtz")
_MATVEC = ("rz_delta", "rz_vd", "quat_rate", "sol")


def _row(dq, transposed, matvec, **more):
    return {"dq": dq, **dict.fromkeys(_TRANSPOSED, transposed),
            **dict.fromkeys(_MATVEC, matvec), **more}


# The order in which cuBLAS sums each product on an H100 with torch 2.11 +
# CUDA 12.8 (its kernel depends on the product's shape, the batch and the
# type), found by holding each product of the plain version against
# candidate orders on the card (`k10_orders.py` holds this table so) at B
# in {1, 2, 7, 16, 64, 128, 256, 512, 1024, 2048, 4096} (f32) and {1, 16,
# 64, 256, 2048, 4096} (f64): per type, (least B, {site: order}) rows, the
# first whose least B the batch reaches; a site not named is a chain (where
# a product's zeros make every order agree, the order of its family).
# Between the batch sizes measured a row is a guess, and the last bits may
# differ there.
CUBLAS_ORDERS = {
    torch.float32: ((4096, _row(PARITY, HALVES, HALVES)),
                    (2048, _row(HALVES, PARITY, HALVES)),
                    (256, _row(HALVES, HALVES, HALVES)),
                    (128, _row(HALVES, SUMS, HALVES)),
                    (2, _row(HALVES, CHAIN, HALVES)),
                    (1, _row(HALVES, HALVES, HALVES, foot=HALVES, vrel=HALVES,
                             rz_rel=PARITY))),
    torch.float64: ((4096, _row(PARITY, PARITY, PARITY)),
                    (2048, _row(PARITY, HALVES, SUMS)),
                    (256, _row(SUMS, PARITY, PARITY)),
                    (64, _row(PARITY, PARITY, SUMS)),
                    (2, _row(SUMS, PARITY, SUMS)),
                    (1, _row(SUMS, CHAIN, PARITY))),
}


def orders(B, dtype) -> int:
    """The launch's orders word: two bits a site (enum Site), its Order."""
    for least, named in CUBLAS_ORDERS[dtype]:
        if B >= least:
            return sum(named.get(site, CHAIN) << (2 * i) for i, site in enumerate(SITES))
    return 0


def build():
    """Compile the kernel (kernels.build) with FLAGS; returns the library's path."""
    return _build.build(SOURCE, FLAGS)


def bind(path) -> ctypes.CDLL:
    """A build of the kernel (or of its device code emulated on the CPU)
    loaded, its entries' argument types set and its tables' sizes checked
    against the wrapper's."""
    lib = ctypes.CDLL(str(path))
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_double,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
    table = (ctypes.c_int * 4)()
    lib.walking_pre_table(table)
    want = (len(INPUTS), len(OUTPUTS), len(OUTPUTS_INT), len(SITES))
    if tuple(table) != want:
        raise RuntimeError(f"{path} takes {tuple(table)} inputs and outputs, the wrapper {want}")
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build())


@functools.cache
def _flat_terrain(device: torch.device, dtype: torch.dtype):
    """The flat world of a step given no terrain (`runtime.step._sp_terrain`)."""
    return _terrain.make_terrain("flat", dtype=dtype, device=device)


def _dims(shape, sizes):
    return tuple(sizes[d] if isinstance(d, str) else d for d in shape)


def _rows_contiguous(t, first):
    """The dims of ``t`` from ``first`` on are laid out contiguous (a dim of
    one element may have any stride)."""
    step = 1
    for n, st in zip(reversed(t.shape[first:]), reversed(t.stride()[first:])):
        if n != 1 and st != step:
            return False
        step *= n
    return True


def _entry(t, lead, tail, B):
    """(a tensor whose scenario b's values start at b·stride, that batch
    stride): ``t`` itself where it is (lead + tail) with one leading axis or
    a leaf every scenario shares (tail), else broadcast and reshaped."""
    if len(lead) == 1 and t.shape == lead + tail and _rows_contiguous(t, 1):
        return t, t.stride(0) if B > 1 else 0
    if t.shape == tail and _rows_contiguous(t, 0):
        return t, 0
    t = torch.broadcast_to(t, lead + tail).reshape((B,) + tail)
    if B > 0 and not _rows_contiguous(t, 1):
        t = t.contiguous()
    return t, t.stride(0) if B > 1 else 0


def check(carry, sp, joy, pat, gf, *, rho_fix, default_rel, horizon, gait_freq,
          per_knot_contacts, est_pos=None, est_vel=None):
    """The kernel's input table (one (tensor, batch stride) pair an input, a
    scenario's values contiguous from b·stride, in the order of INPUTS), the
    leading batch shape and the launch's sizes {B, w, wt, S, K, t_half,
    orders}; ``rho_fix`` / ``default_rel`` the legs' geometry and stance
    (the scenario's, or the Go1 default every scenario shares). Raises
    ValueError on inputs the kernel does not take."""
    ps = carry.plant
    dtype, device = ps.pos.dtype, ps.pos.device
    if dtype not in _ENTRY:
        raise ValueError(f"K10 takes float32 or float64, got {dtype}")
    lead = tuple(ps.pos.shape[:-1])
    goal, gait, terr = carry.goal, carry.gait, carry.terrain_est
    if terr is None:
        raise ValueError("K10 needs the carry's terrain estimate")
    tp = sp.terrain if sp.terrain is not None else _flat_terrain(device, dtype)
    sizes = {"w": goal.vel_filter.buf.shape[-1], "wt": terr.angle_filter.buf.shape[-1],
             "S": pat.states.shape[-1], "K": horizon + 1 if per_knot_contacts else 0}
    if pat.states.shape[0] != LEGS or gait.phase.shape[-1] != LEGS:
        raise ValueError(f"K10 takes {LEGS} legs, got {gait.phase.shape[-1]}")
    if not (1 <= sizes["w"] <= MAX_WINDOW and 1 <= sizes["wt"] <= MAX_WINDOW):
        raise ValueError(f"K10 takes windows of 1 to {MAX_WINDOW} slots, got {sizes['w']} and "
                         f"{sizes['wt']}")
    if goal.pos_filter.buf.shape[-1] != sizes["w"]:
        raise ValueError("K10 takes the goal's two filters with one window")
    if not 1 <= sizes["S"] <= MAX_SEG:
        raise ValueError(f"K10 takes patterns of 1 to {MAX_SEG} segments, got {sizes['S']}")
    leaves = (
        ps.pos, ps.quat, ps.vel, ps.omega,
        ps.pos if est_pos is None else est_pos, ps.vel if est_vel is None else est_vel,
        carry.feet_world, gait.phase, gait.seg_idx, gait.seg_start, gait.swing_start_pos,
        gait.target_pos, gait.target_vel, gait.terrain_height, gait.foothold,
        goal.torso_pos_d_world, goal.quat_d, *goal.vel_filter, *goal.pos_filter,
        goal.attitude_count, *terr.angle_filter, terr.terrain_angle,
        sp.wts.h, sp.target_height, tp.kind, tp.slope_grade, tp.stair_rise, tp.stair_run,
        rho_fix, default_rel,
        joy.velx, joy.vely, joy.body_height, joy.roll_rate, joy.pitch_rate, joy.yaw_rate,
        joy.sin_ang_vel, pat.states, pat.switch_time, pat.n_seg, gf,
    )
    kinds = {"f": dtype, "i": torch.int32, "b": torch.bool, "d": torch.float64}
    B = math.prod(lead)
    table = []
    for (name, shape, kind), t in zip(INPUTS, leaves, strict=True):
        tail = _dims(shape, sizes)
        if not isinstance(t, torch.Tensor) or t.dtype != kinds[kind] or t.device != device:
            got = f"{t.dtype} on {t.device}" if isinstance(t, torch.Tensor) else type(t).__name__
            raise ValueError(f"K10's input {name} must be {kinds[kind]} on {device}, got {got}")
        try:
            table.append(_entry(t, lead, tail, B))
        except RuntimeError as err:
            raise ValueError(f"K10's input {name} {tuple(t.shape)} does not broadcast to "
                             f"{lead + tail}") from err
    t_half = 0.5 / gait_freq
    return table, lead, {"B": B, **sizes, "t_half": t_half, "orders": orders(B, dtype)}


def new_outputs(lead, sizes, dtype, device):
    """The outputs: ({name: view}, {name: int32 view}, the two buffers), each
    view a contiguous (lead + its shape) part of its buffer."""
    B = sizes["B"]

    def carve(spec, dt):
        shapes = [_dims(shape, sizes) for _, shape in spec]
        counts = [B * math.prod(s) for s in shapes]
        buf = torch.empty(sum(counts), dtype=dt, device=device)
        parts = torch.split(buf, counts)
        return {name: p.view(lead + s) for (name, _), p, s in zip(spec, parts, shapes)}, buf

    out, buf = carve(OUTPUTS, dtype)
    out_int, buf_int = carve(OUTPUTS_INT, torch.int32)
    return out, out_int, (buf, buf_int)


_IN_TABLE = ctypes.c_void_p * len(INPUTS)
_STRIDE_TABLE = ctypes.c_longlong * len(INPUTS)
_OUT_TABLE = ctypes.c_void_p * len(OUTPUTS)
_OUT_INT_TABLE = ctypes.c_void_p * len(OUTPUTS_INT)


def launch(lib, table, sizes, out, out_int, dtype, stream=None):
    """One launch of a build on these tables; a CPU emulation of the device
    code takes the same tables with ``stream`` None. Returns the entry's
    error code."""
    fn = getattr(lib, _ENTRY[dtype])
    return fn(_IN_TABLE(*[t.data_ptr() for t, _ in table]),
              _STRIDE_TABLE(*[bs for _, bs in table]),
              _OUT_TABLE(*[t.data_ptr() for t in out.values()]),
              _OUT_INT_TABLE(*[t.data_ptr() for t in out_int.values()]),
              sizes["B"], sizes["w"], sizes["wt"], sizes["S"], sizes["K"], sizes["orders"],
              sizes["t_half"], stream)


def assemble(carry, out, out_int, est_pos=None, est_vel=None, per_knot_contacts=True):
    """The plain version's eight outputs (fbk, cmd, goal, gait,
    plan_contacts, foot_pos_body, terr_est, ground_z) from the kernel's."""
    ps = carry.plant
    fbk = RobotFeedback(
        torso_pos_world=ps.pos if est_pos is None else est_pos, torso_quat=ps.quat,
        torso_lin_vel_world=ps.vel if est_vel is None else est_vel, torso_ang_vel_body=ps.omega,
        foot_pos_body=out["foot_pos_body"], foot_contact=out["contacts_now"],
        joint_pos=out["joint_pos"], joint_vel=out["joint_vel"],
    )
    cmd = Command(
        pos_body_d=out["pos_body_d"], lin_vel_body_d=out["lin_vel_body_d"],
        quat_d=out["quat_cmd"], ang_vel_body_d=out["ang_vel_body_d"],
        contacts=out["schedule"] if per_knot_contacts else out["plan_contacts"],
    )
    goal = _goals.GoalState(
        torso_pos_d_world=out["pos_d"], quat_d=out["quat_d"],
        vel_filter=_filters.WindowState(out["vel_buf"], out_int["vel_idx"],
                                        out_int["vel_count"]),
        pos_filter=_filters.WindowState(out["pos_buf"], out_int["pos_idx"],
                                        out_int["pos_count"]),
        attitude_count=out["att_count"],
    )
    gait = _sched.GaitState(
        phase=out["phase"], seg_idx=out_int["seg_idx"], seg_start=out["seg_start"],
        swing_start_pos=out["swing_start"], target_pos=out["target_pos"],
        target_vel=out["target_vel"], target_acc=out["target_acc"],
        terrain_height=out["terrain_h"], foothold=out["foothold"],
    )
    terr = _kterr.TerrainState(
        angle_filter=_filters.WindowState(out["angle_buf"], out_int["angle_idx"],
                                          out_int["angle_count"]),
        terrain_angle=out["terrain_angle"], surf_coef=out["surf_coef"],
    )
    return (fbk, cmd, goal, gait, out["plan_contacts"], out["foot_pos_body"], terr,
            out["ground_z"])


def walking_pre(carry, sp, joy, pat, gf, *, rho_fix, default_rel, horizon, gait_freq,
                per_knot_contacts, est_pos=None, est_vel=None):
    """The walking steps' stage before the solve on the card: one launch
    (counted in `walking_pre.launches`), the same eight outputs as the plain
    version (`runtime.step._walking_pre_plain`). Raises on tensors off the
    card."""
    kw = dict(rho_fix=rho_fix, default_rel=default_rel, horizon=horizon, gait_freq=gait_freq,
              per_knot_contacts=per_knot_contacts, est_pos=est_pos, est_vel=est_vel)
    device = carry.plant.pos.device
    if device.type != "cuda":
        raise ValueError(f"K10 runs on cuda tensors, not {device} (the plain version is "
                         f"runtime.step._walking_pre_plain)")
    table, lead, sizes = check(carry, sp, joy, pat, gf, **kw)
    dtype = carry.plant.pos.dtype
    out, out_int, _ = new_outputs(lead, sizes, dtype, device)
    if sizes["B"] > 0:
        with torch.cuda.device(device):
            err = launch(_lib(), table, sizes, out, out_int, dtype,
                         torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K10 launch failed with CUDA error {err}")
        walking_pre.launches += 1
    return assemble(carry, out, out_int, est_pos, est_vel, per_knot_contacts)


walking_pre.launches = 0


# Floating-point operations of one scenario in the device code, counted by
# function from csrc/walking_pre.cu (each add, subtract, multiply, divide,
# square root and library function (sin, cos, atan2, asin, acos, fmod,
# floor) once, a fused multiply-add twice; the scenario's chain once, though
# its four lanes repeat it): the attitude, Euler angles and Rz 45; a leg's
# body-frame foot, IK, J, J⁻¹ and dq 150, its foothold and snap 45, its FSM
# 40, its swing curve 110 (the quintic's three axes; the clearing profile is
# fewer); the contact schedule 6 an entry; the goal update 120; the plane
# fit and dihedral angle 150; the ground height 15; the pitched attitude
# 45; a window filter's update 2 a slot.
def flops_per_scenario(n_knots, w, wt):
    return (45 + LEGS * (150 + 45 + 40 + 110) + 6 * LEGS * n_knots + 120 + 150 + 15 + 45
            + 2 * (6 * w + wt))


def work(carry, sp, joy, pat, gf, **kw) -> dict:
    """Bytes and floating-point operations of one launch on these inputs, for
    its bound on the card: every input read once (a leaf every scenario
    shares once for all), every output written once."""
    table, lead, sizes = check(carry, sp, joy, pat, gf, **kw)
    B = sizes["B"]
    read = sum(math.prod(_dims(shape, sizes)) * t.element_size() * (B if bs else 1)
               for (_, shape, _), (t, bs) in zip(INPUTS, table))
    dtype = carry.plant.pos.dtype
    item = torch.empty((), dtype=dtype).element_size()
    written = B * (item * sum(math.prod(_dims(s, sizes)) for _, s in OUTPUTS)
                   + 4 * sum(math.prod(_dims(s, sizes)) for _, s in OUTPUTS_INT))
    return {"bytes": read + written,
            "flops": B * flops_per_scenario(sizes["K"], sizes["w"], sizes["wt"])}
