"""Hardware-loop runtime (port of `quaternion_mpc_tpu/runtime/hardware_loop.py`):
the reference ``main.cpp`` composition as a running program, an MPC loop and a
low-level servo thread exchanging state through seqlock buses and talking
LowCmd / LowState over real UDP sockets to a robot peer.

Reference shape (cited for parity, not copied):
- ``legged_ctrl/src/main.cpp``: two ROS timer threads, MPC update at 2.5 ms
  and low-level ``send_cmd`` at 1 kHz, sharing a ``LeggedState``;
- ``legged_ctrl/src/interfaces/HardwareInterface.cpp:7,82-152``: UDP link
  to 192.168.123.10:8007, joint-order swap on the wire, foot-force
  bias/filter chain, kf_type=1 BasicKF estimation from IMU + legs;
- ``unitree_legged_control/src/joint_controller.cpp:15-229``: the
  firmware-side servo law τ = τ_ff + Kp(q_d−q) + Kd(dq_d−dq).

The control tick is one pure function of tensors (estimator + goal + MPC +
torque map, no blackboard mutation): every solve is
`control.quat_mpc.make_controller`, so each tick launches K1 (the backward
pass) and K2 (the line search) al x ilqr times each. The runtime around it is the native C++ layer (`runtime.native`:
``RateLoop`` absolute-deadline scheduling, ``StateBus`` seqlocks,
``UdpLink`` sockets). The robot peer integrates the received servo law on
the articulated joint-level plant (`sim.articulated.step`, one K7 launch a
low-level period on the card), so the loop runs the whole stack: solver →
torque map → wire codec → UDP → firmware PD → contact physics → sensors →
wire → estimator → solver.

On the card the loop replays CUDA graphs (`utils.graphs.Graphed`): the tick (or, in
three-tier mode, its estimator and MPC tiers) and the peer's period are each
captured once, before any thread starts, and a tick costs the host a few
copies, one replay and one pull instead of thousands of eager launches. On the CPU the
same functions run eagerly.

Threads and the card: the MPC loop, the estimator thread (three-tier mode),
the sim peer and the pullers (pool mode) each issue their work on a CUDA
stream of their own, so a thread's pull to the host waits for its own
launches only, never behind another thread's queue. Data crosses threads
through the host (the buses), or, for the pool's pullers, through a CUDA
event recorded after the tick's launches. Every kernel builds and every
graph is captured in the calling thread before a clock starts.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import queue
import sys
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from quaternion_mpc_tpu_torch._bridge import numpy_dtype, resolve_device
from quaternion_mpc_tpu_torch.control import goals, quat_mpc, standup
from quaternion_mpc_tpu_torch.control import torque as torque_mod
from quaternion_mpc_tpu_torch.control.types import RobotFeedback
from quaternion_mpc_tpu_torch.est import kf as kf_mod
from quaternion_mpc_tpu_torch.gait import raibert as raibert_mod
from quaternion_mpc_tpu_torch.gait import schedule as sched_mod
from quaternion_mpc_tpu_torch.kin import leg as leg_mod
from quaternion_mpc_tpu_torch.ops import lie
from quaternion_mpc_tpu_torch.runtime import native, unitree
from quaternion_mpc_tpu_torch.runtime.step import _go1_default_rel, _pattern_on_device
from quaternion_mpc_tpu_torch.sim import articulated as art_mod
from quaternion_mpc_tpu_torch.sim import terrain as terrain_mod
from quaternion_mpc_tpu_torch.solver.problem import SolverOptions
from quaternion_mpc_tpu_torch.utils import config as cfg_mod
from quaternion_mpc_tpu_torch.utils.graphs import (  # noqa: F401  (the first two re-exported)
    GRAPH_WARMUP, CapturedStep, Graphed)
from quaternion_mpc_tpu_torch.utils.tree import tree_map

# default-pose / stand-up servo gains per joint type (hip, thigh, calf): the
# reference's hard-coded stand gains (GazeboInterface.cpp:85-111)
PRIME_KP = ((70.0, 180.0, 300.0),) * 4
PRIME_KD = ((3.0, 8.0, 15.0),) * 4

# flat f32 sensor frame on the feedback bus:
# quat(4) gyro(3) accel(3) q(12) dq(12) foot_force(4) tick(1)
# The tick counter is the SIM clock: the peer advances dt_low of physics per
# LowCmd served, so (Δtick · dt_low), not the wall clock, is the dt the
# estimator / goal integrators must use (the reactive peer's clock stretches
# whenever the servo thread overruns).
_N_SENSOR = 39
_SENSOR_BYTES = _N_SENSOR * 4
# flat f32 command frame on the command bus: (12, 5) [q dq tau kp kd]
_CMD_BYTES = 12 * 5 * 4


class HWSensors(NamedTuple):
    quat: torch.Tensor        # (4,) IMU attitude [w,x,y,z]
    gyro: torch.Tensor        # (3,) body rates
    accel: torch.Tensor       # (3,) specific force, body frame
    q: torch.Tensor           # (12,) joint angles, controller order
    dq: torch.Tensor          # (12,)
    foot_force: torch.Tensor  # (4,) filtered normal forces


class HWCarry(NamedTuple):
    goal: goals.GoalState
    kf: kf_mod.KFState
    mode: goals.ModeState
    standup: standup.StandupState
    gait: object  # gait.schedule.GaitState (walk mode, A-toggled)
    prev_grf: object = None  # (4, 3) body-frame stance GRFs of the last tick's
    # published plan: the input term of the pool mode's lead prediction


def _upload(flat: np.ndarray, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Host values -> one tensor on ``device``. On the card through pinned
    memory without blocking, so an upload never waits for the stream's
    queued launches."""
    t = torch.from_numpy(np.array(flat, dtype=numpy_dtype(dtype)))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def split_sensors(t: torch.Tensor) -> HWSensors:
    """HWSensors as views of one (38,) tensor of a sensor frame's values:
    quat(4) gyro(3) accel(3) q(12) dq(12) foot_force(4)."""
    return HWSensors(quat=t[0:4], gyro=t[4:7], accel=t[7:10], q=t[10:22], dq=t[22:34],
                     foot_force=t[34:38])


def _sensors_of(flat: np.ndarray, device, dtype) -> HWSensors:
    """HWSensors from the 38 floats of a sensor frame, one upload."""
    return split_sensors(_upload(flat[:_N_SENSOR - 1], device, dtype))


def sensors_from_lowstate(st: unitree.LowState, dtype=torch.float32, device=None) -> HWSensors:
    """The IMU and foot forces as they are, the joints through float32 (as
    the reference reads them)."""
    nd = numpy_dtype(dtype)
    flat = np.concatenate([
        np.asarray(st.quaternion, nd), np.asarray(st.gyroscope, nd),
        np.asarray(st.accelerometer, nd),
        np.array([m.q for m in st.motor_state], np.float32).astype(nd),
        np.array([m.dq for m in st.motor_state], np.float32).astype(nd),
        np.asarray(st.foot_force, nd),
    ])
    return _sensors_of(flat, resolve_device(device), dtype)


def _sensors_to_bytes(st: unitree.LowState) -> bytes:
    q = [m.q for m in st.motor_state]
    dq = [m.dq for m in st.motor_state]
    flat = np.concatenate([
        np.asarray(st.quaternion, np.float32),
        np.asarray(st.gyroscope, np.float32),
        np.asarray(st.accelerometer, np.float32),
        np.asarray(q, np.float32),
        np.asarray(dq, np.float32),
        np.asarray(st.foot_force, np.float32),
        # tick carried as exact uint32 bits (a float32 tick loses integer
        # exactness past 2^24 ≈ 4.6 h at 1 kHz, quantizing Δtick)
        np.asarray([st.tick], np.uint32).view(np.float32),
    ])
    return flat.tobytes()


def _sensors_from_bytes(data: bytes, dtype=torch.float32, device=None) -> tuple[HWSensors, int]:
    flat = np.frombuffer(data, np.float32, count=_N_SENSOR)
    return (_sensors_of(flat, resolve_device(device), dtype),
            int(flat[38:39].view(np.uint32)[0]))


@functools.cache
def _tick_constants(device: torch.device, dtype: torch.dtype):
    """(PRIME_KP (4, 3), PRIME_KD (4, 3), gravity (3,)) on a device, uploaded
    once, so a tick copies nothing from the host."""
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return t(PRIME_KP), t(PRIME_KD), t([0.0, 0.0, -9.81])


def _where(cond, new, old):
    return tree_map(lambda a, b: torch.where(cond, a, b), new, old)


# the interpreter's switch interval while `run_hardware_loopback`'s threads
# run their periods (the servo's is 4 ms at 250 Hz)
RT_SWITCH_INTERVAL_S = 5e-4


def make_hw_control_tick(
    horizon: int = 6,
    opts: SolverOptions = SolverOptions(al_iterations=1, ilqr_iterations=3),
    max_height_cmd_err: float = 0.05,
    gait_freq: float = 2.2,
    pattern=None,
):
    """One hardware control tick with the reference's operator flow:
    sensors → sigmoid contact detection (BaseInterface.cpp:234-249) →
    BasicKF → joystick mode machine (BaseInterface.cpp:135-192) → either
    the default-pose / stand-up servo (set_default_pos, GazeboInterface.cpp:
    85-111 + unitree_controller/src/body.cpp ramp) or goal update +
    quaternion MPC + torque map → (12, 5) servo command [q dq tau kp kd]
    for the wire. An A-press (``joy.mode_switch``) toggles stand ↔ walk:
    walk mode advances the trot FSM on the ESTIMATED foot-world anchors,
    plans Raibert footholds from the estimated velocity, and gates the MPC
    with the per-knot predicted contact schedule; stand mode re-anchors
    the FSM at the current feet every tick so a later walk starts clean.

    ``tick(carry, sensors, dt, joy, wts, rho_fix, kp_joint, kd_joint,
    lead=0.0) -> (carry, cmd_mat (12, 5), info)`` on one robot's tensors.
    ``joy`` is a raw `goals.JoySample` (button edges are consumed the tick
    they arrive). ``dt`` is the SIM-clock time advanced since the previous
    tick, a 0-dim tensor (the reference passes fixed nominal periods,
    Main.cpp:101-119; the reactive loopback peer's clock stretches whenever
    the servo thread overruns). dt == 0 marks a repeated feedback frame: the
    KF measurement update is skipped.

    The commanded body-height error is clamped to ±max_height_cmd_err: a
    cold estimator (BasicKF's 0.09 m prior against a ~0.3 m true height)
    would otherwise command a step the size of the estimator error.

    As in the reference's one compiled program, every flag (`fresh`,
    `in_prime`, `gait_active`, `lead_on`) selects with `torch.where` between
    two computed branches: the tick has no Python branch on a value and no
    host sync, and every call launches the same kernels (K1 and K2 al x
    ilqr times each). ``tick.est_core`` and ``tick.ctrl_core`` are its two tiers, for
    the three-tier runtime."""
    if pattern is None:
        # trot WITH an all-stance dwell (LeggedContactFSM.cpp:110-150): the
        # dwell lets a stop request end the gait where all four feet are
        # planted, and stabilizes each cycle at this loop's modest rate
        pattern = sched_mod.trot_with_stand_pattern(torch.device("cpu"))
    pattern_on = _pattern_on_device(pattern)
    grf_update = quat_mpc.make_controller(horizon, opts, zero_initial_omega=False)

    def est_core(kf_state, sensors: HWSensors, dt, rho_fix):
        """Feedback-tier work (the reference's 1 kHz thread, Main.cpp:
        169-199): FK, sigmoid contact detection, BasicKF tick. Runs inside
        the two-tier tick or alone in the three-tier estimator thread."""
        quat = lie.quat_normalize(sensors.quat)
        rot = lie.quat_to_rotmat(quat)
        q = sensors.q.reshape(4, 3)
        dq = sensors.dq.reshape(4, 3)
        foot_body = leg_mod.fk(q, rho_fix)
        J = leg_mod.jac(q, rho_fix)
        foot_vel_rel = torch.einsum("lij,lj->li", J, dq)

        # sigmoid contact confidence on filtered foot force
        contact = 1.0 / (1.0 + torch.exp(-10.0 * (sensors.foot_force - 10.0)))

        kf_new, _, _ = kf_mod.update(
            kf_state,
            kf_mod.KFInputs(
                torso_rot_mat=rot,
                torso_lin_acc_body=sensors.accel,
                torso_ang_vel_body=sensors.gyro,
                foot_pos_body=foot_body,
                foot_lin_vel_rel=foot_vel_rel,
                contacts=contact,
            ),
            torch.clamp(dt, min=1e-6),
        )
        # repeated frame (dt == 0): keep the previous estimate untouched
        kf_out = _where(dt > 0.0, kf_new, kf_state)
        return kf_out, kf_out.x[0:3], kf_out.x[3:6], contact, foot_body

    def tick(carry: HWCarry, sensors: HWSensors, dt, joy: goals.JoySample,
             wts, rho_fix, kp_joint, kd_joint, lead=0.0):
        kf_state, pos_w, vel_w, _contact, _foot_body = est_core(carry.kf, sensors, dt, rho_fix)
        return ctrl_core(carry, sensors, kf_state, pos_w, vel_w, dt, joy, wts, rho_fix,
                         kp_joint, kd_joint, lead)

    def ctrl_core(carry: HWCarry, sensors: HWSensors, kf_state, pos_w, vel_w, dt,
                  joy: goals.JoySample, wts, rho_fix, kp_joint, kd_joint, lead=0.0):
        """MPC-tier work. Takes only the torso pos / vel ESTIMATE from the
        feedback tier; contact detection and foot kinematics are recomputed
        from the freshest sensors here (in three-tier mode the gait FSM's
        early-contact logic cannot tolerate estimate-bus staleness, and the
        reference's MPC thread likewise reads raw feedback refreshed at
        1 kHz)."""
        dtype, device = sensors.quat.dtype, sensors.quat.device
        prime_kp, prime_kd, gravity = _tick_constants(device, dtype)
        pat = pattern_on(device)
        gf = torch.full((), gait_freq, dtype=dtype, device=device)
        quat = lie.quat_normalize(sensors.quat)
        rot = lie.quat_to_rotmat(quat)
        foot_body = leg_mod.fk(sensors.q.reshape(4, 3), rho_fix)
        contact = 1.0 / (1.0 + torch.exp(-10.0 * (sensors.foot_force - 10.0)))

        # ---- joystick mode machine (A toggles stand / walk, B default-pose)
        mode, joycmd, movement_mode = goals.joy_mode_update(carry.mode, joy, dt)

        # ---- default-pose / stand-up servo path (set_default_pos): the ramp
        # restarts from the measured pose whenever the mode engages
        st = _where(carry.mode.set_default_pos, carry.standup, standup.init_standup(sensors.q))
        st, q_ramp, _done = standup.standup_targets(st, dt)
        zeros43 = torch.zeros((4, 3), dtype=dtype, device=device)
        prime_cmd = torch.stack([q_ramp.reshape(4, 3), zeros43, zeros43, prime_kp, prime_kd],
                                dim=-1).reshape(12, 5)

        # ---- lead STATE PREDICTION (pool dispatch): the command computed here
        # applies ~lead seconds later, so predict the torso state to that time
        # with the SRB model under the PREVIOUS tick's stance forces (the RTI
        # delay compensation) and hand the MPC the predicted state. Gait,
        # contact and anchor logic stay on the measured state. lead == 0
        # reproduces the uncompensated feedback exactly.
        lead_p = torch.zeros((), dtype=dtype, device=device) + lead
        lead_on = lead_p > 0.0
        prev_f = carry.prev_grf if carry.prev_grf is not None else zeros43
        acc_w = (rot @ torch.sum(prev_f, dim=0)) / wts.mass + gravity
        pos_pred = pos_w + vel_w * lead_p + 0.5 * acc_w * lead_p * lead_p
        vel_pred = vel_w + acc_w * lead_p
        quat_pred = lie.quat_normalize(quat + 0.5 * lead_p * (lie.quat_G(quat) @ sensors.gyro))
        rot_pred = lie.quat_to_rotmat(quat_pred)
        # stance feet are world-fixed: the SAME world anchors in the predicted
        # body frame
        feet_world_now = pos_w + foot_body @ rot.T
        foot_body_pred = (feet_world_now - pos_pred) @ rot_pred
        pos_mpc = torch.where(lead_on, pos_pred, pos_w)
        vel_mpc = torch.where(lead_on, vel_pred, vel_w)
        quat_mpc_ = torch.where(lead_on, quat_pred, quat)
        foot_body_mpc = torch.where(lead_on, foot_body_pred, foot_body)

        # ---- MPC path
        fbk = RobotFeedback(
            torso_pos_world=pos_mpc,
            torso_quat=quat_mpc_,
            torso_lin_vel_world=vel_mpc,
            torso_ang_vel_body=sensors.gyro,
            foot_pos_body=foot_body_mpc,
            foot_contact=contact,
            joint_pos=sensors.q,
            joint_vel=sensors.dq,
        )

        # ---- gait: walk mode advances the trot FSM on estimated anchors;
        # stand mode re-anchors it at the current feet. An A-press to stand
        # does not cut the gait mid-stride: the FSM keeps running (zero
        # velocity command) until every foot is back in stance, then freezes
        # (the reference FSM's transition-at-phase-boundary semantics).
        walking = movement_mode == 1
        in_swing = ~sched_mod.contact_flags(carry.gait, pat)
        gait_active = walking | torch.any(in_swing)
        feet_world_est = pos_w + foot_body @ rot.T
        vel_d_rel = torch.stack([joycmd.velx, joycmd.vely, torch.zeros_like(joycmd.velx)])
        target_world, _ = raibert_mod.foothold_targets(
            pos_w, quat, vel_w, vel_d_rel, _go1_default_rel(device, dtype), gait_freq)
        target_world = torch.cat([target_world[:, :2], torch.zeros_like(target_world[:, 2:])],
                                 dim=-1)  # flat-ground demo
        gait_adv = sched_mod.gait_update(carry.gait, pat, dt, gf, feet_world_est, target_world,
                                         contact > 0.5)
        gait_hold = sched_mod.init_gait_state(feet_world_est, pat)
        gait = _where(gait_active, gait_adv, gait_hold)
        plan_contacts = torch.where(gait_active, sched_mod.contact_flags(gait, pat).to(dtype),
                                    torch.ones((4,), dtype=dtype, device=device))
        # per-knot spacing is the solver discretization wts.h, not the
        # measured loop dt: the MPC dynamics integrate at h
        sched = sched_mod.predict_contact_schedule(gait, pat, gf, wts.h, horizon + 1).to(dtype)
        mpc_contacts = torch.where(gait_active, sched,
                                   torch.ones((horizon + 1, 4), dtype=dtype, device=device))

        goal, cmd = goals.goal_update(carry.goal, fbk, joycmd, mpc_contacts, dt=dt)
        height_err = torch.clamp(mode.body_height - pos_w[2], -max_height_cmd_err,
                                 max_height_cmd_err)
        cmd = cmd._replace(pos_body_d=torch.cat([cmd.pos_body_d[:2], height_err[None]]))
        out, _sol = grf_update(fbk, cmd, wts)

        # ---- publish-time LEAD compensation (pool dispatch): the swing
        # targets and the stance / swing joint gating are evaluated at the
        # phase the command will be APPLIED (phase + lead·freq); the force
        # plan stays on the solve-time schedule. lead 0 (the synchronous
        # modes) selects the uncompensated outputs exactly.
        gait_pub_adv = sched_mod.gait_update(gait, pat, lead_p, gf, feet_world_est,
                                             target_world, contact > 0.5)
        gait_pub = _where(gait_active, gait_pub_adv, gait_hold)
        pub_contacts = torch.where(lead_on & gait_active,
                                   sched_mod.contact_flags(gait_pub, pat).to(dtype),
                                   plan_contacts)
        pub_target_pos = torch.where(lead_on, gait_pub.target_pos, gait.target_pos)
        pub_target_vel = torch.where(lead_on, gait_pub.target_vel, gait.target_vel)

        out = out._replace(
            grf_body=out.grf_body * plan_contacts[:, None],
            foot_pos_target_world=pub_target_pos,
            foot_vel_target_world=pub_target_vel,
        )
        targets = torque_mod.tau_ctrl_update(fbk, out, rho_fix, pub_contacts)

        # standing (movement_mode 0), BaseInterface.cpp:402-405: τ_ff = −Jᵀf
        # AND a full joint PD anchored at the MEASURED q / dq (the firmware
        # PD resists drift between command updates). Walk-mode stance legs
        # run pure torque + damping instead.
        kp = torch.broadcast_to(kp_joint, (4, 3))
        kd = torch.broadcast_to(kd_joint, (4, 3))
        kp = torch.where(gait_active, kp * (1.0 - pub_contacts)[:, None], kp)
        mpc_cmd = torch.stack([targets.q, targets.dq, targets.tau, kp, kd], dim=-1).reshape(12, 5)

        # the goal freezes while the default-pose servo holds (the MPC is not
        # in command; integrating its position target would wind up). A
        # B-press takes effect the same tick, hence the post-update mode.
        in_prime = mode.set_default_pos
        goal = _where(in_prime, carry.goal, goal)
        # prime → MPC handover, and the walk → stand edge: re-anchor the
        # desired world position at the estimate, so the MPC starts from zero
        # position error and a wound-up walk anchor does not drag the robot on
        walk_stop = (carry.mode.ctrl_state == 1) & (mode.ctrl_state == 0)
        handover = (carry.mode.set_default_pos & ~in_prime) | walk_stop
        goal = goal._replace(
            torso_pos_d_world=torch.where(handover, pos_w, goal.torso_pos_d_world))
        cmd_mat = torch.where(in_prime, prime_cmd, mpc_cmd)

        info = {
            "mpc_cost": out.mpc_cost,
            "est_pos": pos_w,
            "est_vel": vel_w,
            "movement_mode": movement_mode,
            "in_prime": in_prime,
        }
        return (
            HWCarry(goal=goal, kf=kf_state, mode=mode, standup=st, gait=gait,
                    prev_grf=out.grf_body),
            cmd_mat,
            info,
        )

    # the tiers for the three-tier runtime (the estimator thread runs
    # est_core alone; the MPC thread runs ctrl_core on published estimates)
    tick.est_core = est_core
    tick.ctrl_core = ctrl_core
    # the graphs of its parts (`loop_step`)
    tick.graphs = {}
    return tick


def loop_step(tick, part: str, wts, rho_fix, kp_joint, kd_joint, state, args):
    """A part of ``tick`` with the run's constants bound, as the loop calls
    it; on the card a `CapturedStep` (``state`` and ``args`` are the
    capture's example inputs), captured now if the `Graphed` that
    ``tick.graphs`` keeps for the part and the bound constants has none for
    these inputs' signature:

    - "tick": ``(carry, sensors, dt, joy, lead) -> (carry, cmd_mat, info)``,
      the two-tier tick;
    - "ctrl": ``(carry, sensors, pos, vel, dt, joy, lead) -> (carry, cmd_mat,
      info)``, the MPC tier on a published estimate (the carry's KF passes
      through);
    - "est": ``(kf, sensors, dt) -> (kf, pos and vel (6,))``, the estimator
      tier."""
    consts = (wts, rho_fix, kp_joint, kd_joint)
    if part == "tick":
        def fn(c, s, dt, joy, lead):
            return tick(c, s, dt, joy, *consts, lead)
    elif part == "ctrl":
        def fn(c, s, pos, vel, dt, joy, lead):
            return tick.ctrl_core(c, s, c.kf, pos, vel, dt, joy, *consts, lead)
    elif part == "est":
        def fn(kf, s, dt):
            kf, pos, vel, _contact, _feet = tick.est_core(kf, s, dt, rho_fix)
            return kf, torch.cat([pos, vel])
    else:
        raise ValueError(f"no part {part!r} of the tick")
    key = (part, tuple(id(c) for c in consts))
    if key not in tick.graphs:
        tick.graphs[key] = Graphed(fn, chain=True, clone_outs=part != "est",
                                   label=f"the hardware loop's {part}")
    return tick.graphs[key].captured(state, *args)


# flat f32 estimate frame on the estimate bus (three-tier mode):
# pos(3) vel(3) sim_tick(1); sensors travel on the feedback bus and the MPC
# thread combines the freshest of both
_N_EST = 7
_EST_BYTES = _N_EST * 4


def _est_to_bytes(pos, vel, sim_tick: int) -> bytes:
    flat = np.concatenate([
        np.asarray(pos, np.float32), np.asarray(vel, np.float32),
        np.asarray([sim_tick], np.uint32).view(np.float32),
    ])
    return flat.tobytes()


def _est_from_bytes(data: bytes, dtype=torch.float32, device=None):
    flat = np.frombuffer(data, np.float32, count=_N_EST)
    t = _upload(flat[0:6], resolve_device(device), dtype)
    return t[0:3], t[3:6], int(flat[6:7].view(np.uint32)[0])


def _stream(device: torch.device):
    """A CUDA stream of its own for one thread's work (None on the CPU)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def _on(stream):
    """Context that makes ``stream`` the thread's current stream."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _mark(device: torch.device):
    """An event recorded after the launches queued so far on the current
    stream (None on the CPU, where every operation has finished)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _pull(t: torch.Tensor, event=None, stream=None) -> np.ndarray:
    """``t`` on the host. With ``event``: the copy waits for that event only,
    on ``stream``, so launches queued on the producer's stream after the
    event do not delay it."""
    if event is None:
        return t.cpu().numpy()
    stream.wait_event(event)
    with torch.cuda.stream(stream):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    done.synchronize()
    return host.numpy()


def observe(rs: art_mod.ArticulatedState, rs_prev: art_mod.ArticulatedState,
            ap: art_mod.ArticulatedParams, dt: float) -> torch.Tensor:
    """The sensor frame's values (38,) of a plant state (the peer's IMU,
    joint encoders and foot-force sensors): the IMU's specific force from the
    torso velocity change since ``rs_prev``, ``dt`` earlier; the normal
    component of each foot's contact force."""
    _, foot_world, foot_vel_world, _ = art_mod.foot_kinematics(rs, ap)
    f_world, _ = art_mod.contact_forces(foot_world, foot_vel_world, ap, rs.anchor)
    n_vec = terrain_mod.normal(ap.terrain, foot_world[..., :2])
    f_normal = torch.sum(f_world * n_vec, dim=-1)
    a_world = (rs.torso.vel - rs_prev.torso.vel) / dt
    rot = lie.quat_to_rotmat(rs.torso.quat)
    gravity = _tick_constants(rs.q.device, rs.q.dtype)[2]
    accel_body = rot.T @ (a_world - gravity)
    return torch.cat([rs.torso.quat, rs.torso.omega, accel_body, rs.q.reshape(-1),
                      rs.dq.reshape(-1), f_normal])


def peer_step(rs: art_mod.ArticulatedState, cmd_mat: torch.Tensor,
              ap: art_mod.ArticulatedParams, dt: float, n_sub: int):
    """One low-level period of the robot under a (12, 5) servo command
    [q dq tau kp kd] (the firmware's PD + feed-forward law, each joint's
    gains as commanded): `sim.articulated.step` (one K7 launch on the card)
    and the new state's observation. Returns (new state, `observe` (38,))."""
    cm = cmd_mat.reshape(4, 3, 5)
    targets = torque_mod.JointTargets(q=cm[..., 0], dq=cm[..., 1], tau=cm[..., 2])
    new_rs = art_mod.step(rs, targets, ap._replace(kp_joint=cm[..., 3], kd_joint=cm[..., 4]),
                          dt, n_sub)
    return new_rs, observe(new_rs, rs, ap, dt)


def init_hw_carry(sensors: HWSensors, rho_fix: torch.Tensor, target_height: float = 0.3,
                  window: int = 25) -> HWCarry:
    """The tick's carry at power-on: the BasicKF at its cold prior (0.09 m,
    BasicKF.cpp:59) with the feet from FK, the mode machine standing at
    ``target_height`` with the servo off, the stand-up ramp from the measured
    pose, the trot-with-stand FSM anchored at the estimated feet, and a goal
    filter of ``window`` samples (the reference's MovingWindowFilter(100) at
    its 200 Hz goal rate is 0.5 s of smoothing, QuatMpc.cpp:10-11)."""
    dtype, device = sensors.quat.dtype, sensors.quat.device
    quat = lie.quat_normalize(sensors.quat)
    rot0 = lie.quat_to_rotmat(quat)
    foot_body0 = leg_mod.fk(sensors.q.reshape(4, 3), rho_fix)
    prior = torch.cat([torch.zeros(2, dtype=dtype, device=device),
                       torch.full((1,), 0.09, dtype=dtype, device=device)])
    fbk0 = RobotFeedback(
        torso_pos_world=prior, torso_quat=quat,
        torso_lin_vel_world=torch.zeros(3, dtype=dtype, device=device),
        torso_ang_vel_body=sensors.gyro, foot_pos_body=foot_body0,
        foot_contact=torch.ones(4, dtype=dtype, device=device),
        joint_pos=sensors.q, joint_vel=sensors.dq,
    )
    return HWCarry(
        goal=goals.init_goal_state(fbk0, window=window),
        kf=kf_mod.init_state(rot0, foot_body0, dtype=dtype),
        mode=goals.init_mode_state(target_height, dtype, device),
        standup=standup.init_standup(sensors.q),
        prev_grf=torch.zeros((4, 3), dtype=dtype, device=device),
        gait=sched_mod.init_gait_state(prior + foot_body0 @ rot0.T,
                                       sched_mod.trot_with_stand_pattern(device)),
    )


class SimGo1Peer(threading.Thread):
    """Simulated robot endpoint: answers each LowCmd datagram with one
    low-level period of articulated joint-level physics and a LowState
    reply (the Gazebo / firmware role in the loopback demo). Reactive: the
    controller's servo thread drives the sim clock.

    Its period is `sim.articulated.step` (one K7 launch on the card) and the
    IMU / joint / foot-force observation, on a CUDA stream of its own; the
    new state and the observation come back to the host in one copy. The
    true torso position, attitude and velocity of the last step are kept on
    the host (`true_pos`, `true_quat`, `true_vel`). On the card the period
    is a `CapturedStep`, captured in ``__init__`` (before the thread starts,
    and before the servo thread starts the clock), and its first period is
    run there: GRAPH_WARMUP + 1 K7 launches before the first command (1 on
    the CPU)."""

    def __init__(self, ap: art_mod.ArticulatedParams, rs: art_mod.ArticulatedState,
                 dt_cmd: float, n_sub: int = 32):
        super().__init__(daemon=True)
        self.udp = native.UdpLink()  # no peer: learns it from the first datagram
        self._ap = ap
        self._dt = float(dt_cmd)
        self._n_sub = n_sub
        self._device = rs.q.device
        self._dtype = rs.q.dtype
        self._cuda_stream = _stream(self._device)
        self._stop_evt = threading.Event()
        self.cmds_served = 0
        if self._cuda_stream is not None:
            self._cuda_stream.wait_stream(torch.cuda.current_stream(self._device))
        with _on(self._cuda_stream):
            zero = torch.zeros((12, 5), dtype=self._dtype, device=self._device)
            # period(state, cmd_mat) -> (state, the 44 values `_step` pulls)
            self.period = Graphed(self._period_fn, chain=True, clone_outs=False,
                                  label="the peer's period").captured(rs, zero)
            self._rs, _ = self._step(rs, zero)

    def _period_fn(self, rs, cmd_mat):
        new_rs, obs = peer_step(rs, cmd_mat, self._ap, self._dt, self._n_sub)
        return new_rs, torch.cat([obs, new_rs.torso.pos, new_rs.torso.vel])

    def _step(self, rs, cmd_mat):
        """One low-level period under ``cmd_mat`` (12, 5); returns the new
        state and its 44 observed values on the host: quat(4) gyro(3)
        accel(3) q(12) dq(12) foot_force(4) and the true pos(3) vel(3). On
        the card the returned state is the graph's static state, which the
        next period overwrites."""
        new_rs, obs = self.period(rs, cmd_mat)
        obs = _pull(obs)
        self.true_pos, self.true_vel = obs[38:41], obs[41:44]
        self.true_quat = obs[0:4]
        return new_rs, obs

    @property
    def state(self) -> art_mod.ArticulatedState:
        return self._rs

    def stop(self):
        self._stop_evt.set()

    def run(self):
        tick = 0
        with _on(self._cuda_stream):
            while not self._stop_evt.is_set():
                data = self.udp.recv(4096)
                if data is None:
                    time.sleep(0.0002)
                    continue
                try:
                    cmd = unitree.unpack_low_cmd(data)
                except ValueError:
                    continue
                cmd_mat = np.array([[m.q, m.dq, m.tau, m.Kp, m.Kd] for m in cmd.motor_cmd],
                                   np.float32)
                self._rs, obs = self._step(self._rs, _upload(cmd_mat, self._device,
                                                             self._dtype))
                st = unitree.LowState(quaternion=obs[0:4], gyroscope=obs[4:7],
                                      accelerometer=obs[7:10], foot_force=obs[34:38],
                                      tick=tick)
                for i in range(12):
                    st.motor_state[i].q = float(obs[10 + i])
                    st.motor_state[i].dq = float(obs[22 + i])
                self.udp.send(unitree.pack_low_state(st))
                self.cmds_served += 1
                tick += 1


def run_hardware_loopback(
    duration_s: float = 1.0,
    mpc_rate: float = 50.0,
    low_rate: float = 250.0,
    est_rate: float = 0.0,
    horizon: int = 6,
    opts: Optional[SolverOptions] = None,
    target_height: float = 0.3,
    realtime_priority: Optional[int] = None,
    prime_s: float = 0.6,
    walk_s: float = 0.0,
    velx: float = 0.3,
    auto_rate: bool = True,
    debug_trace: bool = False,
    dtype=torch.float32,
    joy_provider=None,
    state_sink=None,
    async_mpc: bool = False,
    async_pullers: int = 0,
    device=None,
) -> dict:
    """Run the full Main.cpp-shaped stack against the simulated peer.

    Threads: [peer: UDP robot sim] ← UDP → [servo thread: RateLoop at
    low_rate, cmd bus → LowCmd, LowState → feedback bus] ↔ seqlock buses ↔
    [calling thread: RateLoop at mpc_rate, estimator + MPC + torque tick].

    ``est_rate > 0`` enables the THREE-tier shape of the reference
    (Main.cpp:88-207): an estimator thread runs FK + contact detection +
    BasicKF at ``est_rate`` (at least mpc_rate) against the freshest sensor
    frame and publishes estimates on a third seqlock bus; the MPC thread
    consumes the freshest estimate instead of folding the KF into its tick.

    Operator flow (BaseInterface.cpp:135-192): a scripted B-press engages
    the default-pose / stand-up servo for ``prime_s`` seconds (the estimator
    converges from its cold 0.09 m prior), a second B-press hands over to
    MPC standing balance for ``duration_s``; with ``walk_s > 0`` an A-press
    then engages the trot at ``velx`` m/s for ``walk_s`` seconds and a final
    A-press returns to standing for another ``duration_s``.

    ``joy_provider``: optional callable ``(k, scripted_joy) -> JoySample``
    overriding the scripted operator (the hook `runtime.teleop.HighLevelBridge`
    drives). ``state_sink``: optional callable ``(k, info, sensors)`` invoked
    after every MPC tick (the HighState publishing hook).

    ``async_mpc``: one-tick-delay dispatch: each tick's launches are queued
    and the PREVIOUS tick's command is published (pulled after an event
    recorded behind that tick, so the pull does not wait for the new one).
    ``async_pullers > 0``: the pool dispatch: the MPC thread queues the
    tick's launches on its stream and records an event; a pool of puller
    threads waits on the event, copies the command to the host on a stream
    of its own and publishes it under a sequence guard (publish-if-newer).
    The tick then compensates the publish delay (``lead``). Both modes were
    built for a backend whose result pull costs a long round trip; on the
    card the MPC thread's time is the replayed tick's device time, which
    the pool takes off its path (100 Hz). They are kept for ``cli
    run_hardware --async_mpc / --pullers`` and the lead path.

    ``auto_rate``: if the measured warm tick cannot fit 80% of the requested
    MPC period, the MPC rate is lowered to the largest rate the platform
    sustains, and the summary records both. False keeps the requested rate
    and counts the overruns.

    Returns a summary dict (rates achieved, estimator error, drift speed,
    height error, overrun counts) with the JAX package's keys.
    """
    device = resolve_device(device)
    if opts is None:
        opts = SolverOptions(al_iterations=1, ilqr_iterations=3)
    dt_ctrl = 1.0 / mpc_rate
    dt_low = 1.0 / low_rate
    with _on(_stream(device)):  # the calling thread's launches on a stream of its own
        wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype,
                                           device=device)
        terrain = terrain_mod.make_terrain("flat", dtype=dtype, device=device)
        ap = art_mod.default_params(wts.mass, wts.inertia, wts.com_offset, wts.trunk_mass, terrain,
                                    dtype, device)
        rs = art_mod.init_state(height=target_height, rho_fix=ap.rho_fix, dtype=dtype,
                                device=device)
        full = lambda v: torch.full((), v, dtype=dtype, device=device)
        # the goal filter's window from the REQUESTED rate: auto_rate may lower
        # the rate later, and then a stop command decays a little more slowly
        window = max(1, int(round(0.5 * mpc_rate)))
        three_tier = est_rate > 0.0
        dt0 = full(dt_ctrl)
        lead0 = full(0.0)
        joy_neutral = goals.neutral_joy_sample(dtype, device)

        # every graph is captured (on the card) before any thread starts: the
        # peer's period here, the tick's parts below from the plant's initial
        # sensors (example values; each replay copies its own inputs in)
        peer = SimGo1Peer(ap, rs, dt_cmd=dt_low, n_sub=max(2, int(round(dt_low / 0.000125))))
        fused = make_hw_control_tick(horizon, opts)
        consts = (wts, ap.rho_fix, ap.kp_joint, ap.kd_joint)
        sensors_x = split_sensors(observe(rs, rs, ap, dt_low))
        carry_x = init_hw_carry(sensors_x, ap.rho_fix, target_height, window=window)
        if three_tier:
            est_step = loop_step(fused, "est", *consts, carry_x.kf, (sensors_x, dt0))
            mpc_step = loop_step(fused, "ctrl", *consts, carry_x,
                                 (sensors_x, carry_x.kf.x[0:3], carry_x.kf.x[3:6], dt0,
                                  joy_neutral, lead0))
        else:
            mpc_step = loop_step(fused, "tick", *consts, carry_x,
                                 (sensors_x, dt0, joy_neutral, lead0))
        peer.start()

        link = unitree.HardwareLink("127.0.0.1", peer.udp.local_port)
        # the sim peer has no force offset (bias_samples=0); an 8 ms force
        # filter (the reference smooths 40 ms of its 1 kHz hardware forces,
        # HardwareInterface.cpp:139-152, which at this loop's rate mistimes the
        # early-contact transitions)
        link.force_proc = unitree.FootForceProcessor(
            bias_samples=0, window=max(1, int(round(0.008 * low_rate)))
        )

        cmd_bus = native.StateBus(_CMD_BYTES)
        fbk_bus = native.StateBus(_SENSOR_BYTES)
        stop_evt = threading.Event()
        servo_stats = {"ticks": 0, "states": 0, "overruns": 0}

        def servo_loop():
            loop = native.RateLoop(dt_low, realtime_priority)
            while not stop_evt.is_set():
                loop.wait()
                seq, data = cmd_bus.read()
                if seq > 0:
                    flat = np.frombuffer(data, np.float32, count=60).reshape(12, 5)
                    cmd = unitree.LowCmd()
                    for i in range(12):
                        m = cmd.motor_cmd[i]
                        m.q, m.dq, m.tau, m.Kp, m.Kd = [float(v) for v in flat[i]]
                    link.send_cmd(cmd)
                # drain to the freshest LowState
                st = None
                while True:
                    nxt = link.recv_state()
                    if nxt is None:
                        break
                    st = nxt
                if st is not None:
                    fbk_bus.write(_sensors_to_bytes(st))
                    servo_stats["states"] += 1
                servo_stats["ticks"] += 1
            servo_stats["overruns"] = loop.overruns

        servo = threading.Thread(target=servo_loop, daemon=True)
        servo.start()

        # the first servo tick has no command yet: hold the initial pose with the
        # reference's per-joint-type stand gains (GazeboInterface.cpp:85-111)
        hold = np.zeros((12, 5), np.float32)
        hold[:, 0] = rs.q.reshape(-1).cpu().numpy()
        hold[:, 3] = np.asarray(PRIME_KP, np.float32).reshape(-1)
        hold[:, 4] = np.asarray(PRIME_KD, np.float32).reshape(-1)
        cmd_bus.write(hold.tobytes())

        # wait for the first sensor frame through the full UDP round trip
        t0 = time.time()
        while time.time() - t0 < 5.0:
            seq, data = fbk_bus.read()
            if seq > 0:
                break
            time.sleep(0.002)
        else:  # pragma: no cover - startup failure path
            stop_evt.set()
            peer.stop()
            raise TimeoutError("no LowState received from the sim peer")

        sensors0, tick0 = _sensors_from_bytes(data, dtype, device)
        carry = init_hw_carry(sensors0, ap.rho_fix, target_height, window=window)
        true_ = torch.ones((), dtype=torch.bool, device=device)
        joy_press_b = joy_neutral._replace(default_pos=true_)
        pull_stream = _stream(device)  # the MPC thread's pulls behind an event

        def _run_tick(c, sensors, dt, joy, lead, est=None):
            if three_tier:
                return mpc_step(c, sensors, est[0], est[1], dt, joy, lead)
            return mpc_step(c, sensors, dt, joy, lead)

        # time three warm ticks in a chain, as the loop runs them (the MPC tier
        # sets the loop rate), each with its pull to the host
        est_w = None
        if three_tier:
            _kf, pv = est_step(carry.kf, sensors0, dt0)
            est_w = (pv[0:3], pv[3:6])
        c_w, cmd_mat, info = _run_tick(carry, sensors0, dt0, joy_neutral, lead0, est_w)
        _pull(cmd_mat)
        t0 = time.perf_counter()
        for _ in range(3):
            c_w, cmd_w, _ = _run_tick(c_w, sensors0, dt0, joy_neutral, lead0, est_w)
            _pull(cmd_w)
        tick_wall = (time.perf_counter() - t0) / 3.0
        est_wall = 0.0
        if three_tier:
            kf_w = carry.kf
            t0 = time.perf_counter()
            for _ in range(3):
                kf_w, pv = est_step(kf_w, sensors0, dt0)
                _pull(pv)
            est_wall = (time.perf_counter() - t0) / 3.0

        tick_wall_sync = tick_wall
        if async_mpc:
            # pipelined per-tick time: a chain of ticks pulling only the LAST
            # result, the rate bound the one-tick-delay loop pays
            t0 = time.perf_counter()
            c_w, cmd_last = carry, None
            for _ in range(4):
                c_w, cmd_last, _ = _run_tick(c_w, sensors0, dt0, joy_neutral, lead0, est_w)
            _pull(cmd_last)
            tick_wall = (time.perf_counter() - t0) / 4.0

        if async_pullers > 0:
            # pool mode rate bound: the MPC thread pays only the ENQUEUE time a
            # tick; the pool sustains async_pullers concurrent pulls
            c_w2 = carry
            t0 = time.perf_counter()
            for _ in range(8):
                c_w2, cmd_enq, _ = _run_tick(c_w2, sensors0, dt0, joy_neutral, lead0, est_w)
            enqueue_wall = (time.perf_counter() - t0) / 8.0
            _pull(cmd_enq)  # drain the chain
            rtt = max(tick_wall_sync, 1e-4)
            tick_wall = max(enqueue_wall, rtt / async_pullers)
        else:
            enqueue_wall = 0.0

        # publish-time lead for the compensated tick outputs: in pool mode a
        # command applies ~one sync tick after its sensors
        lead_run = full(tick_wall_sync if async_pullers > 0 else 0.0)

        mpc_rate_req = mpc_rate
        if auto_rate and tick_wall > 0.8 * dt_ctrl:
            dt_ctrl = tick_wall / 0.8
            mpc_rate = 1.0 / dt_ctrl

        est_rate_req = est_rate
        est_stats = {"ticks": 0, "updates": 0, "overruns": 0}
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # the carry is complete before threads read it
        if three_tier:
            # the estimator runs at least at the MPC rate (it feeds the MPC);
            # degrade from the requested rate only if its tick cannot fit
            est_rate = max(est_rate, mpc_rate)
            if auto_rate and est_wall > 0.8 / est_rate:
                est_rate = max(mpc_rate, 0.8 / est_wall)
            dt_est = 1.0 / est_rate
            est_bus = native.StateBus(_EST_BYTES)

            def est_loop():
                with _on(_stream(device)):
                    loop = native.RateLoop(dt_est, realtime_priority)
                    kf_state = carry.kf
                    last_tick_e = tick0
                    while not stop_evt.is_set():
                        loop.wait()
                        seq, data = fbk_bus.read()
                        if seq == 0:
                            continue
                        sensors_e, sim_tick_e = _sensors_from_bytes(data, dtype, device)
                        dt_e = min(max(sim_tick_e - last_tick_e, 0) * dt_low, 5.0 * dt_est)
                        last_tick_e = sim_tick_e
                        # one pull a tick: pos and vel as one vector
                        kf_state, pv_t = est_step(kf_state, sensors_e, full(dt_e))
                        pv = _pull(pv_t)
                        est_bus.write(_est_to_bytes(pv[:3], pv[3:6], sim_tick_e))
                        est_stats["ticks"] += 1
                        if dt_e > 0:
                            est_stats["updates"] += 1
                    est_stats["overruns"] = loop.overruns

            est_thread = threading.Thread(target=est_loop, daemon=True)
            est_thread.start()
            # wait for the first published estimate
            t0 = time.time()
            while time.time() - t0 < 5.0:
                seq, _ = est_bus.read()
                if seq > 0:
                    break
                time.sleep(0.002)
            else:  # pragma: no cover - startup failure path
                stop_evt.set()
                peer.stop()
                raise TimeoutError("estimator thread published no estimate")

        n_prime = max(1, int(round(prime_s * mpc_rate)))
        n_ticks = max(1, int(round(duration_s * mpc_rate)))
        n_walk = int(round(walk_s * mpc_rate))
        # phase boundaries: prime | stand | [walk | stand]
        t_walk_on = n_prime + n_ticks
        t_walk_off = t_walk_on + n_walk
        total = t_walk_off + (n_ticks if n_walk else 0)
        joy_press_a = joy_neutral._replace(mode_switch=true_)
        joy_walk = joy_neutral._replace(velx=full(velx))
        loop = native.RateLoop(dt_ctrl, realtime_priority)
        pending = None  # async_mpc one-slot pipeline: (event, packed, info) of tick k-1

        # pool mode: puller threads copy each tick's command to the host behind
        # its event and publish it under a sequence guard; per-tick results are
        # recorded for the bookkeeping after the run
        use_pool = async_pullers > 0
        pub_state = {"last_k": -1, "published": 0, "stale_dropped": 0,
                     "enqueue_dropped": 0, "staleness": []}
        pub_lock = threading.Lock()
        res_by_k, true_by_k = {}, {}
        work_q = None
        pool = []
        cmd_size = 60
        if use_pool:
            work_q = queue.Queue(maxsize=4 * async_pullers)

            def _puller():
                stream = _stream(device)
                with _on(stream):
                    while True:
                        item = work_q.get()
                        if item is None:
                            return
                        k_i, ev_i, packed_i, info_i, sensors_i, t_disp = item
                        buf = _pull(packed_i, ev_i, stream)
                        cmd_np = buf[:cmd_size].reshape(12, 5)
                        with pub_lock:
                            if k_i > pub_state["last_k"]:
                                cmd_bus.write(cmd_np.tobytes())
                                pub_state["last_k"] = k_i
                                pub_state["published"] += 1
                                pub_state["staleness"].append(time.perf_counter() - t_disp)
                            else:
                                pub_state["stale_dropped"] += 1
                            res_by_k[k_i] = (buf[cmd_size:cmd_size + 3], float(buf[-1]))
                        if state_sink is not None:
                            if stream is not None:  # info and sensors are the MPC stream's
                                stream.wait_event(ev_i)
                            state_sink(k_i, info_i, sensors_i)
                            if stream is not None:  # done with them before they are freed
                                stream.synchronize()

            pool = [threading.Thread(target=_puller, daemon=True) for _ in range(async_pullers)]
            for t in pool:
                t.start()

        # real-time hygiene: a CPython gen-2 GC pause lands inside a period and
        # trips the pipeline; collect once, then hold GC off for the RT section.
        # A thread waiting for the GIL waits up to the switch interval (5 ms by
        # default, longer than the servo's period) before the holder must let
        # it go; a shorter one keeps the servo and the peer on their periods
        gc.collect()
        gc_was_enabled = gc.isenabled()
        gc.disable()
        switch_was = sys.getswitchinterval()
        sys.setswitchinterval(RT_SWITCH_INTERVAL_S)
        costs, est_err = [], []
        mpc_pos0 = stand_last = None  # stand-phase endpoints (drift metric)
        walk_start = walk_end = None
        trace = []
        last_tick = tick0
        last_est = last_true = np.zeros(3)
        for k in range(total):
            loop.wait()
            seq, data = fbk_bus.read()
            sensors, sim_tick = _sensors_from_bytes(data, dtype, device)
            kf_est = None
            if three_tier:
                _eseq, edata = est_bus.read()
                pos_e, vel_e, _etick = _est_from_bytes(edata, dtype, device)
                kf_est = (pos_e, vel_e)
            # sim-clock dt; 0 when the frame is a repeat (the tick then skips the
            # KF measurement update), capped at 5 nominal periods after a stall
            dt_sim = min(max(sim_tick - last_tick, 0) * dt_low, 5.0 * dt_ctrl)
            last_tick = sim_tick
            # scripted operator: B on / off around the prime window, A on / off
            # around the walk window
            if k in (0, n_prime):
                joy = joy_press_b
            elif n_walk and k == t_walk_on:
                joy = joy_press_a._replace(velx=joy_walk.velx)
            elif n_walk and k == t_walk_off:
                joy = joy_press_a
            elif n_walk and t_walk_on < k < t_walk_off:
                joy = joy_walk
            else:
                joy = joy_neutral
            if joy_provider is not None:
                joy = joy_provider(k, joy)
            carry, cmd_mat, info = _run_tick(carry, sensors, full(dt_sim), joy, lead_run, kf_est)
            if use_pool:
                # enqueue only: a puller pays the pull off this loop's path
                true_pos = peer.true_pos
                true_by_k[k] = true_pos
                last_true = true_pos
                packed = torch.cat([cmd_mat.reshape(-1), info["est_pos"],
                                    info["mpc_cost"].reshape(1)]).to(torch.float32)
                try:
                    work_q.put_nowait((k, _mark(device), packed, info, sensors,
                                       time.perf_counter()))
                except queue.Full:
                    pub_state["enqueue_dropped"] += 1  # pool saturated: skip tick
                if n_prime <= k < t_walk_on:
                    if mpc_pos0 is None:
                        mpc_pos0 = true_pos
                    stand_last = true_pos
                if n_walk and k == t_walk_on:
                    walk_start = true_pos
                if n_walk and k == t_walk_off:
                    walk_end = true_pos
                continue
            # the command, the estimate and the cost in one pull, in the tick's dtype
            packed = torch.cat([cmd_mat.reshape(-1), info["est_pos"], info["mpc_cost"].reshape(1)])
            if async_mpc:
                # one-tick-delay mode: tick k's launches are queued; publish tick
                # k-1's command, pulled behind k-1's own event
                fresh = (_mark(device), packed, info)
                if pending is None:
                    pending = fresh
                    continue
                (ev, packed, info), pending = pending, fresh
                buf = _pull(packed, ev, pull_stream)
            else:
                buf = _pull(packed)
            cmd_bus.write(buf[:cmd_size].astype(np.float32).tobytes())
            if state_sink is not None:
                state_sink(k, info, sensors)
            true_pos = peer.true_pos
            last_est = buf[cmd_size:cmd_size + 3]
            last_true = true_pos
            if n_prime <= k < t_walk_on:
                if mpc_pos0 is None:
                    mpc_pos0 = true_pos
                stand_last = true_pos
                costs.append(float(buf[-1]))
                est_err.append(float(np.linalg.norm(last_est - true_pos)))
            if n_walk and k == t_walk_on:
                walk_start = true_pos
            if n_walk and k == t_walk_off:
                walk_end = true_pos
            if debug_trace:
                trace.append({
                    "k": k, "dt_sim": round(dt_sim, 4),
                    "mode": int(info["movement_mode"]),
                    "prime": bool(info["in_prime"]),
                    "pos": [round(float(v), 4) for v in peer.true_pos],
                    "qw": round(float(abs(peer.true_quat[0])), 4),
                    "vel": [round(float(v), 3) for v in peer.true_vel],
                })
        mpc_overruns = loop.overruns
        sys.setswitchinterval(switch_was)
        if gc_was_enabled:
            gc.enable()

        if use_pool:
            for _ in pool:
                work_q.put(None)
            for t in pool:
                t.join(timeout=15.0)
            # pair the pulled estimates with the true positions recorded at
            # dispatch time
            for k_i in sorted(res_by_k):
                if n_prime <= k_i < t_walk_on and k_i in true_by_k:
                    est_p, cost_i = res_by_k[k_i]
                    costs.append(cost_i)
                    est_err.append(float(np.linalg.norm(est_p - true_by_k[k_i])))
            if res_by_k:
                last_est = res_by_k[max(res_by_k)][0]

        stop_evt.set()
        servo.join(timeout=2.0)
        if three_tier:
            est_thread.join(timeout=2.0)
        peer.stop()
        peer.join(timeout=2.0)

        height = float(peer.true_pos[2])
        quat_w = float(abs(peer.true_quat[0]))
        mpc_span_s = n_ticks * dt_ctrl
        drift = (
            float(np.linalg.norm((stand_last - mpc_pos0)[:2])) / mpc_span_s
            if mpc_pos0 is not None else float("nan")
        )
        return {
            "mpc_rate_requested": mpc_rate_req,
            "mpc_rate_used": mpc_rate,
            "three_tier": three_tier,
            "est_rate_requested": est_rate_req,
            "est_rate_used": est_rate if three_tier else mpc_rate,
            "est_ticks": est_stats["ticks"],
            "est_updates": est_stats["updates"],
            "est_overruns": int(est_stats["overruns"]),
            "est_tick_wall_ms": est_wall * 1e3,
            "tick_wall_ms": tick_wall * 1e3,
            "tick_wall_sync_ms": tick_wall_sync * 1e3,
            "async_mpc": async_mpc,
            "async_pullers": async_pullers,
            "cmds_published": pub_state["published"],
            "cmds_stale_dropped": pub_state["stale_dropped"],
            "cmds_enqueue_dropped": pub_state["enqueue_dropped"],
            "publish_staleness_ms_p50": (
                float(np.median(pub_state["staleness"]) * 1e3) if pub_state["staleness"] else 0.0
            ),
            "enqueue_wall_ms": enqueue_wall * 1e3,
            "prime_ticks": n_prime,
            "mpc_ticks": n_ticks,
            "mpc_overruns": int(mpc_overruns),
            "servo_ticks": servo_stats["ticks"],
            "servo_states": servo_stats["states"],
            "servo_overruns": int(servo_stats["overruns"]),
            "peer_cmds_served": peer.cmds_served,
            "final_height": height,
            "height_err": abs(height - target_height),
            "final_quat_w": quat_w,
            "mean_mpc_cost": float(np.mean(costs)),
            "final_est_err": est_err[-1],
            "drift_speed_mps": drift,
            "final_est_pos": [float(v) for v in last_est],
            "final_true_pos": [float(v) for v in last_true],
            "walk_ticks": n_walk,
            "walk_distance_m": (
                float(np.linalg.norm((walk_end - walk_start)[:2])) if walk_end is not None else 0.0
            ),
            "upright": quat_w > 0.95 and height > 0.15,
            **({"trace": trace} if debug_trace else {}),
        }
