"""The port's hardware control tick against the JAX tick, in f64 on the same
numpy inputs: the sensor and estimate frame codecs (exact), the feedback
tier `est_core` (1e-10), the joystick mode machine over an edge script
(exact), the whole tick from the JAX tick's own carry through the operator
flow (prime, B handover, stand, A to walk, walk, A back to stand) with the
publish lead 0 and 0.02, the sim peer's step and observation, and the
mode machine and the stand-up ramp through the port's tick alone. Nothing
here runs a thread or asserts a time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quaternion_mpc_tpu_torch
from quaternion_mpc_tpu.control import goals as jgoals
from quaternion_mpc_tpu.control import quat_mpc as jquat
from quaternion_mpc_tpu.control import standup as jstandup
from quaternion_mpc_tpu.control import torque as jtorque
from quaternion_mpc_tpu.control.types import RobotFeedback
from quaternion_mpc_tpu.est import kf as jkf
from quaternion_mpc_tpu.gait import schedule as jsched
from quaternion_mpc_tpu.kin import leg as jleg
from quaternion_mpc_tpu.ops import lie as jlie
from quaternion_mpc_tpu.runtime import hardware_loop as jhw
from quaternion_mpc_tpu.runtime import unitree as jut
from quaternion_mpc_tpu.sim import articulated as jart
from quaternion_mpc_tpu.sim import terrain as jterrain
from quaternion_mpc_tpu.solver import SolverOptions as JOpts
from quaternion_mpc_tpu.utils import config as jcfg
from quaternion_mpc_tpu_torch import _bridge
from quaternion_mpc_tpu_torch.control import goals as tgoals
from quaternion_mpc_tpu_torch.control import standup as tstandup
from quaternion_mpc_tpu_torch.runtime import hardware_loop as thw
from quaternion_mpc_tpu_torch.solver.problem import SolverOptions as TOpts
from quaternion_mpc_tpu_torch.utils.tree import tree_leaves

quaternion_mpc_tpu_torch.set_default_device("cpu")

JD, TD = jnp.float64, torch.float64
TARGET_H = 0.3
DT_CTRL = 0.02  # the loop's 50 Hz
CMD_RTOL = 1e-5  # of cmd_mat's scale: the controllers agree to 1e-5 N on the forces
PEER_RTOL = 1e-4  # of scale: a stick / slip flip can move a joint velocity that far


def _jax_setup():
    wts = jquat.weights_from_config(jcfg.gazebo_go1_quat_mpc(), dtype=JD)
    terrain = jterrain.make_terrain("flat", dtype=JD)
    ap = jart.default_params(wts.mass, wts.inertia, wts.com_offset, wts.trunk_mass, terrain, JD)
    rs = jart.init_state(height=TARGET_H, rho_fix=ap.rho_fix, dtype=JD)
    return wts, ap, rs


def _observe(rs, rs_prev, ap, dt):
    """The sensor frame of a plant state (the JAX peer's observation)."""
    _, foot_world, foot_vel_world, _ = jart.foot_kinematics(rs, ap)
    f_world, _ = jart.contact_forces(foot_world, foot_vel_world, ap, rs.anchor)
    n_vec = jterrain.normal(ap.terrain, foot_world[..., :2])
    a_world = (rs.torso.vel - rs_prev.torso.vel) / dt
    rot = jlie.quat_to_rotmat(rs.torso.quat)
    return jhw.HWSensors(
        quat=rs.torso.quat, gyro=rs.torso.omega,
        accel=rot.T @ (a_world + jnp.array([0.0, 0.0, 9.81], JD)),
        q=rs.q.reshape(-1), dq=rs.dq.reshape(-1), foot_force=jnp.sum(f_world * n_vec, -1),
    )


def _init_carry(sensors, ap, window=25):
    rot0 = jlie.quat_to_rotmat(jlie.quat_normalize(sensors.quat))
    foot_body0 = jleg.fk(sensors.q.reshape(4, 3), ap.rho_fix)
    prior = jnp.array([0.0, 0.0, 0.09], JD)  # cold KF prior
    fbk0 = RobotFeedback(
        torso_pos_world=prior, torso_quat=jlie.quat_normalize(sensors.quat),
        torso_lin_vel_world=jnp.zeros(3, JD), torso_ang_vel_body=sensors.gyro,
        foot_pos_body=foot_body0, foot_contact=jnp.ones(4, JD), joint_pos=sensors.q,
        joint_vel=sensors.dq,
    )
    return jhw.HWCarry(
        goal=jgoals.init_goal_state(fbk0, window=window),
        kf=jkf.init_state(rot0, foot_body0, dtype=JD),
        mode=jgoals.init_mode_state(TARGET_H, JD),
        standup=jstandup.init_standup(sensors.q),
        gait=jsched.init_gait_state(prior + foot_body0 @ rot0.T,
                                    jsched.trot_with_stand_pattern()),
    )


def _peer_step(ap, dt, n_sub):
    """The JAX SimGo1Peer's step on a plant state and a (12, 5) command."""
    def step(rs, cmd_mat):
        cm = cmd_mat.reshape(4, 3, 5)
        targets = jtorque.JointTargets(q=cm[..., 0], dq=cm[..., 1], tau=cm[..., 2])
        new_rs = jart.step(rs, targets, ap._replace(kp_joint=cm[..., 3], kd_joint=cm[..., 4]),
                           dt, n_sub)
        s = _observe(new_rs, rs, ap, dt)
        return new_rs, jnp.concatenate([s.quat, s.gyro, s.accel, s.q, s.dq, s.foot_force])

    return jax.jit(step)


def _t(tree):
    return _bridge.port_tree(tree, "cpu", TD)


def _close(got, want, rtol, what, scale=None):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = float(np.max(np.abs(want))) if scale is None else scale
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * max(scale, 1e-300), f"{what}: max|err| {err:.3e} > {rtol:.0e} x {scale:.3e}"


def _trees_close(got, want, rtol, what):
    for i, (g, w) in enumerate(zip(tree_leaves(got), jax.tree.leaves(want))):
        w = np.asarray(w)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what} leaf {i}")
        else:
            _close(g, w, rtol, f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# frame codecs
# ---------------------------------------------------------------------------


def _low_state(seed, tick):
    rng = np.random.default_rng(seed)
    st = jut.LowState(quaternion=rng.normal(size=4), gyroscope=rng.normal(size=3),
                      accelerometer=rng.normal(size=3), foot_force=rng.uniform(0, 80, 4),
                      tick=tick)
    for m in st.motor_state:
        m.q, m.dq = (float(v) for v in rng.normal(size=2))
    return st


@pytest.mark.parametrize("tick", [0, 7, 2**24 + 3, 2**32 - 1])
def test_sensor_and_estimate_frames_are_the_references(tick):
    st = _low_state(tick % 97, tick)
    data = thw._sensors_to_bytes(st)
    assert data == jhw._sensors_to_bytes(st)
    sensors, t_tick = thw._sensors_from_bytes(data, TD)
    jsensors, j_tick = jhw._sensors_from_bytes(data, JD)
    assert t_tick == j_tick == tick  # exact past 2^24: the tick travels as uint32 bits
    for f in thw.HWSensors._fields:
        np.testing.assert_array_equal(getattr(sensors, f).numpy(), np.asarray(getattr(jsensors, f)))
        assert getattr(sensors, f).dtype == TD
    low = thw.sensors_from_lowstate(st, TD)
    jlow = jhw.sensors_from_lowstate(st, JD)
    for f in thw.HWSensors._fields:
        np.testing.assert_array_equal(getattr(low, f).numpy(), np.asarray(getattr(jlow, f)))

    pos, vel = np.array([0.1, -0.2, 0.29]), np.array([0.3, 0.0, -0.01])
    edata = thw._est_to_bytes(pos, vel, tick)
    assert edata == jhw._est_to_bytes(pos, vel, tick)
    p, v, k = thw._est_from_bytes(edata, TD)
    jp, jv, jk = jhw._est_from_bytes(edata, JD)
    assert k == jk == tick
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# the joystick mode machine
# ---------------------------------------------------------------------------


def test_joy_mode_update_matches_the_reference_over_an_edge_script():
    jn, tn = jgoals.neutral_joy_sample(JD), tgoals.neutral_joy_sample(TD)
    script = [  # (field, value) overrides a tick
        {}, {"default_pos": True}, {"velz": 0.4}, {"default_pos": True, "velz": -2.0},
        {"mode_switch": True, "velx": 0.3}, {"velx": 0.3, "yaw_rate": 0.2},
        {"mode_switch": True}, {"default_pos": True}, {"zero_torque": True},
        {"sin_ang_vel": True, "velz": 9.0}, {"mode_switch": True, "default_pos": True},
        {"exit": True}, {}, {"mode_switch": True, "zero_torque": True},
    ]
    jstate, tstate = jgoals.init_mode_state(TARGET_H, JD), tgoals.init_mode_state(TARGET_H, TD)
    for k, over in enumerate(script):
        jjoy = jn._replace(**{f: jnp.asarray(v, JD if isinstance(v, float) else None)
                              for f, v in over.items()})
        tjoy = _bridge.joy_sample(jjoy, "cpu", TD)
        dt = 0.02 if k % 3 else 0.01
        jstate, jcmd, jmove = jgoals.joy_mode_update(jstate, jjoy, dt)
        tstate, tcmd, tmove = tgoals.joy_mode_update(tstate, tjoy, dt)
        assert int(tmove) == int(jmove) and tmove.dtype == torch.int32
        for got, want in ((tstate, jstate), (tcmd, jcmd)):
            for f in got._fields:
                g, w = getattr(got, f), np.asarray(getattr(want, f))
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"tick {k} {f}")
                assert (g.dtype == torch.bool) == (w.dtype == np.bool_), f
    assert bool(tstate.exit)  # latched


# ---------------------------------------------------------------------------
# the tick, from the JAX tick's own carry through the operator flow
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flow():
    """The JAX operator flow against the JAX plant (horizon 6, 1 x 3, as
    the loop): at each tick its carry, sensors, dt and joystick, and the
    JAX tick's outputs at lead 0 (which the flow follows) and 0.02."""
    wts, ap, rs = _jax_setup()
    tick_fn = jax.jit(jhw.make_hw_control_tick(6, JOpts(al_iterations=1, ilqr_iterations=3)))
    peer = _peer_step(ap, DT_CTRL, int(DT_CTRL / 0.000125))
    sensors = _observe(rs, rs, ap, DT_CTRL)
    carry = _init_carry(sensors, ap)
    jn = jgoals.neutral_joy_sample(JD)
    b, a = jn._replace(default_pos=jnp.asarray(True)), jn._replace(mode_switch=jnp.asarray(True))
    walk = jn._replace(velx=jnp.asarray(0.3, JD))
    script = ([("prime on", b)] + [("prime", jn)] * 6 + [("handover", b)] + [("stand", jn)] * 4
              + [("walk on", a._replace(velx=walk.velx))] + [("walk", walk)] * 8
              + [("walk off", a)] + [("stand after walk", jn)] * 3)
    records = []
    for k, (label, joy) in enumerate(script):
        dt = jnp.asarray(0.0 if label == "stand" and k == 9 else DT_CTRL, JD)  # one repeated frame
        outs = {lead: tick_fn(carry, sensors, dt, joy, wts, ap.rho_fix, ap.kp_joint, ap.kd_joint,
                              jnp.asarray(lead, JD)) for lead in (0.0, 0.02)}
        records.append(dict(label=label, carry=carry, sensors=sensors, dt=dt, joy=joy, outs=outs,
                            rs=rs))
        carry, cmd_mat, _ = outs[0.0]
        rs_prev, rs = rs, None
        rs, _ = peer(rs_prev, cmd_mat)
        sensors = _observe(rs, rs_prev, ap, DT_CTRL)
    return dict(wts=wts, ap=ap, records=records)


@pytest.fixture(scope="module")
def port_tick():
    return thw.make_hw_control_tick(6, TOpts(al_iterations=1, ilqr_iterations=3))


def test_the_flow_covers_every_mode(flow):
    seen = {(r["label"], bool(r["outs"][0.0][2]["in_prime"]),
             int(r["outs"][0.0][2]["movement_mode"])) for r in flow["records"]}
    assert ("prime", True, 0) in seen and ("stand", False, 0) in seen
    assert ("walk", False, 1) in seen and ("stand after walk", False, 0) in seen


@pytest.mark.parametrize("lead", [0.0, 0.02])
@pytest.mark.parametrize("phase", ["prime on", "prime", "handover", "stand", "walk on", "walk",
                                   "walk off", "stand after walk"])
def test_tick_matches_the_reference_from_its_carry(flow, port_tick, phase, lead):
    wts, ap = _t(flow["wts"]), _t(flow["ap"])
    records = [r for r in flow["records"] if r["label"] == phase]
    for r in records:
        jcarry, jcmd, jinfo = r["outs"][lead]
        carry, cmd, info = port_tick(
            _bridge.hw_carry(r["carry"], "cpu", TD), _bridge.hw_sensors(r["sensors"], "cpu", TD),
            _bridge.tensor(r["dt"], "cpu", TD), _bridge.joy_sample(r["joy"], "cpu", TD), wts,
            ap.rho_fix, ap.kp_joint, ap.kd_joint, torch.full((), lead, dtype=TD))
        what = f"{phase} (lead {lead})"
        assert bool(info["in_prime"]) == bool(jinfo["in_prime"]), what
        assert int(info["movement_mode"]) == int(jinfo["movement_mode"]), what
        jcmd = np.asarray(jcmd)
        if bool(jinfo["in_prime"]):  # the stand-up servo's rows, exactly
            np.testing.assert_array_equal(cmd.numpy(), jcmd, err_msg=what)
        else:
            _close(cmd, jcmd, CMD_RTOL, f"{what} cmd_mat")
        _close(info["est_pos"], jinfo["est_pos"], 1e-10, f"{what} est_pos")
        _close(info["est_vel"], jinfo["est_vel"], 1e-10, f"{what} est_vel", scale=1.0)
        _close(info["mpc_cost"], jinfo["mpc_cost"], 1e-6, f"{what} mpc_cost")
        for f in ("mode", "standup", "kf"):
            _trees_close(getattr(carry, f), getattr(jcarry, f), 1e-10, f"{what} carry.{f}")
        _trees_close(carry.gait, jcarry.gait, 1e-8, f"{what} carry.gait")
        _trees_close(carry.goal, jcarry.goal, 1e-8, f"{what} carry.goal")
        _close(carry.prev_grf, jcarry.prev_grf, CMD_RTOL, f"{what} carry.prev_grf")


def test_est_core_matches_the_reference(flow):
    jtick = jhw.make_hw_control_tick(6, JOpts(al_iterations=1, ilqr_iterations=3))
    ttick = thw.make_hw_control_tick(6, TOpts(al_iterations=1, ilqr_iterations=3))
    rho = flow["ap"].rho_fix
    for r in flow["records"][::4]:
        for dt in (DT_CTRL, 0.0):  # dt 0: a repeated frame keeps the estimate
            jout = jtick.est_core(r["carry"].kf, r["sensors"], jnp.asarray(dt, JD), rho)
            tout = ttick.est_core(_bridge.port_tree(r["carry"].kf, "cpu", TD),
                                  _bridge.hw_sensors(r["sensors"], "cpu", TD),
                                  torch.full((), dt, dtype=TD), _bridge.tensor(rho, "cpu", TD))
            _trees_close(tout[0], jout[0], 1e-10, f"{r['label']} kf (dt {dt})")
            for i, name in enumerate(("pos", "vel", "contact", "foot_body"), start=1):
                _close(tout[i], jout[i], 1e-10, f"{r['label']} {name} (dt {dt})", scale=1.0)
            if dt == 0.0:
                np.testing.assert_array_equal(tout[0].x.numpy(), np.asarray(r["carry"].kf.x))


def test_init_hw_carry_is_the_references_power_on_carry(flow):
    """The loop's power-on carry from a sensor frame, against the JAX loop's
    (`run_hardware_loopback` builds it inline), and the observation it
    starts from."""
    wts, ap, rs = _jax_setup()
    jsensors = _observe(rs, rs, ap, DT_CTRL)
    tap, trs = _t(ap), _t(rs)
    obs = thw.observe(trs, trs, tap, DT_CTRL)
    sensors = thw.split_sensors(obs)
    for f in thw.HWSensors._fields:
        _close(getattr(sensors, f), getattr(jsensors, f), 1e-12, f"observed {f}", scale=1.0)
    carry = thw.init_hw_carry(sensors, tap.rho_fix, TARGET_H, window=25)
    jcarry = _init_carry(jsensors, ap)._replace(prev_grf=jnp.zeros((4, 3), JD))
    for f in thw.HWCarry._fields:
        _trees_close(getattr(carry, f), getattr(jcarry, f), 1e-12, f"carry.{f}")


# ---------------------------------------------------------------------------
# the sim peer
# ---------------------------------------------------------------------------


def test_peer_step_matches_the_reference(flow):
    """The port's SimGo1Peer step (the plain articulated plant here) and its
    observation against the JAX peer's, from JAX plant states of the flow,
    at n_sub = 4 over one 4 ms servo period."""
    ap = flow["ap"]
    jpeer = _peer_step(ap, 0.004, 4)
    tap = _t(ap)
    records = [r for r in flow["records"] if r["label"] in ("stand", "walk")][::3]
    peer = thw.SimGo1Peer(tap, _t(records[0]["rs"]), dt_cmd=0.004, n_sub=4)
    for r in records:
        cmd = r["outs"][0.0][1]
        jrs, jobs = jpeer(r["rs"], cmd)
        rs, obs = peer._step(_t(r["rs"]), _bridge.tensor(cmd, "cpu", TD))
        jobs = np.asarray(jobs)
        for name, sl in (("quat", slice(0, 4)), ("gyro", slice(4, 7)), ("accel", slice(7, 10)),
                         ("q", slice(10, 22)), ("dq", slice(22, 34)), ("foot_force", slice(34, 38))):
            _close(obs[sl], jobs[sl], PEER_RTOL, f"{r['label']} observed {name}")
        _trees_close(rs, jrs, PEER_RTOL, f"{r['label']} plant state")
        np.testing.assert_array_equal(peer.true_pos, rs.torso.pos.numpy())


# ---------------------------------------------------------------------------
# the port's tick alone: the mode machine's command selection and the ramp
# ---------------------------------------------------------------------------


def _port_start(q=None):
    wts, ap, rs = _jax_setup()
    if q is not None:
        rs = rs._replace(q=jnp.asarray(q, JD))
    sensors = _observe(rs, rs, ap, DT_CTRL)
    return (_bridge.hw_carry(_init_carry(sensors, ap), "cpu", TD),
            _bridge.hw_sensors(sensors, "cpu", TD), _t(wts), _t(ap))


def test_mode_machine_selects_the_command_through_the_tick():
    """B toggles the default-pose servo on and off (its command carries the
    stand-up gains, the MPC's the joint gains); A toggles stand and walk."""
    carry, sensors, wts, ap = _port_start()
    tick = thw.make_hw_control_tick(4, TOpts(al_iterations=1, ilqr_iterations=1))
    neutral = tgoals.neutral_joy_sample(TD)
    press = torch.ones((), dtype=torch.bool)
    b, a = neutral._replace(default_pos=press), neutral._replace(mode_switch=press)
    dt = torch.full((), DT_CTRL, dtype=TD)
    args = (wts, ap.rho_fix, ap.kp_joint, ap.kd_joint)

    carry, cmd, info = tick(carry, sensors, dt, b, *args)
    assert bool(info["in_prime"])
    np.testing.assert_array_equal(cmd.reshape(4, 3, 5)[..., 3].numpy(), np.asarray(thw.PRIME_KP))
    carry, cmd, info = tick(carry, sensors, dt, neutral, *args)
    assert bool(info["in_prime"])  # latched until the next B edge
    carry, cmd, info = tick(carry, sensors, dt, b, *args)
    assert not bool(info["in_prime"])
    np.testing.assert_array_equal(cmd.reshape(4, 3, 5)[..., 3].numpy(),
                                  ap.kp_joint.expand(4, 3).numpy())
    assert int(info["movement_mode"]) == 0
    carry, cmd, info = tick(carry, sensors, dt, a, *args)
    assert int(info["movement_mode"]) == 1  # A: stand -> walk
    carry, cmd, info = tick(carry, sensors, dt, a, *args)
    assert int(info["movement_mode"]) == 0  # A again: walk -> stand


def test_standup_ramp_reaches_the_stand_pose():
    """While primed the servo command ramps from the crouched pose to the
    stand pose in 2 s (unitree_controller body.cpp:40-73): 100 ticks of
    20 ms, held after."""
    crouch = [[0.0, 1.3, -2.4]] * 4
    carry, sensors, wts, ap = _port_start(crouch)
    tick = thw.make_hw_control_tick(4, TOpts(al_iterations=1, ilqr_iterations=1))
    neutral = tgoals.neutral_joy_sample(TD)
    b = neutral._replace(default_pos=torch.ones((), dtype=torch.bool))
    dt = torch.full((), DT_CTRL, dtype=TD)
    args = (wts, ap.rho_fix, ap.kp_joint, ap.kd_joint)
    carry, cmd0, _ = tick(carry, sensors, dt, b, *args)
    for _ in range(110):
        carry, cmd, info = tick(carry, sensors, dt, neutral, *args)
    assert bool(info["in_prime"])
    np.testing.assert_allclose(cmd0.reshape(4, 3, 5)[..., 0].reshape(-1).numpy(),
                               np.asarray(crouch).reshape(-1), atol=0.02)
    np.testing.assert_allclose(cmd.reshape(4, 3, 5)[..., 0].reshape(-1).numpy(),
                               np.asarray(tstandup.STAND_POSE), atol=1e-4)


# ---------------------------------------------------------------------------
# The capture helper the loop's graphs share with the CLI's (`utils.graphs`).
# CUDA graphs do not exist on the CPU: what runs here is what a replay does
# on the host, the static buffers' copies and checks.
# ---------------------------------------------------------------------------

def test_the_loop_captures_with_the_shared_helper():
    """`loop_step` keeps one `Graphed` for each part and set of bound
    constants in ``tick.graphs``; on the CPU what it returns runs the part
    itself."""
    from quaternion_mpc_tpu_torch.utils import graphs

    assert thw.CapturedStep is graphs.CapturedStep and thw.Graphed is graphs.Graphed
    assert thw.GRAPH_WARMUP == graphs.GRAPH_WARMUP == 2

    def tick(c, s, dt, joy, wts, rho_fix, kp, kd, lead):
        return c + s * dt + wts + lead, c * kp, {"kd": kd}

    tick.graphs = {}
    consts = [torch.full((2,), v) for v in (1.0, 2.0, 3.0, 4.0)]
    state, args = torch.zeros(2), (torch.ones(2), torch.tensor(0.5), None, torch.tensor(0.25))
    step = thw.loop_step(tick, "tick", *consts, state, args)
    new, cmd, info = step(state, *args)
    assert torch.equal(new, torch.full((2,), 1.75)) and torch.equal(info["kd"], consts[3])
    assert thw.loop_step(tick, "tick", *consts, state, args) is step
    (key, g), = tick.graphs.items()
    assert key == ("tick", tuple(id(c) for c in consts)) and g.chain and g.graphs == {}
    other = [c.clone() for c in consts]
    thw.loop_step(tick, "tick", *other, state, args)
    assert len(tick.graphs) == 2
    with pytest.raises(ValueError, match="no part"):
        thw.loop_step(tick, "servo", *consts, state, args)


def _example_inputs():
    """A tick's inputs: a NamedTuple carry with a None leaf, a broadcast
    (stride 0) weight, a dict with a Python value."""
    n = len(tgoals.JoySample._fields)
    carry = tgoals.JoySample(*(torch.full((2,), float(i), dtype=TD) for i in range(n)))
    w = torch.arange(3.0, dtype=TD).expand(4, 3)
    return (carry, None, w, {"lead": 0.0, "x": torch.zeros((4, 2), dtype=TD)})


@pytest.mark.parametrize("change", ["leaf_count", "shape", "dtype", "strides", "python_value",
                                    "structure"])
def test_a_replay_refuses_inputs_the_capture_did_not_see(change):
    from quaternion_mpc_tpu_torch.utils import graphs

    static = graphs.StaticInputs(_example_inputs(), "tick")
    carry, none, w, d = _example_inputs()
    if change == "leaf_count":
        none = torch.zeros(1)
    elif change == "shape":
        d = {**d, "x": torch.zeros((5, 2), dtype=TD)}
    elif change == "dtype":
        d = {**d, "x": torch.zeros((4, 2), dtype=torch.float32)}
    elif change == "strides":
        w = w.contiguous()
    elif change == "python_value":
        d = {**d, "lead": 0.02}
    elif change == "structure":
        d = {"x": d["x"], "lead": d["lead"]}
    with pytest.raises(ValueError, match="tick"):
        static.load((carry, none, w, d))


def test_static_inputs_copy_what_a_replay_reads():
    """The buffers keep each input's layout, a broadcast dimension's one
    column included; a load copies new values in, and skips a tensor that
    already is its buffer."""
    from quaternion_mpc_tpu_torch.utils import graphs

    carry, none, w, d = _example_inputs()
    static = graphs.StaticInputs((carry, none, w, d), "tick", dense=len(carry))
    s_carry, s_none, s_w, s_d = static.args
    assert s_none is None and s_d["lead"] == 0.0 and type(s_carry) is type(carry)
    assert s_w.stride() == (0, 1) and torch.equal(s_w, w)
    assert all(a.data_ptr() != b.data_ptr() and torch.equal(a, b) for a, b in zip(s_carry, carry))
    w2 = (10.0 + torch.arange(3.0, dtype=TD)).expand(4, 3)
    static.load((carry._replace(mode_switch=carry.mode_switch + 1), None, w2, d))
    assert torch.equal(static.args[2], w2)
    assert torch.equal(static.args[0].mode_switch, carry.mode_switch + 1)
    before = s_carry.velx.clone()
    static.load((s_carry, None, w2, d))  # the static carry itself: nothing copied
    assert torch.equal(static.args[0].velx, before)
