"""Example scenario builders (port of `quaternion_mpc_tpu/examples.py`).

Data is drawn host-side with `numpy.random.default_rng(seed)` exactly as the
reference draws it, so both packages see identical scenarios, and lands as
tensors on the requested device and dtype.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from quaternion_mpc_tpu_torch import _bridge, scenarios
from quaternion_mpc_tpu_torch.control import convex_mpc, quat_mpc
from quaternion_mpc_tpu_torch.control.types import Command, RobotFeedback
from quaternion_mpc_tpu_torch.models import classic, srb
from quaternion_mpc_tpu_torch.runtime import step
from quaternion_mpc_tpu_torch.sim import terrain as terrain_mod
from quaternion_mpc_tpu_torch.solver.al_ilqr import broadcast_problem
from quaternion_mpc_tpu_torch.solver.fleet import FleetProblem
from quaternion_mpc_tpu_torch.solver.problem import (
    CostSpec,
    ModelSpec,
    SolverOptions,
    TrajOptProblem,
)
from quaternion_mpc_tpu_torch.utils import config as cfg_mod
from quaternion_mpc_tpu_torch.utils.tree import tile, tree_map

_FIXTURES = pathlib.Path(__file__).resolve().parent.parent / "tests" / "fixtures"

# Go1 default stance feet, body frame (TestAltroQuatMpc.cpp:41-44)
GO1_STANCE_FEET = np.array(
    [
        [0.2104, 0.13, -0.325],
        [0.2104, -0.13, -0.325],
        [-0.1658, 0.13, -0.325],
        [-0.1658, -0.13, -0.325],
    ]
)


def np_euler_to_quat(rpy: np.ndarray) -> np.ndarray:
    """Host-side ZYX euler -> [w,x,y,z] quaternion (pure numpy)."""
    r, p, y = rpy[..., 0] / 2, rpy[..., 1] / 2, rpy[..., 2] / 2
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.stack(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ],
        axis=-1,
    )


def standing_batch(
    batch: int, horizon: int, dtype: torch.dtype, device=None, seed: int = 0,
    controller: str = "quat",
):
    """A batch of perturbed Go1 standing scenarios for the MPC step:
    (RobotFeedback, Command, weights), batch-leading; ``controller`` selects
    QuatMpcWeights ("quat") or ConvexMpcWeights ("convex"). ``horizon`` is
    unused, as in the reference (kept for its signature)."""
    device = _bridge.resolve_device(device)
    del horizon
    rng = np.random.default_rng(seed)
    ndt = _bridge.numpy_dtype(dtype)
    if controller == "convex":
        wts = convex_mpc.weights_from_config(
            cfg_mod.gazebo_go1_convex_mpc(), dtype=dtype, device=device
        )
    elif controller == "quat":
        wts = quat_mpc.weights_from_config(
            cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype, device=device
        )
    else:
        raise ValueError(f"unknown controller {controller!r}; use 'quat' or 'convex'")

    foot = GO1_STANCE_FEET.astype(ndt)
    rpy = 0.05 * rng.standard_normal((batch, 3)).astype(ndt)
    quat = np_euler_to_quat(rpy)
    fbk = RobotFeedback(
        torso_pos_world=np.tile(np.array([0, 0, 0.3], dtype=ndt), (batch, 1)),
        torso_quat=quat.astype(ndt),
        torso_lin_vel_world=0.05 * rng.standard_normal((batch, 3)).astype(ndt),
        torso_ang_vel_body=0.05 * rng.standard_normal((batch, 3)).astype(ndt),
        foot_pos_body=np.tile(foot, (batch, 1, 1)),
        foot_contact=np.ones((batch, 4), dtype=ndt),
        joint_pos=np.zeros((batch, 12), dtype=ndt),
        joint_vel=np.zeros((batch, 12), dtype=ndt),
    )
    ident = np.tile(np.array([1, 0, 0, 0], dtype=ndt), (batch, 1))
    cmd = Command(
        pos_body_d=np.zeros((batch, 3), dtype=ndt),
        lin_vel_body_d=np.zeros((batch, 3), dtype=ndt),
        quat_d=ident,
        ang_vel_body_d=np.zeros((batch, 3), dtype=ndt),
        contacts=np.ones((batch, 4), dtype=ndt),
    )
    wts_b = type(wts)(*(a.expand((batch,) + a.shape) for a in wts))
    return (
        _bridge.from_numpy_tree(fbk, device, dtype),
        _bridge.from_numpy_tree(cmd, device, dtype),
        wts_b,
    )


def standing_fleet(batch: int, dtype: torch.dtype, device=None, seed: int = 0):
    """The standing closed-loop fleet of the reference's CLI
    (`cli.py:180-197`, ``run_standing``): B Go1 robots at rest at 0.3 m on
    their default stance feet, each with an initial velocity of
    0.05·N(0, 1) drawn by numpy from ``seed``. Returns (carry, sp, joy) for
    `runtime.step.make_fleet_standing_step`, batch-leading."""
    device = _bridge.resolve_device(device)
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype, device=device)
    feet = srb.go1_params(dtype=dtype, device=device).foot_pos
    carry, sp = step.init_scenario(wts, feet, dtype=dtype, device=device)
    carry, sp = tile(carry, batch), tile(sp, batch)
    vel = 0.05 * np.random.default_rng(seed).standard_normal((batch, 3))
    carry = carry._replace(plant=carry.plant._replace(vel=_bridge.tensor(vel, device, dtype)))
    return carry, sp, tile(step.neutral_joy(dtype, device), batch)


def walking_batch(batch: int, horizon: int, dtype: torch.dtype, device=None,
                  velx: float = 0.3):
    """The fleet RTI scenario of the reference's bench (`bench.py:394-401`):
    B identical Go1 robots at rest on flat ground, trotting at ``velx``
    m/s, with the warm-start carry of `init_walking_scenario`. Returns
    (carry, sp, joy) for `runtime.step.make_fleet_walking_step`,
    batch-leading."""
    device = _bridge.resolve_device(device)
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype, device=device)
    carry, sp = step.init_walking_scenario(
        wts, dtype=dtype, warm_start=True, horizon=horizon, device=device)
    joy = step.neutral_joy(dtype, device)._replace(
        velx=torch.full((), velx, dtype=dtype, device=device))
    return tile(carry, batch), tile(sp, batch), tile(joy, batch)


def estimated_batch(batch: int, horizon: int, dtype: torch.dtype, device=None, kf_type: int = 1,
                    velx: float = 0.3):
    """The estimated fleet of the reference's bench (`bench.py:367-378`): B
    identical Go1 robots at rest on flat ground with a KF (``kf_type`` 1)
    or EKF (2) in the loop, trotting at ``velx`` m/s. Returns (carry, sp,
    joy) for `runtime.step.make_fleet_estimated_step`, batch-leading, every
    leaf a real copy. ``horizon`` is unused (kept for the signature these
    functions share)."""
    device = _bridge.resolve_device(device)
    del horizon
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype, device=device)
    carry, sp = step.init_estimated_walking_scenario(
        wts, dtype=dtype, kf_type=kf_type, device=device)
    joy = step.neutral_joy(dtype, device)._replace(
        velx=torch.full((), velx, dtype=dtype, device=device))
    return tile(carry, batch), tile(sp, batch), tile(joy, batch)


def actuated_batch(batch: int, dtype: torch.dtype, device=None, kf_type=None,
                   velx: float = 0.4):
    """The actuated fleet as the reference's `cli run_actuated` builds it
    (`cli.py:251-295`): one Go1 on flat ground tiled over B, trotting at
    ``velx`` m/s through the joint-level plant. kf_type None: ground-truth
    feedback (`runtime.step.make_actuated_walking_step`); 0, 1 or 2 the
    estimated loop (`make_estimated_actuated_step`). Returns (carry, sp,
    joy), batch-leading, every leaf a real copy."""
    device = _bridge.resolve_device(device)
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype, device=device)
    if kf_type is None:
        carry, sp = step.init_actuated_scenario(wts, dtype=dtype, device=device)
    else:
        carry, sp = step.init_estimated_actuated_scenario(wts, dtype=dtype, kf_type=kf_type,
                                                          device=device)
    joy = step.neutral_joy(dtype, device)._replace(
        velx=torch.full((), velx, dtype=dtype, device=device))
    return tile(carry, batch), tile(sp, batch), tile(joy, batch)


# the worlds of `actuated_mixed`, each with the start that brings a trot
# onto its feature within a few hundred milliseconds
ACTUATED_WORLDS = (("flat", 0.0), ("slope", -0.25), ("stairs", 0.05))


def actuated_mixed(batch: int, dtype: torch.dtype, device=None, velx: float = 0.4):
    """B actuated Go1s (ground-truth feedback) on flat ground, walking onto
    the slope and up to the first stair riser, in turn (`ACTUATED_WORLDS`).
    Returns (carry, sp, joy), batch-leading."""
    device = _bridge.resolve_device(device)
    wts = quat_mpc.weights_from_config(cfg_mod.gazebo_go1_quat_mpc(), dtype=dtype, device=device)
    per = []
    for kind, start_x in ACTUATED_WORLDS:
        tp = terrain_mod.make_terrain(kind, dtype=dtype, device=device)
        per.append(step.init_actuated_scenario(wts, dtype=dtype, terrain=tp, start_x=start_x,
                                               device=device))
    pick = torch.arange(batch, device=device) % len(per)
    stack = lambda *trees: tree_map(lambda *leaves: torch.stack(leaves)[pick], *trees)
    carry, sp = stack(*(c for c, _ in per)), stack(*(s for _, s in per))
    joy = step.neutral_joy(dtype, device)._replace(
        velx=torch.full((), velx, dtype=dtype, device=device))
    return carry, sp, tile(joy, batch)


def falling_cat_fleet(batch: int, dtype: torch.dtype, device=None, seed: int = 0,
                      N: int = 40, h: float = 0.02):
    """A fleet of the `falling_cat` scenario: B tumbling starts, each at rest
    at an angle drawn uniformly from 100 to 175 degrees about an axis drawn
    uniformly on the sphere (numpy, from ``seed``); everything else is the
    scenario's. Returns (spec, prob, opts) with a leading batch axis on every
    leaf of ``prob``, for `solver.al_ilqr.make_solver(spec, opts)`."""
    spec, prob, opts = scenarios.falling_cat(N=N, h=h, dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    axis = rng.standard_normal((batch, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    half = 0.5 * np.deg2rad(rng.uniform(100.0, 175.0, size=(batch, 1)))
    x0 = np.concatenate([np.cos(half), np.sin(half) * axis, np.zeros((batch, 3))], axis=-1)
    fleet = broadcast_problem(prob, batch)
    return spec, fleet._replace(x0=_bridge.tensor(x0, prob.x0.device, dtype)), opts


def _load_fixture(fixtures_dir, name="quat_mpc_test.json"):
    path = pathlib.Path(_FIXTURES if fixtures_dir is None else fixtures_dir)
    with open(path / name) as f:
        return json.load(f)


def friction_pyramid(mu: float, fz_max: float, contacts) -> tuple[np.ndarray, np.ndarray]:
    """Per-leg rows ±fx−μfz, ±fy−μfz, fz−fz_max·contact, −fz ≤ 0 of the
    reference's standalone solver tests (TestAltroQuatMpc.cpp:114-124), as
    numpy (Cu (6·n_feet, 3·n_feet), cb (6·n_feet,))."""
    n_feet = len(contacts)
    Cu = np.zeros((6 * n_feet, 3 * n_feet))
    cb = np.zeros(6 * n_feet)
    for i, contact in enumerate(contacts):
        Cu[6 * i : 6 * i + 6, 3 * i : 3 * i + 3] = [
            [1, 0, -mu], [-1, 0, -mu], [0, 1, -mu], [0, -1, -mu], [0, 0, 1], [0, 0, -1]]
        cb[6 * i + 4] = -fz_max * contact
    return Cu, cb


_QUAT_MODEL = dict(f=srb.quat_srb_dynamics, fj=srb.quat_srb_jacobian, quat_idx=3)
# the golden fixtures of the reference's solver tests: file, then how the
# single-problem solve is held to it (atol of us, atol of xs)
GOLDEN_FIXTURES = {
    "quat": ("quat_mpc_test.json", 1e-4, 1e-5),
    "trot": ("trot_quat_mpc_test.json", 1e-3, 1e-4),
    "convex": ("convex_mpc.json", 5e-2, 5e-4),
}


def fixture_problem(name: str, dtype: torch.dtype, device=None, fixtures_dir=None):
    """A golden C++ fixture as a single `TrajOptProblem`, rebuilt from the
    standalone test that generated it (tests/test_solver_fixtures.py of the
    reference): "quat" (TestAltroQuatMpc.cpp, standing, N=20), "trot"
    (TestAltroTrotQuatMpc.cpp, two contact feet, nu=6, w=10) or "convex" (the
    Euler convex MPC at N=30: forward Euler, mass 13, contacts {1,0,0,1}).

    Returns (spec, prob, gold_us, gold_xs, atol_us, atol_xs): the golden
    trajectories as f64 numpy (the convex file saves states 0..N-1 only) and
    the reference tests' own bounds, at default `SolverOptions`.
    """
    device = _bridge.resolve_device(device)
    file, atol_us, atol_xs = GOLDEN_FIXTURES[name]
    fix = _load_fixture(fixtures_dir, file)
    t = lambda a: _bridge.tensor(np.asarray(a, dtype=np.float64), device, dtype)
    gold_us = np.asarray(fix["input_trajectory"], dtype=np.float64)
    gold_xs = np.asarray(fix["state_trajectory"], dtype=np.float64)
    if name == "convex":
        N, mass = 30, 13.0
        x_ref = np.asarray(fix["reference_trajectory"], dtype=np.float64)
        u_ref = np.tile(np.array([0.0, 0.0, mass * 9.81 / 4] * 4), (N + 1, 1))
        feet = [[0.17, 0.12, -0.3], [0.17, -0.12, -0.3], [-0.17, 0.12, -0.3], [-0.17, -0.12, -0.3]]
        params = srb.go1_params(foot_pos=feet, inertia_scale=1.0, mass=mass, dtype=dtype,
                                device=device)
        params = params._replace(inertia=t(np.diag([0.02354977, 0.16739931, 0.16279108])))
        spec = ModelSpec(nx=12, nu=12, f=srb.euler_srb_dynamics, fj=srb.euler_srb_jacobian,
                         quat_idx=None, integrator="euler")
        Qd, w = [1.0, 1, 1, 0, 0, 50, 0, 0, 1, 1, 1, 1], 0.0
        Cu, cb = friction_pyramid(0.5, 1000.0, [1, 0, 0, 1])
    else:
        N = 20
        x_ref = np.asarray(fix["reference_state"], dtype=np.float64)
        u_ref = np.asarray(fix["reference_input"], dtype=np.float64)
        if name == "quat":
            params = srb.go1_params(dtype=dtype, device=device)
            Qd, w = [1.0, 1, 1, 0, 0, 0, 0, 2, 2, 2, 1, 1, 1], 1.0
            Cu, cb = friction_pyramid(0.6, 200.0, [1, 1, 1, 1])
        else:
            params = srb.go1_params(foot_pos=[[0.17, 0.13, -0.3], [-0.17, -0.13, -0.3]],
                                    dtype=dtype, device=device)
            Qd, w = [1.0, 1, 1, 0, 0, 0, 0, 10, 10, 10, 10, 10, 10], 10.0
            Cu, cb = friction_pyramid(0.7, 200.0, [1, 1])
        spec = ModelSpec(nx=13, nu=Cu.shape[1], **_QUAT_MODEL)
    prob = TrajOptProblem(
        x0=t(x_ref[0]),
        cost=CostSpec(Qd=t(Qd), Rd=t(np.full(Cu.shape[1], 1e-6)), w=t(w), x_ref=t(x_ref),
                      u_ref=t(u_ref)),
        Cu=t(Cu), cb=t(cb), h=t(0.01), params=params, us_init=t(u_ref[:N]),
    )
    return spec, prob, gold_us, gold_xs, atol_us, atol_xs


def bicycle_tracking(dtype: torch.dtype, device=None, fixtures_dir=None, N: int = 30):
    """The reference's receding-horizon bicycle MPC over the scotty-dog
    trajectory (TestBicycle.cpp: N=30, Qd=1e-2, Rd=1e-3, Qdf=1e1, |δ| ≤ 60° as
    state rows Cx; tests/test_classic.py of the reference).

    Returns (spec, opts, build, x_ref (K, 4), u_ref (K, 2), params, h,
    delta_max): ``build(k0, x0, us_init)`` is tick k0's `TrajOptProblem`.
    """
    device = _bridge.resolve_device(device)
    scotty = _load_fixture(fixtures_dir, "scotty.json")
    t = lambda a: _bridge.tensor(np.asarray(a, dtype=np.float64), device, dtype)
    x_ref, u_ref = t(scotty["state_trajectory"]), t(scotty["input_trajectory"])
    h = t(scotty["tf"] / scotty["N"])
    params = (t(2.7), t(1.5))
    delta_max = 60.0 * np.pi / 180.0
    Cx, Cu, cb = t([[0.0, 0, 0, 1.0], [0.0, 0, 0, -1.0]]), t(np.zeros((2, 2))), t([-delta_max] * 2)
    Qd, Rd, Qdf = t(1e-2 * np.ones(4)), t(1e-3 * np.ones(2)), t(1e1 * np.ones(4))
    w = t(0.0)
    spec = ModelSpec(nx=4, nu=2, f=classic.bicycle_dynamics, quat_idx=None)

    def build(k0: int, x0, us_init):
        return TrajOptProblem(
            x0=x0,
            cost=CostSpec(Qd=Qd, Rd=Rd, w=w, x_ref=x_ref[k0 : k0 + N + 1],
                          u_ref=u_ref[k0 : k0 + N + 1], Qdf=Qdf),
            Cu=Cu, cb=cb, h=h, params=params, us_init=us_init, Cx=Cx,
        )

    opts = SolverOptions(al_iterations=2, ilqr_iterations=8)
    return spec, opts, build, x_ref, u_ref, params, h, delta_max


def bicycle_mixed_rows(batch: int, horizon: int, dtype: torch.dtype, device=None,
                       seed: int = 5):
    """A fleet of the bicycle whose inequality rows mix the state with the
    inputs (steering angle + half the steering rate; heading - acceleration),
    from perturbed starts around a point on both bounds: the cost's cross term lux = ρ·Cuᵀ·diag(active)·Cx
    is then non-zero wherever a row is active, which the tracking problem's
    own rows (Cu = 0) never make it. Returns (FleetModelSpec, FleetProblem,
    lam (N+1, 2, B), rho): multipliers and penalty at which some rows are
    active and some are not."""
    from quaternion_mpc_tpu_torch.solver import al_ilqr

    device = _bridge.resolve_device(device)
    spec, _, build, x_ref, u_ref, _, _, _ = bicycle_tracking(dtype, device, N=horizon)
    prob = build(0, x_ref[0], u_ref[0].expand(horizon, 2))
    rng = np.random.default_rng(seed)
    draw = lambda *shape: _bridge.tensor(rng.standard_normal(shape), device, dtype)
    t = lambda a: _bridge.tensor(np.asarray(a, dtype=np.float64), device, dtype)
    Cu, Cx = t([[0.0, 0.5], [-1.0, 0.0]]), t([[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 1.0, 0.0]])
    # the unperturbed start lies on both bounds, so the perturbed ones fall on either side
    prob = prob._replace(Cu=Cu, Cx=Cx, cb=-(Cx @ x_ref[0] + Cu @ u_ref[0]))
    # the params are a plain tuple, which broadcast_problem takes for a leaf
    prob = al_ilqr.broadcast_problem(prob._replace(params=None), batch)._replace(
        x0=prob.x0 + 0.2 * draw(batch, 4),
        us_init=prob.us_init + 0.3 * draw(batch, horizon, 2),
        params=tuple(p.expand(batch) for p in prob.params))
    return (al_ilqr.fleet_spec(spec), al_ilqr.lift_problem(prob),
            0.5 * draw(horizon + 1, 2, batch), t(3.0))


def classic_problem(name: str, N: int, dtype: torch.dtype, device=None):
    """The unconstrained progression problems of the reference's solver tests
    (tests/test_classic.py) at a horizon of N knots: "double_integrator"
    (ne=4, nu=2, to a goal, Qdf=1e4) or "pendulum" (ne=2, nu=1, swing-up,
    Qdf=100). Returns (spec, prob)."""
    device = _bridge.resolve_device(device)
    t = lambda a: _bridge.tensor(np.asarray(a, dtype=np.float64), device, dtype)
    if name == "double_integrator":
        spec = ModelSpec(nx=4, nu=2, f=classic.double_integrator_dynamics, quat_idx=None)
        goal, x0, h = np.array([1.0, -0.5, 0.0, 0.0]), np.zeros(4), 0.1
        Qd, Rd, Qdf, u0 = np.ones(4), 1e-2 * np.ones(2), 1e4 * np.ones(4), 0.0
    elif name == "pendulum":
        spec = ModelSpec(nx=2, nu=1, f=classic.pendulum_dynamics, quat_idx=None)
        goal, x0, h = np.array([np.pi, 0.0]), np.zeros(2), 0.05
        Qd, Rd, Qdf, u0 = np.array([1e-2, 1e-1]), 1e-3 * np.ones(1), np.array([100.0, 100.0]), 0.1
    else:
        raise ValueError(f"unknown classic problem {name!r}")
    prob = TrajOptProblem(
        x0=t(x0),
        cost=CostSpec(Qd=t(Qd), Rd=t(Rd), w=t(0.0), x_ref=t(np.tile(goal, (N + 1, 1))),
                      u_ref=t(np.zeros((N + 1, spec.nu))), Qdf=t(Qdf)),
        Cu=t(np.zeros((0, spec.nu))), cb=t(np.zeros((0,))), h=t(h), params=None,
        us_init=t(u0 * np.ones((N, spec.nu))),
    )
    return spec, prob


def fixture_fleet_problem(batch: int, dtype: torch.dtype, device=None, fixtures_dir=None):
    """The golden standing quat-MPC fixture (``quat_mpc_test.json``, the
    reference's TestAltroQuatMpc.cpp problem) as a batch-B `FleetProblem`,
    plus its f64 golden optimum.

    Returns (prob, gold_us (20,12) f64 np, gold_xs (21,13) f64 np).
    """
    device = _bridge.resolve_device(device)
    fix = _load_fixture(fixtures_dir)
    x_ref = np.asarray(fix["reference_state"], dtype=np.float64)
    u_ref = np.asarray(fix["reference_input"], dtype=np.float64)
    gold_us = np.asarray(fix["input_trajectory"], dtype=np.float64)
    gold_xs = np.asarray(fix["state_trajectory"], dtype=np.float64)

    Cu, cb = friction_pyramid(mu=0.6, fz_max=200.0, contacts=[1, 1, 1, 1])

    t = lambda a: _bridge.tensor(a, device, dtype)
    bl = lambda a: t(a)[..., None].expand(a.shape + (batch,))
    params = srb.params_to_fleet(srb.go1_params(dtype=dtype, device=device))
    prob = FleetProblem(
        x0=bl(x_ref[0]),
        x_ref=bl(x_ref),
        u_ref=bl(u_ref),
        Qd=bl(np.array([1.0, 1, 1, 0, 0, 0, 0, 2, 2, 2, 1, 1, 1])),
        Rd=bl(np.full((12,), 1e-6)),
        w=t(np.ones((1,))),
        Cu=bl(Cu),
        cb=bl(cb),
        h=t(0.01),
        params=params,
        us_init=bl(u_ref[:20]),
    )
    return prob, gold_us, gold_xs


def fixture_gold_cost(gold_us, gold_xs, fixtures_dir=None) -> float:
    """Raw f64 objective of the golden fixture trajectory, in numpy on the
    host: tracking + geodesic quaternion cost, no AL terms (the solver's
    final_cost convention)."""
    fix = _load_fixture(fixtures_dir)
    x_ref = np.asarray(fix["reference_state"], dtype=np.float64)
    u_ref = np.asarray(fix["reference_input"], dtype=np.float64)
    Qd = np.array([1.0, 1, 1, 0, 0, 0, 0, 2, 2, 2, 1, 1, 1])
    Rd = np.full((12,), 1e-6)
    w = 1.0
    xs = np.asarray(gold_xs, np.float64)
    us = np.asarray(gold_us, np.float64)
    total = 0.0
    for k in range(xs.shape[0]):
        dx = xs[k] - x_ref[k]
        total += 0.5 * float(dx @ (Qd * dx))
        total += w * (1.0 - abs(float(xs[k, 3:7] @ x_ref[k, 3:7])))
        if k < us.shape[0]:
            du = us[k] - u_ref[k]
            total += 0.5 * float(du @ (Rd * du))
    return total


def line_search_inputs(spec, prob: FleetProblem, n_alphas: int = 12, lam=None,
                       rho: float = 1.0) -> dict:
    """The inputs of a first iLQR iteration's line search on ``prob``
    (`solver.fleet.line_search` after `solver.fleet.riccati_backward`): the
    open-loop rollout of us_init, the multipliers ``lam`` (zero by default)
    at penalty ``rho``, the backward pass's gains at reg 1e-8, the AL cost J,
    no scenario done, and the alphas 1, 1/2, ... of ``n_alphas``. Returns
    line_search's arguments after spec and prob, by name."""
    from quaternion_mpc_tpu_torch.solver import fleet

    us = prob.us_init
    dtype, device, batch, N = us.dtype, us.device, us.shape[-1], us.shape[0]
    xs = fleet.open_loop_rollout(spec, prob, us)
    if lam is None:
        lam = torch.zeros((N, prob.cb.shape[-2], batch), dtype=dtype, device=device)
    rho_t = torch.full((), rho, dtype=dtype, device=device)
    reg = torch.full((batch,), 1e-8, dtype=dtype, device=device)
    Ks, ds, dV1, dV2, _ = fleet.riccati_backward(spec, prob, xs, us, lam, rho_t, reg)
    return dict(
        xs=xs, us=us, Ks=Ks.contiguous(), ds=ds.contiguous(), dV1=dV1, dV2=dV2,
        J=fleet.total_cost(spec, xs, us, prob, lam, rho_t),
        done=torch.zeros((batch,), dtype=torch.bool, device=device), lam=lam, rho=rho_t,
        alphas=2.0 * torch.cumprod(torch.full((n_alphas,), 0.5, dtype=dtype, device=device), 0),
    )


def line_search_case(name: str, batch: int, dtype: torch.dtype, device=None, horizon: int = 10,
                     n_alphas: int = 12, seed: int = 0):
    """(spec, prob, inputs): the line search of a first iLQR iteration
    (`line_search_inputs`) on a problem of one of K2's models. The quaternion
    SRB: "standing", the Go1 fleet controller's problem on `standing_batch`
    (every leaf per scenario, ``horizon`` knots); "fixture", the golden
    standing fixture (N = 20, the references, weights and parameters shared
    along B); or "humanoid", the two-footed scenario (N = ``horizon``)
    tiled. The Euler SRB: "convex", the convex fleet controller's problem on
    `standing_batch` (midpoint rule, every leaf per scenario), or
    "convex_fixture", the golden convex fixture (forward Euler, N = 30, its
    leaves shared along B). The attitude model: "falling_cat", the
    `falling_cat_fleet` (N = ``horizon``). The inputs us_init of the
    problems tiled from one ("fixture", "humanoid", "convex_fixture") get
    seeded noise of 2 N a force, falling_cat's of 0.5 N·m a torque, so that
    their scenarios and their rollouts differ."""
    from quaternion_mpc_tpu_torch.solver import al_ilqr

    device = _bridge.resolve_device(device)
    noise_scale = 2.0
    if name == "standing":
        spec = quat_mpc.FLEET_MODEL_SPEC
        prob = quat_mpc.build_fleet_problem(
            *standing_batch(batch, horizon, dtype, device, seed), horizon)
    elif name == "convex":
        spec = convex_mpc.FLEET_MODEL_SPEC
        prob = convex_mpc.build_fleet_problem(
            *standing_batch(batch, horizon, dtype, device, seed, controller="convex"), horizon)
    elif name == "fixture":
        spec = quat_mpc.FLEET_MODEL_SPEC
        prob = fixture_fleet_problem(batch, dtype, device)[0]
    elif name in ("humanoid", "convex_fixture", "falling_cat"):
        if name == "humanoid":
            sspec, sprob, _ = scenarios.humanoid(N=horizon, dtype=dtype, device=device)
            sprob = broadcast_problem(sprob, batch)
        elif name == "convex_fixture":
            sspec, sprob = fixture_problem("convex", dtype, device)[:2]
            sprob = broadcast_problem(sprob, batch)
        else:
            sspec, sprob, _ = falling_cat_fleet(batch, dtype, device, seed, N=horizon)
            noise_scale = 0.5
        spec = al_ilqr.fleet_spec(sspec)
        prob = al_ilqr.lift_problem(sprob)
    else:
        raise ValueError(f"unknown line-search case {name!r}")
    if name not in ("standing", "convex"):
        noise = np.random.default_rng(seed).standard_normal(tuple(prob.us_init.shape))
        prob = prob._replace(
            us_init=prob.us_init + noise_scale * _bridge.tensor(noise, device, dtype))
    return spec, prob, line_search_inputs(spec, prob, n_alphas)
