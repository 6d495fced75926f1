"""The port's single-problem solver (`solver.al_ilqr.make_solver`, the
batch-last fleet solver behind a `TrajOptProblem`) against the JAX
`make_solver`: the same problem, built once with numpy leaves, goes through
both in f64. Also the golden C++ fixtures at full size, the generalised fleet
solver's new fields one at a time, and the K1 wrapper's embedding of
problems smaller than 12 x 12."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quaternion_mpc_tpu import scenarios as jscn
from quaternion_mpc_tpu.models import classic as jclassic
from quaternion_mpc_tpu.models import srb as jsrb
from quaternion_mpc_tpu.solver import CostSpec as JCostSpec
from quaternion_mpc_tpu.solver import ModelSpec as JModelSpec
from quaternion_mpc_tpu.solver import SolverOptions as JSolverOptions
from quaternion_mpc_tpu.solver import TrajOptProblem as JTrajOptProblem
from quaternion_mpc_tpu.solver import make_solver as jmake_solver
from quaternion_mpc_tpu_torch import _bridge
from quaternion_mpc_tpu_torch import examples as tex
from quaternion_mpc_tpu_torch import scenarios as tscn
from quaternion_mpc_tpu_torch.control import quat_mpc as tq
from quaternion_mpc_tpu_torch.kernels import assoc_scan as tk4
from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs
from quaternion_mpc_tpu_torch.models import attitude as tattitude
from quaternion_mpc_tpu_torch.models import classic as tclassic
from quaternion_mpc_tpu_torch.models import srb as tsrb
from quaternion_mpc_tpu_torch.solver import al_ilqr as tal
from quaternion_mpc_tpu_torch.solver import fleet as tfl
from quaternion_mpc_tpu_torch.solver.problem import ModelSpec, SolverOptions
from quaternion_mpc_tpu_torch.utils.tree import tree_leaves

import quaternion_mpc_tpu_torch

# the port makes its tensors on the card unless told otherwise; these tests run on the CPU
quaternion_mpc_tpu_torch.set_default_device("cpu")

torch.set_num_threads(1)
F64 = torch.float64


def friction_pyramid(mu, fz_max, contacts):
    """Per-leg rows ±fx−μfz, ±fy−μfz, fz−fz_max·contact, −fz ≤ 0
    (TestAltroQuatMpc.cpp:114-124)."""
    n_feet = len(contacts)
    Cu = np.zeros((6 * n_feet, 3 * n_feet))
    cb = np.zeros(6 * n_feet)
    for i, contact in enumerate(contacts):
        rows = Cu[6 * i : 6 * i + 6, 3 * i : 3 * i + 3]
        rows[0] = [1, 0, -mu]
        rows[1] = [-1, 0, -mu]
        rows[2] = [0, 1, -mu]
        rows[3] = [0, -1, -mu]
        rows[4] = [0, 0, 1]
        rows[5] = [0, 0, -1]
        cb[6 * i + 4] = -fz_max * contact
    return Cu, cb


def _load(fixtures_dir, name):
    with open(fixtures_dir / name) as f:
        return json.load(f)


def _problem(x0, Qd, Rd, w, x_ref, u_ref, Cu, cb, h, params, N, **more):
    """A JAX `TrajOptProblem` cut to N knots (leaves become jnp arrays)."""
    a = lambda v: jnp.asarray(np.asarray(v, dtype=np.float64))
    cost_more = {k: a(more.pop(k)) for k in ("Qdf",) if k in more}
    more = {k: a(v) for k, v in more.items()}
    return JTrajOptProblem(
        x0=a(x0),
        cost=JCostSpec(Qd=a(Qd), Rd=a(Rd), w=a(w), x_ref=a(x_ref[: N + 1]),
                       u_ref=a(u_ref[: N + 1]), **cost_more),
        Cu=a(Cu), cb=a(cb), h=a(h), params=params, us_init=a(u_ref[:N]), **more,
    )


JQUAT = dict(f=jsrb.quat_srb_dynamics, fj=jsrb.quat_srb_jacobian, quat_idx=3)
TQUAT = dict(f=tsrb.quat_srb_dynamics, fj=tsrb.quat_srb_jacobian, quat_idx=3)
CONVEX_FEET = [[0.17, 0.12, -0.3], [0.17, -0.12, -0.3], [-0.17, 0.12, -0.3], [-0.17, -0.12, -0.3]]


def quat_fixture(fixtures_dir, N=20):
    """TestAltroQuatMpc.cpp: standing balance, N=20, h=0.01."""
    fix = _load(fixtures_dir, "quat_mpc_test.json")
    x_ref, u_ref = np.array(fix["reference_state"]), np.array(fix["reference_input"])
    Cu, cb = friction_pyramid(0.6, 200.0, [1, 1, 1, 1])
    prob = _problem(x_ref[0], [1.0, 1, 1, 0, 0, 0, 0, 2, 2, 2, 1, 1, 1], np.full(12, 1e-6), 1.0,
                    x_ref, u_ref, Cu, cb, 0.01, jsrb.go1_params(), N)
    gold = (fix["input_trajectory"], fix["state_trajectory"], 1e-4, 1e-5)
    return JModelSpec(nx=13, nu=12, **JQUAT), ModelSpec(nx=13, nu=12, **TQUAT), prob, gold


def trot_fixture(fixtures_dir, N=20):
    """TestAltroTrotQuatMpc.cpp: two contact feet, nu = 6, w = 10."""
    fix = _load(fixtures_dir, "trot_quat_mpc_test.json")
    x_ref, u_ref = np.array(fix["reference_state"]), np.array(fix["reference_input"])
    Cu, cb = friction_pyramid(0.7, 200.0, [1, 1])
    params = jsrb.go1_params(foot_pos=[[0.17, 0.13, -0.3], [-0.17, -0.13, -0.3]])
    prob = _problem(x_ref[0], [1.0, 1, 1, 0, 0, 0, 0, 10, 10, 10, 10, 10, 10], np.full(6, 1e-6),
                    10.0, x_ref, u_ref, Cu, cb, 0.01, params, N)
    gold = (fix["input_trajectory"], fix["state_trajectory"], 1e-3, 1e-4)
    return JModelSpec(nx=13, nu=6, **JQUAT), ModelSpec(nx=13, nu=6, **TQUAT), prob, gold


def convex_fixture(fixtures_dir, N=30):
    """The Euler convex MPC's N=30 golden fixture: forward Euler, mass 13,
    contacts {1,0,0,1} (tests/test_solver_fixtures.py:119-182)."""
    fix = _load(fixtures_dir, "convex_mpc.json")
    x_ref = np.array(fix["reference_trajectory"])
    mass = 13.0
    u_ref = np.tile(np.array([0.0, 0.0, mass * 9.81 / 4] * 4), (31, 1))
    params = jsrb.go1_params(foot_pos=CONVEX_FEET, inertia_scale=1.0, mass=mass)
    params = params._replace(inertia=jnp.diag(jnp.array([0.02354977, 0.16739931, 0.16279108])))
    Cu, cb = friction_pyramid(0.5, 1000.0, [1, 0, 0, 1])
    prob = _problem(x_ref[0], [1.0, 1, 1, 0, 0, 50, 0, 0, 1, 1, 1, 1], np.full(12, 1e-6), 0.0,
                    x_ref, u_ref, Cu, cb, 0.01, params, N)
    jspec = JModelSpec(nx=12, nu=12, f=jsrb.euler_srb_dynamics, fj=jsrb.euler_srb_jacobian,
                       quat_idx=None, integrator="euler")
    tspec = ModelSpec(nx=12, nu=12, f=tsrb.euler_srb_dynamics, fj=tsrb.euler_srb_jacobian,
                      quat_idx=None, integrator="euler")
    # the fixture saves states k = 0..N-1 only
    gold = (fix["input_trajectory"], fix["state_trajectory"], 5e-2, 5e-4)
    return jspec, tspec, prob, gold


def bicycle_problem(fixtures_dir, N=8, k0=20):
    """One receding solve of TestBicycle.cpp's scotty-dog tracking: state
    rows Cx (the steering bound), a terminal weight Qdf, no analytic
    Jacobian."""
    scotty = _load(fixtures_dir, "scotty.json")
    x_ref = np.array(scotty["state_trajectory"])[k0:]
    u_ref = np.array(scotty["input_trajectory"])[k0:]
    delta_max = 15.0 * np.pi / 180.0  # tight enough to be active from this start
    x0 = x_ref[0] + np.array([0.3, -0.2, 0.1, 0.35])
    prob = _problem(x0, 1e-2 * np.ones(4), 1e-3 * np.ones(2), 0.0, x_ref, u_ref,
                    np.zeros((2, 2)), [-delta_max, -delta_max], scotty["tf"] / scotty["N"],
                    (jnp.asarray(2.7), jnp.asarray(1.5)), N,
                    Qdf=1e1 * np.ones(4), Cx=[[0.0, 0, 0, 1.0], [0.0, 0, 0, -1.0]])
    jspec = JModelSpec(nx=4, nu=2, f=jclassic.bicycle_dynamics, quat_idx=None)
    tspec = ModelSpec(nx=4, nu=2, f=tclassic.bicycle_dynamics, quat_idx=None)
    return jspec, tspec, prob


def _scenario(name, N):
    jspec, jprob, _ = jscn.SCENARIOS[name](N=N)
    tspec, _, _ = tscn.SCENARIOS[name](N=N, dtype=F64)
    return jspec, tspec, jprob


def _port_problem(jprob):
    params = jprob.params
    if isinstance(params, jsrb.SrbParams):
        params = _bridge.srb_params(params, "cpu", F64)
    elif params is not None and hasattr(params, "inertia"):
        params = _bridge.attitude_params(params, "cpu", F64)
    else:
        params = None  # a plain tuple of arrays (the bicycle's), or none
    return _bridge.traj_opt_problem(jprob, params=params, device="cpu", dtype=F64)


def _solve_both(jspec, tspec, jprob, al, ilqr):
    want = jax.jit(jmake_solver(jspec, JSolverOptions(al_iterations=al, ilqr_iterations=ilqr)))(
        jprob)
    got = tal.make_solver(tspec, SolverOptions(al_iterations=al, ilqr_iterations=ilqr))(
        _port_problem(jprob))
    return want, got


def _assert_solutions_agree(want, got):
    """us 1e-7, xs 1e-8, cost 1e-8, lam 1e-6, the constraint violation 1e-8,
    and the same count of live iterations."""
    np.testing.assert_allclose(got.us.numpy(), np.asarray(want.us), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.stats.cost.numpy(), np.asarray(want.stats.cost),
                               rtol=1e-10, atol=1e-8)
    assert tuple(got.lam.shape) == tuple(want.lam.shape)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(want.lam), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.stats.constraint_violation.numpy(),
                               np.asarray(want.stats.constraint_violation), rtol=0, atol=1e-8)
    assert int(got.stats.iterations) == int(want.stats.iterations)
    assert got.stats.iterations.dtype == torch.int32
    g_want = float(want.stats.grad_norm)
    assert abs(float(got.stats.grad_norm) - g_want) <= 1e-6 * max(1.0, g_want)


SMALL = {
    "quat": (lambda d: quat_fixture(d, N=8)[:3], 2, 3),
    "trot": (lambda d: trot_fixture(d, N=6)[:3], 1, 2),
    "convex": (lambda d: convex_fixture(d, N=8)[:3], 2, 3),
    "falling_cat": (lambda d: _scenario("falling_cat", 8), 2, 3),
    "humanoid": (lambda d: _scenario("humanoid", 6), 1, 2),
    "spider_dog": (lambda d: _scenario("spider_dog", 6), 1, 2),
    "bicycle": (lambda d: bicycle_problem(d), 2, 3),
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_make_solver_matches_jax(name, fixtures_dir):
    build, al, ilqr = SMALL[name]
    want, got = _solve_both(*build(fixtures_dir), al, ilqr)
    _assert_solutions_agree(want, got)
    if name == "bicycle":
        assert float(jnp.max(want.lam)) > 0.0, "the steering bound should be active"


FIXTURES = {"quat": quat_fixture, "trot": trot_fixture, "convex": convex_fixture}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_golden_fixture(name, fixtures_dir):
    """The golden C++ trajectories at full size and default options (6 x 10,
    12 alphas), at the JAX tests' own bounds
    (tests/test_solver_fixtures.py:82-83,115-116,177-182), on the problem
    `examples.fixture_problem` builds, which is leaf by leaf the one these
    tests rebuild from the reference's standalone C++ tests."""
    jspec, _, jprob, (gold_us, gold_xs, atol_u, atol_x) = FIXTURES[name](fixtures_dir)
    tspec, prob, t_us, t_xs, t_atol_u, t_atol_x = tex.fixture_problem(name, F64, "cpu", fixtures_dir)
    assert (t_atol_u, t_atol_x) == (atol_u, atol_x)
    np.testing.assert_array_equal(t_us, np.array(gold_us))
    np.testing.assert_array_equal(t_xs, np.array(gold_xs))
    assert (tspec.nx, tspec.nu, tspec.quat_idx, tspec.integrator) == (
        jspec.nx, jspec.nu, jspec.quat_idx, jspec.integrator)
    want = _port_problem(jprob)
    for g, w in zip(tree_leaves(prob), tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-15)
    sol = tal.make_solver(tspec, SolverOptions())(prob)
    np.testing.assert_allclose(sol.us.numpy(), t_us, rtol=0, atol=atol_u)
    np.testing.assert_allclose(sol.xs.numpy()[: len(t_xs)], t_xs, rtol=0, atol=atol_x)
    assert float(sol.stats.constraint_violation) < 1e-6


def test_bicycle_receding_solves_match_jax(fixtures_dir):
    """Three receding ticks of the scotty-dog bicycle MPC (N=30, 2 x 8, state
    rows Cx, Qdf; tests/test_classic.py:69-127) as `examples.bicycle_tracking`
    builds it: the closed-loop state to 1e-7 against the JAX loop."""
    from quaternion_mpc_tpu.models import discretize as jdisc
    from quaternion_mpc_tpu_torch.models import discretize as tdisc

    spec, opts, build, x_ref, u_ref, params, h, delta_max = tex.bicycle_tracking(
        F64, "cpu", fixtures_dir)
    assert tuple(opts)[:2] == (2, 8) and delta_max == pytest.approx(np.pi / 3)
    jx_ref, ju_ref = jnp.asarray(x_ref.numpy()), jnp.asarray(u_ref.numpy())
    jparams = (jnp.asarray(2.7), jnp.asarray(1.5))
    jsolver = jmake_solver(JModelSpec(nx=4, nu=2, f=jclassic.bicycle_dynamics, quat_idx=None),
                           JSolverOptions(al_iterations=2, ilqr_iterations=8))

    @jax.jit
    def jstep(k0, x0, us_warm):
        idx = k0 + jnp.arange(31)
        prob = JTrajOptProblem(
            x0=x0,
            cost=JCostSpec(Qd=1e-2 * jnp.ones(4), Rd=1e-3 * jnp.ones(2), w=jnp.asarray(0.0),
                           x_ref=jx_ref[idx], u_ref=ju_ref[idx], Qdf=1e1 * jnp.ones(4)),
            Cu=jnp.zeros((2, 2)), cb=jnp.asarray([-delta_max, -delta_max]), h=jnp.asarray(h.numpy()),
            params=jparams, us_init=us_warm, Cx=jnp.asarray([[0.0, 0, 0, 1.0], [0.0, 0, 0, -1.0]]),
        )
        sol = jsolver(prob)
        x1 = jdisc.midpoint_step(jclassic.bicycle_dynamics, x0, sol.us[0], jparams, prob.h)
        return x1, jnp.concatenate([sol.us[1:], sol.us[-1:]])

    solver = tal.make_solver(spec, opts)
    x, us = x_ref[0] + torch.tensor([0.2, -0.1, 0.05, 0.0], dtype=F64), u_ref[0].expand(30, 2)
    jx, jus = jnp.asarray(x.numpy()), jnp.asarray(us.numpy())
    for k in range(3):
        sol = solver(build(k, x, us))
        x = tdisc.midpoint_step(tclassic.bicycle_dynamics, x, sol.us[0], params, h)
        us = torch.cat([sol.us[1:], sol.us[-1:]])
        jx, jus = jstep(k, jx, jus)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-7, err_msg=f"tick {k}")
        np.testing.assert_allclose(us.numpy(), np.asarray(jus), rtol=0, atol=1e-7)


def test_classic_problems_reach_their_goals():
    """The unconstrained progression problems (`examples.classic_problem`; no
    rows at all, nc = 0) as tests/test_classic.py:26-66 holds them: the
    double integrator at its goal, the pendulum swung up."""
    spec, prob = tex.classic_problem("double_integrator", 20, F64, "cpu")
    assert prob.Cu.shape == (0, 2) and prob.cb.shape == (0,)
    sol = tal.make_solver(spec, SolverOptions(al_iterations=1, ilqr_iterations=20))(prob)
    np.testing.assert_allclose(sol.xs[-1].numpy(), [1.0, -0.5, 0.0, 0.0], rtol=0, atol=1e-2)
    assert sol.lam.shape == (21, 0) and float(sol.stats.constraint_violation) == 0.0
    spec, prob = tex.classic_problem("pendulum", 60, F64, "cpu")
    sol = tal.make_solver(spec, SolverOptions(al_iterations=1, ilqr_iterations=80))(prob)
    assert abs(float(sol.xs[-1, 0]) - np.pi) <= 0.05 and abs(float(sol.xs[-1, 1])) <= 0.1
    with pytest.raises(ValueError, match="unknown classic problem"):
        tex.classic_problem("cartpole", 5, F64, "cpu")


def test_falling_cat_fleet_is_seeded():
    spec, prob, opts = tex.falling_cat_fleet(16, torch.float32, "cpu", seed=3)
    again = tex.falling_cat_fleet(16, torch.float32, "cpu", seed=3)[1]
    assert torch.equal(prob.x0, again.x0) and prob.x0.dtype == torch.float32
    assert prob.x0.shape == (16, 7) and prob.cost.w.shape == (16, 41) and prob.Cu.shape == (16, 6, 3)
    angle = 2.0 * torch.rad2deg(torch.acos(prob.x0[:, 0]))
    assert float(angle.min()) >= 100.0 - 1e-3 and float(angle.max()) <= 175.0 + 1e-3
    np.testing.assert_allclose(torch.linalg.norm(prob.x0[:, :4], dim=-1).numpy(), 1.0, atol=1e-6)
    assert (spec.ne, spec.nu) == (6, 3) and tuple(opts)[:2] == (3, 25)


# Starts of `falling_cat_fleet(4096, seed=0)`, the fleet chip_smoke.py solves,
# that run away. The geodesic cost w·(1 − |q_ref·q|) is unbounded below in |q|,
# which the midpoint rule inflates at high rates; from these starts (169 and
# 171 degrees) the line search finds that descent within a few iterations.
RUNAWAY_STARTS = (3925, 626)


def test_falling_cat_runaway_starts_run_away_in_jax_too():
    """The runaway is the reference's behaviour, not the port's: from the
    same starts the JAX solver and the port both leave the unit sphere by
    orders of magnitude with a cost far below zero. From the first the two
    agree to 1e-6 of the inputs' scale all the way (four iterations); from
    the second the blow-up is chaotic and each ends on its own trajectory.
    A start the fleet holds (index 0) stays on the sphere in both."""
    x0s = tex.falling_cat_fleet(4096, F64, "cpu", seed=0)[1].x0
    jspec, jprob, jopts = jscn.falling_cat()
    tspec, tprob, topts = tscn.falling_cat(dtype=F64, device="cpu")
    jsolve, tsolve = jax.jit(jmake_solver(jspec, jopts)), tal.make_solver(tspec, topts)
    norms = {}
    for i in RUNAWAY_STARTS + (0,):
        want = jsolve(jprob._replace(x0=jnp.asarray(x0s[i].numpy())))
        got = tsolve(tprob._replace(x0=x0s[i]))
        norms[i] = (float(jnp.linalg.norm(want.xs[:, :4], axis=-1).max()),
                    float(torch.linalg.norm(got.xs[:, :4], dim=-1).max()))
        if i in RUNAWAY_STARTS:
            assert min(norms[i]) > 100.0, (i, norms[i])
            assert float(want.stats.cost) < -1e6 and float(got.stats.cost) < -1e6
        else:
            assert max(abs(n - 1.0) for n in norms[i]) <= 5e-3, norms[i]
        if i == RUNAWAY_STARTS[0]:
            us = np.asarray(want.us)
            assert int(want.stats.iterations) == int(got.stats.iterations) == 4
            assert np.abs(us - got.us.numpy()).max() <= 1e-6 * np.abs(us).max()


def test_batched_matches_unbatched(fixtures_dir):
    """A leading batch axis on every leaf (the reference's `jax.vmap(solver)`)
    gives each scenario its own solve: 1e-10 against the unbatched one."""
    _, tspec, jprob, _ = quat_fixture(fixtures_dir, N=8)
    prob = _port_problem(jprob)
    rng = np.random.default_rng(5)
    x0s = prob.x0 + torch.from_numpy(0.02 * rng.standard_normal((3, 13)))
    x0s[:, 3:7] = x0s[:, 3:7] / torch.linalg.norm(x0s[:, 3:7], dim=-1, keepdim=True)
    solver = tal.make_solver(tspec, SolverOptions(al_iterations=2, ilqr_iterations=3))
    sol_b = solver(tal.broadcast_problem(prob, 3)._replace(x0=x0s))
    assert sol_b.us.shape == (3, 8, 12) and sol_b.xs.shape == (3, 9, 13)
    assert sol_b.lam.shape == (3, 9, 24) and sol_b.stats.cost.shape == (3,)
    assert sol_b.stats.iterations.shape == (3,)
    for b in range(3):
        sol_1 = solver(prob._replace(x0=x0s[b]))
        np.testing.assert_allclose(sol_b.us[b].numpy(), sol_1.us.numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(sol_b.xs[b].numpy(), sol_1.xs.numpy(), rtol=0, atol=1e-10)
        np.testing.assert_allclose(sol_b.lam[b].numpy(), sol_1.lam.numpy(), rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# The fleet solver's new fields, one at a time
# ---------------------------------------------------------------------------


def _double_integrator(integrator="midpoint", bound=0.8, x0=(0.0, 0.0, 0.0, 0.0), **more):
    N, dim = 6, 2
    goal = np.array([1.0, -0.5, 0.0, 0.0])
    rng = np.random.default_rng(11)
    u_ref = 0.1 * rng.standard_normal((N + 1, dim))
    prob = _problem(x0, np.ones(4), 1e-2 * np.ones(dim), 0.0, np.tile(goal, (N + 1, 1)),
                    u_ref, [[1.0, 0.0], [-1.0, 0.0]], [-bound, -bound], 0.1, None, N, **more)
    jspec = JModelSpec(nx=4, nu=dim, f=jclassic.double_integrator_dynamics, quat_idx=None,
                       integrator=integrator)
    tspec = ModelSpec(nx=4, nu=dim, f=tclassic.double_integrator_dynamics, quat_idx=None,
                      integrator=integrator)
    return jspec, tspec, prob


def _per_knot_w(fixtures_dir):
    jspec, tspec, prob, _ = quat_fixture(fixtures_dir, N=5)
    w = jnp.asarray([1.0, 2.0, 0.5, 3.0, 1.5, 40.0])
    return jspec, tspec, prob._replace(cost=prob.cost._replace(w=w))


ONE_FIELD = {
    "Qdf": lambda d: _double_integrator(Qdf=[50.0, 20.0, 5.0, 1.0]),
    "per_knot_w": _per_knot_w,
    "Cx": lambda d: _double_integrator(
        bound=0.3, x0=(0.28, 0.0, 0.3, 0.0), Cx=[[1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, -1.0]]),
    "euler": lambda d: _double_integrator(integrator="euler"),
}


@pytest.mark.parametrize("field", sorted(ONE_FIELD))
def test_one_new_field_matches_jax(field, fixtures_dir):
    """Qdf, a per-knot w, state rows Cx and the Euler integrator, each in a
    problem that has only that one, against the JAX solver."""
    want, got = _solve_both(*ONE_FIELD[field](fixtures_dir), 2, 3)
    _assert_solutions_agree(want, got)
    if field == "Cx":
        # rows that mix u and x (a cross term lux), at stage knots and the terminal one
        assert float(jnp.max(want.lam[:-1])) > 0.0 and float(jnp.max(want.lam[-1])) > 0.0


def test_old_fleet_paths_unchanged_bit_for_bit(fixtures_dir):
    """A `FleetProblem` that names none of the new fields computes what it
    computed before them, and naming each at its neutral value (Qdf = Qd, a
    per-knot w that is constant, "midpoint") computes the same, bit for bit."""
    prob, _, _ = tex.fixture_fleet_problem(3, F64, "cpu", fixtures_dir)
    assert prob.Qdf is None and prob.Cx is None
    spec = tq.FLEET_MODEL_SPEC
    assert spec.integrator == "midpoint"
    opts = SolverOptions(al_iterations=2, ilqr_iterations=3)
    base = tfl.make_fleet_solver(spec, opts, backend="sweep", stats=True)(prob)
    assert base.lam.shape == (20, 24, 3)
    neutral = prob._replace(Qdf=prob.Qd, w=prob.w.expand(21, 1).clone())
    for backend in ("sweep", "assoc"):
        want = base if backend == "sweep" else tfl.make_fleet_solver(spec, opts, backend, True)(prob)
        got = tfl.make_fleet_solver(
            spec._replace(integrator="midpoint"), opts, backend, stats=True)(neutral)
        for name in ("xs", "us", "cost", "lam", "constraint_violation", "grad_norm"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (backend, name)
        assert torch.equal(got.active_iterations, want.active_iterations)
    assert base.active_iterations.dtype == torch.int32
    assert int(base.active_iterations.max()) <= base.iterations == 6


def test_solution_stats_of_the_fleet(fixtures_dir):
    """`FleetSolution` carries what `SolveStats` holds, per scenario, when
    the solver is built with ``stats``; a fleet controller's solver is not,
    and computes the same trajectories without them."""
    prob, _, _ = tex.fixture_fleet_problem(2, F64, "cpu", fixtures_dir)
    opts = SolverOptions(1, 2)
    sol = tfl.make_fleet_solver(tq.FLEET_MODEL_SPEC, opts, "sweep", stats=True)(prob)
    c = tfl.constraint_values(prob, sol.xs, sol.us)
    assert torch.equal(sol.constraint_violation, torch.clamp(c, min=0).amax(dim=(0, 1)))
    assert sol.grad_norm.shape == (2,) and torch.isfinite(sol.grad_norm).all()
    bare = tfl.make_fleet_solver(tq.FLEET_MODEL_SPEC, opts, "sweep")(prob)
    assert bare.constraint_violation is None and bare.grad_norm is None
    assert bare.active_iterations is None
    for name in ("xs", "us", "cost", "lam"):
        assert torch.equal(getattr(bare, name), getattr(sol, name)), name


# ---------------------------------------------------------------------------
# K1 at ne, nu <= 12
# ---------------------------------------------------------------------------


def _random_expansions(ne, nu, N, B, dtype, seed=0):
    """Well-posed expansions: SPD lxx, luu, lxxN; contracting As."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    spd = lambda n, *lead: (lambda m: torch.einsum("...ikb,...jkb->...ijb", m, m)
                            + 0.5 * torch.eye(n)[..., None])(r(*lead, n, n, B))
    out = (
        0.3 * r(N, ne, ne, B) + torch.eye(ne)[..., None], 0.2 * r(N, ne, nu, B), r(N, ne, B),
        spd(ne, N), r(N, nu, B), spd(nu, N), r(ne, B), spd(ne),
        torch.full((B,), 1e-6, dtype=torch.float64),
    )
    return tuple(t.to(dtype).contiguous() for t in out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("ne,nu", [(12, 6), (6, 3), (2, 1), (4, 2), (12, 12)])
def test_k1_embedding_is_exact(ne, nu, dtype):
    """The 12 x 12 sweep on `embed`'s inputs, sliced (what the card runs for a
    shape with no instantiation of its own, into the instantiation that holds
    it), against the plain sweep at the problem's own size. The
    elimination takes the columns in order without pivoting and the added
    rows and columns couple to nothing: the added gains are exactly 0, and
    the live block is the native one up to the order of its sums. On this
    torch (4, 2) and (2, 1) come out equal to 0; (12, 6) and (6, 3) differ
    in the last bits (6e-15 in f64) because the CPU reduction groups the
    terms of a length-6 or length-3 axis differently from those of a
    length-12 one. So the bound is rounding: 1e-12 (f64) and 1e-4 (f32) of
    each output's largest value. The kernel adds its terms k = 0..11 in
    order, where appended zeros change no partial sum; the emulated device
    code and the card are held to the native plain sweep too."""
    args = _random_expansions(ne, nu, N=7, B=5, dtype=dtype, seed=ne * 13 + nu)
    want = rs.riccati_sweep_ref(*args)
    big = rs.embed(*args)
    assert big[0].shape == (7, 12, 12, 5) and big[5].shape == (7, 12, 12, 5)
    Ks, ds, dV1, dV2, gmax = rs.riccati_sweep_ref(*big)
    assert torch.count_nonzero(Ks[:, nu:]) == 0 and torch.count_nonzero(Ks[:, :, ne:]) == 0
    assert torch.count_nonzero(ds[:, nu:]) == 0
    got = (Ks[:, :nu, :ne], ds[:, :nu], dV1, dV2, gmax)
    for name, g, w in zip(("Ks", "ds", "dV1", "dV2", "gmax"), got, want):
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= (1e-12 if dtype == torch.float64 else 1e-4), (name, err)
        if (ne, nu) in ((4, 2), (2, 1), (12, 12)):
            assert torch.equal(g, w), name
    # the wrapper on CPU tensors is the plain sweep at the native size
    for g, w in zip(rs.riccati_sweep(*args), want):
        assert torch.equal(g, w)


def test_k1_size_limits():
    """ne or nu above 12 raises; the scan backend stays at 12 x 12 and says so."""
    with pytest.raises(ValueError, match="ne <= 12"):
        rs.riccati_sweep(*_random_expansions(13, 4, 3, 2, F64))
    with pytest.raises(ValueError, match="nu <= 12"):
        rs.riccati_sweep(*_random_expansions(6, 13, 3, 2, F64))
    with pytest.raises(ValueError, match="ne = nu = 12 only"):
        tk4.assoc_backward(*_random_expansions(6, 3, 3, 2, F64))


def test_k1_work_counts_the_problem_at_its_own_size():
    """`work` is what the bound on the card is computed from: the bytes and
    multiply-adds of the function at (ne, nu), not of a 12 x 12 launch that
    embeds it."""
    w = rs.work(10, 4096, torch.float32)
    assert w["bytes"] == 4096 * 4 * (756 * 10 + 160)
    assert rs.macs_per_knot() == 9 * 12**3 + sum(11 * (24 - j) for j in range(12)) + 5 * 144 + 168
    assert w["flops"] == 2 * rs.macs_per_knot() * 10 * 4096
    # falling_cat: As 36, Bs 18, lxxs 36, luus 9, lxs 6, lus 3, Ks 18, ds 3 a knot
    cat = rs.work(40, 4096, torch.float32, ne=6, nu=3)
    assert cat["bytes"] == 4096 * 4 * (129 * 40 + 6 + 36 + 1 + 3)
    assert cat["flops"] < w["flops"] * 4 / 6
    # the bicycle's cross term: nu * ne more values a knot, in f64
    plain, cross = (rs.work(30, 1, torch.float64, ne=4, nu=2, lux=lux) for lux in (False, True))
    assert cross["bytes"] - plain["bytes"] == 8 * 30 * 8 and cross["flops"] == plain["flops"]


# (ne, nu, lux) -> the instantiation K1 launches: its own, or the one with the
# fewest values a knot that holds it (then through `embed`)
K1_DISPATCH = [
    ((12, 12, False), (12, 12)), ((12, 12, True), (12, 12)), ((12, 6, False), (12, 6)),
    ((6, 3, False), (6, 3)), ((4, 2, False), (4, 2)), ((4, 2, True), (4, 2)),
    ((2, 1, False), (2, 1)), ((5, 3, False), (6, 3)), ((3, 3, False), (6, 3)),
    ((3, 1, False), (4, 2)), ((1, 1, False), (2, 1)), ((8, 2, False), (12, 6)),
    ((7, 5, False), (12, 6)), ((12, 7, False), (12, 12)), ((6, 3, True), (12, 12)),
    ((2, 1, True), (4, 2)), ((12, 6, True), (12, 12)),
]


@pytest.mark.parametrize("shape, want", K1_DISPATCH, ids=[f"{e}x{u}{'-lux' * x}"
                                                         for (e, u, x), _ in K1_DISPATCH])
def test_k1_dispatch_picks_the_instantiation(shape, want):
    """`riccati_sweep` on the card launches the instantiation that matches
    (ne, nu, lux), and embeds any other shape in the smallest that holds it
    (what `instantiation` answers is what the wrapper launches)."""
    ne, nu, lux = shape
    assert rs.instantiation(ne, nu, lux) == want
    assert (want + (lux,)) in rs.INSTANTIATIONS
    assert (shape in rs.INSTANTIATIONS) == (want == (ne, nu))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("ne,nu,size", [(5, 3, (6, 3)), (3, 1, (4, 2)), (1, 1, (2, 1)),
                                        (7, 5, (12, 6)), (6, 3, (12, 6)), (2, 1, (4, 2))])
def test_k1_embedding_into_a_smaller_instantiation(ne, nu, size, dtype):
    """`embed` with a target size: the plain sweep on the embedded inputs
    gives added gains of exactly 0 and, in its live block, the plain sweep at
    the problem's own size up to the order of torch's CPU sums (as
    `test_k1_embedding_is_exact` explains); with the cross term too."""
    args = _random_expansions(ne, nu, N=6, B=4, dtype=dtype, seed=ne * 7 + nu)
    g = torch.Generator().manual_seed(ne + nu)
    luxs = (0.3 * torch.randn(6, nu, ne, 4, generator=g, dtype=torch.float64)).to(dtype)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    for cross in (None, luxs):
        big = rs.embed(*args, luxs=cross, size=size)
        assert big[0].shape == (6, *size[:1] * 2, 4) and big[1].shape == (6, size[0], size[1], 4)
        assert len(big) == 9 + (cross is not None)
        Ks, ds, dV1, dV2, gmax = rs.riccati_sweep_ref(*big[:9], luxs=big[9] if len(big) > 9
                                                      else None)
        assert Ks.shape == (6, size[1], size[0], 4)
        assert torch.count_nonzero(Ks[:, nu:]) == 0 and torch.count_nonzero(Ks[:, :, ne:]) == 0
        assert torch.count_nonzero(ds[:, nu:]) == 0
        want = rs.riccati_sweep_ref(*args, luxs=cross)
        for name, got, w in zip(("Ks", "ds", "dV1", "dV2", "gmax"),
                                (Ks[:, :nu, :ne], ds[:, :nu], dV1, dV2, gmax), want):
            err = float((got - w).abs().max() / w.abs().max())
            assert err <= tol, (name, err)


def test_k1_work_at_each_instantiation():
    """`work`, the bound's count, at each instantiation's own size: per knot
    As and lxxs ne² each, Bs ne·nu, luus nu², lxs ne, lus nu, the cross term
    nu·ne, Ks nu·ne and ds nu; per scenario lxN, lxxN, reg, dV1, dV2, gmax;
    two operations a multiply-add (`macs_per_knot`). The launch's shared
    memory at each is held in tests/test_torch_sweep_emulation.py (the
    source's `riccati_sweep_smem_bytes`, which `shared_bytes` reads)."""
    for ne, nu, lux in rs.INSTANTIATIONS:
        for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
            w = rs.work(40, 4096, dtype, ne, nu, lux)
            knot = 2 * ne * ne + ne * nu + nu * nu + ne + nu + (1 + lux) * nu * ne + nu
            assert w["bytes"] == 4096 * size * (40 * knot + ne + ne * ne + 4), (ne, nu, lux)
            assert w["flops"] == 2 * rs.macs_per_knot(ne, nu) * 40 * 4096
    # falling_cat: products 2·6³ + 5·6²·3 + 2·6·3², the 3 x 10 elimination
    # 2·(9 + 8 + 7), the matrix-vector products 6² + 4·6·3 + 3² + 2·3
    assert rs.macs_per_knot(6, 3) == 1080 + 48 + 123

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("ne,nu", [(4, 2), (6, 3), (12, 12)])
def test_k1_embedding_with_the_cross_term(ne, nu, dtype):
    """`embed` pads the cross term lux with zeros, so the 12 x 12 plain sweep
    on the embedded inputs gives the native sweep's live block (to rounding,
    as `test_k1_embedding_is_exact` explains) and added gains of exactly 0;
    and the cross term changes the gains."""
    args = _random_expansions(ne, nu, N=5, B=3, dtype=dtype, seed=ne + nu)
    g = torch.Generator().manual_seed(7)
    luxs = (0.3 * torch.randn(5, nu, ne, 3, generator=g, dtype=torch.float64)).to(dtype)
    want = rs.riccati_sweep_ref(*args, luxs=luxs)
    assert not torch.allclose(want[0], rs.riccati_sweep_ref(*args)[0])
    big = rs.embed(*args, luxs=luxs)
    assert len(big) == 10 and big[9].shape == (5, 12, 12, 3)
    assert torch.equal(big[9][:, :nu, :ne], luxs)
    assert torch.count_nonzero(big[9]) == torch.count_nonzero(luxs)
    Ks, ds, dV1, dV2, gmax = rs.riccati_sweep_ref(*big[:9], luxs=big[9])
    assert torch.count_nonzero(Ks[:, nu:]) == 0 and torch.count_nonzero(Ks[:, :, ne:]) == 0
    for name, got, w in zip(("Ks", "ds", "dV1", "dV2", "gmax"),
                            (Ks[:, :nu, :ne], ds[:, :nu], dV1, dV2, gmax), want):
        err = float((got - w).abs().max() / w.abs().max())
        assert err <= (1e-12 if dtype == torch.float64 else 1e-4), (name, err)
    for got, w in zip(rs.riccati_sweep(*args, luxs=luxs), want):
        assert torch.equal(got, w)
    with pytest.raises(ValueError, match="luxs must have shape"):
        rs.riccati_sweep(*args, luxs=luxs.transpose(1, 2).contiguous() if ne != nu
                         else luxs[:-1].contiguous())


def test_state_rows_reach_the_sweep_with_the_cross_term(fixtures_dir, monkeypatch):
    """Every backward pass of the sweep backend goes through
    `kernels.riccati_sweep`, once each: a problem with state rows hands it
    the cross term lux (N, nu, ne, B), every other one none. The scan
    backend refuses state rows."""
    calls = []
    real = rs.riccati_sweep

    def spy(*args, luxs=None):
        calls.append(None if luxs is None else tuple(luxs.shape))
        return real(*args, luxs=luxs)

    monkeypatch.setattr(rs, "riccati_sweep", spy)
    _, tspec, jprob = bicycle_problem(fixtures_dir)
    prob = _port_problem(jprob)
    N = prob.us_init.shape[0]
    tal.make_solver(tspec, SolverOptions(1, 2))(prob)
    assert calls == [(N, 2, 4, 1)] * 2
    calls.clear()
    tal.make_solver(tspec, SolverOptions(1, 2))(prob._replace(Cx=None))
    assert calls == [None, None]
    with pytest.raises(ValueError, match="state rows"):
        tfl.make_fleet_solver(tal.fleet_spec(tspec), SolverOptions(1, 1), "assoc")(
            tal.lift_problem(prob))


def test_model_functions_need_a_fleet_form():
    with pytest.raises(TypeError, match="single_view"):
        tal.make_solver(ModelSpec(nx=2, nu=1, f=lambda x, u, p: x))
    spec = tal.fleet_spec(ModelSpec(nx=7, nu=3, f=tattitude.attitude_dynamics, quat_idx=0))
    assert spec.f is tattitude.attitude_dynamics_fleet and spec.fj is None and spec.edj is None
    quat = tal.fleet_spec(ModelSpec(nx=13, nu=12, **TQUAT))
    assert quat.edj is tsrb.quat_srb_error_discrete_jac_fleet
