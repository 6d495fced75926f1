"""K2's plain version against the JAX reference, and which specs run K2.

The port's `solver.fleet.line_search` (the plain version of
`kernels.line_search`, what the wrapper runs on the CPU) against a JAX
composition of the reference's own functions, the lines of the JAX
package's `solver/fleet.py` it replaces: `jax.vmap` of `rollout` and
`total_cost` over the alphas, then the Armijo test, the accept and the
NaN-safe select (:757-799). Same seeded inputs on both sides, f64, held to
1e-12 of scale: the per-alpha costs (non-finite in the same places), xs,
us and J, and accepted and improved exactly.

Problems of each model K2 has an instantiation for: the quaternion SRB's
golden standing fixture (N = 20, leaves shared along B), Go1 fleet
controller (four feet, every leaf per scenario) and humanoid (two feet);
the Euler SRB's convex fleet controller (midpoint rule) and golden convex
fixture (forward Euler, N = 30, leaves shared along B); the attitude
model's falling_cat fleet (N = 8, per-knot w, Qdf). On the quaternion
controller's problem, an alpha whose rollout overflows to Inf / NaN, a
scenario that accepts nothing, `done` scenarios, per-knot w and cb with a
terminal weight Qdf, and a weight row shared by the fleet (B|1). The
reference's fleet problem has one geodesic weight for the horizon, so a
per-knot w is composed from its `stage_cost_terms` and `al_value` knot by
knot. The reference has its attitude model in the single form only: its
fleet form here is `jax.vmap` of it over the batch axis.

Then the tags: each model's specs carry its own where K2 has an
instantiation for the spec's integrator, every other spec none; a tagged
solve calls K2's wrapper once an iLQR iteration and an untagged one never;
and the wrapper's own checks on the CPU.

K9 (`kernels.rollout`) on the same problems: its plain versions, what its
wrapper runs on the CPU, against the reference's own lines: the open-loop
rollout (the `init_step` `lax.scan`, solver/fleet.py:728-732), `total_cost`
of a trajectory under drawn multipliers and of the final one (zero
multipliers at ρ = 1e-30, :829-831) and the multiplier update (`cvals_k`,
:815-818), f64 to 1e-12 of scale; a tagged solve calls its rollout once and
its pricing al + 1 times, an untagged one or one with state rows never."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quaternion_mpc_tpu.control import convex_mpc as jcv
from quaternion_mpc_tpu.control import quat_mpc as jq
from quaternion_mpc_tpu.models import attitude as jattitude
from quaternion_mpc_tpu.models import srb as jsrb
from quaternion_mpc_tpu.solver import fleet as jfl
from quaternion_mpc_tpu_torch import examples
from quaternion_mpc_tpu_torch import scenarios as tsc
from quaternion_mpc_tpu_torch.control import convex_mpc as tcv
from quaternion_mpc_tpu_torch.control import quat_mpc as tq
from quaternion_mpc_tpu_torch.kernels import line_search as k2
from quaternion_mpc_tpu_torch.kernels import rollout as k9
from quaternion_mpc_tpu_torch.models import attitude as tattitude
from quaternion_mpc_tpu_torch.models import classic as tclassic
from quaternion_mpc_tpu_torch.models import srb as tsrb
from quaternion_mpc_tpu_torch.solver import al_ilqr as tal
from quaternion_mpc_tpu_torch.solver import fleet as tfl
from quaternion_mpc_tpu_torch.solver.problem import ModelSpec, SolverOptions

import quaternion_mpc_tpu_torch

# the port makes its tensors on the card unless told otherwise; these tests run on the CPU
quaternion_mpc_tpu_torch.set_default_device("cpu")

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-12


def _j(t):
    return None if t is None else jnp.asarray(t.detach().numpy())


def _jax_problem(prob):
    """The reference's FleetProblem with the port's leaves (it has no Cx)."""
    kind = jattitude.AttitudeParams if isinstance(prob.params, tattitude.AttitudeParams) \
        else jsrb.SrbParams
    params = kind(*(_j(getattr(prob.params, f)) for f in kind._fields))
    return jfl.FleetProblem(**{f: _j(getattr(prob, f)) for f in jfl.FleetProblem._fields
                               if f != "params"}, params=params)


def _jax_attitude_fleet(x, u, p):
    """The reference's attitude model over a batch-last fleet: `jax.vmap` of
    its single form over the last axis of x, u and the inertia (B or 1)."""
    inertia = jnp.broadcast_to(p.inertia, (3, 3, x.shape[-1]))
    one = lambda x1, u1, i1: jattitude.attitude_dynamics(x1, u1, jattitude.AttitudeParams(i1))
    return jax.vmap(one, in_axes=(-1, -1, -1), out_axes=-1)(x, u, inertia)


def _jax_spec(spec):
    """The reference's FleetModelSpec of the port's."""
    if spec.line_search == "euler_srb":
        return jfl.FleetModelSpec(nx=12, nu=spec.nu, f=jsrb.euler_srb_dynamics_fleet,
                                  fj=jsrb.euler_srb_jacobian_fleet, quat_idx=None,
                                  integrator=spec.integrator)
    if spec.line_search == "attitude":
        return jfl.FleetModelSpec(nx=7, nu=3, f=_jax_attitude_fleet, fj=None, quat_idx=0,
                                  integrator=spec.integrator)
    if spec.nu == 12:
        return jq._fleet_spec()
    return jfl.FleetModelSpec(nx=13, nu=spec.nu, f=jsrb.quat_srb_dynamics_fleet,
                              fj=jsrb.quat_srb_jacobian_fleet, quat_idx=3)


def _jax_total_cost(spec, xs, us, prob, lam, rho):
    """`total_cost` of the reference; for a per-knot w (N+1, B|1), its
    `stage_cost_terms` and `al_value` knot by knot and its terminal term."""
    if prob.w.ndim == 1:
        return jfl.total_cost(spec, xs, us, prob, lam, rho)
    N = us.shape[0]
    cb = jfl.cb_knots(prob.cb, N)
    total = 0.0
    for k in range(N):
        c = jfl.bmv(prob.Cu, us[k]) + cb[k]
        total = total + jfl.stage_cost_terms(
            spec, xs[k], us[k], prob.x_ref[k], prob.u_ref[k], prob._replace(w=prob.w[k])
        ) + jfl.al_value(c, lam[k], rho)
    dxN = xs[N] - prob.x_ref[N]
    Qdf = prob.Qd if prob.Qdf is None else prob.Qdf
    qi = spec.quat_idx
    dot = jnp.sum(xs[N][qi : qi + 4] * prob.x_ref[N][qi : qi + 4], axis=0)
    return total + 0.5 * jnp.sum(Qdf * dxN * dxN, axis=0) + prob.w[N] * (1.0 - jnp.abs(dot))


def _jax_line_search(spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho, alphas):
    """The reference's line search (solver/fleet.py:757-799) on these inputs,
    J None priced by its `total_cost` first (:388, as its AL loop does at
    :806): (xs, us, J, J_out, accepted, improved, J_m)."""
    B = xs.shape[-1]
    if J is None:
        J = _jax_total_cost(spec, xs, us, prob, lam, rho)
    n_alpha = alphas.shape[0]

    def roll_one(alpha):
        xs_a, us_a = jfl.rollout(spec, prob, xs, us, Ks, ds, alpha * jnp.ones((B,), xs.dtype))
        return xs_a, us_a, _jax_total_cost(spec, xs_a, us_a, prob, lam, rho)

    xs_m, us_m, J_m = jax.vmap(roll_one)(alphas)
    expected = -(alphas[:, None] * dV1[None, :] + (alphas**2)[:, None] * dV2[None, :])
    ok = jnp.where(
        expected > 0.0,
        (J[None, :] - J_m) / jnp.maximum(expected, 1e-30) > 1e-4,
        J_m < J[None, :] + 1e-12,
    )
    ok = ok & jnp.isfinite(J_m)
    accepted = jnp.any(ok, axis=0)
    first = jnp.argmax(ok, axis=0)
    sel = (jnp.arange(n_alpha)[:, None] == first[None, :]) & ok
    selm = sel[:, None, None, :]
    xs_ls = jnp.sum(jnp.where(selm, xs_m, 0.0), axis=0)
    us_ls = jnp.sum(jnp.where(selm, us_m, 0.0), axis=0)
    J_ls = jnp.sum(jnp.where(sel, J_m, 0.0), axis=0) + jnp.where(accepted, 0.0, J)
    improved = accepted & (J_ls < J)
    take = improved & ~done
    xs = jnp.where(take[None, None, :], xs_ls, xs)
    us = jnp.where(take[None, None, :], us_ls, us)
    J_out = jnp.where(take, J_ls, J)
    return xs, us, J, J_out, accepted, improved, J_m


def _hold(spec, prob, kw, what):
    """The port's plain line search against the reference's on the same inputs."""
    got = tfl.line_search(spec, prob, **kw, with_costs=True)
    jkw = {k: _j(v) for k, v in kw.items()}
    want = _jax_line_search(_jax_spec(spec), _jax_problem(prob), **jkw)
    xs, us, J, J_out, accepted, improved, J_m = (np.asarray(a) for a in want)
    g = [t.numpy() for t in got]
    fin = np.isfinite(J_m)
    assert np.array_equal(np.isfinite(g[6]), fin), f"{what}: costs non-finite elsewhere"
    scale = np.maximum(np.abs(np.where(fin, J_m, 0.0)).max(), np.abs(J).max())
    assert np.abs(np.where(fin, g[6] - J_m, 0.0)).max() <= TOL * scale, f"{what}: J_m"
    assert np.abs(g[2] - J).max() <= TOL * scale, f"{what}: J"
    for name, a, b in (("xs", g[0], xs), ("us", g[1], us), ("J_out", g[3], J_out)):
        assert np.abs(a - b).max() <= TOL * np.abs(b).max(), f"{what}: {name}"
    assert np.array_equal(g[4], accepted) and np.array_equal(g[5], improved), what
    return got


@pytest.mark.parametrize("priced", [False, True], ids=["J_given", "J_priced"])
@pytest.mark.parametrize(
    "name,batch,horizon,n_alphas",
    [("fixture", 4, 20, 12), ("standing", 6, 10, 8), ("humanoid", 4, 6, 12),
     ("convex", 6, 10, 8), ("convex_fixture", 4, 30, 12), ("falling_cat", 5, 8, 12)],
)
def test_plain_line_search_matches_jax(name, batch, horizon, n_alphas, priced):
    """``priced``: J None, the cost of (xs, us) priced by the line search
    (an AL iteration's first)."""
    spec, prob, kw = examples.line_search_case(name, batch, F64, "cpu", horizon, n_alphas)
    got = _hold(spec, prob, {**kw, "J": None} if priced else kw, name)
    assert bool(got[4].all()) and bool(got[5].all()), "a first iteration improves every scenario"
    assert torch.equal(got[2], kw["J"]), "the priced J is the solver's total_cost of (xs, us)"


def _hard_case(per_knot):
    spec, prob, _ = examples.line_search_case("standing", 7, F64, "cpu", 10, 12)
    N, B = prob.us_init.shape[0], prob.us_init.shape[-1]
    rng = np.random.default_rng(5)
    if per_knot:
        cb = prob.cb[None].expand(N + 1, *prob.cb.shape).clone()
        cb[:, 4::6][torch.from_numpy(rng.random((N + 1, 4, B)) < 0.3)] = 0.0
        prob = prob._replace(w=torch.from_numpy(1.0 + rng.random((N + 1, B))), cb=cb,
                             Qdf=10.0 * prob.Qd)
    prob = prob._replace(Qd=prob.Qd[:, :1].contiguous())  # one weight row: B|1
    kw = examples.line_search_inputs(spec, prob, 12)
    kw["alphas"] = torch.cat([torch.tensor([1e160], dtype=F64), kw["alphas"][:-1]])
    kw["J"][1] = -1e3
    kw["done"][[2, 4]] = True
    return spec, prob, kw


@pytest.mark.parametrize("per_knot", [False, True], ids=["shared", "per_knot"])
def test_plain_line_search_matches_jax_on_hard_cases(per_knot):
    """The overflowing first alpha (every rollout Inf / NaN, never taken), a
    scenario with no alpha accepted (1), done scenarios (2, 4), per-knot w
    and cb with Qdf, and a weight row shared by the fleet."""
    spec, prob, kw = _hard_case(per_knot)
    got = _hold(spec, prob, kw, f"hard cases ({'per knot' if per_knot else 'shared'})")
    assert not bool(torch.isfinite(got[6][0]).any())
    assert bool(torch.isfinite(got[0]).all()) and bool(torch.isfinite(got[1]).all())
    assert not bool(got[4][1])
    for b in (1, 2, 4):
        assert torch.equal(got[0][..., b], kw["xs"][..., b])
        assert torch.equal(got[3][b], kw["J"][b])
    assert bool(got[4][[0, 3, 5, 6]].all())


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    spec, prob, kw = examples.line_search_case("standing", 5, F64, "cpu", 6, 12)
    before = k2.line_search.launches
    got = k2.line_search(spec, prob, **kw, with_costs=True)
    want = tfl.line_search(spec, prob, **kw, with_costs=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(k2.line_search(spec, prob, **kw)) == 6
    assert k2.line_search.launches == before, "the plain version counts no launch"
    meta = {k: v.to("meta") for k, v in kw.items()}
    with pytest.raises(ValueError, match="cpu or cuda"):
        k2.line_search(spec, prob, **meta)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    spec, prob, kw = examples.line_search_case("standing", 3, F64, "cpu", 6, 12)
    k2.check_inputs(spec, prob, **kw)  # the main path's problem is taken
    with pytest.raises(ValueError, match="state rows"):
        k2.check_inputs(spec, prob._replace(Cx=torch.zeros((24, 13, 3), dtype=F64)), **kw)
    with pytest.raises(ValueError, match="alphas"):
        k2.check_inputs(spec, prob, **{**kw, "alphas": torch.full((33,), 0.5, dtype=F64)})
    five = prob.params._replace(foot_pos=torch.zeros((5, 3, 3), dtype=F64))
    with pytest.raises(ValueError, match="feet"):
        k2.check_inputs(spec._replace(nu=15), prob._replace(params=five), **kw)
    with pytest.raises(ValueError, match="tagged"):
        k2.check_inputs(spec._replace(line_search=None), prob, **kw)
    with pytest.raises(ValueError, match="midpoint"):
        k2.check_inputs(spec._replace(integrator="euler"), prob, **kw)
    with pytest.raises(ValueError, match="Qd"):
        k2.check_inputs(spec, prob._replace(Qd=prob.Qd[:12]), **kw)
    with pytest.raises(ValueError, match="done"):
        k2.check_inputs(spec, prob, **{**kw, "done": kw["done"].to(F64)})


def test_each_spec_carries_its_models_tag_where_k2_has_an_instantiation():
    """The quaternion SRB's specs carry "quat_srb", the Euler SRB's (the
    convex fleet controller's, the single convex controller's and the convex
    fixture's under forward Euler) "euler_srb", falling_cat's "attitude";
    the classic models none, nor the quaternion SRB under forward Euler,
    which K2 has no instantiation for."""
    assert tq.FLEET_MODEL_SPEC.line_search == "quat_srb"
    assert tal.fleet_spec(tq.MODEL_SPEC).line_search == "quat_srb"
    for name in ("humanoid", "spider_dog"):
        spec = getattr(tsc, name)(dtype=F64, device="cpu")[0]
        assert tal.fleet_spec(spec).line_search == "quat_srb", name
    spec, _, _ = tsc.falling_cat(dtype=F64, device="cpu")
    fixture = examples.fixture_problem("convex", F64, "cpu")[0]
    tagged = {
        "euler_srb_midpoint": [tcv.FLEET_MODEL_SPEC, tal.fleet_spec(tcv.MODEL_SPEC)],
        "euler_srb_euler": [tal.fleet_spec(fixture)],
        "attitude_midpoint": [
            tal.fleet_spec(spec),
            tal.fleet_spec(ModelSpec(nx=7, nu=3, f=tattitude.attitude_dynamics, quat_idx=0)),
        ],
        "quat_srb_midpoint": [tq.FLEET_MODEL_SPEC],
    }
    for name, specs in tagged.items():
        for s in specs:
            assert k2.instantiation(s.line_search, s.integrator) == name, (name, s)
    untagged = [
        tal.fleet_spec(ModelSpec(nx=4, nu=2, f=tclassic.bicycle_dynamics, quat_idx=None)),
        # the quaternion SRB under forward Euler: K2 steps it by the midpoint rule only
        tal.fleet_spec(ModelSpec(nx=13, nu=12, f=tsrb.quat_srb_dynamics,
                                 fj=tsrb.quat_srb_jacobian, quat_idx=3, integrator="euler")),
        # the attitude model under forward Euler
        tal.fleet_spec(ModelSpec(nx=7, nu=3, f=tattitude.attitude_dynamics, quat_idx=0,
                                 integrator="euler")),
    ]
    assert all(s.line_search is None for s in untagged)


@pytest.mark.parametrize("problem", ["quat_srb", "convex", "convex_fixture", "falling_cat",
                                     "pendulum"])
def test_a_tagged_solve_calls_k2_once_an_iteration(monkeypatch, problem):
    """A solve of each tagged model calls K2's wrapper al x ilqr times (the
    quaternion fleet under both backward passes); the pendulum's, untagged,
    never."""
    calls = []

    def spy(*args, **kw):
        calls.append(1)
        return tfl.line_search(*args, **kw)

    monkeypatch.setattr(k2, "line_search", spy)
    batch = 3
    if problem == "quat_srb":
        opts = SolverOptions(al_iterations=2, ilqr_iterations=3, max_linesearch=8)
        prob = tq.build_fleet_problem(*examples.standing_batch(batch, 6, F64, "cpu"), 6)
        tfl.make_fleet_solver(tq.FLEET_MODEL_SPEC, opts, backend="sweep")(prob)
        assert len(calls) == 2 * 3
        calls.clear()
        tfl.make_fleet_solver(tq.FLEET_MODEL_SPEC, opts, backend="assoc")(prob)
        assert len(calls) == 2 * 3
    elif problem == "convex":
        opts = SolverOptions(al_iterations=1, ilqr_iterations=5, max_linesearch=8)
        fbk, cmd, wts = examples.standing_batch(batch, 6, F64, "cpu", controller="convex")
        prob = tcv.build_fleet_problem(fbk, cmd, wts, 6)
        tfl.make_fleet_solver(tcv.FLEET_MODEL_SPEC, opts, backend="sweep")(prob)
        assert len(calls) == 5
    elif problem == "convex_fixture":
        spec, prob = examples.fixture_problem("convex", F64, "cpu")[:2]
        opts = SolverOptions(al_iterations=2, ilqr_iterations=2)
        tal.make_solver(spec, opts)(prob)
        assert len(calls) == 2 * 2
    elif problem == "falling_cat":
        spec, prob, _ = examples.falling_cat_fleet(batch, F64, "cpu", N=6)
        opts = SolverOptions(al_iterations=2, ilqr_iterations=3)
        tal.make_solver(spec, opts)(prob)
        assert len(calls) == 2 * 3
    else:
        spec, prob = examples.classic_problem("pendulum", 6, F64, "cpu")
        tal.make_solver(spec, SolverOptions(al_iterations=1, ilqr_iterations=2))(prob)
        assert not calls


@pytest.mark.parametrize("name,batch,horizon,n_alphas",
                         [("standing", 16, 10, 8), ("humanoid", 7, 6, 12), ("convex", 16, 10, 8),
                          ("falling_cat", 13, 8, 12)])
def test_conditioned_sets_aside_the_runaway_rollouts_only(name, batch, horizon, n_alphas):
    """`kernels.line_search.conditioned` sets aside a cost exactly where the
    plain version's rollout (f64 or f32) leaves the unit sphere by more than
    RUNAWAY while finite, and a scenario exactly where the selected rollout
    does: nothing of the quaternion SRB's or the Euler SRB's problems, some
    of falling_cat's first iteration at its steep starts."""
    spec, prob, kw = examples.line_search_case(name, batch, F64, "cpu", horizon, n_alphas)
    costs, scenarios = k2.conditioned(spec, prob, kw)
    assert costs.shape == (n_alphas, batch) and scenarios.shape == (batch,)
    if spec.quat_idx is None or name != "falling_cat":
        assert bool(costs.all()) and bool(scenarios.all())
        return
    qi = spec.quat_idx
    xs, _ = tfl.rollout(spec, prob, kw["xs"], kw["us"], kw["Ks"], kw["ds"],
                        kw["alphas"][:, None, None])
    off = (torch.linalg.vector_norm(xs[:, :, qi:qi + 4, :], dim=2) - 1.0).abs()
    away = (torch.where(torch.isfinite(off), off, 0.0) > k2.RUNAWAY).any(1)
    assert bool(away.any()), "the steep starts' full step runs away"
    out = tfl.line_search(spec, prob, **kw, with_costs=True)
    # every finite runaway cost is set aside; and in f64 every cost set aside runs away
    assert not bool((away & torch.isfinite(out[6]) & costs).any())
    assert not bool((~costs & ~away).any())
    ok = tfl.armijo_ok(out[2], out[6], kw["dV1"], kw["dV2"], kw["alphas"])
    first = ok & (torch.cumsum(ok.to(torch.int32), 0) == 1)
    assert not bool(((away & first).any(0) & scenarios).any()), "a runaway selection held"


def _jax_open_loop(spec, prob):
    """The reference's open-loop rollout of us_init (its `init_step` scan)."""

    def init_step(x, u):
        return jfl._fleet_step(spec, x, u, prob.params, prob.h), x

    xN, xs = jax.lax.scan(init_step, prob.x0, prob.us_init)
    return jnp.concatenate([xs, xN[None]], axis=0)


def _jax_multipliers(prob, us, lam, rho):
    """The reference's multiplier update after an AL iteration (`cvals_k`)."""
    N = us.shape[0]

    def cvals_k(u_k, lam_k, cb_k):
        return jnp.maximum(0.0, lam_k + rho * (jfl.bmv(prob.Cu, u_k) + cb_k))

    return jax.vmap(cvals_k)(us, lam, jfl.cb_knots(prob.cb, N))


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got.numpy() - want).max() <= TOL * scale, what


@pytest.mark.parametrize(
    "name,batch,horizon",
    [("standing", 5, 10), ("fixture", 3, 20), ("humanoid", 4, 6), ("convex", 5, 10),
     ("convex_fixture", 3, 30), ("falling_cat", 4, 8),
     # the redesigned kernel's edges: one scenario at N = 1, N = 40 with nc = 6
     ("standing", 1, 1), ("falling_cat", 2, 40)],
)
def test_k9_plain_versions_match_jax(name, batch, horizon):
    """K9's rollout, its pricing (J under drawn multipliers, half of them
    zero, at ρ = 1; the final cost) and its multiplier update, through the
    wrapper on the CPU, against the reference's lines on the same inputs."""
    spec, prob, _ = examples.line_search_case(name, batch, F64, "cpu", horizon, 8)
    jspec, jprob = _jax_spec(spec), _jax_problem(prob)
    us = prob.us_init
    xs = k9.rollout(spec, prob, us)
    _close(xs, _jax_open_loop(jspec, jprob), f"{name}: the open-loop rollout")
    N, nc = us.shape[0], prob.Cu.shape[0]
    rng = np.random.default_rng(4)
    lam_np = 200.0 * rng.random((N, nc, batch)) * (rng.random((N, nc, batch)) < 0.5)
    lam, rho = torch.from_numpy(lam_np), torch.tensor(1.0, dtype=F64)
    J, bar = k9.price(spec, prob, xs, us, lam, rho, cost=True, lam_bar=True)
    jxs, jus, jlam = _j(xs), _j(us), jnp.asarray(lam_np)
    _close(J, _jax_total_cost(jspec, jxs, jus, jprob, jlam, jnp.asarray(1.0)), f"{name}: J")
    _close(bar, _jax_multipliers(jprob, jus, jlam, jnp.asarray(1.0)), f"{name}: λ̄")
    final, none = k9.price(spec, prob, xs, us, None, torch.tensor(1e-30, dtype=F64))
    assert none is None
    _close(final, _jax_total_cost(jspec, jxs, jus, jprob, jnp.zeros_like(jlam),
                                  jnp.asarray(1e-30)), f"{name}: the final cost")
    z = lam + rho * tfl.constraint_values(prob, xs, us)
    assert bool((z >= 0).any()) and bool((z < 0).any()), "some rows active, some not"


def test_k9_wrapper_runs_the_plain_versions_on_the_cpu_and_refuses_state_rows():
    spec, prob, _ = examples.line_search_case("standing", 3, F64, "cpu", 6, 8)
    before = (k9.rollout.launches, k9.price.launches)
    xs = k9.rollout(spec, prob, prob.us_init)
    assert torch.equal(xs, tfl.open_loop_rollout(spec, prob, prob.us_init))
    lam = torch.zeros((6, 24, 3), dtype=F64)
    rho = torch.tensor(1.0, dtype=F64)
    J, bar = k9.price(spec, prob, xs, prob.us_init, lam, rho)
    assert bar is None and torch.equal(J, tfl.total_cost(spec, xs, prob.us_init, prob, lam, rho))
    assert (k9.rollout.launches, k9.price.launches) == before, "the plain versions count none"
    with pytest.raises(ValueError, match="J, λ̄ or both"):
        k9.price(spec, prob, xs, prob.us_init, lam, rho, cost=False)
    with pytest.raises(ValueError, match="state rows"):
        k9.check_rollout(spec, prob._replace(Cx=torch.zeros((24, 13, 3), dtype=F64)),
                         prob.us_init)
    with pytest.raises(ValueError, match="tagged"):
        k9.check_price(spec._replace(line_search=None), prob, xs, prob.us_init, lam, rho)
    with pytest.raises(ValueError, match="us must be"):
        k9.check_rollout(spec, prob, prob.us_init[:, :9])
    meta = prob.us_init.to("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        k9.rollout(spec, prob, meta)


@pytest.mark.parametrize("problem", ["quat_srb", "convex_fixture", "falling_cat", "state_rows",
                                     "pendulum"])
def test_a_tagged_solve_calls_k9_once_a_rollout_and_al_plus_one_pricings(monkeypatch, problem):
    """A solve of a tagged model without state rows calls K9's rollout once
    and its pricing al + 1 times (al multiplier updates, then the final
    cost), each solve's outputs the plain path's; one with state rows Cx
    (the quaternion fleet's problem with rows of zeros) and the pendulum's
    (untagged) never."""
    calls = {"rollout": 0, "price": 0}

    def spy(entry, plain):
        def fn(*args, **kw):
            calls[entry] += 1
            return plain(*args, **kw)
        return fn

    monkeypatch.setattr(k9, "rollout", spy("rollout", k9.open_loop_rollout_ref))
    monkeypatch.setattr(k9, "price", spy("price", k9.price_ref))
    if problem == "quat_srb":
        opts = SolverOptions(al_iterations=2, ilqr_iterations=3, max_linesearch=8)
        prob = tq.build_fleet_problem(*examples.standing_batch(3, 6, F64, "cpu"), 6)
        sol = tfl.make_fleet_solver(tq.FLEET_MODEL_SPEC, opts, backend="sweep")(prob)
        plain = tfl.make_fleet_solver(tq.FLEET_MODEL_SPEC._replace(line_search=None), opts,
                                      backend="sweep")(prob)
        assert all(torch.equal(a, b) for a, b in zip((sol.xs, sol.us, sol.cost, sol.lam),
                                                      (plain.xs, plain.us, plain.cost, plain.lam)))
        want = (1, 3)
    elif problem == "convex_fixture":
        spec, prob = examples.fixture_problem("convex", F64, "cpu")[:2]
        tal.make_solver(spec, SolverOptions(al_iterations=2, ilqr_iterations=2))(prob)
        want = (1, 3)
    elif problem == "falling_cat":
        spec, prob, _ = examples.falling_cat_fleet(3, F64, "cpu", N=6)
        tal.make_solver(spec, SolverOptions(al_iterations=3, ilqr_iterations=1))(prob)
        want = (1, 4)
    elif problem == "state_rows":  # the quaternion fleet's problem with rows Cx·x
        opts = SolverOptions(al_iterations=2, ilqr_iterations=2, max_linesearch=8)
        prob = tq.build_fleet_problem(*examples.standing_batch(3, 6, F64, "cpu"), 6)
        prob = prob._replace(Cx=torch.zeros((24, 13, 3), dtype=F64))
        tfl.make_fleet_solver(tq.FLEET_MODEL_SPEC, opts, backend="sweep")(prob)
        want = (0, 0)
    else:
        spec, prob = examples.classic_problem("pendulum", 6, F64, "cpu")
        tal.make_solver(spec, SolverOptions(al_iterations=1, ilqr_iterations=2))(prob)
        want = (0, 0)
    assert (calls["rollout"], calls["price"]) == want
