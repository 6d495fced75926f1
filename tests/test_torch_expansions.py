"""K8's plain version and the ported block modules against the JAX reference,
and which specs and paths run K8.

The wrapper `kernels.expansions.knot_expansions` on the CPU runs its plain
version (`solver.fleet.knot_expansions` and `terminal_expansion`); it is
held at f64 to 1e-12 of each output's scale against the reference's
`knot_expansions` (a `jax.vmap` over the knots) and `terminal_expansion`,
on the same seeded inputs: the Go1 fleet controller's problem (four feet,
every leaf per scenario), the golden standing fixture lifted as `make_solver`
lifts it with a terminal weight Qdf and a per-knot geodesic weight w (the
reference's fleet functions take one w for the horizon, so that case is
composed from its `error_discrete_jac`, `cost_expansion` and
`terminal_expansion` knot by knot), the two-footed humanoid, and K8's other
models: the convex fleet controller's problem (the Euler SRB, midpoint rule,
the reference's `convex_mpc._fleet_spec()`), the golden convex fixture
(forward Euler, leaves shared along B) and a falling_cat fleet (the
attitude model with per-knot w and Qdf; the reference's spec built here as
a `jax.vmap` of its `attitude_dynamics`, differentiated by its own
`jax.jacfwd`). The multipliers are drawn so that some inequality rows are
active and some not.

`models.srb.quat_srb_edj_blocks` and `solver.fleet._structured_q_terms`
against the reference's at 1e-12, the blocks placed against the dense
`quat_srb_error_discrete_jac_fleet` and the generic E(x1)ᵀ·Ad·E(x) path, and
the Q-terms against the dense AᵀVxxA, BᵀVxxB and BᵀVxxA products (mirroring
the reference's tests/test_fleet_solver.py:67-109).

Then the tags: the quaternion SRB's specs with its structured Jacobian carry
"quat_srb", the Euler SRB's with `euler_srb_jacobian` "euler_srb" (midpoint
rule and forward Euler), the attitude model's differentiated under the
midpoint rule "attitude"; a spec of those models with another Jacobian or
an integrator K8 has no instantiation for, and the classic systems, none; a
problem with state rows Cx keeps the plain expansions; a tagged solve of
each model calls K8's wrapper once an iLQR iteration (the quaternion SRB's
under the sweep and the scan), an untagged one never; and the wrapper's own
checks on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quaternion_mpc_tpu.control import convex_mpc as jcv
from quaternion_mpc_tpu.control import quat_mpc as jq
from quaternion_mpc_tpu.models import attitude as jattitude
from quaternion_mpc_tpu.models import discretize as jdisc
from quaternion_mpc_tpu.models import srb as jsrb
from quaternion_mpc_tpu.solver import fleet as jfl
from quaternion_mpc_tpu_torch import examples
from quaternion_mpc_tpu_torch import scenarios as tsc
from quaternion_mpc_tpu_torch.control import convex_mpc as tcv
from quaternion_mpc_tpu_torch.control import quat_mpc as tq
from quaternion_mpc_tpu_torch.kernels import expansions as k8
from quaternion_mpc_tpu_torch.kernels import line_search as k2
from quaternion_mpc_tpu_torch.models import attitude as tattitude
from quaternion_mpc_tpu_torch.models import classic as tclassic
from quaternion_mpc_tpu_torch.models import srb as tsrb
from quaternion_mpc_tpu_torch.solver import al_ilqr as tal
from quaternion_mpc_tpu_torch.solver import fleet as tfl
from quaternion_mpc_tpu_torch.solver import parallel_riccati as tpr
from quaternion_mpc_tpu_torch.solver.problem import ModelSpec, SolverOptions

import quaternion_mpc_tpu_torch

# the port makes its tensors on the card unless told otherwise; these tests run on the CPU
quaternion_mpc_tpu_torch.set_default_device("cpu")

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-12
OUTPUTS = ("As", "Bs", "lxs", "lxxs", "lus", "luus", "lxN", "lxxN")


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


def _jax_attitude_jacobian(x, u, p):
    """Its continuous Jacobian (7, 10, B): `jax.vmap` of the reference's
    `autodiff_jacobian` (`jax.jacfwd`) of the single form."""
    inertia = jnp.broadcast_to(p.inertia, (3, 3, x.shape[-1]))
    fj = jdisc.autodiff_jacobian(jattitude.attitude_dynamics)
    one = lambda x1, u1, i1: fj(x1, u1, jattitude.AttitudeParams(i1))
    return jax.vmap(one, in_axes=(-1, -1, -1), out_axes=-1)(x, u, inertia)


def _jax_spec(spec):
    """The reference's fleet spec of the port's: the quaternion SRB's with
    its structured Jacobian, the Euler SRB's with its approximate Jacobian
    (`convex_mpc._fleet_spec()` under the midpoint rule), the attitude
    model's differentiated by `jax.jacfwd`."""
    if spec.expansions == "euler_srb":
        if spec.integrator == "midpoint":
            return jcv._fleet_spec()
        return jfl.FleetModelSpec(nx=12, nu=spec.nu, f=jsrb.euler_srb_dynamics_fleet,
                                  fj=jsrb.euler_srb_jacobian_fleet, quat_idx=None,
                                  integrator=spec.integrator)
    if spec.expansions == "attitude":
        return jfl.FleetModelSpec(nx=7, nu=3, f=_jax_attitude_fleet, fj=_jax_attitude_jacobian,
                                  quat_idx=0, integrator=spec.integrator)
    if spec.nu == 12:
        return jq._fleet_spec()
    return jfl.FleetModelSpec(nx=13, nu=spec.nu, f=jsrb.quat_srb_dynamics_fleet,
                              fj=jsrb.quat_srb_jacobian_fleet, quat_idx=3,
                              edj=jsrb.quat_srb_error_discrete_jac_fleet)


def _jax_expansions(spec, prob, xs, us, lam, rho):
    """The reference's knot expansions and terminal expansion on these
    inputs; with a per-knot w (N+1, B|1) composed knot by knot from its
    `error_discrete_jac` and `cost_expansion`, each knot's w in place of the
    problem's."""
    spec, jprob = _jax_spec(spec), _jax_problem(prob)
    xs, us, lam = _j(xs), _j(us), _j(lam)
    if jprob.w.ndim == 1:
        knots = jax.jit(jfl.knot_expansions, static_argnums=0)(spec, jprob, xs, us, lam, rho)
        return (*knots, *jfl.terminal_expansion(spec, xs[-1], jprob))
    N = us.shape[0]
    cb = jfl.cb_knots(jprob.cb, N)
    per_knot = []
    for k in range(N):
        pk = jprob._replace(w=jprob.w[k])
        A, B_ = jfl.error_discrete_jac(spec, xs[k], xs[k + 1], us[k], pk)
        per_knot.append((A, B_, *jfl.cost_expansion(spec, xs[k], us[k], jprob.x_ref[k],
                                                     jprob.u_ref[k], lam[k], rho, pk, cb[k])))
    stacked = [jnp.stack(parts) for parts in zip(*per_knot)]
    return (*stacked, *jfl.terminal_expansion(spec, xs[-1], jprob._replace(w=jprob.w[N])))


def _multipliers(prob, N, seed):
    """λ >= 0 drawn so that some rows are active and some not: half of them
    zero, the rest up to 200."""
    nc, B = prob.cb.shape[-2], prob.x0.shape[-1]
    rng = np.random.default_rng(seed)
    lam = 200.0 * rng.random((N, nc, B)) * (rng.random((N, nc, B)) < 0.5)
    return torch.from_numpy(lam)


def _fixture_qdf_per_knot_w(batch):
    """The golden standing fixture as `make_solver` lifts it: a fleet of
    ``batch`` with per-scenario us_init, a terminal weight Qdf and a per-knot
    geodesic weight w (N+1, B)."""
    spec, prob = examples.fixture_problem("quat", F64, "cpu")[:2]
    prob = tal.broadcast_problem(prob, batch)
    N = prob.us_init.shape[-2]
    rng = np.random.default_rng(5)
    cost = prob.cost._replace(Qdf=10.0 * prob.cost.Qd,
                              w=torch.from_numpy(1.0 + rng.random((batch, N + 1))))
    noise = torch.from_numpy(2.0 * rng.standard_normal(tuple(prob.us_init.shape)))
    prob = prob._replace(cost=cost, us_init=prob.us_init + noise)
    return tal.fleet_spec(spec), tal.lift_problem(prob)


def _case(name, batch=5, horizon=10):
    """(spec, prob, xs, us, lam, rho) of a first iteration's expansions."""
    if name == "fixture_qdf_w":
        spec, prob = _fixture_qdf_per_knot_w(batch)
    else:
        spec, prob, _ = examples.line_search_case(name, batch, F64, "cpu", horizon, 8)
    us = prob.us_init
    xs = tfl.open_loop_rollout(spec, prob, us)
    return spec, prob, xs, us, _multipliers(prob, us.shape[0], 3), torch.tensor(1.0, dtype=F64)


def _assert_near(got, want, what, tol=TOL):
    for name, g, w in zip(OUTPUTS, got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-300)
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, f"{what} {name}: {err:.3g} of scale {scale:.3g}"


# K8's model of each case
_TAGS = {"standing": "quat_srb", "fixture_qdf_w": "quat_srb", "humanoid": "quat_srb",
         "convex": "euler_srb", "convex_fixture": "euler_srb", "falling_cat": "attitude"}


@pytest.mark.parametrize("name", ["standing", "fixture_qdf_w", "humanoid", "convex",
                                  "convex_fixture", "falling_cat"])
def test_plain_expansions_match_jax(name):
    spec, prob, xs, us, lam, rho = _case(name)
    assert spec.expansions == _TAGS[name]
    got = k8.knot_expansions(spec, prob, xs, us, lam, rho)
    want = _jax_expansions(spec, prob, xs, us, lam, float(rho))
    _assert_near(got, want, name)
    # the multipliers leave some rows active and some not
    z = lam + rho * tfl.constraint_values(prob, xs, us)
    assert bool((z >= 0).any()) and bool((z < 0).any())


def test_plain_expansions_hold_ties_and_shared_leaves():
    """A row whose λ + ρc is exactly 0 is active (a foot with no force, its
    multiplier 0, its −fz row at 0 with cb 0); leaves shared along B (the
    golden fixture's references, weights and parameters, batch extent 1)."""
    spec, prob, _ = examples.line_search_case("fixture", 4, F64, "cpu", 20, 8)
    us = prob.us_init.clone()
    us[:, 0:3, 1] = 0.0  # scenario 1: foot 0 carries nothing
    xs = tfl.open_loop_rollout(spec, prob, us)
    lam = torch.zeros((20, prob.cb.shape[-2], 4), dtype=F64)
    rho = torch.tensor(1.0, dtype=F64)
    got = k8.knot_expansions(spec, prob, xs, us, lam, rho)
    _assert_near(got, _jax_expansions(spec, prob, xs, us, lam, 1.0), "ties")
    # foot 0's rows at 0 (the four pyramid rows and −fz) are active, fz − fz_max
    # not: luu's fz entry is Rd + 4·μ² + 1
    assert float(got[5][0, 2, 2, 1]) == pytest.approx(1e-6 + 4 * 0.6**2 + 1.0, rel=1e-12)


def test_edj_blocks_match_jax_and_the_dense_jacobian():
    """`quat_srb_edj_blocks` against the reference's, and placed (the
    SrbEdjBlocks docstring) against the port's dense
    `quat_srb_error_discrete_jac_fleet` and the generic E(x1)ᵀ·Ad·E(x)."""
    from quaternion_mpc_tpu_torch.models import discretize as tdisc

    spec, prob, xs, us, _, _ = _case("standing", batch=16)
    x, x1, u = xs[:3], xs[1:4], us[:3]
    blk = tsrb.quat_srb_edj_blocks(x, x1, u, prob.params, prob.h)
    jprob = _jax_problem(prob)
    for k in range(3):
        jblk = jsrb.quat_srb_edj_blocks(_j(x[k]), _j(x1[k]), _j(u[k]), jprob.params, jprob.h)
        for field in ("A_phi", "A_pw", "B_phi"):
            np.testing.assert_allclose(getattr(blk, field)[k].numpy(),
                                       np.asarray(getattr(jblk, field)), rtol=0, atol=TOL)
        for field in ("Bw", "inv_m", "h", "s_p", "s_v", "s_w"):
            want = np.broadcast_to(np.asarray(getattr(jblk, field)), getattr(blk, field).shape)
            np.testing.assert_allclose(getattr(blk, field).numpy(), want, rtol=0, atol=TOL)
    Ae, Be = tsrb.quat_srb_error_discrete_jac_fleet(x, x1, u, prob.params, prob.h)
    placed_A = torch.zeros_like(Ae)
    placed_B = torch.zeros_like(Be)
    eye = torch.eye(3, dtype=F64)[..., None]
    for r in (0, 6, 9):
        placed_A[:, r:r + 3, r:r + 3] = eye
    placed_A[:, 0:3, 6:9] = blk.h * eye
    placed_A[:, 3:6, 3:6] = blk.A_phi
    placed_A[:, 3:6, 9:12] = blk.A_pw
    Bv = (eye * blk.inv_m).repeat(1, 4, 1)
    placed_B[:, 0:3] = blk.s_p * Bv
    placed_B[:, 3:6] = blk.B_phi
    placed_B[:, 6:9] = blk.s_v * Bv
    placed_B[:, 9:12] = blk.s_w * blk.Bw
    assert torch.equal(placed_A, Ae) and torch.equal(placed_B, Be)
    fspec = spec._replace(edj=None)  # the generic dense path
    Ad, Bd = tdisc.fleet_discrete_jac(fspec, x, u, prob.params, prob.h)
    E0, E1 = tdisc.error_projection_bl(x, 3, 12), tdisc.error_projection_bl(x1, 3, 12)
    np.testing.assert_allclose(Ae.numpy(), tfl.bmm(tfl.bt(E1), tfl.bmm(Ad, E0)).numpy(), atol=1e-14)
    np.testing.assert_allclose(Be.numpy(), tfl.bmm(tfl.bt(E1), Bd).numpy(), atol=1e-14)


@pytest.mark.parametrize("name", ["standing", "humanoid"])
def test_structured_q_terms_match_jax_and_the_dense_products(name):
    """`_structured_q_terms` against the reference's on the same blocks,
    value function and cost expansion, and against the dense products with
    the placed Ae and Be: Qx = lx + AᵀVx, Qu = lu + BᵀVx, Qxx = lxx +
    AᵀVxxA, Quu = luu + BᵀVxxB, Qux = BᵀVxxA."""
    spec, prob, xs, us, lam, rho = _case(name, batch=6)
    B = xs.shape[-1]
    x, x1, u = xs[0], xs[1], us[0]
    rng = np.random.default_rng(3)
    M = rng.standard_normal((B, 12, 12))
    Vxx = torch.from_numpy(np.einsum("bij,bkj->bik", M, M)).movedim(0, -1).contiguous()
    Vx = torch.from_numpy(rng.standard_normal((B, 12))).movedim(0, -1).contiguous()
    As, Bs, lxs, lxxs, lus, luus, _, _ = k8.knot_expansions(spec, prob, xs, us, lam, rho)
    lx, lxx, lu, luu = lxs[0], lxxs[0], lus[0], luus[0]
    blk = tsrb.quat_srb_edj_blocks(x, x1, u, prob.params, prob.h)
    got = tfl._structured_q_terms(blk, Vx, Vxx, lx, lxx, lu, luu)
    jprob = _jax_problem(prob)
    jblk = jsrb.quat_srb_edj_blocks(_j(x), _j(x1), _j(u), jprob.params, jprob.h)
    want = jfl._structured_q_terms(jblk, *(_j(t) for t in (Vx, Vxx, lx, lxx, lu, luu)))
    A, B_ = As[0], Bs[0]
    AtV, BtV = tfl.bmm(tfl.bt(A), Vxx), tfl.bmm(tfl.bt(B_), Vxx)
    dense = (lx + tfl.bmv(tfl.bt(A), Vx), lu + tfl.bmv(tfl.bt(B_), Vx), lxx + tfl.bmm(AtV, A),
             luu + tfl.bmm(BtV, B_), tfl.bmm(BtV, A))
    for term, g, w, d in zip(("Qx", "Qu", "Qxx", "Quu", "Qux"), got, want, dense):
        scale = float(d.abs().max())
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= TOL * scale, term
        assert float((g - d).abs().max()) <= TOL * scale, term


def test_specs_carry_the_expansions_tag():
    """Each spec carries its model's tag where K8 has an instantiation for
    its integrator and the spec asks for the Jacobian K8 computes: the
    quaternion SRB's specs that keep its structured Jacobian "quat_srb" (the
    fleet controller's, and `fleet_spec` of its ModelSpec under the midpoint
    rule: the make_solver fixtures, humanoid, spider_dog); the Euler SRB's
    with `euler_srb_jacobian` "euler_srb" (the convex fleet controller's, the
    single convex controller's, the convex fixture's under forward Euler);
    the attitude model's, differentiated, under the midpoint rule
    "attitude" (falling_cat). None: the quaternion SRB under forward Euler,
    or without fj (no structured Jacobian); the Euler SRB differentiated (no
    fj) or with another fj; the attitude model with an fj of its own, or
    under forward Euler; the classic systems."""
    assert tq.FLEET_MODEL_SPEC.expansions == "quat_srb"
    assert tcv.FLEET_MODEL_SPEC.expansions == "euler_srb"
    assert tal.fleet_spec(tcv.MODEL_SPEC).expansions == "euler_srb"
    quat = dict(f=tsrb.quat_srb_dynamics, fj=tsrb.quat_srb_jacobian, quat_idx=3)
    assert tal.fleet_spec(ModelSpec(nx=13, nu=12, **quat)).expansions == "quat_srb"
    assert tal.fleet_spec(ModelSpec(nx=13, nu=12, **quat, integrator="euler")).expansions is None
    assert tal.fleet_spec(ModelSpec(nx=13, nu=12, f=tsrb.quat_srb_dynamics,
                                    quat_idx=3)).expansions is None
    for name in ("humanoid", "spider_dog", "falling_cat"):
        spec = tal.fleet_spec(tsc.SCENARIOS[name](N=4, dtype=F64, device="cpu")[0])
        assert spec.expansions == ("attitude" if name == "falling_cat" else "quat_srb"), name
    for name in ("quat", "trot", "convex"):
        spec = tal.fleet_spec(examples.fixture_problem(name, F64, "cpu")[0])
        assert spec.expansions == ("euler_srb" if name == "convex" else "quat_srb"), name
        if name == "convex":
            assert k8.instantiation(spec.expansions, spec.integrator) == "euler_srb_euler"
    euler = dict(nx=12, nu=12, f=tsrb.euler_srb_dynamics, quat_idx=None)
    assert tal.fleet_spec(ModelSpec(**euler)).expansions is None  # differentiated
    assert tal.fleet_spec(ModelSpec(**euler, fj=tsrb.quat_srb_jacobian)).expansions is None
    attitude = dict(nx=7, nu=3, f=tattitude.attitude_dynamics, quat_idx=0)
    assert tal.fleet_spec(ModelSpec(**attitude)).expansions == "attitude"
    own_fj = tal.fleet_spec(ModelSpec(**attitude, fj=tattitude.attitude_dynamics))
    assert own_fj.expansions is None and own_fj.line_search == "attitude"
    assert tal.fleet_spec(ModelSpec(**attitude, integrator="euler")).expansions is None
    bicycle = ModelSpec(nx=4, nu=2, f=tclassic.bicycle_dynamics)
    assert tal.fleet_spec(bicycle).expansions is None


def _spy(monkeypatch):
    calls = []
    real = k8.knot_expansions

    def spy(*args):
        calls.append(args[2].shape)
        return real(*args)

    monkeypatch.setattr(k8, "knot_expansions", spy)
    return calls


def test_state_rows_keep_the_plain_expansions(monkeypatch):
    """A tagged spec on a problem with state rows Cx: the expansions are the
    plain ones with the cross term lux (K8 writes none), and K8's own checks
    refuse the problem."""
    spec, prob, xs, us, lam, rho = _case("standing", batch=3, horizon=4)
    calls = _spy(monkeypatch)
    nc = prob.cb.shape[-2]
    Cx = torch.zeros((nc, 13, 3), dtype=F64)
    Cx[:, 2] = 0.1  # a height row in every inequality
    rows = prob._replace(Cx=Cx)
    lam1 = torch.cat([lam, lam[-1:]])
    out = tfl.backward_expansions(spec, rows, xs, us, lam1, rho)
    assert calls == [] and out[6] is not None and out[6].shape == (4, 12, 12, 3)
    want = tfl.knot_expansions_with_cross(spec, rows, xs, us, lam1, rho)
    for g, w in zip(out[:7], want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="state rows Cx"):
        k8.check_inputs(spec, rows, xs, us, lam1, rho)
    tfl.backward_expansions(spec, prob, xs, us, lam, rho)
    assert len(calls) == 1


@pytest.mark.parametrize("backend", ["sweep", "assoc"])
def test_tagged_solves_call_k8_once_an_iteration(monkeypatch, backend):
    """The fleet controller's spec under the sweep and the scan: K8's
    wrapper al x ilqr times a solve; with the tag taken off, never; the
    golden quat fixture through make_solver at 2 x 3: 6 times."""
    spec, prob, _ = examples.line_search_case("standing", 2 if backend == "sweep" else 1, F64,
                                              "cpu", 6, 8)
    calls = _spy(monkeypatch)
    tfl.make_fleet_solver(spec, SolverOptions(2, 3), backend)(prob)
    assert len(calls) == 6
    calls.clear()
    tfl.make_fleet_solver(spec._replace(expansions=None), SolverOptions(2, 3), backend)(prob)
    assert calls == []
    if backend == "sweep":
        fspec, fprob = examples.fixture_problem("quat", F64, "cpu")[:2]
        tal.make_solver(fspec, SolverOptions(2, 3))(fprob)
        assert len(calls) == 6


@pytest.mark.parametrize("problem", ["convex", "convex_fixture", "falling_cat", "pendulum"])
def test_each_models_solve_calls_k8_once_an_iteration(monkeypatch, problem):
    """A solve of each of K8's other models calls its wrapper al x ilqr
    times, and on the CPU gives the plain expansions: the convex fleet
    controller's 1 x 5 (the Euler SRB, midpoint rule), the golden convex
    fixture through `make_solver` (forward Euler), a falling_cat fleet
    through `make_solver` (the attitude model); the pendulum's, untagged,
    never."""
    calls = _spy(monkeypatch)
    batch = 3
    if problem == "convex":
        opts = SolverOptions(al_iterations=1, ilqr_iterations=5, max_linesearch=8)
        fbk, cmd, wts = examples.standing_batch(batch, 6, F64, "cpu", controller="convex")
        prob = tcv.build_fleet_problem(fbk, cmd, wts, 6)
        tfl.make_fleet_solver(tcv.FLEET_MODEL_SPEC, opts, backend="sweep")(prob)
        assert len(calls) == 5
    elif problem == "convex_fixture":
        spec, prob = examples.fixture_problem("convex", F64, "cpu")[:2]
        tal.make_solver(spec, SolverOptions(al_iterations=2, ilqr_iterations=2))(prob)
        assert len(calls) == 2 * 2
    elif problem == "falling_cat":
        spec, prob, _ = examples.falling_cat_fleet(batch, F64, "cpu", N=6)
        tal.make_solver(spec, SolverOptions(al_iterations=2, ilqr_iterations=3))(prob)
        assert len(calls) == 2 * 3
    else:
        spec, prob = examples.classic_problem("pendulum", 6, F64, "cpu")
        tal.make_solver(spec, SolverOptions(al_iterations=1, ilqr_iterations=2))(prob)
        assert not calls


@pytest.mark.parametrize("name", ["convex", "convex_fixture", "falling_cat"])
def test_wrapper_checks_each_models_inputs(name):
    """K8's table and launch sizes for the Euler SRB (12 states, the feet,
    inertia and mass, no quaternion) and the attitude model (7 states, 3
    torques as one group, its inertia alone): the parameters a model has
    not are absent, the instantiation rides in the flags; a spec of the
    model with other sizes, and the attitude model with more torques, are
    refused."""
    spec, prob, xs, us, lam, rho = _case(name, batch=3, horizon=4)
    table, (N, B, n_feet, nc, flags) = k8.check_inputs(spec, prob, xs, us, lam, rho)
    want = {"convex": "euler_srb_midpoint", "convex_fixture": "euler_srb_euler",
            "falling_cat": "attitude_midpoint"}[name]
    assert k8.INSTANTIATIONS[flags >> 8] == want and (N, B) == (us.shape[0], 3)
    absent = [i for i, (t, _) in enumerate(table) if t is None]
    if name == "falling_cat":
        assert (n_feet, nc) == (1, 6) and absent == [11, 13, 14, 15, 16]
        outs = k8.new_outputs((N, B, n_feet, nc, flags), xs)
        assert [tuple(t.shape) for t in outs[:2]] == [(N, 6, 6, 3), (N, 6, 3, 3)]
        with pytest.raises(ValueError, match="three torques"):
            k8.check_inputs(spec._replace(nu=4), prob, xs, us, lam, rho)
    else:
        assert (n_feet, nc) == (4, 24) and absent == [14, 15, 16]
    with pytest.raises(ValueError, match=f"runs '{spec.expansions}' with nx"):
        k8.check_inputs(spec._replace(nx=spec.nx + 1), prob, xs, us, lam, rho)
    assert k8.work(spec, prob, xs, us, lam, rho)["flops"] == B * (
        N * k8.flops_per_knot(want, n_feet, nc) + k8.STATE_FLOPS[spec.expansions])


def test_wrapper_checks_its_inputs():
    """What the kernel does not take raises before any launch: another tag
    or model, more than four feet, more than MAX_ROWS rows, a leaf of
    another shape or type; an operand of batch extent 1 is taken."""
    spec, prob, xs, us, lam, rho = _case("standing", batch=3, horizon=4)
    table, dims = k8.check_inputs(spec, prob, xs, us, lam, rho)
    assert len(table) == k8.INPUTS and dims == (4, 3, 4, 24, 0)
    with pytest.raises(ValueError, match="runs the specs tagged"):
        k8.check_inputs(spec._replace(expansions="bicycle"), prob, xs, us, lam, rho)
    with pytest.raises(ValueError, match="runs 'euler_srb' with nx 12"):
        k8.check_inputs(spec._replace(expansions="euler_srb"), prob, xs, us, lam, rho)
    with pytest.raises(ValueError, match="no instantiation for 'quat_srb' under the 'euler'"):
        k8.check_inputs(spec._replace(integrator="euler"), prob, xs, us, lam, rho)
    with pytest.raises(ValueError, match="float32 or float64"):
        k8.check_inputs(spec, prob, xs.half(), us, lam, rho)
    with pytest.raises(ValueError, match="x_ref must have shape"):
        k8.check_inputs(spec, prob._replace(x_ref=prob.x_ref[:-1]), xs, us, lam, rho)
    with pytest.raises(ValueError, match="Qd is torch.float32"):
        k8.check_inputs(spec, prob._replace(Qd=prob.Qd.float()), xs, us, lam, rho)
    big = prob._replace(Cu=prob.Cu.repeat(3, 1, 1), cb=prob.cb.repeat(3, 1))
    with pytest.raises(ValueError, match="at most 64"):
        k8.check_inputs(spec, big, xs, us, lam.repeat(1, 3, 1), rho)
    shared = prob._replace(x_ref=prob.x_ref[..., :1], Qd=prob.Qd[..., :1].contiguous())
    table, _ = k8.check_inputs(spec, shared, xs, us, lam, rho)
    assert [ld for _, ld in table[2:5]] == [1, 3, 1]
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        k8.knot_expansions(spec, prob, xs.to("meta"), us, lam, rho)


def test_input_table_reads_the_parameters_in_place():
    """The batch-first model parameters (`params_to_fleet`'s movedim: the
    fleet controller's feet and rotation) enter K8's input table as the
    parameters' own storage, read through a row stride of 1 and a batch
    stride of their row count, with no copy; batch-last leaves keep row
    stride B and batch stride 1, a leaf broadcast along B is cut to one
    column of batch stride 0, and a leaf whose leading axes do not step
    evenly through memory is copied."""
    spec, prob, xs, us, lam, rho = _case("standing", batch=5, horizon=4)
    p = prob.params
    table, _ = k8.check_inputs(spec, prob, xs, us, lam, rho)
    inputs = dict(zip(("xs", "us", "x_ref", "u_ref", "Qd", "Qdf", "Rd", "w", "Cu", "cb", "lam",
                       "foot_pos", "inertia", "mass", "com_offset", "com_mass",
                       "rot_body_to_world", "h", "rho"), table))
    for field, rows in (("foot_pos", 12), ("rot_body_to_world", 9)):
        given = getattr(p, field)
        assert not given.is_contiguous()
        t, extent = inputs[field]
        assert t.data_ptr() == given.data_ptr() and extent == 5, field
        assert k2.strides(t) == (1, rows), field
    assert k2.strides(inputs["xs"][0]) == (5, 1) and inputs["xs"][0].data_ptr() == xs.data_ptr()
    t, extent = inputs["inertia"]  # broadcast along B with stride 0
    assert extent == 1 and k2.strides(t) == (1, 0) and t.data_ptr() == p.inertia.data_ptr()
    _, strides, _ = k8.c_tables(table, k8.new_outputs(k8.check_inputs(
        spec, prob, xs, us, lam, rho)[1], xs))
    assert list(strides)[2 * 11:2 * 11 + 2] == [1, 12] and list(strides)[:2] == [5, 1]
    wide = torch.zeros((prob.x_ref.shape[0], 14, 5), dtype=prob.x_ref.dtype)
    wide[:, :13] = prob.x_ref
    table, _ = k8.check_inputs(spec, prob._replace(x_ref=wide[:, :13]), xs, us, lam, rho)
    assert table[2][0].is_contiguous() and table[2][0].data_ptr() != wide.data_ptr()
    assert torch.equal(table[2][0], prob.x_ref)
