"""Parity of the PyTorch port's fleet solver with the JAX reference.

K1's plain version against the TPU kernel itself (Pallas, interpret mode),
the backward pass against `fleet.riccati_backward`, the full fixture solve
against `make_fleet_solver` and the golden trajectories, the f32 guard, and
the torch-specific pieces: line-search selection, CPU dispatch of the kernel
wrapper and its input checks; the backend choice against the reference's
default, and the generic dense error-state Jacobian path."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quaternion_mpc_tpu import examples as jex
from quaternion_mpc_tpu.control import quat_mpc as jq
from quaternion_mpc_tpu.solver import SolverOptions as JaxSolverOptions
from quaternion_mpc_tpu.solver import fleet as jfl
from quaternion_mpc_tpu_torch import _bridge
from quaternion_mpc_tpu_torch import examples as tex
from quaternion_mpc_tpu_torch.control import quat_mpc as tq
from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs
from quaternion_mpc_tpu_torch.solver import fleet as tfl
from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

import quaternion_mpc_tpu_torch

# the port makes its tensors on the card unless told otherwise; these tests run on the CPU
quaternion_mpc_tpu_torch.set_default_device("cpu")

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 10
SWEEP_OUTPUTS = ("Ks", "ds", "dV1", "dV2", "gmax")


def _jax_rollout(prob, us):
    spec = jq._fleet_spec()
    x = prob.x0
    xs = [x]
    for k in range(us.shape[0]):
        x = jfl._fleet_step(spec, x, us[k], prob.params, prob.h)
        xs.append(x)
    return jnp.stack(xs)


def _jax_fleet_problem(batch, dtype):
    fbk, cmd, wts = jex.standing_batch(batch, N, dtype)
    return jax.jit(jq.build_fleet_problem, static_argnums=3)(
        jax.tree.map(jnp.asarray, fbk), jax.tree.map(jnp.asarray, cmd), wts, N
    )


def _to_torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# K1: plain sweep vs the TPU kernel, backward pass vs the reference
# ---------------------------------------------------------------------------


# Sweep outputs in f32 against the plain sweep in f64 on the same
# expansions, relative to each output's largest magnitude: 1e-3 for the gains
# Ks and ds, 1e-4 for dV1, dV2 and max|Qu|. Quu carries Rd = 1e-6 on unloaded
# input directions, so its condition number amplifies f32 rounding: on the
# main path's expansions the f32 gains sit up to 2.5e-4 of scale from f64,
# the other outputs below 1e-6. The f64 plain sweep is held to the reference
# at 1e-9 by test_riccati_backward_matches_jax.
F32_SWEEP_RTOL = dict(Ks=1e-3, ds=1e-3, dV1=1e-4, dV2=1e-4, gmax=1e-4)


def _assert_sweep_near_f64(got, want64, what):
    for name, g, w in zip(SWEEP_OUTPUTS, got, want64):
        g, w = np.asarray(g, np.float64), w.numpy()
        assert g.shape == w.shape, (what, name)
        np.testing.assert_allclose(
            g, w, rtol=0, atol=F32_SWEEP_RTOL[name] * np.abs(w).max(),
            err_msg=f"{what} {name}",
        )


def test_sweep_ref_matches_pallas_kernel():
    """riccati_sweep_ref and experiments/pallas_fleet.py's
    riccati_sweep_pallas (interpret mode), both in f32 on the main path's
    expansions at N=10, B=128, each against riccati_sweep_ref in f64 on the
    same expansions (F32_SWEEP_RTOL)."""
    spec_ = importlib.util.spec_from_file_location(
        "pallas_fleet", REPO / "experiments" / "pallas_fleet.py"
    )
    pallas_fleet = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(pallas_fleet)

    B = 128
    prob = _jax_fleet_problem(B, jnp.float32)
    spec = jq._fleet_spec()
    xs = _jax_rollout(prob, prob.us_init)
    lam = jnp.zeros((N, prob.cb.shape[-2], B), jnp.float32)
    exps = jax.jit(jfl.knot_expansions, static_argnums=0)(
        spec, prob, xs, prob.us_init, lam, jnp.float32(1.0)
    )
    lxN, lxxN = jax.jit(jfl.terminal_expansion, static_argnums=0)(spec, xs[-1], prob)
    reg = jnp.full((B,), 1e-8, jnp.float32)
    args = (*exps, lxN, lxxN, reg)

    pallas = pallas_fleet.riccati_sweep_pallas(*args, interpret=True)
    targs = [t.contiguous() for t in _to_torch(*args)]
    plain = rs.riccati_sweep_ref(*targs)
    assert all(g.dtype == torch.float32 for g in plain)
    want64 = rs.riccati_sweep_ref(*(t.double() for t in targs))
    _assert_sweep_near_f64(pallas, want64, "pallas")
    _assert_sweep_near_f64(plain, want64, "plain f32")



def _numpy_expansions(ne, nu, horizon, batch, seed):
    """Well-posed f32 sweep inputs at (ne, nu) from a numpy seed: contracting
    As, SPD lxx, luu and lxxN, reg 1e-6."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s)

    def spd(n, *lead):
        m = r(*lead, n, n, batch)
        return np.einsum("...ikb,...jkb->...ijb", m, m) + 0.5 * np.eye(n)[..., None]

    out = (0.3 * r(horizon, ne, ne, batch) + np.eye(ne)[..., None], 0.2 * r(horizon, ne, nu, batch),
           r(horizon, ne, batch), spd(ne, horizon), r(horizon, nu, batch), spd(nu, horizon),
           r(ne, batch), spd(ne), np.full((batch,), 1e-6))
    return [a.astype(np.float32) for a in out]


# the shapes K1's instantiations below 12 x 12 serve: falling_cat, the
# humanoid, the bicycle and the double integrator
@pytest.mark.parametrize("ne, nu", [(6, 3), (12, 6), (4, 2)])
def test_sweep_ref_matches_pallas_kernel_at_its_own_size(ne, nu):
    """riccati_sweep_ref at the problem's (ne, nu) and the TPU kernel itself
    (riccati_sweep_pallas, interpret mode) on the same f32 inputs (a numpy
    seed) at N=6 and a B the Pallas kernel takes (128), each against
    riccati_sweep_ref in f64 at (ne, nu) (F32_SWEEP_RTOL). The TPU kernel
    symmetrises Vxx through an nu x nu identity broadcast to ne x ne
    (experiments/pallas_fleet.py:146), so it takes ne == nu only: it gets the
    problem with nu raised to ne by `embed` (zero columns of Bs, the identity
    on luus's added diagonal), and its live block of Ks and ds is compared."""
    spec_ = importlib.util.spec_from_file_location(
        "pallas_fleet", REPO / "experiments" / "pallas_fleet.py"
    )
    pallas_fleet = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(pallas_fleet)

    B, horizon = 128, 6
    targs = [torch.from_numpy(a).contiguous()
             for a in _numpy_expansions(ne, nu, horizon, B, seed=ne * 16 + nu)]
    square = rs.embed(*targs, size=(ne, ne))
    pallas = pallas_fleet.riccati_sweep_pallas(*(jnp.asarray(t.numpy()) for t in square),
                                               interpret=True)
    assert pallas is not None and pallas[0].shape == (horizon, ne, ne, B)
    Ks, ds = np.asarray(pallas[0]), np.asarray(pallas[1])
    assert not Ks[:, nu:].any() and not ds[:, nu:].any()
    pallas = (Ks[:, :nu], ds[:, :nu], *pallas[2:])
    plain = rs.riccati_sweep_ref(*targs)
    want64 = rs.riccati_sweep_ref(*(t.double() for t in targs))
    _assert_sweep_near_f64(pallas, want64, f"pallas {ne}x{nu}")
    _assert_sweep_near_f64(plain, want64, f"plain f32 {ne}x{nu}")

def test_sweep_f32_spread_from_f64():
    """The f32 plain sweep against the f64 sweep on the port's own
    expansions of standing_batch at a ragged B=1000 (F32_SWEEP_RTOL; the
    bound the on-card check holds the kernel to)."""
    B = 1000
    spec = tq._fleet_spec()
    prob = tq.build_fleet_problem(*tex.standing_batch(B, N, torch.float32, "cpu"), N)
    xs = tfl.open_loop_rollout(spec, prob, prob.us_init)
    lam = torch.zeros((N, prob.cb.shape[-2], B))
    exps = tfl.knot_expansions(spec, prob, xs, prob.us_init, lam, torch.tensor(1.0))
    lxN, lxxN = tfl.terminal_expansion(spec, xs[-1], prob)
    args = [t.contiguous() for t in (*exps, lxN, lxxN, torch.full((B,), 1e-8))]
    want64 = rs.riccati_sweep_ref(*(t.double() for t in args))
    _assert_sweep_near_f64(rs.riccati_sweep_ref(*args), want64, "plain f32")


def test_riccati_backward_matches_jax():
    """Expansions + sweep against fleet.riccati_backward: f64, B=8, one pass
    (no iteration amplifies the rounding), away from the initial guess and
    with active constraints."""
    B = 8
    rng = np.random.default_rng(7)
    jprob = _jax_fleet_problem(B, jnp.float64)
    us = jprob.us_init + jnp.asarray(5.0 * rng.standard_normal(jprob.us_init.shape))
    xs = _jax_rollout(jprob, us)
    lam = jnp.asarray(2.0 * rng.random((N, jprob.cb.shape[-2], B)))
    reg = jnp.asarray(10.0 ** rng.uniform(-8, -6, B))
    rho = 10.0
    want = jax.jit(jfl.riccati_backward, static_argnums=0)(
        jq._fleet_spec(), jprob, xs, us, lam, jnp.float64(rho), reg
    )

    tprob = _bridge.fleet_problem(jprob)
    txs, tus, tlam, treg = _to_torch(xs, us, lam, reg)
    got = tfl.riccati_backward(
        tq._fleet_spec(), tprob, txs, tus, tlam, torch.tensor(rho, dtype=torch.float64), treg
    )
    for name, g, w in zip(SWEEP_OUTPUTS, got, want):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-9, err_msg=name
        )


# ---------------------------------------------------------------------------
# Full solves: the golden fixture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixture_f64():
    """The golden fixture (B=2, f64) solved by both packages with default
    SolverOptions; the JAX solver is compiled once for the module."""
    B = 2
    jprob, gold_us, gold_xs = jex.fixture_fleet_problem(B, jnp.float64)
    jsol = jax.jit(jfl.make_fleet_solver(jq._fleet_spec(), JaxSolverOptions(), backend="xla"))(jprob)
    tprob, _, _ = tex.fixture_fleet_problem(B, torch.float64, "cpu")
    tsol = tfl.make_fleet_solver(tq._fleet_spec(), SolverOptions())(tprob)
    return jsol, tsol, gold_us, gold_xs


def test_fixture_solve_matches_jax(fixture_f64):
    jsol, tsol, _, _ = fixture_f64
    np.testing.assert_allclose(tsol.xs.numpy(), np.asarray(jsol.xs), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tsol.us.numpy(), np.asarray(jsol.us), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tsol.cost.numpy(), np.asarray(jsol.cost), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tsol.lam.numpy(), np.asarray(jsol.lam), rtol=1e-6, atol=1e-6)
    assert tsol.iterations == int(jsol.iterations)


def test_fixture_solve_matches_golden(fixture_f64):
    _, tsol, gold_us, gold_xs = fixture_f64
    U = tsol.us.numpy().transpose(2, 0, 1)
    X = tsol.xs.numpy().transpose(2, 0, 1)
    for b in range(U.shape[0]):
        np.testing.assert_allclose(U[b], gold_us, atol=1e-4)
        np.testing.assert_allclose(X[b], gold_xs, atol=1e-5)


def test_f32_fixture_guard():
    """The f32 solve of the golden fixture lands on the f64 optimum: every
    lane's cost within 0.5% of the golden objective and u(0) within 0.5 N of
    the golden GRFs (tests/test_f32_quality.py)."""
    B = 8
    prob, gold_us, gold_xs = tex.fixture_fleet_problem(B, torch.float32, "cpu")
    sol = tfl.make_fleet_solver(tq._fleet_spec(), SolverOptions())(prob)
    assert sol.xs.dtype == sol.us.dtype == sol.cost.dtype == torch.float32
    gold_cost = tex.fixture_gold_cost(gold_us, gold_xs)
    assert gold_cost == pytest.approx(jex.fixture_gold_cost(gold_us, gold_xs), abs=0)
    cost = sol.cost.double().numpy()
    assert np.all(np.isfinite(cost))
    np.testing.assert_allclose(cost, gold_cost, rtol=5e-3)
    u0 = sol.us[0].double().numpy().T
    np.testing.assert_allclose(u0, np.broadcast_to(gold_us[0], u0.shape), atol=0.5)


def test_fixture_problem_matches_jax():
    jprob, _, _ = jex.fixture_fleet_problem(3, jnp.float64)
    tprob, _, _ = tex.fixture_fleet_problem(3, torch.float64, "cpu")
    # the port's fleet problem has every field of the reference's (the
    # terminal weight Qdf is None on every fleet problem: the terminal cost
    # uses Qd) and state rows Cx besides, which the reference keeps to its
    # single-problem solver
    assert set(jfl.FleetProblem._fields) - set(tfl.FleetProblem._fields) == set()
    assert set(tfl.FleetProblem._fields) - set(jfl.FleetProblem._fields) == {"Cx"}
    assert jprob.Qdf is None and tprob.Cx is None
    for name in jfl.FleetProblem._fields:
        j, t = getattr(jprob, name), getattr(tprob, name)
        if j is None:
            assert t is None, name
        elif name == "params":
            for a, b in zip(t, j):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


# ---------------------------------------------------------------------------
# Torch-specific pieces
# ---------------------------------------------------------------------------


def test_select_alpha_first_accepted_and_nan_safe():
    """First passing alpha per scenario from a bool mask (cast for argmax),
    and a select that ignores Inf/NaN rollouts of unselected alphas."""
    K, Bn = 3, 4
    ok = torch.tensor([[False, True, False, False],
                       [True, True, False, False],
                       [True, False, True, False]])
    xs_m = torch.arange(K, dtype=torch.float64).reshape(K, 1, 1, 1).expand(K, 2, 3, Bn).clone()
    us_m = xs_m[:, :1].clone()
    J_m = torch.arange(K, dtype=torch.float64)[:, None].expand(K, Bn).clone()
    xs_m[0, :, :, 0] = float("inf")   # not selected: alpha 0 failed for scenario 0
    xs_m[2, :, :, 1] = float("nan")   # not selected: alpha 0 passed first
    J = torch.full((Bn,), 7.0, dtype=torch.float64)
    xs_ls, us_ls, J_ls, accepted = tfl.select_alpha(ok, xs_m, us_m, J_m, J)
    assert accepted.tolist() == [True, True, True, False]
    first = [1, 0, 2]
    for b, k in enumerate(first):
        assert torch.all(xs_ls[..., b] == k) and torch.all(us_ls[..., b] == k)
        assert J_ls[b] == k
    assert torch.all(xs_ls[..., 3] == 0) and J_ls[3] == 7.0


def test_sweep_runs_plain_version_on_cpu(monkeypatch):
    """CPU tensors go to riccati_sweep_ref; the kernel is neither built nor
    counted."""
    def no_build():
        raise AssertionError("the CUDA library must not be loaded for CPU tensors")

    monkeypatch.setattr(rs, "_lib", no_build)
    monkeypatch.setattr(rs.riccati_sweep, "launches", 0)
    rng = np.random.default_rng(3)
    Bn = 5
    M = rng.standard_normal((N, 12, 12, Bn))
    spd = np.einsum("kijb,kljb->kilb", M, M) + 12 * np.eye(12)[None, :, :, None]
    args = _to_torch(
        0.3 * rng.standard_normal((N, 12, 12, Bn)) + np.eye(12)[None, :, :, None],
        0.1 * rng.standard_normal((N, 12, 12, Bn)),
        rng.standard_normal((N, 12, Bn)), spd,
        rng.standard_normal((N, 12, Bn)), spd,
        rng.standard_normal((12, Bn)), spd[0],
        np.full(Bn, 1e-8),
    )
    args = [a.contiguous() for a in args]
    got = rs.riccati_sweep(*args)
    want = rs.riccati_sweep_ref(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert rs.riccati_sweep.launches == 0


@pytest.mark.parametrize("batch", [1, 7])
def test_sweep_wrapper_on_cpu_matches_jax_backward(batch, monkeypatch):
    """K1's wrapper on CPU tensors (one scenario, and a ragged tile of 7) at
    N=20 takes the plain sweep, builds nothing and counts no launch, and its
    outputs are the reference's `riccati_backward` on the same numpy-seeded
    f64 inputs, each within 1e-9 of its largest magnitude (two orders of
    summation)."""
    def no_build():
        raise AssertionError("the CUDA library must not be loaded for CPU tensors")

    monkeypatch.setattr(rs, "_lib", no_build)
    monkeypatch.setattr(rs.riccati_sweep, "launches", 0)
    n = 20
    rng = np.random.default_rng(11 + batch)
    fbk, cmd, wts = jex.standing_batch(batch, n, jnp.float64)
    jprob = jax.jit(jq.build_fleet_problem, static_argnums=3)(
        jax.tree.map(jnp.asarray, fbk), jax.tree.map(jnp.asarray, cmd), wts, n
    )
    us = jprob.us_init + jnp.asarray(3.0 * rng.standard_normal(jprob.us_init.shape))
    xs = _jax_rollout(jprob, us)
    lam = jnp.asarray(rng.random((n, jprob.cb.shape[-2], batch)))
    reg = jnp.asarray(10.0 ** rng.uniform(-8, -6, batch))
    rho = 10.0
    want = jax.jit(jfl.riccati_backward, static_argnums=0)(
        jq._fleet_spec(), jprob, xs, us, lam, jnp.float64(rho), reg
    )

    spec, tprob = tq._fleet_spec(), _bridge.fleet_problem(jprob)
    txs, tus, tlam, treg = _to_torch(xs, us, lam, reg)
    exps = tfl.knot_expansions(spec, tprob, txs, tus, tlam, torch.tensor(rho, dtype=torch.float64))
    lxN, lxxN = tfl.terminal_expansion(spec, txs[-1], tprob)
    got = rs.riccati_sweep(*(t.contiguous() for t in (*exps, lxN, lxxN, treg)))
    assert rs.riccati_sweep.launches == 0
    assert got[0].shape == (n, 12, 12, batch) and got[1].shape == (n, 12, batch)
    for name, g, w in zip(SWEEP_OUTPUTS, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-9 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize(
    "n, batch, dtype, nbytes",
    [
        # per scenario and knot 600 values in and 156 out, per scenario 157 in
        # and 3 out: 4096 x 4 x (10 x 756 + 160)
        (10, 4096, torch.float32, 126_484_480),
        (10, 4096, torch.float64, 252_968_960),
        (20, 1, torch.float32, 4 * (20 * 756 + 160)),
        (10, 16384, torch.float32, 4 * 126_484_480),
    ],
)
def test_sweep_work_matches_hand_count(n, batch, dtype, nbytes):
    """`riccati_sweep.work`, which the on-card check divides by the card's
    peaks: bytes against the hand count, operations against 18,882
    multiply-adds a knot (nine 12x12x12 products 15,552; the 12x25
    elimination 11 x (24 + ... + 13) = 2,442; five matrix-vector products
    720; Quu·d, d·Qu and d·Quu·d 168)."""
    work = rs.work(n, batch, dtype)
    assert work["bytes"] == nbytes
    assert 9 * 1728 + 2442 + 720 + 168 == 18_882
    assert work["flops"] == 2 * 18_882 * n * batch


def _sweep_args(Bn=4, dtype=torch.float64):
    z = lambda *s: torch.zeros(s + (Bn,), dtype=dtype)
    return [z(N, 12, 12), z(N, 12, 12), z(N, 12), z(N, 12, 12), z(N, 12),
            z(N, 12, 12), z(12), z(12, 12), torch.full((Bn,), 1e-8, dtype=dtype)]


def _bad_shape(a):
    a[0] = torch.zeros(N, 13, 13, 4, dtype=torch.float64)


def _bad_dtype(a):
    a[2] = a[2].float()


def _half(a):
    a[:] = [t.half() for t in a]


def _strided(a):
    a[3] = a[3].transpose(1, 2)


def _bad_reg(a):
    a[8] = torch.full((3,), 1e-8, dtype=torch.float64)


@pytest.mark.parametrize("corrupt", [_bad_shape, _bad_dtype, _half, _strided, _bad_reg])
def test_sweep_rejects_bad_inputs(corrupt):
    args = _sweep_args()
    corrupt(args)
    with pytest.raises(ValueError):
        rs.riccati_sweep(*args)


@pytest.mark.parametrize("backend", ["assoc", "auto", "nope"])
def test_backend_choices(backend):
    """An unknown backend raises; "assoc" and "auto" build and solve one f64
    problem (the golden fixture at B=1, 1 AL x 2 iLQR)."""
    if backend == "nope":
        with pytest.raises(ValueError):
            tfl.make_fleet_solver(tq._fleet_spec(), SolverOptions(), backend=backend)
        return
    prob, _, _ = tex.fixture_fleet_problem(1, torch.float64, "cpu")
    opts = SolverOptions(al_iterations=1, ilqr_iterations=2)
    sol = tfl.make_fleet_solver(tq._fleet_spec(), opts, backend=backend)(prob)
    assert sol.us.shape == (20, 12, 1) and sol.iterations == 2
    assert torch.isfinite(sol.us).all() and torch.isfinite(sol.cost).all()


@pytest.fixture
def backward_spy(monkeypatch):
    """Counts the port's calls of each backward pass."""
    from quaternion_mpc_tpu_torch.solver import parallel_riccati as tpr

    calls = {"sweep": 0, "assoc": 0}

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(tfl, "riccati_backward", spy("sweep", tfl.riccati_backward))
    monkeypatch.setattr(tpr, "parallel_backward", spy("assoc", tpr.parallel_backward))
    return calls


@pytest.mark.parametrize("batch", [1, 8])
def test_default_backend_matches_jax_default(batch, backward_spy):
    """The port's default backend ("auto") takes the reference default's
    backward pass: the associative scan for one robot, the sweep for a
    fleet. Both controllers are built with no backend argument (f64, N=6,
    1 AL x 5 iLQR); GRFs agree to 1e-5 N and costs to 1e-7, the reference's
    bounds for reordered ops through the iterations
    (tests/test_fleet_solver.py:157-160)."""
    n, opts = 6, dict(al_iterations=1, ilqr_iterations=5)
    fbk, cmd, wts = jex.standing_batch(batch, n, jnp.float64)
    jctrl = jax.jit(jq.make_fleet_controller(n, JaxSolverOptions(**opts)))
    j_grf, j_cost = jctrl(jax.tree.map(jnp.asarray, fbk), jax.tree.map(jnp.asarray, cmd), wts)
    tctrl = tq.make_fleet_controller(n, SolverOptions(**opts))
    t_grf, t_cost = tctrl(*tex.standing_batch(batch, n, torch.float64, "cpu"))
    np.testing.assert_allclose(t_grf.numpy(), np.asarray(j_grf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_cost.numpy(), np.asarray(j_cost), rtol=0, atol=1e-7)
    want = {"sweep": 0, "assoc": 5} if batch == 1 else {"sweep": 5, "assoc": 0}
    assert backward_spy == want


def test_dense_error_jacobian_matches_structured_and_jax():
    """The generic dense path (discretize fj, project through E(x), E(x1)) of
    the quaternion spec: equal to its structured edj to round-off
    (tests/test_fleet_solver.py:65-89), and to the reference's dense path,
    over the N knots of a standing fleet at once."""
    B = 4
    jprob = _jax_fleet_problem(B, jnp.float64)
    spec = tq._fleet_spec()
    prob = _bridge.fleet_problem(jprob)
    xs = tfl.open_loop_rollout(spec, prob, prob.us_init)
    dense = tfl.error_discrete_jac(spec._replace(edj=None), xs[:-1], xs[1:], prob.us_init, prob)
    structured = tfl.error_discrete_jac(spec, xs[:-1], xs[1:], prob.us_init, prob)
    jspec = jq._fleet_spec()._replace(edj=None)
    for k in range(N):
        want = jfl.error_discrete_jac(jspec, jnp.asarray(xs[k].numpy()),
                                      jnp.asarray(xs[k + 1].numpy()), jprob.us_init[k], jprob)
        for name, d, s, w in zip(("Ae", "Be"), dense, structured, want):
            np.testing.assert_allclose(d[k].numpy(), s[k].numpy(), rtol=0, atol=1e-14,
                                       err_msg=f"{name} knot {k}")
            np.testing.assert_allclose(d[k].numpy(), np.asarray(w), rtol=0, atol=1e-14,
                                       err_msg=f"{name} knot {k}")
