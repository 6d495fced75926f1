"""K2's device code on the CPU: `csrc/line_search.cu` compiles as plain C++
against `tests/cuda_emulation.h` and runs block by block on the wrapper's
own input table (`kernels.line_search.check_inputs`, `c_tables`: the card's
path), held against the plain version (`line_search_ref`, the port's
`solver.fleet.line_search`) on the same inputs.

Cases, for each model K2 is instantiated for: the quaternion SRB's Go1
standing fleet problem (every leaf per scenario), golden fixture
(references, weights and parameters shared along B, read with batch stride
0) and two-footed humanoid; the Euler SRB's convex fleet problem (midpoint
rule) and golden convex fixture (forward Euler, N = 30, leaves shared); the
attitude model's falling_cat fleet (per-knot w, Qdf, a runaway start); K = 8
and 12 (8 and 16 lanes a scenario), N = 6 to 40, B with a ragged last
block; and, on
the standing problem, an alpha whose rollout overflows to Inf / NaN, a
scenario that accepts no alpha, `done` scenarios, per-knot w and cb with a
terminal weight Qdf, and one scenario past a whole warp of 32 alphas. The
blocks are planned as on an H100 (132 SMs: two lanes an alpha at these
small B) and, where named, for one SM (the plans of a full card: one lane
an alpha, 32 or 16 scenarios a block). What the staged design adds: a
ragged last block over several blocks, leaves of batch extent 1 staged
once a block beside per-scenario ones, trajectories kept in shared memory
or in the device-memory scratch, the selected and the copied-through
trajectories written by one block, and a priced J bit-equal to every J_k
where each rollout reproduces xs_bar (the pricing sums as the rollouts do).

f64 agrees to 1e-10 of scale (the per-alpha costs J_k, then xs, us and J).
f32 is held to the f32 plain version: J_k to 1e-4 of max(|J_k|, |J|), then
xs, us and J to 1e-4 of scale in every scenario whose selected alpha both
sides agree on; a scenario where they differ (a flip, from summing in
another order) must be a margin case, both sides' costs within that
tolerance of the Armijo threshold (`kernels.line_search.compare`). A
rollout that runs away (its quaternion off the unit sphere by more than
`kernels.line_search.RUNAWAY`: falling_cat's steep starts at a large step)
amplifies rounding without bound: its cost is not held, nor a scenario
where such a rollout passes the Armijo test (`conditioned`; no
quaternion-SRB or Euler-SRB case has one). Each
main case runs with J given and with J None, where the kernel prices
xs_bar and us_bar itself (an AL iteration's first line search).
Needs a host C++17 compiler (g++); without one the tests skip."""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from quaternion_mpc_tpu_torch import examples
from quaternion_mpc_tpu_torch.kernels import line_search as k2
from quaternion_mpc_tpu_torch.kernels import rollout as k9

import quaternion_mpc_tpu_torch

# the port makes its tensors on the card unless told otherwise; these tests run on the CPU
quaternion_mpc_tpu_torch.set_default_device("cpu")

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}

_HARNESS = r"""
#include "cuda_emulation.h"
#include "line_search.cu"


// with_model's fn: the launch's blocks one after another, or its plan
template <typename T>
struct Run {
  const void* const* in;
  const long long* ld;
  void* const* out;
  int N, B, K, nc, flags, sms;
  int* plan;  // null: run the blocks

  template <typename M>
  int run() {
    const Args<T> a = make_args<T, M>(in, ld, out, N, B, K, nc, flags, sms);
    if (plan != nullptr) {
      plan[0] = a.plan.P, plan[1] = a.plan.S, plan[2] = a.plan.traj_at >= 0;
      return 0;
    }
    return a.plan.P == 2
               ? emulate_blocks(a.plan.blocks, a.plan.threads, line_search_kernel<T, M, 2>, a)
               : emulate_blocks(a.plan.blocks, a.plan.threads, line_search_kernel<T, M, 1>, a);
  }
};
template <typename T>
static int run(const void* const* in, const long long* ld, void* const* out, int N, int B, int K,
               int n_feet, int nc, int flags, int sms, int* plan) {
  Run<T> fn{in, ld, out, N, B, K, nc, flags, sms, plan};
  const int err = with_model<Separate>(flags >> MODEL_SHIFT, n_feet, fn);
  return err < 0 ? 2 : err;
}
// sms: the multiprocessors the blocks are planned for (an H100's 132 as on
// the card; 1 for the plans of a full card at a small B)
extern "C" int emulated_f32(const void* const* in, const long long* ld, void* const* out,
                            int N, int B, int K, int n_feet, int nc, int flags, int sms) {
  return run<float>(in, ld, out, N, B, K, n_feet, nc, flags, sms, nullptr);
}
extern "C" int emulated_f64(const void* const* in, const long long* ld, void* const* out,
                            int N, int B, int K, int n_feet, int nc, int flags, int sms) {
  return run<double>(in, ld, out, N, B, K, n_feet, nc, flags, sms, nullptr);
}
// the launch's plan: lanes an alpha, scenarios a block, and 1 where it keeps
// its trajectories in shared memory, 0 in the scratch
extern "C" void plan_of(int is_f64, const void* const* in, const long long* ld, void* const* out,
                        int N, int B, int K, int n_feet, int nc, int flags, int sms, int* plan) {
  if (is_f64)
    run<double>(in, ld, out, N, B, K, n_feet, nc, flags, sms, plan);
  else
    run<float>(in, ld, out, N, B, K, n_feet, nc, flags, sms, plan);
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation with")
    work = tmp_path_factory.mktemp("line_search_emulation")
    (work / "harness.cpp").write_text(_HARNESS)
    lib = work / "line_search_emulation.so"
    subprocess.run(
        [compiler, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{HERE}",
         f"-I{k2.SOURCE.parent}", "-o", str(lib), str(work / "harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(lib))
    for name in ("emulated_f32", "emulated_f64"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
        getattr(lib, name).restype = ctypes.c_int
    lib.line_search_table.argtypes = [ctypes.c_void_p]
    lib.plan_of.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    return lib


SMS = 132  # an H100's multiprocessors: the blocks planned as on the card


def _emulated(lib, spec, prob, kw, in_shared=None, sms=SMS):
    """The wrapper's launch with the emulated kernel in place of the card's:
    (xs, us, J, J_out, accepted, improved, costs); the outputs start as NaN /
    True so that anything the kernel leaves unwritten shows. ``in_shared``:
    where the launch must keep its trajectories (True: shared memory, False:
    the device-memory scratch), or None; ``sms``: the multiprocessors its
    blocks are planned for."""
    table, extras, dims = k2.check_inputs(spec, prob, **kw)
    outputs, scratch = k2.new_outputs(dims, kw["xs"], True)
    for t in (*outputs, scratch):
        t.fill_(True if t.dtype == torch.bool else float("nan"))
    is_f64 = kw["xs"].dtype == torch.float64
    tables = k2.c_tables(table, (*extras, scratch), outputs)
    if in_shared is not None:
        assert _plan(lib, is_f64, tables, dims, sms)[2] == in_shared
    fn = lib.emulated_f64 if is_f64 else lib.emulated_f32
    assert fn(*tables, *dims, sms) == 0
    return outputs


def _plan(lib, is_f64, tables, dims, sms):
    """(lanes an alpha, scenarios a block, trajectories in shared memory)."""
    plan = (ctypes.c_int * 3)()
    lib.plan_of(is_f64, *tables, *dims, sms, plan)
    return tuple(plan)


def _hold(lib, spec, prob, kw, what, in_shared=None, sms=SMS):
    """The emulated kernel against the plain version, as the card's check holds it."""
    dtype = kw["xs"].dtype
    got = _emulated(lib, spec, prob, kw, in_shared, sms)
    want = k2.line_search_ref(spec, prob, **kw, with_costs=True)
    res = k2.compare(got, want, kw["dV1"], kw["dV2"], kw["alphas"], RTOL[dtype],
                     held=k2.conditioned(spec, prob, kw))
    assert res["nonfinite_same"], f"{what}: the costs are non-finite in other places"
    assert res["costs_err"] <= RTOL[dtype], f"{what}: J_k {res}"
    if dtype == torch.float64:
        assert not res["flips"], f"{what}: f64 selections differ: {res}"
    assert res["margin_cases"], f"{what}: a flip that is no margin case: {res}"
    assert res["decisions_same"], f"{what}: accepted / improved differ: {res}"
    for key in ("xs_err", "us_err", "J_err"):
        assert res[key] <= RTOL[dtype], f"{what}: {key} {res}"
    return got, want, res


def test_table_matches_the_wrapper(emulated):
    table = (ctypes.c_int * 3)()
    emulated.line_search_table(table)
    assert tuple(table) == (k2.INPUTS, k2.OUTPUTS, 2)  # 2: a row and a batch stride an input
    emulated.line_search_tags.restype = ctypes.c_char_p
    assert tuple(emulated.line_search_tags().decode().split()) == k2.INSTANTIATIONS


@pytest.mark.parametrize("priced", [False, True], ids=["J_given", "J_priced"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize(
    "name,batch,horizon,n_alphas",
    [
        ("standing", 11, 10, 12),   # 8 scenarios a block: a ragged second block
        ("standing", 19, 6, 8),     # 16 a block: a ragged second block
        ("fixture", 9, 20, 12),     # shared leaves, N = 20
        ("humanoid", 7, 6, 12),     # two feet: nu 6, nc 12
        ("humanoid", 5, 10, 8),
        ("convex", 11, 10, 8),      # the Euler SRB, midpoint rule: every leaf per scenario
        ("convex_fixture", 5, 30, 12),  # the Euler SRB, forward Euler: leaves shared, N = 30
        ("falling_cat", 9, 8, 12),  # the attitude model: nu 3, nc 6, per-knot w, Qdf
    ],
)
def test_emulated_kernel_matches_plain(emulated, dtype, name, batch, horizon, n_alphas, priced):
    """``priced``: no J given, the kernel prices xs_bar and us_bar itself
    (an AL iteration's first line search)."""
    spec, prob, kw = examples.line_search_case(name, batch, dtype, "cpu", horizon, n_alphas)
    if priced:
        kw["J"] = None
    got, want, res = _hold(emulated, spec, prob, kw, f"{name} B={batch} N={horizon} K={n_alphas}")
    assert bool(want[4].all()), "every scenario of a first iteration accepts a step"
    print(f"{name} {dtype} priced={priced}: {res}")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_on_hard_cases(emulated, dtype):
    """An alpha that overflows, a scenario that accepts nothing, done
    scenarios, per-knot w and cb and a terminal weight, B = 13 at K = 12."""
    spec, prob, _ = examples.line_search_case("standing", 13, dtype, "cpu", 10, 12)
    N, B = prob.us_init.shape[0], prob.us_init.shape[-1]
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    cb = prob.cb[None].expand(N + 1, *prob.cb.shape).clone()
    lifted = torch.from_numpy(rng.random((N + 1, 4, B)) < 0.3)  # feet lifted at random knots
    cb[:, 4::6][lifted] = 0.0
    prob = prob._replace(
        w=t(1.0 + rng.random((N + 1, B))), cb=cb, Qdf=10.0 * prob.Qd,
        Qd=prob.Qd[:, :1].contiguous(),  # one weight row for the fleet
    )
    kw = examples.line_search_inputs(spec, prob, 12)
    # the largest "alpha" drives every rollout to Inf / NaN; the rest are the halvings
    kw["alphas"] = torch.cat([t([1e30 if dtype == torch.float32 else 1e160]), kw["alphas"][:-1]])
    kw["J"] = kw["J"].clone()
    kw["J"][1] = -1e3  # no cost lies below it: scenario 1 accepts nothing
    kw["done"][[2, 5]] = True
    got, want, res = _hold(emulated, spec, prob, kw, "hard cases")
    costs_w = want[6]
    assert not bool(torch.isfinite(costs_w[0]).any()), "the overflowing alpha stays finite"
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
    assert not bool(want[4][1]) and not bool(got[4][1])
    # nothing taken where done or not accepted: the old trajectory, copied through
    for b in (1, 2, 5):
        assert torch.equal(got[0][..., b], kw["xs"][..., b])
        assert torch.equal(got[1][..., b], kw["us"][..., b])
        assert torch.equal(got[3][b], got[2][b])
    assert bool(want[5][2]) and bool(want[5][5]), "done scenarios still report improvement"


def test_emulated_kernel_at_a_warp_of_alphas(emulated):
    """K = 32: one scenario a warp, the ballot's whole mask."""
    spec, prob, kw = examples.line_search_case("standing", 3, torch.float64, "cpu", 6, 32)
    _hold(emulated, spec, prob, kw, "K = 32")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_on_a_runaway_attitude_start(emulated, dtype):
    """The attitude model with a first "alpha" so large that every rollout
    runs away (the torque through the gyroscopic term and the quaternion's
    rate overflows to Inf / NaN), a scenario that accepts nothing (1) and
    done scenarios (2, 5): the select stays NaN-safe, and nothing is taken
    where done or not accepted."""
    spec, prob, kw = examples.line_search_case("falling_cat", 13, dtype, "cpu", 8, 12)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    kw["alphas"] = torch.cat([t([1e30 if dtype == torch.float32 else 1e160]), kw["alphas"][:-1]])
    kw["J"] = kw["J"].clone()
    kw["J"][1] = -1e3
    kw["done"][[2, 5]] = True
    for how, kw_run in _both_ways(kw):
        if how == "J_priced":
            kw_run = {**kw_run, "J": None}
        got, want, _ = _hold(emulated, spec, prob, kw_run, f"runaway attitude start {how}")
        assert not bool(torch.isfinite(want[6][0]).any()), "the overflowing alpha stays finite"
        assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
        for b in (2, 5) if how == "J_priced" else (1, 2, 5):
            assert torch.equal(got[0][..., b], kw["xs"][..., b])
            assert torch.equal(got[1][..., b], kw["us"][..., b])
            assert torch.equal(got[3][b], got[2][b])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("sms", [SMS, 1], ids=["132_SMs", "1_SM"])
@pytest.mark.parametrize("name,batch,horizon,n_alphas",
                         [("convex", 37, 6, 8), ("convex_fixture", 21, 30, 12),
                          ("falling_cat", 21, 8, 12)], ids=["convex", "convex_fixture",
                                                            "falling_cat"])
def test_emulated_kernel_with_a_ragged_last_block_of_each_model(emulated, name, batch, horizon,
                                                              n_alphas, sms, dtype):
    """The Euler SRB and the attitude model over blocks whose last is
    ragged: planned for an H100 (two lanes an alpha, 8 or 4 scenarios a
    block) and for one SM (one lane an alpha, 16 or 32 a block)."""
    spec, prob, kw = examples.line_search_case(name, batch, dtype, "cpu", horizon, n_alphas)
    P, S, _ = _plan_for(emulated, spec, prob, kw, sms)
    assert P == (2 if sms == SMS else 1) and batch % S != 0 and batch > S
    for how, kw_run in _both_ways(kw):
        _hold(emulated, spec, prob, kw_run, f"{name} B={batch} {how}", sms=sms)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name,horizon", [("convex_fixture", 30), ("falling_cat", 8)])
def test_emulated_kernel_with_shared_leaves_of_each_model(emulated, name, horizon, dtype):
    """The convex fixture's and the falling_cat fleet's leaves that every
    scenario shares (references, weights, Cu, cb and the model's
    parameters: batch extent 1, staged once a block) over several blocks,
    B = 40."""
    spec, prob, kw = examples.line_search_case(name, 40, dtype, "cpu", horizon, 12)
    table, _, _ = k2.check_inputs(spec, prob, **kw)
    # x_ref ... cb, then the model's parameters and h (the multipliers are per scenario)
    shared = [ld for i, (t, ld) in enumerate(table[:20]) if t is not None and 4 <= i != 12]
    assert len(shared) > 8 and all(ld == 1 for ld in shared), [ld for _, ld in table]
    for how, kw_run in _both_ways(kw):
        _hold(emulated, spec, prob, kw_run, f"{name} B=40 {how}")


def _both_ways(kw):
    """The inputs with J given, then with J None (priced by the kernel)."""
    return (("J_given", kw), ("J_priced", {**kw, "J": None}))


def _plan_for(lib, spec, prob, kw, sms):
    """The plan the kernel takes for these inputs (`_plan`)."""
    table, extras, dims = k2.check_inputs(spec, prob, **kw)
    outputs, scratch = k2.new_outputs(dims, kw["xs"], True)
    tables = k2.c_tables(table, (*extras, scratch), outputs)
    return _plan(lib, kw["xs"].dtype == torch.float64, tables, dims, sms)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [36, 34, 33])
@pytest.mark.parametrize("sms", [SMS, 1], ids=["132_SMs", "1_SM"])
def test_emulated_kernel_with_a_ragged_last_block(emulated, dtype, batch, sms):
    """More scenarios than a block holds, the last block ragged: planned for
    an H100 (132 SMs: two lanes an alpha, 8 scenarios a block, the
    trajectories in shared memory) and for one SM (the plans of a full card:
    one lane an alpha, 32 scenarios a block in f32 and 16 in f64, the
    trajectories in the device-memory scratch)."""
    spec, prob, kw = examples.line_search_case("standing", batch, dtype, "cpu", 6, 8)
    full = 32 if dtype == torch.float32 else 16
    assert _plan_for(emulated, spec, prob, kw, sms) == ((2, 8, 1) if sms == SMS else (1, full, 0))
    for how, kw_run in _both_ways(kw):
        _hold(emulated, spec, prob, kw_run, f"B={batch} {how}", sms=sms)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_with_leaves_of_batch_extent_one(emulated, dtype):
    """Leaves every scenario shares (batch extent 1: staged once a block, one
    column every scenario reads) beside leaves per scenario, over blocks:
    the golden fixture (references, weights, Cu and parameters shared) at
    B = 40, and the standing problem at B = 36 with x_ref, u_ref, Cu and the
    multipliers cut to one shared column."""
    spec, prob, kw = examples.line_search_case("fixture", 40, dtype, "cpu", 20, 12)
    for how, kw_run in _both_ways(kw):
        _hold(emulated, spec, prob, kw_run, f"fixture B=40 {how}")
    spec, prob, kw = examples.line_search_case("standing", 36, dtype, "cpu", 6, 8)
    prob = prob._replace(x_ref=prob.x_ref[..., :1], u_ref=prob.u_ref[..., :1],
                         Cu=prob.Cu[..., :1])
    kw = examples.line_search_inputs(spec, prob, 8)
    kw["lam"] = torch.full_like(kw["lam"][..., :1], 0.5)
    table, _, _ = k2.check_inputs(spec, prob, **kw)
    assert [ld for _, ld in table[4:6]] == [1, 1] and table[10][1] == 1 and table[12][1] == 1
    for how, kw_run in _both_ways(kw):
        _hold(emulated, spec, prob, kw_run, f"standing B=36, shared leaves {how}")


@pytest.mark.parametrize(
    "name,dtype,batch,horizon,n_alphas,sms,in_shared",
    [
        ("standing", torch.float64, 8, 20, 32, SMS, False),  # 4 scenarios x 32 lanes: 525 KB
        ("standing", torch.float32, 13, 10, 12, 1, False),   # 16 scenarios x 16 lanes: 269 KB
        ("standing", torch.float32, 13, 10, 12, SMS, True),  # 4 scenarios x 16 lanes: 67 KB
        ("standing", torch.float64, 3, 10, 8, SMS, True),    # 4 scenarios x 8 lanes: 67 KB
        ("standing", torch.float32, 1, 6, 12, SMS, True),    # the hardware tick's shape
        ("convex", torch.float64, 3, 10, 8, SMS, True),      # 4 scenarios x 8 lanes: 64 KB
        ("convex", torch.float32, 13, 10, 12, 1, False),     # 8 scenarios x 16 lanes
        ("convex_fixture", torch.float64, 21, 30, 12, SMS, False),  # 4 x 16 lanes: 375 KB
        ("convex_fixture", torch.float32, 1, 30, 12, SMS, True),  # the fixture's one problem
        ("falling_cat", torch.float32, 5, 40, 12, 1, True),  # 8 x 16 lanes: 208 KB
        ("falling_cat", torch.float64, 5, 40, 12, 1, False),  # the same: 417 KB
    ],
    ids=["f64-N20-K32-B8", "f32-N10-K12-B13-1SM", "f32-N10-K12-B13", "f64-N10-K8-B3",
         "f32-N6-K12-B1", "convex-f64-N10-K8-B3", "convex-f32-N10-K12-B13-1SM",
         "convex_fixture-f64-N30-K12-B21", "convex_fixture-f32-N30-K12-B1",
         "falling_cat-f32-N40-K12-B5-1SM", "falling_cat-f64-N40-K12-B5-1SM"],
)
def test_emulated_kernel_keeps_trajectories_where_they_fit(emulated, name, dtype, batch, horizon,
                                                          n_alphas, sms, in_shared):
    """Each alpha's rollout goes to a slab in shared memory where it fits
    beside the staging and every block has an SM of its own, else to the
    device-memory scratch; both ways the selected one is written. The
    quaternion SRB's fleet problem, the Euler SRB's (convex fleet, convex
    fixture) and the attitude model's."""
    spec, prob, kw = examples.line_search_case(name, batch, dtype, "cpu", horizon, n_alphas)
    for how, kw_run in _both_ways(kw):
        _hold(emulated, spec, prob, kw_run, f"B={batch} K={n_alphas} {how}", in_shared, sms)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_pricing_sums_as_the_rollouts_do(emulated, dtype):
    """With no feedback and no step (Ks = 0, ds = 0) every alpha's rollout
    is the open-loop rollout of us_bar; where xs_bar is the device code's own
    rollout of it, each rollout reproduces xs_bar bit for bit, and the J the
    kernel prices from xs_bar and us_bar (its lanes taking different knots)
    must equal every J_k bit for bit: both sums in knot order, alike."""
    spec, prob, kw = examples.line_search_case("standing", 11, dtype, "cpu", 10, 8)
    kw = {**kw, "Ks": torch.zeros_like(kw["Ks"]), "ds": torch.zeros_like(kw["ds"]),
          "dV1": torch.full_like(kw["dV1"], -1.0), "dV2": torch.zeros_like(kw["dV2"]),
          "lam": torch.full_like(kw["lam"], 0.25)}
    rolled = _emulated(emulated, spec, prob, {**kw, "J": torch.full_like(kw["J"], 1e30)})
    assert bool(rolled[5].all()), "every scenario takes the step below J = 1e30"
    assert torch.equal(rolled[1], kw["us"]), "u = ū + 0·d + 0·δx is ū"
    got = _emulated(emulated, spec, prob, {**kw, "xs": rolled[0], "J": None})
    J, costs = got[2], got[6]
    for k in range(costs.shape[0]):
        assert torch.equal(costs[k], J), f"alpha {k}: J_k differs from the priced J"
    assert torch.equal(got[0], rolled[0]) and torch.equal(got[1], kw["us"])


@pytest.mark.parametrize("dtype,batch,n_alphas,sms,in_shared",
                         [(torch.float64, 6, 8, SMS, True), (torch.float64, 12, 8, 1, False),
                          (torch.float32, 8, 8, SMS, True), (torch.float32, 8, 20, 1, False)],
                         ids=["f64-B6-shared", "f64-B12-scratch", "f32-B8-shared",
                              "f32-B8-K20-scratch"])
def test_emulated_block_writes_taken_and_copied_scenarios(emulated, dtype, batch, n_alphas, sms,
                                                         in_shared):
    """One block whose scenarios take the step or not: done (0, 3), no alpha
    accepted (4), the rest taking their first passing alpha. The block
    writes the selected rollouts (against the plain version) and copies
    xs_bar and us_bar through bit for bit where nothing is taken."""
    spec, prob, kw = examples.line_search_case("standing", batch, dtype, "cpu", 10, n_alphas)
    kw["J"] = kw["J"].clone()
    kw["J"][4] = -1e3
    kw["done"][[0, 3]] = True
    assert _plan_for(emulated, spec, prob, kw, sms)[1] >= batch, "one block"
    got, want, _ = _hold(emulated, spec, prob, kw, f"B={batch} mixed", in_shared, sms)
    taken = want[5] & ~kw["done"]
    assert taken.tolist() == [b not in (0, 3, 4) for b in range(batch)]
    for b in range(batch):
        if not bool(taken[b]):
            assert torch.equal(got[0][..., b], kw["xs"][..., b])
            assert torch.equal(got[1][..., b], kw["us"][..., b])
        else:
            assert not torch.equal(got[0][..., b], kw["xs"][..., b])


# ---------------------------------------------------------------------------
# K9, csrc/rollout.cu: the open-loop rollout and the AL pricing, whose models'
# steps are K2's (csrc/step_models.cuh), emulated the same way and held
# against their plain versions (`kernels.rollout.open_loop_rollout_ref`,
# `price_ref`) through the wrapper's own tables: f64 to 1e-12 and f32 to 1e-6
# of scale (xs and λ̄ of their largest finite magnitude, J of max(|J|, 1) a
# scenario).
# ---------------------------------------------------------------------------

K9_RTOL = {torch.float64: 1e-12, torch.float32: 1e-6}
# the instantiation each problem of `examples.line_search_case` runs
K2_MODEL_OF = {"standing": "quat_srb_midpoint", "fixture": "quat_srb_midpoint",
               "humanoid": "quat_srb_midpoint", "convex": "euler_srb_midpoint",
               "convex_fixture": "euler_srb_euler", "falling_cat": "attitude_midpoint"}

_K9_HARNESS = r"""
#include "cuda_emulation.h"
#include "rollout.cu"

// with_model's fn: the launch's blocks one after another, planned as on an
// H100 (132 SMs) or for `sms`
template <typename T, bool PRICE>
struct Run {
  Args<T> a;
  const void* const* in;
  const long long* st;
  void* const* out;
  int N, B, nc, flags, sms;

  template <typename M>
  int run() {
    a = make_args<T, M>(in, st, out, N, B, nc, flags, sms);
    if constexpr (PRICE)
      return valid(a.price) ? emulate_blocks(a.price.blocks, a.price.threads, price_kernel<T, M>, a)
                            : 3;
    else
      return valid(a.roll) ? emulate_blocks(a.roll.blocks, a.roll.threads, rollout_kernel<T, M>, a)
                           : 3;
  }
};
template <typename T, bool PRICE>
static int run(const void* const* in, const long long* st, void* const* out, int N, int B,
               int n_feet, int nc, int flags, int sms) {
  Run<T, PRICE> fn{{}, in, st, out, N, B, nc, flags, sms};
  const int err = with_model<AsTorch>(flags >> MODEL_SHIFT, n_feet, fn);
  return err < 0 ? 2 : err;
}
#define ENTRY(name, T, PRICE)                                                             \
  extern "C" int name(const void* const* in, const long long* st, void* const* out,       \
                      int N, int B, int n_feet, int nc, int flags, int sms) {             \
    return run<T, PRICE>(in, st, out, N, B, n_feet, nc, flags, sms);                      \
  }
ENTRY(emulated_rollout_f32, float, false)
ENTRY(emulated_rollout_f64, double, false)
ENTRY(emulated_price_f32, float, true)
ENTRY(emulated_price_f64, double, true)

// drive then advance against step, on one state, input and constants, for
// model `model` at n_feet feet with Ops (0: AsTorch, K9's; 1: Separate,
// K2's): x (NX) is stepped both ways into x_step and x_split
template <typename T, typename Ops>
struct Split {
  const T* x;
  const T* u;
  const T* m;
  T h;
  T* x_step;
  T* x_split;

  template <typename M>
  int run() {
    const Sm<T> model{m};
    T d[M::D];
    for (int i = 0; i < M::NX; ++i) x_step[i] = x_split[i] = x[i];
    M::step(x_step, u, model, h);
    M::drive(u, model, d);
    M::advance(x_split, d, model, h);
    return M::NX;
  }
};
template <typename T>
static int split(int separate, int model, int n_feet, const T* x, const T* u, const T* m, T h,
                 T* x_step, T* x_split) {
  if (separate) {
    Split<T, Separate> fn{x, u, m, h, x_step, x_split};
    return with_model<Separate>(model, n_feet, fn);
  }
  Split<T, AsTorch> fn{x, u, m, h, x_step, x_split};
  return with_model<AsTorch>(model, n_feet, fn);
}
extern "C" int split_f32(int separate, int model, int n_feet, const float* x, const float* u,
                         const float* m, float h, float* x_step, float* x_split) {
  return split<float>(separate, model, n_feet, x, u, m, h, x_step, x_split);
}
extern "C" int split_f64(int separate, int model, int n_feet, const double* x, const double* u,
                         const double* m, double h, double* x_step, double* x_split) {
  return split<double>(separate, model, n_feet, x, u, m, h, x_step, x_split);
}
"""


@pytest.fixture(scope="module")
def emulated_k9(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation with")
    work = tmp_path_factory.mktemp("rollout_emulation")
    (work / "harness.cpp").write_text(_K9_HARNESS)
    lib = work / "rollout_emulation.so"
    subprocess.run(
        [compiler, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", f"-I{HERE}",
         f"-I{k9.SOURCE.parent}", "-o", str(lib), str(work / "harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(lib))
    for entry in ("rollout", "price"):
        for t in ("f32", "f64"):
            fn = getattr(lib, f"emulated_{entry}_{t}")
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
            fn.restype = ctypes.c_int
    for t, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        fn = getattr(lib, f"split_{t}")
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [real] + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    k9.bind_plans(lib)
    return lib


def _k9_rollout(lib, spec, prob, us, sms=132):
    """The wrapper's rollout with the emulated kernel in place of the card's,
    its blocks planned for ``sms`` SMs (an H100's 132 by default); xs starts
    as NaN, so that anything left unwritten shows."""
    table, dims = k9.check_rollout(spec, prob, us)
    N, B = dims[:2]
    xs = torch.full((N + 1, spec.nx, B), float("nan"), dtype=us.dtype)
    fn = getattr(lib, f"emulated_rollout_{'f64' if us.dtype == torch.float64 else 'f32'}")
    assert fn(*k9.c_tables(table, (xs, None, None)), *dims, sms) == 0
    return xs


def _k9_price(lib, spec, prob, xs, us, lam, rho, cost=True, lam_bar=True, sms=132):
    """The wrapper's pricing with the emulated kernel: (J or None, λ̄ or None)."""
    table, dims = k9.check_price(spec, prob, xs, us, lam, rho)
    N, B, _, nc, _ = dims
    J = torch.full((B,), float("nan"), dtype=xs.dtype) if cost else None
    bar = torch.full((N, nc, B), float("nan"), dtype=xs.dtype) if lam_bar else None
    fn = getattr(lib, f"emulated_price_{'f64' if xs.dtype == torch.float64 else 'f32'}")
    assert fn(*k9.c_tables(table, (None, J, bar)), *dims, sms) == 0
    return J, bar


def _k9_close(got, want, what, rtol, per_scenario=False):
    """Non-finite in the same places; the finite elements within ``rtol``
    of the largest finite magnitude (``per_scenario``: of max(|want|, 1) each)."""
    bad_g, bad_w = ~torch.isfinite(got), ~torch.isfinite(want)
    assert torch.equal(bad_g, bad_w), f"{what}: {int(bad_g.sum())} non-finite, plain {int(bad_w.sum())}"
    fin = torch.where(bad_w, 0.0, want)
    scale = fin.abs().clamp_min(1.0) if per_scenario else fin.abs().max().clamp_min(1e-300)
    err = float((torch.where(bad_w, 0.0, got - want).abs() / scale).max())
    assert err <= rtol, f"{what}: {err:.3g} of scale"
    return err


def _k9_hold(lib, spec, prob, what, lam=None, rho=1.0, us=None, draw_lam=True):
    """K9's rollout of ``us`` (us_init by default) and its pricing of the
    rollout, J and λ̄ together and each alone, against the plain versions;
    λ drawn (half zero, the rest up to 200: some rows active, some not)
    unless given. Returns the emulated (xs, J, λ̄)."""
    us = prob.us_init if us is None else us
    dtype = us.dtype
    rtol = K9_RTOL[dtype]
    xs = _k9_rollout(lib, spec, prob, us)
    _k9_close(xs, k9.open_loop_rollout_ref(spec, prob, us), f"{what} xs", rtol)
    if lam is None and draw_lam:
        N, nc, B = us.shape[0], prob.Cu.shape[0], us.shape[-1]
        rng = np.random.default_rng(5)
        lam = torch.as_tensor(200.0 * rng.random((N, nc, B)) * (rng.random((N, nc, B)) < 0.5),
                              dtype=dtype)
    rho_t = torch.tensor(rho, dtype=dtype)
    want = k9.price_ref(spec, prob, xs, us, lam, rho_t, True, True)
    for cost, lam_bar in ((True, True), (True, False), (False, True)):
        J, bar = _k9_price(lib, spec, prob, xs, us, lam, rho_t, cost, lam_bar)
        if cost:
            _k9_close(J, want[0], f"{what} J", rtol, per_scenario=True)
        if lam_bar:
            _k9_close(bar, want[1], f"{what} λ̄", rtol)
    return xs, *_k9_price(lib, spec, prob, xs, us, lam, rho_t)


def test_k9_tables_match_the_wrapper(emulated_k9):
    emulated_k9.rollout_table.argtypes = [ctypes.c_void_p]
    table = (ctypes.c_int * 2)()
    emulated_k9.rollout_table(table)
    assert tuple(table) == (k9.INPUTS, k9.OUTPUTS)
    emulated_k9.rollout_tags.restype = ctypes.c_char_p
    assert tuple(emulated_k9.rollout_tags().decode().split()) == k9.INSTANTIATIONS == \
        k2.INSTANTIATIONS


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize(
    "name,batch,horizon",
    [
        ("standing", 70, 10),        # 64 scenarios a rollout block, 32 a pricing's: ragged
        ("humanoid", 9, 20),         # two feet: nu 6, nc 12
        ("fixture", 40, 20),         # leaves of batch extent 1 (references, weights, Cu, params)
        ("convex", 33, 10),          # the Euler SRB, midpoint rule
        ("convex_fixture", 5, 30),   # the Euler SRB, forward Euler, leaves shared
        ("falling_cat", 35, 8),      # the attitude model: per-knot w, Qdf
    ],
)
def test_k9_emulated_matches_plain(emulated_k9, dtype, name, batch, horizon):
    """Each of the four instantiations (the quaternion SRB at four and two
    feet) against the plain rollout, total_cost and multiplier update, with
    λ̄ asked for and not, over ragged last blocks."""
    spec, prob, _ = examples.line_search_case(name, batch, dtype, "cpu", horizon, 8)
    table, dims = k9.check_rollout(spec, prob, prob.us_init)
    assert k9.INSTANTIATIONS[dims[-1] >> 8] == K2_MODEL_OF[name]
    _k9_hold(emulated_k9, spec, prob, f"{name} B={batch} N={horizon}")


def _k9_feet(spec, prob, n):
    """The problem with its first ``n`` feet (6 inequality rows a foot)."""
    nu, nc = 3 * n, 6 * n
    p = prob.params._replace(foot_pos=prob.params.foot_pos[:n])
    return spec._replace(nu=nu), prob._replace(
        u_ref=prob.u_ref[:, :nu], Rd=prob.Rd[:nu], Cu=prob.Cu[:nc, :nu], cb=prob.cb[..., :nc, :],
        params=p, us_init=prob.us_init[:, :nu].contiguous())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["standing", "convex"])
@pytest.mark.parametrize("n_feet", [1, 2, 3])
def test_k9_emulated_with_fewer_feet(emulated_k9, dtype, name, n_feet):
    """One to three feet of the quaternion and the Euler fleet controllers'
    problems (nu 3, 6, 9; nc 6, 12, 18)."""
    spec, prob, _ = examples.line_search_case(name, 9, dtype, "cpu", 6, 8)
    spec, prob = _k9_feet(spec, prob, n_feet)
    _k9_hold(emulated_k9, spec, prob, f"{name} {n_feet} feet")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_k9_emulated_with_leaves_of_batch_extent_one(emulated_k9, dtype):
    """x_ref, u_ref, Cu and the multipliers cut to one shared column of a
    batch-last tensor (batch stride 0, row stride B: read in place), the
    per-knot w and cb of the fleet with a terminal weight Qdf, and zero
    multipliers at the final cost's penalty (no λ given)."""
    spec, prob, _ = examples.line_search_case("standing", 36, dtype, "cpu", 6, 8)
    N, B = prob.us_init.shape[0], prob.us_init.shape[-1]
    rng = np.random.default_rng(3)
    cb = prob.cb[None].expand(N + 1, *prob.cb.shape).clone()
    cb[:, 4::6][torch.from_numpy(rng.random((N + 1, 4, B)) < 0.3)] = 0.0
    prob = prob._replace(x_ref=prob.x_ref[..., :1], u_ref=prob.u_ref[..., :1],
                         Cu=prob.Cu[..., :1], cb=cb, Qdf=10.0 * prob.Qd,
                         w=torch.as_tensor(1.0 + rng.random((N + 1, B)), dtype=dtype))
    table, _ = k9.check_price(spec, prob, prob.us_init.new_zeros((N + 1, 13, B)),
                              prob.us_init, None, torch.tensor(1.0, dtype=dtype))
    assert [ld for _, ld in table[2:4]] == [1, 1] and table[8][1] == 1
    assert k2.strides(table[2][0]) == (B, 0) and table[10][0] is None
    lam = torch.full((N, prob.Cu.shape[0], 1), 0.5, dtype=dtype)
    _k9_hold(emulated_k9, spec, prob, "shared leaves", lam=lam)
    _k9_hold(emulated_k9, spec, prob, "no multipliers, final penalty", rho=1e-30, draw_lam=False)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_k9_emulated_spreads_an_overflowing_start_as_plain(emulated_k9, dtype):
    """falling_cat starts that overflow: torques so large that a rollout runs
    to Inf / NaN within the horizon (scenarios 1 and 4), a first state with
    an Inf (5): xs, J and λ̄ non-finite in the same places as the plain
    versions', the rest held as elsewhere."""
    spec, prob, _ = examples.line_search_case("falling_cat", 7, dtype, "cpu", 8, 8)
    huge = 1e18 if dtype == torch.float32 else 1e150
    us = prob.us_init.clone()
    us[2:, :, 1] *= huge
    us[:, 0, 4] = huge
    x0 = prob.x0.clone()
    x0[5, 5] = float("inf")
    prob = prob._replace(x0=x0, us_init=us)
    xs, J, bar = _k9_hold(emulated_k9, spec, prob, "overflowing starts")
    assert not bool(torch.isfinite(xs[..., [1, 4, 5]]).all(0).all(0).any())
    assert bool(torch.isfinite(xs[..., [0, 2, 3, 6]]).all()) and not bool(torch.isfinite(J).all())


# The step split in two (csrc/step_models.cuh): `drive`, what the inputs set
# alone, then `advance`, equal to `step` bit for bit for every model and both
# roundings (Separate, K2's; AsTorch, K9's), so that K2's outputs do not move
# and K9's chain takes each knot's drive computed off it.
_MODELS = [(model, feet) for model in range(3) for feet in (1, 2, 3, 4)] + [(3, 1)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("separate", [0, 1], ids=["as_torch", "separate"])
@pytest.mark.parametrize("model,n_feet", _MODELS,
                         ids=[f"{k9.INSTANTIATIONS[m]}-{f}" for m, f in _MODELS])
def test_k9_drive_then_advance_is_the_step(emulated_k9, dtype, separate, model, n_feet):
    np_t = np.float64 if dtype == torch.float64 else np.float32
    rng = np.random.default_rng(100 * model + 10 * n_feet + separate)
    fn = getattr(emulated_k9, f"split_{'f64' if dtype == torch.float64 else 'f32'}")
    for trial in range(20):
        x = rng.standard_normal(13).astype(np_t)
        x[3 if model == 0 else 0:][:4] /= np.linalg.norm(x[3 if model == 0 else 0:][:4])
        u = (50.0 * rng.standard_normal(12)).astype(np_t)
        m = rng.standard_normal(28).astype(np_t)
        m[-1] = 10.0 + abs(m[-1])  # the quaternion SRB's mass, the last constant
        if model in (1, 2):
            m[3 * n_feet + 9] = 12.0 + trial  # the Euler SRB's mass
        got = [np.full(13, np.nan, np_t), np.full(13, np.nan, np_t)]
        n = fn(separate, model, n_feet, *(a.ctypes.data for a in (x, u, m)), np_t(0.02),
               *(g.ctypes.data for g in got))
        assert n in (7, 12, 13)
        assert np.isfinite(got[0][:n]).all()
        assert got[0][:n].tobytes() == got[1][:n].tobytes(), f"trial {trial}"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize(
    "name,batch,horizon,sms",
    [
        ("standing", 1, 10, 132),     # one scenario of a block of 8
        ("standing", 7, 10, 132),     # a ragged single tile
        ("standing", 33, 10, 1),      # planned for one SM: tiles of 32, a ragged second
        ("standing", 100, 10, 132),   # tiles of 8, a ragged last one
        ("standing", 9, 1, 132),      # N = 1
        ("standing", 33, 40, 1),      # N = 40 at 32 scenarios a block: f64 drives in two passes
        ("falling_cat", 7, 40, 132),  # nc = 6, N = 40
        ("falling_cat", 33, 40, 1),
        ("convex", 100, 10, 132),
    ],
)
def test_k9_emulated_plans(emulated_k9, dtype, name, batch, horizon, sms):
    """The redesigned rollout and pricing at their plans' edges: ragged
    tiles (B = 1, 7, 33, 100), blocks planned for an H100 and for one SM,
    N = 1 and N = 40 (the rollout's drives in more than one pass where
    shared memory holds fewer knots), nc = 6 (falling_cat: rows on four
    lanes, two of them one row short), the multiplier update's knot groups;
    J and λ̄ together, each alone, against the plain versions."""
    spec, prob, _ = examples.line_search_case(name, batch, dtype, "cpu", horizon, 8)
    us = prob.us_init
    table, dims = k9.check_rollout(spec, prob, us)
    plan = k9.plans(emulated_k9, table, dims, (us, None, None), dtype, sms)
    assert plan["roll_blocks"] * plan["roll_S"] >= batch > (plan["roll_blocks"] - 1) * plan["roll_S"]
    if (name, horizon, sms, dtype) == ("standing", 40, 1, torch.float64):
        assert plan["roll_chunk"] < horizon, "the drives in two passes"
    rtol = K9_RTOL[dtype]
    xs = _k9_rollout(emulated_k9, spec, prob, us, sms)
    _k9_close(xs, k9.open_loop_rollout_ref(spec, prob, us), "xs", rtol)
    N, nc = us.shape[0], prob.Cu.shape[0]
    rng = np.random.default_rng(7)
    lam = torch.as_tensor(200.0 * rng.random((N, nc, batch)) * (rng.random((N, nc, batch)) < 0.5),
                          dtype=dtype)
    rho = torch.tensor(1.0, dtype=dtype)
    ptable, pdims = k9.check_price(spec, prob, xs, us, lam, rho)
    update = k9.plans(emulated_k9, ptable, pdims, (None, None, xs), dtype, sms)
    assert update["price_groups"] == -(-N // update["price_knots"])
    final = k9.plans(emulated_k9, ptable, pdims, (None, xs, None), dtype, sms)
    assert final["price_groups"] == 1 and final["price_knots"] == N + 1
    want = k9.price_ref(spec, prob, xs, us, lam, rho, True, True)
    for cost, lam_bar in ((True, True), (True, False), (False, True)):
        J, bar = _k9_price(emulated_k9, spec, prob, xs, us, lam, rho, cost, lam_bar, sms)
        if cost:
            _k9_close(J, want[0], "J", rtol, per_scenario=True)
        if lam_bar:
            _k9_close(bar, want[1], "λ̄", rtol)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_k9_emulated_three_feet_per_knot_leaves_no_multipliers(emulated_k9, dtype):
    """Three feet (nc = 18, not a multiple of four: lanes 2 and 3 take a row
    fewer) with per-knot w and cb, Qdf, at B = 33 over one SM's tiles and an
    H100's; then the final cost with no λ at ρ = 1e-30."""
    spec, prob, _ = examples.line_search_case("standing", 33, dtype, "cpu", 10, 8)
    spec, prob = _k9_feet(spec, prob, 3)
    N, B = prob.us_init.shape[0], prob.us_init.shape[-1]
    rng = np.random.default_rng(11)
    cb = prob.cb[None].expand(N + 1, *prob.cb.shape).clone()
    cb[:, 4::6][torch.from_numpy(rng.random((N + 1, 3, B)) < 0.3)] = 0.0
    prob = prob._replace(cb=cb, Qdf=10.0 * prob.Qd,
                         w=torch.as_tensor(1.0 + rng.random((N + 1, B)), dtype=dtype))
    _k9_hold(emulated_k9, spec, prob, "three feet, per-knot leaves")
    _k9_hold(emulated_k9, spec, prob, "three feet, no multipliers", rho=1e-30, draw_lam=False)
    rtol = K9_RTOL[dtype]
    xs = _k9_rollout(emulated_k9, spec, prob, prob.us_init, 1)
    want = k9.price_ref(spec, prob, xs, prob.us_init, None, torch.tensor(1e-30, dtype=dtype))
    J, _ = _k9_price(emulated_k9, spec, prob, xs, prob.us_init, None,
                     torch.tensor(1e-30, dtype=dtype), True, False, sms=1)
    _k9_close(J, want[0], "final cost, one SM", rtol, per_scenario=True)


def test_k9_emulated_reads_what_shared_memory_cannot_hold_from_device_memory(emulated_k9):
    """A horizon so long (N = 160, f64) that a tile's λ for every knot no
    longer fits a block's shared memory: the final cost's plan reads λ from
    device memory (Cu and cb staged), and agrees all the same."""
    dtype = torch.float64
    spec, prob, _ = examples.line_search_case("standing", 7, dtype, "cpu", 160, 8)
    us = prob.us_init
    N, nc, B = us.shape[0], prob.Cu.shape[0], us.shape[-1]
    xs = k9.open_loop_rollout_ref(spec, prob, us)
    rng = np.random.default_rng(9)
    lam = torch.as_tensor(200.0 * rng.random((N, nc, B)) * (rng.random((N, nc, B)) < 0.5),
                          dtype=dtype)
    rho = torch.tensor(1.0, dtype=dtype)
    table, dims = k9.check_price(spec, prob, xs, us, lam, rho)
    plan = k9.plans(emulated_k9, table, dims, (None, xs, xs), dtype)
    assert plan["lam_at"] == -1 and plan["cu_at"] >= 0 and plan["cb_at"] >= 0
    want = k9.price_ref(spec, prob, xs, us, lam, rho, True, True)
    J, bar = _k9_price(emulated_k9, spec, prob, xs, us, lam, rho, True, True)
    _k9_close(J, want[0], "J", K9_RTOL[dtype], per_scenario=True)
    _k9_close(bar, want[1], "λ̄", K9_RTOL[dtype])
