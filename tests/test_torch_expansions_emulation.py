"""K8's device code on the CPU: `csrc/expansions.cu` compiles as plain C++
against `tests/cuda_emulation.h` and runs block by block on the wrapper's
own input table (`kernels.expansions.check_inputs`, `c_tables`: the card's
path), held against the plain version (`knot_expansions_ref`) on the same
inputs.

Cases: the Go1 fleet controller's problem (four feet, every leaf per
scenario) at B = 1, 7, 31, 32, 33 and 130 (ragged tiles of 32 scenarios,
several tiles a knot, the terminal knot's tiles a warp); one, two (the
humanoid) and three feet; the golden standing fixture's leaves shared along
B (batch extent 1) and a mix of shared and per-scenario leaves, with what a
block stages in shared memory read back; per-knot cb and w with a terminal
weight Qdf; multipliers drawn so that some rows are active and some not,
and rows at an exact tie λ + ρc = 0 (active); a problem with no inequality
rows; a block's warps resumed last to first, so that the sums after the
barrier find λ̄ and the active rows only if the barrier orders them; the
batch-first model parameters read in place through their strides. Every
output element counts: the outputs start as NaN.

f64 agrees to 1e-12 of each output's scale. f32 is held to the f32 plain
version at 1e-5 of scale: the device code does PyTorch's operations in the
order PyTorch does them on the card (long sums over four accumulators, the
cross product's terms fused), which is not its order on the CPU (built
here with -ffp-contract=off, on the card with -fmad=false).

The same device code on a number type that counts its operations gives
`kernels.expansions.flops_per_knot` and `STATE_FLOPS`, the operations
`work` counts for the bound, and apart from them `RECOMPUTED_FLOPS`, those
the Bs piece computes again. Needs a host C++17 compiler (g++); without one
the tests skip."""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from quaternion_mpc_tpu_torch import examples
from quaternion_mpc_tpu_torch.kernels import expansions as k8
from quaternion_mpc_tpu_torch.kernels import line_search as k2
from quaternion_mpc_tpu_torch.solver import fleet as tfl

import quaternion_mpc_tpu_torch

# the port makes its tensors on the card unless told otherwise; these tests run on the CPU
quaternion_mpc_tpu_torch.set_default_device("cpu")

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}

_HARNESS = r"""
#include "cuda_emulation.h"

#include <cmath>
#include <cstring>

// A number that counts the floating-point operations done on it: each add,
// subtract, multiply and divide once (a negation, a comparison none), those
// that a piece computes again (K8_RECOMPUTE) apart. It holds one double, so
// that a table of double pointers reads as one of it.
static long long flops = 0, recomputed = 0;
static bool recomputing = false;
#define K8_RECOMPUTE(on) (recomputing = (on))
#define COUNT(n) ((recomputing ? recomputed : flops) += (n))
struct Counted {
  double v;
  Counted() = default;
  template <typename A>
  explicit Counted(A a) : v(static_cast<double>(a)) {}
};
inline Counted counted(double v) {
  Counted c;
  c.v = v;
  return c;
}
inline Counted operator+(Counted a, Counted b) { COUNT(1); return counted(a.v + b.v); }
inline Counted operator-(Counted a, Counted b) { COUNT(1); return counted(a.v - b.v); }
inline Counted operator*(Counted a, Counted b) { COUNT(1); return counted(a.v * b.v); }
inline Counted operator/(Counted a, Counted b) { COUNT(1); return counted(a.v / b.v); }
inline Counted operator-(Counted a) { return counted(-a.v); }
// a fused multiply-add: two operations, one rounding
inline Counted fused(Counted a, Counted b, Counted c) {
  COUNT(2);
  return counted(std::fma(a.v, b.v, c.v));
}
// a sine or a cosine: one operation
inline Counted sin(Counted a) { COUNT(1); return counted(std::sin(a.v)); }
inline Counted cos(Counted a) { COUNT(1); return counted(std::cos(a.v)); }
inline bool operator>(Counted a, Counted b) { return a.v > b.v; }
inline bool operator<(Counted a, Counted b) { return a.v < b.v; }
inline bool operator>=(Counted a, Counted b) { return a.v >= b.v; }

#include "expansions.cu"

template <typename T>
struct Run {
  Args<T> a;
  template <typename M>
  int run() {
    return emulate_blocks(launch_blocks<T, M>(a), Shape<T, M>::THREADS,
                          expansions_kernel<T, M>, a);
  }
};
template <typename T>
static int run(const void* const* in, const long long* ld, void* const* out, int N, int B,
               int n_feet, int nc, int flags) {
  Run<T> fn{make_args<T>(in, ld, out, N, B, nc, flags, 3 * n_feet)};
  const int err = with_model(flags, n_feet, fn);
  return err < 0 ? 2 : err;
}
extern "C" int emulated_f32(const void* const* in, const long long* ld, void* const* out, int N,
                            int B, int n_feet, int nc, int flags) {
  return run<float>(in, ld, out, N, B, n_feet, nc, flags);
}
extern "C" int emulated_f64(const void* const* in, const long long* ld, void* const* out, int N,
                            int B, int n_feet, int nc, int flags) {
  return run<double>(in, ld, out, N, B, n_feet, nc, flags);
}
// The operations of a launch on f64 tables, counted over every thread; -1 on a fault.
extern "C" long long count_flops(const void* const* in, const long long* ld, void* const* out,
                                 int N, int B, int n_feet, int nc, int flags) {
  flops = recomputed = 0;
  return run<Counted>(in, ld, out, N, B, n_feet, nc, flags) == 0 ? flops : -1;
}
// Of the last count_flops, the operations that a piece computed again.
extern "C" long long count_recomputed() { return recomputed; }
// Resume the warps of a block last to first (on) or first to last.
extern "C" void set_warps_reversed(int on) { emulation::warps_reversed = on != 0; }
// The shared memory of the last block emulated: n doubles from value `off`,
// and where each staged leaf sits (SM_CB, ... SM_ROT, in the order of the
// inputs cb, Rd, Qd, Qdf, w, then the six parameters).
extern "C" void shared_f64(double* out, int off, int n) {
  std::memcpy(out, smem_raw + static_cast<size_t>(off) * sizeof(double), n * sizeof(double));
}
extern "C" void staged_at(int* out) {
  const int at[] = {SM_CB, SM_RD, SM_QD, SM_QDF, SM_W, SM_FOOT, SM_INERTIA, SM_MASS,
                    SM_COM, SM_COM_MASS, SM_ROT};
  std::memcpy(out, at, sizeof(at));
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation with")
    work = tmp_path_factory.mktemp("expansions_emulation")
    (work / "harness.cpp").write_text(_HARNESS)
    lib = work / "expansions_emulation.so"
    subprocess.run(
        [compiler, "-std=c++17", "-O1", "-ffp-contract=off", "-fno-strict-aliasing", "-shared",
         "-fPIC", f"-I{HERE}", f"-I{k8.SOURCE.parent}", "-o", str(lib),
         str(work / "harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(lib))
    for name in ("emulated_f32", "emulated_f64", "count_flops"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        getattr(lib, name).restype = ctypes.c_longlong if name == "count_flops" else ctypes.c_int
    lib.expansions_table.argtypes = [ctypes.c_void_p]
    lib.count_recomputed.restype = ctypes.c_longlong
    lib.set_warps_reversed.argtypes = [ctypes.c_int]
    lib.shared_f64.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.staged_at.argtypes = [ctypes.c_void_p]
    return lib


def _emulated(lib, spec, prob, xs, us, lam, rho):
    """The wrapper's launch with the emulated kernel in place of the card's:
    the eight outputs, which start as NaN so that anything the kernel leaves
    unwritten shows."""
    table, dims = k8.check_inputs(spec, prob, xs, us, lam, rho)
    outputs = k8.new_outputs(dims, xs)
    for t in outputs:
        t.fill_(float("nan"))
    fn = lib.emulated_f64 if xs.dtype == torch.float64 else lib.emulated_f32
    assert fn(*k8.c_tables(table, outputs), *dims) == 0
    return outputs


_OUTPUTS = ("As", "Bs", "lxs", "lxxs", "lus", "luus", "lxN", "lxxN")


def _hold(lib, spec, prob, xs, us, lam, rho, what):
    """The emulated kernel against the plain version, each output relative to
    its largest magnitude."""
    got = _emulated(lib, spec, prob, xs, us, lam, rho)
    want = k8.knot_expansions_ref(spec, prob, xs, us, lam, rho)
    rtol = RTOL[xs.dtype]
    for name, g, w in zip(_OUTPUTS, got, want):
        assert g.shape == w.shape, (what, name)
        assert bool(torch.isfinite(g).all()), f"{what} {name}: an element unwritten or not finite"
        scale = float(w.abs().max())
        err = float((g - w).abs().max()) / max(scale, 1e-300)
        assert err <= rtol, f"{what} {name}: {err:.3g} of scale {scale:.3g}"
    return got, want


def _feet(spec, prob, n):
    """The problem with its first ``n`` feet: their forces, weights,
    references and inequality rows (6 a foot)."""
    nu, nc = 3 * n, 6 * n
    p = prob.params._replace(foot_pos=prob.params.foot_pos[:n])
    cb = prob.cb[..., :nc, :]
    return spec._replace(nu=nu), prob._replace(
        u_ref=prob.u_ref[:, :nu], Rd=prob.Rd[:nu], Cu=prob.Cu[:nc, :nu], cb=cb, params=p,
        us_init=prob.us_init[:, :nu].contiguous())


def _inputs(spec, prob, rho=1.0, seed=3):
    """xs from the open-loop rollout of us_init, λ drawn (half zero, the rest
    up to 200: some rows active, some not) at penalty ``rho``."""
    us = prob.us_init
    N, B, nc = us.shape[0], us.shape[-1], prob.cb.shape[-2]
    rng = np.random.default_rng(seed)
    lam = 200.0 * rng.random((N, nc, B)) * (rng.random((N, nc, B)) < 0.5)
    xs = tfl.open_loop_rollout(spec, prob, us)
    return xs, us, torch.as_tensor(lam, dtype=us.dtype), torch.tensor(rho, dtype=us.dtype)


def test_tables_match_the_wrapper(emulated):
    table = (ctypes.c_int * 3)()
    emulated.expansions_table(table)
    assert tuple(table) == (k8.INPUTS, k8.OUTPUTS, k8.MAX_ROWS)
    emulated.expansions_tags.restype = ctypes.c_char_p
    assert tuple(emulated.expansions_tags().decode().split()) == k8.INSTANTIATIONS


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 7, 31, 32, 33, 130])
def test_emulated_kernel_matches_plain(emulated, dtype, batch):
    """The fleet controller's problem, every leaf per scenario: one
    scenario, a ragged single tile (7, 31), one whole tile (32), a tile and
    one scenario (33), and five tiles a knot, the last ragged (130); the
    terminal knot's tiles a warp of one or more blocks."""
    spec, prob, _ = examples.line_search_case("standing", batch, dtype, "cpu", 10, 8)
    xs, us, lam, rho = _inputs(spec, prob)
    z = lam + rho * tfl.constraint_values(prob, xs, us)
    assert bool((z >= 0).any()) and bool((z < 0).any())
    _hold(emulated, spec, prob, xs, us, lam, rho, f"standing B={batch}")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n_feet", [1, 2, 3])
def test_emulated_kernel_with_fewer_feet(emulated, dtype, n_feet):
    """One to three feet of the fleet controller's problem (nu 3, 6, 9)."""
    spec, prob, _ = examples.line_search_case("standing", 9, dtype, "cpu", 6, 8)
    spec, prob = _feet(spec, prob, n_feet)
    _hold(emulated, spec, prob, *_inputs(spec, prob), f"{n_feet} feet")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_on_the_humanoid(emulated, dtype):
    """The two-footed humanoid: its own mass, inertia and feet, no CoM term."""
    spec, prob, _ = examples.line_search_case("humanoid", 7, dtype, "cpu", 8, 8)
    _hold(emulated, spec, prob, *_inputs(spec, prob, rho=10.0), "humanoid")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_with_shared_leaves_and_ties(emulated, dtype):
    """The golden standing fixture (N = 20): references, weights, Cu, cb
    and the parameters shared along B (batch extent 1), h one value; one
    scenario's foot 0 carries nothing at zero multipliers, so that its
    pyramid rows and its −fz row sit at λ + ρc = 0 exactly (active)."""
    spec, prob, _ = examples.line_search_case("fixture", 40, dtype, "cpu", 20, 8)
    table, _ = k8.check_inputs(spec, prob, *_inputs(spec, prob))
    assert [ld for _, ld in table[2:10]] == [1] * 8 and table[11][1] == 1
    us = prob.us_init.clone()
    us[:, 0:3, 1] = 0.0
    prob = prob._replace(us_init=us)
    xs, us, lam, rho = _inputs(spec, prob)
    lam[:, :, 1] = 0.0
    got, _ = _hold(emulated, spec, prob, xs, us, lam, rho, "fixture B=40")
    assert float(got[5][0, 2, 2, 1]) == pytest.approx(1e-6 + 4 * 0.6**2 + 1.0, rel=1e-6)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_with_per_knot_leaves(emulated, dtype):
    """Per-knot w (N+1, B) and cb (N+1, nc, B) (feet lifted at random
    knots), a terminal weight Qdf, one weight row for the fleet (Qd of
    batch extent 1), h and ρ per scenario."""
    spec, prob, _ = examples.line_search_case("standing", 13, dtype, "cpu", 10, 8)
    N, B = prob.us_init.shape[0], prob.us_init.shape[-1]
    rng = np.random.default_rng(4)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    cb = prob.cb[None].expand(N + 1, *prob.cb.shape).clone() if prob.cb.dim() == 2 \
        else prob.cb.clone()
    cb[:, 4::6][torch.from_numpy(rng.random((N + 1, 4, B)) < 0.3)] = 0.0
    prob = prob._replace(w=t(1.0 + rng.random((N + 1, B))), cb=cb, Qdf=10.0 * prob.Qd,
                         Qd=prob.Qd[:, :1].contiguous(), h=t(0.01 + 0.01 * rng.random(B)))
    xs, us, lam, _ = _inputs(spec, prob)
    rho = t(1.0 + rng.random(B))
    table, (_, _, _, _, flags) = k8.check_inputs(spec, prob, xs, us, lam, rho)
    assert flags == 3 and table[4][1] == 1 and table[17][1] == B and table[18][1] == B
    _hold(emulated, spec, prob, xs, us, lam, rho, "per-knot leaves")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_without_inequality_rows(emulated, dtype):
    """nc = 0: lu = Rd·(u − u_ref) and luu = diag(Rd) alone."""
    spec, prob, _ = examples.line_search_case("standing", 5, dtype, "cpu", 6, 8)
    prob = prob._replace(Cu=prob.Cu[:0], cb=prob.cb[..., :0, :])
    got, _ = _hold(emulated, spec, prob, *_inputs(spec, prob), "nc = 0")
    assert torch.equal(got[5][:, range(12), range(12)], prob.Rd.expand(6, 12, 5))


@pytest.mark.parametrize("n_feet,nc", [(4, 24), (2, 12), (1, 6), (3, 18), (4, 0)])
def test_flop_count_matches_the_device_code(emulated, n_feet, nc):
    """The operations of one scenario's launch (N = 3: three stage knots and
    the terminal) on a counting number type: N·flops_per_knot + STATE_FLOPS,
    whatever the data (no operation is skipped where a row is inactive)."""
    spec, prob, _ = examples.line_search_case("standing", 1, torch.float64, "cpu", 3, 8)
    spec, prob = _feet(spec, prob, n_feet)
    if nc == 0:
        prob = prob._replace(Cu=prob.Cu[:0], cb=prob.cb[..., :0, :])
    xs, us, lam, rho = _inputs(spec, prob)
    table, dims = k8.check_inputs(spec, prob, xs, us, lam, rho)
    outputs = k8.new_outputs(dims, xs)
    count = emulated.count_flops(*k8.c_tables(table, outputs), *dims)
    assert count == 3 * k8.flops_per_knot("quat_srb_midpoint", n_feet, nc) + \
        k8.STATE_FLOPS["quat_srb"]
    # the Bs piece's own inverse inertia, ½h, ½h², q_m and ½G(q_m), apart
    assert emulated.count_recomputed() == 3 * k8.RECOMPUTED_FLOPS["quat_srb_midpoint"]
    want = k8.knot_expansions_ref(spec, prob, xs, us, lam, rho)
    for g, w in zip(outputs, want):  # the counted run computes the same values
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max())


# K8's input table, by name (csrc/expansions.cu enum Input)
_INPUTS = ("xs", "us", "x_ref", "u_ref", "Qd", "Qdf", "Rd", "w", "Cu", "cb", "lam", "foot_pos",
           "inertia", "mass", "com_offset", "com_mass", "rot_body_to_world", "h", "rho")
# the leaves a block stages where every scenario shares them, in the order of `staged_at`
_STAGED = ("cb", "Rd", "Qd", "Qdf", "w", "foot_pos", "inertia", "mass", "com_offset",
           "com_mass", "rot_body_to_world")


@pytest.mark.parametrize("case", ["fixture", "mixed", "falling_cat"])
def test_emulated_kernel_stages_the_shared_leaves(emulated, case):
    """A block copies the leaves every scenario shares (batch extent 1) to
    shared memory, and nothing of a per-scenario leaf: after a launch the
    last block's shared memory (a terminal block: knot N's cb row and w)
    holds each shared leaf's values and, where a leaf is per scenario, the
    0xff bytes the emulation fills it with. "fixture": every leaf shared;
    "mixed": the fleet controller's problem with Cu, cb, Rd and the
    inertia shared, per-knot w and cb, the rest per scenario. (Cu, shared
    or not, goes to a stage block's tile, which the results hold.)
    "falling_cat": the attitude model's leaves, all shared, its inertia the
    one parameter it has: the others' room stays as it was filled."""
    dtype = torch.float64
    if case == "falling_cat":
        spec, prob, _ = examples.line_search_case("falling_cat", 9, dtype, "cpu", 6, 8)
    elif case == "fixture":
        spec, prob, _ = examples.line_search_case("fixture", 9, dtype, "cpu", 20, 8)
    else:
        spec, prob, _ = examples.line_search_case("standing", 9, dtype, "cpu", 6, 8)
        N = prob.us_init.shape[0]
        cb = prob.cb[None, ..., :1].expand(N + 1, *prob.cb.shape[:-1], 1).clone()
        cb[N, 4::6] = 0.0
        w = torch.as_tensor(1.0 + np.random.default_rng(5).random((N + 1, 9)), dtype=dtype)
        prob = prob._replace(Cu=prob.Cu[..., :1].contiguous(), cb=cb, Rd=prob.Rd[..., :1], w=w)
    xs, us, lam, rho = _inputs(spec, prob)
    _hold(emulated, spec, prob, xs, us, lam, rho, f"{case}: staged")
    table, (N, _, _, nc, flags) = k8.check_inputs(spec, prob, xs, us, lam, rho)
    by_name = dict(zip(_INPUTS, table))
    at = (ctypes.c_int * len(_STAGED))()
    emulated.staged_at(at)
    staged = 0
    for name, off in zip(_STAGED, at):
        t, extent = by_name[name]
        if t is None:  # a parameter the model has not
            got = np.empty(1)
            emulated.shared_f64(got.ctypes.data, off, 1)
            assert np.isnan(got).all(), f"{name} is not the model's and was staged"
            continue
        values = t[..., 0].reshape(-1)
        if name == "cb" and flags & 2:
            values = t[N, :, 0]
        elif name == "w" and flags & 1:
            values = t[N, 0].reshape(1)
        got = np.empty(values.numel())
        emulated.shared_f64(got.ctypes.data, off, got.size)
        if extent == 1:
            assert np.array_equal(got, values.numpy()), name
            staged += 1
        else:
            assert np.isnan(got).all(), f"{name} is per scenario and was staged"
    assert staged == {"fixture": 11, "mixed": 6, "falling_cat": 6}[case]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_orders_its_pieces_by_the_barrier(emulated, dtype):
    """The luu warps read which rows are active from the AL-terms warp
    through shared memory after a barrier: with a block's warps resumed
    last to first (the luu warps first), every output is still the plain
    version's."""
    spec, prob, _ = examples.line_search_case("standing", 33, dtype, "cpu", 6, 8)
    xs, us, lam, rho = _inputs(spec, prob)
    z = lam + rho * tfl.constraint_values(prob, xs, us)
    assert bool((z >= 0).any()) and bool((z < 0).any())
    emulated.set_warps_reversed(1)
    try:
        _hold(emulated, spec, prob, xs, us, lam, rho, "warps last to first")
    finally:
        emulated.set_warps_reversed(0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_reads_strided_parameters(emulated, dtype):
    """Batch-first parameters, each scenario its own (the feet, the rotation,
    and here also the inertia and the CoM offset, scaled a scenario), go to
    the kernel in place, read through their strides, and give the plain
    version's outputs."""
    spec, prob, _ = examples.line_search_case("standing", 33, dtype, "cpu", 6, 8)
    p = prob.params
    scale = torch.as_tensor(1.0 + 0.2 * np.random.default_rng(6).random(33), dtype=dtype)
    inertia = torch.movedim(p.inertia[..., 0][None] * scale[:, None, None], 0, -1)
    com = torch.movedim(p.com_offset[..., 0][None] * scale[:, None], 0, -1)
    prob = prob._replace(params=p._replace(inertia=inertia, com_offset=com))
    xs, us, lam, rho = _inputs(spec, prob)
    table, _ = k8.check_inputs(spec, prob, xs, us, lam, rho)
    by_name = dict(zip(_INPUTS, table))
    for name, rows in (("foot_pos", 12), ("inertia", 9), ("com_offset", 3),
                       ("rot_body_to_world", 9)):
        given = getattr(prob.params, name)
        t, extent = by_name[name]
        assert not given.is_contiguous() and t.data_ptr() == given.data_ptr(), name
        assert extent == 33 and k2.strides(t) == (1, rows), name
    _hold(emulated, spec, prob, xs, us, lam, rho, "strided parameters")


# K8's other models: the convex fleet controller's problem (the Euler SRB,
# midpoint rule, every leaf per scenario), the golden convex fixture (forward
# Euler, N = 30, leaves shared along B) and a falling_cat fleet (the attitude
# model, midpoint rule, per-knot w, Qdf, leaves shared along B)
_INSTANTIATION = {"convex": "euler_srb_midpoint", "convex_fixture": "euler_srb_euler",
                  "falling_cat": "attitude_midpoint"}


def _model_case(name, batch, dtype, horizon=8):
    spec, prob, _ = examples.line_search_case(name, batch, dtype, "cpu", horizon, 8)
    table, (*_, flags) = k8.check_inputs(spec, prob, *_inputs(spec, prob))
    assert k8.INSTANTIATIONS[flags >> 8] == _INSTANTIATION[name]
    return spec, prob


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name,batch", [("convex", 1), ("convex", 7), ("convex", 33),
                                        ("convex_fixture", 9), ("falling_cat", 1),
                                        ("falling_cat", 7), ("falling_cat", 33)])
def test_emulated_models_match_plain(emulated, dtype, name, batch):
    """Each of K8's other instantiations against its plain version: the
    Euler SRB by the midpoint rule and by forward Euler (its reference
    approximation of the Jacobian, discretised), the attitude model (the
    plain version's Jacobian by torch.func.jacfwd); one scenario, a ragged
    tile, a tile and one scenario; some rows active and some not."""
    spec, prob = _model_case(name, batch, dtype)
    xs, us, lam, rho = _inputs(spec, prob)
    z = lam + rho * tfl.constraint_values(prob, xs, us)
    assert bool((z >= 0).any()) and bool((z < 0).any())
    _hold(emulated, spec, prob, xs, us, lam, rho, f"{name} B={batch}")


@pytest.mark.parametrize("integrator", ["midpoint", "euler"])
@pytest.mark.parametrize("n_feet", [1, 2, 3])
def test_emulated_euler_srb_with_fewer_feet(emulated, integrator, n_feet):
    """One to three feet of the convex fleet controller's problem, by the
    midpoint rule and by forward Euler."""
    spec, prob, _ = examples.line_search_case("convex", 9, torch.float64, "cpu", 6, 8)
    spec, prob = _feet(spec._replace(integrator=integrator), prob, n_feet)
    _hold(emulated, spec, prob, *_inputs(spec, prob), f"Euler SRB {integrator} {n_feet} feet")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["convex", "falling_cat"])
def test_emulated_models_with_per_knot_and_shared_leaves(emulated, dtype, name):
    """Per-knot w (N+1, B) and cb (N+1, nc, B) (rows zeroed at random
    knots), a terminal weight Qdf, one weight row for the fleet (Qd of
    batch extent 1), h and ρ per scenario."""
    spec, prob = _model_case(name, 13, dtype)
    N, B = prob.us_init.shape[0], prob.us_init.shape[-1]
    rng = np.random.default_rng(4)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    cb = prob.cb[None].expand(N + 1, *prob.cb.shape).clone() if prob.cb.dim() == 2 \
        else prob.cb.clone()
    cb[:, 1::3][torch.from_numpy(rng.random((N + 1, cb[:, 1::3].shape[1], B)) < 0.3)] = 0.0
    prob = prob._replace(w=t(1.0 + rng.random((N + 1, B))), cb=cb, Qdf=10.0 * prob.Qd,
                         Qd=prob.Qd[:, :1].contiguous(), h=t(0.01 + 0.01 * rng.random(B)))
    xs, us, lam, _ = _inputs(spec, prob)
    rho = t(1.0 + rng.random(B))
    table, (_, _, _, _, flags) = k8.check_inputs(spec, prob, xs, us, lam, rho)
    assert flags & 3 == 3 and table[4][1] == 1 and table[17][1] == B and table[18][1] == B
    _hold(emulated, spec, prob, xs, us, lam, rho, f"{name} per-knot leaves")


@pytest.mark.parametrize("name", ["convex", "convex_fixture", "falling_cat"])
def test_emulated_models_without_inequality_rows(emulated, name):
    """nc = 0: lu = Rd·(u − u_ref) and luu = diag(Rd) alone."""
    spec, prob = _model_case(name, 5, torch.float64)
    prob = prob._replace(Cu=prob.Cu[:0], cb=prob.cb[..., :0, :])
    got, _ = _hold(emulated, spec, prob, *_inputs(spec, prob), f"{name} nc = 0")
    nu = spec.nu
    assert torch.equal(got[5][:, range(nu), range(nu)],
                       prob.Rd.expand(nu, 5).expand(got[5].shape[0], nu, 5))


@pytest.mark.parametrize("name,n_feet,nc", [("euler_srb_midpoint", 4, 24),
                                             ("euler_srb_midpoint", 2, 12),
                                             ("euler_srb_midpoint", 1, 0),
                                             ("euler_srb_euler", 4, 24),
                                             ("euler_srb_euler", 3, 0),
                                             ("attitude_midpoint", 1, 6),
                                             ("attitude_midpoint", 1, 0)])
def test_flop_count_of_each_model(emulated, name, n_feet, nc):
    """The operations of one scenario's launch (N = 3) of each of K8's other
    instantiations on a counting number type: N·flops_per_knot +
    STATE_FLOPS, whatever the data, the Bs piece's repeats apart
    (RECOMPUTED_FLOPS)."""
    problem = {"euler_srb_midpoint": "convex", "euler_srb_euler": "convex_fixture",
               "attitude_midpoint": "falling_cat"}[name]
    spec, prob, _ = examples.line_search_case(problem, 1, torch.float64, "cpu", 3, 8)
    if problem != "falling_cat":
        spec, prob = _feet(spec, prob, n_feet)
    if nc == 0:
        prob = prob._replace(Cu=prob.Cu[:0], cb=prob.cb[..., :0, :])
    if problem == "convex_fixture":  # N = 30 there: the first three knots
        prob = prob._replace(x_ref=prob.x_ref[:4], u_ref=prob.u_ref[:4],
                             us_init=prob.us_init[:3])
    xs, us, lam, rho = _inputs(spec, prob)
    table, dims = k8.check_inputs(spec, prob, xs, us, lam, rho)
    assert dims[0] == 3 and k8.INSTANTIATIONS[dims[4] >> 8] == name
    outputs = k8.new_outputs(dims, xs)
    count = emulated.count_flops(*k8.c_tables(table, outputs), *dims)
    assert count == 3 * k8.flops_per_knot(name, n_feet, nc) + \
        k8.STATE_FLOPS[name.rsplit("_", 1)[0]]
    assert emulated.count_recomputed() == 3 * k8.RECOMPUTED_FLOPS[name]
    want = k8.knot_expansions_ref(spec, prob, xs, us, lam, rho)
    for g, w in zip(outputs, want):  # the counted run computes the same values
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_attitude_model_spreads_non_finite_values_as_plain(emulated, dtype):
    """Runaway falling_cat starts, as the solver meets them at its first
    iterations: scenario 1's quaternion blown up at some knots far enough
    that the products of the expansions overflow, scenario 4's first state
    Inf, scenario 5's a NaN. Every output has as many non-finite elements as
    the plain version's, in the same places, and the finite ones agree to
    RTOL of each scenario's scale."""
    spec, prob = _model_case("falling_cat", 7, dtype)
    xs, us, lam, rho = _inputs(spec, prob)
    huge = 1e13 if dtype == torch.float32 else 1e105
    xs = xs.clone()
    xs[3:6, 0:4, 1] *= huge
    xs[0, 5, 4] = float("inf")
    xs[2, 1, 5] = float("nan")
    got = _emulated(emulated, spec, prob, xs, us, lam, rho)
    want = k8.knot_expansions_ref(spec, prob, xs, us, lam, rho)
    spread = 0
    for name, g, w in zip(_OUTPUTS, got, want):
        bad_g, bad_w = ~torch.isfinite(g), ~torch.isfinite(w)
        assert torch.equal(bad_g, bad_w), (
            f"{name}: {int(bad_g.sum())} non-finite elements, plain {int(bad_w.sum())}")
        spread += int(bad_w.sum())
        fin = torch.where(bad_w, 0.0, w)
        scale = fin.abs().flatten(0, -2).max(0).values.clamp_min(1e-300)
        err = (torch.where(bad_w, 0.0, g - w).abs().flatten(0, -2).max(0).values / scale).max()
        assert float(err) <= RTOL[dtype], f"{name}: {float(err):.3g} of a scenario's scale"
    assert spread > 0 and bool(torch.isfinite(got[0][..., [0, 2, 3, 6]]).all())


@pytest.mark.parametrize("name", ["convex", "falling_cat"])
def test_emulated_models_order_their_pieces_by_the_barrier(emulated, name):
    """With a block's warps resumed last to first, every output of the
    Euler SRB's and the attitude model's instantiations is still the plain
    version's."""
    spec, prob = _model_case(name, 33, torch.float64)
    emulated.set_warps_reversed(1)
    try:
        _hold(emulated, spec, prob, *_inputs(spec, prob), f"{name}: warps last to first")
    finally:
        emulated.set_warps_reversed(0)
