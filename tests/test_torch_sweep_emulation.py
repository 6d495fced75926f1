"""K1's device code on the CPU: `csrc/riccati_sweep.cu` compiles as plain
C++ against `tests/cuda_emulation.h` (one fiber a CUDA thread, resumed warp
by warp between `__syncthreads`/`__syncwarp`, an exchange buffer for the
shuffles, cp.async copying at once), every instantiation of `K1_SHAPES`, and a
block at a time it is held against `riccati_sweep_ref` on the main path's
expansions and at each instantiation's own shape: the tiling, the lane
mappings of the products (a warp at 12 x 12, a group of lanes below), the
Gauss-Jordan in registers, the staging and the ragged last tile. What it
cannot show is a race on the asynchronous copies or anything of speed: the
card's check is `chip_smoke.py`. Needs a host C++17 compiler (g++); without
one the tests skip."""

import ctypes
import pathlib
import shutil
import subprocess

import pytest
import torch

from quaternion_mpc_tpu_torch import examples as tex
from quaternion_mpc_tpu_torch import scenarios as tscn
from quaternion_mpc_tpu_torch.control import quat_mpc as tq
from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs
from quaternion_mpc_tpu_torch.solver import al_ilqr as tal
from quaternion_mpc_tpu_torch.solver import fleet as tfl

import quaternion_mpc_tpu_torch

# the port makes its tensors on the card unless told otherwise; these tests run on the CPU
quaternion_mpc_tpu_torch.set_default_device("cpu")

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
SWEEP_OUTPUTS = ("Ks", "ds", "dV1", "dV2", "gmax")
# As on the card (chip_smoke.py): f64 against the plain sweep to 1e-10 of
# each output's largest magnitude (two orders of summation); f32 against the
# plain sweep in f64 on the same f32 expansions, gains to 1e-3 and the rest
# to 1e-4 (Quu carries Rd = 1e-6, which amplifies f32 rounding).
RTOL = {
    torch.float64: dict(Ks=1e-10, ds=1e-10, dV1=1e-10, dV2=1e-10, gmax=1e-10),
    torch.float32: dict(Ks=1e-3, ds=1e-3, dV1=1e-4, dV2=1e-4, gmax=1e-4),
}

_HARNESS = r"""
#include "cuda_emulation.h"
#include "riccati_sweep.cu"

template <class S, typename T>
static int run(const T* As, const T* Bs, const T* lxs, const T* lxxs, const T* lus,
               const T* luus, const T* luxs, const T* lxN, const T* lxxN, const T* reg, T* Ks,
               T* ds, T* dV1, T* dV2, T* gmax, int N, int B) {
  static_assert(Layout<S, T>::BYTES <= sizeof(smem_raw));
  return emulate_blocks((B + S::TILE - 1) / S::TILE, S::THREADS, riccati_sweep_kernel<S, T>, As,
                        Bs, lxs, lxxs, lus, luus, luxs, lxN, lxxN, reg, Ks, ds, dV1, dV2, gmax, N,
                        B);
}
// As the card's entries: the instantiation at (ne, nu, luxs != null); -1 for none.
#define ENTRY(name, T)                                                                      \
  extern "C" int name(int ne, int nu, const T* a, const T* b, const T* c, const T* d,      \
                      const T* e, const T* f, const T* x, const T* g, const T* h, const T* i, \
                      T* j, T* k, T* l, T* m, T* n, int N, int B) {                           \
    const bool lux = x != nullptr;                                                          \
    K1_SHAPES(CASE)                                                                         \
    return -1;                                                                              \
  }
#define CASE(E, U, X) \
  if (ne == E && nu == U && lux == X) return run<Shape<E, U, X>>(a, b, c, d, e, f, x, g, h, i, j, k, l, m, n, N, B);
ENTRY(sweep_f32, float)
ENTRY(sweep_f64, double)
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation with")
    work = tmp_path_factory.mktemp("sweep_emulation")
    (work / "harness.cpp").write_text(_HARNESS)
    lib = work / "sweep_emulation.so"
    subprocess.run(
        [compiler, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{HERE}",
         f"-I{rs.SOURCE.parent}", "-o", str(lib), str(work / "harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(lib))
    for name in ("sweep_f32", "sweep_f64"):
        getattr(lib, name).argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 15
                                       + [ctypes.c_int, ctypes.c_int])
        getattr(lib, name).restype = ctypes.c_int
    lib.riccati_sweep_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.riccati_sweep_shapes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def _launch(lib, args, luxs=None, size=None):
    """The emulated kernel at ``size`` (default: the inputs' own shape) on
    K1's inputs, the inputs embedded first where ``size`` is larger, as the
    wrapper launches on the card; returns the five outputs at the launch's
    size (NaN where the kernel wrote nothing) after checking that no block
    stopped at a barrier."""
    horizon, batch, dtype = args[0].shape[0], args[0].shape[-1], args[0].dtype
    ne, nu = args[0].shape[1], args[1].shape[2]
    size = size or (ne, nu)
    if size != (ne, nu):
        big = [t.contiguous() for t in rs.embed(*args, luxs=luxs, size=size)]
        args, luxs = big[:9], (None if luxs is None else big[9])
    nan = float("nan")
    outs = [torch.full((horizon, size[1], size[0], batch), nan, dtype=dtype),
            torch.full((horizon, size[1], batch), nan, dtype=dtype)]
    outs += [torch.full((batch,), nan, dtype=dtype) for _ in range(3)]
    fn = lib.sweep_f32 if dtype == torch.float32 else lib.sweep_f64
    pointers = [t.data_ptr() for t in args[:6]] + [None if luxs is None else luxs.data_ptr()]
    pointers += [t.data_ptr() for t in (*args[6:], *outs)]
    stuck = fn(*size, *pointers, horizon, batch)
    assert stuck == 0, f"at {size}: the block's threads stopped at barriers that never open ({stuck})"
    return outs


def _hold(got, args, dtype, luxs=None):
    """The emulated outputs against the plain sweep in f64 at the problem's
    own size, to RTOL."""
    want = rs.riccati_sweep_ref(*(t.double() for t in args),
                                luxs=None if luxs is None else luxs.double())
    for name, g, w in zip(SWEEP_OUTPUTS, got, want):
        assert g.shape == w.shape, name
        assert torch.isfinite(g).all(), f"{name}: an entry was never written"
        err = (g.double() - w).abs().max().item()
        assert err <= RTOL[dtype][name] * w.abs().max().item(), (name, err)
    return want


def _expansions(batch, horizon, dtype):
    """K1's inputs on the main path's first backward pass (standing_batch)."""
    spec = tq._fleet_spec()
    prob = tq.build_fleet_problem(*tex.standing_batch(batch, horizon, dtype, "cpu"), horizon)
    xs = tfl.open_loop_rollout(spec, prob, prob.us_init)
    lam = torch.zeros((horizon, prob.cb.shape[-2], batch), dtype=dtype)
    exps = tfl.knot_expansions(spec, prob, xs, prob.us_init, lam, torch.tensor(1.0, dtype=dtype))
    lxN, lxxN = tfl.terminal_expansion(spec, xs[-1], prob)
    reg = torch.full((batch,), 1e-8, dtype=dtype)
    return [t.contiguous() for t in (*exps, lxN, lxxN, reg)]


# (B, N): one warp of a block; a ragged single tile; two tiles, the second
# with one scenario; N=20 past two rounds of both stages; a single knot.
@pytest.mark.parametrize("batch, horizon", [(1, 3), (7, 4), (9, 10), (3, 20), (17, 1)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_matches_plain_sweep(emulated, dtype, batch, horizon):
    args = _expansions(batch, horizon, dtype)
    _hold(_launch(emulated, args), args, dtype)


def _first_pass(spec, prob, batch, dtype, seed=3):
    """K1's inputs on the first backward pass of a fleet of ``batch`` of a
    single problem from perturbed starts and inputs, at its own (ne, nu)."""
    g = torch.Generator().manual_seed(seed)
    x0 = prob.x0 + 0.05 * torch.randn((batch,) + prob.x0.shape, generator=g, dtype=dtype)
    us = prob.us_init + 0.3 * torch.randn((batch,) + prob.us_init.shape, generator=g, dtype=dtype)
    fprob = tal.lift_problem(tal.broadcast_problem(prob, batch)._replace(x0=x0, us_init=us))
    fspec = tal.fleet_spec(spec)
    xs = tfl.open_loop_rollout(fspec, fprob, fprob.us_init)
    horizon = us.shape[1]
    lam = torch.zeros((horizon, fprob.cb.shape[-2], batch), dtype=dtype)
    exps = tfl.knot_expansions(fspec, fprob, xs, fprob.us_init, lam,
                               torch.tensor(1.0, dtype=dtype))
    lxN, lxxN = tfl.terminal_expansion(fspec, xs[-1], fprob)
    reg = torch.full((batch,), 1e-8, dtype=dtype)
    return [t.contiguous() for t in (*exps, lxN, lxxN, reg)]


def _random_expansions(ne, nu, horizon, batch, dtype, seed=0):
    """Well-posed expansions at any (ne, nu): SPD lxx, luu, lxxN; contracting As."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    spd = lambda n, *lead: (lambda m: torch.einsum("...ikb,...jkb->...ijb", m, m)
                            + 0.5 * torch.eye(n)[..., None])(r(*lead, n, n, batch))
    out = (0.3 * r(horizon, ne, ne, batch) + torch.eye(ne)[..., None],
           0.2 * r(horizon, ne, nu, batch), r(horizon, ne, batch), spd(ne, horizon),
           r(horizon, nu, batch), spd(nu, horizon), r(ne, batch), spd(ne),
           torch.full((batch,), 1e-6, dtype=torch.float64))
    return [t.to(dtype).contiguous() for t in out]


def _problem_expansions(name, batch, horizon, dtype):
    """K1's inputs of the named problem at its own (ne, nu): a branch
    scenario's or a classic system's first backward pass, the mixed-row
    bicycle fleet's without its cross term, or "random 5x3", a shape with no
    instantiation of its own."""
    if name == "bicycle":
        fspec, fprob, lam, rho = tex.bicycle_mixed_rows(batch, horizon, dtype, "cpu")
        xs = tfl.open_loop_rollout(fspec, fprob, fprob.us_init)
        *exps, _ = tfl.knot_expansions_with_cross(fspec, fprob, xs, fprob.us_init, lam, rho)
        lxN, lxxN = tfl.terminal_expansion(fspec, xs[-1], fprob, lam, rho)
        return [t.contiguous() for t in (*exps, lxN, lxxN, torch.full((batch,), 1e-8,
                                                                       dtype=dtype))]
    if name == "random 5x3":
        return _random_expansions(5, 3, horizon, batch, dtype, seed=batch)
    if name in tscn.SCENARIOS:
        spec, prob, _ = tscn.SCENARIOS[name](N=horizon, dtype=dtype, device="cpu")
    else:
        spec, prob = tex.classic_problem(name, horizon, dtype, "cpu")
    return _first_pass(spec, prob, batch, dtype)


# (problem, ne, nu, B, N) at each instantiation below 12 x 12 (falling_cat:
# per-knot w, Qdf, autodiff Jacobians; the humanoid; the bicycle; the double
# integrator; the pendulum), and a 5 x 3 shape that the wrapper embeds in the
# 6 x 3 instantiation. Tiles of 8 (ne = 12), 32 (ne = 6) and 64 scenarios
# (ne <= 4): a ragged single tile, and two tiles whose second holds one
# scenario; N >= 4 uses both stages twice.
EMBEDDED_CASES = [("falling_cat", 6, 3, 9, 6), ("falling_cat", 6, 3, 33, 4),
                  ("humanoid", 12, 6, 3, 5), ("humanoid", 12, 6, 9, 4),
                  ("bicycle", 4, 2, 65, 4), ("double_integrator", 4, 2, 7, 6),
                  ("pendulum", 2, 1, 5, 4), ("random 5x3", 5, 3, 11, 5)]


@pytest.mark.parametrize("name, ne, nu, batch, horizon", EMBEDDED_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_on_embedded_problem(emulated, dtype, name, ne, nu, batch, horizon):
    """What the wrapper launches for a problem smaller than 12 x 12 (the
    instantiation at its own size, or `embed` into the smallest that holds
    it), with the device code itself, against the plain sweep at the
    problem's own size; and bit for bit against the 12 x 12 kernel on
    `embed`'s inputs: the instantiations add the live terms in the 12 x 12
    body's order, where the embedded launch adds exact zeros besides (g++
    contracts no multiply-add here)."""
    args = _problem_expansions(name, batch, horizon, dtype)
    assert args[0].shape == (horizon, ne, ne, batch) and args[1].shape == (horizon, ne, nu, batch)
    size = rs.instantiation(ne, nu)
    assert (size == (ne, nu)) == (name != "random 5x3")
    outs = _launch(emulated, args, size=size)
    Ks, ds = outs[0], outs[1]
    # the added rows and columns of an embedded launch couple to nothing
    assert torch.count_nonzero(Ks[:, nu:]) == 0 and torch.count_nonzero(Ks[:, :, ne:]) == 0
    assert torch.count_nonzero(ds[:, nu:]) == 0
    got = (Ks[:, :nu, :ne], ds[:, :nu], *outs[2:])
    _hold(got, args, dtype)
    big = _launch(emulated, args, size=(12, 12))
    for out, g, w in zip(SWEEP_OUTPUTS, got, (big[0][:, :nu, :ne], big[1][:, :nu], *big[2:])):
        assert torch.equal(g, w), out


def _state_row_expansions(batch, horizon, dtype):
    """K1's inputs, with the cross term lux, on a backward pass of a fleet of
    the bicycle (ne = 4, nu = 2) whose rows mix the state with the inputs."""
    fspec, fprob, lam, rho = tex.bicycle_mixed_rows(batch, horizon, dtype, "cpu")
    xs = tfl.open_loop_rollout(fspec, fprob, fprob.us_init)
    *exps, luxs = tfl.knot_expansions_with_cross(fspec, fprob, xs, fprob.us_init, lam, rho)
    lxN, lxxN = tfl.terminal_expansion(fspec, xs[-1], fprob, lam, rho)
    reg = torch.full((batch,), 1e-8, dtype=dtype)
    return [t.contiguous() for t in (*exps, lxN, lxxN, reg)], luxs.contiguous()


# (B, N): a ragged single tile; both stages used twice over; and two tiles
# of the 4 x 2 instantiation's 64 scenarios, the second ragged
@pytest.mark.parametrize("batch, horizon", [(5, 3), (9, 6), (67, 6)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_with_the_cross_term(emulated, dtype, batch, horizon):
    """The instantiation that stages the cost's cross term lux (Qux = lux +
    BᵀVxxA) at the bicycle's own 4 x 2, which the wrapper launches for a
    problem with state rows, against the plain sweep with the cross term at
    that size, and bit for bit against the same problem embedded in the
    12 x 12 instantiation with the cross term."""
    args, luxs = _state_row_expansions(batch, horizon, dtype)
    assert luxs.shape == (horizon, 2, 4, batch)
    live = torch.count_nonzero(luxs.abs().amax(dim=(1, 2)))  # (knot, scenario) pairs
    assert 0 < live < horizon * batch, "rows active in some knots and not in others"
    assert rs.instantiation(4, 2, lux=True) == (4, 2)
    got = _launch(emulated, args, luxs=luxs)
    want = _hold(got, args, dtype, luxs=luxs)
    without = rs.riccati_sweep_ref(*(t.double() for t in args))
    assert (want[0] - without[0]).abs().max() > 1e-3 * want[0].abs().max()
    big = _launch(emulated, args, luxs=luxs, size=(12, 12))
    for out, g, w in zip(SWEEP_OUTPUTS, got, (big[0][:, :2, :4], big[1][:, :2], *big[2:])):
        assert torch.equal(g, w), out


def test_shared_memory_fits_the_card(emulated):
    """A block's dynamic shared memory, as the layout computes it, at every
    instantiation: two f32 blocks and one f64 block (the launch bounds' minimum)
    fit an SM's 227 KB (232,448 bytes), each block with the 1 KB the system
    reserves; at 12 x 12 80,640 / 160,640 bytes, with the cross
    term's slab 90,880 / 179,072. The source builds exactly INSTANTIATIONS."""
    shapes = (ctypes.c_int * 64)()
    count = emulated.riccati_sweep_shapes(shapes, len(shapes))
    assert {(shapes[3 * i], shapes[3 * i + 1], bool(shapes[3 * i + 2]))
            for i in range(count)} == set(rs.INSTANTIATIONS) and count == len(rs.INSTANTIATIONS)
    smem = lambda is_f64, ne, nu, lux: emulated.riccati_sweep_smem_bytes(is_f64, ne, nu, lux)
    assert (smem(0, 12, 12, 0), smem(1, 12, 12, 0)) == (80_640, 160_640)
    assert (smem(0, 12, 12, 1), smem(1, 12, 12, 1)) == (90_880, 179_072)
    for ne, nu, lux in rs.INSTANTIATIONS:
        f32, f64 = smem(0, ne, nu, lux), smem(1, ne, nu, lux)
        assert 0 < f32 < f64, (ne, nu, lux)
        assert 2 * (f32 + 1024) <= 232_448 and f64 + 1024 <= 232_448, (ne, nu, lux, f32, f64)
    assert smem(0, 5, 3, 0) == -1, "no instantiation at 5 x 3"
