"""K7's device code on the CPU: `csrc/articulated.cu` compiles as plain C++
against `tests/cuda_emulation.h` and runs block by block on the wrapper's
packed rows (`kernels.articulated.pack` / `unpack`, the card's path), held
against the plain step (`sim.articulated.step(..., backend="plain")`, the
leg dynamics by torch.func where the kernel has closed forms) on seeded
states over flat, slope and stairs, with and without an external wrench,
joint gains (3,) and (4, 3), B in {1, 7, 9, 33} and one B over a full
block and a part of a second (`B_RAGGED`): four lanes a scenario, so the
lanes past the last scenario compute on a clamped index and take part in
every shuffle; one that returned early would leave its group's shuffles
waiting, which the emulation reports.

f64 agrees to 1e-9 of each leaf's scale after 80 substeps. f32 is held
against the f64 plain step on the same inputs to 1e-3 of scale (80
substeps of the stiff contact, 30 kN/m against legs of a few hundred grams,
leave f32 about 1e-5 of scale away) in every scenario where the plain step
run in f32 stays within that bound too. Where f32 rounding itself flips a
foot's stick / slip decision at the friction cone's edge, both f32 versions
leave the f64 one together (by up to 1e-2 of scale on the joint
velocities); there the kernel is held to the f32 plain step, to the same
1e-3, and such scenarios must stay rare.

The same device code, built on a number type that counts its operations,
gives `kernels.articulated.FLOPS_PER_SUBSTEP` (the kernel's bound): the
kernel's phase stamps (`K7_STAMP`) split each lane's operations by phase, and
one scenario's substep is counted with the torso once and each leg once.
Needs a host C++17 compiler (g++); without one the tests skip."""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from quaternion_mpc_tpu_torch.control import quat_mpc as tq
from quaternion_mpc_tpu_torch.control import torque as ttorque
from quaternion_mpc_tpu_torch.kernels import articulated as k7
from quaternion_mpc_tpu_torch.ops import lie as tlie
from quaternion_mpc_tpu_torch.sim import articulated as tart
from quaternion_mpc_tpu_torch.sim import plant as tplant
from quaternion_mpc_tpu_torch.sim import terrain as tterrain
from quaternion_mpc_tpu_torch.utils import config as tcfg
from quaternion_mpc_tpu_torch.utils.tree import tile, tree_leaves, tree_map

import quaternion_mpc_tpu_torch

# the port makes its tensors on the card unless told otherwise; these tests run on the CPU
quaternion_mpc_tpu_torch.set_default_device("cpu")

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
F64 = torch.float64
N_SUB = 80
B_RAGGED = k7.THREADS // 4 + 3  # a full block and three scenarios of a second
B_MAX = max(33, B_RAGGED)
TOL = {torch.float64: 1e-9, torch.float32: 1e-3}

_HARNESS = r"""
#include "cuda_emulation.h"

// A number that counts the floating-point operations done on it, in the
// counter of the (emulated) thread that does them: each add, subtract,
// multiply, divide, min, max, square root, sine, cosine, exponential and floor
// once; negation and comparison not at all.
static long long flops[1024];
struct Counted {
  double v;
  Counted() = default;
  template <typename A>
  explicit Counted(A a) : v(static_cast<double>(a)) {}
  explicit operator int() const { return static_cast<int>(v); }
};
inline Counted counted(double v) {
  Counted c;
  c.v = v;
  return c;
}
inline void tick() { ++flops[threadIdx.x]; }
inline Counted operator+(Counted a, Counted b) { tick(); return counted(a.v + b.v); }
inline Counted operator-(Counted a, Counted b) { tick(); return counted(a.v - b.v); }
inline Counted operator*(Counted a, Counted b) { tick(); return counted(a.v * b.v); }
inline Counted operator/(Counted a, Counted b) { tick(); return counted(a.v / b.v); }
inline Counted operator-(Counted a) { return counted(-a.v); }
inline bool operator>(Counted a, Counted b) { return a.v > b.v; }
inline bool operator<(Counted a, Counted b) { return a.v < b.v; }
inline bool operator>=(Counted a, Counted b) { return a.v >= b.v; }
inline void k_sincos(Counted a, Counted& s, Counted& c) {
  flops[threadIdx.x] += 2;
  s = counted(std::sin(a.v));
  c = counted(std::cos(a.v));
}
inline Counted k_sqrt(Counted a) { tick(); return counted(std::sqrt(a.v)); }
inline Counted k_exp(Counted a) { tick(); return counted(std::exp(a.v)); }
inline Counted k_floor(Counted a) { tick(); return counted(std::floor(a.v)); }
inline Counted k_min(Counted a, Counted b) { tick(); return a.v < b.v ? a : b; }
inline Counted k_max(Counted a, Counted b) { tick(); return a.v > b.v ? a : b; }
// A shuffle moves the value, not its count (the emulation's exchange holds doubles).
inline Counted __shfl_xor_sync(unsigned mask, Counted value, int lane_mask) {
  return counted(__shfl_xor_sync(mask, value.v, lane_mask));
}

// K7_STAMP(phase, values...): the operations since the thread's previous
// stamp go to that phase.
static long long stamped[1024], by_phase[1024][8];
#define K7_STAMP(phase, ...)                                              \
  do {                                                                    \
    by_phase[threadIdx.x][phase] += flops[threadIdx.x] - stamped[threadIdx.x]; \
    stamped[threadIdx.x] = flops[threadIdx.x];                            \
  } while (0)

#include "articulated.cu"

template <typename T>
static int run(const T* s, const T* t, const T* p, T* o, int n_sub, int B) {
  return emulate_blocks((B + SCENARIOS - 1) / SCENARIOS, THREADS, articulated_kernel<T>, s, t, p,
                        o, n_sub, B);
}
extern "C" int step_f32(const float* s, const float* t, const float* p, float* o, int n_sub,
                        int B) {
  return run<float>(s, t, p, o, n_sub, B);
}
extern "C" int step_f64(const double* s, const double* t, const double* p, double* o,
                        int n_sub, int B) {
  return run<double>(s, t, p, o, n_sub, B);
}
extern "C" int block_threads() { return THREADS; }
// The operations of n_sub substeps of one scenario (B = 1), by lane (the
// scenario's four, then the idle ones) and phase: out[lane * PHASES + phase].
extern "C" int count_flops(const double* s, const double* t, const double* p, int n_sub,
                           long long* out) {
  std::vector<Counted> cs(STATE), ct(TARGETS), cp(PARAMS), co(STATE);
  for (int i = 0; i < STATE; ++i) cs[i] = Counted(s[i]);
  for (int i = 0; i < TARGETS; ++i) ct[i] = Counted(t[i]);
  for (int i = 0; i < PARAMS; ++i) cp[i] = Counted(p[i]);
  std::memset(flops, 0, sizeof(flops));
  std::memset(stamped, 0, sizeof(stamped));
  std::memset(by_phase, 0, sizeof(by_phase));
  if (run<Counted>(cs.data(), ct.data(), cp.data(), co.data(), n_sub, 1) != 0) return 1;
  for (int lane = 0; lane < THREADS; ++lane)
    for (int phase = 0; phase < PHASES; ++phase) out[lane * PHASES + phase] = by_phase[lane][phase];
  return 0;
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation with")
    work = tmp_path_factory.mktemp("articulated_emulation")
    (work / "harness.cpp").write_text(_HARNESS)
    lib = work / "articulated_emulation.so"
    subprocess.run(
        [compiler, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{HERE}",
         f"-I{k7.SOURCE.parent}", "-o", str(lib), str(work / "harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(lib))
    for name in ("step_f32", "step_f64"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    lib.count_flops.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    lib.count_flops.restype = ctypes.c_int
    lib.block_threads.restype = ctypes.c_int
    lib.articulated_widths.argtypes = [ctypes.c_void_p]
    return lib


def _emulated_step(lib, s, tg, p, dt_ctrl, n_sub, ext):
    """The wrapper's launch with the emulated kernel in place of the card's."""
    lead = tuple(s.q.shape[:-2])
    state, targets, params = k7.pack(s, tg, p, dt_ctrl, ext)
    out = torch.full_like(state, float("nan"))
    fn = lib.step_f64 if state.dtype == torch.float64 else lib.step_f32
    assert fn(state.data_ptr(), targets.data_ptr(), params.data_ptr(), out.data_ptr(), n_sub,
              state.shape[0]) == 0
    return k7.unpack(out, lead)


def _case(seed, kp_per_leg, push):
    """B_MAX scenarios (f64): the Go1 plant on flat, slope and stairs in
    turn, standing near the surface with perturbed joints and rates, the
    anchors near the feet (a far one slips), targets around the joints."""
    rng = np.random.default_rng(seed)
    b = B_MAX
    t = lambda a: torch.tensor(np.asarray(a), dtype=F64)
    wts = tq.weights_from_config(tcfg.gazebo_go1_quat_mpc(), dtype=F64, device="cpu")
    kinds = ("flat", "slope", "stairs")
    worlds = [tterrain.make_terrain(kinds[i % 3], dtype=F64, device="cpu") for i in range(b)]
    tp = tterrain.TerrainParams(*(torch.stack(parts) for parts in zip(*worlds)))
    ap = tart.default_params(wts.mass, wts.inertia, wts.com_offset, wts.trunk_mass, tp, F64,
                             "cpu")
    # every parameter per scenario, so that the first rows are a smaller case
    ap = ap._replace(**{f: tile(getattr(ap, f), b) for f in ap._fields if f != "terrain"})
    if kp_per_leg:
        gains = t(1.0 + 0.1 * rng.random((b, 4, 3)))
        ap = ap._replace(kp_joint=ap.kp_joint[:, None, :] * gains,
                         kd_joint=ap.kd_joint[:, None, :] * gains)
    base = tart.init_state(dtype=F64, device="cpu")
    x = t(rng.uniform(0.05, 0.95, b))
    ground = tterrain.height(tp, torch.stack([x, torch.zeros_like(x)], -1))
    torso = tplant.PlantState(
        pos=torch.stack([x, t(rng.normal(0, 0.02, b)), ground + t(rng.uniform(0.27, 0.31, b))],
                        -1),
        quat=tlie.euler_to_quat(t(0.08 * rng.standard_normal((b, 3)))),
        vel=t(rng.normal(0, 0.3, (b, 3))), omega=t(rng.normal(0, 0.4, (b, 3))),
    )
    s = tart.ArticulatedState(torso=torso, q=base.q + t(rng.normal(0, 0.08, (b, 4, 3))),
                              dq=t(rng.normal(0, 1.5, (b, 4, 3))), anchor=base.anchor)
    anchor = tart.foot_kinematics(s, ap)[1] + t(rng.normal(0, 0.002, (b, 4, 3)))
    s = s._replace(anchor=anchor + t(np.array([0.0, 0.05, 0.0, 0.0])[:, None]))
    tg = ttorque.JointTargets(q=s.q + t(rng.normal(0, 0.05, (b, 4, 3))),
                              dq=t(rng.normal(0, 0.5, (b, 4, 3))),
                              tau=t(rng.normal(0, 4.0, (b, 4, 3))))
    ext = None
    if push:
        ext = tplant.ExtWrench(force_world=t(rng.normal(0, 20.0, (b, 3))),
                               torque_body=t(rng.normal(0, 2.0, (b, 3))))
    return s, tg, ap, wts.h.expand(b).clone(), ext


_PLAIN = {}


def _plain(case_key, dtype=F64):
    """The plain step at n_sub = 80 of a case in ``dtype``, computed once."""
    if (case_key, dtype) not in _PLAIN:
        s, tg, ap, dt_ctrl, ext = (_rows(x, B_MAX, dtype) for x in _case(*case_key))
        _PLAIN[case_key, dtype] = tart.step(s, tg, ap, dt_ctrl, N_SUB, ext, backend="plain")
    return _PLAIN[case_key, dtype]


def _rows(tree, b, dtype=None):
    """The first b scenarios of a tree, cast to dtype."""
    def take(a):
        a = a[:b] if a.dim() > 0 else a
        return a.to(dtype) if dtype is not None and a.is_floating_point() else a
    return tree_map(take, tree)


def _errors(got, want):
    """Per scenario, the largest error of any leaf over that leaf's scale."""
    errs = []
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        w = w.to(F64)
        scale = max(1.0, float(w.abs().max()))
        errs.append((g.to(F64) - w).abs().reshape(w.shape[0], -1).amax(dim=1) / scale)
    return torch.stack(errs).amax(dim=0)


def _close(got, want, tol):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        scale = max(1.0, float(w.abs().max()))
        err = float((g.to(F64) - w).abs().max())
        assert err <= tol * scale, (err, scale, tuple(w.shape))


@pytest.mark.parametrize("batch", [1, 7, 9, 33, B_RAGGED])
@pytest.mark.parametrize("kp_per_leg", [False, True], ids=["kp3", "kp4x3"])
@pytest.mark.parametrize("push", [False, True], ids=["free", "push"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_matches_plain_step(emulated, dtype, push, kp_per_leg, batch):
    key = (11 + 2 * push + kp_per_leg, kp_per_leg, push)
    s, tg, ap, dt_ctrl, ext = (_rows(x, batch, dtype) for x in _case(*key))
    got = _emulated_step(emulated, s, tg, ap, dt_ctrl, N_SUB, ext)
    assert all(leaf.dtype == dtype for leaf in tree_leaves(got))
    want = _rows(_plain(key), batch)
    if dtype == torch.float64:
        _close(got, want, TOL[dtype])
        return
    plain32 = _rows(_plain(key, torch.float32), batch)
    flipped = _errors(plain32, want) > TOL[dtype]  # f32 itself leaves f64 there
    assert int(flipped.sum()) <= max(1, batch // 10)
    err = torch.where(flipped, _errors(got, plain32), _errors(got, want))
    assert float(err.max()) <= TOL[dtype], err


def test_emulated_kernel_takes_shared_parameters_and_one_robot(emulated):
    """An unbatched robot with scalar parameters and a Python-float period
    packs into one row and matches the plain step."""
    s, tg, ap, _, _ = _case(17, False, False)
    one = lambda tree: _rows(tree, 1)
    s1, tg1 = tree_map(lambda a: a[0], one(s)), tree_map(lambda a: a[0], one(tg))
    ap1 = tree_map(lambda a: a[0], one(ap))
    got = _emulated_step(emulated, s1, tg1, ap1, 0.01, 8, None)
    want = tart.step(s1, tg1, ap1, 0.01, 8, backend="plain")
    assert got.q.shape == (4, 3) and got.torso.pos.shape == (3,)
    _close(got, want, 1e-11)


def _flops_by_phase(lib, rows, n_sub):
    """One scenario's operations over n_sub substeps, (lanes, phases)."""
    out = np.zeros((k7.THREADS, len(k7.PHASES)), dtype=np.int64)
    assert lib.count_flops(*(r.data_ptr() for r in rows), n_sub, out.ctypes.data) == 0
    return out


def test_flop_count_matches_the_device_code(emulated):
    """`FLOPS_PER_SUBSTEP` is what the device code does in one scenario's
    substep, the same in and out of contact (the branches are selects): the
    attitude and the torso's update of one lane (every lane of the scenario
    repeats them), each of the four lanes' leg (kinematics and contact, leg
    dynamics), and the sums over the legs as a sum of four terms, 3 adds a
    value (the butterfly does 2 in each lane)."""
    widths = (ctypes.c_int * 3)()
    emulated.articulated_widths(widths)
    assert tuple(widths) == (k7.STATE, k7.TARGETS, k7.PARAMS)
    assert emulated.block_threads() == k7.THREADS
    ph = {name: i for i, name in enumerate(k7.PHASES)}
    s, tg, ap, dt_ctrl, ext = _case(19, True, True)
    state, targets, params = k7.pack(s, tg, ap, dt_ctrl, ext)
    lifted = state.clone()
    lifted[:, 2] += 1.0  # every foot in the air
    for rows in (state, lifted):
        for i in range(3):
            scenario = (rows[i], targets[i], params[i])
            per = _flops_by_phase(emulated, scenario, 2) - _flops_by_phase(emulated, scenario, 1)
            legs, idle = per[:4], per[4:]
            # every lane repeats the torso and does one leg; the idle lanes compute too
            assert (legs == legs[0]).all() and (idle == legs[0]).all()
            values = 6  # Σ f_body and Σ foot x f_body
            assert legs[0, ph["sums"]] == values * 2  # the butterfly: offsets 1 and 2
            count = (legs[0, ph["attitude"]] + legs[:, ph["contact"]].sum()
                     + legs[:, ph["dynamics"]].sum() + values * 3 + legs[0, ph["torso"]])
            assert count == k7.FLOPS_PER_SUBSTEP
    work = k7.work(N_SUB, 64, torch.float32)
    assert work["flops"] == k7.FLOPS_PER_SUBSTEP * N_SUB * 64
    assert work["bytes"] == 64 * 4 * (2 * 49 + 36 + 231)
