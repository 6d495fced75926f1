"""K10, the walking tick's stage before the solve (`runtime.step._walking_pre`).

(a) The plain version (`runtime.step._walking_pre_plain`, what
`_walking_pre` runs on the CPU) against the JAX package's `pre`, composed here from the JAX
package's own functions exactly as `quaternion_mpc_tpu/runtime/step.py`
composes it (:996-1063, the estimated twin of :1516-1580, which with no
estimate is :1516-1580) and run under `jax.vmap`, f64, on carries built by
the JAX package and brought across by `_bridge`.

(b) K10's device code (`csrc/walking_pre.cu`) built with the host compiler
against `tests/cuda_emulation.h` and run through the wrapper's own tables
(`kernels.walking_pre.check`, `new_outputs`, `launch`, `assemble`: the
card's path), held against the plain version on the same inputs, f64 and
f32, its inputs left unchanged.

Cases: mixed flat, slope and stairs worlds with feet and footholds near the
stairs' riser edges; the contact schedule per knot and not; an estimate in
place of the plant's position and velocity; one unbatched robot; B=19 (the
kernel's groups of eight scenarios a warp with a ragged tail); mid-walk
gait states in which every transition of the FSM fires (stance to swing, a
swing's end, a segment wrap, a latched climb to a higher tread); window
filters empty, part full, full and wrapping (their idx and count set
directly); the sinusoidal attitude mode. Beside them, the device code alone:
every output written and no input at B = 1, 6 and 19; windows short enough
that a scenario's four lanes share fewer than four reduction lanes, held
against `utils/filters.window_update`; window buffers laid out with a gap
between scenarios or off a 16-byte boundary (the copies' other paths), bit for
bit against the common layout.

Bounds: every output to 1e-12 of its scale in f64 and 1e-6 in f32 (integer
and flag outputs exactly), except what follows the terrain's plane fit (its
coefficients, the filtered angle, the pitched attitude). The fit's normal
matrix WᵀW + 1e-6·I is singular but for the floor when two feet stand (a
trot): its condition number κ reaches 2e6, and any two orders of summation
part by rounding × κ (the JAX package and the port by up to 1.7e-12·κ of
scale). Those outputs are held to 1e-11·κ of scale in f64;
in f32, where rounding is of the floor's size, the kernel's error against
the f64 plain version must be within 4x the f32 plain version's own plus
1e-6 of scale (on the card the two are equal bit for bit: chip_smoke.py).
Needs a host C++17 compiler (g++) for (b); without one those tests skip."""

import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quaternion_mpc_tpu.control import goals as jgoals
from quaternion_mpc_tpu.control import quat_mpc as jq
from quaternion_mpc_tpu.control.types import RobotFeedback as JFeedback
from quaternion_mpc_tpu.gait import raibert as jraibert
from quaternion_mpc_tpu.gait import schedule as jsched
from quaternion_mpc_tpu.kin import terrain as jkterr
from quaternion_mpc_tpu.ops import lie as jlie
from quaternion_mpc_tpu.runtime import step as jrt
from quaternion_mpc_tpu.sim import terrain as jterrain
from quaternion_mpc_tpu.utils import config as jcfg
from quaternion_mpc_tpu_torch import _bridge
from quaternion_mpc_tpu_torch.kernels import walking_pre as k10
from quaternion_mpc_tpu_torch.runtime import step as trt
from quaternion_mpc_tpu_torch.utils.tree import tree_leaves, tree_map

import quaternion_mpc_tpu_torch

# the port makes its tensors on the card unless told otherwise; these tests run on the CPU
quaternion_mpc_tpu_torch.set_default_device("cpu")

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
F64 = jnp.float64
HORIZON = 10
GAIT_FREQ = 2.2
RISE, RUN, GRADE = 0.17, 0.30, 0.2
WINDOW = 100


def _stack(trees):
    return jax.tree.map(lambda *a: jnp.stack(a), *trees)


def _ground(kind, x):
    """sim/terrain.height in numpy."""
    xc = np.maximum(x, 0.0)
    return np.where(kind == 0, 0.0, np.where(kind == 1, GRADE * xc,
                                             RISE * np.floor(xc / RUN) * (x > 0)))


def _case(B, seed, *, fsm=False):
    """A JAX walking fleet of B robots on flat, slope and stairs worlds in
    mid-walk states drawn from ``seed``: (carry, sp, joy, est_pos, est_vel)
    as batch-leading JAX pytrees. ``fsm``: the robots' gait states set so
    that each FSM transition fires in some leg."""
    rng = np.random.default_rng(seed)
    kinds = np.arange(B) % 3
    names = ("flat", "slope", "stairs")
    wts = jq.weights_from_config(jcfg.gazebo_go1_quat_mpc(), dtype=F64)
    per = [jrt.init_walking_scenario(
        wts, dtype=F64, horizon=HORIZON,
        terrain=jterrain.make_terrain(names[k], slope_grade=GRADE, stair_rise=RISE,
                                      stair_run=RUN, dtype=F64))
        for k in kinds]
    carry, sp = _stack([p[0] for p in per]), _stack([p[1] for p in per])
    joy = _stack([jrt.neutral_joy(F64)] * B)

    # torso over the stairs' first risers, feet on the ground below them
    x = rng.uniform(-0.1, 1.2, B)
    pos = np.stack([x, rng.uniform(-0.2, 0.2, B), 0.3 + _ground(kinds, x)
                    + rng.uniform(-0.22, 0.05, B)], -1)
    quat = np.concatenate([np.ones((B, 1)), 0.08 * rng.standard_normal((B, 3))], -1)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    feet = pos[:, None, :] + np.asarray(jrt.GO1_DEFAULT_REL) + 0.03 * rng.standard_normal((B, 4, 3))
    # a foot a few mm either side of a riser edge
    feet[kinds == 2, 0, 0] = RUN * np.round(feet[kinds == 2, 0, 0] / RUN) \
        + rng.uniform(-0.01, 0.01, (kinds == 2).sum())
    feet[..., 2] = _ground(kinds[:, None], feet[..., 0]) + 0.005 * rng.standard_normal((B, 4))
    plant = carry.plant._replace(pos=jnp.asarray(pos), quat=jnp.asarray(quat),
                                 vel=jnp.asarray(0.3 * rng.standard_normal((B, 3))),
                                 omega=jnp.asarray(0.3 * rng.standard_normal((B, 3))))

    phase = rng.uniform(0.0, 1.0, (B, 4))
    seg_idx = rng.integers(0, 2, (B, 4))
    seg_start = phase - rng.uniform(0.0, 0.6, (B, 4))
    foothold = feet + 0.05 * rng.standard_normal((B, 4, 3))
    swing_start = feet + 0.02 * rng.standard_normal((B, 4, 3))
    if fsm:
        # trot rows: FL/RR stance then swing, FR/RL swing then stance (at 0.5)
        phase[:, 0], seg_idx[:, 0], seg_start[:, 0] = 0.499, 0, 0.0     # stance → swing
        phase[:, 1], seg_idx[:, 1], seg_start[:, 1] = 0.497, 0, 0.0     # swing ends
        phase[:, 2], seg_idx[:, 2], seg_start[:, 2] = 0.999, 1, 0.5     # stance wraps to 0
        phase[:, 3], seg_idx[:, 3], seg_start[:, 3] = 0.70, 1, 0.5      # mid-swing
        foothold[:, 3, 2] = swing_start[:, 3, 2] + RISE                 # a climb: latched
    gait = carry.gait._replace(
        phase=jnp.asarray(phase), seg_idx=jnp.asarray(seg_idx, jnp.int32),
        seg_start=jnp.asarray(seg_start), swing_start_pos=jnp.asarray(swing_start),
        target_pos=jnp.asarray(feet + 0.02 * rng.standard_normal((B, 4, 3))),
        target_vel=jnp.asarray(0.3 * rng.standard_normal((B, 4, 3))),
        target_acc=jnp.asarray(rng.standard_normal((B, 4, 3))),
        terrain_height=jnp.asarray(feet[..., 2] + 0.01 * rng.standard_normal((B, 4))),
        foothold=jnp.asarray(foothold))

    def window(shape):
        # empty, part full, full and about to wrap, full past the wrap
        count = rng.choice([0, 1, 37, WINDOW, WINDOW], shape)
        idx = np.where(count < WINDOW, count, rng.choice([WINDOW - 1, 13], shape))
        return jgoals.filters.WindowState(
            buf=jnp.asarray(0.1 * rng.standard_normal(shape + (WINDOW,))),
            idx=jnp.asarray(idx, jnp.int32), count=jnp.asarray(count, jnp.int32))

    qd = np.concatenate([np.ones((B, 1)), 0.08 * rng.standard_normal((B, 3))], -1)
    qd /= np.linalg.norm(qd, axis=-1, keepdims=True)
    goal = carry.goal._replace(
        torso_pos_d_world=jnp.asarray(pos + 0.05 * rng.standard_normal((B, 3))),
        quat_d=jnp.asarray(qd), vel_filter=window((B, 3)), pos_filter=window((B, 3)),
        attitude_count=jnp.asarray(rng.integers(0, 60, B), F64))
    angle = window((B,))
    terr = carry.terrain_est._replace(
        angle_filter=angle._replace(buf=jnp.abs(angle.buf)),
        terrain_angle=jnp.asarray(rng.uniform(-0.3, 0.3, B)))
    carry = carry._replace(plant=plant, feet_world=jnp.asarray(feet), gait=gait, goal=goal,
                           terrain_est=terr)
    joy = joy._replace(
        velx=jnp.asarray(rng.uniform(-0.3, 0.6, B)), vely=jnp.asarray(rng.uniform(-0.2, 0.2, B)),
        roll_rate=jnp.asarray(0.2 * rng.standard_normal(B)),
        pitch_rate=jnp.asarray(0.2 * rng.standard_normal(B)),
        yaw_rate=jnp.asarray(0.2 * rng.standard_normal(B)),
        sin_ang_vel=jnp.asarray(rng.uniform(size=B) < 0.3))
    est_pos = jnp.asarray(pos + 0.01 * rng.standard_normal((B, 3)))
    est_vel = jnp.asarray(0.3 * rng.standard_normal((B, 3)))
    return carry, sp, joy, est_pos, est_vel


def _jax_pre(pattern, per_knot_contacts, with_est):
    """The JAX package's `pre` (runtime/step.py:996-1063; with no estimate
    the fleet walking step's :1516-1580), one robot, for jax.vmap."""

    def pre(carry, sp, joy, est_pos, est_vel):
        ps = carry.plant
        dtype = ps.pos.dtype
        rot = jlie.quat_to_rotmat(ps.quat)
        foot_pos_body = (carry.feet_world - ps.pos) @ rot
        rho_fix = jrt._sp_rho_fix(sp, dtype)
        if not with_est:
            est_pos, est_vel = ps.pos, ps.vel
        contacts_now = jsched.contact_flags(carry.gait, pattern).astype(dtype)
        foot_vel_world_now = jnp.where(contacts_now[:, None] > 0.5, 0.0, carry.gait.target_vel)
        joint_pos, joint_vel = jrt._pinned_feet_joint_state(ps, foot_pos_body, foot_vel_world_now,
                                                            rho_fix)
        fbk = JFeedback(torso_pos_world=est_pos, torso_quat=ps.quat, torso_lin_vel_world=est_vel,
                        torso_ang_vel_body=ps.omega, foot_pos_body=foot_pos_body,
                        foot_contact=contacts_now, joint_pos=joint_pos.reshape(-1),
                        joint_vel=joint_vel.reshape(-1))
        vel_d_rel = jnp.stack([joy.velx, joy.vely, jnp.zeros_like(joy.velx)])
        default_rel = jrt._sp_default_rel(sp, dtype)
        target_world, _ = jraibert.foothold_targets(ps.pos, ps.quat, est_vel, vel_d_rel,
                                                    default_rel, GAIT_FREQ)
        target_world = jterrain.snap_to_ground(sp.terrain, target_world)
        gait = jsched.gait_update(carry.gait, pattern, sp.wts.h, jnp.asarray(GAIT_FREQ, dtype),
                                  carry.feet_world, target_world, contacts_now > 0.5)
        plan_contacts = jsched.contact_flags(gait, pattern).astype(dtype)
        mpc_contacts = plan_contacts
        if per_knot_contacts:
            mpc_contacts = jsched.predict_contact_schedule(
                gait, pattern, jnp.asarray(GAIT_FREQ, dtype), sp.wts.h, HORIZON + 1
            ).astype(dtype)
        goal, cmd = jgoals.goal_update(carry.goal, fbk, joy, mpc_contacts, dt=sp.wts.h)
        n_stance = jnp.maximum(jnp.sum(plan_contacts), 1.0)
        ground_z = jnp.sum(carry.feet_world[:, 2] * plan_contacts) / n_stance
        cmd = cmd._replace(pos_body_d=cmd.pos_body_d.at[2].set(
            ground_z + sp.target_height - est_pos[2]))
        terr_est, pitch_d = jkterr.terrain_update(
            carry.terrain_est, carry.feet_world - ps.pos, movement_mode=1,
            torso_height=est_pos[2] - ground_z, contact_weights=plan_contacts)
        eul_d = jlie.quat_to_euler(cmd.quat_d)
        cmd = cmd._replace(quat_d=jlie.euler_to_quat(
            jnp.stack([eul_d[0], eul_d[1] + pitch_d, eul_d[2]])))
        return fbk, cmd, goal, gait, plan_contacts, foot_pos_body, terr_est, ground_z

    return pre


# (name, B or None for one unbatched robot, seed, per_knot_contacts, estimate, FSM states)
CASES = [
    ("mixed", 6, 0, True, False, False),
    ("no_schedule", 6, 1, False, False, False),
    ("estimate", 6, 2, True, True, False),
    ("fsm", 6, 3, True, False, True),
    ("one_robot", None, 4, True, True, False),
    # three full groups of eight scenarios and a tail of three; every filter's
    # reduction 32 lanes wide (B=6's terrain filter is 64). At most seeds 19
    # draws put some leg at its workspace's edge (the knee folded to -pi or
    # stretched straight), where J⁻¹ magnifies rounding past these bounds
    # (seeds 5-13 and 15: joint_vel 1e-12 to 6e-12 of scale apart, port and
    # JAX; f32 1e-4); seed 14 puts none there
    ("nineteen", 19, 14, True, True, False),
]
IDS = [c[0] for c in CASES]

# the outputs that follow the terrain's plane fit, by their place in the
# flattened outputs (`_named_leaves`)
FIT_OUTPUTS = ("[1].quat_d", "[6].angle_filter.buf", "[6].terrain_angle", "[6].surf_coef")


def _named_leaves(tree, path=""):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree) for x in _named_leaves(v, f"{path}.{f}")]
    if isinstance(tree, tuple):
        return [x for i, v in enumerate(tree) for x in _named_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def _make_case(name, B, seed, per_knot, with_est, fsm):
    """The case's JAX inputs and outputs, and the port's inputs (f64)."""
    jc, jsp, jjoy, jest_pos, jest_vel = _case(B or 1, seed, fsm=fsm)
    pattern = jsched.trot_pattern()
    # eager, as jax.vmap alone runs it: XLA fuses multiply-adds under jax.jit,
    # and an out-of-reach foot's IK (acos at the workspace edge) magnifies that
    jout = jax.vmap(_jax_pre(pattern, per_knot, with_est))(jc, jsp, jjoy, jest_pos, jest_vel)
    carry, sp = _bridge.walking_carry(jc), _bridge.scenario_params(jsp)
    joy = _bridge.joy_command(jjoy)
    pat = _bridge.gait_pattern(pattern)
    est = (torch.from_numpy(np.array(jest_pos)), torch.from_numpy(np.array(jest_vel)))
    if B is None:  # one robot: every leaf without its batch axis
        one = lambda tree: tree_map(lambda t: t[0], tree)
        carry, sp, joy, est = one(carry), one(sp), one(joy), tuple(t[0] for t in est)
        jout = jax.tree.map(lambda a: a[0], jout)
    kw = dict(horizon=HORIZON, gait_freq=GAIT_FREQ, per_knot_contacts=per_knot,
              est_pos=est[0] if with_est else None, est_vel=est[1] if with_est else None)
    return dict(name=name, jax=jout, inputs=(carry, sp, joy, pat), kw=kw, fsm=fsm)


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    return _make_case(*request.param)


def _fit_kappa(carry, plan_contacts):
    """κ of each scenario's fit matrix WᵀW + 1e-6·I (f64): (B,) or ()."""
    rel = (carry.feet_world - carry.plant.pos[..., None, :]).double()
    w = plan_contacts.double()
    W = torch.stack([torch.ones_like(rel[..., 0]), rel[..., 0], rel[..., 1]], -1) * w[..., None]
    A = W.transpose(-1, -2) @ W + 1e-6 * torch.eye(3, dtype=torch.float64)
    return torch.linalg.cond(A)


def _err(got, want, kappa, path):
    """max |got − want| over the output's elements, relative to its scale;
    the fit's outputs divided by κ of their scenario (the largest κ for the
    leaves that have no batch axis of their own)."""
    both_nan = torch.isnan(got) & torch.isnan(want)
    d = torch.where(both_nan, 0.0, (got.double() - want.double()).abs())
    scale = torch.nan_to_num(want.double(), nan=0.0).abs().max().clamp(min=1e-300)
    if path in FIT_OUTPUTS:
        k = kappa.reshape(kappa.shape + (1,) * (d.dim() - kappa.dim()))
        d = d / k
    return float(d.max() / scale) if d.numel() else 0.0


def _hold(got, want, tol, kappa, what, fit_tol=None, f64_ref=None, plain=None):
    """Every output of ``got`` against ``want``: integers and flags equal,
    the rest within ``tol`` of scale; the fit's outputs within ``fit_tol``·κ
    of scale, or (``f64_ref``, ``plain``) within 4x the error of ``plain``
    against ``f64_ref`` plus ``tol`` of scale."""
    gl, wl = _named_leaves(tuple(got)), _named_leaves(tuple(want))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    refs = dict(_named_leaves(tuple(f64_ref))) if f64_ref is not None else {}
    plains = dict(_named_leaves(tuple(plain))) if plain is not None else {}
    for (path, g), (_, w) in zip(gl, wl):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path, g.shape, w.shape)
        if not g.is_floating_point():
            assert torch.equal(g, w), (what, path)
            continue
        assert torch.equal(torch.isnan(g), torch.isnan(w)), (what, path)
        if path in FIT_OUTPUTS and fit_tol is None:
            ref, p = refs[path].double(), plains[path].double()
            scale = ref.abs().max()
            mine = (g.double() - ref).abs().max()
            theirs = (p - ref).abs().max()
            assert mine <= 4 * theirs + tol * scale, (what, path, float(mine), float(theirs))
            continue
        err = _err(g, w, kappa, path) if path in FIT_OUTPUTS else _err(g, w, kappa, "")
        assert err <= (fit_tol if path in FIT_OUTPUTS else tol), (what, path, err)


def _cast(inputs, kw, dtype):
    """The case's port inputs in ``dtype`` (the pattern's switch times stay f64)."""
    carry, sp, joy, pat = inputs
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    kw = dict(kw, **{k: None if kw[k] is None else cast(kw[k]) for k in ("est_pos", "est_vel")})
    return (tree_map(cast, carry), tree_map(cast, sp), tree_map(cast, joy), pat), kw


def _gf(dtype):
    return torch.full((), GAIT_FREQ, dtype=dtype)


def test_plain_pre_matches_jax(case):
    (carry, sp, joy, pat), kw = case["inputs"], case["kw"]
    got = trt._walking_pre_plain(carry, sp, joy, pat, _gf(torch.float64), **kw)
    want = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), case["jax"])
    # the JAX package's feedback flattens the joints per robot alike; its
    # flags are bool where the port keeps the state's dtype: compare values
    want = tuple(tree_map(lambda w, g: w.to(g.dtype), w_, g_) for w_, g_ in zip(want, got))
    kappa = _fit_kappa(carry, got[4])
    _hold(got, want, 1e-12, kappa, f"{case['name']}: port vs JAX", fit_tol=1e-11)


def test_fsm_case_fires_every_transition():
    """The FSM case's legs: FL stance → swing, FR's swing ends, RL wraps
    past the cycle's end, RR's climb to a higher tread is latched."""
    case = _make_case(*CASES[IDS.index("fsm")])
    (carry, sp, joy, pat), kw = case["inputs"], case["kw"]
    out = trt._walking_pre_plain(carry, sp, joy, pat, _gf(torch.float64), **kw)
    gait = out[3]
    assert bool((gait.seg_idx[:, 0] == 1).all())  # FL now swings
    assert torch.equal(gait.swing_start_pos[:, 0], carry.feet_world[:, 0])
    assert bool((gait.seg_idx[:, 1] == 1).all())  # FR in stance
    assert bool((gait.seg_idx[:, 2] == 0).all() and (gait.phase[:, 2] < 0.1).all())  # wrapped
    assert torch.equal(gait.foothold[:, 3], carry.gait.foothold[:, 3])  # latched


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation with")
    work = tmp_path_factory.mktemp("walking_pre_emulation")
    (work / "harness.cpp").write_text('#include "cuda_emulation.h"\n#include "walking_pre.cu"\n')
    lib = work / "walking_pre_emulation.so"
    subprocess.run(
        [compiler, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", f"-I{HERE}",
         f"-I{k10.SOURCE.parent}", "-o", str(lib), str(work / "harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    return k10.bind(lib)


def _geometry(carry, sp):
    """The legs' geometry and stance as `runtime.step._walking_pre` hands
    them to the wrapper."""
    return dict(rho_fix=trt._sp_rho_fix(sp, carry.plant.pos),
                default_rel=trt._sp_default_rel(sp, carry.plant.pos))


def _emulated(lib, carry, sp, joy, pat, gf, kw):
    """The wrapper's launch with the emulated kernel in place of the card's;
    the outputs start as NaN / −7 so that anything left unwritten shows."""
    dtype = carry.plant.pos.dtype
    table, lead, sizes = k10.check(carry, sp, joy, pat, gf, **_geometry(carry, sp), **kw)
    out, out_int, (buf, buf_int) = k10.new_outputs(lead, sizes, dtype, torch.device("cpu"))
    buf.fill_(float("nan"))
    buf_int.fill_(-7)
    assert k10.launch(lib, table, sizes, out, out_int, dtype) == 0
    return k10.assemble(carry, out, out_int, kw["est_pos"], kw["est_vel"],
                        kw["per_knot_contacts"])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_matches_plain(emulated, case, dtype):
    (carry, sp, joy, pat), kw = _cast(case["inputs"], case["kw"], dtype)
    leaves = [t for tree in (carry, sp, joy, pat, kw["est_pos"], kw["est_vel"])
              for t in tree_leaves(tree)]
    before = [t.clone() for t in leaves]
    got = _emulated(emulated, carry, sp, joy, pat, _gf(dtype), kw)
    for b, a in zip(before, leaves):
        assert torch.equal(b, a), "the kernel wrote into an input"
    want = trt._walking_pre_plain(carry, sp, joy, pat, _gf(dtype), **kw)
    kappa = _fit_kappa(carry, want[4])
    what = f"{case['name']} {dtype}: kernel vs plain"
    if dtype == torch.float64:
        _hold(got, want, 1e-12, kappa, what, fit_tol=1e-11)
    else:
        (c64, s64, j64, p64), kw64 = _cast(case["inputs"], case["kw"], torch.float64)
        ref = trt._walking_pre_plain(c64, s64, j64, p64, _gf(torch.float64), **kw64)
        _hold(got, want, 1e-6, kappa, what, f64_ref=ref, plain=want)


def test_wrapper_takes_the_plain_version_on_the_cpu(case):
    (carry, sp, joy, pat), kw = case["inputs"], case["kw"]
    k10.walking_pre.launches = 0
    got = trt._walking_pre(carry, sp, joy, pat, _gf(torch.float64), **kw)
    want = trt._walking_pre_plain(carry, sp, joy, pat, _gf(torch.float64), **kw)
    assert k10.walking_pre.launches == 0
    for g, w in zip(_named_leaves(tuple(got)), _named_leaves(tuple(want))):
        assert torch.equal(g[1], w[1]), g[0]
    # the kernel's own wrapper runs on the card only
    with pytest.raises(ValueError, match="cuda"):
        k10.walking_pre(carry, sp, joy, pat, _gf(torch.float64), **_geometry(carry, sp), **kw)


def test_work_counts_every_input_once(case):
    (carry, sp, joy, pat), kw = case["inputs"], case["kw"]
    work = k10.work(carry, sp, joy, pat, _gf(torch.float64), **_geometry(carry, sp), **kw)
    B = carry.plant.pos.shape[0] if carry.plant.pos.dim() > 1 else 1
    # the three window buffers read and written, 8 bytes a slot
    assert work["bytes"] > B * 2 * 8 * 7 * WINDOW
    assert work["flops"] > 0


def _fill_launch(lib, table, sizes, out, out_int, bufs, dtype):
    """One emulated launch into outputs filled with NaN / −7 first."""
    bufs[0].fill_(float("nan"))
    bufs[1].fill_(-7)
    assert k10.launch(lib, table, sizes, out, out_int, dtype) == 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("B", [1, 6, 19])
def test_emulated_kernel_writes_every_output_and_no_input(emulated, B, dtype):
    """Every element of both output buffers is written (none left NaN where
    the plain version is finite, none left −7) and no input changes, at one
    robot, one ragged group and three groups with a tail."""
    case = _make_case(f"B{B}", B, 10 + B, True, B != 6, False)
    (carry, sp, joy, pat), kw = _cast(case["inputs"], case["kw"], dtype)
    leaves = [t for tree in (carry, sp, joy, pat, kw["est_pos"], kw["est_vel"])
              for t in tree_leaves(tree)]
    before = [t.clone() for t in leaves]
    table, lead, sizes = k10.check(carry, sp, joy, pat, _gf(dtype), **_geometry(carry, sp), **kw)
    out, out_int, bufs = k10.new_outputs(lead, sizes, dtype, torch.device("cpu"))
    _fill_launch(emulated, table, sizes, out, out_int, bufs, dtype)
    got = k10.assemble(carry, out, out_int, kw["est_pos"], kw["est_vel"], True)
    want = trt._walking_pre_plain(carry, sp, joy, pat, _gf(dtype), **kw)
    for (path, g), (_, w) in zip(_named_leaves(tuple(got)), _named_leaves(tuple(want))):
        if g.is_floating_point():
            assert torch.equal(torch.isnan(g), torch.isnan(w)), path
    assert not bool((bufs[1] == -7).any())
    for b, a in zip(before, leaves):
        assert torch.equal(b, a), "the kernel wrote into an input"


def _short_windows(carry, w, wt):
    """The carry with its goal filters cut to ``w`` slots and its terrain
    filter to ``wt`` (idx and count brought inside them)."""
    def cut(state, n):
        return state._replace(buf=state.buf[..., :n].contiguous(), idx=state.idx % n,
                              count=torch.clamp(state.count, max=n))

    goal = carry.goal._replace(vel_filter=cut(carry.goal.vel_filter, w),
                               pos_filter=cut(carry.goal.pos_filter, w))
    terr = carry.terrain_est._replace(angle_filter=cut(carry.terrain_est.angle_filter, wt))
    return carry._replace(goal=goal, terrain_est=terr)


def _hold_filter(old, new, mean, rows):
    """A filter's new state from the kernel against `utils/filters.
    window_update` of the value the kernel pushed (its new buffer at the old
    idx), exactly; its mean (``mean``) within 1e-12 of scale; on ``rows``."""
    from quaternion_mpc_tpu_torch.utils import filters

    pushed = torch.gather(new.buf, -1, old.idx[..., None].long())[..., 0]
    state, avg = filters.window_update(old, pushed)
    for a, b in zip(state, new):
        assert torch.equal(a[rows], b[rows])
    scale = avg[rows].abs().max().clamp(min=1e-300)
    assert float((avg[rows] - mean[rows]).abs().max() / scale) <= 1e-12


@pytest.mark.parametrize("windows", [(3, 2), (1, 20)], ids=["w3_wt2", "w1_wt20"])
def test_emulated_kernel_short_windows(emulated, windows):
    """Windows of 1-3 slots (PyTorch's reduction 1 or 2 lanes wide: fewer
    than a scenario's four lanes) and of 20 (16 lanes): the kernel against
    the plain version, and the goal's velocity and position filters and the
    terrain's angle filter, state and mean, against
    `utils/filters.window_update` of the value the kernel pushed."""
    case = _make_case("short", 6, 21, True, True, False)
    (carry, sp, joy, pat), kw = case["inputs"], case["kw"]
    carry = _short_windows(carry, *windows)
    got = _emulated(emulated, carry, sp, joy, pat, _gf(torch.float64), kw)
    want = trt._walking_pre_plain(carry, sp, joy, pat, _gf(torch.float64), **kw)
    _hold(got, want, 1e-12, _fit_kappa(carry, want[4]), "short windows", fit_tol=1e-11)

    _, cmd, goal, _, _, _, terr, ground_z = got
    every = slice(None)
    _hold_filter(carry.goal.vel_filter, goal.vel_filter, cmd.lin_vel_body_d, every)
    # the position command's third value is the height over the ground
    _hold_filter(carry.goal.pos_filter, goal.pos_filter,
                 torch.cat([cmd.pos_body_d[..., :2], _filter_mean(goal.pos_filter)[..., 2:]], -1),
                 every)
    active = (kw["est_pos"][..., 2] - ground_z) > 0.1
    assert bool(active.any())
    old = carry.terrain_est.angle_filter
    _hold_filter(old, terr.angle_filter, _filter_mean(terr.angle_filter), active)
    angle = _filter_mean(terr.angle_filter)[active].clamp(-0.349, 0.349)
    assert float((terr.terrain_angle[active] - angle).abs().max()) <= 1e-12 * float(
        angle.abs().max())
    for a, b in zip(old, terr.angle_filter):  # unchanged where not active
        assert torch.equal(a[~active], b[~active])


def _filter_mean(state):
    """The masked mean of a filter's state."""
    slots = torch.arange(state.buf.shape[-1])
    return torch.sum(state.buf * (slots < state.count[..., None]), dim=-1) / state.count


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("layout", ["gap", "offset"])
def test_emulated_kernel_copies_at_any_layout(emulated, layout, dtype):
    """The window buffers with a gap between scenarios (a batch stride past
    their length: the copies a scenario at a time), or one element off a
    16-byte boundary with the outputs off it too (the copies an element at a
    time): every output bit for bit as with the common layout."""
    case = _make_case("layout", 19, 22, True, False, False)
    (carry, sp, joy, pat), kw = _cast(case["inputs"], case["kw"], dtype)
    table, lead, sizes = k10.check(carry, sp, joy, pat, _gf(dtype), **_geometry(carry, sp), **kw)
    out, out_int, bufs = k10.new_outputs(lead, sizes, dtype, torch.device("cpu"))
    _fill_launch(emulated, table, sizes, out, out_int, bufs, dtype)
    want = [t.clone() for t in bufs]

    def moved(t):
        flat = t.reshape(t.shape[0], -1)
        if layout == "gap":
            big = torch.full((flat.shape[0], flat.shape[1] + 5), float("nan"), dtype=t.dtype)
            big[:, :flat.shape[1]] = flat
            return big[:, :flat.shape[1]].view(t.shape)
        big = torch.full((flat.numel() + 1,), float("nan"), dtype=t.dtype)
        big[1:] = flat.reshape(-1)
        return big[1:].view(t.shape)

    goal, terr = carry.goal, carry.terrain_est
    carry = carry._replace(
        goal=goal._replace(vel_filter=goal.vel_filter._replace(buf=moved(goal.vel_filter.buf)),
                           pos_filter=goal.pos_filter._replace(buf=moved(goal.pos_filter.buf))),
        terrain_est=terr._replace(angle_filter=terr.angle_filter._replace(
            buf=moved(terr.angle_filter.buf))))
    table, lead, sizes = k10.check(carry, sp, joy, pat, _gf(dtype), **_geometry(carry, sp), **kw)
    stride = {name: bs for (name, _, _), (_, bs) in zip(k10.INPUTS, table)}
    if layout == "gap":
        assert stride["vel_buf"] == 3 * WINDOW + 5 and stride["angle_buf"] == WINDOW + 5
    out, out_int, bufs = k10.new_outputs(lead, sizes, dtype, torch.device("cpu"))
    if layout == "offset":
        shifted = torch.empty(bufs[0].numel() + 1, dtype=dtype)[1:]
        base = bufs[0].data_ptr()
        out = {name: shifted[(v.data_ptr() - base) // v.element_size():][:v.numel()].view(v.shape)
               for name, v in out.items()}
        bufs = (shifted, bufs[1])
    _fill_launch(emulated, table, sizes, out, out_int, bufs, dtype)
    ints = {4: torch.int32, 8: torch.int64}
    for g, w in zip(bufs, want):
        assert torch.equal(g.view(ints[g.element_size()]), w.view(ints[w.element_size()]))
