"""K11, the SRB plant's tick and what follows it (`runtime.step._srb_post`).

(a) The plain version (`runtime.step._srb_post_plain`, what `_srb_post` runs
on the CPU) against the JAX package's `post`, composed here from the JAX
package's own functions as `quaternion_mpc_tpu/runtime/step.py` composes it
(the walking steps' :1581-1616, :363-397; the standing steps' :1452-1471,
:182-200: `sim.plant.step` n_sub times, `control.safety.is_safe` /
`finite_state`, `sim.terrain.height`, `ops.lie.quat_to_euler` / `rotz`) and
run under `jax.vmap`, f64, every output within 1e-12 of its scale.

(b) K11's device code (`csrc/srb_post.cu`) built with the host compiler
against `tests/cuda_emulation.h` and run through the wrapper's own tables
(`kernels.srb_post.check`, `new_outputs`, `launch`, `assemble`: the card's
path), held against the plain version on the same inputs: f64 within 1e-12
of scale (on the CPU the plain version's einsums sum in the CPU's order, not
cuBLAS's), f32 within 1e-6; every output written (pre-filled with NaN), no
input written; the controller's batch-last forces, leaves every scenario
shares and a layout that must be copied, bit for bit against the common
layout.

Cases: the walking and the standing mode (n_sub 2, and 3, whose h / 3 is a
product with a rounded reciprocal); with and without a push (`ExtWrench`);
zero and emulated joint velocities; flat, slope and stairs worlds; a
scenario already dead, one whose forces are not finite, one tipped past
1 rad of roll, one under the floor (walking), one with a joint at 35 rad/s;
B = 1, 7, 19, 37 (five warps of eight scenarios, the last part-filled) and
one unbatched robot; every output written whatever the buffers held before,
at B = 1, 7, 19 and 37. Needs a host C++17 compiler (g++) for (b); without
one those tests skip."""

import pathlib
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quaternion_mpc_tpu.control import safety as jsafety
from quaternion_mpc_tpu.ops import lie as jlie
from quaternion_mpc_tpu.sim import plant as jplant
from quaternion_mpc_tpu.sim import terrain as jterrain
from quaternion_mpc_tpu_torch.kernels import srb_post as k11
from quaternion_mpc_tpu_torch.runtime import step as trt
from quaternion_mpc_tpu_torch.sim import plant as tplant
from quaternion_mpc_tpu_torch.sim import terrain as tterrain
from quaternion_mpc_tpu_torch.utils.tree import tree_leaves, tree_map

import quaternion_mpc_tpu_torch

# the port makes its tensors on the card unless told otherwise; these tests run on the CPU
quaternion_mpc_tpu_torch.set_default_device("cpu")

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
RISE, RUN, GRADE = 0.17, 0.30, 0.2
GO1_FEET = np.array([[0.19, 0.13, -0.3], [0.19, -0.13, -0.3],
                     [-0.19, 0.13, -0.3], [-0.19, -0.13, -0.3]])


def _ground(kind, x):
    """sim/terrain.height in numpy."""
    xc = np.maximum(x, 0.0)
    return np.where(kind == 0, 0.0, np.where(kind == 1, GRADE * xc,
                                             RISE * np.floor(xc / RUN) * (x > 0)))


def _quat(rpy):
    """ZYX Euler angles (B, 3) to quaternions [w, x, y, z]."""
    cr, sr = np.cos(rpy[:, 0] / 2), np.sin(rpy[:, 0] / 2)
    cp, sp = np.cos(rpy[:, 1] / 2), np.sin(rpy[:, 1] / 2)
    cy, sy = np.cos(rpy[:, 2] / 2), np.sin(rpy[:, 2] / 2)
    return np.stack([cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
                     cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr], -1)


def _draw(B, seed, walking, ext, jv):
    """A case's inputs as numpy arrays (batch-leading, f64), drawn from
    ``seed``: mid-trot robots on flat, slope and stairs, with the special
    scenarios of the module's docstring where B allows."""
    rng = np.random.default_rng(seed)
    kind = np.arange(B) % 3
    x = rng.uniform(-0.1, 1.2, B)
    pos = np.stack([x, rng.uniform(-0.2, 0.2, B), 0.3 + _ground(kind, x)
                    + rng.uniform(-0.03, 0.03, B)], -1)
    rpy = 0.1 * rng.standard_normal((B, 3))
    grf = np.concatenate([rng.normal(0, 3, (B, 4, 2)), rng.normal(32, 5, (B, 4, 1))], -1)
    d = dict(
        pos=pos, vel=0.3 * rng.standard_normal((B, 3)), omega=0.3 * rng.standard_normal((B, 3)),
        alive=np.ones(B, bool), grf=grf,
        foot_pos_body=GO1_FEET + 0.02 * rng.standard_normal((B, 4, 3)),
        mass=12.84 + 0.3 * rng.standard_normal(B),
        com_offset=0.01 * rng.standard_normal((B, 3)), com_mass=5.2 + 0.1 * rng.standard_normal(B),
        h=0.01 + 0.001 * rng.uniform(size=B), target_height=0.3 + 0.02 * rng.uniform(size=B),
    )
    off = 0.005 * rng.standard_normal((B, 3, 3))
    d["inertia"] = np.diag([0.0168, 0.0565, 0.0647])[None] + (off + off.transpose(0, 2, 1)) / 2
    if ext:
        d["ext_force"] = rng.normal(0, 20, (B, 3))
        d["ext_torque"] = rng.normal(0, 1, (B, 3))
    if jv:
        d["joint_vel"] = rng.uniform(-21, 21, (B, 12))
    if walking:
        d["plan_contacts"] = (rng.uniform(size=(B, 4)) < 0.6).astype(float)
        feet = pos[:, None, :] + GO1_FEET + 0.03 * rng.standard_normal((B, 4, 3))
        feet[..., 2] = _ground(kind[:, None], feet[..., 0])
        d["feet_world"] = feet
        d["target_pos"] = feet + 0.05 * rng.standard_normal((B, 4, 3))
        d["kind"] = kind.astype(np.int32)
        d["grade"], d["rise"], d["run"] = (np.full(B, v) for v in (GRADE, RISE, RUN))
        d["velx"] = rng.uniform(-0.3, 0.6, B)
        d["ground_z"] = _ground(kind, x) + 0.01 * rng.standard_normal(B)
    else:
        d["quat_d"] = _quat(0.05 * rng.standard_normal((B, 3)))
    if B >= 7:
        d["alive"][1] = False                     # already dead
        d["grf"][2, 1, 2] = np.nan                # diverges
        rpy[3, 0] = 1.3                           # tipped past the roll limit
        if walking:  # 4.5 cm over the terrain: under the 5 cm floor
            d["pos"][4, 2] = _ground(kind[4], x[4]) + 0.045
            d["vel"][4] = 0.0
        if jv:
            d["joint_vel"][5, 7] = 35.0           # a joint past 30 rad/s
    d["quat"] = _quat(rpy)
    return d


def _torch_inputs(d, walking, n_sub, dtype=torch.float64):
    """The port's arguments of `_srb_post` from a case's arrays."""
    t = lambda k: torch.from_numpy(np.asarray(d[k])).to(dtype)
    ps = tplant.PlantState(t("pos"), t("quat"), t("vel"), t("omega"))
    pp = tplant.PlantParams(mass=t("mass"), inertia=t("inertia"), com_offset=t("com_offset"),
                            com_mass=t("com_mass"), foot_pos_body=t("foot_pos_body"))
    kw = dict(ext=tplant.ExtWrench(t("ext_force"), t("ext_torque")) if "ext_force" in d else None,
              joint_vel=t("joint_vel") if "joint_vel" in d else None)
    if walking:
        tp = tterrain.TerrainParams(torch.from_numpy(d["kind"]), t("grade"), t("rise"), t("run"),
                                    torch.full(d["kind"].shape, 9.81, dtype=dtype))
        kw["walk"] = k11.WalkingPostIn(t("plan_contacts"), t("feet_world"), t("target_pos"), tp,
                                       t("velx"), t("ground_z"))
    else:
        kw["quat_d"], kw["n_sub"] = t("quat_d"), n_sub
    return (ps, torch.from_numpy(d["alive"]), t("grf"), pp, t("h"), t("target_height")), kw


def _map(fn, args, kw):
    """``fn`` on every tensor of `_srb_post`'s (args, keywords)."""
    f = lambda t: fn(t) if isinstance(t, torch.Tensor) else t
    return tuple(tree_map(f, a) for a in args), {k: tree_map(f, v) for k, v in kw.items()}


def _jax_post(walking, n_sub, with_ext, with_jv):
    """The JAX package's post of one robot (see the module's docstring)."""

    def post(d):
        ps = jplant.PlantState(d["pos"], d["quat"], d["vel"], d["omega"])
        pp = jplant.PlantParams(d["mass"], d["inertia"], d["com_offset"], d["com_mass"],
                                d["foot_pos_body"])
        ext = jplant.ExtWrench(d["ext_force"], d["ext_torque"]) if with_ext else None
        joint_vel = d["joint_vel"] if with_jv else jnp.zeros((12,), jnp.float64)
        if walking:
            f_body = d["grf"] * d["plan_contacts"][:, None]
            new = jplant.step(ps, f_body, pp, d["h"], ext)
        else:
            new = ps
            for _ in range(n_sub):
                new = jplant.step(new, d["grf"], pp, d["h"] / n_sub, ext)
        ok = jsafety.is_safe(new.quat, joint_vel) & jsafety.finite_state(new)
        if walking:
            tp = jterrain.TerrainParams(d["kind"], d["grade"], d["rise"], d["run"],
                                        jnp.asarray(9.81))
            ok = ok & (new.pos[2] - jterrain.height(tp, new.pos[:2]) > 0.05)
        alive = d["alive"] & ok
        kept = jax.tree.map(lambda a, b: jnp.where(alive, a, b), new, ps)
        out = dict(new_plant=new, plant=kept, alive=alive, alive_f=alive.astype(jnp.float64))
        if walking:
            yaw = jlie.quat_to_euler(kept.quat)[2]
            vel_rel = jlie.rotz(yaw).T @ kept.vel
            out.update(
                vel_err=jnp.abs(vel_rel[0] - d["velx"]),
                height_err=jnp.abs(kept.pos[2] - d["ground_z"] - d["target_height"]),
                f_body=f_body,
                feet_world=jnp.where(d["plan_contacts"][:, None] > 0.5, d["feet_world"],
                                     d["target_pos"]))
        else:
            out.update(height_err=jnp.abs(kept.pos[2] - d["target_height"]),
                       att_err=1.0 - jnp.abs(jnp.sum(kept.quat * d["quat_d"])))
        return out

    return post


# (name, B or None for one unbatched robot, seed, walking, n_sub, push, joint velocities)
CASES = [
    ("walk", 7, 0, True, 1, False, False),
    ("walk_push_jv", 19, 1, True, 1, True, True),
    ("walk_one", 1, 2, True, 1, True, False),
    ("walk_unbatched", None, 3, True, 1, True, True),
    ("stand", 7, 4, False, 2, False, False),
    ("stand_push_jv", 19, 5, False, 2, True, True),
    ("stand_three_substeps", 7, 6, False, 3, False, True),
    ("stand_unbatched", None, 7, False, 2, True, False),
    # five warps of eight scenarios, the last with five
    ("walk_warps_push_jv", 37, 14, True, 1, True, True),
    ("stand_warps_push_jv", 37, 15, False, 2, True, True),
]
IDS = [c[0] for c in CASES]


def _make_case(name, B, seed, walking, n_sub, push, jv):
    d = _draw(B or 1, seed, walking, push, jv)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    post = _jax_post(walking, n_sub, push, jv)
    if B is None:
        # one robot as the JAX package steps it (no vmap); the port's
        # per-scenario steps take it as a batch of one (`runtime.step._one_robot`)
        jout = jax.tree.map(lambda a: a[None], post({k: v[0] for k, v in jd.items()}))
    else:
        jout = jax.vmap(post)(jd)
    args, kw = _torch_inputs(d, walking, n_sub)
    return dict(name=name, jax=jout, args=args, kw=kw, walking=walking)


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    return _make_case(*request.param)


def _leaves(out):
    """An `SrbPost` as [(name, tensor)], the absent fields left out."""
    named = []
    for field, v in zip(out._fields, out):
        if isinstance(v, tplant.PlantState):
            named += [(f"{field}.{f}", x) for f, x in zip(v._fields, v)]
        elif v is not None:
            named.append((field, v))
    return named


# The metrics are differences of values of order one (1 − |q·q_d|, a height
# less the target, a velocity less the command), so their rounding is that of
# their terms: their scale is at least 1.
METRICS = ("height_err", "vel_err", "att_err")


def _hold(got, want, tol, what):
    """Every output of ``got`` against ``want`` (name -> tensor): flags equal,
    NaN where ``want`` has NaN, the rest within ``tol`` of its scale (of at
    least 1 for the metrics)."""
    assert [n for n, _ in got] == list(want), (what, [n for n, _ in got], list(want))
    for name, g in got:
        w = want[name]
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        if not g.is_floating_point():
            assert torch.equal(g, w.to(g.dtype)), (what, name)
            continue
        g, w = g.double(), w.double()
        assert torch.equal(torch.isnan(g), torch.isnan(w)), (what, name)
        scale = torch.nan_to_num(w, nan=0.0).abs().max().clamp(
            min=1.0 if name in METRICS else 1e-300)
        d = torch.nan_to_num((g - w).abs(), nan=0.0).max() if g.numel() else torch.zeros(())
        assert float(d / scale) <= tol, (what, name, float(d / scale))


def _want_from_jax(jout):
    want = {}
    for field in k11.SrbPost._fields:
        if field not in jout:
            continue
        v = jout[field]
        if isinstance(v, jplant.PlantState):
            want.update({f"{field}.{f}": torch.from_numpy(np.array(x))
                         for f, x in zip(v._fields, v)})
        else:
            want[field] = torch.from_numpy(np.array(v))
    return want


def test_plain_post_matches_jax(case):
    got = trt._srb_post_plain(*case["args"], **case["kw"])
    _hold(_leaves(got), _want_from_jax(case["jax"]), 1e-12, f"{case['name']}: port vs JAX")


def test_special_scenarios_are_masked():
    """The dead, diverged, tipped, under-the-floor and over-speed scenarios
    all end not alive and keep their old plant; the others live."""
    for walking in (True, False):
        case = _make_case("special", 19, 11, walking, 1 if walking else 2, True, True)
        out = trt._srb_post_plain(*case["args"], **case["kw"])
        dead = [1, 2, 3, 5] + ([4] if walking else [])
        assert not bool(out.alive[dead].any()) and bool(out.alive[6:].all())
        ps = case["args"][0]
        for kept, old in zip(out.plant, ps):
            assert torch.equal(kept[dead], old[dead])
        assert bool(torch.isnan(out.new_plant.pos[2]).any())


def test_wrapper_takes_the_plain_version_on_the_cpu(case):
    k11.srb_post.launches = 0
    got = trt._srb_post(*case["args"], **case["kw"])
    want = trt._srb_post_plain(*case["args"], **case["kw"])
    assert k11.srb_post.launches == 0
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        assert torch.equal(torch.nan_to_num(g, nan=7.0), torch.nan_to_num(w, nan=7.0)), name
    # the kernel's own wrapper runs on the card only
    with pytest.raises(ValueError, match="cuda"):
        k11.srb_post(*case["args"], **case["kw"])


def test_work_counts_every_input_once(case):
    work = k11.work(*case["args"], **case["kw"])
    B = case["args"][0].pos.shape[0] if case["args"][0].pos.dim() > 1 else 1
    # the plant's 13 values read and written twice, 8 bytes each
    assert work["bytes"] > B * 8 * 13 * 3
    assert work["flops"] > B * 400 * case["kw"].get("n_sub", 1)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    compiler = shutil.which("g++")
    if compiler is None:
        pytest.skip("no host C++ compiler (g++) to build the emulation with")
    work = tmp_path_factory.mktemp("srb_post_emulation")
    (work / "harness.cpp").write_text('#include "cuda_emulation.h"\n#include "srb_post.cu"\n')
    lib = work / "srb_post_emulation.so"
    subprocess.run(
        [compiler, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", f"-I{HERE}",
         f"-I{k11.SOURCE.parent}", "-o", str(lib), str(work / "harness.cpp")],
        check=True, capture_output=True, text=True,
    )
    return k11.bind(lib)


def _cast(args, kw, dtype):
    return _map(lambda t: t.to(dtype) if t.is_floating_point() else t, args, kw)


def _emulated(lib, args, kw, fill=True, value=float("nan")):
    """The wrapper's launch with the emulated kernel in place of the card's;
    the float outputs start as ``value`` (NaN: anything left unwritten
    shows) and alive as ``value`` != -7. Returns (the outputs as `SrbPost`,
    the two buffers)."""
    dtype = args[0].pos.dtype
    table, lead, sizes = k11.check(*args, **kw)
    out, alive, bufs = k11.new_outputs(lead, sizes, dtype, torch.device("cpu"))
    if fill:
        bufs[0].fill_(value)
        bufs[1].fill_(value != -7)
    assert k11.launch(lib, table, sizes, out, alive, dtype) == 0
    return k11.assemble(out, alive, sizes["walking"]), bufs


def _inputs(args, kw):
    return [t for x in (*args, *kw.values()) for t in tree_leaves(x)
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_matches_plain(emulated, case, dtype):
    args, kw = _cast(case["args"], case["kw"], dtype)
    before = [t.clone() for t in _inputs(args, kw)]
    got, bufs = _emulated(emulated, args, kw)
    for b, a in zip(before, _inputs(args, kw)):
        assert torch.equal(torch.nan_to_num(b, nan=7.0), torch.nan_to_num(a, nan=7.0)), \
            "the kernel wrote into an input"
    want = trt._srb_post_plain(*args, **kw)
    _hold(_leaves(got), dict(_leaves(want)), 1e-12 if dtype == torch.float64 else 1e-6,
          f"{case['name']} {dtype}: kernel vs plain")
    # every output written: NaN only where the plain version has NaN
    assert int(torch.isnan(bufs[0]).sum()) == sum(
        int(torch.isnan(w).sum()) for _, w in _leaves(want) if w.is_floating_point())


@pytest.mark.parametrize("walking", [True, False], ids=["walking", "standing"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_reads_any_layout(emulated, walking, dtype):
    """The controller's forces batch-last (a view of a (12, B) buffer, as the
    fleet controllers return them), the inertia and the push leaves every
    scenario shares, a flat world given as no terrain, and a foot layout one
    element stride cannot describe (copied): every output bit for bit as
    with the common layout."""
    case = _make_case("layout", 19, 12, walking, 1 if walking else 2, True, True)
    args, kw = _cast(case["args"], case["kw"], dtype)
    B = 19
    if walking:  # the flat world, for every scenario, as a world and as none
        tp = tterrain.make_terrain("flat", dtype=dtype, device="cpu")
        kw = dict(kw, walk=kw["walk"]._replace(terrain=tterrain.TerrainParams(
            *(torch.broadcast_to(t, (B,)).clone() for t in tp))))
    ps, alive, grf, pp, h, th = args
    shared_inertia = pp.inertia[0]
    shared_ext = tplant.ExtWrench(kw["ext"].force_world[0], kw["ext"].torque_body[0])
    common_pp = pp._replace(inertia=shared_inertia.expand(B, 3, 3).clone())
    common_kw = dict(kw, ext=tplant.ExtWrench(shared_ext.force_world.expand(B, 3).clone(),
                                              shared_ext.torque_body.expand(B, 3).clone()))
    want, _ = _emulated(emulated, (ps, alive, grf, common_pp, h, th), common_kw)

    grf_bl = torch.movedim(grf.reshape(B, 12), 0, -1).contiguous()  # (12, B)
    grf_view = torch.movedim(grf_bl, -1, 0).reshape(B, 4, 3)
    assert grf_view.stride() == (1, 3 * B, B)
    feet_t = pp.foot_pos_body.transpose(-1, -2).contiguous().transpose(-1, -2)  # (B, 4, 3), strides (12, 1, 4)
    moved_kw = dict(kw, ext=shared_ext)
    if walking:
        moved_kw["walk"] = kw["walk"]._replace(terrain=None)
    table, _, _ = k11.check(ps, alive, grf_view, pp._replace(inertia=shared_inertia,
                                                             foot_pos_body=feet_t),
                            h, th, **moved_kw)
    strides = {name: (bs, es) for (name, _, _), (_, bs, es) in zip(k11.INPUTS, table)}
    assert strides["grf"] == (1, B) and strides["inertia"] == (0, 1)
    assert strides["ext_force"] == (0, 1) and strides["foot_pos_body"] == (12, 1)
    if walking:
        assert strides["kind"][0] == 0
    got, _ = _emulated(emulated, (ps, alive, grf_view,
                                  pp._replace(inertia=shared_inertia, foot_pos_body=feet_t),
                                  h, th), moved_kw)
    ints = {4: torch.int32, 8: torch.int64, 1: torch.uint8}
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        assert torch.equal(g.contiguous().view(ints[g.element_size()]),
                           w.contiguous().view(ints[w.element_size()])), name

    # batch-first leaves as views one element into a buffer: not 16 bytes
    # aligned, read element by element
    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        return view

    moved_ps = tplant.PlantState(*(offset(t) for t in ps))
    moved_pp = pp._replace(foot_pos_body=offset(pp.foot_pos_body))
    moved_kw = dict(common_kw, joint_vel=offset(kw["joint_vel"]))
    if walking:
        w = kw["walk"]
        moved_kw["walk"] = w._replace(plan_contacts=offset(w.plan_contacts),
                                      feet_world=offset(w.feet_world),
                                      target_pos=offset(w.target_pos))
    moved, _ = _emulated(emulated, (moved_ps, alive, grf, moved_pp._replace(
        inertia=common_pp.inertia), h, th), moved_kw)
    for (name, g), (_, w) in zip(_leaves(moved), _leaves(want)):
        assert torch.equal(g.contiguous().view(ints[g.element_size()]),
                           w.contiguous().view(ints[w.element_size()])), f"offset view: {name}"


@pytest.mark.parametrize("B", [1, 7, 19, 37])
@pytest.mark.parametrize("walking", [True, False], ids=["walking", "standing"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_emulated_kernel_writes_every_output(emulated, B, walking, dtype):
    """The same outputs, bit for bit, whether the buffers held NaN and True
    or −7 and False before the launch (B = 37: five warps, the last with
    five scenarios), and no input written."""
    case = _make_case("written", B, 20 + B, walking, 1 if walking else 2, True, True)
    args, kw = _cast(case["args"], case["kw"], dtype)
    before = [t.clone() for t in _inputs(args, kw)]
    _, nan_fill = _emulated(emulated, args, kw)
    _, minus_fill = _emulated(emulated, args, kw, value=-7.0)
    for b, a in zip(before, _inputs(args, kw)):
        assert torch.equal(torch.nan_to_num(b, nan=7.0), torch.nan_to_num(a, nan=7.0)), \
            "the kernel wrote into an input"
    ints = {4: torch.int32, 8: torch.int64, 1: torch.uint8}
    for x, y in zip(nan_fill, minus_fill):
        assert torch.equal(x.view(ints[x.element_size()]), y.view(ints[y.element_size()]))


def test_emulated_kernel_takes_the_carry_of_one_robot(emulated):
    """One unbatched robot and B = 1 give the same bits."""
    case = _make_case("one", None, 13, True, 1, True, True)
    one, _ = _emulated(emulated, case["args"], case["kw"])
    batched, _ = _emulated(emulated, *_map(lambda t: t[None], case["args"], case["kw"]))
    for (name, g), (_, w) in zip(_leaves(one), _leaves(batched)):
        assert g.shape == w.shape[1:] and torch.equal(g, w[0]), name
