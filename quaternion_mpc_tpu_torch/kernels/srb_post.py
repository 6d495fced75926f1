"""K11: the SRB plant's tick and what follows it (`runtime/step`'s `post` of
the walking and standing steps: the plant's midpoint step(s), the walking
feet, the safety and divergence mask, the tick's metrics) as one
hand-written CUDA kernel.

Replaces the region XLA fused for the JAX package at
`quaternion_mpc_tpu/sim/plant.py:109` (`step`) with the `post` stages of
`quaternion_mpc_tpu/runtime/step.py` around it (:1581-1616, :1066-1195,
:363-397, :780-895, :1452-1471, :182-200, :575-610), under `jax.vmap`.
Eager PyTorch runs the plain version (`runtime.step._srb_post_plain`) as
~360 launches a walking tick at B = 4096 (PERF.md).

What bounds it on the H100: bytes (`work`: ~85 values read and ~55 written
a scenario); below that, one scenario's latency, as long at B = 1 as at
4096: its loads' round trip, then the chain of two evaluations of the
dynamics a substep, the mask's angles and the metric, 1,800-2,800
instructions issued once each by one warp.

Design (csrc/srb_post.cu): four lanes a scenario, eight a warp, a warp a
block. Every input is loaded before the first store; lane f is foot f (its
force, feet output and moment; the sums formed after shuffles), the chain
runs in every lane with its independent divisions (the inertia's inverse,
the velocity's rate, the renormalisation) and the mask's libdevice calls
dealt over the lanes, and each einsum picks its order by selects. Built
with -fmad=false (`FLAGS`), its operations round as the plain version's do
on the card: libdevice's functions, PyTorch's reduction order for each sum
and norm, torch.linalg.cross's fused terms, and cuBLAS's order for each
einsum product at the call's batch size and type (`CUBLAS_ORDERS`), so that
the outputs equal the plain version's bit for bit there (chip_smoke.py
holds them so, and holds the parent design, a thread a scenario, bit for
bit against this one with --kernels-only --k11-baseline; PERF.md).

Every input is read in place through a (batch stride, element stride) pair
(a batch stride 0 for a leaf every scenario shares: a flat terrain, an
unbatched push), so the controller's batch-last forces are not copied; a
layout one element stride cannot describe is copied first. The outputs are
views of two new buffers (the state's dtype and bool), each output
contiguous; the inputs are never written.

`srb_post` runs on the card only: it launches the kernel once or raises.
`runtime.step._srb_post` picks by device, the plain version on the CPU.
Source `csrc/srb_post.cu`, compiled at first use with nvcc into `build/`
(`kernels.build`) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from quaternion_mpc_tpu_torch.kernels import build as _build
from quaternion_mpc_tpu_torch.kernels import walking_pre as _k10
from quaternion_mpc_tpu_torch.sim import plant as _plant

SOURCE = _build.CSRC / "srb_post.cu"
_ENTRY = {torch.float32: "srb_post_f32", torch.float64: "srb_post_f64"}
# -fmad=false: each operation rounds as the plain version's do on the card
# (the fused multiply-adds of torch.linalg.cross and cuBLAS are written out).
FLAGS = ("-fmad=false",)
FEET = 4
JOINTS = 12


class WalkingPostIn(NamedTuple):
    """What the walking steps add to the post's inputs: the planned contacts
    (B, 4), the feet before the tick (B, 4, 3), the FSM's swing targets
    (B, 4, 3), the world (`sim.terrain.TerrainParams`; None: flat), the
    commanded forward velocity (B,) and the ground height under the stance
    feet (B,)."""

    plan_contacts: torch.Tensor
    feet_world: torch.Tensor
    target_pos: torch.Tensor
    terrain: object
    velx: torch.Tensor
    ground_z: torch.Tensor


class SrbPost(NamedTuple):
    """The post's outputs: the plant after the tick before the mask, the
    plant kept (a failed scenario frozen in its last healthy state), alive
    (bool) and as the state's dtype (the metric), the height error; walking:
    the forward velocity error, the applied body forces (B, 4, 3) and the
    feet after the tick (stance pinned, swing on the FSM's target);
    standing: the attitude error. A field of the other mode is None."""

    new_plant: _plant.PlantState
    plant: _plant.PlantState
    alive: torch.Tensor
    alive_f: torch.Tensor
    height_err: torch.Tensor
    vel_err: object = None
    att_err: object = None
    f_body: object = None
    feet_world: object = None


# The input table, in the order of csrc/srb_post.cu enum Input: (name, the
# scenario's shape, kind: "f" the state's dtype, "i" int32, "b" bool). The
# ExtWrench's, the joint velocities, the standing mode's desired attitude and
# the walking mode's inputs may be absent.
INPUTS = (
    ("pos", (3,), "f"), ("quat", (4,), "f"), ("vel", (3,), "f"), ("omega", (3,), "f"),
    ("alive", (), "b"), ("grf", (FEET, 3), "f"), ("foot_pos_body", (FEET, 3), "f"),
    ("mass", (), "f"), ("inertia", (3, 3), "f"), ("com_offset", (3,), "f"),
    ("com_mass", (), "f"), ("h", (), "f"), ("target_height", (), "f"),
    ("ext_force", (3,), "f"), ("ext_torque", (3,), "f"), ("joint_vel", (JOINTS,), "f"),
    ("quat_d", (4,), "f"),
    ("plan_contacts", (FEET,), "f"), ("feet_world", (FEET, 3), "f"),
    ("target_pos", (FEET, 3), "f"), ("kind", (), "i"), ("grade", (), "f"), ("rise", (), "f"),
    ("run", (), "f"), ("velx", (), "f"), ("ground_z", (), "f"),
)
# The outputs in the state's dtype, in the order of enum Out: (name, the
# scenario's shape, written in the walking mode only).
OUTPUTS = (
    ("new_pos", (3,), False), ("new_quat", (4,), False), ("new_vel", (3,), False),
    ("new_omega", (3,), False), ("pos", (3,), False), ("quat", (4,), False),
    ("vel", (3,), False), ("omega", (3,), False), ("alive_f", (), False),
    ("height_err", (), False), ("err", (), False), ("f_body", (FEET, 3), True),
    ("feet_world", (FEET, 3), True),
)

# The einsum products of the plain version, in the order of enum Site (and
# of the calls of one `sim.plant.dynamics`): rot·Σf, rotᵀ·g, I·ω, G(q)·ω,
# I⁻¹·moment; then the walking metric's Rz(yaw)ᵀ·v.
SITES = ("f_world", "g_body", "i_omega", "quat_rate", "omega_dot", "vel_rel")
CHAIN, HALVES, PARITY, SUMS = 0, 1, 2, 3  # csrc/closed_loop.cuh enum Order
# The products by cuBLAS's kernel family: Mᵀ·v (a transposed matrix-vector
# product) and M·v.
_TRANSPOSED = ("g_body", "vel_rel")
_MATVEC = ("f_world", "i_omega", "quat_rate", "omega_dot")


def _row(transposed, matvec):
    return {**dict.fromkeys(_TRANSPOSED, transposed), **dict.fromkeys(_MATVEC, matvec)}


# The order in which cuBLAS sums each product on an H100 with torch 2.11 +
# CUDA 12.8 (its kernel depends on the product's shape, the batch and the
# type), found by holding each product of the plain version against
# candidate orders on the card (`k10_orders.py --kernel k11` holds this table
# so) at the batch sizes of `kernels.walking_pre.CUBLAS_ORDERS`: per type, (least
# B, {site: order}) rows, the first whose least B the batch reaches. Between
# the batch sizes measured a row is a guess, and the last bits may differ
# there.
CUBLAS_ORDERS = {
    torch.float32: ((4096, _row(HALVES, HALVES)),
                    (2048, _row(PARITY, HALVES)),
                    (256, _row(HALVES, HALVES)),
                    (128, _row(SUMS, HALVES)),
                    (2, _row(CHAIN, HALVES)),
                    (1, _row(HALVES, HALVES))),
    torch.float64: ((4096, _row(PARITY, PARITY)),
                    (2048, _row(HALVES, SUMS)),
                    (256, _row(PARITY, PARITY)),
                    (64, _row(PARITY, SUMS)),
                    (2, _row(PARITY, SUMS)),
                    (1, _row(CHAIN, PARITY))),
}


def orders(B, dtype) -> int:
    """The launch's orders word: two bits a site (enum Site), its Order."""
    for least, named in CUBLAS_ORDERS[dtype]:
        if B >= least:
            return sum(named.get(site, CHAIN) << (2 * i) for i, site in enumerate(SITES))
    return 0


def build():
    """Compile the kernel (kernels.build) with FLAGS; returns the library's path."""
    return _build.build(SOURCE, FLAGS)


def bind(path) -> ctypes.CDLL:
    """A build of the kernel (or of its device code emulated on the CPU)
    loaded, its entries' argument types set and its tables' sizes checked
    against the wrapper's."""
    lib = ctypes.CDLL(str(path))
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    table = (ctypes.c_int * 3)()
    lib.srb_post_table(table)
    want = (len(INPUTS), len(OUTPUTS), len(SITES))
    if tuple(table) != want:
        raise RuntimeError(f"{path} takes {tuple(table)} inputs, outputs and sites, the "
                           f"wrapper {want}")
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build())


def _stride(t, first):
    """The one step between the elements of ``t``'s dims from ``first`` on,
    taken flat in order, or None where no single step describes them (a
    dim of one element may have any stride)."""
    step, inner = None, 1
    for n, st in zip(reversed(t.shape[first:]), reversed(t.stride()[first:])):
        if n != 1:
            if st % inner or (step is not None and st != step * inner):
                return None
            if step is None:
                step = st // inner
        inner *= n
    return 1 if step is None else step


def _entry(t, lead, tail, B):
    """(a tensor whose scenario b's element i lies at b·bs + i·es, bs, es):
    ``t`` itself where it is (lead + tail) with one leading axis or a leaf
    every scenario shares (tail), else broadcast and reshaped (copied where
    one step cannot describe it)."""
    if t is None:
        return None, 0, 0
    if len(lead) == 1 and t.shape == lead + tail:
        es = _stride(t, 1)
        if es is not None:
            return t, t.stride(0) if B > 1 else 0, es
    if t.shape == tail:
        es = _stride(t, 0)
        if es is not None:
            return t, 0, es
    t = torch.broadcast_to(t, lead + tail).reshape((B,) + tail)
    if B > 0 and _stride(t, 1) is None:
        t = t.contiguous()
    return t, t.stride(0) if B > 1 else 0, _stride(t, 1)


def check(ps, alive, grf_body, pp, h, target_height, *, n_sub=1, ext=None, joint_vel=None,
          quat_d=None, walk=None):
    """The kernel's input table (one (tensor or None, batch stride, element
    stride) triple an input, in the order of INPUTS), the leading batch
    shape and the launch's sizes {B, n_sub, walking, ext, orders}. Raises
    ValueError on inputs the kernel does not take."""
    dtype, device = ps.pos.dtype, ps.pos.device
    if dtype not in _ENTRY:
        raise ValueError(f"K11 takes float32 or float64, got {dtype}")
    if (walk is None) == (quat_d is None):
        raise ValueError("K11 takes the walking mode's inputs or the standing mode's quat_d")
    if n_sub < 1 or (walk is not None and n_sub != 1):
        raise ValueError(f"K11 takes at least one substep (the walking mode one), got {n_sub}")
    if grf_body.shape[-2] != FEET or pp.foot_pos_body.shape[-2] != FEET:
        raise ValueError(f"K11 takes {FEET} feet, got {grf_body.shape[-2]}")
    lead = tuple(ps.pos.shape[:-1])
    B = math.prod(lead)
    tp = None
    if walk is not None:
        tp = walk.terrain if walk.terrain is not None else _k10._flat_terrain(device, dtype)
    none = lambda x, i: None if x is None else x[i]
    leaves = (
        ps.pos, ps.quat, ps.vel, ps.omega, alive, grf_body, pp.foot_pos_body,
        pp.mass, pp.inertia, pp.com_offset, pp.com_mass, h, target_height,
        none(ext, 0), none(ext, 1), joint_vel, quat_d,
        *(walk[:3] if walk is not None else (None,) * 3),
        *((tp.kind, tp.slope_grade, tp.stair_rise, tp.stair_run) if tp is not None
          else (None,) * 4),
        none(walk, 4), none(walk, 5),
    )
    kinds = {"f": dtype, "i": torch.int32, "b": torch.bool}
    table = []
    for (name, tail, kind), t in zip(INPUTS, leaves, strict=True):
        if t is not None and (not isinstance(t, torch.Tensor) or t.dtype != kinds[kind]
                              or t.device != device):
            got = f"{t.dtype} on {t.device}" if isinstance(t, torch.Tensor) else type(t).__name__
            raise ValueError(f"K11's input {name} must be {kinds[kind]} on {device}, got {got}")
        try:
            table.append(_entry(t, lead, tail, B))
        except RuntimeError as err:
            raise ValueError(f"K11's input {name} {tuple(t.shape)} does not broadcast to "
                             f"{lead + tail}") from err
    sizes = {"B": B, "n_sub": n_sub, "walking": walk is not None, "ext": ext is not None,
             "orders": orders(B, dtype)}
    return table, lead, sizes


def new_outputs(lead, sizes, dtype, device):
    """The outputs: ({name: view}, alive (bool), the two buffers), each view
    a contiguous (lead + its shape) part of its buffer; the walking mode's
    outputs empty in the standing mode."""
    B = sizes["B"]
    shapes = [shape if sizes["walking"] or not walking else (0,)
              for _, shape, walking in OUTPUTS]
    counts = [B * math.prod(s) for s in shapes]
    buf = torch.empty(sum(counts), dtype=dtype, device=device)
    out = {name: p.view(lead + s)
           for (name, _, _), p, s in zip(OUTPUTS, torch.split(buf, counts), shapes)}
    alive = torch.empty(lead, dtype=torch.bool, device=device)
    return out, alive, (buf, alive)


_IN_TABLE = ctypes.c_void_p * len(INPUTS)
_STRIDE_TABLE = ctypes.c_longlong * len(INPUTS)
_OUT_TABLE = ctypes.c_void_p * len(OUTPUTS)


def launch(lib, table, sizes, out, alive, dtype, stream=None):
    """One launch of a build on these tables; a CPU emulation of the device
    code takes the same tables with ``stream`` None. Returns the entry's
    error code."""
    fn = getattr(lib, _ENTRY[dtype])
    return fn(_IN_TABLE(*[None if t is None else t.data_ptr() for t, _, _ in table]),
              _STRIDE_TABLE(*[bs for _, bs, _ in table]),
              _STRIDE_TABLE(*[es for _, _, es in table]),
              _OUT_TABLE(*[t.data_ptr() for t in out.values()]),
              alive.data_ptr(), sizes["B"], sizes["n_sub"], int(sizes["walking"]),
              int(sizes["ext"]), sizes["orders"], stream)


def assemble(out, alive, walking):
    """The plain version's `SrbPost` from the kernel's outputs."""
    state = lambda p: _plant.PlantState(*(out[p + n] for n in ("pos", "quat", "vel", "omega")))
    return SrbPost(
        new_plant=state("new_"), plant=state(""), alive=alive, alive_f=out["alive_f"],
        height_err=out["height_err"],
        vel_err=out["err"] if walking else None, att_err=None if walking else out["err"],
        f_body=out["f_body"] if walking else None,
        feet_world=out["feet_world"] if walking else None,
    )


def srb_post(ps, alive, grf_body, pp, h, target_height, **kw) -> SrbPost:
    """The walking and standing steps' post on the card: one launch (counted
    in `srb_post.launches`), the same outputs as the plain version
    (`runtime.step._srb_post_plain`). Raises on tensors off the card."""
    device = ps.pos.device
    if device.type != "cuda":
        raise ValueError(f"K11 runs on cuda tensors, not {device} (the plain version is "
                         f"runtime.step._srb_post_plain)")
    table, lead, sizes = check(ps, alive, grf_body, pp, h, target_height, **kw)
    dtype = ps.pos.dtype
    out, alive_out, _ = new_outputs(lead, sizes, dtype, device)
    if sizes["B"] > 0:
        with torch.cuda.device(device):
            err = launch(_lib(), table, sizes, out, alive_out, dtype,
                         torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K11 launch failed with CUDA error {err}")
        srb_post.launches += 1
    return assemble(out, alive_out, sizes["walking"])


srb_post.launches = 0


# Floating-point operations of one scenario in the device code, counted by
# function from csrc/srb_post.cu (each add, subtract, multiply, divide,
# square root and library function (atan2, asin, sin, cos, floor) once, a
# fused multiply-add twice): one evaluation of the dynamics 195 (the
# rotation 21, rotᵀ·g 15, the CoM's gravity moment 15, I·ω and −ω × Iω 30,
# rot·Σf 15, G(q)·ω and ½ 41, the velocity's 6, the 3 x 3 inverse 41 and its
# product 15; the push 6 more); a midpoint substep two of them, the midpoint
# and the end 65 and the renormalisation 12; the forces' sums 45 (walking:
# the forces by the contacts 12 more); the mask 35 (walking: the floor 8);
# the metrics: walking 28, standing 12.
def flops_per_scenario(n_sub, walking, ext):
    dyn = 195 + 6 * ext
    return (n_sub * (2 * dyn + 65 + 12) + 45 + 35
            + (12 + 8 + 28 if walking else 12))


def work(ps, alive, grf_body, pp, h, target_height, **kw) -> dict:
    """Bytes and floating-point operations of one launch on these inputs, for
    its bound on the card: every input read once (a leaf every scenario
    shares once for all), every output written once."""
    table, lead, sizes = check(ps, alive, grf_body, pp, h, target_height, **kw)
    B = sizes["B"]
    read = sum(math.prod(tail) * t.element_size() * (B if bs else 1)
               for (_, tail, _), (t, bs, _) in zip(INPUTS, table) if t is not None)
    item = torch.empty((), dtype=ps.pos.dtype).element_size()
    written = B * (item * sum(math.prod(s) for _, s, walking in OUTPUTS
                              if sizes["walking"] or not walking) + 1)
    return {"bytes": read + written,
            "flops": B * flops_per_scenario(sizes["n_sub"], sizes["walking"], sizes["ext"])}
