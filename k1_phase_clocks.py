"""Where K1 (the fleet Riccati sweep), K4 (the associative-scan backward
pass), K8 (the knot expansions), K9 (the open-loop rollout and the AL
pricing), K10 (the walking tick's pre) and K11 (the SRB steps' post) spend
their clocks on the card.

    python3 k1_phase_clocks.py          # all six
    python3 k1_phase_clocks.py k1       # or k4, k8, k9, k10 or k11

K1: builds `quaternion_mpc_tpu_torch/csrc/riccati_sweep.cu` a second time with
-DK1_PHASE_CLOCKS, which makes lane 0 of the first scenario of the middle
block stamp clock64() after every phase of every knot, launches it on the
main path's expansions and on falling_cat's and the humanoid's, each at its
own instantiation (f32), at a few shapes and prints the mean clocks of each
phase over the knots after the first. One scenario's view: at B=1 it is the
length of the serial chain, at large B every phase is stretched by the other
warps of the SM.

K4: builds `csrc/assoc_scan.cu` with -DK4_PHASE_CLOCKS, which makes thread 0
of the block stamp clock64() with a phase code after every phase its warp
takes part in (the first combine of every level, the first knot of every
round), launches the fused entry `assoc_backward` at B=1, f32, N=10 and N=20
on the same expansions, and prints the clocks of the element stage, of each
level up and down (the system's products, the elimination and the two
product phases after it apart, and the wait at the level's barrier) and of
the gains stage.

K8: builds `csrc/expansions.cu` with -DK8_PHASE_CLOCKS, which makes lane 0
of every warp of one stage block (knot N/2, the middle tile) stamp clock64()
as its piece goes (the knot's pieces are warps: As, Bs, the state cost, the
AL rows over the rest; then luu's rows and lu's over all of them), launches
it on each instantiation's first expansions (f32) at K8_SHAPES (the
quaternion SRB's hardware tick and fleet step, the convex fleet's, the
convex fixture's, the falling_cat fleet's) and prints each warp's clocks:
staging and the barrier after it, computing, storing, the wait at the
barrier that hands on λ̄ and the active rows, summing its rows of luu and lu
and storing them.

K9: builds `csrc/rollout.cu` with -DK9_PHASE_CLOCKS, which makes thread 0 of
the middle block stamp clock64() at the ends of its phases, launches the
rollout, the multiplier update (λ̄ alone) and the final cost (J alone, no
λ) at K9_SHAPES and prints: for the rollout the constants (M::load and the
barrier), the drives of every knot (and the barrier), the chain's steps
(the mean of one `advance` with its xs row: the chain's latency floor is N
of them) and the whole; for the pricing the copies issued, the weights and
the first knot's loads with the wait for the copies, the knots (the state
and input sums, the inequality's rows), the barrier and the sum over the
knots.

K10: builds `csrc/walking_pre.cu` with -DK10_PHASE_CLOCKS, which makes lane 0
of the middle scenario stamp clock64() after each stage of the walking
pre (K10_STAGES), launches it on the flat walk's state after 300 ticks
(`chip_smoke._k10_walk_states`) at K10_SHAPES, holds its outputs bit for bit
against the shipped build's, and prints the clocks of each stage, the
shipped build's time there (events around a replayed graph of 50 launches)
and its blocks resident on an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).

K11: builds `csrc/srb_post.cu` with -DK11_PHASE_CLOCKS, which makes lane 0
of the middle scenario's group stamp clock64() after each stage of the post
(`k11_stages`: the loads, the inverse, the forces, each dynamics and
midpoint of each substep, the mask, the metrics, the stores; each stage's
values fenced before its stamp), launches it on the inputs one eager tick
hands it from the flat walk's state after 300 ticks (walking) and from the
pushed standing fleet's (two substeps; `chip_smoke._k11_states`) at
K11_SHAPES, holds its outputs bit for bit against the shipped build's, and
prints the clocks of each stage, the shipped build's time there and its
blocks resident on an SM.

A stamp itself costs clocks (two stamps back to back are printed), so read
the phases against each other, not as absolute times; a kernel's time is
`chip_smoke.py`'s. Needs one CUDA card; exits 1 without.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

PHASES = (
    "wait+barrier", "stage knot k-1", "write gains k+1", "AtV BtV Qx Qu", "Qxx Quu Qux",
    "Gauss-Jordan", "KtQuu dV", "Vxx Vx", "symmetrise",
)
# (problem, N, B): the main path's 12 x 12 expansions, falling_cat's (6 x 3)
# and the humanoid's (12 x 6), each at its own instantiation
SHAPES = (("go1", 10, 1), ("go1", 20, 1), ("go1", 10, 256), ("go1", 10, 4096),
          ("go1", 10, 16384), ("falling_cat", 40, 1), ("falling_cat", 40, 4096),
          ("humanoid", 20, 256))

# K4's stamp codes (csrc/assoc_scan.cu `Code`): what ended just before.
K4_BARRIER, K4_STORED = 3, 4
K4_CODES = {
    2: "load", 3: "barrier", 4: "store and sums",
    10: "stage", 11: "Gauss-Jordan", 12: "C and b",
    20: "I+C1J2", 21: "Gauss-Jordan", 22: "J2PA1 A PC1A2t V b", 23: "J eta C A",
    30: "I+C1J2", 31: "Gauss-Jordan", 32: "J2PA1 V", 33: "J eta",
    40: "stage", 41: "BtS Qu", 42: "Quu Qux", 43: "Gauss-Jordan", 44: "dV sums",
}
K4_STAGE_OF = {1: "elements", 2: "up", 3: "down", 4: "gains"}
K4_HORIZONS = (10, 20)


def k4_clocks(device) -> None:
    import chip_smoke
    from quaternion_mpc_tpu_torch.kernels import assoc_scan as k4
    from quaternion_mpc_tpu_torch.kernels import build as kbuild

    lib = ctypes.CDLL(str(kbuild.build(k4.SOURCE, ("-DK4_PHASE_CLOCKS",))))
    lib.assoc_backward_f32.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int, ctypes.c_int,
                                                               ctypes.c_void_p]
    lib.assoc_scan_clocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.assoc_backward_f32.restype = lib.assoc_scan_clocks.restype = ctypes.c_int
    for horizon in K4_HORIZONS:
        args = chip_smoke._sweep_inputs(1, torch.float32, device, horizon)
        outs = [torch.empty((horizon, 12, 12, 1), device=device),
                torch.empty((horizon, 12, 1), device=device)]
        outs += [torch.empty(1, device=device) for _ in range(3)]
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(3):
            err = lib.assoc_backward_f32(*(t.data_ptr() for t in (*args, *outs)), horizon, 1,
                                         stream)
            if err != 0:
                raise RuntimeError(f"launch failed with CUDA error {err}")
        torch.cuda.synchronize()
        for g, w in zip(outs, k4.assoc_backward(*args)):
            if not torch.equal(g, w):
                raise AssertionError("the instrumented build disagrees with the kernel")
        codes, clocks = np.zeros(1 << 12, dtype=np.int32), np.zeros(1 << 12, dtype=np.int64)
        if lib.assoc_scan_clocks(codes.ctypes.data, clocks.ctypes.data, len(codes)) != 0:
            raise RuntimeError("reading the stamps failed")
        end = int(np.argmax(codes == K4_STORED))
        codes, spent = codes[2:end + 1], np.diff(clocks[1:end + 1])
        print(f"[clocks] K4 assoc_backward f32 N={horizon} B=1: {clocks[end] - clocks[1]} clocks "
              f"from the first stamp to the last (two stamps back to back "
              f"{clocks[1] - clocks[0]}), thread 0's view")
        # a segment ends at a barrier's stamp (or the last stamp); its stage is
        # the tens digit of the codes inside it
        segment, level = [], {"up": 0, "down": 0}
        for code, c in zip(codes, spent):
            segment.append((int(code), int(c)))
            if code not in (K4_BARRIER, K4_STORED):
                continue
            stage = K4_STAGE_OF.get(segment[0][0] // 10, "end")
            if stage in level:
                level[stage] += 1
                stage = f"{stage} level {level[stage]}"
            by_phase = {}
            for k, v in segment:
                by_phase[K4_CODES[k]] = by_phase.get(K4_CODES[k], 0) + v
            print(f"[clocks]   {stage}: {sum(v for _, v in segment)} clocks: "
                  + ", ".join(f"{name} {v}" for name, v in by_phase.items()))
            segment = []


# K8: (problem, N, B), f32: the quaternion SRB's hardware tick and fleet
# step, the convex fleet's (the Euler SRB, midpoint rule), the convex
# fixture's (forward Euler), the falling_cat fleet's (the attitude model)
K8_SHAPES = (("standing", 6, 1), ("standing", 10, 4096), ("convex", 10, 4096),
             ("convex_fixture", 30, 256), ("falling_cat", 40, 4096))
# the stamps a warp (csrc/expansions.cu K8_STAMP): what ends at each
K8_SLOTS = ("staging and its barrier", "computing", "storing", "wait at the barrier",
            "summing (luu's rows, lu)", "storing them")
K8_PIECES = ("As", "Bs", "state cost")


def k8_clocks(device) -> None:
    import chip_smoke
    from quaternion_mpc_tpu_torch.kernels import build as kbuild
    from quaternion_mpc_tpu_torch.kernels import expansions as k8

    lib = k8.bind(kbuild.build(k8.SOURCE, k8.FLAGS + ("-DK8_PHASE_CLOCKS",)))
    lib.expansions_clock_block.argtypes = [ctypes.c_int]
    lib.expansions_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.expansions_clock_block.restype = lib.expansions_clocks.restype = ctypes.c_int
    for name, horizon, batch in K8_SHAPES:
        args = chip_smoke._k8_inputs(name, horizon, batch, torch.float32, device)
        want = k8.knot_expansions(*args)
        tiles = -(-batch // 32)
        block = (horizon // 2) * tiles + tiles // 2
        if lib.expansions_clock_block(block) != 0:
            raise RuntimeError("setting the stamping block failed")
        launch = chip_smoke._k8_launcher(lib, args)
        for _ in range(3):
            got = launch()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("the instrumented build disagrees with the kernel")
        stamps = np.zeros(32 * 8, dtype=np.int64)
        if lib.expansions_clocks(stamps.ctypes.data, len(stamps)) != 0:
            raise RuntimeError("reading the stamps failed")
        rows = stamps.reshape(32, 8)
        start = rows[0, 0]
        warps = [w for w in range(32) if rows[w, 0] != 0]
        end = max(int(rows[w].max()) for w in warps)
        print(f"[clocks] K8 {chip_smoke.K8_MODEL[name]} {name} f32 N={horizon} B={batch} block "
              f"{block}: {end - start} clocks from warp 0's first stamp to the block's last; "
              f"by warp (clocks a part: {', '.join(K8_SLOTS)}):")
        for w in warps:
            r = rows[w]
            piece = K8_PIECES[w] if w < len(K8_PIECES) else f"AL rows {w - len(K8_PIECES)}"
            # slots 0 start, 1 staged, 2 computed, 3 piece done, 4 barrier,
            # 5 luu summed, 6 luu stored; a part a warp has not: -
            parts = [(r[1] - r[0]), (r[2] - r[1]) if r[2] else None,
                     (r[3] - r[2]) if r[2] else None, r[4] - r[3],
                     (r[5] - r[4]) if r[5] else None, (r[6] - r[5]) if r[6] else None]
            if not r[2]:
                parts[1] = r[3] - r[1]
            print(f"[clocks]   {piece}: " + ", ".join(
                "-" if c is None else str(int(c)) for c in parts)
                + f" (starts {int(r[0] - start)} after warp 0)")


# K9: (dtype, problem, N, B): the quaternion SRB's fleet step (and at B=256,
# and in f64), the convex fleet's, the convex fixture's (forward Euler, f64)
# and the falling_cat fleet's
K9_SHAPES = ((torch.float32, "standing", 10, 4096), (torch.float64, "standing", 10, 4096),
             (torch.float32, "standing", 10, 256), (torch.float32, "convex", 10, 4096),
             (torch.float64, "convex_fixture", 30, 256), (torch.float32, "falling_cat", 40, 4096))


def k9_clocks(device) -> None:
    import chip_smoke
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.kernels import build as kbuild
    from quaternion_mpc_tpu_torch.kernels import rollout as k9

    lib = k9.bind(kbuild.build(k9.SOURCE, k9.FLAGS + ("-DK9_PHASE_CLOCKS",)))
    lib.rollout_clock_block.argtypes = [ctypes.c_int]
    lib.rollout_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rollout_clock_block.restype = lib.rollout_clocks.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for dtype, name, horizon, batch in K9_SHAPES:
        spec, prob, kw = examples.line_search_case(name, batch, dtype, device, horizon, 8)
        lam = chip_smoke._k9_lam(prob, horizon, batch, dtype, device)
        calls = chip_smoke._k9_calls(lib, spec, prob, kw, lam)
        shipped = chip_smoke._k9_calls(k9._lib(), spec, prob, kw, lam)
        tag = f"{chip_smoke.K2_MODEL[name]} {name} {str(dtype)[6:]} N={horizon} B={batch}"
        for call in ("rollout", "multiplier update", "final cost"):
            fn = calls[call]
            plan = k9.plans(lib, fn.table, fn.dims, fn.outputs, dtype, sms)
            blocks = plan["roll_blocks"] if call == "rollout" else plan["price_blocks"]
            if lib.rollout_clock_block(blocks // 2) != 0:
                raise RuntimeError("setting the stamping block failed")
            for _ in range(3):
                got = fn()
            torch.cuda.synchronize()
            want = shipped[call]()
            if not all(g is None or torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError("the instrumented build disagrees with the kernel")
            stamps = np.zeros(160, dtype=np.int64)
            if lib.rollout_clocks(stamps.ctypes.data, len(stamps)) != 0:
                raise RuntimeError("reading the stamps failed")
            if call == "rollout":
                steps = np.diff(stamps[2:3 + min(horizon, 157)])
                print(f"[clocks] K9 {tag} rollout (S={plan['roll_S']}, {plan['roll_threads']} "
                      f"threads, block {blocks // 2}): {stamps[2 + min(horizon, 157)] - stamps[0]} "
                      f"clocks in all: constants {stamps[1] - stamps[0]}, drives "
                      f"{stamps[2] - stamps[1]}, the chain {stamps[2 + min(horizon, 157)] - stamps[2]}"
                      f" ({steps.mean():.0f} a step, first {steps[0]}, the rest "
                      f"{steps[1:].mean() if len(steps) > 1 else 0:.0f}; the floor N x a step)")
                continue
            end = 6 if call == "final cost" else 4
            parts = np.diff(stamps[:end])
            print(f"[clocks] K9 {tag} {call} (S={plan['price_S']}, rows {plan['price_rows']}, "
                  f"{plan['price_knots']} knots a block, block {blocks // 2}): "
                  f"{stamps[end - 1] - stamps[0]} clocks in all: "
                  + ", ".join(f"{p} {int(c)}" for p, c in zip(chip_smoke.K9_PRICE_PHASES, parts)))


# K10: (dtype, B) on the flat walk's state after 300 ticks
K10_SHAPES = ((torch.float32, 1), (torch.float32, 256), (torch.float32, 4096),
              (torch.float64, 1), (torch.float64, 256), (torch.float64, 4096))
# the stamps of lane 0 of the middle scenario (csrc/walking_pre.cu
# K10_STAMP): what ends at each stamp after the first
K10_STAGES = ("the input loads and the windows' copies issued", "attitude and Rz",
              "the goal update", "the leg (IK, J⁻¹)", "Raibert and snap", "the FSM and swing",
              "the legs' stores and the schedule",
              "the staged windows' wait and the goal's new values", "vel filter 0",
              "pos filter 0", "vel filter 1", "pos filter 1", "vel filter 2", "pos filter 2",
              "the goal's buffers written", "the ground height and the plane fit",
              "the angle filter and its buffer written",
              "the means' divisions and the pitched attitude", "the final stores")


def k10_clocks(device) -> None:
    import concurrent.futures

    import chip_smoke
    from quaternion_mpc_tpu_torch.kernels import build as kbuild
    from quaternion_mpc_tpu_torch.kernels import expansions as k8
    from quaternion_mpc_tpu_torch.kernels import line_search as k2
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs
    from quaternion_mpc_tpu_torch.kernels import rollout as k9
    from quaternion_mpc_tpu_torch.kernels import walking_pre as k10
    from quaternion_mpc_tpu_torch.runtime import step as rt

    # the walks' kernels and the instrumented build, one nvcc each, at once
    with concurrent.futures.ThreadPoolExecutor() as pool:
        stamped = pool.submit(kbuild.build, k10.SOURCE, k10.FLAGS + ("-DK10_PHASE_CLOCKS",))
        list(pool.map(lambda m: m.build(), (rs, k2, k8, k9, k10)))
        lib = k10.bind(stamped.result())
    lib.walking_pre_clock_scenario.argtypes = [ctypes.c_longlong]
    lib.walking_pre_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.walking_pre_clock_scenario.restype = lib.walking_pre_clocks.restype = ctypes.c_int
    shipped = k10._lib()
    shipped.walking_pre_occupancy.argtypes = [ctypes.c_int] * 3
    shipped.walking_pre_occupancy.restype = ctypes.c_int
    print(f"[clocks] K10 shipped build: registers, stack, spill stores, spill loads "
          f"{chip_smoke._k10_registers(kbuild, k10.build())}")
    chip_smoke._k10_sass(kbuild, stamped.result())  # the stamped build's SASS beside it
    pat = rt._pattern_on_device(None)(device)
    state = chip_smoke._k10_walk_states(device)[len(chip_smoke.K10_SNAPSHOTS) - 1]
    for dtype, batch in K10_SHAPES:
        c, s, j, gf, kw = chip_smoke._k10_case(state, dtype, batch)
        ours = chip_smoke._k10_launcher(shipped, pat, c, s, j, gf, kw)
        want = [t.clone() for t in ours()]
        fn = chip_smoke._k10_launcher(lib, pat, c, s, j, gf, kw)
        if lib.walking_pre_clock_scenario(batch // 2) != 0:
            raise RuntimeError("setting the stamping scenario failed")
        for _ in range(3):
            got = fn()
        torch.cuda.synchronize()
        if chip_smoke._k10_bits_differ(got, want):
            raise AssertionError("the instrumented build disagrees with the kernel")
        stamps = np.zeros(len(K10_STAGES) + 1, dtype=np.int64)
        if lib.walking_pre_clocks(stamps.ctypes.data, len(stamps)) != 0:
            raise RuntimeError("reading the stamps failed")
        ms = chip_smoke._graph_time(ours, reps=50) * 1e3
        w, wt = (c.goal.vel_filter.buf.shape[-1], c.terrain_est.angle_filter.buf.shape[-1])
        blocks = shipped.walking_pre_occupancy(int(dtype == torch.float64), w, wt)
        parts = np.diff(stamps)
        print(f"[clocks] K10 {str(dtype)[6:]} B={batch} (scenario {batch // 2}, lane 0): "
              f"{stamps[-1] - stamps[0]} clocks in all; the shipped build {ms:.4f} ms, "
              f"{blocks} blocks an SM: "
              + ", ".join(f"{name} {int(p)}" for name, p in zip(K10_STAGES, parts)))


# K11: (mode, dtype, B) on the flat walk's state after 300 ticks (walking)
# and the pushed standing fleet's (standing, two substeps)
K11_SHAPES = tuple((mode, dtype, batch) for mode in ("walking", "standing")
                   for dtype in (torch.float32, torch.float64) for batch in (1, 256, 4096))


def k11_stages(n_sub):
    """The stamps of lane 0 of the middle scenario's group (csrc/srb_post.cu
    K11_STAMP): what ends at each stamp after the first."""
    chain = [f"substep {s}: {part}" for s in range(n_sub)
             for part in ("dynamics 1", "dynamics 2", "the midpoint and the renormalisation")]
    return ("the loads", "the inertia's inverse",
            "the forces, their sums and moments, the joint velocities", *chain, "the mask",
            "the metrics", "the stores")


def k11_clocks(device) -> None:
    import concurrent.futures

    import chip_smoke
    from quaternion_mpc_tpu_torch.kernels import build as kbuild
    from quaternion_mpc_tpu_torch.kernels import expansions as k8
    from quaternion_mpc_tpu_torch.kernels import line_search as k2
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs
    from quaternion_mpc_tpu_torch.kernels import rollout as k9
    from quaternion_mpc_tpu_torch.kernels import srb_post as k11
    from quaternion_mpc_tpu_torch.kernels import walking_pre as k10

    # the walks' kernels and the instrumented build, one nvcc each, at once
    with concurrent.futures.ThreadPoolExecutor() as pool:
        stamped = pool.submit(kbuild.build, k11.SOURCE, k11.FLAGS + ("-DK11_PHASE_CLOCKS",))
        list(pool.map(lambda m: m.build(), (rs, k2, k8, k9, k10, k11)))
        lib = k11.bind(stamped.result())
    lib.srb_post_clock_scenario.argtypes = [ctypes.c_longlong]
    lib.srb_post_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.srb_post_clock_scenario.restype = lib.srb_post_clocks.restype = ctypes.c_int
    shipped = k11._lib()
    shipped.srb_post_occupancy.argtypes = [ctypes.c_int] * 3
    shipped.srb_post_occupancy.restype = ctypes.c_int
    print(f"[clocks] K11 shipped build: registers, stack, spill stores, spill loads "
          f"{chip_smoke._k11_registers(kbuild, k11.build())}; stamped "
          f"{chip_smoke._k11_registers(kbuild, stamped.result())}")
    recs = dict(chip_smoke._k11_states(device, chip_smoke._k10_walk_states(device)))
    rec = {"walking": recs[f"flat tick {chip_smoke.K10_SNAPSHOTS[-1]}"],
           "standing": recs[f"standing pushed tick {chip_smoke.K11_STAND_TICKS}"]}
    for mode, dtype, batch in K11_SHAPES:
        args, kw = chip_smoke._k11_case(rec[mode], dtype, batch)
        ours = chip_smoke._k11_launcher(shipped, args, kw)
        want = [t.clone() for t in ours()]
        fn = chip_smoke._k11_launcher(lib, args, kw)
        if lib.srb_post_clock_scenario(batch // 2) != 0:
            raise RuntimeError("setting the stamping scenario failed")
        for _ in range(3):
            got = fn()
        torch.cuda.synchronize()
        if chip_smoke._k10_bits_differ(got, want):
            raise AssertionError("the instrumented build disagrees with the kernel")
        stages = k11_stages(kw.get("n_sub", 1))
        stamps = np.zeros(len(stages) + 1, dtype=np.int64)
        if lib.srb_post_clocks(stamps.ctypes.data, len(stamps)) != 0:
            raise RuntimeError("reading the stamps failed")
        ms = chip_smoke._graph_time(ours, reps=50) * 1e3
        blocks = shipped.srb_post_occupancy(int(dtype == torch.float64), int(mode == "walking"),
                                            int(kw.get("ext") is not None))
        parts = np.diff(stamps)
        print(f"[clocks] K11 {mode} {str(dtype)[6:]} B={batch} (scenario {batch // 2}): "
              f"{stamps[-1] - stamps[0]} clocks in all; the shipped build {ms:.4f} ms, "
              f"{blocks} blocks an SM: "
              + ", ".join(f"{name} {int(p)}" for name, p in zip(stages, parts)))


def main(argv) -> int:
    which = set(argv) or {"k1", "k4", "k8", "k9", "k10", "k11"}
    if not which <= {"k1", "k4", "k8", "k9", "k10", "k11"}:
        print("usage: k1_phase_clocks.py [k1] [k4] [k8] [k9] [k10] [k11]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k1_phase_clocks: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import quaternion_mpc_tpu_torch  # noqa: F401
    from quaternion_mpc_tpu_torch.kernels import build as kbuild
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    device = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    if "k4" in which:
        k4_clocks(device)
    if "k8" in which:
        k8_clocks(device)
    if "k9" in which:
        k9_clocks(device)
    if "k10" in which:
        k10_clocks(device)
    if "k11" in which:
        k11_clocks(device)
    if "k1" not in which:
        return 0
    lib = ctypes.CDLL(str(kbuild.build(rs.SOURCE, ("-DK1_PHASE_CLOCKS",))))
    lib.riccati_sweep_f32.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 15 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.riccati_sweep_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.riccati_sweep_f32.restype = lib.riccati_sweep_clocks.restype = ctypes.c_int

    for problem, horizon, batch in SHAPES:
        if problem == "go1":
            args = chip_smoke._sweep_inputs(batch, torch.float32, device, horizon)
        else:
            args = chip_smoke._family_first_pass(problem, horizon, batch, torch.float32, device)
        ne, nu = args[0].shape[1], args[1].shape[2]
        outs = [torch.empty((horizon, nu, ne, batch), device=device),
                torch.empty((horizon, nu, batch), device=device)]
        outs += [torch.empty(batch, device=device) for _ in range(3)]
        pointers = [t.data_ptr() for t in args[:6]] + [None]
        pointers += [t.data_ptr() for t in (*args[6:], *outs)]
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(3):
            err = lib.riccati_sweep_f32(ne, nu, *pointers, horizon, batch, stream)
            if err != 0:
                raise RuntimeError(f"launch failed with CUDA error {err}")
        torch.cuda.synchronize()
        want = rs.riccati_sweep(*args)
        for g, w in zip(outs, want):
            if not torch.equal(g, w):
                raise AssertionError("the instrumented build disagrees with the kernel")
        stamps = np.zeros(2 + len(PHASES) * horizon, dtype=np.int64)
        if lib.riccati_sweep_clocks(stamps.ctypes.data, len(stamps)) != 0:
            raise RuntimeError("reading the stamps failed")
        per_knot = np.diff(stamps[1:]).reshape(horizon, len(PHASES))
        later = per_knot[1:].mean(0)
        print(f"[clocks] f32 {problem} ne={ne} nu={nu} N={horizon} B={batch}: {later.sum():.0f} "
              f"clocks a knot (first knot {per_knot[0].sum()}; two stamps back to back "
              f"{stamps[1] - stamps[0]}): "
              + ", ".join(f"{name} {c:.0f}" for name, c in zip(PHASES, later)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
