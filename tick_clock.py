"""Time the hardware loop's tick, the Go1 fleet's step and tick, the convex
fleet's step and the falling_cat fleet's solve on one card, so that two
checkouts of this repository can be compared in turns in one call on one
card.

    python3 tick_clock.py     # from the root of a checkout: times that checkout's port
    python3 tick_clock.py convex falling_cat   # only the parts named (PARTS)

Prints the card's name and power limit, then one JSON object:
- the hardware loop's two-tier tick as the loop replays it (a CUDA graph, in
  a chain, f32, B=1) at horizon 6, 1 x 3 (the loop's default) and at the
  walk flow's horizon 8, 2 x 3, each from the carry of a short operator flow
  (25 prime ticks and 15 standing ticks against the peer's plant): p50 /
  min / max ms of 20 warm replays with the pull to the host, and the device
  operations and busy ms of one traced replay (every trace also gives each
  hand-written kernel's launches and device ms, `KERNELS`);
- the quaternion-MPC fleet controller's step (N=10, 2 AL x 5 iLQR, 8 alphas,
  f32) at B=4096: p50 / min / max ms of 10 steps after 2 warm-ups, each
  ending in a synchronise, and the device operations of one traced step;
- the walking RTI fleet's tick (N=10, 1 x 3, 8 alphas, f32, B=4096, 0.3
  m/s): the same, over 10 ticks after 3 settle ticks;
- K2, the line search, alone at the fleet step's shape (f32, N=10, 8
  alphas, B=4096): the host's time in one call of its wrapper (mean of 100
  calls, no synchronise) and the kernel's by events around a replayed graph
  of 50 launches;
- the Euler convex fleet controller's step (N=10, 1 AL x 5 iLQR, 8 alphas,
  f32, B=4096): p50 / min / max ms of 10 steps after 2 warm-ups, the device
  operations of one traced step with the launches, device operations and
  device ms inside its `expansions` profiler ranges (the backward passes'
  knot expansions, one range an iLQR iteration), and the fleet's mean Σfz;
- the falling_cat fleet's solve (`examples.falling_cat_fleet`, B=4096, f32,
  N=40, 3 AL x 25 iLQR, 12 alphas): p50 / min / max ms of 3 solves after 1
  warm-up, and the solve cut to 1 x 5: p50 / min / max ms of 5 after 1
  warm-up and the device operations of one traced, with its `expansions`
  ranges as the convex step's;
- one whole falling_cat 3 x 25 solve traced: its device operations (~75k),
  busy ms and each hand-written kernel's launches and device ms;
- the fleet step, the walking tick, the convex step and the falling_cat
  3 x 25 solve as the entry points run them on the card, replayed from a
  CUDA graph (`utils.graphs.Graphed`; the parts named `*_graphed`): warm-up
  and capture seconds, the graph's pool bytes, p50 / min / max ms of 10
  replays (3 for the falling_cat solve) after 2, each ending in a
  synchronise, the same of the graph alone on its buffers (no copy in or
  clone out) and of the host's part of a call (no synchronise), and the
  device operations and busy ms of one traced replay, with the launches,
  device operations and device ms inside the solver's K9 ranges
  (`open_loop_rollout`, `pricing`; the convex step's `expansions` too).
The parts that are not graphed use only functions the port has had since
its hardware loop was graphed, and `chip_smoke.py`'s helpers of the same
checkout (the last three of them use none); the graphed parts need
`utils.graphs` (since the entry points replay graphs), so name the other
parts when timing an older checkout.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

FLEET_B = 4096
# the hand-written kernels a trace splits out: tag -> part of the kernel's name
KERNELS = {"K1": "riccati_sweep_kernel", "K2": "line_search_kernel",
           "K4": "assoc_backward_kernel", "K7": "articulated_kernel", "K8": "expansions_kernel",
           "K9 rollout": "rollout_kernel", "K9 price": "price_kernel"}
# the solver's profiler ranges around K9's calls (or, on a spec K9 does not
# run and in a checkout before it, around nothing: entered 0 times)
K9_RANGES = ("open_loop_rollout", "pricing")


def _trace(fn, ranges=()):
    """The device operations of one fn() in a torch.profiler trace. A
    profiler range (`record_function`: the steps' `fleet_step.*`, the
    solver's `expansions`) is also recorded on the device, as an annotation
    spanning its kernels; it is no operation and is left out. For each of
    ``ranges``: the times it was entered, the launch calls on the host
    inside it, and the device operations and their ms inside its spans on
    the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    annotations = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    ops = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in annotations]
    kernels = {}
    for tag, name in KERNELS.items():
        mine = [e for e in ops if name in e.name]
        kernels[tag] = [len(mine), sum(e.time_range.elapsed_us() for e in mine) / 1e3]
    out = {"device_ops": len(ops),
           "device_busy_ms": sum(e.time_range.elapsed_us() for e in ops) / 1e3,
           "kernels_launches_ms": kernels}
    for name in ranges:
        host = [e.time_range for e in events
                if e.name == name and e.device_type == DeviceType.CPU]
        span = [e.time_range for e in events
                if e.name == name and e.device_type == DeviceType.CUDA]
        inside = [e for e in ops if any(d.start <= e.time_range.start <= d.end for d in span)]
        out[f"range_{name}"] = {
            "entered": len(host),
            "launches": sum(1 for e in events if e.name.startswith(("cudaLaunch", "cuLaunch"))
                            and any(h.start <= e.time_range.start <= h.end for h in host)),
            "device_ops": len(inside),
            "device_ms": sum(e.time_range.elapsed_us() for e in inside) / 1e3}
    return out


def _ms(times):
    return [statistics.median(times) * 1e3, min(times) * 1e3, max(times) * 1e3]


def _timed(fn, runs, warmup):
    """Seconds of each of ``runs`` calls of fn() after ``warmup``, each
    ending in a synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def hardware_tick(device, horizon, al, ilqr):
    import chip_smoke as cs
    from quaternion_mpc_tpu_torch.control import goals
    from quaternion_mpc_tpu_torch.runtime import hardware_loop as hw

    flow = (horizon, al, ilqr, [("prime", 25), ("stand", 15)])
    _, _, _, _, carry, tick, _ = cs._hw_sync_flow(device, flow)
    wts, ap, rs = cs._hw_setup(device, torch.float32)
    sensors = hw.split_sensors(hw.observe(rs, rs, ap, cs.HW_DT))
    joy = goals.neutral_joy_sample(torch.float32, device)
    dt = torch.full((), cs.HW_DT, dtype=torch.float32, device=device)
    lead0 = torch.zeros((), dtype=torch.float32, device=device)
    bound = (wts, ap.rho_fix, ap.kp_joint, ap.kd_joint)
    graph = hw.loop_step(tick, "tick", *bound, carry, (sensors, dt, joy, lead0))
    chain = [carry]

    def replay():
        chain[0], cmd, info = graph(chain[0], sensors, dt, joy, lead0)
        return cmd

    for _ in range(3):
        replay().cpu()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        replay().cpu()
        times.append(time.perf_counter() - t0)
    return {"replay_ms_p50_min_max": _ms(times), **_trace(replay)}


def fleet_step(device):
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    opts = SolverOptions(al_iterations=2, ilqr_iterations=5, max_linesearch=8)
    ctrl = quat_mpc.make_fleet_controller(10, opts)
    inputs = examples.standing_batch(FLEET_B, 10, torch.float32, device)
    times = _timed(lambda: ctrl(*inputs), runs=10, warmup=2)
    return {"step_ms_p50_min_max": _ms(times), **_trace(lambda: ctrl(*inputs))}


def walking_tick(device):
    import chip_smoke as cs
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.runtime import step as rt

    step = rt.make_fleet_walking_step(10, cs._rti_opts(), warm_start=True)
    carry, sp, joy = examples.walking_batch(FLEET_B, 10, torch.float32, device, velx=0.3)
    state = [carry]

    def tick():
        state[0], _ = step(state[0], sp, joy)

    times = _timed(tick, runs=10, warmup=3)
    return {"tick_ms_p50_min_max": _ms(times), **_trace(tick)}


def line_search(device):
    import chip_smoke as cs
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.kernels import line_search as k2

    spec, prob, kw = examples.line_search_case("standing", FLEET_B, torch.float32, device, 10, 8)
    launch = lambda: k2.line_search(spec, prob, **kw)
    launch()
    return {"host_ms_a_call": cs._enqueue_time(launch) * 1e3,
            "kernel_ms": cs._graph_time(launch, reps=50) * 1e3}


def convex_step(device):
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control import convex_mpc
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    opts = SolverOptions(al_iterations=1, ilqr_iterations=5, max_linesearch=8)
    ctrl = convex_mpc.make_fleet_controller(10, opts)
    inputs = examples.standing_batch(FLEET_B, 10, torch.float32, device, controller="convex")
    times = _timed(lambda: ctrl(*inputs), runs=10, warmup=2)
    grf, _ = ctrl(*inputs)
    return {"step_ms_p50_min_max": _ms(times),
            **_trace(lambda: ctrl(*inputs), ranges=("expansions",)),
            "mean_sum_fz_N": grf[..., 2].sum(-1).mean().item()}


def falling_cat_solve(device):
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.solver import al_ilqr

    spec, prob, opts = examples.falling_cat_fleet(FLEET_B, torch.float32, device, seed=0)
    solver = al_ilqr.make_solver(spec, opts)
    times = _timed(lambda: solver(prob), runs=3, warmup=1)
    short = al_ilqr.make_solver(spec, opts._replace(al_iterations=1, ilqr_iterations=5))
    short_times = _timed(lambda: short(prob), runs=5, warmup=1)
    return {"solve_ms_p50_min_max": _ms(times),
            "solve_1x5": {"ms_p50_min_max": _ms(short_times),
                          **_trace(lambda: short(prob), ranges=("expansions",))}}


def falling_cat_trace(device):
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.solver import al_ilqr

    spec, prob, opts = examples.falling_cat_fleet(FLEET_B, torch.float32, device, seed=0)
    solver = al_ilqr.make_solver(spec, opts)
    return _trace(lambda: solver(prob))


def _graphed(fn, args, chain=False, runs=10, ranges=()):
    """``fn`` as the entry points replay it (`Graphed`): its capture's
    seconds and pool bytes, p50 / min / max of ``runs`` replays after 2,
    and one traced replay. With ``chain`` the state is carried replay to
    replay in the graph's own buffers."""
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed

    g = Graphed(fn, chain=chain)
    cap = g.captured(*args)
    state = [args[0]]

    def replay():
        if chain:
            state[0], *_ = g(state[0], *args[1:])
        else:
            g(*args)

    times = _timed(replay, runs=runs, warmup=2)
    # where a replayed call's time goes: the graph alone on its buffers, and
    # the host's part of a call (the copies in, the replay's launch, the
    # clones out) with no synchronise
    graph_alone = _timed(cap.graph.replay, runs=runs, warmup=1)
    host = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay()
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return {"capture_s": cap.capture_s, "pool_bytes": cap.pool_bytes,
            "per_replay": cap.per_replay, "replay_ms_p50_min_max": _ms(times),
            "graph_alone_ms_p50_min_max": _ms(graph_alone),
            "host_ms_a_call_p50_min_max": _ms(host), **_trace(replay, ranges)}


def fleet_step_graphed(device):
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    opts = SolverOptions(al_iterations=2, ilqr_iterations=5, max_linesearch=8)
    inputs = examples.standing_batch(FLEET_B, 10, torch.float32, device)
    return _graphed(quat_mpc.make_fleet_controller(10, opts), inputs, ranges=K9_RANGES)


def walking_tick_graphed(device):
    import chip_smoke as cs
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.runtime import step as rt

    step = rt.make_fleet_walking_step(10, cs._rti_opts(), warm_start=True)
    carry, sp, joy = examples.walking_batch(FLEET_B, 10, torch.float32, device, velx=0.3)
    return _graphed(step, (carry, sp, joy), chain=True, ranges=K9_RANGES)


def convex_step_graphed(device):
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control import convex_mpc
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    opts = SolverOptions(al_iterations=1, ilqr_iterations=5, max_linesearch=8)
    inputs = examples.standing_batch(FLEET_B, 10, torch.float32, device, controller="convex")
    return _graphed(convex_mpc.make_fleet_controller(10, opts), inputs,
                    ranges=("expansions", *K9_RANGES))


def falling_cat_solve_graphed(device):
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.solver import al_ilqr

    spec, prob, opts = examples.falling_cat_fleet(FLEET_B, torch.float32, device, seed=0)
    return _graphed(al_ilqr.make_solver(spec, opts), (prob,), runs=3, ranges=K9_RANGES)


PARTS = {
    "hardware_tick_h6_1x3": lambda device: hardware_tick(device, 6, 1, 3),
    "hardware_tick_h8_2x3": lambda device: hardware_tick(device, 8, 2, 3),
    "fleet_step_2x5_B4096": fleet_step,
    "walking_tick_1x3_B4096": walking_tick,
    "line_search_f32_N10_K8_B4096": line_search,
    "convex_step_1x5_B4096": convex_step,
    "falling_cat_solve_3x25_B4096": falling_cat_solve,
    "falling_cat_trace_3x25_B4096": falling_cat_trace,
    "fleet_step_2x5_B4096_graphed": fleet_step_graphed,
    "walking_tick_1x3_B4096_graphed": walking_tick_graphed,
    "convex_step_1x5_B4096_graphed": convex_step_graphed,
    "falling_cat_solve_3x25_B4096_graphed": falling_cat_solve_graphed,
}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("tick_clock: no CUDA device", file=sys.stderr)
        return 1
    parts = [name for name in PARTS if not argv or any(name.startswith(a) for a in argv)]
    if argv and not parts:
        print(f"tick_clock: parts are {', '.join(PARTS)}", file=sys.stderr)
        return 2
    import quaternion_mpc_tpu_torch  # noqa: F401  (sets the full-f32 matmul flags)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    device = torch.device("cuda:0")
    t0 = time.perf_counter()
    out = {name: PARTS[name](device) for name in parts}
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
