"""Command-line entry points (port of `quaternion_mpc_tpu/cli.py`, the
launch-file layer): the same controllers closed-loop against the port's
plants, batched over a scenario fleet, on the card unless ``--device``
names another:

    python -m quaternion_mpc_tpu_torch.cli run_standing --batch 64 --steps 200
    python -m quaternion_mpc_tpu_torch.cli run_trot --velx 0.4 --steps 100
    python -m quaternion_mpc_tpu_torch.cli bench_solver --batch 4096
    python -m quaternion_mpc_tpu_torch.cli run_hardware --duration 1.0
    python -m quaternion_mpc_tpu_torch.cli run_fleet --batch 4096 --checkpoint ck/fleet
    torchrun --nproc_per_node 4 -m quaternion_mpc_tpu_torch.cli run_fleet --batch 16384

Each command prints a one-line JSON summary on stdout with the JAX CLI's
keys and optionally streams LeggedLogger-style telemetry with --log. A
closed-loop run is timed on its second pass; ``compile_s`` is what the first
pass took beyond it (building the CUDA kernels at first use, the warm-up and
the capture of the tick's graph: XLA's compile time in the JAX CLI).

Where the JAX CLI jits (the controller of ``bench_solver``, the tick of the
closed loops, ``run_fleet`` and ``viz_forces``, the branch scenarios'
solves and receding ticks), the port replays a CUDA graph on the card
(`utils.graphs.Graphed`); on the CPU the same functions run eagerly. To
time eager calls on the card, call the library functions the commands
wrap (`control.quat_mpc.make_fleet_controller`, the `runtime.step`
factories, `solver.al_ilqr.make_solver`) directly.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch", type=int, default=64, help="fleet size")
    p.add_argument("--steps", type=int, default=100, help="control ticks")
    p.add_argument("--horizon", type=int, default=10, help="MPC horizon N")
    p.add_argument("--config", default="gazebo_go1_quat_mpc",
                   help="config preset name (utils.config.presets)")
    p.add_argument("--log", default=None, help="telemetry JSONL path")
    p.add_argument("--f64", action="store_true", help="run in float64")
    p.add_argument("--device", default="cuda",
                   help="torch device the run uses (cuda, cuda:1, cpu)")
    p.add_argument("--push", type=float, default=0.0,
                   help="lateral shoulder-push force [N] injected on the "
                        "torso (external_force.cpp analog); 0 = off")
    p.add_argument("--push-at", type=int, default=40,
                   help="control tick the push window starts")
    p.add_argument("--push-ticks", type=int, default=10,
                   help="push window length in control ticks")


def _setup(args):
    """(torch, dtype, device, cfg, wts): ``--device`` made the port's
    default device and the preset's weights on it; also sets
    ``args._ctrl_wts`` and ``args._controller`` (the config key picks the
    MPC, Main.cpp:69-91; the quat weights stay the plant's physical truth
    either way)."""
    import torch

    import quaternion_mpc_tpu_torch  # (also sets the full-f32 matmul flags)
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.utils import config as cfg_mod

    dtype = torch.float64 if args.f64 else torch.float32
    device = torch.device(args.device)
    quaternion_mpc_tpu_torch.set_default_device(device)
    table = cfg_mod.presets()
    if args.config not in table:
        raise SystemExit(
            f"unknown --config '{args.config}'; choose from: {', '.join(sorted(table))}"
        )
    cfg = table[args.config]()
    wts = quat_mpc.weights_from_config(cfg, dtype=dtype, device=device)
    if cfg.mpc.controller == "convex":
        from quaternion_mpc_tpu_torch.control import convex_mpc

        args._ctrl_wts = convex_mpc.weights_from_config(cfg, dtype=dtype, device=device)
    else:
        args._ctrl_wts = wts
    args._controller = cfg.mpc.controller
    return torch, dtype, device, cfg, wts


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_loop(args, step, init_carry, joy, sp, metric_names, device):
    """Shared closed-loop runner: ``args.steps`` ticks of the fleet step (a
    Python loop where the JAX CLI scans), run twice from ``init_carry``: the
    first pass builds, warms and captures, the second is timed. Reports the
    last tick's metrics.

    On the card one tick is a CUDA graph, replayed ``args.steps`` times with
    the carry chained in the graph's own buffers, as the hardware loop does.
    The ticks are not captured in one graph, as the JAX CLI's scan compiles
    them: its memory and capture time would grow with ``--steps``."""
    import numpy as np
    import torch

    from quaternion_mpc_tpu_torch.utils import telemetry
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed
    from quaternion_mpc_tpu_torch.utils.tree import tile, tree_map

    push = float(getattr(args, "push", 0.0) or 0.0)
    ext_on = ext_off = None
    if push != 0.0:
        # world-frame shove at a point 0.1 m above the CoM for a window of
        # ticks (the reference's external_force push tool)
        from quaternion_mpc_tpu_torch.ops import lie
        from quaternion_mpc_tpu_torch.sim import plant as plant_mod

        dtype = sp.target_height.dtype
        f = torch.tensor([0.0, push, 0.0], dtype=dtype, device=device)
        tq = lie.cross(torch.tensor([0.0, 0.0, 0.1], dtype=dtype, device=device), f)
        ext_on = tile(plant_mod.ExtWrench(f, tq), args.batch)
        ext_off = tree_map(torch.zeros_like, ext_on)
    t_on, n_on = args.push_at, args.push_ticks
    # with --push the wrench is an input of every tick, the push window's
    # or zeros (the JAX body's jnp.where); the metrics are read after the
    # last tick only, so a replay's are not cloned out of the graph
    fn = step if ext_on is None else (lambda c, s, j, ext: step(c, s, j, ext_wrench=ext))
    tick = Graphed(fn, chain=True, clone_outs=False)

    def run(carry):
        metrics = None
        for t in range(args.steps):
            ext = () if ext_on is None else (ext_on if t_on <= t < t_on + n_on else ext_off,)
            carry, metrics = tick(carry, sp, joy, *ext)
        _sync(device)
        return carry, metrics

    t0 = time.perf_counter()
    run(init_carry)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    _carry, metrics = run(init_carry)
    wall = time.perf_counter() - t0

    logger = telemetry.TelemetryLogger(args.log)
    out = {
        "steps": args.steps,
        "batch": args.batch,
        "wall_s": round(wall, 3),
        "compile_s": round(first - wall, 3),
    }
    m_np = {k: getattr(metrics, k).double().cpu().numpy() for k in metric_names}
    for k, v in m_np.items():
        out[f"{k}_final"] = round(float(v.mean()), 5)
    out["alive_frac"] = round(float(m_np["alive"].mean()), 4)
    out["solves_per_sec"] = round(args.steps * args.batch / wall, 1)
    logger.publish_state(
        fleet_metrics={k: np.mean(v) for k, v in m_np.items()},
        mpc_time_s=wall / args.steps,
        n_solves=args.batch,
    )
    logger.close()
    return out


def cmd_run_standing(args) -> dict:
    """Standing-balance fleet."""
    torch, dtype, device, cfg, wts = _setup(args)
    import numpy as np

    from quaternion_mpc_tpu_torch.models import srb
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.utils.tree import tile

    carry1, sp1 = rt.init_scenario(
        wts, srb.go1_params(dtype=dtype, device=device).foot_pos, dtype=dtype,
        ctrl_wts=args._ctrl_wts, device=device,
    )
    carry, sp = tile(carry1, args.batch), tile(sp1, args.batch)
    joy = tile(rt.neutral_joy(dtype, device), args.batch)
    # perturb the initial velocity per scenario
    rng = np.random.default_rng(0)
    vel = torch.as_tensor(0.05 * rng.standard_normal((args.batch, 3)), dtype=dtype).to(device)
    carry = carry._replace(plant=carry.plant._replace(vel=vel))
    step = rt.make_fleet_standing_step(horizon=args.horizon, controller=args._controller)
    return _run_loop(args, step, carry, joy, sp,
                     ("height_err", "att_err", "mpc_cost", "alive"), device)


def cmd_run_trot(args) -> dict:
    """Trot-walking fleet tracking a commanded velocity."""
    torch, dtype, device, cfg, wts = _setup(args)
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.sim import terrain as terrain_mod
    from quaternion_mpc_tpu_torch.utils.tree import tile

    tp = None
    if args.terrain != "flat":
        tp = terrain_mod.make_terrain(args.terrain, dtype=dtype, device=device)
    carry1, sp1 = rt.init_walking_scenario(wts, dtype=dtype, terrain=tp,
                                           ctrl_wts=args._ctrl_wts, device=device)
    joy1 = rt.neutral_joy(dtype, device)._replace(
        velx=torch.full((), args.velx, dtype=dtype, device=device))
    step = rt.make_fleet_walking_step(horizon=args.horizon, controller=args._controller)
    return _run_loop(args, step, tile(carry1, args.batch), tile(joy1, args.batch),
                     tile(sp1, args.batch), ("vel_err", "height_err", "mpc_cost", "alive"),
                     device)


def _gait_pattern(name: str, device):
    """Gait selection (the reference's set_*_gait_pattern rosparam choices,
    LeggedContactFSM.cpp:87-206). None -> the step factory's default."""
    if name == "default":
        return None
    from quaternion_mpc_tpu_torch.gait import schedule as sched_mod

    return {
        "trot": sched_mod.trot_pattern,
        "trot_stand": sched_mod.trot_with_stand_pattern,
        "crawl": sched_mod.crawl_pattern,
        "stand": lambda device: sched_mod.stand_pattern(device=device),
    }[name](device)


def cmd_run_actuated(args) -> dict:
    """Joint-level actuated trot: MPC → torque layer → contact physics
    (`sim.articulated`, K7 on the card; the Gazebo-tier closed loop) over a
    fleet."""
    torch, dtype, device, cfg, wts = _setup(args)
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.sim import terrain as terrain_mod
    from quaternion_mpc_tpu_torch.utils.tree import tile

    tp = None
    if args.terrain != "flat":
        tp = terrain_mod.make_terrain(args.terrain, dtype=dtype, device=device)
    pattern = _gait_pattern(args.gait, device)
    gait_freq = args.gait_freq if args.gait_freq > 0 else cfg.gait.gait_freq
    joy1 = rt.neutral_joy(dtype, device)._replace(
        velx=torch.full((), args.velx, dtype=dtype, device=device))
    if args.kf_type < 0:
        # ground-truth feedback tier
        carry1, sp1 = rt.init_actuated_scenario(wts, dtype=dtype, terrain=tp, pattern=pattern,
                                                device=device)
        step = rt.make_actuated_walking_step(
            horizon=args.horizon, n_sub=args.n_sub, pattern=pattern,
            gait_freq=gait_freq, stance_kp_frac=args.stance_kp,
        )
        metric_keys = ("vel_err", "height_err", "mpc_cost", "alive")
    else:
        # the full Gazebo-parity loop: estimator + torque + gait + terrain
        carry1, sp1 = rt.init_estimated_actuated_scenario(
            wts, dtype=dtype, terrain=tp, kf_type=args.kf_type, pattern=pattern, device=device)
        step = rt.make_estimated_actuated_step(
            horizon=args.horizon, n_sub=args.n_sub, kf_type=args.kf_type,
            pattern=pattern, gait_freq=gait_freq, stance_kp_frac=args.stance_kp,
        )
        metric_keys = ("vel_err", "height_err", "est_err", "mpc_cost", "alive")
    return _run_loop(args, step, tile(carry1, args.batch), tile(joy1, args.batch),
                     tile(sp1, args.batch), metric_keys, device)


def cmd_run_fleet(args) -> dict:
    """The fleet sharded over the ranks of `torch.distributed` (one device a
    rank; one rank unless the process was started to join a group, e.g. by
    torchrun) with all_reduce'd metrics and optional checkpoint / resume.
    The steps run twice from the same carry; the second run is timed and
    checkpointed."""
    import numpy as np
    import torch

    from quaternion_mpc_tpu_torch.parallel import distributed
    from quaternion_mpc_tpu_torch.parallel import mesh as mesh_mod

    distributed.init(device=args.device)
    mesh = mesh_mod.scenario_mesh(args.device)
    if args.batch % mesh.size:
        raise SystemExit(f"--batch must divide the {mesh.size}-rank mesh")
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    args.device = str(mesh.device)  # the rank's own card
    torch, dtype, device, cfg, wts = _setup(args)

    from quaternion_mpc_tpu_torch.models import srb
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.utils import checkpoint as ckpt
    from quaternion_mpc_tpu_torch.utils.tree import tile

    walking = args.walk > 0.0
    if walking:
        carry1, sp1 = rt.init_walking_scenario(wts, dtype=dtype, ctrl_wts=args._ctrl_wts,
                                               device=device)
        joy1 = rt.neutral_joy(dtype, device)._replace(
            velx=torch.full((), args.walk, dtype=dtype, device=device))
    else:
        carry1, sp1 = rt.init_scenario(
            wts, srb.go1_params(dtype=dtype, device=device).foot_pos, dtype=dtype,
            ctrl_wts=args._ctrl_wts, device=device)
        joy1 = rt.neutral_joy(dtype, device)
    carry, sp, joy = tile(carry1, args.batch), tile(sp1, args.batch), tile(joy1, args.batch)
    rng = np.random.default_rng(1)
    vel = torch.as_tensor(0.05 * rng.standard_normal((args.batch, 3)), dtype=dtype).to(device)
    carry = carry._replace(plant=carry.plant._replace(vel=vel))
    start_step = 0
    if args.resume:
        carry = ckpt.restore(args.resume, like=carry)
        start_step = int(ckpt.metadata(args.resume).get("step", 0))
        print(f"[fleet] resumed from {args.resume} @ step {start_step}", file=sys.stderr)

    # the fleet step on this rank's shard, metrics summed over the ranks;
    # --walk shards the walking fleet (gait and warm-start state in the carry).
    # On the card the rank's part (the step and its sums over the shard) is a
    # CUDA graph (`mesh.fleet_shard`), replayed with the carry chained in its
    # buffers; the all_reduce over the ranks runs outside it
    if walking:
        step_fn = rt.make_fleet_walking_step(horizon=args.horizon, controller=args._controller)
    else:
        step_fn = rt.make_fleet_standing_step(horizon=args.horizon, controller=args._controller)
    fleet = mesh_mod.fleet_shard(step_fn, mesh)
    carry0, sp, joy = (mesh_mod.shard_batch(t, mesh) for t in (carry, sp, joy))

    def run(c):
        metrics = None
        for _ in range(args.steps):
            c, metrics = fleet(c, sp, joy)
        _sync(device)
        return c, metrics

    run(carry0)  # builds the kernels and captures the graph
    t0 = time.perf_counter()
    carry, metrics = run(carry0)
    wall = time.perf_counter() - t0

    if args.checkpoint:
        whole = mesh_mod.gather_batch(carry, mesh)
        if mesh.rank == 0:
            path = ckpt.save(args.checkpoint, whole,
                             metadata={"step": start_step + args.steps, "batch": args.batch})
            print(f"[fleet] checkpoint -> {path}", file=sys.stderr)

    return {
        "devices": mesh.size,
        "batch": args.batch,
        "steps": args.steps,
        "wall_s": round(wall, 3),
        "solves_per_sec": round(args.steps * args.batch / wall, 1),
        "fleet_alive": round(float(metrics.alive) / args.batch, 4),
        "fleet_mean_cost": round(float(metrics.mpc_cost) / args.batch, 5),
        "resumed_at": start_step,
    }


def cmd_bench_solver(args) -> dict:
    """Raw solver throughput (the bench.py metric, parameterizable)."""
    torch, dtype, device, cfg, wts = _setup(args)
    import numpy as np

    from quaternion_mpc_tpu_torch.control import convex_mpc, quat_mpc
    from quaternion_mpc_tpu_torch.examples import standing_batch
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed

    if args._controller == "convex":
        ctrl = convex_mpc.make_fleet_controller(
            args.horizon, SolverOptions(al_iterations=1, ilqr_iterations=5))
    else:
        ctrl = quat_mpc.make_fleet_controller(
            args.horizon, SolverOptions(al_iterations=2, ilqr_iterations=5))
    # the JAX CLI jits the controller: on the card a CUDA graph, replayed
    step = Graphed(ctrl)
    fbk, cmd, wts_b = standing_batch(args.batch, args.horizon, dtype, device,
                                     controller=args._controller)
    grf, cost = step(fbk, cmd, wts_b)  # builds the kernels, warms, captures
    _sync(device)
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        grf, cost = step(fbk, cmd, wts_b)
        _sync(device)
        times.append(time.perf_counter() - t0)
    p50 = float(np.median(times))
    return {
        "batch": args.batch,
        "horizon": args.horizon,
        "p50_step_ms": round(p50 * 1e3, 2),
        "solves_per_sec": round(args.batch / p50, 1),
        "per_solve_ms": round(p50 / args.batch * 1e3, 5),
        "mean_cost": round(float(cost.double().mean()), 5),
    }


def cmd_run_hardware(args) -> dict:
    """Main.cpp-shaped hardware loopback: native RateLoop / seqlock / UDP
    runtime around the estimator + MPC + torque tick, against the
    articulated UDP sim peer (`runtime.hardware_loop`). Scripted operator
    flow: default-pose prime (estimator warm-up) → MPC standing balance."""
    torch, dtype, device, cfg, wts = _setup(args)
    from quaternion_mpc_tpu_torch.runtime import hardware_loop as hw

    return hw.run_hardware_loopback(
        duration_s=args.duration,
        mpc_rate=args.mpc_rate,
        low_rate=args.low_rate,
        est_rate=args.est_rate,
        prime_s=args.prime,
        walk_s=args.walk,
        velx=args.velx,
        auto_rate=not args.no_auto_rate,
        async_mpc=args.async_mpc,
        async_pullers=args.pullers,
        dtype=dtype,
        device=device,
    )


def cmd_viz_forces(args) -> dict:
    """Render GRF vectors along a walking run (the draw_force_plugin role):
    run ONE actuated-trot scenario, record grf_vis telemetry frames, write
    a PNG via utils.visualize.render_forces."""
    torch, dtype, device, cfg, wts = _setup(args)
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.sim import articulated as art_mod
    from quaternion_mpc_tpu_torch.sim import terrain as terrain_mod
    from quaternion_mpc_tpu_torch.utils import telemetry, visualize
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed

    tp = None
    if args.terrain != "flat":
        tp = terrain_mod.make_terrain(args.terrain, dtype=dtype, device=device)
    carry, sp = rt.init_actuated_scenario(wts, dtype=dtype, terrain=tp, device=device)
    joy = rt.neutral_joy(dtype, device)._replace(
        velx=torch.full((), args.velx, dtype=dtype, device=device))
    # the JAX CLI jits the step: on the card a CUDA graph, replayed with the
    # carry chained in its buffers (each tick is read before the next replay)
    step = Graphed(rt.make_actuated_walking_step(horizon=args.horizon), chain=True,
                   clone_outs=False)

    logger = telemetry.TelemetryLogger(args.log)
    frames = []
    for _ in range(args.steps):
        carry, _m = step(carry, sp, joy)
        rs = carry.robot
        _, fw, fv, _ = art_mod.foot_kinematics(rs, sp.plant)
        f_world, _ = art_mod.contact_forces(fw, fv, sp.plant, rs.anchor)
        pos, fw, f_world = (t.double().cpu().numpy() for t in (rs.torso.pos, fw, f_world))
        frames.append({
            "ch": "grf_vis",
            "pos": [float(v) for v in pos],
            "feet": [[float(v) for v in row] for row in fw],
            "grf": [[float(v) for v in row] for row in f_world],
            "contacts": None,
        })
        logger.publish_forces(pos, fw, f_world)
    logger.close()
    out_path = visualize.render_forces(frames, args.out, every=max(1, args.steps // 60))
    return {
        "frames": len(frames),
        "out": str(out_path),
        "final_x": float(carry.robot.torso.pos[0]),
        "alive": bool(carry.alive),
    }


def cmd_run_scenario(args) -> dict:
    """Solve a named branch scenario (falling_cat / humanoid / spider_dog)."""
    torch, dtype, device, cfg, wts = _setup(args)
    from quaternion_mpc_tpu_torch import scenarios

    if args.name not in scenarios.SCENARIOS:
        raise SystemExit(
            f"unknown --name '{args.name}'; choose from: "
            + ", ".join(sorted(scenarios.SCENARIOS))
        )
    t0 = time.perf_counter()
    if args.closed_loop:
        summary = scenarios.run_closed_loop(args.name, n_ticks=args.steps, dtype=dtype,
                                            device=device)
    else:
        _sol, summary = scenarios.solve_scenario(args.name, dtype=dtype, device=device)
    summary["name"] = args.name
    summary["closed_loop"] = bool(args.closed_loop)
    summary["wall_s"] = round(time.perf_counter() - t0, 3)
    return summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="quaternion_mpc_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("run_standing", help="standing-balance fleet")
    _common(p)
    p.set_defaults(fn=cmd_run_standing)

    p = sub.add_parser("run_trot", help="trot-walking fleet")
    _common(p)
    p.add_argument("--velx", type=float, default=0.4, help="commanded m/s")
    p.add_argument("--terrain", default="flat",
                   help="world: flat | slope | stairs | space")
    p.set_defaults(fn=cmd_run_trot)

    p = sub.add_parser("run_actuated", help="joint-level torque-driven trot fleet")
    _common(p)
    p.add_argument("--velx", type=float, default=0.4, help="commanded m/s")
    p.add_argument("--terrain", default="flat",
                   help="world: flat | slope | stairs | space")
    p.add_argument("--n_sub", type=int, default=80,
                   help="physics substeps per MPC tick (80 = 0.125 ms at h=10 ms)")
    p.add_argument("--gait", default="default",
                   choices=["default", "trot", "trot_stand", "crawl", "stand"],
                   help="gait pattern (LeggedContactFSM tables); e.g. "
                        "--gait crawl --gait_freq 1.0 climbs moderate stairs")
    p.add_argument("--gait_freq", type=float, default=0.0,
                   help="gait frequency [Hz]; 0 = config preset")
    p.add_argument("--stance_kp", type=float, default=0.0,
                   help="fraction of the position anchor kept on stance "
                        "legs (0 = walk convention; ~0.3 for stairs)")
    p.add_argument("--kf_type", type=int, default=-1,
                   help="-1: ground-truth feedback; 0/1/2: full estimated "
                        "loop (truth passthrough / BasicKF / EKF+mocap)")
    p.set_defaults(fn=cmd_run_actuated)

    p = sub.add_parser("run_fleet", help="mesh-sharded fleet w/ checkpointing")
    _common(p)
    p.add_argument("--checkpoint", default=None, help="save carry here at end")
    p.add_argument("--resume", default=None, help="restore carry from here")
    p.add_argument("--walk", type=float, default=0.0,
                   help="shard the WALKING fleet at this velx [m/s] "
                        "(0 = standing balance)")
    p.set_defaults(fn=cmd_run_fleet)

    p = sub.add_parser("bench_solver", help="raw solver throughput")
    _common(p)
    p.add_argument("--iters", type=int, default=10)
    p.set_defaults(fn=cmd_bench_solver)

    p = sub.add_parser("run_scenario", help="branch configs: falling_cat / humanoid / spider_dog")
    _common(p)
    p.add_argument("--name", required=True)
    p.add_argument("--closed_loop", action="store_true",
                   help="receding-horizon closed loop on the scenario's "
                        "plant (re-solve each tick) instead of one open-"
                        "loop solve; --steps sets the tick count")
    p.set_defaults(fn=cmd_run_scenario)

    p = sub.add_parser(
        "viz_forces",
        help="render GRF vectors along a trot (draw_force_plugin role)",
    )
    _common(p)
    p.add_argument("--velx", type=float, default=0.4)
    p.add_argument("--terrain", default="flat")
    p.add_argument("--out", default="forces.png")
    p.set_defaults(fn=cmd_viz_forces)

    p = sub.add_parser(
        "run_hardware",
        help="Main.cpp-shaped loopback: RateLoop threads + UDP sim peer",
    )
    _common(p)
    p.add_argument("--duration", type=float, default=2.0, help="MPC phase [s]")
    p.add_argument("--prime", type=float, default=0.6,
                   help="default-pose/estimator warm-up phase [s]")
    p.add_argument("--walk", type=float, default=0.0,
                   help="trot phase length [s] (A-press toggled; 0 = stand only)")
    p.add_argument("--velx", type=float, default=0.3, help="walk speed [m/s]")
    p.add_argument("--mpc_rate", type=float, default=50.0)
    p.add_argument("--low_rate", type=float, default=250.0)
    p.add_argument("--est_rate", type=float, default=0.0,
                   help="estimator (feedback) thread rate [Hz]; > 0 enables "
                        "the reference's three-tier thread shape "
                        "(Main.cpp:88-207), 0 folds the KF into the MPC tick")
    p.add_argument("--no_auto_rate", action="store_true",
                   help="keep the requested MPC rate even if the measured "
                        "tick cannot sustain it (count overruns)")
    p.add_argument("--async_mpc", action="store_true",
                   help="one-tick-delay MPC dispatch: publish the previous "
                        "tick's command while the next one runs")
    p.add_argument("--pullers", type=int, default=0,
                   help="pool dispatch: N puller threads copy each tick's "
                        "command to the host behind its CUDA event and "
                        "publish it (sequence-guarded, lead-compensated tick)")
    p.set_defaults(fn=cmd_run_hardware)
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    out = args.fn(args)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
