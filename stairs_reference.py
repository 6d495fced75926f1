"""The f32 walking RTI fleet on the stairs world, on the CPU: how many robots
stand after 300 ticks at 0.4 m/s, stepped by the JAX package's fleet step
and by the port's (its plain versions), from the same starts.

    JAX_PLATFORMS=cpu python3 stairs_reference.py [TICKS [BATCH]]

The fleet is chip_smoke.py's stairs walk (`_k10_walk_states`: Go1 from
`init_walking_scenario` on stairs of 0.17 m rise and 0.30 m run, warm
started, 1 AL x 3 iLQR, penalty 10, 8 alphas, horizon 10), cut from 4,096
robots to BATCH (8) identical ones. It answers whether the reference falls
where the port on the card does; it runs the JAX package on the CPU only."""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import torch

from quaternion_mpc_tpu.control import quat_mpc as jquat_mpc
from quaternion_mpc_tpu.runtime import step as jrt
from quaternion_mpc_tpu.sim import terrain as jterrain
from quaternion_mpc_tpu.solver import SolverOptions as JSolverOptions
from quaternion_mpc_tpu.utils import config as jconfig

VELX, HORIZON = 0.4, 10


def jax_walk(ticks, batch):
    """(robots alive after each tick, the fleet's x at the end) of the JAX
    package's fleet step."""
    dtype = jnp.float32
    wts = jquat_mpc.weights_from_config(jconfig.gazebo_go1_quat_mpc(), dtype=dtype)
    carry, sp = jrt.init_walking_scenario(wts, dtype=dtype,
                                          terrain=jterrain.make_terrain("stairs", dtype=dtype),
                                          warm_start=True, horizon=HORIZON)
    joy = jrt.neutral_joy(dtype)._replace(velx=jnp.asarray(VELX, dtype))
    carry, sp, joy = (jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape), t)
                      for t in (carry, sp, joy))
    step = jax.jit(jrt.make_fleet_walking_step(
        horizon=HORIZON, opts=JSolverOptions(al_iterations=1, ilqr_iterations=3,
                                             penalty_initial=10.0, max_linesearch=8),
        warm_start=True))
    alive = []
    for _ in range(ticks):
        carry, _ = step(carry, sp, joy)
        alive.append(int(carry.alive.sum()))
    return alive, [float(x) for x in carry.plant.pos[:, 0]]


def port_walk(ticks, batch):
    """The same of the port's fleet step on the CPU (its plain versions)."""
    import quaternion_mpc_tpu_torch
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.sim import terrain
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions
    from quaternion_mpc_tpu_torch.utils import config
    from quaternion_mpc_tpu_torch.utils.tree import tile

    quaternion_mpc_tpu_torch.set_default_device("cpu")
    dtype, device = torch.float32, torch.device("cpu")
    wts = quat_mpc.weights_from_config(config.gazebo_go1_quat_mpc(), dtype=dtype, device=device)
    carry, sp = rt.init_walking_scenario(
        wts, dtype=dtype, terrain=terrain.make_terrain("stairs", dtype=dtype, device=device),
        warm_start=True, horizon=HORIZON, device=device)
    joy = rt.neutral_joy(dtype, device)._replace(
        velx=torch.full((), VELX, dtype=dtype, device=device))
    carry, sp, joy = (tile(t, batch) for t in (carry, sp, joy))
    step = rt.make_fleet_walking_step(HORIZON, SolverOptions(
        al_iterations=1, ilqr_iterations=3, penalty_initial=10.0, max_linesearch=8),
        warm_start=True)
    alive = []
    for _ in range(ticks):
        carry, _ = step(carry, sp, joy)
        alive.append(int(carry.alive.sum()))
    return alive, carry.plant.pos[:, 0].tolist()


def main(argv) -> int:
    ticks = int(argv[0]) if argv else 300
    batch = int(argv[1]) if len(argv) > 1 else 8
    for name, walk in (("JAX package", jax_walk), ("port (plain, CPU)", port_walk)):
        t0 = time.perf_counter()
        alive, x = walk(ticks, batch)
        down = next((t + 1 for t, n in enumerate(alive) if n < batch), None)
        print(f"[stairs] {name}: f32 fleet B={batch} on stairs at {VELX} m/s, {ticks} ticks: "
              f"{alive[-1]} of {batch} robots alive; the first tick with one down {down}; "
              f"x {', '.join(f'{v:.4f}' for v in x)}; {time.perf_counter() - t0:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
