"""Multi-process fleet (port of `quaternion_mpc_tpu/parallel/distributed.py`):
`torch.distributed` bring-up and the weak-scaling harness.

One process per device, each a rank, all joined into one process group; the
scenario axis is sharded over the ranks and the metrics summed with
`all_reduce` (`parallel.mesh`).

    from quaternion_mpc_tpu_torch.parallel import distributed, mesh
    distributed.init("10.0.0.1:29500", num_processes=4, process_id=rank)
    m = distributed.global_scenario_mesh()
    ... mesh.fleet_shard(step, m) ...

Under ``torchrun`` (which sets ``MASTER_ADDR`` and ``WORLD_SIZE``) `init()`
with no arguments joins its rendezvous.
"""

from __future__ import annotations

import os
import statistics
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from quaternion_mpc_tpu_torch._bridge import resolve_device
from quaternion_mpc_tpu_torch.parallel import mesh as mesh_mod


def _info() -> dict:
    joined = dist.is_available() and dist.is_initialized()
    return {
        "process_id": dist.get_rank() if joined else 0,
        "process_count": dist.get_world_size() if joined else 1,
        "local_devices": 1,  # one device a rank
        "global_devices": dist.get_world_size() if joined else 1,
    }


def init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> dict:
    """Join this process into the process group: at
    ``tcp://<coordinator_address>`` (or the address itself when it names a
    scheme, e.g. ``file:///shared/rendezvous``), with ``num_processes``
    ranks, this one ``process_id``; NCCL when ``device`` (the card unless the
    caller names another) is a CUDA device, gloo on the CPU. With no
    coordinator: torchrun's environment if it set one, else a no-op (one
    process, no group). Returns the JAX package's keys."""
    if dist.is_initialized():
        return _info()
    env = "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ
    if coordinator_address is None and not env and num_processes in (None, 1):
        return _info()
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        method = (coordinator_address if "://" in coordinator_address
                  else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=method, world_size=num_processes,
                                rank=process_id)
    return _info()


def global_scenario_mesh(device=None) -> mesh_mod.ScenarioMesh:
    """The mesh over every rank of the group (one when none is joined)."""
    return mesh_mod.scenario_mesh(device)


def _sub_mesh(n: int, device) -> Optional[mesh_mod.ScenarioMesh]:
    """The mesh of ranks 0..n-1, None on the other ranks. Every rank must
    call it (a new group is made collectively)."""
    world = mesh_mod.scenario_mesh(device)
    if world.group is None or n == world.size:
        return world
    group = dist.new_group(list(range(n)))
    return mesh_mod.scenario_mesh(device, group) if world.rank < n else None


def _median_time(run, device: torch.device, iters: int) -> float:
    """Median wall seconds of ``run()`` ending in a synchronise, after one
    untimed call (which builds the kernels)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run()
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run()
        sync()
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


def _efficiency(results: dict) -> dict:
    base = None
    for n in sorted(results):
        per_dev = results[n]["steps_per_sec"] / n
        if base is None:
            base = per_dev
        results[n]["efficiency"] = per_dev / base
    return results


def _sweep(device_counts, per_device_batch, device, run_on) -> dict:
    world = mesh_mod.scenario_mesh(device).size
    results = {}
    for n in device_counts:
        if n > world:
            continue
        m = _sub_mesh(n, device)
        if m is None:
            continue
        B = per_device_batch * n
        t = run_on(m, B)
        results[n] = {"batch": B, "step_s": t, "steps_per_sec": B / t}
    return _efficiency(results)


def scaling_report(
    make_step: Callable[[], Callable],
    make_batch: Callable[[int], tuple],
    device_counts: Sequence[int],
    per_device_batch: int,
    iters: int = 5,
    device=None,
) -> dict:
    """Weak-scaling sweep: the per-device batch held while the mesh grows
    over the first n ranks (counts above the world size are skipped).
    Returns throughput per count and efficiency against the smallest.

    make_step() -> step(carry, inputs) on a leading batch axis;
    make_batch(B) -> (carry, inputs) batch-leading trees of the whole fleet.
    On the card each rank's part of the step (the step and its sums over the
    shard) is a CUDA graph (`mesh.fleet_map`), as the JAX package jits the
    sharded step; the all_reduce runs outside it.
    """
    def run_on(m, B):
        fleet = mesh_mod.fleet_map(make_step(), m)
        carry, inputs = (mesh_mod.shard_batch(t, m) for t in make_batch(B))
        return _median_time(lambda: fleet(carry, inputs), m.device, iters)

    return _sweep(device_counts, per_device_batch, device, run_on)


def scaling_report_fleet(
    fleet_step: Callable,
    make_batch: Callable[[int], tuple],
    device_counts: Sequence[int],
    per_device_batch: int,
    iters: int = 5,
    device=None,
) -> dict:
    """Weak-scaling sweep of a fleet-native step (`runtime.step.make_fleet_*`)
    sharded with `mesh.fleet_shard`, the per-device batch held while the
    mesh grows. make_batch(B) -> (carry, sp, joy) batch-leading trees. On
    the card each rank's part is a CUDA graph, as in `scaling_report`."""
    def run_on(m, B):
        sharded = mesh_mod.fleet_shard(fleet_step, m)
        carry, sp, joy = (mesh_mod.shard_batch(t, m) for t in make_batch(B))
        return _median_time(lambda: sharded(carry, sp, joy), m.device, iters)

    return _sweep(device_counts, per_device_batch, device, run_on)
