"""Scenario-fleet parallelism (port of `quaternion_mpc_tpu/parallel/mesh.py`):
the mesh, sharding, and fleet collectives, in PyTorch's own idiom.

The JAX package shards the scenario axis over a ('scenario',) device mesh
with `shard_map` and sums metrics with `psum`. Here one process drives one
CUDA device (a rank of `torch.distributed`): a mesh is the process group, the
rank's device and the world size. Each rank holds a contiguous slice of the
fleet's leading axis, runs the fleet step on it, and sums the metrics over
its scenarios and then over the ranks with one `all_reduce` (SUM) each. With
no process group initialised the world is one rank and no collective runs.

Several devices driven from one process, as JAX's virtual mesh of CPU
devices does, is not the PyTorch idiom and has no counterpart here: run one
process per device (``torchrun``, or `parallel.distributed.init`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from quaternion_mpc_tpu_torch._bridge import resolve_device
from quaternion_mpc_tpu_torch.utils.graphs import Graphed
from quaternion_mpc_tpu_torch.utils.tree import is_namedtuple

SCENARIO_AXIS = "scenario"


class ScenarioMesh(NamedTuple):
    group: Optional[object]  # the process group; None: one rank, no collective
    device: torch.device     # this rank's device
    size: int                # ranks in the mesh
    rank: int                # this rank's place in it


def _map(fn, tree):
    """``fn`` over the tensors of a tree of NamedTuples, tuples, lists and
    dicts; None stays None."""
    if tree is None:
        return None
    if is_namedtuple(tree):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _rank_device(device, rank: int) -> torch.device:
    """``device``, the card unless the caller names another; a CUDA device
    without an index is the rank's own card."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % max(1, torch.cuda.device_count()))
    return device


def scenario_mesh(device=None, group=None) -> ScenarioMesh:
    """The mesh of ``group`` (the default group when one is initialised,
    else one rank) on this rank's ``device``."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return ScenarioMesh(None, _rank_device(device, 0), 1, 0)
    if group is None:
        group = dist.group.WORLD
    rank = dist.get_rank(group)
    return ScenarioMesh(group, _rank_device(device, rank), dist.get_world_size(group), rank)


def shard_batch(tree, mesh: ScenarioMesh):
    """This rank's contiguous slice of each leaf's leading axis, on its
    device; 0-dim leaves whole. Raises unless the batch divides the mesh."""
    def take(x):
        if x.dim() == 0:
            return x.to(mesh.device)
        batch = x.shape[0]
        if batch % mesh.size:
            raise ValueError(f"a batch of {batch} does not divide a {mesh.size}-rank mesh")
        per = batch // mesh.size
        return x[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device).contiguous()

    return _map(take, tree)


def replicate(tree, mesh: ScenarioMesh):
    """Every leaf whole on this rank's device."""
    return _map(lambda x: x.to(mesh.device), tree)


def gather_batch(tree, mesh: ScenarioMesh):
    """`shard_batch` undone: each leaf's shards joined along the leading
    axis on every rank (an all_gather a leaf; the leaf itself at one rank)."""
    if mesh.group is None:
        return tree

    def join(x):
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(wire) for _ in range(mesh.size)]
        dist.all_gather(parts, wire, group=mesh.group)
        return torch.cat(parts).to(x.dtype)

    return _map(join, tree)


def _psum(total: torch.Tensor, mesh: ScenarioMesh) -> torch.Tensor:
    """``total`` summed over the mesh's ranks (in place; no collective at
    one rank without a group)."""
    if mesh.group is not None:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
    return total


def _over_ranks(step_fn: Callable, mesh: ScenarioMesh, reduce: bool):
    """``step_fn`` on this rank's shard, its per-scenario metrics summed over
    the shard and then over the ranks when ``reduce``. The rank's part (the
    step and its sums over the shard) is replayed from a CUDA graph on the
    card (`utils.graphs.Graphed`, as the JAX package jits the sharded step;
    ``step_fn`` itself on the CPU); the collective runs outside it. The
    carry it returns is the graph's own buffer, which the next call
    overwrites."""
    def local(carry, *args):
        carry, metrics = step_fn(carry, *args)
        if reduce:
            metrics = _map(lambda m: torch.sum(m, dim=0), metrics)
        return carry, metrics

    part = Graphed(local, chain=True, label="a rank's part of the fleet step")
    if not reduce:
        return part

    def fleet_fn(*args):
        carry, sums = part(*args)
        return carry, _map(lambda t: _psum(t, mesh), sums)

    return fleet_fn


def fleet_map(step_fn: Callable, mesh: ScenarioMesh, *, has_metrics: bool = True):
    """A per-scenario step as a fleet step over the mesh.

    step_fn: (carry, inputs) -> (carry, metrics) on a leading batch axis
    (the port's per-scenario steps take one; no vmap). Returns fleet_fn on
    this rank's shard; the metrics, summed over the shard and the ranks, are
    fleet totals, the same on every rank. On the card the rank's part is a
    CUDA graph (`_over_ranks`)."""
    return _over_ranks(step_fn, mesh, has_metrics)


def fleet_shard(fleet_step: Callable, mesh: ScenarioMesh, *, reduce_metrics: bool = True):
    """A fleet-native step (batch-leading ``(carry, sp, joy)``,
    ``runtime.step.make_fleet_*``) over the mesh: each rank runs it on its
    shard; the per-scenario metrics are summed to fleet totals (the same on
    every rank) unless ``reduce_metrics=False``, which keeps them per
    scenario of the shard. On the card the rank's part is a CUDA graph
    (`_over_ranks`)."""
    return _over_ranks(fleet_step, mesh, reduce_metrics)


def fleet_mean(values: torch.Tensor, mesh: ScenarioMesh) -> torch.Tensor:
    """The fleet mean of per-scenario ``values`` (this rank's shard) over
    the mesh."""
    total = _psum(torch.sum(values, dim=0), mesh)
    count = _psum(torch.full((), values.shape[0], dtype=torch.int64, device=values.device), mesh)
    return total / count
