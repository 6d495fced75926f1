"""CUDA graphs: the port's counterpart of `jax.jit`.

The JAX package runs each entry point as one compiled device program: its
callers `jax.jit` the fleet controller, the closed-loop tick, the fleet
shard and the single-problem solve. Here the same call sites capture the
function once in a `torch.cuda.CUDAGraph` on static copies of its inputs and
replay it, so a call costs the host a few copies and one replay instead of
thousands of eager launches. A replay launches the same kernels on the same
buffers as the eager call, so it gives the same bits.

- `Graphed(fn)`: ``fn`` as graphs, one for each signature of its inputs,
  captured at the first call with that signature and replayed after. A
  signature is what a graph bakes in of its inputs (`graph_key`): the
  structure of the arguments and the Python values in it, and each input's
  shape, strides, dtype and device. A call with another B or dtype captures
  a new graph; it never replays a wrong one. What ``fn`` closes over (its
  options, horizon, backend, bound weights) is baked in as well, and a
  `Graphed` cannot see it change: build a new `Graphed` for each ``fn``.
- `CapturedCall`: ``fn(*args) -> outs`` with no carried state (a solve, a
  controller step); the outputs are cloned out of the graph's pool, and
  what is not a tensor (an iteration count) is returned as the capture
  returned it.
- `CapturedStep`: ``fn(state, *args) -> (new state, *outs)``, a tick whose
  state a chain of replays carries in the graph's own buffers (the hardware
  loop, the CLI's closed loops).

On the CPU, where CUDA graphs do not exist, ``fn`` itself runs: the plain
path is what the tests hold against the JAX package. On the card a capture
that fails raises; nothing falls back to eager.

Capture: GRAPH_WARMUP eager calls on a side stream (real launches, counted:
they build the kernels at first use and fill the per-device constant caches,
neither of which a capture may do), then the capture in PyTorch's global
mode, which fails if another thread makes an unsafe CUDA call meanwhile.
Allocations inside the capture (K2's per-launch trajectory scratch among
them) come from the graph's private pool. A `torch.Generator` the function
draws from is registered with the graph (``generators``), so that each
replay draws what the next eager call would; the capture leaves each
generator as it found it, so the first replay draws what the first eager
call would have. The kernels' launch counters
count Python calls, so the capture's calls are taken back and each replay
adds the graph's own (``per_replay``).
"""

from __future__ import annotations

import time

import torch

# eager calls before a capture: they build the kernels, fill the per-device
# constant caches and settle the allocator, none of which a capture may do
GRAPH_WARMUP = 2

_TENSOR = "<tensor>"  # a tensor's place in a structure (`_flatten`)


def launch_counters():
    """The kernel wrappers, each with its ``launches`` count."""
    from quaternion_mpc_tpu_torch.kernels import (articulated, assoc_scan, expansions,
                                                  line_search, riccati_sweep, rollout)

    return (riccati_sweep.riccati_sweep, assoc_scan.assoc_scan, assoc_scan.assoc_backward,
            articulated.articulated_step, line_search.line_search, expansions.knot_expansions,
            rollout.rollout, rollout.price)


def _flatten(tree, leaves: list):
    """The structure of ``tree`` (NamedTuples, tuples, lists and dicts of
    tensors and Python values), hashable, with each tensor appended to
    ``leaves`` and marked in its place; any other value (None, a number, a
    dtype) is kept in the structure, as a graph bakes it in."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _TENSOR
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    if isinstance(tree, dict):
        return (dict, tuple(tree), tuple(_flatten(v, leaves) for v in tree.values()))
    return ("value", tree)


def _unflatten(spec, leaves):
    """`_flatten` undone: the structure ``spec`` with its tensors taken in
    order from the iterator ``leaves``."""
    if spec == _TENSOR:
        return next(leaves)
    kind = spec[0]
    if kind == "value":
        return spec[1]
    if kind is dict:
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    parts = [_unflatten(s, leaves) for s in spec[1]]
    return kind(*parts) if hasattr(kind, "_fields") else kind(parts)


def _layout(t: torch.Tensor, strides: bool = True):
    return ((tuple(t.shape), t.stride(), t.dtype, t.device) if strides
            else (tuple(t.shape), t.dtype, t.device))


def signature(tree, strides: bool = True):
    """What a graph bakes in of its inputs ``tree``: the structure with its
    Python values, and each tensor's shape, dtype, device and (``strides``)
    strides."""
    leaves = []
    spec = _flatten(tree, leaves)
    return spec, tuple(_layout(t, strides) for t in leaves)


def graph_key(args, state=None):
    """The key of a graph of a function of ``args`` (and, for a
    `CapturedStep`, of the carried ``state``, whose strides a replay may
    change: its buffers are dense)."""
    return signature(args), None if state is None else signature(state, False)


def _copy_in(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``src`` into the static buffer ``dst`` of its layout; along a broadcast
    dimension (stride 0, which both share) only the one column is written."""
    for d in range(dst.dim()):
        if dst.stride(d) == 0 and dst.shape[d] > 1:
            dst, src = dst.narrow(d, 0, 1), src.narrow(d, 0, 1)
    dst.copy_(src)


class StaticInputs:
    """Static buffers of a function's inputs ``args``, which a graph reads.
    The first ``dense`` tensors (a carried state, which the graph writes)
    get dense buffers of their shape; every other tensor a buffer of its own
    strides, a broadcast (stride 0) dimension included, so the graph runs
    the eager call's layouts. ``load(args)`` copies new inputs in (a tensor
    that already is its buffer is not copied) and refuses a structure, a
    leaf count, a shape, strides or a dtype other than the capture's."""

    def __init__(self, args, what, dense: int = 0):
        self.what = what
        leaves = []
        self.spec = _flatten(args, leaves)
        self.layouts = [_layout(t, i >= dense) for i, t in enumerate(leaves)]
        self.buffers = [
            torch.empty_like(t) if i < dense
            else torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device)
            for i, t in enumerate(leaves)]
        for d, s in zip(self.buffers, leaves):
            _copy_in(d, s)
        self.args = _unflatten(self.spec, iter(self.buffers))

    def load(self, args) -> None:
        leaves = []
        spec = _flatten(args, leaves)
        if len(leaves) != len(self.buffers):
            raise ValueError(f"{self.what}: {len(leaves)} input leaves, captured with "
                             f"{len(self.buffers)}")
        if spec != self.spec:
            raise ValueError(f"{self.what}: the inputs' structure or Python values differ "
                             "from the capture's")
        for d, s, lay in zip(self.buffers, leaves, self.layouts):
            if s.data_ptr() == d.data_ptr() and s.shape == d.shape:
                continue
            got = _layout(s, len(lay) == 4)
            if got != lay:
                raise ValueError(f"{self.what}: input {got[0]} {s.dtype} (strides "
                                 f"{s.stride()}), captured with {lay[0]} {lay[-2]}"
                                 + (f" (strides {lay[1]})" if len(lay) == 4 else ""))
            _copy_in(d, s)


def _capture(fn, args, generators, finish=None):
    """GRAPH_WARMUP eager calls of ``fn(*args)`` on a side stream, then one
    captured in a new graph (``finish(out)`` inside the capture as well).
    Returns (graph, the captured call's output, [(counter, launches a
    replay)], bytes the graph's pool reserved, seconds taken)."""
    t0 = time.perf_counter()
    device = next(t for t in tensors(args)).device
    drawn = [g.get_state() for g in generators]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(GRAPH_WARMUP):
            fn(*args)
    torch.cuda.current_stream(device).wait_stream(side)
    counters = launch_counters()
    before = [c.launches for c in counters]
    # the capture empties the allocator's cache first: so does this, so that
    # what is reserved after it is the graph's private pool
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    try:
        with torch.cuda.graph(graph, stream=side):
            out = fn(*args)
            if finish is not None:
                finish(out)
    finally:
        captured = [c.launches - n for c, n in zip(counters, before)]
        for c, n in zip(counters, before):
            c.launches = n
    counted = [(c, n) for c, n in zip(counters, captured) if n]
    pool = torch.cuda.memory_reserved(device) - reserved
    for g, state in zip(generators, drawn):
        g.set_state(state)
    return graph, out, counted, pool, time.perf_counter() - t0


def tensors(tree):
    """The tensors of ``tree`` in `_flatten`'s order."""
    leaves = []
    _flatten(tree, leaves)
    return leaves


def clone_tree(x):
    """``x`` (a structure `_flatten` walks) with every tensor cloned."""
    leaves = []
    spec = _flatten(x, leaves)
    return _unflatten(spec, iter([t.clone() for t in leaves]))


class _Replayed:
    """What `CapturedCall` and `CapturedStep` share: the graph (``graph``),
    its launches a replay (``per_replay``, by wrapper), the bytes its
    private pool holds (``pool_bytes``) and the seconds its warm-up and
    capture took (``capture_s``)."""

    def _set(self, graph, counted, pool, seconds):
        self.graph = graph
        self._counted = counted
        self.per_replay = {c.__name__: n for c, n in counted}
        self.pool_bytes = pool
        self.capture_s = seconds

    def _replay(self):
        self.graph.replay()
        for c, n in self._counted:
            c.launches += n


class CapturedCall(_Replayed):
    """``fn(*args) -> outs`` with no carried state, captured once in a CUDA
    graph on static copies of its inputs (`StaticInputs`) and replayed:
    ``call(*args)`` copies each input in, replays the graph on the current
    stream and returns the outputs cloned out of the graph's pool; a value
    that is not a tensor is returned as the capture returned it.
    ``generators``: the `torch.Generator` objects ``fn`` draws from."""

    def __init__(self, fn, args, label="a graphed call", generators=()):
        self._in = StaticInputs(args, label)
        graph, out, counted, pool, seconds = _capture(fn, self._in.args, generators)
        self._set(graph, counted, pool, seconds)
        self._out = out

    def __call__(self, *args):
        self._in.load(args)
        self._replay()
        return clone_tree(self._out)


class CapturedStep(_Replayed):
    """``fn(state, *args) -> (new state, *outs)`` captured once in a CUDA
    graph on static copies of its inputs, and replayed.

    ``step(state, *args)`` copies each input leaf into its static buffer
    (a leaf that already is that buffer is not copied), replays the graph on
    the current stream and returns ``(state, *outs)``: ``state`` is the
    static state, which the graph itself overwrites with the new state, so a
    chain of replays copies no state; ``outs`` are cloned out of the graph's
    pool unless ``clone_outs`` is False (then the next replay overwrites
    them). Constants (weights, parameters) are bound in ``fn`` and baked in
    by address, as is every Python number it uses. ``label`` names the
    graph in errors; ``generators``: the `torch.Generator` objects ``fn``
    draws from."""

    def __init__(self, fn, state, args, label="a graphed step", clone_outs=True,
                 generators=()):
        self._clone = clone_outs
        self._n_state = len(tensors(state))
        self._in = StaticInputs((state, *args), label, dense=self._n_state)
        graph, out, counted, pool, seconds = _capture(
            fn, self._in.args, generators, lambda out: self._copy_back(tensors(out[0])))
        self._set(graph, counted, pool, seconds)
        self._outs = tuple(out[1:])

    def _copy_back(self, new):
        """(inside the capture) the new state into the static state. A new
        leaf that aliases another static buffer is cloned first, so no copy
        reads a buffer an earlier copy wrote."""
        state = self._in.buffers[:self._n_state]
        if len(new) != len(state):
            raise ValueError(f"the step returns {len(new)} state leaves for {len(state)}")
        held = {t.untyped_storage().data_ptr() for t in self._in.buffers}
        same = [n.data_ptr() == d.data_ptr() and n.shape == d.shape for n, d in zip(new, state)]
        new = [n if s or n.untyped_storage().data_ptr() not in held else n.clone()
               for n, s in zip(new, same)]
        for d, n, s in zip(state, new, same):
            if not s:
                d.copy_(n)

    def __call__(self, state, *args):
        self._in.load((state, *args))
        self._replay()
        outs = tuple(clone_tree(o) for o in self._outs) if self._clone else self._outs
        return (self._in.args[0], *outs)


def on_card(tree) -> bool:
    """Whether the first tensor of ``tree`` lies on a CUDA device."""
    leaves = tensors(tree)
    return bool(leaves) and leaves[0].device.type == "cuda"


class Graphed:
    """``fn`` replayed from CUDA graphs on the card, one graph for each
    signature of its inputs (`graph_key`), each captured at the first call
    with its signature; ``fn`` itself when the inputs lie on the CPU. What
    ``fn`` closes over is baked into every graph: a new ``fn`` needs a new
    `Graphed`. ``label`` names the graphs in errors.

    ``chain=False``: ``fn(*args) -> outs``, a `CapturedCall`.
    ``chain=True``: ``fn(state, *args) -> (state, *outs)``, a `CapturedStep`:
    the state it returns is the graph's own buffer, which the next replay
    overwrites, so a chain of calls copies no state. ``graphs`` holds the
    captures by signature."""

    def __init__(self, fn, *, chain=False, clone_outs=True, generators=(), label=None):
        self.fn = fn
        self.chain = chain
        self.clone_outs = clone_outs
        self.generators = tuple(generators)
        self.label = label or getattr(fn, "__name__", "a graphed function")
        self.graphs = {}

    def key_of(self, *args):
        if self.chain:
            return graph_key(args[1:], state=args[0])
        return graph_key(args)

    def captured(self, *args):
        """What runs these inputs, nothing run yet: on the card their
        capture (a `CapturedCall` or `CapturedStep`), made now if there is
        none; on the CPU ``fn`` itself."""
        if not on_card(args):
            return self.fn
        k = self.key_of(*args)
        g = self.graphs.get(k)
        if g is None:
            g = self.graphs[k] = (
                CapturedStep(self.fn, args[0], args[1:], self.label, self.clone_outs,
                             self.generators)
                if self.chain else CapturedCall(self.fn, args, self.label, self.generators))
        return g

    def __call__(self, *args):
        return self.captured(*args)(*args)
