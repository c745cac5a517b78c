"""CUDA-graph replay of pure functions, and the warm-up and capture that
every graph of the port goes through.

`graphed(fn)` returns a function with fn's contract that, on the card,
replays fn from a CUDA graph instead of dispatching its kernels one by
one. The first call with a given input signature (the shape, stride,
dtype and device of every tensor, inside tuples, lists, dicts and
dataclasses too, and every other argument by value) warms fn up on a side
stream and captures it over static copies of the inputs; every call then
copies its inputs into those buffers, replays the graph and returns fresh
tensors: a result the caller holds never changes under it, and an output
that is an input unchanged, or a view of one, comes back as the caller's
own tensor or that view of it.

It calls fn as it is, judging only from what it can see, where a graph
cannot apply: no tensor on the card (the CPU path), a grid split by rows
(a `rows` descriptor: the sp paths' exchanges), a random generator among
the arguments, `metrics.nan_debug` or `metrics.enabled()` on (both read
the card from the host), or a capture already under way (an outer graph
records the call).

The rule for a function wrapped here: it writes none of its inputs, makes
no host read of a device value and counts nothing (no `profiling.count`, no
`profiling.recorded_counter`): a replay runs none of its Python, so a
count would be made once at the capture and never again. A capture
refuses counts (`profiling.uncounted`), and the card refuses host reads
while it captures.

`warm_up` and `capture` are the pattern itself, which `live.GraphedStep`
shares.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import torch

from slam_tpu_torch.parallel.rows import Rows
from slam_tpu_torch.utils import metrics, profiling

# one memory pool a card, shared by every graph here: they replay one at a
# time on the caller's stream, and each graph's outputs are copied out
# right after its replay, so one graph's scratch may be another's
_pools: dict = {}


def warm_up(step, device, n: int = 2) -> None:
    """Run step() n times on a side stream, as a capture needs (lazy
    initialisations and caches done before it)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(n):
            step()
    torch.cuda.current_stream(device).wait_stream(side)


def capture(step, pool=None):
    """(graph, step's result): step() captured into a new CUDA graph, its
    allocations from `pool` (a graph_pool_handle; None: its own)."""
    g = torch.cuda.CUDAGraph()
    with profiling.uncounted(), torch.cuda.graph(g, pool=pool):
        out = step()
    return g, out


def _is_state(x) -> bool:
    """A dataclass instance whose fields are walked (frozen ones, the
    configurations, are values)."""
    return dataclasses.is_dataclass(x) and not isinstance(x, type) and \
        not type(x).__dataclass_params__.frozen


def flatten(x) -> tuple:
    """(x's tensors, x's signature as a list)."""
    tensors, key = [], []
    _flatten(x, tensors, key)
    return tensors, key


def _flatten(x, tensors: list, key: list) -> None:
    """Append x's tensors to `tensors` and its signature to `key`."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        key.append((x.shape, x.stride(), x.dtype, x.device))
    elif isinstance(x, (tuple, list)):
        key.append((type(x), len(x)))
        for v in x:
            _flatten(v, tensors, key)
    elif isinstance(x, dict):
        key.append((dict, tuple(x)))
        for v in x.values():
            _flatten(v, tensors, key)
    elif _is_state(x):
        key.append(type(x))
        for f in dataclasses.fields(x):
            _flatten(getattr(x, f.name), tensors, key)
    else:
        key.append(x)


def _rebuild(x, it):
    """x with each tensor replaced by the next of `it`."""
    if isinstance(x, torch.Tensor):
        return next(it)
    if isinstance(x, tuple):
        vals = [_rebuild(v, it) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, list):
        return [_rebuild(v, it) for v in x]
    if isinstance(x, dict):
        return {k: _rebuild(v, it) for k, v in x.items()}
    if _is_state(x):
        return dataclasses.replace(x, **{
            f.name: _rebuild(getattr(x, f.name), it)
            for f in dataclasses.fields(x)})
    return x


def _static(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised buffer laid out as t (dense where t overlaps)."""
    if 0 in t.stride():
        return torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device)


_LARGE = 1 << 20      # bytes: a tensor copied by a copy of its own


def _groups(tensors: list) -> list:
    """Positions of `tensors` for the copies: each large tensor alone (a
    plain copy runs at the memory's rate, a multi-tensor copy well below
    it), the others grouped by dtype, one multi-tensor copy a group."""
    by, out = {}, []
    for i, t in enumerate(tensors):
        if t.numel() * t.element_size() >= _LARGE:
            out.append([i])
        else:
            by.setdefault(t.dtype, []).append(i)
    return out + list(by.values())


def _copy(dst: list, src: list, groups: list) -> None:
    for g in groups:
        if len(g) == 1:
            dst[g[0]].copy_(src[g[0]])
        else:
            torch._foreach_copy_([dst[i] for i in g], [src[i] for i in g])


class _Graph:
    """fn captured for one input signature."""

    def __init__(self, fn, args, kwargs, tensors: list):
        dev = tensors[0].device
        self.inputs = [_static(t) for t in tensors]
        self.in_groups = _groups(tensors)
        _copy(self.inputs, tensors, self.in_groups)
        a, k = _rebuild((args, kwargs), iter(self.inputs))
        pool = _pools.get(dev)
        if pool is None:
            pool = _pools[dev] = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        warm_up(lambda: fn(*a, **k), dev)
        try:
            self.graph, self.template = capture(lambda: fn(*a, **k), pool)
        except BaseException:
            # a pool whose graphs are all gone takes no capture again
            _pools.pop(dev, None)
            raise
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        outs, _ = flatten(self.template)
        # each output leaf: ("in", i), the caller's i-th input as it was
        # given; ("view", i, size, stride, offset), that view of it (fn
        # writes no input, so a view of one holds the caller's values); or
        # ("out", j), a fresh copy of static output j
        where_in = {id(t): i for i, t in enumerate(self.inputs)}
        base_in = {t.untyped_storage().data_ptr(): i
                   for i, t in enumerate(self.inputs)
                   if t.numel() and t.stride() == tensors[i].stride()}
        self.outputs, self.slots, seen = [], [], {}
        for t in outs:
            base = t.untyped_storage().data_ptr()
            if id(t) in where_in:
                self.slots.append(("in", where_in[id(t)]))
            elif t.numel() and base in base_in:
                i = base_in[base]
                self.slots.append(("view", i, t.shape, t.stride(),
                                   t.storage_offset() -
                                   self.inputs[i].storage_offset()))
            else:
                if id(t) not in seen:
                    seen[id(t)] = len(self.outputs)
                    self.outputs.append(t)
                self.slots.append(("out", seen[id(t)]))
        self.out_groups = _groups(self.outputs)

    def __call__(self, tensors: list):
        _copy(self.inputs, tensors, self.in_groups)
        self.graph.replay()
        fresh = [torch.empty_like(t) for t in self.outputs]
        _copy(fresh, self.outputs, self.out_groups)

        def leaf(slot):
            kind, i = slot[:2]
            if kind == "out":
                return fresh[i]
            t = tensors[i]
            if kind == "in":
                return t
            return t.as_strided(slot[2], slot[3],
                                t.storage_offset() + slot[4])
        return _rebuild(self.template, map(leaf, self.slots))


def plain_reason(tensors: list, key: list) -> str | None:
    """Why a graph cannot stand for a call of these inputs (their tensors
    and signature, as `flatten` gives them), None where it can."""
    if not tensors:
        return "no tensor"
    if any(isinstance(v, Rows) for v in key):
        return "a grid split by rows"
    if any(isinstance(v, torch.Generator) for v in key):
        return "a random generator"
    if metrics.enabled() or metrics.nan_debugging():
        return "metrics or nan_debug on"
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        return "not all on one card"
    if torch.cuda.is_current_stream_capturing():
        return "inside a capture"
    return None


def graphed(fn):
    """fn replayed from a CUDA graph per input signature where a graph
    applies, and called as it is elsewhere (module docstring)."""
    graphs: dict = {}

    @functools.wraps(fn)
    def call(*args, **kwargs):
        tensors, key = flatten((args, kwargs))
        if plain_reason(tensors, key) is not None:
            return fn(*args, **kwargs)
        key = tuple(key)
        try:
            g = graphs.get(key)
        except TypeError:               # an argument with no value's hash
            return fn(*args, **kwargs)
        if g is None:
            g = graphs[key] = _Graph(fn, args, kwargs, tensors)
        return g(tensors)
    call.graphs = graphs        # the captures, by signature
    return call
