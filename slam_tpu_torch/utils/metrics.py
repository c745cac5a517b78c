"""Scalar metrics of the ticks — counterpart of slam_tpu/utils/metrics.py.

Two channels, as in slam_tpu:

- `emit(name, **scalars)` records one dict per call on the host, each
  tensor scalar reduced to its mean over the robot batch. Disabled by
  default, and then it returns at once: no tensor is read, so a tick never
  waits for the card. Enabled, every emit copies its scalars to the host,
  which synchronises with the card (slam_tpu's host callback does the
  same on a TPU that allows it).
- The device ring: per robot, a (capacity, 9) f32 buffer of NaN rows and
  a write count, carried in SlamState.metrics_ring. `ring_write` is a pure
  indexed write at count % capacity with no host sync; `drain_ring` reads
  the rows back once a block of ticks has run.

`nan_debug(True)` turns on a finite check of the state after every tick
of the rollouts, the counterpart of slam_tpu's jax_debug_nans.

Usage:
    from slam_tpu_torch.utils import metrics
    metrics.enable()
    ... run ticks ...
    for rec in metrics.records(): ...
    metrics.disable()
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

import numpy as np
import torch

from slam_tpu_torch import default_device
from slam_tpu_torch.utils import profiling

_lock = threading.Lock()
_enabled = False
_records: list[dict] = []
_user_cb: Callable[[dict], None] | None = None
_nan_debug = False


def enabled() -> bool:
    return _enabled


def enable(callback: Callable[[dict], None] | None = None) -> bool:
    """Turn emission on; `callback` also receives every record. Returns
    True (slam_tpu returns False where its backend cannot call the host;
    the port always can)."""
    global _enabled, _user_cb
    _enabled = True
    _user_cb = callback
    return True


def disable() -> None:
    global _enabled, _user_cb
    _enabled = False
    _user_cb = None


def records() -> list[dict]:
    with _lock:
        return list(_records)


def clear() -> None:
    with _lock:
        _records.clear()


def _record(name: str, **scalars) -> None:
    rec = {"name": name}
    for k, v in scalars.items():
        if isinstance(v, torch.Tensor):
            profiling.count("host_syncs")
            a = v.detach().cpu().numpy()
        else:
            a = np.asarray(v)
        rec[k] = float(a.mean()) if a.ndim else float(a)
        if a.ndim:
            rec.setdefault("batch", int(a.shape[0]))
    with _lock:
        _records.append(rec)
        cb = _user_cb
    if cb is not None:
        cb(rec)


def emit(name: str, **scalars) -> None:
    """Record named scalars (tensors (B,) or (), or numbers); nothing at
    all unless metrics are enabled."""
    if not _enabled:
        return
    _record(name, **scalars)


def summary() -> dict[str, dict[str, float]]:
    """Mean of every scalar per metric name over the recorded history."""
    out: dict[str, dict[str, list]] = {}
    for rec in records():
        d = out.setdefault(rec["name"], {})
        for k, v in rec.items():
            if k != "name":
                d.setdefault(k, []).append(v)
    return {n: {k: float(np.mean(v)) for k, v in d.items()}
            for n, d in out.items()}


# ---------- device metrics ring ----------
#
# Row layout, fixed so every emission site writes the same row shape: the
# channels, then which site wrote the row (index into RING_SITES) and a
# bitmask of the channels it set (an unset channel is not a literal 0).

RING_CHANNELS = (
    "step", "icp_ok", "num_corr", "mean_residual", "scene_points",
    "graph_nodes", "graph_edges",
)
RING_SITES = ("slam_step", "slam_step_3d", "graph_update", "other")
_ROW_LEN = len(RING_CHANNELS) + 2


def init_ring(batch: int, capacity: int = 256, device=None):
    """A ring per robot: ((B, capacity, 9) f32 of NaN, (B,) int32 write
    count), on the card unless `device` says otherwise."""
    device = default_device(device)
    return (torch.full((batch, capacity, _ROW_LEN), float("nan"),
                       dtype=torch.float32, device=device),
            torch.zeros(batch, dtype=torch.int32, device=device))


def ring_write(ring, site: str = "other", **scalars):
    """Write named scalars (a subset of RING_CHANNELS, each (B,) or a
    number) as one row per robot at its count % capacity, tagged with the
    site; return the new ring. A None ring passes through. Pure: the
    inputs are not modified, and nothing waits for the card."""
    if ring is None:
        return None
    buf, idx = ring
    B, cap, _ = buf.shape

    def col(v):          # numbers are filled on the device: no host copy
        if isinstance(v, torch.Tensor):
            return v.to(torch.float32).expand(B)
        return torch.full((B,), float(v), dtype=torch.float32,
                          device=buf.device)
    cols = [col(0.0)] * len(RING_CHANNELS)
    mask = 0
    for k, v in scalars.items():
        c = RING_CHANNELS.index(k)
        cols[c] = col(v)
        mask |= 1 << c
    site_i = RING_SITES.index(site) if site in RING_SITES \
        else len(RING_SITES) - 1
    row = torch.stack(cols + [col(site_i), col(mask)], -1)
    slot = (idx % cap).long()
    hit = torch.arange(cap, device=buf.device)[None, :] == slot[:, None]
    buf = torch.where(hit[..., None], row[:, None, :], buf)
    return (buf, idx + 1)


def drain_ring(ring) -> list[dict]:
    """Records of a ring (or one of slam_tpu's rings, numpy): every written
    row, robot by robot in slot order, with the site's name and ONLY the
    channels that site wrote."""
    if ring is None:
        return []
    buf = ring[0]
    buf = buf.detach().cpu().numpy() if isinstance(buf, torch.Tensor) \
        else np.asarray(buf)
    out = []
    for r in buf.reshape(-1, buf.shape[-1]):
        if not np.isfinite(r).any():
            continue                                  # never written
        site = int(r[len(RING_CHANNELS)])
        mask = int(r[len(RING_CHANNELS) + 1])
        rec = {"name": RING_SITES[site] if 0 <= site < len(RING_SITES)
               else "ring"}
        rec.update({k: float(v) for c, (k, v)
                    in enumerate(zip(RING_CHANNELS, r)) if mask & (1 << c)})
        out.append(rec)
    return out


# ---------- NaN debugging ----------

def nan_debug(enable: bool = True) -> None:
    """Opt-in NaN debugging (slam_tpu sets jax_debug_nans, which raises at
    the primitive that made a NaN; torch has no such trap for forward
    ops). When on, the rollouts (slam2d.rollout, rollout_with_graph,
    slam3d.rollout_3d, shared_map.fleet_rollout_shared) check after every
    tick that each float field of their state is finite, and raise
    FloatingPointError at the first tick and field that is not. Off by
    default; on, it costs one host read a tick (a sync with the card)."""
    global _nan_debug
    _nan_debug = bool(enable)


def nan_debugging() -> bool:
    """Whether nan_debug is on."""
    return _nan_debug


def _float_fields(tree, path: str):
    """(path, tensor) of every float tensor in a state tree of dataclasses
    and tuples. The metrics ring is skipped: its unwritten rows are NaN by
    design."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point():
            yield path, tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            if f.name != "metrics_ring":
                yield from _float_fields(getattr(tree, f.name),
                                         f"{path}.{f.name}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _float_fields(t, f"{path}[{i}]")


def check_finite(tick: int, **trees) -> None:
    """Under nan_debug, raise FloatingPointError naming the tick and the
    first field of `trees` (name=state tree) holding a NaN or an infinity;
    otherwise return at once, reading nothing."""
    if not _nan_debug:
        return
    fields = [f for name, tree in trees.items()
              for f in _float_fields(tree, name)]
    if not fields:
        return
    profiling.count("host_syncs")
    if bool(torch.stack([torch.isfinite(t).all() for _, t in fields]).all()):
        return
    for name, t in fields:
        profiling.count("host_syncs")
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"nan_debug: tick {tick}: {name} is not finite")
