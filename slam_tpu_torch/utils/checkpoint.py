"""Checkpoint / resume of a whole state — counterpart of
slam_tpu/utils/checkpoint.py.

The port writes numpy `.npz` files only (orbax is a JAX library): one
array per tensor of the state, keyed by its field path ("ekf.mu",
"map_grid.count", "metrics_ring.0"), so a file names what it holds. A path
without the ".npz" suffix gets it. `restore` fills a template of the same
structure (its shapes and dtypes) and raises when the file's tensors do
not match it.

`restore` also reads slam_tpu's npz layout (its orbax-free fallback:
leaves "leaf_0" ... in the order jax.tree.flatten gives them) into a port
state of the same content, for instance one that interop.state_from_numpy
carried across: the leaves are matched by slam_tpu's field order, a
single robot's leaves take the template's batch of 1, and the JAX state's
random key, which the port does not hold, is skipped.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

# slam_tpu's SlamState field order (its pytree's leaf order); "rng" is the
# JAX random key, which the port does not hold. Every other container has
# the same fields in the same order in both packages.
_SLAM_TPU_ORDER = {"SlamState": (
    "ekf", "pose", "scan_reg_pose", "scan_reg_ok", "local_map", "prev_scene",
    "map_cloud", "map_grid", "graph", "graph_full", "step", "true_pose",
    "rng", "metrics_ring", "attitude", "prev_ground")}


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _leaves(x, prefix: str = "", slam_tpu_order: bool = False) -> list:
    """(field path, tensor) pairs of a state, in field order (slam_tpu's
    when asked; a JAX-only leaf gives (path, None))."""
    if isinstance(x, torch.Tensor):
        return [(prefix, x)]
    if dataclasses.is_dataclass(x):
        names = [f.name for f in dataclasses.fields(x)]
        if slam_tpu_order and type(x).__name__ in _SLAM_TPU_ORDER:
            names = _SLAM_TPU_ORDER[type(x).__name__]
        out = []
        for n in names:
            if not hasattr(x, n):
                out.append((prefix + n, None))
                continue
            out += _leaves(getattr(x, n), prefix + n + ".", slam_tpu_order)
        return out
    if isinstance(x, tuple):
        out = []
        for i, v in enumerate(x):
            out += _leaves(v, f"{prefix}{i}.", slam_tpu_order)
        return out
    return []        # None and static fields (floats, ints) hold no tensor


def _rebuild(x, new: dict, prefix: str = ""):
    if isinstance(x, torch.Tensor):
        return new[prefix]
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _rebuild(getattr(x, f.name), new, prefix + f.name + ".")
            for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(_rebuild(v, new, f"{prefix}{i}.")
                     for i, v in enumerate(x))
    return x


def save(path: str, state: Any) -> None:
    """Write every tensor of `state` to an npz file."""
    np.savez_compressed(_npz_path(path), **{
        k.rstrip("."): v.detach().cpu().numpy() for k, v in _leaves(state)})


def restore(path: str, like: Any) -> Any:
    """A state of `like`'s structure, shapes, dtypes and device from the
    npz file at path (the port's layout or slam_tpu's)."""
    npz_file = _npz_path(path)
    if not os.path.exists(npz_file):
        raise FileNotFoundError(f"no checkpoint found: {npz_file} does not "
                                f"exist")
    with np.load(npz_file) as npz:
        files = set(npz.files)
        if "leaf_0" in files:
            order = _leaves(like, slam_tpu_order=True)
            if len(files) != len(order):
                raise ValueError(
                    f"checkpoint at {npz_file} has {len(files)} leaves, the "
                    f"template {len(order)} in slam_tpu's layout")
            arrays = {k: npz[f"leaf_{i}"] for i, (k, t) in enumerate(order)
                      if t is not None}
        else:
            names = [k for k, _ in _leaves(like)]
            if files != {k.rstrip(".") for k in names}:
                raise ValueError(
                    f"checkpoint at {npz_file} holds {sorted(files)}, the "
                    f"template {sorted(k.rstrip('.') for k in names)}")
            arrays = {k: npz[k.rstrip(".")] for k in names}
    new = {}
    for k, t in _leaves(like):
        a = arrays[k]
        if a.size != t.numel():
            raise ValueError(f"checkpoint leaf {k.rstrip('.')} has shape "
                             f"{a.shape}, the template {tuple(t.shape)}")
        new[k] = torch.as_tensor(a.reshape(tuple(t.shape))).to(
            dtype=t.dtype, device=t.device)
    return _rebuild(like, new)
