"""The fleet's rank mesh — counterpart of slam_tpu/parallel/mesh.py.

Mesh axes, as in slam_tpu:
  dp — robots: each rank steps its own slice of the fleet (the reference's
       one robot a process becomes thousands of batched robots a rank);
  sp — rows of each robot's grids, split over the ranks of a column.

A Mesh is the (dp, sp) array of ranks; it is built for a rank count
without a process group (layout tests run in one process) and makes its
dp process group from that layout once a group is up
(parallel/multihost.init_distributed). The placement rules are slam_tpu's
NamedSharding specs written out as index slices: `fleet_sharding` and
`grid_rows_sharding` give, for each tensor leaf, the slices every rank
owns, exactly what `NamedSharding.devices_indices_map` gives.

The sp axis is layout only: stepping a fleet whose grid rows are split
needs a halo exchange in every grid op (the rolls, the point-map and
occupancy scatters, the export's top-k, the particle scoring's reads),
which is ROADMAP queue 1's next item. Until then placing or rolling a
fleet on an sp > 1 mesh raises NotImplementedError; rows are never
replicated silently.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from slam_tpu_torch.parallel import multihost

AXES = ("dp", "sp")


class Mesh:
    """A (dp, sp) array of ranks. `ranks[i, j]` holds robot shard i and grid
    row block j."""

    def __init__(self, ranks):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        if self.ranks.ndim != 2:
            raise ValueError(f"a mesh is a (dp, sp) array of ranks, got "
                             f"shape {self.ranks.shape}")
        self.axis_names = AXES
        self._dp_group = None

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.ranks.shape))

    @property
    def size(self) -> int:
        return self.ranks.size

    def dp_group(self):
        """The process group of the dp axis (sp == 1: every rank of the
        mesh), or None for a one-rank mesh without a process group. Made
        at first use, collectively: every rank of the world calls it."""
        require_dp_only(self, "a dp collective")
        if not dist.is_initialized():
            if self.size > 1:
                raise RuntimeError(f"a mesh of {self.size} ranks needs a "
                                   "process group (init_distributed)")
            return None
        if self._dp_group is None:
            members = sorted(self.ranks[:, 0].tolist())
            if members == list(range(dist.get_world_size())):
                self._dp_group = dist.group.WORLD
            else:
                self._dp_group = dist.new_group(members)
        return self._dp_group


def require_dp_only(mesh: Mesh, what: str) -> None:
    """Raise NotImplementedError for `what` on an sp > 1 mesh."""
    if mesh.shape["sp"] > 1:
        raise NotImplementedError(
            f"{what} on a mesh with sp={mesh.shape['sp']}: stepping grids "
            "whose rows are split over ranks needs the sp axis's halo "
            "exchange, not yet ported (ROADMAP.md, queue 1); use sp=1")


def make_mesh(n_devices: int | None = None, sp: int = 1) -> Mesh:
    """Mesh over (dp, sp): the first n_devices ranks (default: the world
    size, 1 without a process group), dp = n_devices / sp."""
    if n_devices is None:
        n_devices = multihost.world_size()
    if n_devices % sp != 0:
        raise ValueError(
            f"n_devices={n_devices} must be divisible by sp={sp} "
            "(the (dp, sp) mesh is a full factorization — a floor division "
            "would silently drop devices)")
    return Mesh(np.arange(n_devices).reshape(n_devices // sp, sp))


def tree_map(fn, tree, *rest):
    """fn over the tensors of a state tree (dataclasses and tuples), with
    the matching leaves of `rest` as further arguments; None and static
    fields (floats, ints) stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return tree


def _block(n: int, parts: int, i: int, what: str) -> slice:
    """Block i of `parts` of a dim of n; the whole dim (slice(None), as
    JAX writes it) on an axis of one rank."""
    if parts == 1:
        return slice(None)
    if n % parts:
        raise ValueError(f"{what} of {n} does not divide over {parts} ranks")
    k = n // parts
    return slice(i * k, (i + 1) * k)


def _owned(mesh: Mesh, shape, rows_over_sp: bool) -> dict:
    """{rank: index slices} of a leaf of `shape`: dim 0 over dp, with
    rows_over_sp dim 1 over sp too, a 0-dim leaf on every rank whole."""
    dp, sp = mesh.ranks.shape
    out = {}
    for (i, j), r in np.ndenumerate(mesh.ranks):
        if not len(shape):
            out[int(r)] = ()
            continue
        idx = [slice(None)] * len(shape)
        idx[0] = _block(shape[0], dp, i, "a batch")
        if rows_over_sp:
            idx[1] = _block(shape[1], sp, j, "grid rows")
        out[int(r)] = tuple(idx)
    return out


def grid_rows_sharding(mesh: Mesh, tree):
    """The slices each rank owns of a batched grid container
    (OccupancyGrid, PointMapGrid, MlsGrid, ...): every leaf shaped (B, H,
    W, ...) splits its batch over dp and its rows over sp; smaller leaves
    (centres, origins) split their batch over dp only. A tree of the same
    structure, each tensor replaced by {rank: tuple of slices}."""
    return tree_map(lambda t: _owned(mesh, t.shape, t.dim() >= 3), tree)


def fleet_sharding(mesh: Mesh, states):
    """The slices each rank owns of a batched SlamState: the batch over dp;
    the robots' own grids (occupancy, point map) their rows over sp too."""
    sh = tree_map(lambda t: _owned(mesh, t.shape, False), states)
    sh = sh.replace(local_map=grid_rows_sharding(mesh, states.local_map))
    if states.map_grid is not None:
        sh = sh.replace(map_grid=grid_rows_sharding(mesh, states.map_grid))
    return sh


def shard_fleet(mesh: Mesh, states, rank: int | None = None, device=None):
    """This rank's robots of a whole fleet's state (`rank` defaults to the
    process's), on this rank's device (multihost.rank_device: its card
    unless `device` says otherwise). Raises NotImplementedError on an sp >
    1 mesh."""
    require_dp_only(mesh, "placing a fleet")
    me = multihost.rank() if rank is None else rank
    dev = multihost.rank_device(device)
    return tree_map(lambda t, s: t[s[me]].to(dev), states,
                    fleet_sharding(mesh, states))


def gather_fleet(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` (its robots first) joined in dp order, on every
    rank, on x's device. Through host memory, as pickled tensors: gloo
    cannot all-gather CUDA tensors, and NCCL none on the CPU."""
    group = mesh.dp_group()
    if group is None:
        return x
    parts = [None] * mesh.size
    dist.all_gather_object(parts, x.cpu(), group=group)
    members = sorted(mesh.ranks[:, 0].tolist())
    by_rank = dict(zip(members, parts))
    return torch.cat([by_rank[int(r)] for r in mesh.ranks[:, 0]]).to(
        x.device)
