"""The fleet's rank mesh — counterpart of slam_tpu/parallel/mesh.py.

Mesh axes, as in slam_tpu:
  dp — robots: each rank steps its own slice of the fleet (the reference's
       one robot a process becomes thousands of batched robots a rank);
  sp — rows of each robot's grids, split over the ranks of a dp row.

A Mesh is the (dp, sp) array of ranks; it is built for a rank count
without a process group (layout tests run in one process) and makes its
process groups from that layout once a group is up
(parallel/multihost.init_distributed): each sp column's dp group, each dp
row's sp group and the whole mesh's. The placement rules are slam_tpu's
NamedSharding specs written out as index slices: `fleet_sharding` and
`grid_rows_sharding` give, for each tensor leaf, the slices every rank
owns, exactly what `NamedSharding.devices_indices_map` gives.

On an sp > 1 mesh `shard_fleet` and `shard_grids` place those slices: a
rank holds its dp row's robots, and of their grids (local_map, map_grid,
MLS banks, the 3D path's GroundMap.grid) only its block of rows, the
grid's `rows` field naming the split (parallel/rows.py); the state
outside the grids is the same on every rank of the row. Where XLA inserts
halo collectives, every grid op here exchanges over the sp group itself:
the 2D and 3D ticks with every matcher, the "grid" matcher's field, graph
mode and relocalization all run on split grids. `gather_grids` joins
robots and rows again, for tests and checks. The init functions
(slam2d.init_state, slam3d.init_state_3d, init_ground_map, init_mls)
take `rows=` and allocate the slab alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from slam_tpu_torch.parallel import multihost
from slam_tpu_torch.parallel.rows import GroupExchange, Rows
from slam_tpu_torch.types import GroundMap

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
        self._groups = None
        self._exchange = None

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.ranks.shape))

    @property
    def size(self) -> int:
        return self.ranks.size

    def coords(self, rank: int | None = None) -> tuple:
        """(i, j): the robot shard and row block of `rank` (default this
        process's)."""
        me = multihost.rank() if rank is None else rank
        at = np.argwhere(self.ranks == me)
        if not len(at):
            raise ValueError(f"rank {me} is not in the mesh {self.ranks}")
        return int(at[0][0]), int(at[0][1])

    def _process_groups(self):
        """(dp group of this rank's sp column, sp group of its dp row (None
        for sp = 1), the whole mesh's group), or None for a one-rank mesh
        without a process group. Made at first use, collectively (every
        rank of the world calls it): the columns' groups, then the rows'."""
        if not dist.is_initialized():
            if self.size > 1:
                raise RuntimeError(f"a mesh of {self.size} ranks needs a "
                                   "process group (init_distributed)")
            return None
        if self._groups is None:
            world = list(range(dist.get_world_size()))
            made = {}

            def group(members):
                key = tuple(sorted(int(m) for m in members))
                if key not in made:
                    made[key] = (dist.group.WORLD if list(key) == world
                                 else dist.new_group(list(key)))
                return made[key]
            i, j = self.coords()
            cols = [group(self.ranks[:, c]) for c in range(
                self.ranks.shape[1])]
            rows = [group(self.ranks[r]) if self.ranks.shape[1] > 1
                    else None for r in range(self.ranks.shape[0])]
            self._groups = (cols[j], rows[i], group(self.ranks.ravel()))
        return self._groups

    def dp_group(self):
        """The process group of this rank's sp column (its dp axis: one
        rank of every robot shard), or None for a one-rank mesh without a
        process group. Made at first use, collectively."""
        groups = self._process_groups()
        return None if groups is None else groups[0]

    def sp_group(self):
        """The process group of this rank's dp row (the ranks that split
        its robots' grid rows), None when sp = 1. Made collectively."""
        groups = self._process_groups()
        return None if groups is None else groups[1]

    def group(self):
        """The process group of every rank of the mesh, or None for a
        one-rank mesh without a process group."""
        groups = self._process_groups()
        return None if groups is None else groups[2]

    def rows(self, H: int) -> Rows:
        """This rank's block of a grid's H rows, with its sp group's
        exchange (one for every grid of the rank)."""
        if self.shape["sp"] == 1:
            raise ValueError("rows are split only on an sp > 1 mesh")
        group = self.sp_group()
        if group is None:
            raise RuntimeError("grids split by rows need a process group "
                               "(init_distributed)")
        i, j = self.coords()
        if self._exchange is None:
            self._exchange = GroupExchange(group, self.ranks[i])
        return Rows(self._exchange, j, self.shape["sp"], H)


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


def _grid_rows(grids) -> int:
    """The row count of a grid container: its first leaf of (B, H, W,
    ...)."""
    for f in dataclasses.fields(grids):
        t = getattr(grids, f.name)
        if isinstance(t, torch.Tensor) and t.dim() >= 3:
            return t.shape[1]
    raise ValueError(f"{type(grids).__name__} holds no (B, H, W) leaf")


def _split(mesh: Mesh, grids, me: int):
    """grids (this rank's slice, h rows) with `rows` naming its block of
    the whole h * sp, on an sp > 1 mesh; as they are otherwise."""
    sp = mesh.shape["sp"]
    if sp == 1:
        return grids
    if me != multihost.rank():
        raise ValueError("rows split over an sp group are placed by their "
                         "own rank")
    return grids.replace(rows=mesh.rows(_grid_rows(grids) * sp))


def shard_grids(mesh: Mesh, grids, rank: int | None = None, device=None):
    """This rank's slice of a batch of grid containers (OccupancyGrid,
    PointMapGrid, MlsGrid, GroundMap): its robot shard, and on an sp > 1
    mesh its block of every robot's rows, the container's `rows` naming
    the split (which needs the process group); a GroundMap's cloud is
    split by robots only. On this rank's device
    (multihost.rank_device)."""
    me = multihost.rank() if rank is None else rank
    dev = multihost.rank_device(device)
    if isinstance(grids, GroundMap):
        return GroundMap(
            grid=shard_grids(mesh, grids.grid, rank, device),
            cloud=tree_map(lambda t, s: t[s[me]].to(dev), grids.cloud,
                           tree_map(lambda t: _owned(mesh, t.shape, False),
                                    grids.cloud)))
    return _split(mesh, tree_map(lambda t, s: t[s[me]].to(dev), grids,
                                 grid_rows_sharding(mesh, grids)), me)


def shard_fleet(mesh: Mesh, states, rank: int | None = None, device=None):
    """This rank's robots of a whole fleet's state (`rank` defaults to the
    process's), on this rank's device (multihost.rank_device: its card
    unless `device` says otherwise). On an sp > 1 mesh the robots' own
    grids (local_map, map_grid) hold this rank's block of rows."""
    me = multihost.rank() if rank is None else rank
    dev = multihost.rank_device(device)
    out = tree_map(lambda t, s: t[s[me]].to(dev), states,
                   fleet_sharding(mesh, states))
    out = out.replace(local_map=_split(mesh, out.local_map, me))
    if out.map_grid is not None:
        out = out.replace(map_grid=_split(mesh, out.map_grid, me))
    return out


def _in_order(group, x) -> dict:
    """Every rank's x of `group` (pickled CPU copies: gloo cannot
    all-gather CUDA tensors, and NCCL none on the CPU), keyed by rank."""
    n = dist.get_world_size(group)
    parts = [None] * n
    dist.all_gather_object(parts, x, group=group)
    return dict(zip(sorted(dist.get_process_group_ranks(group)), parts))


def gather_fleet(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every robot shard's `x` (its robots first) joined in dp order, on
    every rank, on x's device. Through host memory, over this rank's sp
    column."""
    group = mesh.dp_group()
    if group is None:
        return x
    by_rank = _in_order(group, x.cpu())
    j = mesh.coords()[1]
    return torch.cat([by_rank[int(r)] for r in mesh.ranks[:, j]]).to(
        x.device)


def gather_grids(mesh: Mesh, grids):
    """The whole batch of grid containers on every rank, robots and rows
    joined (for tests and checks: it builds whole grids), rows None, on
    the grids' device (a GroundMap's cloud joined over robots). Through
    host memory, over the whole mesh."""
    group = mesh.group()
    if group is None:
        return grids
    if isinstance(grids, GroundMap):
        return GroundMap(grid=gather_grids(mesh, grids.grid),
                         cloud=tree_map(lambda t: gather_fleet(mesh, t),
                                        grids.cloud))
    dev = next(t for t in (getattr(grids, f.name)
                           for f in dataclasses.fields(grids))
               if isinstance(t, torch.Tensor)).device
    by_rank = _in_order(group, tree_map(lambda t: t.cpu(),
                                        grids.replace(rows=None)))
    dp, sp = mesh.ranks.shape
    parts = [by_rank[int(r)] for r in mesh.ranks.ravel()]

    def join(*leaves):
        blocks = [leaves[i * sp:(i + 1) * sp] for i in range(dp)]
        if leaves[0].dim() >= 3:
            whole = [torch.cat(b, 1) for b in blocks]
        else:
            whole = [b[0] for b in blocks]
        return torch.cat(whole).to(dev)
    return tree_map(join, parts[0], *parts[1:])
