"""Grids split by rows over the sp axis: the slab descriptor and its
exchanges.

On a (dp, sp) mesh with sp > 1 each robot's grids (OccupancyGrid,
PointMapGrid, MlsGrid, the 3D path's GroundMap.grid: leaves (B, H, W,
...)) lie on the sp ranks of its dp row in blocks of h = H / sp rows,
block j on the row's j-th rank: the layout of slam_tpu's
`grid_rows_sharding`, P("dp", "sp", ...). A grid container carries its
split in its static `rows` field (a `Rows`; None when the grid is whole),
and every grid op reads it, so no pipeline signature changes. No rank
ever holds a whole robot grid, nor a whole nearest-centroid field.

Each grid op is a local half, a plain function of this rank's slab and of
what it received, and an exchange over the sp group:
- `halo`: r rows from each neighbouring block (the stencils, the jump
  flood), the grid's outer edges filled with a value the caller chooses
  (`with_halo`);
- `ring` steps: rotate-by-one over the group (the rolls, ops/roll.py);
- `merge_top`: each slab's top-k candidates all-gathered in block order
  and merged by a stable sort (`merge_candidates`), which gives the whole
  grid's order exactly, ties included;
- `owner_select`: each slab's answers to queries that every rank holds
  alike (field lookups, height windows) all-gathered, each element taken
  from the block that owns its row (`select_owned`), exact in bits;
- `all_sum`: an integer all-reduce (class and occupied-cell counts);
- `all_gather`: K5's bit-table words (ops/particle.py).

`GroupExchange` runs them on a torch.distributed group: NCCL moves the
card's tensors; gloo (several ranks on one card, and the CPU tests) stages
CUDA tensors through host memory, because gloo all-gathers no CUDA tensor.
No exchange reads a shift or a count back to the host to size itself: a
roll always takes sp - 1 ring steps, a merge always k candidates a slab.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Rows:
    """Block j of sp of a grid's H rows, and the exchange of its sp group.
    Static: it rides in a grid container's `rows` field."""

    __slots__ = ("comm", "j", "sp", "H")

    def __init__(self, comm, j: int, sp: int, H: int):
        if comm is None:
            raise ValueError("a grid split by rows needs its sp group's "
                             "exchange (a process group)")
        if H % sp:
            raise ValueError(f"grid rows of {H} do not divide over {sp} "
                             "ranks")
        if not 0 <= j < sp:
            raise ValueError(f"block {j} of {sp}")
        self.comm, self.j, self.sp, self.H = comm, j, sp, H

    @property
    def h(self) -> int:
        """Rows of each slab."""
        return self.H // self.sp

    @property
    def r0(self) -> int:
        """The whole grid's index of this slab's first row."""
        return self.j * self.h

    def __repr__(self) -> str:
        return f"Rows(block {self.j} of {self.sp}, {self.h} of {self.H} rows)"


def whole_rows(rows: Rows | None, n: int) -> int:
    """The whole grid's row count: `n` (the slab's own) when not split."""
    return n if rows is None else rows.H


def row_index(rows: Rows | None, n: int, device) -> torch.Tensor:
    """(n,) the whole grid's index of each of a slab's n rows."""
    r = torch.arange(n, device=device)
    return r if rows is None else r + rows.r0


def slab_rows(rows: Rows | None, n: int) -> int:
    """Rows an init function allocates of a grid of n: the slab's h with
    `rows` (whose H must be n), else n."""
    if rows is None:
        return n
    if rows.H != n:
        raise ValueError(f"a split of {rows.H} rows for a grid of {n}")
    return rows.h


def owner_of(r: torch.Tensor, rows: Rows) -> torch.Tensor:
    """The block that holds each of the whole grid's rows r (in [0, H))."""
    return torch.div(r, rows.h, rounding_mode="floor")


class GroupExchange:
    """The exchanges of one sp group: `members` are its global ranks in
    block order, this process among them. Counts the copies between the
    card and the host that its gloo staging makes (`host_copies`, each
    way), which a count of a tick's host syncs must tell from the tick's
    own."""

    def __init__(self, group, members):
        self.group = group
        self.members = [int(m) for m in members]
        self.j = self.members.index(dist.get_rank())
        self.sp = len(self.members)
        self.nccl = dist.get_backend(group) == "nccl"
        self.host_copies = 0

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        if self.nccl or x.device.type == "cpu":
            return x.contiguous()
        self.host_copies += 1
        return x.cpu()

    def _back(self, x: torch.Tensor, device) -> torch.Tensor:
        if x.device != device:
            self.host_copies += 1
        return x.to(device)

    def ring(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """x sent to block j + step, the tensor of block j - step received
        (modulo sp)."""
        dst = self.members[(self.j + step) % self.sp]
        src = self.members[(self.j - step) % self.sp]
        send = self._host(x)
        recv = torch.empty_like(send)
        if self.nccl:
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, dst, self.group),
                dist.P2POp(dist.irecv, recv, src, self.group)])
        else:
            reqs = [dist.isend(send, dst, group=self.group),
                    dist.irecv(recv, src, group=self.group)]
        for r in reqs:
            r.wait()
        return self._back(recv, x.device)

    def all_gather(self, x: torch.Tensor) -> list:
        """Every block's x (equal shapes), in block order."""
        send = self._host(x)
        if self.nccl:
            out = send.new_empty((self.sp,) + tuple(send.shape))
            dist.all_gather_into_tensor(out, send, group=self.group)
            return list(out.unbind(0))
        parts = [torch.empty_like(send) for _ in range(self.sp)]
        dist.all_gather(parts, send, group=self.group)
        return [self._back(p, x.device) for p in parts]

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every block's x (integers: exact in any order)."""
        send = self._host(x).clone()
        dist.all_reduce(send, group=self.group)
        return self._back(send, x.device)


def with_halo(x: torch.Tensor, above, below, fill, j: int,
              sp: int) -> torch.Tensor:
    """Local half of `halo`: slab x (B, h, ...) between the rows received
    from the blocks above and below ((B, r, ...) each), `fill` in place of
    a block beyond the grid's edge. (B, h + 2r, ...)."""
    if j == 0:
        above = torch.full_like(above, fill)
    if j == sp - 1:
        below = torch.full_like(below, fill)
    return torch.cat([above, x, below], 1)


def halo(x: torch.Tensor, r: int, fill, rows: Rows) -> torch.Tensor:
    """Slab x (B, h, ...) with r rows of each neighbouring block on either
    side, `fill` beyond the grid's outer edges: (B, h + 2r, ...)."""
    if r > rows.h:
        raise ValueError(f"a halo of {r} rows from slabs of {rows.h}")
    above = rows.comm.ring(x[:, -r:].contiguous(), 1)   # block j-1's last
    below = rows.comm.ring(x[:, :r].contiguous(), -1)   # block j+1's first
    return with_halo(x, above, below, fill, rows.j, rows.sp)


def _to_words(t: torch.Tensor) -> torch.Tensor:
    """(B, k, ...) as (B, k, n) int32 words: 4-byte floats bitcast, bools
    and integers converted (exact below 2^31)."""
    t = t.reshape(t.shape[0], t.shape[1], -1)
    if t.dtype == torch.float32:
        return t.contiguous().view(torch.int32)
    return t.to(torch.int32)


def _from_words(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    shape = w.shape[:2] + like.shape[2:]
    if like.dtype == torch.float32:
        return w.contiguous().view(torch.float32).reshape(shape)
    return w.to(like.dtype).reshape(shape)


def merge_candidates(blocks: list, capacity: int):
    """Local half of `merge_top`: each block's (score (B, k), payloads
    [(B, k, ...)]) in block order, each sorted as a stable descending sort
    of its slab sorts it -> the `capacity` best of all, by a stable
    descending sort of the candidates joined in block order. Flat indices
    rise with the block, so equal scores keep the whole grid's flat order:
    the result is the whole grid's top `capacity`, ties included."""
    score = torch.cat([s for s, _ in blocks], 1)
    pay = [torch.cat(p, 1) for p in zip(*(p for _, p in blocks))]
    v, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    v, idx = v[:, :capacity], idx[:, :capacity]
    return v, [torch.gather(p, 1, idx.view(idx.shape + (1,) * (p.dim() - 2))
                            .expand(idx.shape + p.shape[2:]))
               for p in pay]


def merge_top(score: torch.Tensor, payloads: list, capacity: int,
              rows: Rows):
    """The whole grid's top `capacity` from this slab's candidates: score
    (B, k) f32 sorted by a stable descending sort and payloads (B, k, ...)
    (among them the candidates' whole-grid flat indices), all-gathered over
    the sp group in one exchange and merged by merge_candidates. Every
    rank of the group gets the same result."""
    parts = [score] + list(payloads)
    words = [_to_words(p) for p in parts]
    sizes = [w.shape[-1] for w in words]
    got = rows.comm.all_gather(torch.cat(words, -1))
    blocks = []
    for g in got:
        cols = [_from_words(w, p) for w, p in
                zip(g.split(sizes, -1), parts)]
        blocks.append((cols[0], cols[1:]))
    return merge_candidates(blocks, capacity)


def select_owned(blocks: list, owner: torch.Tensor) -> torch.Tensor:
    """Local half of `owner_select`: every block's (B, n, ...) answers in
    block order -> (B, n, ...), element (b, k) taken from block owner[b,
    k]. A gather, so the answer keeps the owner's bits (a float sum of
    the other blocks' zeros would turn -0.0 into +0.0)."""
    stacked = torch.stack(blocks)                           # (sp, B, n, ...)
    idx = owner.to(torch.int64).view((1,) + owner.shape +
                                     (1,) * (stacked.dim() - 3))
    idx = idx.expand((1,) + stacked.shape[1:])
    return torch.gather(stacked, 0, idx)[0]


def owner_select(x: torch.Tensor, owner: torch.Tensor,
                 rows: Rows) -> torch.Tensor:
    """This slab's answers x (B, n, ...) to queries that every rank of the
    sp group holds alike, joined with the other slabs' in one all-gather:
    element (b, k) from block owner[b, k] (B, n), the block whose rows
    hold its cell; the same on every rank. x's value where this block is
    not the owner is never read."""
    return select_owned(rows.comm.all_gather(x.contiguous()), owner)


def all_sum(x: torch.Tensor, rows: Rows | None) -> torch.Tensor:
    """x (integers) summed over the sp group; x itself when not split."""
    if rows is None:
        return x
    if x.is_floating_point():
        raise TypeError("all_sum adds integers only: a float sum depends on "
                        "its order")
    return rows.comm.all_reduce(x)
