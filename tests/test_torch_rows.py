"""Port, the sp axis's slab ops (parallel/rows.py and every grid op that
reads a grid's `rows`) against the same op on the whole grid, in one
process: sp = 2 and 4, each block of rows a thread whose exchanges go
through a loopback (the threads meet at a barrier), the blocks' results
stitched back into whole grids.

Exact throughout: counts, flags, rolled cells, exports (order and values,
ties included), bit tables, the "grid" matcher's field (px, py, valid,
n_class), its lookups and fits, and the height window's reads are equal;
float sums that a scatter adds point by point are held within 1e-6 (on
the CPU each cell adds its points in the same order, so they are equal
too). The field is also held to slam_tpu's within 1e-6.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu.mapping import point_map as jpm
from slam_tpu.ops import grid_icp as jg
from slam_tpu_torch.config import HeightConfig, IcpConfig, MlsConfig
from slam_tpu_torch.mapping import mls as tmls
from slam_tpu_torch.mapping import occupancy as tocc
from slam_tpu_torch.mapping import point_map as tpm
from slam_tpu_torch.ops import (grid_icp, height, particle, roll, scatter2d,
                                stencil)
from slam_tpu_torch.parallel import rows as trows
from slam_tpu_torch.parallel.mesh import tree_map
from slam_tpu_torch.types import OccupancyGrid, PointCloud
from tests.test_mls_parity import _terrain_scans
from tests.torch_parity import assert_close, assert_equal

torch.set_num_threads(1)

B = 3
G = 32
SPS = [2, 4]


class Loopback:
    """The exchanges of an sp group whose blocks run as threads of one
    process: each call posts this block's tensor and reads the others'
    between two barriers."""

    def __init__(self, sp):
        self.sp = sp
        self.slots = [None] * sp
        self.barrier = threading.Barrier(sp, timeout=60)

    def member(self, j):
        hub = self

        class Member:
            def _swap(self, x):
                hub.slots[j] = x
                hub.barrier.wait()
                got = list(hub.slots)
                hub.barrier.wait()
                return got

            def ring(self, x, step):
                return self._swap(x)[(j - step) % hub.sp].clone()

            def all_gather(self, x):
                return [t.clone() for t in self._swap(x)]

            def all_reduce(self, x):
                return sum(self._swap(x))
        return Member()


def on_blocks(sp, fn):
    """[fn(j, exchange) for each block j], the blocks run concurrently on
    threads that share a Loopback; the first failure re-raised."""
    hub = Loopback(sp)
    out, errors = [None] * sp, []

    def run(j):
        try:
            out[j] = fn(j, hub.member(j))
        except BaseException as e:        # re-raised below
            errors.append(e)
            hub.barrier.abort()
    threads = [threading.Thread(target=run, args=(j,)) for j in range(sp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return out


def slab(grid, j, sp, comm):
    """Block j of sp of a whole grid container's rows, `rows` set."""
    H = next(t.shape[1] for t in (getattr(grid, f.name)
                                  for f in dataclasses.fields(grid))
             if isinstance(t, torch.Tensor) and t.dim() >= 3)
    h = H // sp
    return tree_map(lambda t: t[:, j * h:(j + 1) * h] if t.dim() >= 3
                    else t, grid).replace(rows=trows.Rows(comm, j, sp, H))


def stitch(slabs):
    """Whole grids from their blocks (rows None)."""
    return tree_map(lambda *ts: torch.cat(ts, 1) if ts[0].dim() >= 3
                    else ts[0], *slabs).replace(rows=None)


def split_run(grid, sp, fn):
    """fn(slab) on every block of grid, the results in block order."""
    return on_blocks(sp, lambda j, c: fn(slab(grid, j, sp, c)))


def same_on_blocks(results, check):
    """`check(r)` on block 0's result, and every block's equal to it."""
    check(results[0])
    for r in results[1:]:
        tree_map(lambda a, b: assert_equal(a, b), r, results[0])


# shifts (B, 2): none; one row each way; a slab's height or more (an EKF
# shift after a relocalization); opposite signs on two robots
def shifts(case, sp):
    h = G // sp
    return torch.tensor({
        "zero": [[0, 0], [0, 0], [0, 0]],
        "one": [[1, 0], [-1, 2], [1, -1]],
        "slab": [[h, 3], [-h - 1, 0], [2 * h + 3, -5]],
        "opposite": [[3, 1], [-5, -2], [0, 7]],
        "beyond": [[G + 2, 0], [-G, 1], [G - 1, -G - 3]],
    }[case], dtype=torch.int32)


CASES = ["zero", "one", "slab", "opposite", "beyond"]


def _point_map(seed=0):
    g = torch.Generator().manual_seed(seed)
    count = torch.randint(0, 4, (B, G, G), generator=g).float()
    count[:, :, ::5] = 0.0
    return tpm.PointMapGrid(
        count=count, sum_x=torch.randn(B, G, G, generator=g),
        sum_y=torch.randn(B, G, G, generator=g),
        sum_z=torch.randn(B, G, G, generator=g),
        center=torch.tensor([[0.0, 0.0], [1.5, -2.0], [-3.0, 4.5]]),
        resolution=0.5)


def _occupancy(seed=1):
    g = torch.Generator().manual_seed(seed)
    return OccupancyGrid(
        counts=torch.randint(0, 6, (B, G, G), generator=g).float(),
        drivable=torch.randint(-1, 2, (B, G, G), generator=g).to(torch.int8),
        origin=torch.zeros(B, 2, dtype=torch.int32),
        center=torch.tensor([[0.0, 0.0], [0.25, -0.5], [1.0, 1.0]]))


def _mls_cfg():
    return MlsConfig(size_x=G, size_y=G, resolution=0.5, max_range=30.0,
                     update_dist=16)


def _cloud(seed, n=900):
    """Terrain scans of robots seeded seed + b, every fifth point masked,
    scaled by 0.8 and moved 4 m in -x, so that the step ridge runs along
    the grid's middle row, a slab boundary for sp = 2 and 4."""
    xyz = np.stack([_terrain_scans(seed + b, 1, n)[0] for b in range(B)])
    xyz[..., :2] *= np.float32(0.8)
    xyz[..., 0] -= np.float32(4.0)
    valid = np.ones(xyz.shape[:-1], bool)
    valid[:, ::5] = False
    return PointCloud(xyz=torch.from_numpy(xyz),
                      valid=torch.from_numpy(valid),
                      flags=torch.zeros(valid.shape, dtype=torch.int32))


def _mls_grid(folds=3):
    cfg = _mls_cfg()
    grid = tmls.init_mls(cfg, B, device="cpu")
    for k in range(folds):
        grid = tmls.add_to_mls(grid, _cloud(10 * k), cfg)
    return grid


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("case", CASES)
def test_roll_2d_ring(sp, case):
    """roll_2d on a slab through sp - 1 ring steps equals the whole grid's
    roll, wrap-around rows included, for a trailing channel dim too."""
    a = torch.arange(B * G * G * 2, dtype=torch.float32).reshape(B, G, G, 2)
    d = shifts(case, sp)
    got = split_run(OccupancyGrid(counts=a, drivable=a[..., 0], origin=d,
                                  center=d.float()), sp,
                    lambda s: roll.roll_2d(s.counts, d, s.rows))
    assert_equal(torch.cat(got, 1), roll.roll_2d(a, d))


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("case", CASES)
def test_shift_point_map_and_origin(sp, case):
    """shift_point_map and shift_origin (fresh rows cleared by the slab's
    global rows) equal the whole grid's, channels packed into one ring."""
    d = shifts(case, sp)
    pm, occ = _point_map(), _occupancy()
    new_pm = pm.center + d.float() * pm.resolution
    new_occ = occ.center + d.float() * 0.5
    cfg = _mls_cfg()
    want_pm = tpm.shift_point_map(pm, new_pm)
    want_occ = tocc.shift_origin(occ, new_occ, cfg)
    got = on_blocks(sp, lambda j, c: (
        tpm.shift_point_map(slab(pm, j, sp, c), new_pm),
        tocc.shift_origin(slab(occ, j, sp, c), new_occ, cfg)))
    for want, k in ((want_pm, 0), (want_occ, 1)):
        tree_map(assert_equal, stitch([g[k] for g in got]), want)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("radius", [1, 2])
def test_box_sum_halo(sp, radius):
    """neighbor_sum_2d with a halo of `radius` rows: a slab boundary sums
    the neighbour's real rows, zeros only at the grid's outer edges."""
    g = torch.Generator().manual_seed(3)
    x = (torch.rand(B, G, G, generator=g) < 0.5).float()
    got = split_run(OccupancyGrid(counts=x, drivable=x, origin=x[:, 0],
                                  center=x[:, 0]), sp,
                    lambda s: stencil.neighbor_sum_2d(s.counts, radius,
                                                      s.rows))
    assert_equal(torch.cat(got, 1), stencil.neighbor_sum_2d(x, radius))


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("capacity", [40, 300, G * G + 5])
def test_export_point_planes_ties_and_ga(sp, capacity):
    """The export merged over the blocks equals the whole grid's: integer
    counts 0-3 put tied scores on both sides of every slab boundary, the
    capacity cuts inside a tie group, and the GA flags of the rows that
    border a slab read the neighbour's row."""
    pm = _point_map()
    want = tpm.export_point_planes(pm, capacity, ga_threshold=2)
    got = split_run(pm, sp, lambda s: tpm.export_point_planes(
        s, capacity, ga_threshold=2))

    def check(r):
        for a, b in zip(r, want):
            assert_equal(a, b)
    same_on_blocks(got, check)
    h = G // sp
    ga_cells = (pm.count >= 1) & (stencil.neighbor_sum_2d(
        (pm.count < 1).float()) >= 2)
    assert bool(ga_cells[:, h - 1:h + 1].any()) and int(want[3].sum()) > 0


@pytest.mark.parametrize("sp", SPS)
def test_update_point_map_scatter_outside_slab(sp):
    """update_point_map_xy keeps the points of the slab's rows: points on
    every row, off the grid, masked, and with NaN coordinates masked."""
    g = torch.Generator().manual_seed(4)
    pm = _point_map()
    qx = torch.rand(B, 500, generator=g) * 20 - 10 + pm.center[:, 0:1]
    qy = torch.rand(B, 500, generator=g) * 20 - 10 + pm.center[:, 1:2]
    qz = torch.randn(B, 500, generator=g)
    valid = torch.rand(B, 500, generator=g) < 0.9
    qx[:, ::7] = float("nan")
    valid[:, ::7] = False
    want = tpm.update_point_map_xy(pm, qx, qy, qz, valid)
    got = stitch(split_run(pm, sp, lambda s: tpm.update_point_map_xy(
        s, qx, qy, qz, valid)))
    assert_equal(got.count, want.count)
    for n in ("sum_x", "sum_y", "sum_z"):
        assert_close(getattr(got, n), getattr(want, n), atol=1e-6)
    assert float((got.count - pm.count).sum()) > 0


@pytest.mark.parametrize("sp", SPS)
def test_occupancy_updates_and_cloud(sp):
    """add_to_occupancy_xy, add_to_occupancy_xy2 and add_to_occupancy on
    slabs, then occupancy_cloud's merged top cells (counts tie often)."""
    cfg = dataclasses.replace(_mls_cfg(), max_range=7.0)
    occ = _occupancy()
    g = torch.Generator().manual_seed(5)
    ox, oy, gx, gy = (torch.rand(B, 400, generator=g) * 18 - 9
                      for _ in range(4))
    ov = torch.rand(B, 400, generator=g) < 0.8
    gv = torch.rand(B, 400, generator=g) < 0.8
    obst = PointCloud(xyz=torch.stack([ox, oy, torch.zeros_like(ox)], -1),
                      valid=ov, flags=torch.zeros(B, 400, dtype=torch.int32))
    gnd = obst.replace(xyz=torch.stack([gx, gy, torch.zeros_like(gx)], -1),
                       valid=gv)

    def ops(o):
        o = tocc.add_to_occupancy_xy(o, ox, oy, ov, cfg)
        o = tocc.add_to_occupancy_xy2(o, ox, oy, ov, gx, gy, gv, cfg)
        o = tocc.add_to_occupancy(o, obst, gnd, cfg)
        return o, tocc.occupancy_cloud(o, cfg, 150)
    want, want_cloud = ops(occ)
    got = split_run(occ, sp, ops)
    tree_map(assert_equal, stitch([r[0] for r in got]), want)
    same_on_blocks([r[1] for r in got],
                   lambda c: tree_map(assert_equal, c, want_cloud))
    assert int(want_cloud.valid.sum()) > 0


@pytest.mark.parametrize("sp", SPS)
def test_scatter_max_rows(sp):
    g = torch.Generator().manual_seed(6)
    cx = torch.randint(-3, G + 3, (B, 300), generator=g)
    cy = torch.randint(-3, G + 3, (B, 300), generator=g)
    v = torch.rand(B, 300, generator=g)
    ok = torch.rand(B, 300, generator=g) < 0.9
    want = scatter2d.scatter_max_2d(cx, cy, v, ok, (G, G))
    got = on_blocks(sp, lambda j, c: scatter2d.scatter_max_2d(
        cx, cy, v, ok, (G // sp, G), rows=trows.Rows(c, j, sp, G)))
    assert_equal(torch.cat(got, 1), want)


@pytest.mark.parametrize("sp", SPS)
def test_mls_fold_shift_and_export(sp):
    """add_to_mls on slabs (drivability on the rows beside a boundary reads
    the neighbour's slot 0 through an +inf-filled halo), shift_origin_mls
    by more than a slab, and get_segmented_clouds' merged top clusters."""
    cfg = _mls_cfg()
    grid = _mls_grid(2)
    cloud = _cloud(50)
    d = shifts("slab", sp)
    new_center = grid.center + d.float() * cfg.resolution

    def ops(s):
        s = tmls.add_to_mls(s, cloud, cfg)
        folded = s
        s = tmls.shift_origin_mls(s, new_center, cfg)
        s = tmls.add_to_mls(s, _cloud(60), cfg)
        return folded, s, tmls.get_segmented_clouds(s, cfg, 200)
    w_fold, w_grid, (w_obs, w_gnd) = ops(grid)
    got = split_run(grid, sp, ops)
    for k, want in ((0, w_fold), (1, w_grid)):
        whole = stitch([r[k] for r in got])
        for n in ("num_pts", "drivable", "origin", "center"):
            assert_equal(getattr(whole, n), getattr(want, n))
        for n in ("mean", "var_z"):
            assert_close(getattr(whole, n), getattr(want, n), atol=1e-6)
    same_on_blocks([r[2] for r in got], lambda c: (
        tree_map(assert_equal, c[0], w_obs),
        tree_map(assert_equal, c[1], w_gnd)))
    drv = w_fold.drivable[:, G // 2 - 1:G // 2 + 1]   # beside a boundary
    assert bool((drv == 1).any()) and bool((drv == 0).any())
    assert int(w_gnd.valid.sum()) > 0 and int(w_obs.valid.sum()) > 0


@pytest.mark.parametrize("sp", SPS)
def test_k5_table_from_slab_words(sp):
    """K5's bit table all-gathered from the slabs' words equals
    occupancy_bits_reference of the whole grid; the plain scorer and
    pf_match read it to the same results as on the whole grid."""
    pm = _point_map()
    pm = pm.replace(count=torch.where(pm.count > 1, pm.count, 0.0),
                    center=pm.center[:1].expand(B, 2).clone())
    g = torch.Generator().manual_seed(7)
    scan = PointCloud(xyz=torch.randn(B, 64, 3, generator=g) * 4,
                      valid=torch.rand(B, 64, generator=g) < 0.9,
                      flags=torch.zeros(B, 64, dtype=torch.int32))
    pred = torch.randn(B, 3, generator=g)
    noise = torch.randn(B, 16, 3, generator=g)
    u = torch.rand(B, generator=g)
    cfg = particle.PFConfig(num_particles=16)
    parts = pred[:, None] + noise * 0.3
    want_bits = particle.occupancy_bits_reference(pm.count)
    want_score = particle.score_particles_reference(
        pm, scan.xyz[..., :2], scan.valid, parts, 0.5)
    want_pf = particle.pf_match(pm, scan, pred, 0.5, cfg, noise=noise, u=u)

    def ops(s):
        return (particle.occupancy_bits(s),
                particle.score_particles_reference(
                    s, scan.xyz[..., :2], scan.valid, parts, 0.5),
                particle.pf_match(s, scan, pred, 0.5, cfg, noise=noise,
                                  u=u))
    got = split_run(pm, sp, ops)
    same_on_blocks(got, lambda r: (
        assert_equal(r[0], want_bits), assert_equal(r[1], want_score),
        [assert_equal(a, b) for a, b in zip(r[2], want_pf)]))
    assert 0 < float(want_score.mean()) < 1


def test_slab_words_must_align():
    """A slab whose cells are not whole 32-bit words raises."""
    with pytest.raises(ValueError, match="word-aligned"):
        particle._slab_words(torch.zeros(1, 3, 10))


def test_merge_candidates_keeps_flat_order():
    """The local half of merge_top: blocks' sorted candidates with equal
    scores on both sides come back in flat order."""
    blocks = [(torch.tensor([[3.0, 1.0, 1.0]]), [torch.tensor([[2, 0, 5]])]),
              (torch.tensor([[3.0, 1.0, 0.0]]), [torch.tensor([[9, 8, 7]])])]
    v, (idx,) = trows.merge_candidates(blocks, 5)
    assert_equal(v, torch.tensor([[3.0, 3.0, 1.0, 1.0, 1.0]]))
    assert_equal(idx, torch.tensor([[2, 9, 0, 5, 8]]))


def test_with_halo_fills_outer_edges():
    x = torch.ones(1, 2, 3)
    up, down = torch.full((1, 1, 3), 5.0), torch.full((1, 1, 3), 6.0)
    assert_equal(trows.with_halo(x, up, down, 0.0, 0, 2)[:, [0, 3]],
                 torch.tensor([[[0.0] * 3, [6.0] * 3]]))
    assert_equal(trows.with_halo(x, up, down, -1.0, 1, 3)[:, [0, 3]],
                 torch.tensor([[[5.0] * 3, [6.0] * 3]]))


def test_rows_need_an_exchange_and_refuse():
    """A split grid needs its group's exchange; with one, the "grid"
    matcher's field builds on a slab (h of the G rows) instead of
    refusing."""
    with pytest.raises(ValueError, match="process group"):
        trows.Rows(None, 0, 2, G)
    with pytest.raises(ValueError, match="divide"):
        trows.Rows(object(), 0, 3, G)
    pm = _point_map()
    s = slab(pm, 0, 2, object())
    assert repr(s.rows) == "Rows(block 0 of 2, 16 of 32 rows)"
    fields = split_run(pm, 2, lambda s: grid_icp.nearest_point_field(s, 0.5))
    assert fields[0].px.shape == (B, 2, G // 2, G)
    assert fields[1].rows.j == 1 and fields[1].rows.H == G
    with pytest.raises(ValueError, match="a split of 32 rows"):
        tpm.init_point_map(B, 16, rows=trows.Rows(object(), 0, 2, G),
                           device="cpu")


RES = 0.5
# slam_tpu's field, vmapped over robots, compiled once
_jax_field = jax.jit(jax.vmap(lambda g: jg.nearest_point_field(g, RES)))


def _sparse_point_map(seed=8):
    """Occupied cells on the rows one to four from every slab boundary of
    sp = 2 and 4 (8, 16, 24), on the grid's outer rows and a few between;
    half the centroids at their cell centre, so that many flood candidates
    tie and slam_tpu's visit order decides."""
    g = torch.Generator().manual_seed(seed)
    count = torch.zeros(B, G, G)
    near = [r for b in (8, 16, 24) for r in (b - 4, b - 3, b - 1, b, b + 1,
                                             b + 3)] + [0, 1, G - 2, G - 1]
    for r in near + [5, 12, 19, 28]:
        cols = torch.randint(0, G, (B, 3), generator=g)
        count[torch.arange(B)[:, None], r, cols] = torch.randint(
            1, 4, (B, 3), generator=g).float()
    count[:, 14:18, 10:14] = 2.0                    # a block: inner cells NGA
    off = (torch.rand(B, G, G, generator=g) - 0.5) * RES * count
    centred = torch.rand(B, G, G, generator=g) < 0.5
    off = torch.where(centred, 0.0, off)
    off_y = torch.where(centred, 0.0, (torch.rand(B, G, G, generator=g) - 0.5)
                        * RES * count)
    return tpm.PointMapGrid(
        count=count, sum_x=off, sum_y=off_y, sum_z=torch.zeros(B, G, G),
        center=torch.tensor([[0.0, 0.0], [1.5, -2.0], [-3.0, 4.5]]),
        resolution=RES)


def _field_arrays(f):
    return (f.px, f.py, f.valid)


@pytest.mark.parametrize("sp", SPS)
def test_nearest_point_field_on_slabs(sp):
    """The field built on slabs (a halo a visit from the neighbouring
    slab's current rows, n_class summed over the group) equals the whole
    grid's in bits, and slam_tpu's within 1e-6 (valid and n_class
    exact)."""
    pm = _sparse_point_map()
    want = grid_icp.nearest_point_field(pm, RES)
    got = split_run(pm, sp, lambda s: grid_icp.nearest_point_field(s, RES))
    for k, whole in enumerate(_field_arrays(want)):
        assert_equal(torch.cat([_field_arrays(f)[k] for f in got], 2), whole)
    for f in got:
        assert_equal(f.n_class, want.n_class)
        assert f.rows.sp == sp
    jf = _jax_field(jpm.PointMapGrid(
        count=jnp.asarray(pm.count.numpy()),
        sum_x=jnp.asarray(pm.sum_x.numpy()),
        sum_y=jnp.asarray(pm.sum_y.numpy()),
        sum_z=jnp.asarray(pm.sum_z.numpy()),
        center=jnp.asarray(pm.center.numpy()), resolution=RES))
    assert_equal(want.valid, np.asarray(jf.valid))
    assert_equal(want.n_class, np.asarray(jf.n_class).astype(np.int32))
    assert_close(want.px, np.asarray(jf.px), atol=1e-6)
    assert_close(want.py, np.asarray(jf.py), atol=1e-6)
    # the flood crosses every boundary: cells beside one take a centroid
    # from the other side
    h = G // sp
    assert bool((want.valid[:, :, h - 1] & (pm.count[:, None, h - 1] == 0))
                .any()) and int(want.n_class[:, 1].sum()) > 0


def _queries(seed=9, S=200):
    """Queries over every slab, some off the grid on each side."""
    g = torch.Generator().manual_seed(seed)
    q = (torch.rand(B, S, 2, generator=g) - 0.5) * (G + 8) * RES
    q = q + torch.tensor([[0.0, 0.0], [1.5, -2.0], [-3.0, 4.5]])[:, None]
    return q, torch.rand(B, S, generator=g) < 0.5


@pytest.mark.parametrize("sp", SPS)
def test_lookup_and_fit_on_field_slabs(sp):
    """lookup on field slabs (each rank answers the queries of its rows,
    one owner_select joins them) equals the whole field's, queries in
    every slab and off the grid; icp_fit_grid ("while" and "scan")
    equals the whole grid's fit."""
    pm = _sparse_point_map()
    q, q_ga = _queries()
    want = grid_icp.lookup(grid_icp.nearest_point_field(pm, RES), q, q_ga)
    scene = q[:, :120] * 0.3
    init = torch.tensor([[0.2, -0.1, 0.05], [1.4, -1.8, -0.1],
                         [-3.1, 4.3, 0.0]])
    fits = {loop: IcpConfig(loop=loop, max_iterations=6, inlier_dist=4.0,
                            min_scene_points=10) for loop in ("while", "scan")}
    want_fit = {k: grid_icp.icp_fit_grid(
        scene, torch.ones(B, 120, dtype=torch.bool), q_ga[:, :120],
        grid_icp.nearest_point_field(pm, RES), init, c)
        for k, c in fits.items()}

    def ops(s):
        f = grid_icp.nearest_point_field(s, RES)
        return grid_icp.lookup(f, q, q_ga), {k: grid_icp.icp_fit_grid(
            scene, torch.ones(B, 120, dtype=torch.bool), q_ga[:, :120], f,
            init, c) for k, c in fits.items()}
    got = split_run(pm, sp, ops)
    for r in got:
        assert_equal(r[0][0], want[0])
        assert_equal(r[0][1], want[1])
        for k in fits:
            tree_map(assert_equal, r[1][k]._asdict(), want_fit[k]._asdict())
    rows = torch.floor((q[..., 0] - pm.center[:, None, 0]) / RES) + G // 2
    assert bool((rows < 0).any() and (rows >= G).any())
    for j in range(sp):
        assert bool(((rows // (G // sp)) == j).any())
    assert bool(want[1].any() and (~want[1]).any())
    assert int(want_fit["scan"].num_corr.min()) > 0


def _ground_map(seed=10):
    """A ground point map of dense cells with z, for height windows."""
    g = torch.Generator().manual_seed(seed)
    count = (torch.rand(B, G, G, generator=g) < 0.7).float() * \
        torch.randint(1, 4, (B, G, G), generator=g).float()
    return tpm.PointMapGrid(
        count=count,
        sum_x=(torch.rand(B, G, G, generator=g) - 0.5) * RES * count,
        sum_y=(torch.rand(B, G, G, generator=g) - 0.5) * RES * count,
        sum_z=(torch.randn(B, G, G, generator=g) * 0.05 - 1.0) * count,
        center=torch.tensor([[0.0, 0.0], [1.5, -2.0], [-3.0, 4.5]]),
        resolution=RES)


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("where", ["straddle", "edge"])
def test_height_window_on_slabs(sp, where):
    """height_interpolate_grid on slabs: the window's cells read from the
    slab that holds their row and joined by owner_select give the whole
    grid's z in bits, for windows across a slab boundary and windows
    clamped at the grid's outer rows."""
    gm = _ground_map()
    cfg = HeightConfig(max_nn_dist_sq=1.0)
    h = G // sp
    if where == "straddle":
        rows = torch.tensor([h, 2 * h - 1 if sp > 2 else h + 1, h - 1])
    else:
        rows = torch.tensor([0, G - 1, 1])
    x = (rows.float() - G // 2 + 0.5) * RES + gm.center[:, 0]
    y = gm.center[:, 1] + torch.tensor([0.3, -1.2, 6.0])
    pose = torch.stack([x, y, torch.tensor([0.1, 2.0, -1.0]),
                        torch.full((B,), 0.0)], -1)
    want = height.height_interpolate_grid(gm, pose, cfg)
    got = split_run(gm, sp, lambda s: height.height_interpolate_grid(
        s, pose, cfg))
    for z in got:
        assert_equal(z, want)
    assert int((want != 0.0).sum()) >= 2      # most robots found ground


@pytest.mark.parametrize("sp", SPS)
def test_occupied_cells_sum_over_slabs(sp):
    """The 3D tick's have-a-ground-map gate counts the whole grid's
    occupied cells: one cell in each slab is sp cells on every block."""
    gm = _ground_map()
    h = G // sp
    count = torch.zeros(B, G, G)
    count[:, torch.arange(sp) * h + 1, 3] = 2.0
    gm = gm.replace(count=count)
    want = height.occupied_cells(gm)
    assert_equal(want, torch.full((B,), sp))
    for got in split_run(gm, sp, height.occupied_cells):
        assert_equal(got, want)


def test_owner_select_and_all_sum():
    """The local half takes each element from its owner's block, keeping
    -0.0; all_sum adds integers over the group and refuses floats."""
    blocks = [torch.tensor([[[-0.0, 1.0], [2.0, 3.0]]]),
              torch.tensor([[[0.0, 5.0], [6.0, 7.0]]])]
    got = trows.select_owned(blocks, torch.tensor([[0, 1]]))
    assert_equal(got, torch.tensor([[[-0.0, 1.0], [6.0, 7.0]]]))
    assert torch.signbit(got[0, 0, 0])
    out = on_blocks(3, lambda j, c: (
        trows.owner_select(torch.full((2, 4), float(j)),
                           torch.tensor([[2, 1, 0, 2], [0, 0, 1, 1]]),
                           trows.Rows(c, j, 3, 6)),
        trows.all_sum(torch.tensor([j, 1]), trows.Rows(c, j, 3, 6))))
    for sel, tot in out:
        assert_equal(sel, torch.tensor([[2.0, 1, 0, 2], [0, 0, 1, 1]]))
        assert_equal(tot, torch.tensor([3, 3]))
    x = torch.tensor([4, 5])
    assert trows.all_sum(x, None) is x
    with pytest.raises(TypeError, match="integers"):
        trows.all_sum(torch.zeros(2), trows.Rows(object(), 0, 2, 4))
