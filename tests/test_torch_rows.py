"""Port, the sp axis's slab ops (parallel/rows.py and every grid op that
reads a grid's `rows`) against the same op on the whole grid, in one
process: sp = 2 and 4, each block of rows a thread whose exchanges go
through a loopback (the threads meet at a barrier), the blocks' results
stitched back into whole grids.

Exact throughout: counts, flags, rolled cells, exports (order and values,
ties included) and bit tables are equal; float sums that a scatter adds
point by point are held within 1e-6 (on the CPU each cell adds its points
in the same order, so they are equal too).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from slam_tpu_torch.config import MlsConfig
from slam_tpu_torch.mapping import mls as tmls
from slam_tpu_torch.mapping import occupancy as tocc
from slam_tpu_torch.mapping import point_map as tpm
from slam_tpu_torch.ops import grid_icp, particle, roll, scatter2d, stencil
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
    """A split grid needs its group's exchange; the paths not ported raise
    NotImplementedError naming their ROADMAP item."""
    with pytest.raises(ValueError, match="process group"):
        trows.Rows(None, 0, 2, G)
    with pytest.raises(ValueError, match="divide"):
        trows.Rows(object(), 0, 3, G)
    pm = _point_map()
    s = slab(pm, 0, 2, object())
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        grid_icp.nearest_point_field(s, 0.5)
    assert repr(s.rows) == "Rows(block 0 of 2, 16 of 32 rows)"
