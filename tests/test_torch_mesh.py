"""Port parity, the rank mesh: parallel/mesh.py and parallel/multihost.py's
layouts against slam_tpu's on conftest's 8 virtual devices, in one
process (slam_tpu_torch vs slam_tpu, CPU).

Exact throughout: the rank arrays equal the device ids of JAX's
Mesh.devices, and every leaf's per-rank slices equal
NamedSharding.devices_indices_map. On an sp > 1 mesh placing a fleet
needs a process group (tests/test_torch_sp.py runs it on four gloo ranks),
and the paths not ported to split grids raise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from slam_tpu.config import sim2d_config
from slam_tpu.mapping import mls as jmls
from slam_tpu.parallel import mesh as jmesh
from slam_tpu.parallel import multihost as jmh
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu_torch import interop, mesh_scaling
from slam_tpu_torch.mapping.mls import init_mls
from slam_tpu_torch.mapping.point_map import init_point_map
from slam_tpu_torch.ops.grid_icp import nearest_point_field
from slam_tpu_torch.ops.height import height_interpolate_grid
from slam_tpu_torch.parallel import mesh as tmesh
from slam_tpu_torch.parallel import multihost as tmh
from slam_tpu_torch.parallel import rows as trows
from slam_tpu_torch.parallel import shared_map as tsm
from slam_tpu_torch.pipeline import relocalize, slam3d
from slam_tpu_torch.pipeline import slam2d as tslam
from slam_tpu_torch.types import GroundMap
from tests.torch_parity import assert_equal, numpy_tree

torch.set_num_threads(1)

B = 16


@pytest.fixture(scope="module")
def fleet():
    cfg = sim2d_config()
    st = jax.vmap(lambda k: jslam.init_state(k, cfg))(
        jax.random.split(jax.random.PRNGKey(0), B))
    return cfg, st, interop.state_from_numpy(numpy_tree(st), "cpu")


def _ids(mesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(mesh.devices)


def _port_leaves(tree, path=""):
    """(path in jax.tree_util.keystr's form, {rank: slices}) of a port
    sharding tree."""
    if isinstance(tree, dict):
        yield path, tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _port_leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, f"{path}[{i}]")


def _jax_maps(tree, shardings) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree_util.tree_leaves(shardings)
    assert len(leaves) == len(specs)
    return {jax.tree_util.keystr(p): {d.id: idx for d, idx in
                                      s.devices_indices_map(x.shape).items()}
            for (p, x), s in zip(leaves, specs)}


def _assert_same_slices(port_tree, want: dict, min_leaves: int):
    got = dict(_port_leaves(port_tree))
    assert len(got) >= min_leaves
    for path, slices in got.items():
        assert path in want, path
        assert slices == want[path], path


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_make_mesh_layout(sp):
    want = jmesh.make_mesh(8, sp=sp)
    got = tmesh.make_mesh(8, sp=sp)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    np.testing.assert_array_equal(got.ranks, _ids(want))


def test_fleet_mesh_over_virtual_hosts():
    want = jmh.make_fleet_mesh(sp=2, hosts=2)
    got = tmh.make_fleet_mesh(sp=2, hosts=2, n_ranks=8)
    assert got.shape == dict(want.shape) == {"dp": 4, "sp": 2}
    np.testing.assert_array_equal(got.ranks, _ids(want))


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_fleet_sharding_matches_devices_indices_map(fleet, sp):
    _, st, ts = fleet
    want = _jax_maps(st, jmesh.fleet_sharding(jmesh.make_mesh(8, sp=sp), st))
    _assert_same_slices(tmesh.fleet_sharding(tmesh.make_mesh(8, sp=sp), ts),
                        want, 20)


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_grid_rows_sharding_matches_devices_indices_map(fleet, sp):
    cfg, st, ts = fleet
    jm, tm = jmesh.make_mesh(8, sp=sp), tmesh.make_mesh(8, sp=sp)
    for jtree, ttree in (
            (st.local_map, ts.local_map), (st.map_grid, ts.map_grid),
            (jax.vmap(lambda _: jmls.init_mls(cfg.mls))(np.arange(B)),
             init_mls(cfg.mls, B, device="cpu"))):
        want = _jax_maps(jtree, jmesh.grid_rows_sharding(jm, jtree))
        _assert_same_slices(tmesh.grid_rows_sharding(tm, ttree), want, 4)


def test_shard_fleet_takes_each_ranks_robots(fleet):
    _, _, ts = fleet
    mesh = tmesh.make_mesh(8)
    for r in range(8):
        mine = tmesh.shard_fleet(mesh, ts, rank=r, device="cpu")
        tmesh.tree_map(lambda a, b: assert_equal(a, b[2 * r:2 * r + 2]),
                       mine, ts)
        assert mine.pose.shape == (2, 4) and mine.map_grid.resolution == 0.5


def test_sp_is_layout_only(fleet):
    """What the sp axis does not reach yet raises NotImplementedError naming
    its ROADMAP item: the 3D path, the "grid" matcher's field, graph mode,
    relocalization and mesh_scaling --sp; a split grid needs a process
    group."""
    cfg, _, ts = fleet
    mesh = tmesh.make_mesh(8, sp=2)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.shard_fleet(mesh, ts, rank=0, device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        tsm.fleet_rollout_shared(
            ts, init_point_map(1, 16, device="cpu"), None, cfg, 1,
            generator=torch.Generator(), mesh=mesh)
    with pytest.raises(NotImplementedError, match="mesh_scaling --sp"):
        tmesh.require_dp_only(mesh, "mesh_scaling")
    rows = trows.Rows(object(), 0, 2, 192)
    split = ts.replace(local_map=ts.local_map.replace(rows=rows),
                       map_grid=ts.map_grid.replace(rows=rows))
    refused = {
        "3D, with mesh_scaling --sp": [
            lambda: slam3d.process_frame_3d(
                split, GroundMap(grid=split.map_grid, cloud=None), None,
                None, None, None, None, None, cfg),
            lambda: height_interpolate_grid(split.map_grid, ts.pose,
                                            cfg.height)],
        'the "grid" field': [lambda: nearest_point_field(split.map_grid,
                                                         0.5)],
        "graph regeneration": [
            lambda: tslam.graph_update(split, cfg),
            lambda: tslam.rollout_with_graph(split, None, cfg, 1, None)],
        "relocalization": [lambda: relocalize.relocalize(split, None, cfg)],
    }
    for item, calls in refused.items():
        for call in calls:
            with pytest.raises(NotImplementedError,
                               match=f"ROADMAP.md queue 1, step 3 "
                                     f"\\({item}\\)"):
                call()


def test_layout_errors(fleet, monkeypatch):
    _, _, ts = fleet
    with pytest.raises(ValueError, match="divisible"):
        tmesh.make_mesh(8, sp=3)
    with pytest.raises(ValueError, match="inside one host"):
        tmh.make_fleet_mesh(sp=4, hosts=4, n_ranks=8)
    with pytest.raises(ValueError, match="batch of 16"):
        tmesh.fleet_sharding(tmesh.make_mesh(3), ts)
    with pytest.raises(ValueError, match="grid rows"):
        tmesh.grid_rows_sharding(tmesh.make_mesh(5, sp=5),
                                 init_point_map(5, 16, device="cpu"))
    assert tmh.host_local_batch(B) == jmh.host_local_batch(B) == B
    monkeypatch.setattr(tmh, "world_size", lambda: 3)
    with pytest.raises(ValueError, match="does not divide"):
        tmh.host_local_batch(B)
    assert tmh.host_local_batch(3 * B) == B


def test_one_rank_without_a_group(fleet):
    """Alone, a one-rank mesh needs no process group: the merger is
    merge_maps, a gather returns its input; a larger mesh asks for one."""
    _, _, ts = fleet
    mesh = tmesh.make_mesh()
    assert mesh.shape == {"dp": 1, "sp": 1}
    assert mesh.dp_group() is None
    grids = ts.map_grid.replace(count=torch.rand(B, 192, 192))
    got = tsm.make_shared_map_merger(mesh)(grids)
    want = tsm.merge_maps(grids)
    for n in (*tsm.CHANNELS, "center"):
        assert torch.equal(getattr(got, n), getattr(want, n))
    assert tmesh.gather_fleet(mesh, ts.pose) is ts.pose
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(2).dp_group()


def test_mesh_scaling_alone(capsys):
    """One rank without a group: B = 1, one macro warm and one timed; sp = 2
    does not fit one rank."""
    rows = mesh_scaling.main(["--batches", "1", "--steps", "4",
                              "--device", "cpu"])
    assert len(rows) == 1 and rows[0]["finite"]
    assert rows[0]["dp"] == 1 and rows[0]["robots_per_rank"] == 1
    out = capsys.readouterr().out
    assert out.startswith("b  1 dp1 sp1: per-rank peak not measured")
    assert "robot-steps/s aggregate" in out and "1 rank(s), cpu" in out
    with pytest.raises(ValueError, match="inside one host"):
        mesh_scaling.main(["--sp", "2", "--device", "cpu"])
