"""Port parity, g2o text files (graph/g2o_io.py): the port and slam_tpu
write the same text for the same graph, each reads the other's files, the
6-DoF graph round-trips, and loads raise on overflow (slam_tpu_torch vs
slam_tpu, CPU).

Tolerances: the planar graph's text is equal character for character
(the same %.9g fields from the same f32 values); loaded fields equal
exactly (the same parse into f32). The 6-DoF files hold quaternions that
each package computes in f32 from the rotation matrices (the same
Shepperd candidates, another rounding): rotations and information agree
to 1e-6, translations exactly.
"""

import jax
import numpy as np
import pytest
import torch

from slam_tpu.config import GraphConfig
from slam_tpu.graph import g2o_io as jio
from slam_tpu.graph import pose_graph as jpg
from slam_tpu.graph import pose_graph3d as jpg3
from slam_tpu_torch import interop
from slam_tpu_torch.graph import g2o_io as tio
from tests.torch_parity import assert_close, assert_equal, numpy_tree

torch.set_num_threads(1)

PLANAR = ("node_pose", "node_valid", "node_stamp", "edge_ij", "edge_rel",
          "edge_info", "edge_valid", "num_nodes", "num_edges")
SE3 = ("node_t", "node_R", "node_valid", "edge_ij", "edge_t", "edge_R",
       "edge_info", "edge_valid")


def _rot(rpy):
    """Rotations (n, 3, 3) of roll, pitch, yaw (n, 3), in numpy."""
    r, p, y = (rpy[:, k].astype(np.float64) for k in range(3))
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    return np.stack([
        np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                 -1),
        np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                 -1),
        np.stack([-sp, cp * sr, cp * cr], -1)], -2).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    """A slam_tpu PoseGraph (slots 0-2, 4 and 5 of 8 hold nodes, 6 of 10
    edges are valid, random symmetric information), and the port's copy
    (batch 1)."""
    rng = np.random.default_rng(3)
    gcfg = GraphConfig(max_nodes=8, max_edges=10, keyframe_points=16)
    nv = np.isin(np.arange(8), (0, 1, 2, 4, 5))
    ev = np.arange(10) < 6
    pose = rng.uniform(-30, 30, (8, 4)).astype(np.float32)
    pose[:, 2] = rng.uniform(-3.1, 3.1, 8)
    A = rng.normal(size=(10, 4, 4)).astype(np.float32)
    rel = rng.uniform(-5, 5, (10, 4)).astype(np.float32)
    rel[:, 2] = rng.uniform(-1, 1, 10)
    ij = np.stack([[0, 1], [1, 2], [2, 4], [4, 5], [0, 2], [1, 5]] +
                  [[0, 0]] * 4).astype(np.int32)
    graph = jpg.init_graph(gcfg).replace(
        node_pose=np.where(nv[:, None], pose, 0.0).astype(np.float32),
        node_valid=nv,
        node_stamp=np.where(nv, np.cumsum(nv) - 1, -1).astype(np.int32),
        edge_ij=ij, edge_rel=np.where(ev[:, None], rel, 0.0).astype(
            np.float32),
        edge_info=np.where(ev[:, None, None], A @ A.transpose(0, 2, 1),
                           0.0).astype(np.float32),
        edge_valid=ev, num_nodes=np.int32(6), num_edges=np.int32(6))
    port = interop.graph_from_numpy(
        numpy_tree(jax.tree.map(lambda x: np.asarray(x)[None], graph)),
        "cpu")
    return graph, port, gcfg


@pytest.mark.parametrize("mode", ["se3", "se2"])
def test_save_g2o_writes_slam_tpus_text(built, tmp_path, mode):
    graph, port, _ = built
    want = tmp_path / "jax.g2o"
    got = tmp_path / "port.g2o"
    assert tio.save_g2o(str(got), port, mode=mode) == \
        jio.save_g2o(str(want), graph, mode=mode)
    assert got.read_text() == want.read_text()
    assert got.read_text().count("EDGE_") == int(graph.num_edges) == 6


@pytest.mark.parametrize("mode", ["se3", "se2"])
@pytest.mark.parametrize("writer", ["port", "slam_tpu"])
def test_load_g2o_reads_either_packages_file(built, tmp_path, mode, writer):
    graph, port, gcfg = built
    path = str(tmp_path / "g.g2o")
    if writer == "port":
        tio.save_g2o(path, port, mode=mode)
    else:
        jio.save_g2o(path, graph, mode=mode)
    want = jio.load_g2o(path, gcfg)
    got = tio.load_g2o(path, gcfg, device="cpu")
    for k in PLANAR:
        assert_equal(getattr(got, k)[0], getattr(want, k), k)
    assert got.kf_xyz.shape == (1,) + tuple(want.kf_xyz.shape)
    assert not bool(got.kf_valid.any())


def _se3_graph():
    """A slam_tpu Se3Graph: 6 nodes at random 6-DoF poses, 5 chained edges
    with random symmetric information; the other slots as
    init_se3_graph leaves them."""
    rng = np.random.default_rng(4)
    g = jpg3.init_se3_graph(8, 12)
    N, E = 6, 5
    rpy = rng.uniform(-0.4, 0.4, (8, 3)).astype(np.float32)
    rpy[:, 2] = rng.uniform(-3, 3, 8)
    erpy = rng.uniform(-0.3, 0.3, (12, 3)).astype(np.float32)
    A = rng.normal(size=(12, 6, 6)).astype(np.float32)
    nv = np.arange(8) < N
    ev = np.arange(12) < E
    rpy[~nv] = 0.0
    erpy[~ev] = 0.0

    def on(a, mask):
        return np.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a,
                        0).astype(a.dtype)
    return g.replace(
        node_t=on(rng.uniform(-20, 20, (8, 3)).astype(np.float32), nv),
        node_R=_rot(rpy), node_valid=nv,
        edge_ij=on(np.stack([np.arange(12), np.arange(12) + 1],
                            -1).astype(np.int32), ev),
        edge_t=on(rng.uniform(-3, 3, (12, 3)).astype(np.float32), ev),
        edge_R=_rot(erpy),
        edge_info=on((A @ A.transpose(0, 2, 1)).astype(np.float32), ev),
        edge_valid=ev)


def test_save_g2o_se3_round_trip(tmp_path):
    """The port's 6-DoF save and load round-trip an Se3Graph carried
    across from slam_tpu; slam_tpu reads the port's file and the port
    slam_tpu's, to the same fields."""
    jgraph = _se3_graph()
    port = interop.se3_graph_from_numpy(
        jax.tree.map(lambda x: np.asarray(x)[None], jgraph), "cpu")
    ours, theirs = str(tmp_path / "port.g2o"), str(tmp_path / "jax.g2o")
    assert tio.save_g2o_se3(ours, port) == (6, 5)
    assert jio.save_g2o_se3(theirs, jgraph) == (6, 5)
    back = tio.load_g2o_se3(ours, 8, 12, device="cpu")
    for path in (ours, theirs):
        want = jio.load_g2o_se3(path, 8, 12)
        got = tio.load_g2o_se3(path, 8, 12, device="cpu")
        for k in SE3:
            assert_close(getattr(got, k)[0], getattr(want, k), atol=1e-6,
                         what=k)
    for k in SE3:
        assert_close(getattr(back, k)[0], getattr(jgraph, k), atol=1e-6,
                     what=k)
    assert_equal(back.node_t[0], jgraph.node_t)


def _overflow(tmp_path, built):
    graph, _, _ = built
    path = str(tmp_path / "g.g2o")
    jio.save_g2o(path, graph)
    se3 = str(tmp_path / "se3.g2o")
    jio.save_g2o_se3(se3, _se3_graph())
    return path, se3


@pytest.mark.parametrize("what", ["nodes", "edges", "se3 nodes",
                                  "se3 edges", "duplicate"])
def test_load_raises_on_overflow(built, tmp_path, what):
    path, se3 = _overflow(tmp_path, built)
    if what == "nodes":
        with pytest.raises(ValueError, match="max_nodes"):
            tio.load_g2o(path, GraphConfig(max_nodes=2, max_edges=64,
                                           keyframe_points=8), device="cpu")
    elif what == "edges":
        with pytest.raises(ValueError, match="max_edges"):
            tio.load_g2o(path, GraphConfig(max_nodes=16, max_edges=1,
                                           keyframe_points=8), device="cpu")
    elif what == "se3 nodes":
        with pytest.raises(ValueError, match="max_nodes"):
            tio.load_g2o_se3(se3, 4, 12, device="cpu")
    elif what == "se3 edges":
        with pytest.raises(ValueError, match="max_edges"):
            tio.load_g2o_se3(se3, 8, 2, device="cpu")
    else:
        dup = tmp_path / "dup.g2o"
        dup.write_text("VERTEX_SE2 2 0 0 0\nVERTEX_SE2 2 1 1 0\n")
        with pytest.raises(ValueError, match="duplicate vertex"):
            tio.load_g2o(str(dup), GraphConfig(max_nodes=4, max_edges=4,
                                               keyframe_points=8),
                         device="cpu")


def test_loaders_want_the_card(built, tmp_path, monkeypatch):
    """Without device= the loaders put the graph on the card, and raise
    where there is none."""
    path, se3 = _overflow(tmp_path, built)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.load_g2o(path, built[2])
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.load_g2o_se3(se3, 8, 12)
