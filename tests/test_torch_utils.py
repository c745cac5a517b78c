"""Port parity, the utilities: .pcd and trajectory files written by each
package and read by the other, checkpoints (the port's round trip and
slam_tpu's npz layout read by the port), the cloud-form occupancy update
and `occupancy_cloud`, `apply_sweep_overrides`, profiling and the viz
renderers (slam_tpu_torch vs slam_tpu, CPU).

Tolerances: files of the same cloud or trajectory are byte-equal (ASCII
and binary .pcd, CSV); loads, checkpoints, occupancy counts, drivability,
the occupancy cloud's order and the configs exact; occupancy-cloud
coordinates to 1e-6 m (cell centre products); MLS markers exact (numpy
in both).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_tpu import config as jcfg
from slam_tpu.config import MlsConfig
from slam_tpu.mapping import occupancy as jocc
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.types import PointCloud as JCloud
from slam_tpu.types import MlsGrid as JMls
from slam_tpu.utils import checkpoint as jckpt
from slam_tpu.utils import pcd as jpcd
from slam_tpu.utils import trajectory as jtraj
from slam_tpu.utils import viz as jviz
from slam_tpu_torch import config as tcfg
from slam_tpu_torch import interop
from slam_tpu_torch.mapping import occupancy as tocc
from slam_tpu_torch.types import PointCloud as TCloud
from slam_tpu_torch.utils import checkpoint as tckpt
from slam_tpu_torch.utils import pcd as tpcd
from slam_tpu_torch.utils import profiling as tprof
from slam_tpu_torch.utils import trajectory as ttraj
from slam_tpu_torch.utils import viz as tviz
from tests.torch_parity import assert_close, assert_equal

torch.set_num_threads(1)


def _cloud_np(n=37, cap=48, seed=0):
    rng = np.random.RandomState(seed)
    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n] = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    valid = np.arange(cap) < n
    valid[5] = False
    flags = np.zeros(cap, np.int32)
    flags[:n] = rng.choice([0, 2, 4, 6], n)
    return xyz, valid, flags


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("with_flags", [False, True])
def test_pcd_files_cross_read_and_are_byte_equal(tmp_path, binary,
                                                 with_flags):
    xyz, valid, flags = _cloud_np()
    jc = JCloud(xyz=jnp.asarray(xyz), valid=jnp.asarray(valid),
                flags=jnp.asarray(flags))
    tc = TCloud(xyz=torch.from_numpy(xyz)[None],
                valid=torch.from_numpy(valid)[None],
                flags=torch.from_numpy(flags)[None])
    pj, pt = str(tmp_path / "j.pcd"), str(tmp_path / "t.pcd")
    assert jpcd.save_pcd(pj, jc, with_flags, binary) == \
        tpcd.save_pcd(pt, tc, with_flags, binary) == 36
    assert open(pj, "rb").read() == open(pt, "rb").read()
    got = tpcd.load_pcd(pj, capacity=40, device="cpu")
    want = jpcd.load_pcd(pt, capacity=40)
    assert got.xyz.shape == (1, 40, 3)
    assert_equal(got.xyz[0], want.xyz)
    assert_equal(got.valid[0], want.valid)
    assert_equal(got.flags[0], want.flags)


def _lzf_literal_encode(raw: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(raw), 32):
        chunk = raw[i:i + 32]
        out.append(len(chunk) - 1)
        out += chunk
    return bytes(out)


def test_pcd_binary_compressed_and_lzf(tmp_path):
    stream = bytes([0x02]) + b"abc" + bytes([0x80, 0x02])
    assert tpcd._lzf_decompress(stream, 9) == \
        jpcd._lzf_decompress(stream, 9) == b"abcabcabc"
    with pytest.raises(ValueError, match="lzf"):
        tpcd._lzf_decompress(bytes([0x80, 0x02]), 4)
    rng = np.random.RandomState(3)
    n = 11
    cols = [rng.uniform(-5, 5, n).astype("<f4") for _ in range(3)]
    ga = (rng.rand(n) < 0.5).astype("<u2")
    raw = b"".join(c.tobytes() for c in cols) + ga.tobytes()
    comp = _lzf_literal_encode(raw)
    path = tmp_path / "bc.pcd"
    with open(path, "wb") as f:
        f.write(("VERSION 0.7\nFIELDS x y z ground_adj\nSIZE 4 4 4 2\n"
                 "TYPE F F F U\nCOUNT 1 1 1 1\n"
                 f"WIDTH {n}\nHEIGHT 1\nPOINTS {n}\n"
                 "DATA binary_compressed\n").encode())
        f.write(np.array([len(comp), len(raw)], "<u4").tobytes())
        f.write(comp)
    got = tpcd.load_pcd(str(path), device="cpu")
    want = jpcd.load_pcd(str(path))
    assert_equal(got.xyz[0], want.xyz)
    assert_equal(got.flags[0], want.flags)
    bad = tmp_path / "bad.pcd"
    bad.write_bytes(b"VERSION 0.7\nFIELDS x y z\n")
    with pytest.raises(ValueError, match="header"):
        tpcd.load_pcd(str(bad), device="cpu")


def test_trajectory_csv_cross_read(tmp_path):
    rng = np.random.default_rng(2)
    poses = rng.uniform(-50, 50, (9, 4)).astype(np.float32)
    pj, pt = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    assert jtraj.save_trajectory_csv(pj, poses) == \
        ttraj.save_trajectory_csv(pt, torch.from_numpy(poses)) == 9
    assert open(pj, "rb").read() == open(pt, "rb").read()
    assert_equal(ttraj.load_trajectory_csv(pj), jtraj.load_trajectory_csv(pt))
    with pytest.raises(ValueError, match="poses"):
        ttraj.save_trajectory_csv(pt, np.zeros((3, 2)))


def _jax_state_with_values(seed=0):
    """slam_tpu's init state, every leaf filled from a numpy seed."""
    cfg = jcfg.sim2d_config()
    st = jslam.init_state(jax.random.PRNGKey(0), cfg, with_metrics_ring=True,
                          metrics_ring_capacity=8)
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == bool:
            return rng.random(x.shape) < 0.5
        return rng.integers(-3, 9, x.shape).astype(x.dtype) \
            if np.issubdtype(x.dtype, np.integer) \
            else rng.normal(size=x.shape).astype(x.dtype)
    return jax.tree.map(fill, st)


def test_checkpoint_round_trip_and_slam_tpu_layout(tmp_path):
    st = _jax_state_with_values(1)
    want = interop.state_from_numpy(
        jax.tree.map(lambda x: np.asarray(x)[None], st), "cpu")
    # the template: another state of the same structure
    like = interop.state_from_numpy(jax.tree.map(
        lambda x: np.asarray(x)[None],
        _jax_state_with_values(2)), "cpu")
    jckpt.save(str(tmp_path / "jax.npz"), st)
    got = tckpt.restore(str(tmp_path / "jax.npz"), like)
    tckpt.save(str(tmp_path / "port"), got)
    again = tckpt.restore(str(tmp_path / "port"), like)
    for a, b, c in zip(tckpt._leaves(got), tckpt._leaves(want),
                       tckpt._leaves(again)):
        assert a[0] == b[0] == c[0]
        assert a[1].dtype == b[1].dtype
        assert_equal(a[1], b[1], what=a[0])
        assert_equal(c[1], b[1], what=a[0])
    assert got.map_grid.resolution == like.map_grid.resolution
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "missing"), like)
    with pytest.raises(ValueError, match="holds"):
        tckpt.restore(str(tmp_path / "port"), like.ekf)
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore(str(tmp_path / "jax.npz"), like.ekf)


def _occ_inputs(seed=0, n=64):
    rng = np.random.default_rng(seed)
    # points at 0.2 m cell centres (MlsConfig's default resolution), the
    # obstacles on 8 x 8 cells so that counts pass min_cluster_points
    obs = np.zeros((n, 3), np.float32)
    obs[:, :2] = rng.integers(-4, 4, (n, 2)) * 0.2 + 0.1
    gnd = np.zeros((n, 3), np.float32)
    gnd[:, :2] = rng.integers(-10, 10, (n, 2)) * 0.2 + 0.1
    gnd[: n // 4, :2] = obs[: n // 4, :2]             # shared cells
    return obs, rng.random(n) < 0.9, gnd, rng.random(n) < 0.9


def test_add_to_occupancy_and_occupancy_cloud_match_jax():
    cfg = MlsConfig(size_x=64, size_y=64)
    jg = jocc.init_occupancy(cfg)
    tg = tocc.init_occupancy(tcfg.MlsConfig(size_x=64, size_y=64), 1,
                             device="cpu")
    tcfg_m = tcfg.MlsConfig(size_x=64, size_y=64)
    for seed in range(4):
        obs, ov, gnd, gv = _occ_inputs(seed)
        jg = jocc.add_to_occupancy(
            jg, JCloud(xyz=jnp.asarray(obs), valid=jnp.asarray(ov),
                       flags=jnp.zeros(len(ov), jnp.int32)),
            JCloud(xyz=jnp.asarray(gnd), valid=jnp.asarray(gv),
                   flags=jnp.zeros(len(gv), jnp.int32)), cfg)
        tg = tocc.add_to_occupancy(
            tg, TCloud(xyz=torch.from_numpy(obs)[None],
                       valid=torch.from_numpy(ov)[None],
                       flags=torch.zeros(1, len(ov), dtype=torch.int32)),
            TCloud(xyz=torch.from_numpy(gnd)[None],
                   valid=torch.from_numpy(gv)[None],
                   flags=torch.zeros(1, len(gv), dtype=torch.int32)), tcfg_m)
    assert_close(tg.counts[0], jg.counts, atol=1e-6)
    assert_equal(tg.drivable[0], jg.drivable)
    jg = jg.replace(center=jnp.float32([3.5, -1.25]))
    tg = tg.replace(center=torch.tensor([[3.5, -1.25]]))
    counts = np.asarray(jg.counts)
    occ = np.asarray(jg.drivable) == 0
    assert len(set(counts[occ].tolist())) < occ.sum()    # tied counts
    for cap in (8, 200):
        jc = jocc.occupancy_cloud(jg, cfg, cap)
        tc = tocc.occupancy_cloud(tg, tcfg_m, cap)
        assert_equal(tc.valid[0], jc.valid)
        assert_close(tc.xyz[0], jc.xyz, atol=1e-6)
        assert_equal(tc.flags[0], jc.flags)


def test_apply_sweep_overrides_field_for_field(monkeypatch):
    spec = ("icp.loop=scan;cloud.export_recall=1.0;mls.size_x=96;"
            "graph.map_regen=mls;mls.rolling=false;pf.score_stride=4")
    j = jcfg.apply_sweep_overrides(jcfg.sim2d_config(), spec)
    t = tcfg.apply_sweep_overrides(tcfg.sim2d_config(), spec)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.mls.size_x == 96 and t.mls.rolling is False
    monkeypatch.setenv("SLAM_TPU_SWEEP_SET", "ekf.init_sigma=0.5")
    assert tcfg.apply_sweep_overrides(tcfg.default_config()).ekf.init_sigma \
        == jcfg.apply_sweep_overrides(jcfg.default_config()).ekf.init_sigma \
        == 0.5
    with pytest.raises(AttributeError):
        tcfg.apply_sweep_overrides(tcfg.default_config(), "icp.nope=1")


def test_profiling_stage_trace_and_throughput(tmp_path):
    with tprof.trace(str(tmp_path)):
        with tprof.stage("test_stage"):
            x = torch.ones(4) * 2
    assert float(x[0]) == 2.0
    names = {e.get("name") for e in json.load(
        open(tmp_path / "trace.json"))["traceEvents"]}
    assert "test_stage" in names
    t = tprof.Throughput(batch=8)
    t.tick(10)
    assert t.robot_steps_per_sec > 0
    assert t.robot_steps_per_sec == pytest.approx(8 * t.steps_per_sec,
                                                  rel=0.5)


def test_viz_markers_and_renders(tmp_path):
    rng = np.random.default_rng(4)
    H, W, K = 6, 5, 3
    g = JMls(mean=rng.normal(size=(H, W, K, 3)).astype(np.float32),
             var_z=rng.random((H, W, K)).astype(np.float32),
             num_pts=rng.integers(0, 5, (H, W, K)).astype(np.float32),
             drivable=rng.integers(-1, 2, (H, W)).astype(np.int8),
             origin=np.zeros(2, np.int32), center=np.zeros(2, np.float32))
    mcfg = MlsConfig()
    tg = interop.mls_grid_from_numpy(jax.tree.map(lambda x: x[None], g),
                                     "cpu")
    want = jviz.mls_markers(g, mcfg)
    got = tviz.mls_markers(tg, tcfg.MlsConfig())
    for k in ("pos", "scale", "rgba"):
        assert_equal(got[k], want[k])
    est = torch.from_numpy(rng.normal(size=(10, 3)).astype(np.float32))
    tviz.render_trajectory(str(tmp_path / "traj.png"), est, est * 1.01)
    tviz.render_grid(str(tmp_path / "grid.png"), tg.drivable[0])
    tviz.render_mls_markers(str(tmp_path / "mls.png"), got)
    for f in ("traj.png", "grid.png", "mls.png"):
        assert os.path.getsize(tmp_path / f) > 0
