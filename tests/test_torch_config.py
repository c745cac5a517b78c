"""The port's own config equals slam_tpu's, field for field, for every
constructor; and the port's entry points run on the card unless asked for
the CPU, raising (not falling back) when there is none."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from slam_tpu import config as jcfg
from slam_tpu.mapping import mls as jmls
from slam_tpu.mapping import point_map as jpm
from slam_tpu.pipeline import slam2d as jslam
from slam_tpu.sim import world2d as jw
from slam_tpu_torch import config as tcfg
from slam_tpu_torch import interop
from slam_tpu_torch.mapping.mls import init_mls
from slam_tpu_torch.mapping.occupancy import init_occupancy
from slam_tpu_torch.mapping.point_map import init_point_map
from slam_tpu_torch.models.ekf import init_ekf
from slam_tpu_torch.parallel.shared_map import fleet_rollout_shared
from slam_tpu_torch.pipeline import slam2d
from slam_tpu_torch.sim import world2d
from slam_tpu_torch.types import make_cloud
from tests.torch_parity import numpy_tree

CONSTRUCTORS = ("default_config", "sim2d_config", "sim3d_config",
                "ref_scale_config")


def test_config3_is_the_jax_benchmarks():
    """sim2d_reloc_config is the config bench.py's bench_mls_reloc builds."""
    c = jcfg.sim2d_config()
    want = c.replace(global_match=dataclasses.replace(
        c.global_match, grid_size=192, num_rotations=32))
    assert dataclasses.asdict(tcfg.sim2d_reloc_config()) == \
        dataclasses.asdict(want)


@pytest.mark.parametrize("name", CONSTRUCTORS)
def test_config_equals_jax(name):
    got = getattr(tcfg, name)()
    want = getattr(jcfg, name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # same sections, in the same order, with the same field order
    for a, b in zip(dataclasses.fields(got), dataclasses.fields(want)):
        assert a.name == b.name
        sa, sb = getattr(got, a.name), getattr(want, b.name)
        if dataclasses.is_dataclass(sa):
            assert [f.name for f in dataclasses.fields(sa)] == \
                [f.name for f in dataclasses.fields(sb)]
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]


def _entry_points():
    cfg = tcfg.sim2d_config()
    jc = jcfg.sim2d_config()
    st = numpy_tree(jax.vmap(lambda k: jslam.init_state(k, jc))(
        jax.random.split(jax.random.PRNGKey(0), 2)))
    world = numpy_tree(jw.make_world(jax.random.PRNGKey(1), jc.sim))
    grid = numpy_tree(jpm.init_point_map(8))
    cpu_world = interop.world_from_numpy(world, "cpu")
    cpu_states = interop.state_from_numpy(st, "cpu")
    cpu_shared = init_point_map(1, 8, device="cpu")
    return {
        "init_state": lambda: slam2d.init_state(cfg, 2),
        "make_world": lambda: world2d.make_world(torch.Generator(), cfg.sim),
        "init_point_map": lambda: init_point_map(1, 8),
        "init_occupancy": lambda: init_occupancy(cfg.mls, 2),
        "init_ekf": lambda: init_ekf(cfg.ekf, 2),
        "make_cloud": lambda: make_cloud(2, 8),
        "state_from_numpy": lambda: interop.state_from_numpy(st),
        "world_from_numpy": lambda: interop.world_from_numpy(world),
        "point_map_from_numpy": lambda: interop.point_map_from_numpy(grid),
        "fleet_rollout_shared": lambda: fleet_rollout_shared(
            cpu_states, cpu_shared, cpu_world, cfg, 1),
        "init_mls": lambda: init_mls(cfg.mls, 2),
        "mls_grid_from_numpy": lambda: interop.mls_grid_from_numpy(
            jax.tree.map(lambda x: np.asarray(x)[None],
                         jmls.init_mls(cfg.mls))),
    }


ENTRY_POINTS = ("init_state", "make_world", "init_point_map",
                "init_occupancy", "init_ekf", "make_cloud",
                "state_from_numpy", "world_from_numpy",
                "point_map_from_numpy", "fleet_rollout_shared", "init_mls",
                "mls_grid_from_numpy")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_without_device_wants_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_points()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_explicit_cpu_device():
    st = slam2d.init_state(tcfg.sim2d_config(), 2, device="cpu")
    assert st.pose.device.type == "cpu"
    assert st.map_grid.count.device.type == "cpu"
    g = interop.point_map_from_numpy(numpy_tree(jpm.init_point_map(8)),
                                     "cpu")
    assert g.count.shape == (1, 8, 8) and g.center.shape == (1, 2)
    np.testing.assert_array_equal(g.count.numpy(), 0)
