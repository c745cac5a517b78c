"""The roofline counts on small shapes, against counts by hand."""

import types

import torch

from portbench.harness import core, layers

K1 = core.load_module(core.ROOT, "roofline", "K1")


def problem():
    # robot 0: 2 GA + 1 NGA scene points, 2 GA + 3 NGA model points, one
    # pad slot each; robot 1: no valid scene point
    sc = torch.tensor([[1., 1., 0., -1.], [-1., -1., -1., -1.]])
    mc = torch.tensor([[1., 1., 0., 0., 0., 2.], [0., 0., 0., 0., 0., 0.]])
    sx = torch.tensor([[0.1, 1.1, 5.0, 0.], [0., 0., 0., 0.]])
    sy = torch.zeros(2, 4)
    mx = torch.tensor([[0., 1., 5., 9., 13., 0.], [0., 1., 2., 3., 4., 5.]])
    my = torch.zeros(2, 6)
    init = torch.zeros(2, 3)
    cfg = types.SimpleNamespace(max_iterations=20, inlier_dist=1.0,
                                min_delta=1e-6, min_scene_points=1)
    return (sx, sy, sc, mx, my, mc, init, cfg)


def test_k1_bytes_and_operations():
    args = problem()
    moved, ops = K1.count(args, {}, None)
    # class planes 2 x 4 and 2 x 6 floats; x and y at 3 + 11 valid slots;
    # init (B, 4) and result (B, 8)
    assert moved == 4 * (8 + 12) + 8 * 14 + 2 * 16 + 2 * 32
    iters = K1.fit_iterations(*args[:7], {
        "max_iterations": 20, "inlier_dist": 1.0, "min_delta": 1e-6,
        "min_scene_points": 1})
    assert int(iters[1]) == 0 and int(iters[0]) >= 1
    # robot 0: 2 x 2 GA pairs + 1 x 3 NGA pairs a fit iteration
    assert ops == 5.0 * 7 * int(iters[0])


def test_share_is_bound_over_kernel_time():
    args = problem()
    moved, ops = K1.count(args, {}, None)
    data = dict(calls={"K1": [(args, {})]},
                by_name_us={"void icp_fused_planes_kernel<1>(x)": 2.0,
                            "other": 100.0})
    share = layers.roofline_share(data, K1, "K1")
    assert abs(share - 100 * K1.bound_s(moved, ops) / 2e-6) < 1e-9
    assert layers.roofline_share(dict(data, calls={}), K1, "K1") is None


def test_collectives_leave_the_busy_share():
    idle = core.load_module(core.ROOT, "metrics", "device_idle_share.fleet")
    merge = core.load_module(core.ROOT, "metrics", "merge_ms.mesh")
    data = dict(ticks=8, wall_ms_per_tick=10.0, busy_us=90_000.0,
                by_name_us={"ncclDevKernel_AllReduce": 50_000.0, "k": 40_000.0},
                launches_us={"ncclDevKernel_AllReduce": [400.0, 49_600.0,
                                                         500.0]})
    # 40 ms of compute over 8 ticks of 10 ms: half the window idle
    assert abs(idle.read(data) - 50.0) < 1e-9
    assert merge.read(data) == 0.5
    assert merge.read(dict(data, launches_us={"k": [1.0]})) is None
