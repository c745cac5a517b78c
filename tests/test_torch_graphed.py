"""CUDA-graph replay of the 3D tick's stages (slam_tpu_torch/utils/graphed.py).

On the CPU: a graphed function is the plain function wherever a graph
cannot apply (CPU tensors, a grid split by rows, a generator, metrics or
nan_debug on), and a 3D tick still calls, through slam3d's and world3d's
module names, every stage function the benchmark wraps in its ranges
(portbench/metrics/*.py STAGES), so the benchmark's per-stage times keep
reading the graphs' kernels. On a card only (marker `cuda`): the graphed
stages and rollout_3d against the plain path, fresh results, and a count
inside a captured function refused."""

import dataclasses

import pytest
import torch

from portbench.harness import core, tracing
from slam_tpu_torch import config as tcfg
from slam_tpu_torch.mapping import point_map
from slam_tpu_torch.parallel.rows import Rows
from slam_tpu_torch.pipeline import slam3d
from slam_tpu_torch.sim import world3d
from slam_tpu_torch.utils import graphed, metrics, profiling

torch.set_num_threads(1)


def _grid(B=2, G=8, device="cpu", rows=None):
    g = point_map.init_point_map(B, G, device=device)
    return dataclasses.replace(g, count=torch.rand(B, G, G, device=device),
                               rows=rows)


def _reason(*args, **kwargs):
    return graphed.plain_reason(*graphed.flatten((args, kwargs)))


def _traced(fn):
    calls = []

    def traced(*a, **k):
        calls.append(1)
        return fn(*a, **k)
    return graphed.graphed(traced), calls


def test_cpu_tensors_take_the_plain_function():
    f, calls = _traced(point_map.shift_point_map)
    g = _grid()
    xy = torch.full((2, 2), 1.3)
    got = f(g, xy)
    want = point_map.shift_point_map(g, xy)
    assert calls == [1] and not f.graphs
    assert torch.equal(got.count, want.count) and \
        torch.equal(got.center, want.center)
    assert _reason(g, xy) == "not all on one card"


class _Group:
    """A stand-in sp exchange: the descriptor is all the test reads."""


@pytest.mark.parametrize("case", ["rows", "generator", "metrics",
                                  "nan_debug"])
def test_what_keeps_the_plain_function(case):
    """Each condition a graph cannot meet, judged before the device."""
    g, extra = _grid(), ()
    if case == "rows":
        g = _grid(rows=Rows(_Group(), 0, 2, 8))
    elif case == "generator":
        extra = (torch.Generator(),)
    f, calls = _traced(lambda grid, xy, *_: xy + 1)
    try:
        if case == "metrics":
            metrics.enable()
        elif case == "nan_debug":
            metrics.nan_debug(True)
        want = {"rows": "a grid split by rows",
                "generator": "a random generator",
                "metrics": "metrics or nan_debug on",
                "nan_debug": "metrics or nan_debug on"}[case]
        assert _reason(g, torch.zeros(2, 2), *extra) == want
        f(g, torch.zeros(2, 2), *extra)
    finally:
        metrics.disable()
        metrics.nan_debug(False)
        metrics.clear()
    assert calls == [1] and not f.graphs
    assert _reason() == "no tensor"


def _wrapped_names():
    """module:function of every 3D stage the benchmark wraps."""
    root = core.ROOT
    readers = {p.stem: core.load_module(root, "metrics", p.stem)
               for p in (root / "portbench" / "metrics").glob("*.py")}
    stages, _ = tracing.specs(readers)
    return sorted({spec for specs in stages.values() for spec in specs
                   if spec.split(":")[0].endswith(("slam3d", "world3d"))})


def test_a_tick_calls_every_wrapped_stage(monkeypatch):
    names = _wrapped_names()
    assert "slam_tpu_torch.pipeline.slam3d:segment_ground" in names
    seen = {}
    for spec in names:
        mod, fn = tracing._resolve(spec)
        orig = getattr(mod, fn)

        def spy(*a, _orig=orig, _spec=spec, **k):
            seen[_spec] = seen.get(_spec, 0) + 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, fn, spy)
    cfg = tcfg.sim3d_config()
    gen = torch.Generator().manual_seed(0)
    world = world3d.make_world(gen, cfg.sim, device="cpu")
    state = slam3d.init_state_3d(cfg, 2, world, device="cpu", generator=gen)
    gm = slam3d.init_ground_map(cfg, 2, device="cpu")
    slam3d.rollout_3d(state, world, gm, cfg, 4, gen)
    assert set(seen) == set(names), set(names) - set(seen)
    per_tick = {"segment_ground", "build_scene_3d_planes", "fused_register",
                "add_to_occupancy_xy2", "raycast"}
    for spec, n in seen.items():
        fn = spec.split(":")[1]
        if fn in per_tick:
            assert n == 4, (spec, n)
    assert seen["slam_tpu_torch.pipeline.slam3d:update_point_map_xy"] == 8


# ---------- on a card ----------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_stage_replays_the_plain_function(card):
    f = graphed.graphed(point_map.update_point_map_xy)
    g = _grid(B=4, G=32, device=card)
    xs = [torch.rand(4, 100, device=card) * 10 - 5 for _ in range(6)]
    valid = torch.rand(4, 100, device=card) > 0.2
    got = [f(g, xs[0], xs[1], None, valid)]
    got.append(f(got[0], xs[2], xs[3], None, valid))
    assert len(f.graphs) == 1
    w0 = point_map.update_point_map_xy(g, xs[0], xs[1], None, valid,
                                       deterministic=True)
    w1 = point_map.update_point_map_xy(w0, xs[2], xs[3], None, valid,
                                       deterministic=True)
    for a, b in ((got[0], w0), (got[1], w1)):
        for name in ("count", "sum_x", "sum_y", "center"):
            assert torch.allclose(getattr(a, name), getattr(b, name),
                                  atol=1e-5), name
    # the first result is a fresh tensor, unchanged by the second replay;
    # sum_z, an input unchanged, is the caller's own tensor
    assert torch.allclose(got[0].count, w0.count)
    assert got[0].sum_z is g.sum_z and got[1].sum_z is g.sum_z


@pytest.mark.cuda
def test_a_count_inside_a_capture_is_refused(card):
    def counts(x):
        profiling.count("test.graphed")
        return x + 1
    with pytest.raises(RuntimeError, match="capture"):
        graphed.graphed(counts)(torch.zeros(3, device=card))


def _alike(a, b) -> bool:
    """Equal in bits, NaN where NaN."""
    return bool(((a == b) | ((a != a) & (b != b))).all())


@pytest.mark.cuda
def test_rollout_3d_graphed_matches_plain(card):
    """Two macros of config 2 at sim3d on 8 robots, graphed and plain from
    one state and generator state: every tensor two plain runs give alike
    in bits, the graphed run gives alike (the others hold the maps' float
    atomics, whose order varies in both forms), and the poses agree."""
    cfg = tcfg.sim3d_config()
    gen = torch.Generator(card).manual_seed(0)
    world = world3d.make_world(gen, cfg.sim, device=card)
    s = slam3d.init_state_3d(cfg, 8, world, device=card, generator=gen)
    gm = slam3d.init_ground_map(cfg, 8, device=card)
    s, gm, _ = slam3d.rollout_3d(s, world, gm, cfg, 4, gen)
    start = gen.get_state()

    def run():
        gen.set_state(start)
        return graphed.flatten(slam3d.rollout_3d(s, world, gm, cfg, 8,
                                                 gen))[0]
    stages = {n: f for n, f in vars(slam3d).items() if hasattr(f, "graphs")}
    graphed_run = run()
    assert stages["update_point_map_xy"].graphs and stages["_height"].graphs
    for n, f in stages.items():
        setattr(slam3d, n, f.__wrapped__)
    try:
        plain = [run(), run()]
    finally:
        for n, f in stages.items():
            setattr(slam3d, n, f)
    repeated = 0
    for g, a, b in zip(graphed_run, *plain):
        if _alike(a, b):
            repeated += 1
            assert _alike(g, a)
    assert repeated > len(graphed_run) // 2
    # the estimates (B, 8, 4) lead rollout_3d's (est, true, reg_ok)
    assert torch.allclose(graphed_run[-3], plain[0][-3], atol=6e-3)
