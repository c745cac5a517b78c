"""The program's own spans and counters beside the harness's attribution:
on a synthetic chrome trace, the program's spans leave `tracing.attribute`
and every existing reader as they read without them; each reader of a
program counter or span returns None on data without its input and the
right number on a hand-built `data`; and a traced run of a fleet cell and
of the live cell on the CPU reports the program counters it can."""

import copy
import json

import pytest

from portbench.harness import core, program, tracing

BENCH = json.loads((core.ROOT / "BENCHMARK.json").read_text())
NEW = ("fit_iterations.fleet", "fit_iterations.live",
       "host_syncs_per_step.fleet", "host_syncs_per_step.live",
       "step_idle_ms.live", "step_ms.live")


def reader(name):
    return core.load_module(core.ROOT, "metrics", name)


def all_readers():
    return {m["name"]: reader(m["name"]) for m in BENCH["per_layer"]}


def span(name, ts, dur):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur)


def kernel(name, ts, dur, launched, corr):
    return [dict(ph="X", cat="kernel", name=name, ts=ts, dur=dur,
                 args=dict(correlation=corr)),
            dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                 ts=launched, dur=1, args=dict(correlation=corr))]


def fleet_tick(t0, corr):
    """One tick as the outside wrappers see it: the raycast and the scene
    build wrapped, the EKF not, kernels in each, gaps between."""
    return [span("raycast_ms", t0 + 10, 30),
            span("scene_build_ms", t0 + 60, 30),
            *kernel("raycast_k", t0 + 15, 20, t0 + 12, corr),
            *kernel("ekf_k", t0 + 50, 4, t0 + 45, corr + 1),
            *kernel("scene_k", t0 + 70, 15, t0 + 62, corr + 2),
            *kernel("glue_k", t0 + 95, 3, t0 + 92, corr + 3)]


def program_tick(t0):
    """The program's spans of the same tick: around the outside wrappers'
    functions (raycast, scene_build), inside nothing of theirs (ekf), and
    the tick around them all."""
    return [span("slam2d.tick", t0 + 5, 95), span("raycast", t0 + 9, 32),
            span("ekf", t0 + 44, 8), span("scene_build", t0 + 59, 32)]


def test_program_spans_leave_the_outside_attribution_alone():
    labels = set(tracing.specs(all_readers())[0])
    assert not labels & {"raycast", "scene_build", "ekf", "slam2d.tick"}
    base = [e for k in range(4) for e in fleet_tick(100 * k, 10 * k)]
    spans = [e for k in range(4) for e in program_tick(100 * k)]
    plain = tracing.attribute(dict(traceEvents=base), labels)
    traced = tracing.attribute(dict(traceEvents=base + spans), labels)
    assert traced == plain
    for name, r in all_readers().items():
        data = dict(plain, ticks=4, wall_ms_per_tick=0.1, calls={},
                    frames=4, latency_ms=1.0, syncs=8)
        assert r.read(copy.deepcopy(data)) == r.read(dict(
            traced, ticks=4, wall_ms_per_tick=0.1, calls={}, frames=4,
            latency_ms=1.0, syncs=8)), name


def test_live_spans_name_the_live_gaps_and_nothing_else():
    """In the live cell no stage is wrapped from outside: the live step's
    spans take the idle gaps inside the step, the readers that were there
    read the same."""
    labels = set(tracing.specs(all_readers())[0])
    ev = [*kernel("pre_k", 10, 5, 8, 1), *kernel("nn_k", 30, 5, 28, 2),
          *kernel("post_k", 50, 5, 48, 3),
          *kernel("next_pre", 200, 5, 198, 4)]
    steps = [span("live.pre", 6, 8), span("live.iteration", 16, 28),
             span("live.post", 45, 8)]
    plain = tracing.attribute(dict(traceEvents=ev), labels)
    traced = tracing.attribute(dict(traceEvents=ev + steps), labels)
    # gaps 15-30 (middle 22.5) and 35-50 (42.5) in the iteration, 55-200
    # (127.5) outside the step
    assert plain["gaps_us"] == {"outside the stages": 175}
    assert traced["gaps_us"] == {"live.iteration": 30,
                                 "outside the stages": 145}
    for k in ("by_name_us", "launches_us", "busy_us", "ops"):
        assert traced[k] == plain[k]
    data = dict(traced, frames=1)
    assert reader("step_idle_ms.live").read(data) == pytest.approx(0.030)
    # the step's three kernels (5 us each) and its two gaps
    assert reader("step_ms.live").read(data) == pytest.approx(0.045)
    assert reader("step_ms.live").read(dict(plain, frames=1)) is None
    for name in ("device_idle_share.live", "host_syncs_per_frame.live"):
        extra = dict(frames=1, latency_ms=1.0, syncs=9)
        assert reader(name).read(dict(plain, **extra)) == \
            reader(name).read(dict(traced, **extra))


def counted(*pairs):
    return {"program_counts": [((name, n), {}) for name, n in pairs]}


def test_counter_readers_on_hand_built_data(monkeypatch):
    assert program.COUNT_CALLS == {
        "program_counts": "slam_tpu_torch.utils.profiling:count"}
    empty = dict(calls={}, ticks=8, frames=20, gaps_us={})
    for name in ("fit_iterations.fleet", "step_idle_ms.live",
                 "step_ms.live"):
        assert reader(name).read(empty) is None, name
    for name in NEW:
        assert reader(name).read(dict(empty, ticks=0, frames=0)) is None
    assert reader("host_syncs_per_step.fleet").read(empty) == 0.0
    monkeypatch.setattr(program, "COUNT_CALLS", {})     # no registry
    for name in NEW:
        assert reader(name).read(empty) is None, name
    monkeypatch.undo()
    data = dict(empty, calls=counted(("host_syncs", 1), ("k1.launches", 1),
                                     ("icp.fit_iterations", 1),
                                     ("host_syncs", 3),
                                     ("icp.fit_iterations", 6)))
    assert reader("host_syncs_per_step.fleet").read(data) == 4 / 8
    assert reader("host_syncs_per_step.live").read(data) == 4 / 20
    assert reader("fit_iterations.live").read(data) == 7 / 20
    zero = dict(empty, calls=counted(("k1.launches", 1)))
    assert reader("host_syncs_per_step.fleet").read(zero) == 0.0
    monkeypatch.setattr(program, "totals", lambda: {
        "k1.fit_iterations": 30, "k1.fit_problems": 4})
    assert reader("fit_iterations.fleet").read(empty) == 7.5
    monkeypatch.setattr(program, "totals", lambda: {"k4.launches": 3})
    assert reader("fit_iterations.fleet").read(empty) is None
    monkeypatch.setattr(program, "totals", lambda: None)
    assert reader("fit_iterations.fleet").read(empty) is None


@pytest.mark.parametrize("name,extra", [
    ("sim2d.fused.b4096", dict(robots=4, check_before=3)),
    ("sim2d.live.10hz", dict(trace_frames=6))])
def test_a_traced_cpu_run_reports_the_program_counters(name, extra):
    cell = core.Cell(name)
    cell.traffic = dict(cell.traffic, **extra)
    r = core.run_cell(cell, 2 ** 36 + 7, 1.0, True, "cpu")
    got = r["metrics"]
    if name.startswith("sim2d.fused"):
        # the CPU runs K1's plain version, which counts nothing
        assert got["host_syncs_per_step.fleet"]["value"] == 0.0
        assert "fit_iterations.fleet" not in got
    else:
        assert got["fit_iterations.live"]["value"] > 0.0
        assert got["host_syncs_per_step.live"]["value"] >= \
            got["fit_iterations.live"]["value"]
        # no device operations
        assert "step_idle_ms.live" not in got and "step_ms.live" not in got
