"""The shared-map fleet over ranks: two gloo ranks on the CPU at two
robots a rank (a copy of the benchmark with that traffic and the cell
added to it), a sound run correct, each fault the cell can have (a step
that returns its state, half the fleet left out, the exchange between
ranks left out, an answer altered) not correct, planted on every rank,
and a forbidden module loaded by another rank than the one that prints
refused."""

import json
import shutil
import sys
import types

import pytest

from portbench.harness import core

NAME = "sim2d_pf.shared.4x1024"


def plant(mp, fault):
    from slam_tpu_torch.parallel import shared_map
    from slam_tpu_torch.pipeline import slam2d
    orig = slam2d.slam_step
    if fault == "unchanged":
        mp.setattr(slam2d, "slam_step", lambda s, *a, **k: s)
    elif fault == "half":
        from portbench.tests.test_portbench_faults import mix

        def half(s, *a, **k):
            return mix(orig(s, *a, **k), s, s.pose.shape[0] // 2)
        mp.setattr(slam2d, "slam_step", half)
    elif fault == "exchange":
        mp.setattr(shared_map, "_sum_over_ranks", lambda g, group, f=None:
                   (g, f))
    elif fault == "jax":
        mp.setitem(sys.modules, "jax", types.ModuleType("jax"))
    elif fault == "altered":
        def altered(s, *a, **k):
            out = orig(s, *a, **k)
            pose = out.pose.clone()
            pose[0, 0] += 0.05
            return out.replace(pose=pose)
        mp.setattr(slam2d, "slam_step", altered)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("bench")
    shutil.copytree(core.ROOT / "portbench", r / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"]:
        if m["name"] in ("robot_steps_per_s", "macro_ms_p95"):
            m["workloads"].append(NAME)
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    p = r / "portbench" / "traffic" / "shared.particle.4x1024.json"
    t = json.loads(p.read_text())
    t.update(ranks=2, robots=2, check_before=2, warmup_macros=1)
    p.write_text(json.dumps(t))
    return r


def run(root, monkeypatch=None, fault=None, here=True):
    """One run; `fault` planted in the other ranks, and with `here` in
    this one (rank 0) too."""
    cell = core.Cell(NAME, root=root)
    drv = cell.driver()
    if fault:
        if here:
            plant(monkeypatch, fault)
        monkeypatch.setattr(drv, "RANK_MODULE", "portbench.tests.fault_rank")
        orig = drv.subprocess.Popen

        def popen(cmd, **k):
            return orig([cmd[0], cmd[1], cmd[2], fault] + cmd[3:], **k)
        monkeypatch.setattr(drv.subprocess, "Popen", popen)
    return core.run_cell(cell, 2 ** 34 + 3, 0.5, False, "cpu")


def test_sound_run_is_correct(root):
    r = run(root)
    assert r["correct"] is True and r["device"]["count"] == 2


@pytest.mark.parametrize("fault", ["unchanged", "half", "exchange",
                                   "altered"])
def test_fault_is_not_correct(root, monkeypatch, fault):
    assert run(root, monkeypatch, fault)["correct"] is False


def test_forbidden_module_on_another_rank_is_refused(root, monkeypatch):
    with pytest.raises(core.Forbidden) as e:
        run(root, monkeypatch, "jax", here=False)
    assert e.value.found == ["jax"]


def test_control_fails(root):
    cell = core.Cell(NAME, root=root)
    ctx = core.Context(cell, 2 ** 33 + 9, 1.0, False, "cpu", 0.0)
    numbers = cell.driver().control(ctx, 1)
    from portbench.harness import checks
    assert checks.judge(numbers, cell.limits)["correct"] is False
