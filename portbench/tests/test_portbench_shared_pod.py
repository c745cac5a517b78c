"""The pod cell sim2d_pf.shared.4x8192 on the CPU: a copy of the benchmark
with its traffic cut to two gloo ranks of two robots (as
test_portbench_shared.py cuts the 4x1024 traffic), a sound run correct
with one whole-grid merge a macro counted by the program, and the
exchange between ranks left out, or half the fleet, not correct."""

import json
import shutil
import time

import pytest

from portbench.harness import checks, core
from portbench.tests.test_portbench_shared import plant

NAME = "sim2d_pf.shared.4x8192"
TRAFFIC = "shared.particle.4x8192"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("pod")
    shutil.copytree(core.ROOT / "portbench", r / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", r / "BENCHMARK.json")
    p = r / "portbench" / "traffic" / f"{TRAFFIC}.json"
    t = json.loads(p.read_text())
    t.update(ranks=2, robots=2, check_before=2, warmup_macros=1)
    p.write_text(json.dumps(t))
    return r


def run(root, monkeypatch=None, fault=None):
    """One untraced run (the fault planted on every rank): the driver's
    output, its verdict and rank 0's merge counters."""
    from slam_tpu_torch.utils import profiling
    cell = core.Cell(NAME, root=root)
    drv = cell.driver()
    if fault:
        plant(monkeypatch, fault)
        monkeypatch.setattr(drv, "RANK_MODULE", "portbench.tests.fault_rank")
        orig = drv.subprocess.Popen

        def popen(cmd, **k):
            return orig([cmd[0], cmd[1], cmd[2], fault] + cmd[3:], **k)
        monkeypatch.setattr(drv.subprocess, "Popen", popen)
    profiling.reset_counters()
    ctx = core.Context(cell, 2 ** 34 + 5, 0.5, False, "cpu",
                       time.perf_counter())
    out = drv.run(ctx)
    merges = {n: profiling.count_of(f"shared_map.{n}")
              for n in ("merges", "merge_bytes")}
    return out, checks.judge(out["checks"], cell.limits), merges


def test_sound_run_is_correct_with_one_merge_a_macro(root):
    out, verdict, merges = run(root)
    assert verdict["correct"] is True and out["device"]["count"] == 2
    cell = core.Cell(NAME, root=root)
    macros = cell.traffic["warmup_macros"] + out["window"]["macros"]
    assert macros > 1 and merges["merges"] == macros
    G = cell.config["config"]["mls"]["size_x"]
    assert merges["merge_bytes"] == macros * 4 * G * G * 4


@pytest.mark.parametrize("fault", ["exchange", "half"])
def test_fault_is_not_correct(root, monkeypatch, fault):
    assert run(root, monkeypatch, fault)[1]["correct"] is False
