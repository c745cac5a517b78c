"""The measurement path refuses to run without a card, and in a checkout
that holds only BENCHMARK.json and portbench/; with a card it prints one
result line. Subprocesses, as the benchmark is run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness import core

CMD = [sys.executable, "portbench/run.py", "--workload", "sim2d.live.10hz",
       "--seed", str(2 ** 33 + 1), "--seconds", "2", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run(CMD, cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def _has_card():
    import torch
    return torch.cuda.is_available()


def test_refuses_without_a_card():
    if _has_card():
        pytest.skip("a card is visible")
    r = _run(core.ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "cuda" in r.stderr.lower()


def test_refuses_with_the_benchmark_alone(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    r = _run(tmp_path, env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.cuda
def test_one_result_line_on_a_card():
    if not _has_card():
        pytest.skip("needs an NVIDIA card")
    r = _run(core.ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert list(line)[-1] == "checks"
