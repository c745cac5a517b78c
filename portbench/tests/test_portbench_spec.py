"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic, driver and metric found by name."""

import json
import re
import shutil

import pytest

from portbench.harness import core

ROOT = core.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert LINE.match(m["layer"])
    all_names = [m["name"] for m in metrics] + names + \
        [w["name"] for w in BENCH["workloads"]]
    for group in (names, [w["name"] for w in BENCH["workloads"]],
                  [m["name"] for m in metrics]):
        assert len(group) == len(set(group))
    assert all(NAME.match(n) for n in all_names)


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in BENCH["workloads"]:
        cell = core.Cell(w["name"])
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
        assert cell.per_layer
        for m in BENCH["per_layer"]:
            if m["name"] in cell.per_layer:
                assert m["moves"] in cell.end_to_end, (m["name"], w["name"])


def test_metrics_of_one_layer_share_its_name():
    by_module = {}
    for m in BENCH["per_layer"]:
        by_module.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_module.values())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(name):
    cell = core.Cell(name)
    assert cell.workload["config"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert cell.workload["traffic"] == next(
        w["traffic"] for w in BENCH["workloads"] if w["name"] == name)
    assert cell.chips == next(w["chips"] for w in BENCH["workloads"]
                              if w["name"] == name)
    assert hasattr(cell.driver(), "run")
    for mod in cell.readers().values():
        assert callable(mod.read)
    assert set(cell.limits)
    core.slam_config(cell.config["config"])


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_run_config(c):
    doc = json.loads((ROOT / c["file"]).read_text())
    assert doc["source"] == c["source"] and doc["reduced"] == c["reduced"]
    cfg = core.slam_config(doc["config"])
    import dataclasses
    assert json.loads(json.dumps(dataclasses.asdict(cfg))) == doc["config"]


def test_a_cell_added_as_files_alone(tmp_path):
    """A new configuration, traffic, cell and per-layer metric are new
    files and new entries: nothing that is there is edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    pb = tmp_path / "portbench"
    base = json.loads((ROOT / "portbench/configs/sim2d.json").read_text())
    base["name"] = "dummy"
    (pb / "configs/dummy.json").write_text(json.dumps(base))
    (pb / "traffic/dummy.fleet.json").write_text(json.dumps(dict(
        driver="fleet2d", robots=2, ticks_per_macro=2, warmup_macros=1,
        check_before=2, check_macros=1, trace_macros=1)))
    limits = json.loads((ROOT / "portbench/workloads/sim2d.fused.b4096.json")
                        .read_text())["limits"]
    (pb / "workloads/dummy.cell.json").write_text(json.dumps(dict(
        config="dummy", traffic="dummy.fleet", chips=1, limits=limits)))
    (pb / "metrics/dummy_ms.py").write_text(
        "from portbench.harness.layers import stage_ms\n"
        "STAGES = {'dummy_ms': ['slam_tpu_torch.sim.world2d:raycast']}\n"
        "def read(data):\n    return stage_ms(data, 'dummy_ms')\n")
    bench["configs"].append(dict(name="dummy", source="x",
                                 file="portbench/configs/dummy.json",
                                 reduced=[], why="test only"))
    bench["workloads"].append(dict(name="dummy.cell", config="dummy",
                                   traffic="dummy.fleet", chips=1,
                                   why="test only"))
    for m in bench["end_to_end"]:
        if m["name"] == "robot_steps_per_s":
            m["workloads"].append("dummy.cell")
    bench["per_layer"].append(dict(name="dummy_ms", unit="ms/tick",
                                   better="lower", source="device_trace",
                                   layer="simulator", moves="robot_steps_per_s",
                                   workloads=["dummy.cell"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = core.Cell("dummy.cell", root=tmp_path)
    assert cell.end_to_end == ["robot_steps_per_s", "setup_s"]
    assert list(cell.readers()) == ["dummy_ms"]
    r = core.run_cell(cell, 2 ** 40 + 3, 0.5, True, "cpu")
    assert r["correct"] is True
    assert list(r["checks"]) == list(limits)
    r = core.run_cell(cell, 2 ** 40 + 3, 0.5, False, "cpu")
    assert set(r["metrics"]) == {"robot_steps_per_s", "setup_s"}


def test_unknown_cell_is_refused():
    with pytest.raises(core.Refused):
        core.Cell("no.such.cell")
