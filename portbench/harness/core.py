"""The harness: one run of one cell of the benchmark.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name, in files of its own:
  BENCHMARK.json                 which metrics each cell reports
  portbench/workloads/<w>.json   the cell: configuration, traffic, chips,
                                 and the limits of its output check
  portbench/configs/<c>.json     the configuration as it is run
  portbench/traffic/<t>.json     the traffic's parameters and its driver
  portbench/drivers/<d>.py       the driver of a kind of traffic
  portbench/metrics/<m>.py       the reader of a per-layer metric
  portbench/roofline/<k>.py      a kernel's operations and bytes
so a cell, a configuration or a metric is added as new files and entries.

With --trace 0 the result line holds the cell's end-to-end metrics, with
--trace 1 its per-layer metrics (read from a profiled slice run after the
window). Both check the outputs of the timed path against the plain
reference (portbench/reference/) and print each compared number beside its
limit, last on standard error and as the last key of the result line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# modules that must not be loaded in the process that prints the result,
# compared by whole top-level name (the port's package is slam_tpu_torch)
FORBIDDEN = ("jax", "jaxlib", "flax", "slam_tpu")


class Refused(Exception):
    """The run cannot measure: no result is printed, the exit code is 2."""


def load_json(root: Path, kind: str, name: str) -> dict:
    path = root / "portbench" / kind / f"{name}.json"
    if not path.is_file():
        raise Refused(f"no {kind} file {path.relative_to(root)}")
    with open(path) as f:
        return json.load(f)


def load_module(root: Path, kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = root / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        raise Refused(f"no {kind} module {path.relative_to(root)}")
    mod_name = f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell resolved by name: its workload, configuration and traffic
    files, its driver, and the metrics BENCHMARK.json gives it."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root
        self.name = name
        bench_path = root / "BENCHMARK.json"
        if not bench_path.is_file():
            raise Refused("no BENCHMARK.json at the root of the checkout")
        with open(bench_path) as f:
            self.bench = json.load(f)
        self.workload = load_json(root, "workloads", name)
        self.config = load_json(root, "configs", self.workload["config"])
        self.traffic = load_json(root, "traffic", self.workload["traffic"])
        self.chips = int(self.workload["chips"])
        self.limits = dict(self.workload["limits"])
        self.end_to_end = [m["name"] for m in self.bench["end_to_end"]
                           if self._has(m)]
        self.per_layer = [m["name"] for m in self.bench["per_layer"]
                          if self._has(m)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def driver(self):
        return load_module(self.root, "drivers", self.traffic["driver"])

    def readers(self) -> dict:
        return {m: load_module(self.root, "metrics", m)
                for m in self.per_layer}

    def units(self) -> dict:
        return {m["name"]: m["unit"] for m in self.bench["end_to_end"] +
                self.bench["per_layer"]}


def slam_config(values: dict):
    """The port's SlamConfig holding every value of a configuration file's
    "config" group (lists become the tuples the dataclasses hold)."""
    import dataclasses

    from slam_tpu_torch import config as cm

    top = {}
    for f in dataclasses.fields(cm.SlamConfig):
        v = values.get(f.name)
        if isinstance(v, dict):
            cls = type(getattr(cm.SlamConfig(), f.name))
            v = cls(**{k: tuple(x) if isinstance(x, list) else x
                       for k, x in v.items()})
        if v is not None:
            top[f.name] = v
    return cm.SlamConfig(**top)


def use_checkout_caches(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout. The port builds
    its nvcc library and its native runtime into build/slam_tpu_torch/
    beside the package; these cover any PyTorch extension or Triton
    kernel a later program builds."""
    cache = root / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Forbidden(Exception):
    """A process of the run (another rank's, where a cell runs several)
    loaded a forbidden module: no result is printed."""

    def __init__(self, found: list):
        super().__init__(found)
        self.found = found


def device_info(device: str, count: int, peak: int) -> dict:
    """The result line's `device`: the card's name, the cards used and the
    peak on the fullest (on the CPU, where a test drives the harness, the
    CPU's)."""
    if device == "cpu":
        return dict(platform="cpu", kind="cpu", count=count,
                    memory_peak_bytes=peak)
    import torch
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=count, memory_peak_bytes=peak)


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out[0] if out else "not read"


class Context:
    """What a driver is given: the cell, the run's arguments, the device
    (the card; the CPU only where a test drives the harness without the
    look for a card) and the start of the process's clock."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = t_start
        self.traffic = cell.traffic
        self.config_values = cell.config["config"]

    def slam_config(self):
        return slam_config(self.config_values)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """Drive one run and return the result dict (the line's content).
    The driver returns end_to_end values, attempted / failed, the
    compared numbers, and with `trace` the profiled slice's data."""
    from portbench.harness import checks, tracing

    ctx = Context(cell, seed, seconds, trace, device,
                  time.perf_counter() if t_start is None else t_start)
    out = cell.driver().run(ctx)
    verdict = checks.judge(out["checks"], cell.limits)
    units = cell.units()
    if trace:
        values = tracing.read_metrics(cell.readers(), out["trace"])
    else:
        missing = [m for m in cell.end_to_end if m not in out["end_to_end"]]
        if missing:
            raise RuntimeError(f"the driver measured no {missing}")
        values = {m: out["end_to_end"][m] for m in cell.end_to_end}
    result = dict(correct=verdict["correct"], attempted=out["attempted"], failed=out["failed"],
                  metrics={k: {"value": v, "unit": units[k]}
                           for k, v in values.items()},
                  device=out["device"])
    if trace:
        result["device"].update(busy_s=out["trace"]["busy_s"],
                                window_s=out["trace"]["window_s"])
        result["breakdown"] = out["trace"]["breakdown"]
    result["checks"] = verdict["numbers"]
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = Cell(args.workload)
        use_checkout_caches(cell.root)
        import torch
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is False: the benchmark "
                          "measures on an NVIDIA card only")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"the cell needs {cell.chips} cards, "
                          f"{torch.cuda.device_count()} visible")
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    # the process's load: one host thread for PyTorch's CPU operations,
    # whose spinning pool would contend with the dispatching thread
    torch.set_num_threads(1)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", t_start)
        found = forbidden_loaded()
    except Forbidden as e:
        found = e.found
    if found:
        print(f"portbench: a process of the run loaded {found}; the "
              "benchmark runs the port alone", file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed} on "
          f"{power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
