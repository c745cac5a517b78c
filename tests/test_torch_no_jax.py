"""The port stands alone: slam_tpu_torch imports and runs a tick (and
imports its pose graph, MLS, FFT-match, relocalization, metrics, live,
fiducial, calibration, sample-map and utility modules, its entry
points and its multi-device layer, and builds and
drives its native runtime in build/slam_tpu_torch/) with jax unimportable and no
module of the slam_tpu package loaded (by import or by file path), no source file of it (or chip_smoke.py) imports jax or the
slam_tpu package or builds a path into slam_tpu/ (nor do
tests/torch_dist_worker.py and tests/torch_sp_worker.py, the distributed
tests' rank processes; parallel/rows.py, the sp axis's exchanges, among
the sources), and
chip_smoke.py refuses to report without a GPU."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

TICK = r"""
import os
import sys
ROOT = os.getcwd()
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import torch
torch.set_num_threads(1)
from slam_tpu_torch.config import sim2d_config
from slam_tpu_torch.pipeline import slam2d
from slam_tpu_torch.sim import world2d
cfg = sim2d_config()
gen = torch.Generator().manual_seed(0)
world = world2d.make_world(gen, cfg.sim, device="cpu")
state = slam2d.init_state(cfg, 2, device="cpu", generator=gen)
state = slam2d.slam_step(state, world, cfg, gen)
assert torch.isfinite(state.pose).all() and int(state.step[0]) == 1
import slam_tpu_torch.graph.pose_graph
import slam_tpu_torch.mapping.mls
import slam_tpu_torch.ops.fft_match
import slam_tpu_torch.pipeline.relocalize
import slam_tpu_torch.utils.metrics
# the live-frame path and the camera periphery
import slam_tpu_torch.calib
import slam_tpu_torch.live
import slam_tpu_torch.mapping.sample_map
import slam_tpu_torch.ops.fiducial
import slam_tpu_torch.sim.replay
import slam_tpu_torch.utils.checkpoint
import slam_tpu_torch.utils.pcd
import slam_tpu_torch.utils.profiling
import slam_tpu_torch.utils.trajectory
import slam_tpu_torch.utils.viz
# the entry points users run
import slam_tpu_torch.eviction_study
import slam_tpu_torch.make_replay
import slam_tpu_torch.run_fleet
import slam_tpu_torch.run_reloc
import slam_tpu_torch.run_sim2d
import slam_tpu_torch.run_sim3d
# the multi-device layer
import slam_tpu_torch.mesh_scaling
import slam_tpu_torch.parallel.mesh
import slam_tpu_torch.parallel.multihost
import slam_tpu_torch.parallel.rows
import slam_tpu_torch.parallel.shared_map
from slam_tpu_torch.runtime import native
lib = native.build()
assert str(lib.parent) == os.path.join(ROOT, "build", "slam_tpu_torch"), lib
ring = native.FrameRing(4, (8,))
assert ring.push(torch.arange(8.0).numpy()) and ring.pop()[0] == 1
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "slam_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
# nor any module loaded from a file of the JAX package, under any name
jax_pkg = os.path.join(ROOT, "slam_tpu") + os.sep
bad = [m for m, mod in list(sys.modules.items())
       if os.path.abspath(getattr(mod, "__file__", None) or "")
       .startswith(jax_pkg)]
assert not bad, bad
print("TICK_OK")
"""


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    env["PYTHONPATH"] = str(ROOT) if cwd == ROOT else ""
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_tick_runs_with_jax_unimportable():
    r = _run(["-c", TICK], ROOT)
    assert r.returncode == 0, r.stderr
    assert "TICK_OK" in r.stdout


def test_no_jax_imports_in_port_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax|slam_tpu)(\.|\s|$)", re.M)
    files = sorted((ROOT / "slam_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_worker.py",
              ROOT / "tests" / "torch_sp_worker.py"]
    assert len(files) > 10
    assert ROOT / "slam_tpu_torch" / "parallel" / "rows.py" in files
    for f in files:
        assert not pat.search(f.read_text()), f


def _code_strings(tree):
    """String constants of a module outside its docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def _joins_slam_tpu(node) -> bool:
    """A `... / "slam_tpu"` path join or an os.path.join(..., "slam_tpu")."""
    def named(n):
        return isinstance(n, ast.Constant) and n.value == "slam_tpu"
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        return named(node.left) or named(node.right)
    return (isinstance(node, ast.Call)
            and getattr(node.func, "attr", None) == "join"
            and any(named(a) for a in node.args))


def test_port_builds_no_path_into_the_jax_package():
    """No file of the port loads a module by file path, joins slam_tpu into
    a path, or holds a path through slam_tpu/ in a string of its code. (A
    "file.py:line" record of the TPU kernel a kernel replaces is not a
    path it opens.)"""
    path = re.compile(r"(^|[/\\])slam_tpu[/\\]")
    file_line = re.compile(r"\.py:\d+$")
    files = sorted((ROOT / "slam_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        text = f.read_text()
        assert "spec_from_file_location" not in text, f
        assert "SourceFileLoader" not in text, f
        tree = ast.parse(text)
        assert not any(_joins_slam_tpu(n) for n in ast.walk(tree)), f
        for s in _code_strings(tree):
            assert not (path.search(s) and not file_line.search(s)), (f, s)


def test_chip_smoke_needs_a_gpu(tmp_path):
    # here there is no CUDA device: the script must fail and print no result
    if torch.cuda.is_available():
        return
    r = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    # alone in a directory, without the package, it fails as well
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
