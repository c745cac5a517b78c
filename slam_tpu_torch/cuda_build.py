"""Build and load the package's CUDA kernels (`csrc/*.cu`).

The kernels have a plain C interface and are compiled by `nvcc` into one
shared library, loaded with ctypes: no PyTorch headers, so a build takes
seconds. Each source compiles in its own `nvcc` process, all started
together, and one more links them. The build happens at first use, into
`build/slam_tpu_torch/` beside the package, from the sources in the
checkout alone. The library's file name carries a hash of the sources and
flags, so an edited kernel is rebuilt.

Nothing here runs at import time: CPU-only machines import the package but
never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "slam_tpu_torch"

# -fmad=false: every product and sum is rounded on its own, as PyTorch's
# elementwise ops round them, so kernels and their plain versions agree on
# the distances whose ties and minima they compare.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "slam_icp_fused_planes": [_P] * 9 + [_I] * 4 + [_F, _F, _I, _P],
    "slam_icp_tiled_planes": [_P] * 13 + [_I] * 4 + [_F, _F, _I, _P],
    "slam_nn": [_P] * 9 + [_I] * 5 + [_P, _I, _I, _P],
    "slam_pf_pack": [_P, _L, _L, _L, _I, _I, _P, _P],
    "slam_pf_score": [_P, _I, _I] + [_P] * 5 + [_I] * 3 + [_F, _P, _I, _I,
                                                           _P],
    "slam_raycast3d": [_P, _L, _L, _L] + [_P] * 10 + [_I] * 6 + [_F, _F,
                                                                  _P],
    "slam_ground_gp": [_P] * 3 + [_L] + [_P] * 5 + [_I] * 6 + [_F] * 8 +
                      [_P],
}

# dynamic shared memory one block may use on sm_90
MAX_SMEM = 232448

_lib = None


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libslam_tpu_torch-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it is already built.
    The compiler's per-kernel register and spill report (`ptxas -v`) is
    kept beside the library, in `<library>.ptxas.txt`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    nvcc = nvcc_path()
    objs, procs = [], []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = [p.communicate()[0] for p in procs]
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{log}")
    tmp = out.with_suffix(f".{tag}.so")
    res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                          *map(str, objs)], capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    Path(f"{out}.ptxas.txt").write_text("".join(logs))
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_operands(name: str, tensors, shapes, dtypes=None,
                   contiguous=None) -> None:
    """Raise unless every tensor is a tensor of its shape and type (f32
    unless `dtypes` says otherwise), contiguous unless `contiguous` says
    the kernel reads it through its strides, all on the first tensor's
    device: what a kernel reads through a raw pointer."""
    dev = tensors[0].device
    dtypes = dtypes or [torch.float32] * len(tensors)
    contiguous = contiguous or [True] * len(tensors)
    for t, shape, dtype, cont in zip(tensors, shapes, dtypes, contiguous):
        if (t.device != dev or t.dtype != dtype
                or tuple(t.shape) != tuple(shape)
                or (cont and not t.is_contiguous())):
            raise ValueError(f"{name} takes {'contiguous ' if cont else ''}"
                             f"tensors on one "
                             f"device: got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, want {dtype} {tuple(shape)}")


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
