"""ctypes bindings for the native host runtime (runtime/src/slamrt.cpp) —
counterpart of slam_tpu/runtime/native.py (`FrameRing`, `ScanLoader`,
`Profiler`), with the same names and behaviour.

The C++ layer is framework-free: a lock-free SPSC frame ring (the
transport between sensor feeds and the device step), a threaded loader
that fills a ring from a replay file or a seeded synthetic source, and a
microsecond scoped profiler. The port builds its own copy of the library
at first use, with g++ and runtime/Makefile's flags, into
`build/slam_tpu_torch/libslamrt-<hash>.so` beside the package; the hash
covers the sources and flags, so an edited source is rebuilt. Nothing is
built when the module is imported.
"""

from __future__ import annotations

import ctypes as C
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np

from slam_tpu_torch.utils import profiling

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCES = (_ROOT / "runtime" / "src" / "slamrt.cpp",
           _ROOT / "runtime" / "src" / "slamrt.h")
BUILD_DIR = _ROOT / "build" / "slam_tpu_torch"
# runtime/Makefile's CXXFLAGS
CXXFLAGS = ("-O2", "-g", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
            "-pthread")
_lib: Optional[C.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libslamrt-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the runtime library unless it is already built; returns its
    path. Raises when no C++ compiler is found or the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (g++, or set CXX) to "
                           "build the native runtime")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    res = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", str(tmp),
                          str(SOURCES[0])], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building the native runtime failed "
                           f"({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> C.CDLL:
    global _lib
    if _lib is None:
        L = C.CDLL(str(build()))
        L.slamrt_ring_create.restype = C.c_void_p
        L.slamrt_ring_create.argtypes = [C.c_uint32, C.c_uint64]
        L.slamrt_ring_destroy.argtypes = [C.c_void_p]
        L.slamrt_ring_acquire.restype = C.POINTER(C.c_float)
        L.slamrt_ring_acquire.argtypes = [C.c_void_p, C.c_int]
        L.slamrt_ring_publish.argtypes = [C.c_void_p, C.c_uint64]
        L.slamrt_ring_abort.argtypes = [C.c_void_p]
        L.slamrt_ring_pop.restype = C.c_uint64
        L.slamrt_ring_pop.argtypes = [C.c_void_p, C.POINTER(C.c_float),
                                      C.POINTER(C.c_uint64)]
        L.slamrt_ring_published.restype = C.c_uint64
        L.slamrt_ring_published.argtypes = [C.c_void_p]
        L.slamrt_ring_dropped.restype = C.c_uint64
        L.slamrt_ring_dropped.argtypes = [C.c_void_p]
        L.slamrt_ring_available.restype = C.c_uint32
        L.slamrt_ring_available.argtypes = [C.c_void_p]
        L.slamrt_loader_create_replay.restype = C.c_void_p
        L.slamrt_loader_create_replay.argtypes = [
            C.c_void_p, C.c_char_p, C.c_uint64, C.c_int, C.c_double]
        L.slamrt_loader_create_synthetic.restype = C.c_void_p
        L.slamrt_loader_create_synthetic.argtypes = [
            C.c_void_p, C.c_uint64, C.c_uint64, C.c_double, C.c_int]
        for f in ("start", "stop", "destroy"):
            getattr(L, f"slamrt_loader_{f}").argtypes = [C.c_void_p]
        L.slamrt_loader_produced.restype = C.c_uint64
        L.slamrt_loader_produced.argtypes = [C.c_void_p]
        L.slamrt_loader_error.restype = C.c_int
        L.slamrt_loader_error.argtypes = [C.c_void_p]
        L.slamrt_prof_create.restype = C.c_void_p
        L.slamrt_prof_destroy.argtypes = [C.c_void_p]
        L.slamrt_prof_begin.restype = C.c_int32
        L.slamrt_prof_begin.argtypes = [C.c_void_p, C.c_char_p]
        L.slamrt_prof_end.argtypes = [C.c_void_p, C.c_int32]
        L.slamrt_prof_lookup.restype = C.c_int32
        L.slamrt_prof_lookup.argtypes = [C.c_void_p, C.c_char_p]
        L.slamrt_prof_stats.argtypes = [
            C.c_void_p, C.c_int32, C.POINTER(C.c_uint64),
            C.POINTER(C.c_double), C.POINTER(C.c_double),
            C.POINTER(C.c_double)]
        L.slamrt_prof_report.restype = C.c_uint64
        L.slamrt_prof_report.argtypes = [C.c_void_p, C.c_char_p, C.c_uint64]
        _lib = L
    return _lib


class FrameRing:
    """SPSC frame ring of `slots` float32 frames of `frame_shape`."""

    def __init__(self, slots: int, frame_shape: tuple):
        self._shape = tuple(frame_shape)
        self._floats = int(np.prod(frame_shape))
        self._r = lib().slamrt_ring_create(slots, self._floats)
        self._scratch = np.empty(self._floats, np.float32)

    def push(self, frame: np.ndarray, drop_oldest: bool = True) -> bool:
        """Copy a frame in; with drop_oldest a full ring overwrites its
        oldest unread frame, else the push returns False."""
        # validate before acquire, and abort on a failed copy: acquire holds
        # the producer lock until publish, so a raise between the two would
        # deadlock every later push and loader thread
        arr = np.asarray(frame, np.float32).ravel()
        if arr.size != self._floats:
            raise ValueError(f"frame has {arr.size} floats, ring expects "
                             f"{self._floats} (shape {self._shape})")
        ptr = lib().slamrt_ring_acquire(self._r, int(drop_oldest))
        if not ptr:
            return False
        try:
            np.ctypeslib.as_array(ptr, shape=(self._floats,))[:] = arr
        except Exception:
            lib().slamrt_ring_abort(self._r)
            raise
        lib().slamrt_ring_publish(self._r, 0)
        return True

    def pop_into(self, out: np.ndarray) -> int:
        """Pop the next frame into `out` (a C-contiguous float32 array of
        the frame's size, e.g. a pinned host buffer); returns its sequence
        id, or 0 when the ring is empty (out untouched). A popped frame
        counts as `live.frames`, and its time from publish to this pop (the
        ring's steady clock, which time.monotonic_ns reads) as
        `live.ring_wait_ns` (utils/profiling.py)."""
        if (out.dtype != np.float32 or out.size != self._floats
                or not out.flags.c_contiguous):
            raise ValueError(f"pop_into takes a contiguous float32 array of "
                             f"{self._floats} floats")
        t = C.c_uint64(0)
        seq = lib().slamrt_ring_pop(
            self._r, out.ctypes.data_as(C.POINTER(C.c_float)), C.byref(t))
        if seq:
            profiling.count("live.frames")
            profiling.count("live.ring_wait_ns", time.monotonic_ns() - t.value)
        return seq

    def pop(self):
        """Returns (seq, frame) or (0, None)."""
        seq = self.pop_into(self._scratch)
        if seq == 0:
            return 0, None
        return seq, self._scratch.reshape(self._shape).copy()

    @property
    def published(self):
        return lib().slamrt_ring_published(self._r)

    @property
    def dropped(self):
        return lib().slamrt_ring_dropped(self._r)

    @property
    def available(self):
        return lib().slamrt_ring_available(self._r)

    def __del__(self):
        try:
            lib().slamrt_ring_destroy(self._r)
        except Exception:
            pass


class ScanLoader:
    """Threaded producer filling a FrameRing from a replay file (`path`) or
    a seeded synthetic source."""

    def __init__(self, ring: FrameRing, path: str | None = None,
                 seed: int = 0, rate_hz: float = 0.0, loop: bool = True,
                 num_threads: int = 2):
        # the worker threads write into the ring's C buffer: hold the ring
        # so it outlives this loader
        self._ring = ring
        if path is not None:
            if not os.path.exists(path):
                raise FileNotFoundError(f"replay file not found: {path}")
            if os.path.getsize(path) < ring._floats * 4:
                raise ValueError(
                    f"replay file {path} is smaller than one "
                    f"{ring._floats}-float frame")
            self._l = lib().slamrt_loader_create_replay(
                ring._r, str(path).encode(), ring._floats, int(loop),
                rate_hz)
        else:
            self._l = lib().slamrt_loader_create_synthetic(
                ring._r, ring._floats, seed, rate_hz, num_threads)

    def start(self):
        lib().slamrt_loader_start(self._l)

    @property
    def error(self) -> bool:
        """True when a replay worker failed to open its file."""
        return bool(lib().slamrt_loader_error(self._l))

    def stop(self):
        lib().slamrt_loader_stop(self._l)

    @property
    def produced(self):
        return lib().slamrt_loader_produced(self._l)

    def __del__(self):
        try:
            lib().slamrt_loader_destroy(self._l)
        except Exception:
            pass


class Profiler:
    """Scoped microsecond profiler."""

    def __init__(self):
        self._p = lib().slamrt_prof_create()

    class _Scope:
        def __init__(self, prof, name):
            self.prof, self.name = prof, name.encode()

        def __enter__(self):
            self.id = lib().slamrt_prof_begin(self.prof._p, self.name)
            return self

        def __exit__(self, *a):
            lib().slamrt_prof_end(self.prof._p, self.id)

    def scope(self, name: str) -> "_Scope":
        return Profiler._Scope(self, name)

    def stats(self, name: str):
        pid = lib().slamrt_prof_lookup(self._p, name.encode())
        calls = C.c_uint64(0)
        tot = C.c_double(0)
        mn = C.c_double(0)
        mx = C.c_double(0)
        lib().slamrt_prof_stats(self._p, pid, C.byref(calls), C.byref(tot),
                                C.byref(mn), C.byref(mx))
        return dict(calls=calls.value, total_us=tot.value, min_us=mn.value,
                    max_us=mx.value)

    def report(self) -> str:
        buf = C.create_string_buffer(64 * 1024)
        n = lib().slamrt_prof_report(self._p, buf, len(buf))
        return buf.raw[:n].decode()

    def __del__(self):
        try:
            lib().slamrt_prof_destroy(self._p)
        except Exception:
            pass
