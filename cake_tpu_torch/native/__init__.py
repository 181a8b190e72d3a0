"""The port's native (C++) host runtime, built on first use with g++.

The model runs on the card through PyTorch and the port's CUDA kernels;
the host runtime around it has native parts, as in the JAX package
(`cake_tpu/native/`), from the same C++ sources:

  * csrc/safetensors.cpp — mmap'd safetensors reader (zero-copy tensor
    views + madvise prefetch), wrapped in native/safetensors.py and
    used by utils/loading.load_weights
  * csrc/scheduler.cpp — thread-safe continuous-batching FIFO scheduler,
    wrapped in native/scheduler.py and taken by the serving engine
  * csrc/embed.cpp — the C-ABI embed library (native/embed.py builds it)

`get_library()` compiles the first two with `g++ -O2 -std=c++17` into
`cake_tpu_torch/_build/libcake_native_<hash>.so`, the name keyed on the
sources' content (an edit rebuilds, an unchanged tree is reused), through
a per-process temporary file and `os.replace`, so concurrent builders
never race; ctypes loads it. Where no g++ is found or the build fails, a
warning is logged once and the callers take their Python versions: the
FIFO `PyScheduler` and the numpy memmap reader. This is host code, not a
kernel: it runs the same on a machine with a card and without one.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SOURCES = ("safetensors.cpp", "scheduler.cpp")

_lock = threading.Lock()
_lib = None
_lib_error: str | None = None
# the loaded library's path and the seconds get_library took to build
# and load it (only the load, where the library was already built)
BUILD_INFO: dict = {}


def source_hash(sources) -> str:
    """The first 16 hex digits of the sha256 of the sources' bytes."""
    h = hashlib.sha256()
    for src in sources:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_shared(stem: str, sources, extra_flags=()) -> str:
    """Compile `sources` (names in csrc/) into
    `_build/lib<stem>_<hash>.so` unless that file exists; returns its
    path. Raises CalledProcessError (or FileNotFoundError without g++)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR,
                           f"lib{stem}_{source_hash(sources)}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = f"{so_path}.{os.getpid()}.tmp"   # per-process; replace is atomic
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
           *[os.path.join(CSRC_DIR, s) for s in sources], *extra_flags]
    log.info("building %s: %s", stem, " ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    os.replace(tmp, so_path)
    return so_path


def _declare(lib) -> None:
    c = ctypes
    # safetensors
    lib.cake_st_open.restype = c.c_void_p
    lib.cake_st_open.argtypes = [c.c_char_p, c.c_char_p, c.c_int]
    lib.cake_st_num_tensors.restype = c.c_int64
    lib.cake_st_num_tensors.argtypes = [c.c_void_p]
    lib.cake_st_name.restype = c.c_char_p
    lib.cake_st_name.argtypes = [c.c_void_p, c.c_int64]
    lib.cake_st_dtype.restype = c.c_char_p
    lib.cake_st_dtype.argtypes = [c.c_void_p, c.c_int64]
    lib.cake_st_ndim.restype = c.c_int32
    lib.cake_st_ndim.argtypes = [c.c_void_p, c.c_int64]
    lib.cake_st_shape.restype = None
    lib.cake_st_shape.argtypes = [c.c_void_p, c.c_int64,
                                  c.POINTER(c.c_int64)]
    lib.cake_st_data.restype = c.POINTER(c.c_uint8)
    lib.cake_st_data.argtypes = [c.c_void_p, c.c_int64,
                                 c.POINTER(c.c_int64)]
    lib.cake_st_prefetch.restype = None
    lib.cake_st_prefetch.argtypes = [c.c_void_p, c.c_int64]
    lib.cake_st_close.restype = None
    lib.cake_st_close.argtypes = [c.c_void_p]
    # scheduler
    lib.cake_sched_create.restype = c.c_void_p
    lib.cake_sched_create.argtypes = [c.c_int32, c.c_int32]
    lib.cake_sched_destroy.restype = None
    lib.cake_sched_destroy.argtypes = [c.c_void_p]
    lib.cake_sched_submit.restype = c.c_int32
    lib.cake_sched_submit.argtypes = [c.c_void_p, c.c_uint64, c.c_int32,
                                      c.c_int32]
    lib.cake_sched_cancel.restype = c.c_int32
    lib.cake_sched_cancel.argtypes = [c.c_void_p, c.c_uint64]
    lib.cake_sched_plan.restype = c.c_int32
    lib.cake_sched_plan.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_uint64), c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.POINTER(c.c_uint64), c.POINTER(c.c_int32), c.POINTER(c.c_int32),
    ]
    lib.cake_sched_report.restype = c.c_int32
    lib.cake_sched_report.argtypes = [c.c_void_p, c.c_uint64, c.c_int32,
                                      c.c_int32]
    lib.cake_sched_queue_depth.restype = c.c_int32
    lib.cake_sched_queue_depth.argtypes = [c.c_void_p]
    lib.cake_sched_active.restype = c.c_int32
    lib.cake_sched_active.argtypes = [c.c_void_p]
    lib.cake_sched_completed.restype = c.c_uint64
    lib.cake_sched_completed.argtypes = [c.c_void_p]


def get_library():
    """Build (if needed) and load the native library; None, with one
    logged warning, where it cannot be built."""
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            t0 = time.perf_counter()
            so_path = build_shared("cake_native", _SOURCES,
                                   extra_flags=("-lpthread",))
            lib = ctypes.CDLL(so_path)
            _declare(lib)
            BUILD_INFO.update(path=so_path,
                              seconds=time.perf_counter() - t0)
            _lib = lib
        except Exception as e:  # toolchain missing, build error, ...
            _lib_error = str(e)
            log.warning("native library unavailable (%s); "
                        "using Python fallbacks", e)
        return _lib


def is_available() -> bool:
    return get_library() is not None
