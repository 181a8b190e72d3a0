"""Build the port's CUDA sources into shared libraries at first use.

Each `csrc/*.cu` file has a plain C interface. nvcc compiles it for
sm_90a into `cake_tpu_torch/_build/lib<stem>_<hash>.so`, one library per
content of the source and the shared `csrc/*.cuh` headers (an edit
rebuilds, an unchanged tree is reused), and ctypes loads it.
`build_libraries` starts one nvcc per missing library, all at once, and
waits for them all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Callable, List, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", CSRC_DIR)

# source path -> {"seconds", "ptxas"} of this process's build; a library
# found already built records 0 seconds and no ptxas report
BUILD_INFO: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
            "port's CUDA kernels build from source at first use")
    return found


def library_path(source: str) -> str:
    """Where the library of `source`'s current content (and the shared
    headers') is built."""
    h = hashlib.sha256()
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    for path in [source] + [os.path.join(CSRC_DIR, n) for n in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build_libraries(sources: Sequence[str]) -> List[str]:
    """Compile every source whose library is missing, one nvcc process
    per source started together, and return the libraries' paths."""
    outs = [library_path(s) for s in sources]
    jobs = []
    for src, out in zip(sources, outs):
        if os.path.exists(out):
            BUILD_INFO.setdefault(src, dict(seconds=0.0, ptxas=""))
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, out, tmp, proc, time.perf_counter()))
    errors = []
    for src, out, tmp, proc, t0 in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed ({proc.returncode}) on {src}:\n{err}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent builder loads either
        BUILD_INFO[src] = dict(seconds=time.perf_counter() - t0, ptxas=err)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


class CudaLibrary:
    """One `csrc/` source, built and loaded with ctypes on first `get()`;
    `bind(lib)` declares the argument and result types of its exports."""

    def __init__(self, source_name: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = os.path.join(CSRC_DIR, source_name)
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build_libraries([self.source])[0])
                self._bind(lib)
                self._lib = lib
            return self._lib
