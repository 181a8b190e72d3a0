"""What the port takes of `cake_tpu/utils/profiling.py`: the profiler
trace around a one-shot generation (`trace`, a torch.profiler capture
written as a Chrome / Perfetto trace file where JAX writes its
jax.profiler trace), the windowed step counter (`StepStats`),
`human_bytes` and the device memory stats behind the scrape-time HBM
gauges (from `torch.cuda.memory_stats()`). The JAX module's live
capture (`capture_trace`) and its annotations are not ported yet."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

NUM_OPS_TO_STATS = 5


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile everything inside the block (None or "" = no-op): the
    host's ops, and the card's kernels when there is one, written on
    exit to `<log_dir>/trace.<pid>.<ms>.json`, a Chrome trace that
    ui.perfetto.dev and chrome://tracing open."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"trace.{os.getpid()}.{int(time.time() * 1e3)}.json")
    log.info("profiling to %s", log_dir)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
    log.info("profile written to %s", path)


def human_bytes(n: float) -> str:
    """1536 -> '1.5 KiB'."""
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TiB"


def device_memory_stats() -> List[Dict[str, object]]:
    """Per-card memory usage (live, peak and capacity bytes); empty
    without a card."""
    import torch
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return out


@dataclass
class StepStats:
    """Windowed per-step throughput counters.

    Call `step(bytes_in, bytes_out)` once per op; every `window` ops the
    moving-window ops/s + throughput is logged and returned.
    """

    name: str = "engine"
    window: int = NUM_OPS_TO_STATS
    ops: int = 0
    total_bytes_in: int = 0
    total_bytes_out: int = 0
    _win_start: float = field(default_factory=time.perf_counter)
    _win_bytes_in: int = 0
    _win_bytes_out: int = 0
    last_ops_per_s: float = 0.0

    def step(self, bytes_in: int = 0, bytes_out: int = 0) -> Optional[dict]:
        self.ops += 1
        self.total_bytes_in += bytes_in
        self.total_bytes_out += bytes_out
        self._win_bytes_in += bytes_in
        self._win_bytes_out += bytes_out
        if self.ops % self.window:
            return None
        now = time.perf_counter()
        dt = max(now - self._win_start, 1e-9)
        snap = {
            "ops_per_s": self.window / dt,
            "read_bytes_per_s": self._win_bytes_in / dt,
            "write_bytes_per_s": self._win_bytes_out / dt,
        }
        self.last_ops_per_s = snap["ops_per_s"]
        log.info(
            "%s: %.1f ops/s | read %s/s | write %s/s", self.name,
            snap["ops_per_s"], human_bytes(snap["read_bytes_per_s"]),
            human_bytes(snap["write_bytes_per_s"]),
        )
        self._win_start = now
        self._win_bytes_in = 0
        self._win_bytes_out = 0
        return snap
