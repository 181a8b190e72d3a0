"""What the port takes of `cake_tpu/utils/profiling.py`: the profiler
trace around a one-shot generation (`trace`, a torch.profiler capture
written as a Chrome / Perfetto trace file where JAX writes its
jax.profiler trace), named spans in it (`annotate`, a
torch.profiler.record_function where JAX opens a TraceAnnotation), the
windowed step counter (`StepStats`), `human_bytes`, the device memory
stats behind the scrape-time HBM gauges (from `torch.cuda.memory_stats()`)
and the lifecycle memory log (`log_memory`, at "model loaded" and
"engine start"), and the live capture behind `POST /api/v1/profile`
(`capture_trace`: a torch.profiler session over the next N seconds of
whatever the process is doing)."""

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


def annotate(name: str):
    """Named span visible in the profile (the host's timeline, and the
    card's kernels launched inside it): a torch.profiler
    record_function, a context manager and decorator like JAX's
    TraceAnnotation. Costs next to nothing while no profiler runs."""
    import torch
    return torch.profiler.record_function(name)


def capture_trace(seconds: float, out_dir: Optional[str] = None,
                  run=None) -> dict:
    """Profile the NEXT `seconds` of the live process (the POST
    /api/v1/profile backend, obs/steps.ProfileCapture): unlike `trace`,
    which wraps a block the caller controls, this records whatever the
    process runs meanwhile (a serving engine's replays on its own
    thread: the card's kernels are CUPTI's, whichever thread launched
    them), then writes a Chrome trace.

    out_dir: the capture directory (created if missing); None makes a
    fresh temporary one a capture. run: where the profiler starts and
    stops (run(fn) returns fn()): a serving engine passes its
    `_run_on_engine_thread`, because stopping the profiler while another
    thread launches a CUDA graph can deadlock the two; None: here.
    Returns {"dir", "trace", "seconds"}: the trace file's path and the
    wall seconds captured."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    d = out_dir or tempfile.mkdtemp(prefix="cake-profile-")
    os.makedirs(d, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    path = os.path.join(
        d, f"trace.{os.getpid()}.{int(time.time() * 1e3)}.json")
    run = run or (lambda fn: fn())
    prof = profile(activities=acts)
    t0 = time.perf_counter()
    run(prof.start)
    try:
        time.sleep(seconds)
    finally:
        run(prof.stop)
    captured = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    log.info("profiler capture: %.2fs -> %s", captured, path)
    return {"dir": d, "trace": path, "seconds": round(captured, 3)}


def warm_profiler() -> float:
    """Start and stop an empty torch.profiler session with the card's
    activities on the calling thread, and return its seconds. The
    profiler's first start in a process initializes CUPTI (seconds on a
    card) and its client on the starting thread; a serving process that
    will capture from its HTTP handlers pays that once, at startup, on
    the thread that imported torch (`api/server.start` with
    --profile-dir)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=acts):
        pass
    dt = time.perf_counter() - t0
    log.info("profiler warmed in %.2fs", dt)
    return dt


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


def log_memory(tag: str) -> None:
    """Log each card's allocated, reserved and peak allocated memory at a
    lifecycle point (cake/mod.rs:65-71), from torch.cuda.memory_stats;
    nothing without a card (the CPU has no such stats), and nothing in a
    process that has not touched CUDA (a --cpu run on a machine with a
    card: reading the stats would create a context on every card)."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        log.info("[%s] cuda:%d: %s allocated (peak %s), %s reserved",
                 tag, i,
                 human_bytes(stats.get("allocated_bytes.all.current", 0)),
                 human_bytes(stats.get("allocated_bytes.all.peak", 0)),
                 human_bytes(stats.get("reserved_bytes.all.current", 0)))


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
