"""Step-level performance telemetry: the flight recorder, the step cost
(FLOPs and bytes), graph-capture counters and device gauges.

Counterpart of `cake_tpu/obs/steps.py`, with the same metric families
and record shape. Where JAX leans on XLA the port has its own:

  * **Step flight recorder** (`StepTelemetry`): one bounded-ring record
    per engine step (kind prefill / decode / decode_scan / mixed; a
    mixed record also splits occupancy into decode, prefill-chunk and
    idle rows and feeds `cake_mixed_step_rows_total{kind}`), with the
    attention impl, occupancy, tokens emitted, page-pool free/total,
    dispatch wall, device seconds, MFU / HBM utilization and whether
    the step captured a graph. Served at `GET /api/v1/steps`,
    optionally appended as JSONL (`--step-log`, obs/jsonl.py).

  * **The cost** (`step_cost`): JAX lowers each jitted step once and
    reads `cost_analysis()` (`lower_cost`); the port counts the FLOPs
    and bytes of a step from the model config and the step's rows
    (a deliberate divergence: an analytic count of the useful work, not
    the compiler's count of the whole program).

  * **"Compiles"** (`StepTelemetry.count_capture`): the port compiles
    no program per signature; its counterpart of a new jit signature is
    a CUDA-graph capture (one per `DecodeRunner` / `MixedRunner`
    variant, serve/graphs.py), counted under JAX's
    `cake_jit_compiles_total{fn}` and `cake_jit_compile_seconds` (a
    deliberate divergence in what the family counts).

  * **Device gauges** (`refresh_device_gauges`): the card's live, peak
    and limit bytes from `torch.cuda.memory_stats()`, refreshed at
    scrape time; no sample on the CPU.

MFU is model-FLOPs utilization: the step's counted FLOPs over the card's
peak rate times the step's device seconds (CUDA events around the
replays on the card, the wall on the CPU), clamped to 1.0 as in JAX
(the record keeps the unclamped ratio beside it, `mfu_raw`, unexported).
HBM utilization is the counted bytes over the card's memory rate the
same way. On the CPU the peaks are relative figures, as in JAX.

  * **Live profile capture** (`ProfileCapture`, behind
    `POST /api/v1/profile`): a single-flight torch.profiler capture of
    the next N seconds of the live process (utils/profiling.capture_trace),
    where JAX captures a jax.profiler trace.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from cake_tpu_torch.obs import metrics as _m
from cake_tpu_torch.obs.jsonl import JsonlAppender

log = logging.getLogger(__name__)

# Peak dense bf16 tensor-core FLOP/s and memory bytes/s by device-name
# substring (torch.cuda.get_device_name), first match wins: the figures
# chip_smoke.py's kernel bounds use (H100 SXM: 989 TFLOP/s bf16 dense,
# 3.35 TB/s HBM3). An unknown card gets the H100 figures; the CPU lane
# relative ones, as in JAX.
PEAK_FLOPS = [("h100", 989e12)]
HBM_BPS = [("h100", 3.35e12)]
DEFAULT_PEAK_FLOPS = 989e12
DEFAULT_HBM_BPS = 3.35e12
CPU_PEAK_FLOPS = 1e12
CPU_HBM_BPS = 100e9


def _is_cpu_kind(k: str) -> bool:
    return not k or "cpu" in k


def peak_flops_for(kind: str) -> float:
    k = (kind or "").lower()
    for sub, v in PEAK_FLOPS:
        if sub in k:
            return v
    return CPU_PEAK_FLOPS if _is_cpu_kind(k) else DEFAULT_PEAK_FLOPS


def hbm_bps_for(kind: str) -> float:
    k = (kind or "").lower()
    for sub, v in HBM_BPS:
        if sub in k:
            return v
    return CPU_HBM_BPS if _is_cpu_kind(k) else DEFAULT_HBM_BPS


def device_kind(device) -> str:
    """The name the peak tables key on: the card's name, or "cpu"."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


# -- metric families (module-level, as in JAX) --------------------------------

_STEPS_TOTAL = _m.counter(
    "cake_steps_total",
    "Engine steps recorded by the flight recorder, by step kind",
    labelnames=("kind",))
_STEP_DISPATCH = _m.histogram(
    "cake_step_dispatch_seconds",
    "Per-step dispatch wall seconds, by step kind",
    labelnames=("kind",))
_STEP_MFU = _m.gauge(
    "cake_step_mfu",
    "Last step's model-FLOPs utilization (counted FLOPs / peak card "
    "FLOPs x step device seconds), by step kind",
    labelnames=("kind",))
_STEP_HBM = _m.gauge(
    "cake_step_hbm_util",
    "Last step's HBM-bandwidth utilization (counted bytes / HBM "
    "bandwidth x step device seconds), by step kind",
    labelnames=("kind",))
_JIT_COMPILES = _m.counter(
    "cake_jit_compiles_total",
    "CUDA-graph captures per engine step (one per runner variant; a "
    "rise during steady-state decode is a capture storm)",
    labelnames=("fn",))
_JIT_COMPILE_SECONDS = _m.histogram(
    "cake_jit_compile_seconds",
    "Wall seconds of the warm-up and capture of each CUDA graph")
_DEV_HBM_IN_USE = _m.gauge(
    "cake_device_hbm_bytes_in_use",
    "Live HBM bytes per device (torch.cuda.memory_stats; absent on CPU)",
    labelnames=("device",))
_DEV_HBM_PEAK = _m.gauge(
    "cake_device_hbm_peak_bytes",
    "Peak HBM bytes per device since process start",
    labelnames=("device",))
_DEV_HBM_LIMIT = _m.gauge(
    "cake_device_hbm_bytes_limit",
    "HBM byte capacity per device",
    labelnames=("device",))
_MIXED_ROWS = _m.counter(
    "cake_mixed_step_rows_total",
    "Row-slots processed by mixed continuous-batching steps, by row "
    "kind (decode = one-token decode rows, prefill = prefill-chunk "
    "rows, idle = empty slots in the launch)",
    labelnames=("kind",))


def refresh_page_gauges(engine) -> None:
    """KV page-pool occupancy gauges of a paged engine and the KV tiers'
    gauges, read at scrape time (api/server.py); a no-op for the dense
    flavors."""
    if not getattr(engine, "paged", False):
        return
    try:
        # the pager is engine-thread state swapped wholesale by a live
        # reconfigure; its declared lock (_admit_lock) pins one
        # consistent pool for this scrape. NON-blocking on purpose: the
        # watchdog and /metrics run through here, and a switch holding
        # the lock through its rebuild must never stall the stall
        # detector (or observability): on contention the gauges keep
        # their last values for one scrape.
        if engine._admit_lock.acquire(blocking=False):
            try:
                n_total = engine.cache.n_pages
                # cakelint: skip[affinity] _admit_lock held via the non-blocking acquire above (the with-form the checker recognizes would block behind a switch)
                n_free = engine._pager.free_pages
            finally:
                engine._admit_lock.release()
            _m.gauge("cake_engine_kv_pages_total",
                     "KV pages in the pool").set(n_total)
            _m.gauge("cake_engine_kv_pages_free",
                     "KV pages currently free").set(n_free)
        _m.gauge("cake_prefix_pages_shared",
                 "Shared prefix pages currently mapped into admitted "
                 "slots' table rows (pool pages saved vs unshared "
                 "admission)").set(
            getattr(engine, "_prefix_pages_shared", 0))
        # KV tiers (kv/host_tier.py owns the cake_kv_* gauges and their
        # refresh: the device pool's bytes, and the host tier's pages
        # and bytes when --kv-host-pages is set)
        from cake_tpu_torch.kv import host_tier as kv_host_tier
        kv_host_tier.refresh_gauges(engine.cache,
                                    getattr(engine, "_host_tier", None))
    except Exception:  # noqa: BLE001 — telemetry must never fail serving
        log.debug("page gauge refresh failed", exc_info=True)


def refresh_device_gauges() -> None:
    """Sync the per-device HBM gauges from torch.cuda.memory_stats().
    No-op without a card: the gauges stay sample-less."""
    try:
        from cake_tpu_torch.utils.profiling import device_memory_stats
        stats = device_memory_stats()
    except Exception:  # noqa: BLE001 — a scrape must never fail
        log.debug("device memory stats unavailable", exc_info=True)
        return
    for s in stats:
        if s.get("bytes_in_use") is None:
            continue
        dev = str(s["device"])
        _DEV_HBM_IN_USE.labels(device=dev).set(float(s["bytes_in_use"]))
        if s.get("peak_bytes_in_use") is not None:
            _DEV_HBM_PEAK.labels(device=dev).set(
                float(s["peak_bytes_in_use"]))
        if s.get("bytes_limit") is not None:
            _DEV_HBM_LIMIT.labels(device=dev).set(float(s["bytes_limit"]))


# -- the step cost --------------------------------------------------------------


@dataclass(frozen=True)
class CostInfo:
    """A step's counted FLOPs and bytes."""

    flops: float = 0.0
    bytes_accessed: float = 0.0


def matmul_weights_per_token(config) -> int:
    """Multiply-adds of the block products for one token: q, k, v, o,
    gate, up and down in every layer. A mixture-of-experts layer
    computes what ops/moe.moe_mlp computes: every expert's gate, up and
    down on every token (E x 3 x D x F) plus the router's D x E."""
    c = config
    D, H, KV, hd = (c.hidden_size, c.num_attention_heads,
                    c.num_key_value_heads, c.head_dim)
    ffn = 3 * D * c.intermediate_size
    if getattr(c, "is_moe", False):
        E = c.num_local_experts
        ffn = E * ffn + D * E
    return c.num_hidden_layers * (D * (H + 2 * KV) * hd + H * hd * D + ffn)


def step_cost(config, kind: str, rows: int, tokens: int,
              ctx_lens: Sequence[Tuple[int, int]], *, emit_rows: int,
              passes: int = 1, weight_bytes: int = 0,
              embed_row_bytes: int = 0,
              kv_bytes_per_token: float = 0.0,
              kv_span: Optional[int] = None) -> CostInfo:
    """FLOPs and bytes of one recorded step (`kind` as in the record;
    `rows` and `tokens` are the record's and go unread here, named so a
    call reads like the record it costs).

    ctx_lens: one (pos, n) pair per run of n query tokens a forward pass
    computes for a row starting at absolute position pos (a decode row
    (pos, 1); a burst one pair a row and replay; a chunk row its window
    (off, n); a one-slot prefill its prompt or window). Only real
    tokens count: the columns a mixed step pads each row to ([B, C])
    and a prefill's bucket padding are left out, as chip_smoke.py's
    mixed-step bound leaves them out. emit_rows: rows whose last token
    goes through the lm_head and is sampled. passes: forward passes
    the step makes (weights read once each: a decode_scan burst of n
    replays makes n, a group of one-slot prefills one a window).

      FLOPs = 2 x (block matmul weights) x sum(n)
              + 4 x H x hd x L x sum over tokens of its context
              + 2 x D x V x emit_rows
      bytes = passes x weight_bytes + sum(n) x embed_row_bytes
              + kv_bytes_per_token x sum(pos + n)

    weight_bytes: the weights a pass reads, at their stored size (int8
    and int4 leaves with their scales), the embedding left out (a pass
    gathers embed_row_bytes a token of it); kv_bytes_per_token: the
    pool's bytes a token at its stored size (scales included), each
    row's history read once and its new tokens written once.

    kv_span: the row length of the dense engine's cache (T, or a ring's
    W slots), whose steps attend a row's every slot under a mask
    whatever the position: a run (pos, n) then attends n x kv_span
    (query, key) pairs and reads kv_span positions of KV (its n new
    ones written on top). None: the paged pool's counts above."""
    c = config
    n_tok = sum(n for _, n in ctx_lens)
    if kv_span is None:
        # a token at position p attends p + 1 keys: a run (pos, n)
        # attends n * pos + n (n + 1) / 2 (query, key) pairs
        pairs = sum(n * p + n * (n + 1) // 2 for p, n in ctx_lens)
        kv_tokens = sum(p + n for p, n in ctx_lens)
    else:
        pairs = sum(n * kv_span for _, n in ctx_lens)
        kv_tokens = sum(kv_span + n for _, n in ctx_lens)
    flops = (2 * matmul_weights_per_token(c) * n_tok
             + 4 * c.num_attention_heads * c.head_dim
             * c.num_hidden_layers * pairs
             + 2 * c.hidden_size * c.vocab_size * emit_rows)
    nbytes = (passes * weight_bytes + n_tok * embed_row_bytes
              + kv_bytes_per_token * kv_tokens)
    return CostInfo(flops=float(flops), bytes_accessed=float(nbytes))


# -- flight recorder ----------------------------------------------------------

# step kinds whose records carry decode throughput (utilization
# aggregation weights these; prefill is reported per-kind only)
_DECODE_KINDS = ("decode", "decode_scan", "spec", "mixed")


def _sig(v: Optional[float], digits: int = 6) -> Optional[float]:
    """Round to significant digits (utilization exports: decimal-place
    rounding would collapse legitimately tiny values to 0.0)."""
    return float(f"%.{digits}g" % v) if v is not None else None


@dataclass
class StepRecord:
    """One engine step. dispatch_s is host wall to get the work onto
    the device; device_s the device time of its replays (CUDA events on
    the card, read at the fetch that already happens; the wall on the
    CPU); wall_s the whole step on the host."""

    step: int
    ts: float                      # wall-clock
    kind: str                      # prefill | decode | decode_scan | mixed
    impl: str                      # paged-auto | paged-kernel | ...
    rows: int                      # batch occupancy this step
    tokens: int                    # tokens emitted by this step
    dispatch_s: float
    device_s: float
    wall_s: float
    mfu: Optional[float] = None
    hbm_util: Optional[float] = None
    pages_free: Optional[int] = None
    pages_total: Optional[int] = None
    compiled: bool = False         # this step captured a graph
    rows_decode: Optional[int] = None
    rows_prefill: Optional[int] = None
    rows_idle: Optional[int] = None
    rids: Optional[Tuple[int, ...]] = None
    # the ratios before the clamp to 1.0 (not exported: a reading above
    # 1 is a wrong count or a wrong clock, which the clamp would hide)
    mfu_raw: Optional[float] = None
    hbm_raw: Optional[float] = None

    def to_dict(self) -> Dict:
        out = {
            "step": self.step,
            "ts": round(self.ts, 6),
            "kind": self.kind,
            "impl": self.impl,
            "rows": self.rows,
            "tokens": self.tokens,
            "dispatch_s": round(self.dispatch_s, 6),
            "device_s": round(self.device_s, 6),
            "wall_s": round(self.wall_s, 6),
            "mfu": _sig(self.mfu),
            "hbm_util": _sig(self.hbm_util),
            "compiled": self.compiled,
        }
        if self.pages_total is not None:
            out["pages_free"] = self.pages_free
            out["pages_total"] = self.pages_total
        if self.rows_decode is not None:
            out["rows_decode"] = self.rows_decode
            out["rows_prefill"] = self.rows_prefill
            out["rows_idle"] = self.rows_idle
        if self.rids is not None:
            out["rids"] = list(self.rids)
        return out


class StepTelemetry:
    """Per-engine step flight recorder and capture counter.

    capacity bounds the in-memory ring (GET /api/v1/steps); log_path
    additionally appends every record as one JSON line (--step-log).
    kind: the device's name for the peak tables (`device_kind`);
    peak_flops/hbm_bps override them (tests pin them for exact MFU
    math). events: an obs/events.EventBus or None (a capture publishes
    a "recompile" event, as a new jit signature does in JAX)."""

    # cakelint guards discipline: the JSONL appender and the event bus
    # are optional planes
    OPTIONAL_PLANES = ("_log", "_events")

    def __init__(self, *, impl: str = "paged", capacity: int = 512,
                 log_path: Optional[str] = None, kind: str = "",
                 peak_flops: Optional[float] = None,
                 hbm_bps: Optional[float] = None, events=None):
        self.impl = impl
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._next = 1
        self._log = JsonlAppender(log_path) if log_path else None
        self._peak = peak_flops if peak_flops is not None \
            else peak_flops_for(kind)
        self._bps = hbm_bps if hbm_bps is not None else hbm_bps_for(kind)
        self._events = events

    def rebind(self, *, impl: Optional[str] = None) -> None:
        """Re-tag this recorder after a live engine config switch
        (serve/engine.reconfigure): the ring and the --step-log appender
        survive, and the new config's records carry its attention impl.
        The JAX recorder also moves its jit accountant's key prefix; the
        port's captures are per runner, and a switch drops the runners,
        so nothing else can alias across configs."""
        if impl is not None:
            self.impl = impl

    # -- captures -----------------------------------------------------------

    def count_capture(self, fn_name: str, seconds: float) -> None:
        """One CUDA-graph capture of step `fn_name` (warm-up and capture
        took `seconds`): the counterpart of a new jit signature."""
        _JIT_COMPILES.labels(fn=fn_name).inc()
        _JIT_COMPILE_SECONDS.observe(seconds)
        if self._events is not None:
            self._events.publish("recompile", fn=fn_name, impl=self.impl)

    # -- recording ----------------------------------------------------------

    def record(self, kind: str, *, rows: int = 0, tokens: int = 0,
               dispatch_s: Optional[float] = None,
               device_s: Optional[float] = None,
               wall_s: Optional[float] = None,
               cost: Optional[CostInfo] = None,
               compiled: bool = False,
               pages_free: Optional[int] = None,
               pages_total: Optional[int] = None,
               rows_decode: Optional[int] = None,
               rows_prefill: Optional[int] = None,
               rows_idle: Optional[int] = None,
               rids: Optional[Sequence[int]] = None) -> StepRecord:
        """Append one step record; derives MFU / HBM utilization from
        `cost` and the step's device seconds. Any subset of the three
        timings may be given; missing ones fall back to the others."""
        wall = wall_s if wall_s is not None else (
            (dispatch_s or 0.0) + (device_s or 0.0))
        disp = dispatch_s if dispatch_s is not None else wall
        dev = device_s if device_s is not None else wall
        mfu = hbm = mfu_raw = hbm_raw = None
        if cost is not None and dev > 0:
            if cost.flops > 0 and self._peak > 0:
                mfu_raw = cost.flops / (self._peak * dev)
                mfu = min(1.0, mfu_raw)
            if cost.bytes_accessed > 0 and self._bps > 0:
                hbm_raw = cost.bytes_accessed / (self._bps * dev)
                hbm = min(1.0, hbm_raw)
        with self._lock:
            rec = StepRecord(
                step=self._next, ts=time.time(), kind=kind,
                impl=self.impl, rows=int(rows), tokens=int(tokens),
                dispatch_s=float(disp), device_s=float(dev),
                wall_s=float(wall), mfu=mfu, hbm_util=hbm,
                pages_free=pages_free, pages_total=pages_total,
                compiled=bool(compiled),
                rows_decode=rows_decode, rows_prefill=rows_prefill,
                rows_idle=rows_idle,
                rids=(tuple(int(r) for r in rids)
                      if rids is not None else None),
                mfu_raw=mfu_raw, hbm_raw=hbm_raw)
            self._next += 1
            self._ring.append(rec)
        _STEPS_TOTAL.labels(kind=kind).inc()
        _STEP_DISPATCH.labels(kind=kind).observe(disp)
        for k, v in (("decode", rows_decode), ("prefill", rows_prefill),
                     ("idle", rows_idle)):
            if v:
                _MIXED_ROWS.labels(kind=k).inc(v)
        if mfu is not None:
            _STEP_MFU.labels(kind=kind).set(_sig(mfu))
        if hbm is not None:
            _STEP_HBM.labels(kind=kind).set(_sig(hbm))
        if self._log is not None:
            self._log.append(rec.to_dict())
        return rec

    # -- export -------------------------------------------------------------

    def records(self) -> List[StepRecord]:
        """The ring's records, oldest first (the objects, raw ratios
        included)."""
        with self._lock:
            return list(self._ring)

    def dump(self, limit: Optional[int] = None) -> List[Dict]:
        """Records newest first (the GET /api/v1/steps body)."""
        with self._lock:
            recs = list(reversed(self._ring))
        if limit is not None:
            recs = recs[:max(0, int(limit))]
        return [r.to_dict() for r in recs]

    def records_for(self, rid: int) -> List[Dict]:
        """Ring records whose dispatched batch contained `rid`, oldest
        first — the per-request explain's step stream (bounded by the
        ring capacity, like every other dump)."""
        with self._lock:
            recs = [r for r in self._ring
                    if r.rids is not None and rid in r.rids]
        return [r.to_dict() for r in recs]

    def utilization(self, since_step: int = 0, *,
                    include_prefill: bool = False) -> Dict[str, float]:
        """Wall-time-weighted mean MFU / HBM utilization over the ring's
        decode-side records (decode / decode_scan / spec / mixed),
        leaving out records whose step captured a graph.
        include_prefill=True widens it to the phase-split prefill
        records too (the autotune signal gather: a mixed record folds
        its chunks' prefill work in, so the other loop must count the
        same work); since_step drops every record up to a warm-up
        boundary (a `summary()["recorded_steps"]` read then). 0.0 when
        no remaining record carried a cost."""
        kinds = _DECODE_KINDS + ("prefill",) if include_prefill \
            else _DECODE_KINDS
        with self._lock:
            recs = [r for r in self._ring
                    if r.kind in kinds and not r.compiled
                    and r.step > since_step]
        out = {"mfu": 0.0, "hbm_util": 0.0}
        for field in ("mfu", "hbm_util"):
            num = den = 0.0
            for r in recs:
                v = getattr(r, field)
                if v is not None and r.wall_s > 0:
                    num += v * r.wall_s
                    den += r.wall_s
            if den > 0:
                out[field] = _sig(num / den)
        return out

    def summary(self) -> Dict:
        """Aggregate view for /api/v1/steps: per-kind counts, tokens,
        mean dispatch seconds, capture counts, plus the decode-side
        utilization means."""
        with self._lock:
            recs = list(self._ring)
            recorded = self._next - 1
        kinds: Dict[str, Dict] = {}
        for r in recs:
            k = kinds.setdefault(r.kind, {
                "count": 0, "tokens": 0, "compiles": 0,
                "dispatch_s_sum": 0.0})
            k["count"] += 1
            k["tokens"] += r.tokens
            k["compiles"] += 1 if r.compiled else 0
            k["dispatch_s_sum"] += r.dispatch_s
        for k in kinds.values():
            k["mean_dispatch_s"] = round(
                k.pop("dispatch_s_sum") / k["count"], 6)
        return {
            "recorded_steps": recorded,
            "ring": len(recs),
            "impl": self.impl,
            "kinds": kinds,
            **self.utilization(),
        }

    def close(self) -> None:
        if self._log is not None:
            self._log.close()


# -- on-demand profiler capture ----------------------------------------------


class ProfileBusyError(RuntimeError):
    """A capture is already running (the single-flight guard). The API
    layer maps this to HTTP 409."""


class ProfileCapture:
    """Single-flight torch.profiler capture from a live process.

    The profiler supports one active session per process; a second
    concurrent capture would raise from inside it (or corrupt the first
    trace), so the guard rejects it up front with ProfileBusyError."""

    MAX_SECONDS = 120.0

    def __init__(self):
        self._lock = threading.Lock()

    @property
    def busy(self) -> bool:
        # advisory only (the real gate is the non-blocking acquire)
        return self._lock.locked()

    def capture(self, seconds: float, out_dir: Optional[str] = None,
                run=None) -> Dict:
        """One capture of the next `seconds` (utils/profiling.
        capture_trace; `run` places the profiler's start and stop)."""
        try:
            seconds = float(seconds)
        except (TypeError, ValueError):
            raise ValueError("seconds must be a number")
        if not (0 < seconds <= self.MAX_SECONDS):
            raise ValueError(
                f"seconds must be in (0, {self.MAX_SECONDS:.0f}]")
        if not self._lock.acquire(blocking=False):
            raise ProfileBusyError(
                "a profiler capture is already in progress")
        try:
            from cake_tpu_torch.utils.profiling import capture_trace
            return capture_trace(seconds, out_dir, run=run)
        finally:
            self._lock.release()


PROFILER = ProfileCapture()
