"""Per-request lifecycle tracing for the serving engine.

Counterpart of `cake_tpu/obs/tracing.py`, copied as it is.

Every request gets a `TraceRecord` with timestamped spans:

    admitted -> queued -> prefill -> first_token -> decode
                                                 -> retired | error | cancelled

and the derived latencies every capacity/regression question needs:
queue wait (admitted -> prefill), prefill seconds (prefill ->
first_token), TTFT (admitted -> first_token), per-token inter-arrival
stats, and e2e latency. Records live in a bounded ring (finished
requests; active ones are tracked until they finish) and are dumped by
`GET /api/v1/requests`. With an events path set (`--trace-events`),
every span is also appended as one JSON line — the replayable audit log
for offline analysis.

The tracer also feeds the metrics registry: finishing a request
observes the TTFT / e2e / queue-wait / prefill histograms and the
per-status request counter, so `/api/v1/metrics` latency distributions
populate with zero extra wiring in the engine. Tracer methods never
raise into the engine loop — a broken events file degrades to a logged
warning, not a failed generation.

The port's paged engine calls the tracer at its submit, admission,
first-token, emit, preemption, requeue and retire seams.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from cake_tpu_torch.obs import metrics as _m
from cake_tpu_torch.obs.jsonl import JsonlAppender

log = logging.getLogger(__name__)

# terminal statuses a record can finish with
TERMINAL = ("retired", "error", "cancelled")

REQUEST_TTFT = _m.histogram(
    "cake_request_ttft_seconds",
    "Time from admission to first generated token (includes queue wait)")
REQUEST_E2E = _m.histogram(
    "cake_request_e2e_seconds",
    "Time from admission to request retirement")
REQUEST_QUEUE_WAIT = _m.histogram(
    "cake_request_queue_wait_seconds",
    "Time from admission until a decode slot started prefilling")
REQUEST_PREFILL = _m.histogram(
    "cake_request_prefill_seconds",
    "Time from prefill dispatch to the first generated token")
REQUEST_INTER_TOKEN = _m.histogram(
    "cake_request_inter_token_seconds",
    "Gap between consecutive generated tokens of one request",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5, 5.0))
REQUESTS_FINISHED = _m.counter(
    "cake_requests_finished_total",
    "Requests finished, by terminal status", labelnames=("status",))


@dataclass
class TraceRecord:
    """One request's lifecycle. Spans are (name, perf_counter ts);
    `wall_start` anchors them to wall-clock for export."""

    rid: int
    prompt_tokens: int = 0
    max_new_tokens: int = 0
    # admission class (cake_tpu/sched priority classes; "standard"
    # for engines without SLO scheduling)
    priority: str = "standard"
    spans: List[tuple] = field(default_factory=list)
    status: str = "active"
    error: Optional[str] = None
    output_tokens: int = 0
    # inter-token gap summary (seconds); full per-token lists would make
    # the ring's memory proportional to generated tokens
    itl_count: int = 0
    itl_sum: float = 0.0
    itl_max: float = 0.0
    # annotations (checkpoint resume, decode-budget truncation, ...)
    resumed: bool = False
    truncated: bool = False
    # engine config epoch at admission (cake_tpu/autotune): a live
    # config switch bumps the engine's epoch, so a trace whose spans
    # include a "reconfigured" event is attributable to both configs —
    # admitted under this epoch, finished under a later one
    config_epoch: int = 0
    # the originating distributed-trace id (x-cake-trace, minted by a
    # front-door router or a client), the key the router's federated
    # timeline correlates this record under; None without trace context
    trace: Optional[str] = None
    wall_start: float = 0.0
    _last_token_t: float = 0.0

    def _t(self, name: str) -> Optional[float]:
        for n, t in self.spans:
            if n == name:
                return t
        return None

    def _t_last(self, name: str) -> Optional[float]:
        t = None
        for n, ts in self.spans:
            if n == name:
                t = ts
        return t

    @property
    def queue_wait_s(self) -> Optional[float]:
        a, p = self._t("admitted"), self._t_last("prefill")
        return (p - a) if a is not None and p is not None else None

    @property
    def prefill_s(self) -> Optional[float]:
        p, f = self._t_last("prefill"), self._t("first_token")
        return (f - p) if p is not None and f is not None else None

    @property
    def ttft_s(self) -> Optional[float]:
        a, f = self._t("admitted"), self._t("first_token")
        return (f - a) if a is not None and f is not None else None

    @property
    def e2e_s(self) -> Optional[float]:
        a = self._t("admitted")
        end = self._t(self.status) if self.status in TERMINAL else None
        return (end - a) if a is not None and end is not None else None

    def to_dict(self) -> Dict:
        t0 = self.spans[0][1] if self.spans else 0.0
        out = {
            "rid": self.rid,
            "status": self.status,
            "priority": self.priority,
            "config_epoch": self.config_epoch,
            "prompt_tokens": self.prompt_tokens,
            "max_new_tokens": self.max_new_tokens,
            "output_tokens": self.output_tokens,
            "submitted_at": round(self.wall_start, 6),
            "spans": [
                {"name": n, "t": round(self.wall_start + (ts - t0), 6),
                 "offset_s": round(ts - t0, 6)}
                for n, ts in self.spans
            ],
            "queue_wait_s": _r(self.queue_wait_s),
            "prefill_s": _r(self.prefill_s),
            "ttft_s": _r(self.ttft_s),
            "e2e_s": _r(self.e2e_s),
            "inter_token": {
                "count": self.itl_count,
                "mean_s": _r(self.itl_sum / self.itl_count
                             if self.itl_count else None),
                "max_s": _r(self.itl_max if self.itl_count else None),
            },
        }
        if self.error:
            out["error"] = self.error
        if self.resumed:
            out["resumed"] = True
        if self.truncated:
            out["truncated"] = True
        if self.trace:
            out["trace"] = self.trace
        return out


def _r(v: Optional[float]) -> Optional[float]:
    return round(v, 6) if v is not None else None


class RequestTracer:
    """Bounded-ring lifecycle recorder, safe from any thread.

    capacity bounds the FINISHED-record ring; active records are always
    retained (they are bounded by the engine's queue + slots). With
    `events_path`, each span appends one JSON line
    ``{"ts", "rid", "event", ...}`` through the shared obs/jsonl.py
    writer (append-only, lazily opened so a follower process that never
    serves requests never touches the file, fsync on close, fail-open
    on OSError; read it back with `obs.jsonl.read_jsonl`, which
    tolerates the torn tail a killed process leaves)."""

    # cakelint guards discipline: SLO accounting and the event bus are
    # optional attachments
    OPTIONAL_PLANES = ("_slo", "_events")

    def __init__(self, capacity: int = 256,
                 events_path: Optional[str] = None,
                 observe_metrics: bool = True,
                 slo=None):
        self._lock = threading.Lock()
        self._active: Dict[int, TraceRecord] = {}
        self._done: deque = deque(maxlen=max(1, int(capacity)))
        self._events = (JsonlAppender(events_path)
                        if events_path else None)
        self._observe = observe_metrics
        # obs/slo.SLOAccountant: finish() is THE retire seam every
        # path funnels through (normal emit, recovery's exhausted-
        # budget finish), so attainment/goodput accounting hooked here
        # sees each request exactly once, with latencies measured from
        # the ORIGINAL admission span (resubmits append spans to the
        # same record — the clock never resets on requeue)
        self._slo = slo

    # -- lifecycle hooks (called by the engine) ---------------------------

    def admit(self, rid: int, prompt_tokens: int,
              max_new_tokens: int, priority: str = "standard",
              config_epoch: int = 0, trace: Optional[str] = None) -> None:
        now = time.perf_counter()
        rec = TraceRecord(rid=rid, prompt_tokens=prompt_tokens,
                          max_new_tokens=max_new_tokens,
                          priority=priority,
                          config_epoch=config_epoch, trace=trace,
                          wall_start=time.time())
        rec.spans.append(("admitted", now))
        rec.spans.append(("queued", now))
        with self._lock:
            self._active[rid] = rec
        self._event(rec, "admitted", prompt_tokens=prompt_tokens,
                    max_new_tokens=max_new_tokens, priority=priority)

    def drop(self, rid: int) -> None:
        """Un-admit a request whose submission was rejected (queue
        full): remove the active record without retiring it into the
        ring — it never entered the engine."""
        with self._lock:
            rec = self._active.pop(rid, None)
        if rec is not None:
            self._event(rec, "rejected")

    def span(self, rid: int, name: str, **fields) -> None:
        now = time.perf_counter()
        with self._lock:
            rec = self._active.get(rid)
            if rec is None:
                return
            rec.spans.append((name, now))
        self._event(rec, name, **fields)

    def prefill_start(self, rid: int) -> None:
        self.span(rid, "prefill")

    def first_token(self, rid: int) -> None:
        now = time.perf_counter()
        with self._lock:
            rec = self._active.get(rid)
            if rec is None:
                return
            rec.spans.append(("first_token", now))
            rec.spans.append(("decode", now))
            rec.output_tokens = 1
            rec._last_token_t = now
        self._event(rec, "first_token", ttft_s=_r(rec.ttft_s))

    def token(self, rid: int) -> None:
        """Per-token inter-arrival accounting (tokens after the first).
        Summary-only on the record; the distribution goes to the
        inter-token histogram."""
        now = time.perf_counter()
        gap = None
        with self._lock:
            rec = self._active.get(rid)
            if rec is None:
                return
            if rec._last_token_t:
                gap = now - rec._last_token_t
                rec.itl_count += 1
                rec.itl_sum += gap
                rec.itl_max = max(rec.itl_max, gap)
            rec._last_token_t = now
            rec.output_tokens += 1
        if gap is not None and self._observe:
            REQUEST_INTER_TOKEN.observe(gap)

    def finish(self, rid: int, status: str = "retired",
               error: Optional[str] = None,
               output_tokens: Optional[int] = None) -> None:
        """Move a request to the finished ring (idempotent: only the
        first terminal transition records)."""
        if status not in TERMINAL:
            raise ValueError(f"not a terminal status: {status!r}")
        now = time.perf_counter()
        with self._lock:
            rec = self._active.pop(rid, None)
            if rec is None:
                return
            rec.status = status
            rec.error = error
            if output_tokens is not None:
                rec.output_tokens = output_tokens
            rec.spans.append((status, now))
            self._done.append(rec)
        if self._observe:
            REQUESTS_FINISHED.labels(status=status).inc()
            if status == "retired":
                for h, v in ((REQUEST_TTFT, rec.ttft_s),
                             (REQUEST_E2E, rec.e2e_s),
                             (REQUEST_QUEUE_WAIT, rec.queue_wait_s),
                             (REQUEST_PREFILL, rec.prefill_s)):
                    if v is not None:
                        h.observe(v)
        if self._slo is not None and status != "cancelled":
            # cancelled = the client went away; the server attained
            # nothing and missed nothing. Errors are unconditional
            # misses (slo="failed").
            self._slo.observe(rec.priority, rec.ttft_s, rec.e2e_s,
                              rec.output_tokens,
                              failed=(status == "error"))
        self._event(rec, status, error=error,
                    output_tokens=rec.output_tokens, e2e_s=_r(rec.e2e_s),
                    queue_wait_s=_r(rec.queue_wait_s))

    def annotate(self, rid: int, **fields) -> None:
        """Attach flags to a live record (resumed / truncated / ...).
        Unknown keys are ignored rather than raised: annotation is
        best-effort metadata, never control flow."""
        with self._lock:
            rec = self._active.get(rid)
            if rec is None:
                # the request may have retired between submit and this
                # call: annotate the ring record
                rec = next((r for r in self._done if r.rid == rid), None)
            if rec is None:
                return
            for k, v in fields.items():
                if hasattr(rec, k) and not k.startswith("_"):
                    setattr(rec, k, v)

    # -- export -----------------------------------------------------------

    def dump(self, limit: Optional[int] = None,
             rid: Optional[int] = None,
             cls: Optional[str] = None,
             since: Optional[int] = None) -> List[Dict]:
        """All records, newest first: active requests, then the finished
        ring. Filters compose (GET /api/v1/requests): rid= exact,
        cls= priority class, since= strictly-greater rid — rids are
        monotonic per engine, so `since=<response cursor>` is a cursor
        that reads only requests admitted after the previous poll.
        With since= the order flips to OLDEST-first and limit= keeps
        the first n (the page right after the cursor — newest-first
        truncation would skip the older records forever); without it,
        newest-first is the natural dashboard view."""
        with self._lock:
            recs = (sorted(self._active.values(),
                           key=lambda r: r.rid, reverse=True)
                    + list(reversed(self._done)))
        if rid is not None:
            recs = [r for r in recs if r.rid == rid]
        if cls is not None:
            recs = [r for r in recs if r.priority == cls]
        if since is not None:
            recs = sorted((r for r in recs if r.rid > since),
                          key=lambda r: r.rid)
        if limit is not None:
            recs = recs[:max(0, int(limit))]
        return [r.to_dict() for r in recs]

    def _find(self, rid: int) -> Optional[TraceRecord]:
        """The record of `rid`, active or finished (caller holds the
        lock)."""
        rec = self._active.get(rid)
        if rec is None:
            rec = next((r for r in self._done if r.rid == rid), None)
        return rec

    def get(self, rid: int) -> Optional[Dict]:
        """One record by rid (active or finished), or None — the
        timeline endpoint's lookup."""
        with self._lock:
            rec = self._find(rid)
            return rec.to_dict() if rec is not None else None

    def trace_for(self, rid: int) -> Optional[str]:
        """The distributed-trace id the request was admitted under, or
        None — the event bus's per-publish annotation resolver."""
        with self._lock:
            rec = self._find(rid)
            return rec.trace if rec is not None else None

    def recent_ttfts(self, n: int = 32) -> List[float]:
        """TTFT seconds of the newest <= n finished-and-retired requests
        (the autotune controller's arrival-latency signal: one pass over
        the bounded ring's tail)."""
        out: List[float] = []
        with self._lock:
            recs = list(self._done)[-max(1, int(n)):]
        for r in recs:
            if r.status == "retired" and r.ttft_s is not None:
                out.append(r.ttft_s)
        return out

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def close(self) -> None:
        if self._events is not None:
            self._events.close()

    # -- JSONL event log ---------------------------------------------------

    def _event(self, rec: TraceRecord, event: str, **fields) -> None:
        if self._events is None:
            return
        line = {"ts": round(time.time(), 6), "rid": rec.rid,
                "event": event}
        if rec.trace:
            line["trace"] = rec.trace
        line.update({k: v for k, v in fields.items() if v is not None})
        self._events.append(line)
