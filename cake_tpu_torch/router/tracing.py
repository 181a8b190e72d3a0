"""Router-side distributed tracing: per-request hop records.

The front door is where a request's end-to-end story STARTS — admit,
replica pick (with the affinity verdict), proxy connect, first byte,
failover resume, retire — yet it was the one tier with no
request-linked telemetry. This module is the router's counterpart of
obs/tracing.py: a bounded ring of `HopRecord`s keyed by the
``x-cake-trace`` id the router mints (or propagates), each holding
wall-clock hop spans and the per-replica attempt list.

Contracts:

  * spans carry WALL-CLOCK timestamps directly (no perf_counter
    anchoring): the federated timeline merges them with clock-offset-
    corrected replica spans by plain sort;
  * a trace REACTIVATES on a keyed reconnect (`begin` with a known
    trace id appends to the same record, pulling it back out of the
    finished ring if needed) — a failover-resumed stream is ONE story
    across two replicas, not two records;
  * `find_by_rid` resolves a replica-local rid to its trace record
    through the attempt list — the router's
    ``GET /api/v1/requests/{rid}/timeline`` lookup;
  * rolling first-byte-latency and pick-outcome samples feed the
    sentinel's router detectors (obs/sentinel.attach_router_sentinel)
    with zero extra instrumentation;
  * with an events path set (``--trace-events`` on the router role),
    every span appends as one JSON line through the shared
    obs/jsonl.py writer, exactly like the engine tracer's audit log.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from cake_tpu_torch.obs import metrics as _m
from cake_tpu_torch.obs.jsonl import JsonlAppender

# terminal hop statuses (ok/retire = relay completed; relayed = a
# non-200 relayed verbatim; midstream = the stream broke after bytes
# reached the client; shed = the router could not place the request)
HOP_TERMINAL = ("retire", "relayed", "midstream", "shed", "error")

_HOP_FIRST_BYTE = _m.histogram(
    "cake_router_hop_first_byte_seconds",
    "Router-observed pick-to-first-byte latency per traced hop "
    "(router/tracing.py; the replica dimension rides the hop records "
    "served at GET /api/v1/requests/{rid}/timeline, never a label)")


@dataclass
class HopRecord:
    """One trace's router-side story. attempts: one row per replica
    pick (`{"replica", "outcome", "rid": int|None}`; rid filled when
    that replica admitted)."""

    trace: str
    cls: str = "standard"
    stream: bool = False
    hop: int = 1
    status: str = "active"
    wall_start: float = 0.0
    spans: List[Dict] = field(default_factory=list)
    attempts: List[Dict] = field(default_factory=list)

    def to_dict(self) -> Dict:
        return {
            "trace": self.trace,
            "class": self.cls,
            "stream": self.stream,
            "hop": self.hop,
            "status": self.status,
            "submitted_at": round(self.wall_start, 6),
            "spans": [dict(sp) for sp in self.spans],
            "attempts": [dict(a) for a in self.attempts],
        }


class HopTracer:
    """Bounded-ring hop recorder, safe from the router's handler
    threads. capacity bounds the FINISHED ring; active records are
    bounded by in-flight client connections."""

    # cakelint guards discipline: the JSONL appender is optional
    OPTIONAL_PLANES = ("_events",)

    def __init__(self, capacity: int = 256,
                 events_path: Optional[str] = None,
                 wall=time.time, mono=time.monotonic):
        self._lock = threading.Lock()
        self._active: Dict[str, HopRecord] = {}
        self._done: deque = deque(maxlen=max(1, int(capacity)))
        self._events = (JsonlAppender(events_path)
                        if events_path else None)
        self._wall = wall
        self._mono = mono
        # rolling sentinel feeds: (mono_t, replica, first-byte seconds)
        # and (mono_t, affinity outcome) — bounded, appended at the
        # span sites below, windowed by the router detectors
        self._ttfts: deque = deque(maxlen=2048)
        self._outcomes: deque = deque(maxlen=4096)

    # -- lifecycle (handler threads) --------------------------------------

    def begin(self, trace: str, *, cls: str = "standard",
              stream: bool = False, hop: int = 1) -> HopRecord:
        """Open (or REACTIVATE) the trace's record and span its
        admission at this tier. A keyed reconnect reuses its original
        trace id (the sticky map remembers it), so the resumed leg
        appends to the same story."""
        now = self._wall()
        with self._lock:
            rec = self._active.get(trace)
            if rec is None:
                rec = next((r for r in self._done if r.trace == trace),
                           None)
                if rec is not None:
                    # reactivation: pull the finished record back — the
                    # failover-resumed leg continues the same story
                    self._done.remove(rec)
                    rec.status = "active"
                    self._active[trace] = rec
            if rec is None:
                rec = HopRecord(trace=trace, cls=cls, stream=stream,
                                hop=hop, wall_start=now)
                self._active[trace] = rec
            rec.spans.append({"name": "admit", "t": now, "hop": hop})
        self._jsonl(rec, "admit", hop=hop, cls=cls)
        return rec

    def span(self, trace: str, name: str, **fields) -> None:
        now = self._wall()
        clean = {k: v for k, v in fields.items() if v is not None}
        with self._lock:
            rec = self._active.get(trace)
            if rec is None:
                return
            rec.spans.append({"name": name, "t": now, **clean})
            if name == "pick" and "outcome" in clean:
                self._outcomes.append((self._mono(), clean["outcome"]))
            if name == "first_byte" and "ttft_s" in clean \
                    and "replica" in clean:
                self._ttfts.append((self._mono(), clean["replica"],
                                    float(clean["ttft_s"])))
        if name == "first_byte" and "ttft_s" in clean:
            _HOP_FIRST_BYTE.observe(float(clean["ttft_s"]))
        self._jsonl(rec, name, **clean)

    def attempt(self, trace: str, replica: str, outcome: str) -> None:
        """Record one replica pick (the span rides along via span())."""
        with self._lock:
            rec = self._active.get(trace)
            if rec is None:
                return
            rec.attempts.append({"replica": replica, "outcome": outcome,
                                 "rid": None})

    def admitted(self, trace: str, replica: str,
                 rid: Optional[int]) -> None:
        """The replica 200'd: bind its echoed x-cake-rid to the
        newest attempt on that replica (the federated timeline's
        rid -> replica join key)."""
        now = self._wall()
        with self._lock:
            rec = self._active.get(trace)
            if rec is None:
                return
            for a in reversed(rec.attempts):
                if a["replica"] == replica:
                    a["rid"] = rid
                    break
            rec.spans.append({"name": "admitted", "t": now,
                              "replica": replica,
                              **({"rid": rid} if rid is not None
                                 else {})})
        self._jsonl(rec, "admitted", replica=replica, rid=rid)

    def finish(self, trace: str, status: str, **fields) -> None:
        """Terminal transition: span + move to the finished ring."""
        if status not in HOP_TERMINAL:
            raise ValueError(f"not a terminal hop status: {status!r}")
        now = self._wall()
        clean = {k: v for k, v in fields.items() if v is not None}
        with self._lock:
            rec = self._active.pop(trace, None)
            if rec is None:
                return
            rec.status = status
            rec.spans.append({"name": status, "t": now, **clean})
            self._done.append(rec)
        self._jsonl(rec, status, **clean)

    # -- export -----------------------------------------------------------

    def get(self, trace: str) -> Optional[Dict]:
        with self._lock:
            rec = self._active.get(trace)
            if rec is None:
                rec = next((r for r in self._done if r.trace == trace),
                           None)
            return rec.to_dict() if rec is not None else None

    def find_by_rid(self, rid: int) -> Optional[Dict]:
        """Newest record any of whose attempts admitted as `rid` on
        some replica — the /api/v1/requests/{rid}/timeline lookup.
        (rids are replica-LOCAL; collisions across replicas resolve
        newest-first, and the record names its replicas either way.)"""
        with self._lock:
            pools = (self._active.values(), reversed(self._done))
            newest = None
            for pool in pools:
                for rec in pool:
                    if any(a.get("rid") == rid for a in rec.attempts):
                        if newest is None or (rec.wall_start
                                              > newest.wall_start):
                            newest = rec
            return newest.to_dict() if newest is not None else None

    def dump(self, limit: Optional[int] = None) -> List[Dict]:
        """Records newest first: active, then the finished ring."""
        with self._lock:
            recs = (sorted(self._active.values(),
                           key=lambda r: r.wall_start, reverse=True)
                    + list(reversed(self._done)))
        if limit is not None:
            recs = recs[:max(0, int(limit))]
        return [r.to_dict() for r in recs]

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    # -- sentinel feeds ---------------------------------------------------

    def ttft_by_replica(self, window_s: float,
                        now: Optional[float] = None
                        ) -> Dict[str, List[float]]:
        """replica -> first-byte latencies observed inside the window
        (the replica-skew detector's input)."""
        now = self._mono() if now is None else now
        out: Dict[str, List[float]] = {}
        with self._lock:
            for t, rep, v in self._ttfts:
                if now - t <= window_s:
                    out.setdefault(rep, []).append(v)
        return out

    def outcome_counts(self, window_s: float,
                       now: Optional[float] = None) -> Dict[str, int]:
        """Affinity pick outcomes inside the window (hit / spill /
        sticky / none — the affinity-collapse detector's input)."""
        now = self._mono() if now is None else now
        out: Dict[str, int] = {}
        with self._lock:
            for t, outcome in self._outcomes:
                if now - t <= window_s:
                    out[outcome] = out.get(outcome, 0) + 1
        return out

    def close(self) -> None:
        if self._events is not None:
            self._events.close()

    # -- JSONL audit log --------------------------------------------------

    def _jsonl(self, rec: HopRecord, event: str, **fields) -> None:
        if self._events is None:
            return
        line = {"ts": round(self._wall(), 6), "trace": rec.trace,
                "event": event}
        line.update({k: v for k, v in fields.items() if v is not None})
        self._events.append(line)
