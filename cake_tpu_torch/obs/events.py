"""Cross-subsystem event bus: typed, request-linked serving events.

Counterpart of `cake_tpu/obs/events.py`, copied as it is. A counter
says *how many* requests were preempted, never *which* ones; the bus is
the request-linked complement: every subsystem publishes one typed
event per incident, carrying the rid where one exists, into a bounded
thread-safe ring served at ``GET /api/v1/events`` (filterable by
``?rid= / ?type= / ?since=`` cursor) and optionally appended as JSONL
(``--event-log``, the shared obs/jsonl.py writer).

The vocabulary is the JAX package's whole closed set (an unknown type
raises at the publish site, because a misspelled type would silently
vanish from every ``?type=`` filter), so a ``?type=`` filter accepts
the same names on both servers. The port's engine publishes
``preempted``, ``prefix_hit``, ``shed``, and through the host KV tier
``kv_spill``, ``kv_restore`` and ``resident_spilled``, through recovery
``recovered``, ``poisoned`` and ``fault_injected``, ``recompile`` at a
graph capture, through paged speculative decoding ``spec_round`` and
``spec_degraded``, through a live switch ``reconfigured``, through the
sentinel ``anomaly``, through its action plane ``anomaly_action``, and
through disaggregated prefill/decode (kv/transfer.py and the engine's
seams) ``kv_shipped``, ``kv_adopted`` and ``kv_ship_degraded``; the
router (router/) publishes the rest on its own ring. Events published
with a rid carry the request's x-cake-trace (``trace_of``).

Cost discipline: publishers hold ``events = None`` when the bus is
disabled (``--event-ring 0``) and every call site guards ``if <bus> is
not None``. Metrics stay rid-free by design: the bus carries rids, the
``cake_events_total{type}`` counter carries only the type.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from cake_tpu_torch.obs import metrics as _m
from cake_tpu_torch.obs.jsonl import JsonlAppender

# the typed vocabulary — every publisher names one of these. The
# router-tier types (cake_tpu/router: the front-door process publishes
# into its OWN bus instance) and the sentinel's "anomaly"
# (obs/sentinel.py) share the vocabulary so ?type= filters and the
# timeline cause summary treat every tier identically; router events
# carry a `trace` field (the x-cake-trace id) instead of a rid — the
# router never knows the replica-local rid until admission.
EVENT_TYPES = (
    "preempted", "kv_spill", "kv_restore", "prefix_hit", "recovered",
    "poisoned", "reconfigured", "shed", "fault_injected", "recompile",
    # decode-resident spill under pool oversubscription
    # (serve/engine._spill_resident_stream)
    "resident_spilled",
    # router tier (cake_tpu/router/server.py)
    "affinity_miss", "spill_to_secondary", "failover_resume",
    "shed_by_router",
    # regression sentinel (obs/sentinel.py): fired/cleared transitions
    "anomaly",
    # closed-loop action plane (obs/actions.py): one typed audit event
    # per action taken (or declined) in response to an anomaly
    "anomaly_action",
    # fleet discovery (cake_tpu/router/discovery.py): replica
    # membership churn at the front door — a replica's first announce
    # frame registered it (replica_joined), its departure notice began
    # the drain-then-forget sequence (replica_departed), or its
    # announce stream went quiet and placement fell back to the poll
    # path (replica_stale)
    "replica_joined", "replica_departed", "replica_stale",
    # disaggregated prefill/decode (cake_tpu/kv/transfer.py): a
    # prefill host shipped a prefix's pool pages (kv_shipped), the
    # decode host adopted them into its own pool (kv_adopted), or the
    # shipment failed/expired and the request degraded to whole-prompt
    # prefill on the decode host (kv_ship_degraded)
    "kv_shipped", "kv_adopted", "kv_ship_degraded",
    # paged speculative decoding (cake_tpu/spec): one batched
    # draft+verify round's aggregate acceptance (spec_round, rid-less;
    # fault=True marks an injected spec.verify round), and the degrade
    # actions of the closed loop (spec_degraded: action="disabled"
    # carries the stream's rid + reason, action="shrink_gamma" is the
    # engine-wide tuner move)
    "spec_round", "spec_degraded",
)

EVENTS_TOTAL = _m.counter(
    "cake_events_total",
    "Serving events published on the cross-subsystem event bus, by "
    "event type (obs/events.py; rids ride the events themselves, "
    "never a metric label)",
    labelnames=("type",))
EVENTS_DROPPED = _m.counter(
    "cake_events_dropped_total",
    "Events evicted from the bounded in-memory event ring before being "
    "read (raise --event-ring, or attach --event-log for a lossless "
    "JSONL sink)")


@dataclass
class Event:
    """One published event. ``seq`` is the ring-wide monotonic cursor
    (GET /api/v1/events?since= pagination); ``ts`` is wall-clock so
    the timeline stitcher can merge events with tracer spans."""

    seq: int
    ts: float
    type: str
    rid: Optional[int] = None
    fields: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        out = {"seq": self.seq, "ts": round(self.ts, 6),
               "type": self.type}
        if self.rid is not None:
            out["rid"] = self.rid
        out.update(self.fields)
        return out


class EventBus:
    """Bounded, thread-safe ring of typed request-linked events.

    capacity bounds the in-memory ring (evictions count into
    cake_events_dropped_total); log_path additionally appends every
    event as one JSON line through the shared obs/jsonl.py writer
    (lazily opened, fsync on close, fail-open on OSError — a broken
    log file degrades to a logged warning, never a failed publish)."""

    # cakelint guards discipline: the JSONL appender and the trace-id
    # resolver are both optional attachments
    OPTIONAL_PLANES = ("_log", "trace_of")

    def __init__(self, capacity: int = 1024,
                 log_path: Optional[str] = None,
                 observe_metrics: bool = True):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._next_seq = 1
        self._log = JsonlAppender(log_path) if log_path else None
        self._observe = observe_metrics
        # an optional rid -> trace-id resolver (RequestTracer.trace_for):
        # behind a front-door router, events published with a rid carry
        # the originating x-cake-trace, so the router's federated
        # timeline selects them without knowing the replica's rids
        self.trace_of = None

    def publish(self, type: str, rid: Optional[int] = None,
                **fields) -> Event:
        """Append one event. Unknown types raise ValueError — a typo'd
        type would silently vanish from every ?type= filter, so the
        vocabulary is closed. None-valued fields are dropped (callers
        pass optional context unconditionally)."""
        if type not in EVENT_TYPES:
            raise ValueError(
                f"unknown event type {type!r} (obs/events.EVENT_TYPES)")
        ev = Event(seq=0, ts=time.time(), type=type,
                   rid=int(rid) if rid is not None else None,
                   fields={k: v for k, v in fields.items()
                           if v is not None})
        if (rid is not None and self.trace_of is not None
                and "trace" not in ev.fields):
            t = self.trace_of(int(rid))
            if t:
                ev.fields["trace"] = t
        with self._lock:
            ev.seq = self._next_seq
            self._next_seq += 1
            dropped = len(self._ring) == self._ring.maxlen
            self._ring.append(ev)
        if self._observe:
            EVENTS_TOTAL.labels(type=type).inc()
            if dropped:
                EVENTS_DROPPED.inc()
        if self._log is not None:
            self._log.append(ev.to_dict())
        return ev

    # -- export -----------------------------------------------------------

    def dump(self, rid: Optional[int] = None,
             type: Optional[str] = None,
             since: Optional[int] = None,
             limit: Optional[int] = None) -> List[Dict]:
        """Events in publish order (ascending seq); see snapshot()."""
        return self.snapshot(rid=rid, type=type, since=since,
                             limit=limit)[0]

    def snapshot(self, rid: Optional[int] = None,
                 type: Optional[str] = None,
                 since: Optional[int] = None,
                 limit: Optional[int] = None):
        """(events, cursor) in publish order (ascending seq). Filters
        compose: rid= exact, type= exact, since= strictly-greater seq.
        limit= keeps the FIRST n matches — the page right after
        `since`; keeping the newest would make a limited cursor poll
        skip the truncated older events forever. The cursor is safe to
        pass back as `since`: the last RETURNED seq when the page was
        truncated, else the ring's newest seq AT THE SNAPSHOT (events
        published after the snapshot stay strictly above it — nothing
        is ever skipped)."""
        with self._lock:
            evs = list(self._ring)
            snap_cursor = self._next_seq - 1
        out = []
        for ev in evs:
            if rid is not None and ev.rid != rid:
                continue
            if type is not None and ev.type != type:
                continue
            if since is not None and ev.seq <= since:
                continue
            out.append(ev.to_dict())
        truncated = limit is not None and len(out) > max(0, int(limit))
        if limit is not None:
            out = out[:max(0, int(limit))]
        if not truncated:
            cursor = snap_cursor
        elif out:
            cursor = out[-1]["seq"]
        else:                      # limit=0: no progress was made
            cursor = since if since is not None else 0
        return out, cursor

    @property
    def cursor(self) -> int:
        """Highest seq published so far (0 = nothing yet)."""
        with self._lock:
            return self._next_seq - 1

    def close(self) -> None:
        if self._log is not None:
            self._log.close()
