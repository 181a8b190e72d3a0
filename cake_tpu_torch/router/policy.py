"""Routing policy: sticky idempotency keys -> prefix affinity with a
bounded-load spill -> least-loaded healthy.

Pick order for one request:

1. **Sticky idempotency key.** A retried `x-cake-idempotency-key`
   routes to the replica that first admitted it, so the attach
   semantics (never double-admit; Last-Event-ID exact-suffix resume)
   hold across the fleet. Only when that replica is EJECTED does the
   key fall through to re-admission elsewhere — a draining home still
   serves attaches (the key names existing work; `engine.submit`
   checks the key before the drain gate).
2. **Prefix affinity.** The consistent-hash target for the request's
   page-aligned prefix fingerprint — unless it is over the load
   watermark, in which case the request SPILLS to the next ring node
   (bounded load: a hot tenant saturating its home replica overflows
   deterministically instead of queueing behind itself) and the miss
   is recorded.
3. **Least-loaded** healthy, admitting replica (no fingerprint, or the
   whole ring is uneligible).

A request no replica can take raises NoReplicaError. Its retry-after,
when present, is a REPLICA-computed drain ETA — the router never
invents a Retry-After of its own (the honest-backpressure
contract).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional, Set

from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.router.affinity import HashRing
from cake_tpu_torch.router.replicas import ReplicaState, ReplicaTracker

_AFFINITY = obs_metrics.counter(
    "cake_router_affinity_total",
    "Routing decisions by affinity outcome: hit (ring target taken), "
    "spill (target over the load watermark or uneligible), sticky "
    "(idempotency-key home), none (no shareable prefix)",
    labelnames=("outcome",))
_FAILOVERS = obs_metrics.counter(
    "cake_router_failovers_total",
    "Requests re-routed away from their first-choice replica",
    labelnames=("reason",))


class NoReplicaError(Exception):
    """No replica can admit this request. retry_after_s, when not None,
    is a replica-computed drain ETA (propagated, never invented)."""

    def __init__(self, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class Decision:
    """One routing decision (also the router's JSONL decision-log
    record via to_json)."""

    __slots__ = ("replica", "outcome", "sticky", "spill_reason")

    def __init__(self, replica: str, outcome: str, sticky: bool,
                 spill_reason: Optional[str] = None):
        self.replica = replica
        self.outcome = outcome   # hit | spill | sticky | none
        self.sticky = sticky
        # why an affinity key did not land on its ring target:
        # "saturated" (the target is over the load watermark — the
        # bounded-load spill) or "uneligible" (ejected / draining /
        # excluded by this request's retry loop). None on hit/sticky/
        # keyless picks. Feeds the router event ring's affinity_miss /
        # spill_to_secondary causes.
        self.spill_reason = spill_reason

    def to_json(self) -> dict:
        out = {"replica": self.replica, "outcome": self.outcome,
               "sticky": self.sticky}
        if self.spill_reason is not None:
            out["spill_reason"] = self.spill_reason
        return out


class RoutingPolicy:
    """Pure pick logic over a ReplicaTracker + HashRing; thread-safe
    (HTTP handler threads route concurrently)."""

    def __init__(self, tracker: ReplicaTracker,
                 ring: Optional[HashRing] = None,
                 load_watermark: int = 8,
                 mode: str = "affinity",
                 sticky_cap: int = 4096):
        if mode not in ("affinity", "round_robin"):
            raise ValueError(f"unknown router policy mode {mode!r} "
                             "(choose affinity or round_robin)")
        if load_watermark < 1:
            raise ValueError(
                f"load_watermark {load_watermark} must be >= 1")
        self.tracker = tracker
        self.ring = ring if ring is not None else HashRing(
            tracker.names())
        self.load_watermark = load_watermark
        self.mode = mode
        self._mu = threading.Lock()
        # bounded key -> home-replica map (LRU): sticky failover state
        self._sticky: OrderedDict[str, str] = OrderedDict()
        self._sticky_cap = sticky_cap
        self._rr = 0   # round_robin cursor (the bench strawman)
        # placement de-weighting: replica -> composed weight in
        # (0, 1]. Effective load = load / weight, so a de-weighted
        # replica reads as saturated (affinity spills away,
        # least-loaded stops picking it) but stays ELIGIBLE — never
        # ejected on a stale anomaly window. The composed weight is
        # the PRODUCT of named factors (set_factor: "anomaly" from the
        # obs/actions.py actuator, "headroom"/"attainment" from pushed
        # fleet telemetry, router/discovery.py), floored at 0.05, with
        # per-factor provenance kept for /api/v1/fleet audit. Empty by
        # default: report-only behavior is bit-identical to weightless
        # routing.
        self._weights: dict = {}
        # replica -> {source: {"weight": w, "cause": str|None}}
        self._factors: dict = {}

    # -- sticky map ------------------------------------------------------

    def note_admitted(self, idem_key: Optional[str], replica: str,
                      trace: Optional[str] = None) -> None:
        """Record the replica that admitted a keyed request (retries
        route back to it — attach — until it is ejected) and the trace
        id it ran under, so a keyed reconnect CONTINUES the same
        distributed trace instead of starting a fresh one (the
        failover-resumed stream is one story across replicas)."""
        if idem_key is None:
            return
        with self._mu:
            prev = self._sticky.get(idem_key)
            if trace is None and prev is not None:
                trace = prev[1]
            self._sticky[idem_key] = (replica, trace)
            self._sticky.move_to_end(idem_key)
            while len(self._sticky) > self._sticky_cap:
                self._sticky.popitem(last=False)

    def sticky_home(self, idem_key: Optional[str]) -> Optional[str]:
        if idem_key is None:
            return None
        with self._mu:
            entry = self._sticky.get(idem_key)
            return entry[0] if entry is not None else None

    def sticky_trace(self, idem_key: Optional[str]) -> Optional[str]:
        """The trace id the keyed request first admitted under (None =
        unknown key, or it was admitted without trace context)."""
        if idem_key is None:
            return None
        with self._mu:
            entry = self._sticky.get(idem_key)
            return entry[1] if entry is not None else None

    # -- composed placement weights --------------------------------------

    def set_weight(self, replica: str, weight: float) -> None:
        """Back-compat seam for the closed-loop anomaly actuator
        (obs/actions.py): sets the "anomaly" FACTOR, leaving factors
        other sources own (headroom, attainment) intact — an anomaly
        clearing must not also clear a memory-pressure de-weight."""
        self.set_factor(replica, "anomaly", weight)

    def set_factor(self, replica: str, source: str, weight: float,
                   cause: Optional[str] = None) -> None:
        """Set one source's weight factor for a replica. A factor at
        (or above) 1.0 clears that source's entry — the common case
        stays an empty dict and a single load comparison. The composed
        weight is the product of the surviving factors, floored at
        0.05: a zero weight would be a de-facto ejection, which the
        de-weighting contract forbids. `cause` is the human-readable
        provenance ("pool free 0.06 < 0.25") surfaced by
        weight_provenance() and GET /api/v1/fleet."""
        with self._mu:
            facs = self._factors.setdefault(replica, {})
            if weight >= 1.0:
                facs.pop(source, None)
            else:
                facs[source] = {"weight": max(0.05, float(weight)),
                                "cause": cause}
            if not facs:
                self._factors.pop(replica, None)
                self._weights.pop(replica, None)
            else:
                w = 1.0
                for f in facs.values():
                    w *= f["weight"]
                self._weights[replica] = max(0.05, w)

    def clear_factors(self, replica: str) -> None:
        """Drop every factor for a replica (it was forgotten by fleet
        discovery — a future replica reusing the name starts clean)."""
        with self._mu:
            self._factors.pop(replica, None)
            self._weights.pop(replica, None)

    def weight(self, replica: str) -> float:
        with self._mu:
            return self._weights.get(replica, 1.0)

    def weights(self) -> dict:
        """Current non-1.0 composed weights (the /api/v1/anomalies and
        state export)."""
        with self._mu:
            return dict(self._weights)

    def weight_provenance(self, replica: str) -> dict:
        """The composed weight AND where it came from: per-factor
        weight + cause. {"weight": 1.0, "factors": {}} for an
        unweighted replica."""
        with self._mu:
            facs = self._factors.get(replica, {})
            return {"weight": self._weights.get(replica, 1.0),
                    "factors": {src: dict(f)
                                for src, f in facs.items()}}

    def _load_of(self, st: ReplicaState) -> float:
        """Placement load: reported load divided by the replica's
        weight (a 0.25-weight replica with 1 in flight competes like 4
        in flight)."""
        with self._mu:
            w = self._weights.get(st.name)
        return st.load if w is None else st.load / w

    # -- the pick --------------------------------------------------------

    def _eligible(self, exclude: Set[str]) -> List[ReplicaState]:
        out = [s for s in self.tracker.admitting()
               if s.name not in exclude]
        # route AROUND a replica reporting a live config hot-switch
        # (the compile wall behind a fold-everything switch would eat
        # this request's TTFT; proxying into it just earns a 409 roam)
        # — but ONLY while another eligible replica exists: a fleet
        # that is all mid-switch still serves, it never strands
        # traffic. Restore is automatic: the next doc without the flag
        # (the epoch landed) puts the replica straight back.
        steady = [s for s in out if not s.switch_in_flight]
        return steady if steady else out

    def route(self, key: Optional[str] = None,
              idem_key: Optional[str] = None,
              exclude: Optional[Set[str]] = None) -> Decision:
        """Pick a replica. `exclude` holds replicas already tried this
        request (the proxy's failover loop). Raises NoReplicaError when
        nothing can admit."""
        exclude = exclude or set()
        # 1. sticky home: attaches must land where the work lives,
        # draining or not — but never on an ejected corpse, and never
        # on a replica this request already failed against
        home = self.sticky_home(idem_key)
        if home is not None:
            st = self.tracker.get(home)
            usable = (st is not None and not st.ejected and st.polled
                      and not st.breaker_tripped
                      and st.doc.get("status") == "ok")
            if usable and home not in exclude:
                _AFFINITY.labels(outcome="sticky").inc()
                return Decision(home, "sticky", sticky=True)
            if not usable:
                # the home is GONE (not merely excluded by this
                # request's retry loop): re-admission elsewhere
                _FAILOVERS.labels(reason="home_ejected").inc()

        eligible = self._eligible(exclude)
        if not eligible:
            # propagate a replica-computed drain ETA when one exists;
            # otherwise the 503 carries NO Retry-After (the router
            # never invents one)
            etas = [s.drain_eta_s for s in self.tracker.states()
                    if s.draining and s.drain_eta_s is not None]
            raise NoReplicaError(
                "no replica can admit this request "
                f"(tried: {sorted(exclude) or 'none'}; "
                f"replicas: {self.tracker.snapshot()})",
                retry_after_s=min(etas) if etas else None)

        if self.mode == "round_robin":
            with self._mu:
                self._rr += 1
                pick = eligible[self._rr % len(eligible)]
            return Decision(pick.name, "none", sticky=False)

        # 2. affinity with bounded-load spill. `reason` remembers WHY
        # the ring primary was bypassed — "saturated" (bounded-load
        # spill) vs "uneligible" (ejected/draining/excluded) — for the
        # spill Decision's cause attribution
        reason = None
        if key is not None:
            first = True
            for name in self.ring.nodes_for(key):
                st = next((s for s in eligible if s.name == name), None)
                if st is None:
                    if first:
                        reason = "uneligible"
                    first = False   # ring target uneligible -> spill
                    continue
                if (self._load_of(st) >= self.load_watermark
                        and not first):
                    # later ring nodes only take spill when under the
                    # watermark too; past them we fall to least-loaded
                    first = False
                    continue
                if first and self._load_of(st) < self.load_watermark:
                    _AFFINITY.labels(outcome="hit").inc()
                    return Decision(st.name, "hit", sticky=False)
                if first:
                    # the affinity target is saturated: spill
                    reason = "saturated"
                    first = False
                    continue
                _AFFINITY.labels(outcome="spill").inc()
                return Decision(st.name, "spill", sticky=False,
                                spill_reason=reason)
            _AFFINITY.labels(outcome="spill").inc()

        # 3. least-loaded healthy (by weight-adjusted load)
        pick = min(eligible, key=lambda s: (self._load_of(s), s.name))
        if key is None:
            _AFFINITY.labels(outcome="none").inc()
        return Decision(pick.name,
                        "spill" if key is not None else "none",
                        sticky=False,
                        spill_reason=reason if key is not None else None)
