"""Closed-loop anomaly actions: typed, rate-bounded actuation with a
full audit trail, plus black-box postmortem bundles.

Counterpart of `cake_tpu/obs/actions.py`: the engine's actuator, the
router's (`RouterAnomalyActuator`, --router-anomaly-weighting) and the
postmortem sink for either role. The sentinel
(obs/sentinel.py) detects recompile storms, step-time regressions and
attainment collapse; this module closes the loop:

  * **ActionPlane** — the audit trail: a bounded action-history ring
    served through ``GET /api/v1/anomalies``, one typed
    ``anomaly_action`` event per action on the engine's bus, the
    ``cake_anomaly_actions_total{kind,action,outcome}`` counter, and a
    sliding-window rate bound so a flapping detector can never thrash
    configs faster than ``max_per_min`` state changes a minute.
  * **EngineAnomalyActuator** — sentinel transitions become first-class
    AutotuneController signals (``note_anomaly``): a recompile storm or
    step-time regression HOLDS new policy switches while active, and —
    when the post-switch rollback guard is armed — pins the rollback
    verdict immediately from anomaly evidence instead of waiting out the
    timer window. The reconfigure itself still happens on the engine
    thread through ``reconfigure()`` at the next autotune tick; the
    actuator runs on the sentinel thread and reads no device tensor.
  * **PostmortemSink** — black-box forensics: on a breaker stop, a
    failed rebuild, a poison quarantine or SIGTERM, dump one JSON bundle
    (recent step records, event ring, trace spans, anomaly and action
    history, stats, metrics snapshot, journal tail) to
    ``--postmortem-dir``; ``tools/postmortem.py`` (stdlib only) renders
    a bundle into a wall-clock-ordered narrative. Dumps are best-effort
    and interval-bounded: the sink runs on failure paths and must never
    take the process down, or write one bundle per poisoned request in a
    cascade.

Actuation is opt-in (``--sentinel-act``, ``--postmortem-dir``): with the
flags off nothing here is constructed.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from cake_tpu_torch.obs import metrics as _m

log = logging.getLogger(__name__)

ACTIONS_TOTAL = _m.counter(
    "cake_anomaly_actions_total",
    "Closed-loop actions taken (or declined) in response to sentinel "
    "anomalies, by detector kind, action (hold / rollback / resume / "
    "deweight / reweight) and outcome (applied / noop / skipped / "
    "rate_limited) — obs/actions.py; armed by --sentinel-act / "
    "--router-anomaly-weighting, zero series in report-only mode",
    labelnames=("kind", "action", "outcome"))
POSTMORTEM_BUNDLES = _m.counter(
    "cake_postmortem_bundles_total",
    "Black-box postmortem bundles written to --postmortem-dir, by "
    "trigger (breaker_stop / reset_failed / poison / sigterm / "
    "engine_stop); tools/postmortem.py renders a bundle into a "
    "wall-clock narrative",
    labelnames=("trigger",))
POSTMORTEM_ERRORS = _m.counter(
    "cake_postmortem_errors_total",
    "Postmortem bundle writes that failed (the dump path never takes "
    "serving down — a failure is logged and counted, never raised)")

# actions that CHANGE state (a config switch, a placement weight) and
# therefore spend the ActionPlane's rate budget; holds, resumes and
# recovery re-weights are always free — the budget must never strand a
# de-weighted replica or let the controller keep switching on garbage
RATE_BOUND_ACTIONS = ("rollback", "deweight")


class ActionPlane:
    """Bounded audit trail + rate limiter shared by every anomaly
    actuator in one process. Thread-safe: actuators run on the sentinel
    thread, `history()`/`state()` on API handler threads."""

    # cakelint guards discipline: the event bus is an optional plane
    OPTIONAL_PLANES = ("_events",)

    def __init__(self, *, events=None, capacity: int = 256,
                 max_per_min: int = 6,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 observe_metrics: bool = True):
        if max_per_min < 1:
            raise ValueError("max_per_min must be >= 1")
        self._events = events
        self._clock = clock
        self._wall = wall
        self._observe = observe_metrics
        self.max_per_min = int(max_per_min)
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._spent: deque = deque()   # monotonic stamps of rate-bound applies
        self._total = 0
        self._applied = 0

    def allow(self, now: Optional[float] = None) -> bool:
        """True while another rate-bound actuation fits the sliding
        one-minute budget (a flapping detector can propose, but cannot
        actuate, unboundedly)."""
        now = self._clock() if now is None else now
        with self._mu:
            while self._spent and now - self._spent[0] > 60.0:
                self._spent.popleft()
            return len(self._spent) < self.max_per_min

    def record(self, kind: str, action: str, outcome: str,
               **detail) -> Dict:
        """Append one action to the audit trail: ring + typed
        ``anomaly_action`` bus event + metrics. None-valued detail is
        dropped (callers pass optional context unconditionally)."""
        rec = {"t": round(self._wall(), 6), "kind": kind,
               "action": action, "outcome": outcome}
        rec.update({k: v for k, v in detail.items() if v is not None})
        with self._mu:
            self._ring.append(rec)
            self._total += 1
            if outcome == "applied":
                self._applied += 1
                if action in RATE_BOUND_ACTIONS:
                    self._spent.append(self._clock())
        if self._observe:
            ACTIONS_TOTAL.labels(kind=kind, action=action,
                                 outcome=outcome).inc()
        if self._events is not None:
            # only scalar detail rides the event (evidence dicts stay
            # in the ring — the bus is the timeline's merge feed)
            scal = {k: v for k, v in detail.items()
                    if isinstance(v, (str, int, float, bool))}
            self._events.publish("anomaly_action", kind=kind,
                                 action=action, outcome=outcome, **scal)
        return rec

    # -- export (GET /api/v1/anomalies "actions") -------------------------

    def history(self, limit: Optional[int] = None) -> List[Dict]:
        """Newest-first action records."""
        with self._mu:
            out = [dict(r) for r in reversed(self._ring)]
        if limit is not None:
            out = out[:max(0, int(limit))]
        return out

    @property
    def total(self) -> int:
        with self._mu:
            return self._total

    @property
    def applied_total(self) -> int:
        with self._mu:
            return self._applied

    def state(self, limit: Optional[int] = None) -> Dict:
        with self._mu:
            total, applied = self._total, self._applied
        return {"actions": self.history(limit), "total": total,
                "applied": applied, "max_per_min": self.max_per_min}


def _scalar_cause(cause: Dict) -> Dict:
    """The scalar slice of a detector cause (threshold/value/baseline),
    prefixed so action records never collide with their own keys."""
    out = {}
    for k in ("value", "threshold", "baseline", "ratio", "comparison"):
        v = cause.get(k)
        if isinstance(v, (str, int, float, bool)):
            out[f"cause_{k}"] = v
    return out


class EngineAnomalyActuator:
    """Replica-side closed loop: sentinel transitions -> autotune
    controller signals (--sentinel-act).

    Runs on the sentinel thread; `AutotuneController.note_anomaly` is
    thread-safe and only flips host-side intent — the resulting
    hold/rollback is consumed by `decide()` on the engine thread at the
    next autotune tick, so the reconfigure itself stays on the existing
    engine-thread `reconfigure()` seam."""

    def __init__(self, engine, plane: ActionPlane):
        self._engine = engine
        self._plane = plane

    def attach(self, sentinel) -> "EngineAnomalyActuator":
        sentinel.add_listener(self.on_transition)
        return self

    @staticmethod
    def actionable(kind: str) -> bool:
        """Config-plane evidence: a recompile storm or a step-time
        regression indicts the CURRENT config for the live shape mix;
        spill/shed/attainment anomalies have their own actuators
        (shedding, the host tier) and propose nothing here."""
        return kind == "recompile_storm" or kind.startswith("step_time:")

    def on_transition(self, kind: str, state: str, cause: Dict) -> None:
        if not self.actionable(kind):
            return
        at = getattr(self._engine, "_autotuner", None)
        if at is None:
            self._plane.record(kind, "hold" if state == "fired"
                               else "resume", "skipped",
                               reason="autotune disabled")
            return
        if state == "cleared":
            proposal = at.note_anomaly(kind, "cleared", cause)
            if proposal is not None:
                self._plane.record(kind, proposal, "applied",
                                   **_scalar_cause(cause))
            return
        # fired: a rollback (guard armed) is a config switch and spends
        # the rate budget; over budget it degrades to a plain hold —
        # holds are free (they PREVENT switches, never cause them)
        wants_switch = at.guard_armed
        allowed = self._plane.allow() if wants_switch else True
        proposal = at.note_anomaly(kind, "fired", cause,
                                   allow_switch=allowed)
        outcome = ("rate_limited"
                   if wants_switch and not allowed else "applied")
        self._plane.record(kind, proposal, outcome,
                           **_scalar_cause(cause))


def _best_effort(fn: Callable, what: str):
    """Collector wrapper for the postmortem path: a broken telemetry
    read costs one log line, never the bundle."""
    try:
        return fn()
    except Exception:  # noqa: BLE001 — forensics never raise
        log.debug("postmortem: %s collector failed", what,
                  exc_info=True)
        return None


def _journal_tail(path: Optional[str], n: int = 200) -> Optional[list]:
    if not path:
        return None
    try:
        with open(path, "rb") as f:
            # bounded read from the end: journals can be huge
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - 256 * 1024))
            lines = f.read().decode("utf-8", "replace").splitlines()
    except OSError:
        return None
    out = []
    for ln in lines[-n:]:
        try:
            out.append(json.loads(ln))
        except ValueError:
            out.append({"raw": ln})
    return out


# the router-tier detector kinds the actuator acts on
ROUTER_ACTION_KINDS = ("replica_ttft_skew", "affinity_collapse",
                       "router_shed_storm")


class RouterAnomalyActuator:
    """Router-side closed loop: sentinel transitions -> placement
    de-weighting (--router-anomaly-weighting).

    On fire, the offending replica's RoutingPolicy weight drops to
    `factor` (its effective load is divided by the weight, so affinity
    targets spill away and least-loaded stops picking it) — it stays
    ELIGIBLE, never ejected, so a stale window can at worst misplace
    load, not strand it. On clear, the weight is restored and the
    replica enters a `cooldown_s` window during which it cannot be
    de-weighted again (anti-flap, on top of the detectors' own
    fire/clear hysteresis)."""

    def __init__(self, router, plane: ActionPlane, *,
                 factor: float = 0.25, cooldown_s: float = 30.0,
                 window_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"factor {factor} must be in (0, 1)")
        self._router = router
        self._plane = plane
        self.factor = float(factor)
        self.cooldown_s = float(cooldown_s)
        self.window_s = float(window_s)
        self._clock = clock
        self._mu = threading.Lock()
        self._deweighted: Dict[str, str] = {}      # kind -> replica
        self._cooldown_until: Dict[str, float] = {}  # replica -> t

    def attach(self, sentinel) -> "RouterAnomalyActuator":
        sentinel.add_listener(self.on_transition)
        return self

    def _offender(self, kind: str) -> Optional[str]:
        """The replica this anomaly indicts. TTFT skew: the slowest
        median in the hop tracer's window. Shed storm / affinity
        collapse carry no replica in their cause — blame the most
        loaded admitting replica. None when the fleet has fewer than
        two admitting replicas: de-weighting the only destination just
        misroutes the accounting."""
        if kind == "replica_ttft_skew":
            hops = self._router.hops
            if hops is None:
                return None
            meds: Dict[str, float] = {}
            for name, ttfts in hops.ttft_by_replica(
                    self.window_s).items():
                if ttfts:
                    xs = sorted(ttfts)
                    meds[name] = xs[len(xs) // 2]
            if len(meds) < 2:
                return None
            return max(sorted(meds), key=lambda n: meds[n])
        states = self._router.tracker.admitting()
        if len(states) < 2:
            return None
        return max(states, key=lambda s: (s.load, s.name)).name

    def on_transition(self, kind: str, state: str, cause: Dict) -> None:
        if kind not in ROUTER_ACTION_KINDS:
            return
        policy = self._router.policy
        now = self._clock()
        if state == "fired":
            name = self._offender(kind)
            if name is None:
                self._plane.record(kind, "deweight", "noop",
                                   reason="no offender "
                                          "(need >= 2 admitting replicas)",
                                   **_scalar_cause(cause))
                return
            with self._mu:
                cooling = now < self._cooldown_until.get(
                    name, float("-inf"))
            if cooling:
                self._plane.record(kind, "deweight", "skipped",
                                   replica=name, reason="cooldown",
                                   **_scalar_cause(cause))
                return
            if not self._plane.allow(now):
                self._plane.record(kind, "deweight", "rate_limited",
                                   replica=name, **_scalar_cause(cause))
                return
            policy.set_weight(name, self.factor)
            with self._mu:
                self._deweighted[kind] = name
            self._plane.record(kind, "deweight", "applied",
                               replica=name, weight=self.factor,
                               **_scalar_cause(cause))
            return
        # cleared: restore the weight unless another active anomaly
        # still holds this replica down
        with self._mu:
            name = self._deweighted.pop(kind, None)
            held = name is not None and name in self._deweighted.values()
        if name is None:
            return
        if held:
            self._plane.record(kind, "reweight", "noop", replica=name,
                               reason="held by another anomaly")
            return
        policy.set_weight(name, 1.0)
        with self._mu:
            self._cooldown_until[name] = now + self.cooldown_s
        self._plane.record(kind, "reweight", "applied", replica=name,
                           weight=1.0, cooldown_s=self.cooldown_s)


def _best_effort(fn: Callable, what: str):
    """Collector wrapper for the postmortem path: a broken telemetry
    read costs one log line, never the bundle."""
    try:
        return fn()
    except Exception:  # noqa: BLE001 — forensics never raise
        log.debug("postmortem: %s collector failed", what,
                  exc_info=True)
        return None


def _journal_tail(path: Optional[str], n: int = 200) -> Optional[list]:
    if not path:
        return None
    try:
        with open(path, "rb") as f:
            # bounded read from the end: journals can be huge
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - 256 * 1024))
            lines = f.read().decode("utf-8", "replace").splitlines()
    except OSError:
        return None
    out = []
    for ln in lines[-n:]:
        try:
            out.append(json.loads(ln))
        except ValueError:
            out.append({"raw": ln})
    return out


class PostmortemSink:
    """Black-box bundle writer (--postmortem-dir): one JSON file per
    terminal incident, holding every in-memory ring that explains WHY.
    Interval-bounded (one poison cascade writes one bundle, not
    hundreds) and best-effort end to end."""

    def __init__(self, dir_path: str, *, min_interval_s: float = 5.0,
                 wall: Callable[[], float] = time.time,
                 clock: Callable[[], float] = time.monotonic):
        self.dir = dir_path
        self.min_interval_s = float(min_interval_s)
        self._wall = wall
        self._clock = clock
        self._mu = threading.Lock()
        self._last_t: Optional[float] = None
        self._seq = 0
        try:
            os.makedirs(dir_path, exist_ok=True)
        except OSError:
            log.warning("postmortem: cannot create %s", dir_path,
                        exc_info=True)

    def dump(self, trigger: str, *, engine=None, router=None,
             reason: Optional[str] = None,
             force: bool = False) -> Optional[str]:
        """Write one bundle; returns its path, or None (interval-bound
        hit, or the write failed). `force=True` bypasses the interval
        bound — terminal triggers (breaker stop, SIGTERM) always leave
        a bundle even right after a poison dump."""
        now = self._clock()
        with self._mu:
            if (not force and self._last_t is not None
                    and now - self._last_t < self.min_interval_s):
                return None
            self._last_t = now
            self._seq += 1
            seq = self._seq
        try:
            bundle = self._collect(trigger, engine=engine,
                                   router=router, reason=reason)
            name = (f"postmortem-{int(bundle['wall_time'] * 1000)}"
                    f"-{seq:03d}-{trigger}.json")
            path = os.path.join(self.dir, name)
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(bundle, f, indent=1, default=str)
                f.write("\n")
            os.replace(tmp, path)
            POSTMORTEM_BUNDLES.labels(trigger=trigger).inc()
            log.warning("postmortem: wrote %s (%s)", path, trigger)
            return path
        except Exception:  # noqa: BLE001 — forensics never raise
            POSTMORTEM_ERRORS.inc()
            log.warning("postmortem: bundle write failed (%s)", trigger,
                        exc_info=True)
            return None

    def _collect(self, trigger: str, *, engine=None, router=None,
                 reason: Optional[str]) -> Dict:
        bundle: Dict = {"version": 1, "trigger": trigger,
                        "wall_time": round(self._wall(), 6)}
        if reason is not None:
            bundle["reason"] = str(reason)
        src = engine if engine is not None else router
        if src is None:
            return bundle
        flight = getattr(src, "flight", None)
        if flight is not None:
            bundle["steps"] = _best_effort(
                lambda: flight.dump(limit=256), "flight")
        events = getattr(src, "events", None)
        if events is not None:
            bundle["events"] = _best_effort(
                lambda: events.dump(limit=512), "events")
        tracer = getattr(src, "tracer", None)
        if tracer is not None:
            bundle["traces"] = _best_effort(
                lambda: tracer.dump(limit=64), "tracer")
        hops = getattr(src, "hops", None)
        if hops is not None:
            bundle["hops"] = _best_effort(
                lambda: hops.dump(limit=64), "hops")
        sentinel = getattr(src, "sentinel", None)
        if sentinel is not None:
            bundle["anomalies"] = _best_effort(
                lambda: sentinel.state(limit=64), "sentinel")
        actions = (getattr(src, "_actions", None)
                   or getattr(src, "actions", None))
        if actions is not None:
            bundle["actions"] = _best_effort(
                lambda: actions.history(limit=128), "actions")
        stats = getattr(src, "stats", None)
        if stats is not None and dataclasses.is_dataclass(stats):
            bundle["stats"] = _best_effort(
                lambda: dataclasses.asdict(stats), "stats")
        journal = getattr(src, "_journal", None)
        if journal is not None:
            bundle["journal_tail"] = _best_effort(
                lambda: _journal_tail(getattr(journal, "path", None)),
                "journal")
        bundle["metrics"] = _best_effort(_m.REGISTRY.render, "metrics")
        return bundle
