"""Online performance-regression sentinel: rolling-window anomaly
detectors over the LIVE signal stream.

Counterpart of `cake_tpu/obs/sentinel.py`: the engine's detector set
(`attach_engine_sentinel`) and the router's (`attach_router_sentinel`,
over the hop tracer and the router's event ring). The live telemetry the
engine already keeps — step records (obs/steps.py), SLO attainment
(obs/slo.py), the event bus (obs/events.py) — is rich enough to detect
these failure classes online: recompile storms (in the port, bursts of
CUDA-graph captures), KV spill storms, shed storms, per-kind step-time
regressions against a self-calibrated baseline and per-class attainment
collapse.

Design rules:

  * **Detectors are pure and fake-clock testable.** A detector is fed
    (value, now) observations by `Sentinel.tick()` and answers with a
    fired/cleared transition or None; hysteresis (fire after N
    consecutive anomalous windows, clear after M consecutive clean
    ones) prevents flapping on a single noisy window.
  * **No new hot-path instrumentation, no device reads.** Sources are
    closures over seams that ALREADY exist — the flight recorder ring,
    the event bus cursor, the SLO accountant's windows — read once per
    tick (seconds), never per token or step. Every value they read is a
    host number the engine thread already recorded, so the sentinel's
    thread never touches a device tensor or waits for the stream.
  * **Typed output.** A firing publishes one typed ``anomaly`` event
    (machine-readable cause + the evidence window) on the engine's event
    bus, bumps ``cake_anomaly_total{kind}``, raises
    ``cake_anomaly_active{kind}``, and lands in the bounded anomaly ring
    served at ``GET /api/v1/anomalies``. Clearing publishes the paired
    transition and drops the gauge.

Armed by ``--sentinel`` (args -> master -> engine) with
``--sentinel-interval`` setting the tick cadence; `attach_engine_sentinel`
builds the standard detector set from a live engine.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from cake_tpu_torch.obs import metrics as _m

log = logging.getLogger(__name__)

ANOMALY_TOTAL = _m.counter(
    "cake_anomaly_total",
    "Anomalies fired by the online regression sentinel (--sentinel), "
    "by detector kind (obs/sentinel.py; each firing also publishes a "
    "typed 'anomaly' event carrying the machine-readable cause and "
    "evidence window)",
    labelnames=("kind",))
ANOMALY_ACTIVE = _m.gauge(
    "cake_anomaly_active",
    "1 while the named sentinel detector is in the fired state, 0 "
    "once its clear-hysteresis window passes clean",
    labelnames=("kind",))


@dataclass
class Observation:
    """One (value, time) sample a detector judged; the evidence
    window's unit."""

    t: float
    value: float
    anomalous: bool

    def to_dict(self) -> Dict:
        return {"t": round(self.t, 6),
                "value": round(float(self.value), 6),
                "anomalous": self.anomalous}


class Detector:
    """Hysteresis core shared by every detector flavor.

    `observe(value, now)` judges one windowed sample and returns a
    transition dict (`{"state": "fired"|"cleared", "cause": {...}}`)
    or None. Firing needs `fire_after` CONSECUTIVE anomalous samples;
    clearing needs `clear_after` consecutive clean ones — a single
    noisy window moves neither edge (the no-flap contract, pinned by
    unit test). Subclasses implement `judge(value) -> bool` and
    `describe() -> dict` (the machine-readable threshold block)."""

    def __init__(self, kind: str, *, fire_after: int = 2,
                 clear_after: int = 3, evidence: int = 32):
        if fire_after < 1 or clear_after < 1:
            raise ValueError("fire_after and clear_after must be >= 1")
        self.kind = kind
        self.fire_after = fire_after
        self.clear_after = clear_after
        self.active = False
        self._over = 0
        self._clean = 0
        self._evidence: deque = deque(maxlen=max(1, int(evidence)))

    # -- subclass surface --------------------------------------------------

    def judge(self, value: float) -> bool:
        raise NotImplementedError

    def describe(self) -> Dict:
        """Machine-readable threshold block ({"threshold": ...,
        "comparison": "above"|"below", ...})."""
        raise NotImplementedError

    # -- the one entry point ----------------------------------------------

    def observe(self, value: float, now: float) -> Optional[Dict]:
        anomalous = bool(self.judge(value))
        self._evidence.append(Observation(now, float(value), anomalous))
        if anomalous:
            self._over += 1
            self._clean = 0
        else:
            self._clean += 1
            self._over = 0
        if not self.active and self._over >= self.fire_after:
            self.active = True
            return {"state": "fired", "cause": self.cause(value)}
        if self.active and self._clean >= self.clear_after:
            self.active = False
            return {"state": "cleared", "cause": self.cause(value)}
        return None

    def cause(self, value: float) -> Dict:
        out = {"kind": self.kind, "value": round(float(value), 6)}
        out.update(self.describe())
        return out

    def evidence_window(self) -> List[Dict]:
        return [o.to_dict() for o in self._evidence]

    def state(self) -> Dict:
        return {"kind": self.kind, "active": self.active,
                "fire_after": self.fire_after,
                "clear_after": self.clear_after,
                **self.describe()}


class ThresholdDetector(Detector):
    """Fixed-threshold detector: anomalous when the windowed value
    crosses `threshold` in the `mode` direction (rates: recompiles /
    spills / sheds per window; fractions: attainment below target)."""

    def __init__(self, kind: str, threshold: float,
                 mode: str = "above", **kw):
        if mode not in ("above", "below"):
            raise ValueError(f"mode {mode!r} must be above or below")
        super().__init__(kind, **kw)
        self.threshold = float(threshold)
        self.mode = mode

    def judge(self, value: float) -> bool:
        return (value > self.threshold if self.mode == "above"
                else value < self.threshold)

    def describe(self) -> Dict:
        return {"threshold": self.threshold, "comparison": self.mode}


class BaselineDetector(Detector):
    """Self-calibrated detector: the first `calibrate_n` samples (never
    judged anomalous) fix a median baseline; afterwards a sample is
    anomalous when it exceeds `ratio x baseline` (mode "above" — e.g.
    step-time p95 regression) or falls below `ratio x baseline` (mode
    "below", ratio < 1 — e.g. affinity hit-rate collapse). min_baseline
    floors the calibrated value so microsecond-noise baselines cannot
    make every later sample read as a 3x regression."""

    def __init__(self, kind: str, ratio: float = 3.0,
                 calibrate_n: int = 6, mode: str = "above",
                 min_baseline: float = 0.0, **kw):
        if mode not in ("above", "below"):
            raise ValueError(f"mode {mode!r} must be above or below")
        if calibrate_n < 1:
            raise ValueError("calibrate_n must be >= 1")
        super().__init__(kind, **kw)
        self.ratio = float(ratio)
        self.calibrate_n = int(calibrate_n)
        self.mode = mode
        self.min_baseline = float(min_baseline)
        self.baseline: Optional[float] = None
        self._calib: List[float] = []

    def judge(self, value: float) -> bool:
        if self.baseline is None:
            self._calib.append(float(value))
            if len(self._calib) >= self.calibrate_n:
                xs = sorted(self._calib)
                mid = xs[len(xs) // 2] if len(xs) % 2 else (
                    (xs[len(xs) // 2 - 1] + xs[len(xs) // 2]) / 2.0)
                self.baseline = max(mid, self.min_baseline)
            return False
        bound = self.ratio * self.baseline
        return value > bound if self.mode == "above" else value < bound

    def describe(self) -> Dict:
        out = {"ratio": self.ratio, "comparison": self.mode,
               "calibrate_n": self.calibrate_n}
        if self.baseline is not None:
            out["baseline"] = round(self.baseline, 6)
            out["threshold"] = round(self.ratio * self.baseline, 6)
        else:
            out["calibrating"] = True
        return out


@dataclass
class Anomaly:
    """One fired detector transition held in the bounded ring."""

    kind: str
    fired_at: float                # wall clock
    cause: Dict
    evidence: List[Dict] = field(default_factory=list)
    cleared_at: Optional[float] = None

    def to_dict(self) -> Dict:
        out = {"kind": self.kind,
               "fired_at": round(self.fired_at, 6),
               "active": self.cleared_at is None,
               "cause": self.cause,
               "evidence": self.evidence}
        if self.cleared_at is not None:
            out["cleared_at"] = round(self.cleared_at, 6)
        return out


class Sentinel:
    """Detector orchestrator: one tick reads every registered source,
    feeds its detector, and turns transitions into anomaly records,
    metrics and typed bus events.

    `tick(now=None)` is the synchronous, fake-clock-friendly seam
    (chip_smoke.py and the tests drive it directly); `start()` runs it on a daemon
    thread every `interval_s`. Sources are zero-arg callables returning
    the windowed value or None (no data this window — the detector is
    NOT fed: absence of traffic is not evidence either way). A source
    that raises is logged and skipped — the sentinel must never take
    serving down."""

    # cakelint guards discipline: the event bus is an optional plane
    OPTIONAL_PLANES = ("_events",)

    def __init__(self, *, interval_s: float = 2.0, events=None,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 capacity: int = 256, observe_metrics: bool = True):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.interval_s = float(interval_s)
        self._events = events
        self._clock = clock
        self._wall = wall
        self._observe = observe_metrics
        self._mu = threading.Lock()
        self._sources: List[tuple] = []
        self._active: Dict[str, Anomaly] = {}
        self._history: deque = deque(maxlen=max(1, int(capacity)))
        self._ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # transition listeners (obs/actions.py actuators): called as
        # fn(kind, state, cause) on the ticking thread AFTER the
        # anomaly ring / metrics / bus publish — a listener that raises
        # is logged and skipped (the sentinel never takes serving down)
        self._listeners: List[Callable] = []

    def add_listener(self, fn: Callable[[str, str, Dict], None]
                     ) -> "Sentinel":
        with self._mu:
            self._listeners.append(fn)
        return self

    def add(self, detector: Detector,
            source: Callable[[], Optional[float]]) -> "Sentinel":
        with self._mu:
            if any(d.kind == detector.kind for d, _ in self._sources):
                raise ValueError(
                    f"duplicate detector kind {detector.kind!r}")
            self._sources.append((detector, source))
        return self

    # -- the tick ---------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> List[Dict]:
        """Run every detector once; returns this tick's transitions
        (the smoke's assertion surface)."""
        now = self._clock() if now is None else now
        with self._mu:
            sources = list(self._sources)
            self._ticks += 1
        out: List[Dict] = []
        for det, src in sources:
            try:
                value = src()
            except Exception:  # noqa: BLE001 — telemetry never fails serving
                log.debug("sentinel source %s failed", det.kind,
                          exc_info=True)
                continue
            if value is None:
                continue
            tr = det.observe(float(value), now)
            if tr is not None:
                self._transition(det, tr)
                out.append({"kind": det.kind, **tr})
        return out

    def _transition(self, det: Detector, tr: Dict) -> None:
        wall_now = self._wall()
        if tr["state"] == "fired":
            rec = Anomaly(kind=det.kind, fired_at=wall_now,
                          cause=tr["cause"],
                          evidence=det.evidence_window())
            with self._mu:
                self._active[det.kind] = rec
                self._history.append(rec)
            if self._observe:
                ANOMALY_TOTAL.labels(kind=det.kind).inc()
                ANOMALY_ACTIVE.labels(kind=det.kind).set(1)
            log.warning("sentinel: anomaly fired: %s", tr["cause"])
        else:
            with self._mu:
                rec = self._active.pop(det.kind, None)
            if rec is not None:
                rec.cleared_at = wall_now
            if self._observe:
                ANOMALY_ACTIVE.labels(kind=det.kind).set(0)
            log.info("sentinel: anomaly cleared: %s", det.kind)
        if self._events is not None:
            self._events.publish("anomaly", state=tr["state"],
                                 **tr["cause"])
        with self._mu:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(det.kind, tr["state"], dict(tr["cause"]))
            except Exception:  # noqa: BLE001 — actuators never take us down
                log.warning("sentinel listener failed on %s %s",
                            det.kind, tr["state"], exc_info=True)

    # -- export (GET /api/v1/anomalies) -----------------------------------

    def state(self, limit: Optional[int] = None) -> Dict:
        with self._mu:
            active = [a.to_dict() for a in self._active.values()]
            hist = [a.to_dict() for a in reversed(self._history)]
            dets = [d.state() for d, _ in self._sources]
            ticks = self._ticks
        if limit is not None:
            hist = hist[:max(0, int(limit))]
        return {"active": active, "anomalies": hist,
                "detectors": dets, "ticks": ticks,
                "interval_s": self.interval_s}

    # -- baseline persistence (the checkpoint snapshot) --------------------

    def export_baselines(self) -> Dict[str, Dict]:
        """Calibrated BaselineDetector state, keyed by kind — the
        checkpoint snapshot carries this (informationally, outside the
        fingerprint) so a graceful restart does not spend calibrate_n
        windows re-learning what normal looks like. Only CALIBRATED
        detectors export; a mid-calibration sample list is not a
        baseline."""
        out: Dict[str, Dict] = {}
        with self._mu:
            sources = list(self._sources)
        for det, _ in sources:
            if (isinstance(det, BaselineDetector)
                    and det.baseline is not None):
                out[det.kind] = {"baseline": round(det.baseline, 9),
                                 "ratio": det.ratio, "mode": det.mode}
        return out

    def restore_baselines(self, baselines: Optional[Dict[str, Dict]]
                          ) -> int:
        """Adopt previously exported baselines into this sentinel's
        still-calibrating BaselineDetectors (matched by kind; a
        detector that already calibrated keeps its own — live evidence
        beats a snapshot). Mismatched mode or a non-positive value is
        skipped: a stale snapshot must never plant a baseline an
        empty-baseline firing would be judged against. Returns the
        number of detectors restored."""
        if not baselines:
            return 0
        restored = 0
        with self._mu:
            sources = list(self._sources)
        for det, _ in sources:
            if not isinstance(det, BaselineDetector):
                continue
            saved = baselines.get(det.kind)
            if not isinstance(saved, dict) or det.baseline is not None:
                continue
            try:
                value = float(saved["baseline"])
            except (KeyError, TypeError, ValueError):
                continue
            if value <= 0 or saved.get("mode", det.mode) != det.mode:
                continue
            det.baseline = max(value, det.min_baseline)
            det._calib = []
            restored += 1
        if restored:
            log.info("sentinel: restored %d calibrated baseline(s) "
                     "from snapshot", restored)
        return restored

    @property
    def active_count(self) -> int:
        with self._mu:
            return len(self._active)

    @property
    def fired_total(self) -> int:
        """Firings THIS sentinel saw (ring-bounded; a drive reads
        this per-instance view — cake_anomaly_total is process-global
        across sentinels)."""
        with self._mu:
            return len(self._history)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "Sentinel":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="cake-sentinel")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — keep ticking
                log.debug("sentinel tick failed", exc_info=True)

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# -- standard detector sets ---------------------------------------------------

# step kinds the per-kind step-time regression detectors watch: the
# decode-side kinds carry the throughput, prefill carries admission
# latency — a bounded set (obs/steps.py's vocabulary), so the
# cake_anomaly_* {kind} label stays bounded too
STEP_KINDS = ("decode", "decode_scan", "mixed", "spec", "prefill")


def _event_count_source(bus, type: str) -> Callable[[], Optional[float]]:
    """Events of `type` published since the previous tick (cursor-paged
    off the bus — the existing seam, no publisher changes)."""
    state = {"cursor": bus.cursor}

    def src() -> Optional[float]:
        evs, cursor = bus.snapshot(type=type, since=state["cursor"])
        state["cursor"] = cursor
        return float(len(evs))
    return src


class _FlightWindow:
    """ONE flight-ring snapshot per tick, shared by every flight-fed
    source (5 step kinds + recompile would otherwise each copy the
    whole ring every tick). The cursor starts at the ring's newest
    step AT ATTACH TIME, so a sentinel attached to an already-warm
    engine never counts pre-attach history as its first window (the
    event sources start at the bus cursor for the same reason).
    Sentinel.tick calls every registered source each tick, so the
    refresh cycles exactly once per `consumers` reads."""

    def __init__(self, flight):
        self._flight = flight
        recs = flight.dump(limit=1)
        self._cursor = recs[0]["step"] if recs else 0
        self._recs: List[Dict] = []
        self._reads = 0
        self.consumers = 1     # set after registration

    def _window(self) -> List[Dict]:
        if self._reads == 0:
            recs = self._flight.dump()
            newest = recs[0]["step"] if recs else self._cursor
            self._recs = [r for r in recs
                          if r["step"] > self._cursor]
            self._cursor = newest
        self._reads += 1
        if self._reads >= self.consumers:
            self._reads = 0
        return self._recs

    def p95_source(self, kind: str, min_samples: int = 5
                   ) -> Callable[[], Optional[float]]:
        """p95 wall seconds of `kind` steps in this window, capturing
        steps excluded (their wall is the graph capture — the recompile
        detector owns those)."""
        def src() -> Optional[float]:
            walls = sorted(r["wall_s"] for r in self._window()
                           if r["kind"] == kind and not r["compiled"])
            if len(walls) < min_samples:
                return None
            return walls[min(len(walls) - 1, int(0.95 * len(walls)))]
        return src

    def recompile_source(self) -> Callable[[], Optional[float]]:
        """Steps that captured a CUDA graph in this window (the flight
        recorder's compiled flag, the port's counterpart of a new jit
        signature — works with the event bus disabled too)."""
        def src() -> Optional[float]:
            return float(sum(1 for r in self._window()
                             if r["compiled"]))
        return src


def attach_engine_sentinel(engine, *, interval_s: float = 2.0,
                           step_ratio: float = 3.0,
                           recompile_threshold: float = 2.0,
                           spill_threshold: float = 16.0,
                           shed_threshold: float = 4.0,
                           attainment_floor: float = 0.5,
                           fire_after: int = 2,
                           clear_after: int = 3) -> Sentinel:
    """The engine-side standard detector set, fed entirely from
    existing seams (flight recorder, event bus, SLO accountant):

      * ``step_time:{kind}`` — per-kind step p95 vs a self-calibrated
        baseline (> step_ratio x baseline fires);
      * ``recompile_storm`` — CUDA-graph captures per tick window
        (steady-state serving captures nothing; a rise is a new step
        variant, a shape leak or a live config switch re-capturing);
      * ``kv_spill_storm`` / ``shed_storm`` — kv_spill / shed events
        per tick window (needs the event bus);
      * ``attainment:{class}`` — rolling-1m SLO attainment below
        attainment_floor.
    """
    sen = Sentinel(interval_s=interval_s, events=engine.events)
    window = _FlightWindow(engine.flight)
    for kind in STEP_KINDS:
        sen.add(BaselineDetector(f"step_time:{kind}", ratio=step_ratio,
                                 min_baseline=1e-4,
                                 fire_after=fire_after,
                                 clear_after=clear_after),
                window.p95_source(kind))
    sen.add(ThresholdDetector("recompile_storm", recompile_threshold,
                              fire_after=fire_after,
                              clear_after=clear_after),
            window.recompile_source())
    window.consumers = len(STEP_KINDS) + 1
    if engine.events is not None:
        sen.add(ThresholdDetector("kv_spill_storm", spill_threshold,
                                  fire_after=fire_after,
                                  clear_after=clear_after),
                _event_count_source(engine.events, "kv_spill"))
        sen.add(ThresholdDetector("shed_storm", shed_threshold,
                                  fire_after=fire_after,
                                  clear_after=clear_after),
                _event_count_source(engine.events, "shed"))
    from cake_tpu_torch.sched.classes import PRIORITY_CLASSES

    def _attainment_source(cls: str):
        def src() -> Optional[float]:
            return engine.slo.attainment_by_class("1m").get(cls)
        return src
    for cls in PRIORITY_CLASSES:
        sen.add(ThresholdDetector(f"attainment:{cls}",
                                  attainment_floor, mode="below",
                                  fire_after=fire_after,
                                  clear_after=clear_after),
                _attainment_source(cls))
    return sen


def attach_router_sentinel(router, *, interval_s: float = 2.0,
                           window_s: float = 30.0,
                           ttft_skew_ratio: float = 4.0,
                           hit_collapse_ratio: float = 0.5,
                           shed_threshold: float = 4.0,
                           min_samples: int = 4,
                           fire_after: int = 2,
                           clear_after: int = 3) -> Optional[Sentinel]:
    """The router-side standard detector set, fed from the hop
    tracer's rolling samples and the router event ring:

      * ``replica_ttft_skew`` — slowest replica's median first-byte
        latency over the fastest's (> ttft_skew_ratio fires): one
        degraded replica in an otherwise healthy fleet;
      * ``affinity_collapse`` — fleet affinity hit fraction vs its
        self-calibrated baseline (< hit_collapse_ratio x baseline
        fires): ring churn / a hot tenant overwhelming its home;
      * ``router_shed_storm`` — shed_by_router events per tick window.

    None when the hop tracer is disabled (trace_ring=0) — every
    detector here reads it."""
    if router.hops is None:
        log.warning("router sentinel disabled: the hop tracer is off "
                    "(trace_ring=0) and every router detector reads "
                    "its samples")
        return None
    hops = router.hops
    sen = Sentinel(interval_s=interval_s, events=router.events)

    def ttft_skew() -> Optional[float]:
        by_rep = hops.ttft_by_replica(window_s)
        meds = []
        for ttfts in by_rep.values():
            if len(ttfts) >= min_samples:
                xs = sorted(ttfts)
                meds.append(xs[len(xs) // 2])
        if len(meds) < 2 or min(meds) <= 0:
            return None
        return max(meds) / min(meds)

    def hit_fraction() -> Optional[float]:
        counts = hops.outcome_counts(window_s)
        denom = counts.get("hit", 0) + counts.get("spill", 0)
        if denom < min_samples:
            return None
        return counts.get("hit", 0) / denom

    sen.add(ThresholdDetector("replica_ttft_skew", ttft_skew_ratio,
                              fire_after=fire_after,
                              clear_after=clear_after), ttft_skew)
    sen.add(BaselineDetector("affinity_collapse",
                             ratio=hit_collapse_ratio, mode="below",
                             fire_after=fire_after,
                             clear_after=clear_after), hit_fraction)
    if router.events is not None:
        sen.add(ThresholdDetector("router_shed_storm", shed_threshold,
                                  fire_after=fire_after,
                                  clear_after=clear_after),
                _event_count_source(router.events, "shed_by_router"))
    return sen
