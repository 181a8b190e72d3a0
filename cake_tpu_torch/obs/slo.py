"""SLO attainment + goodput accounting: serving quality as a metric.

Counterpart of `cake_tpu/obs/slo.py`, copied as it is.

The Gemma-on-TPU serving comparison (PAPERS.md) frames serving quality
as *SLO attainment under load*, not raw tok/s: a server emitting 1000
tok/s where every interactive request waited 4s is worse than one at
800 tok/s inside its latency targets. This module owns that layer:

  * **targets** — per-class latency SLOs (``--slo-targets
    "interactive=ttft:0.1,e2e:2;standard=..."``), parsed and validated
    at startup exactly like ``--fault-plan`` (a malformed spec is a
    loud CLI error, never a silently-default serving run). Classes not
    named keep the defaults below.
  * **attainment** — the fraction of retired requests that met BOTH
    their class targets, over rolling 1m/10m windows, exported as
    ``cake_slo_attainment{class,window}`` gauges.
  * **burn-rate counters** — ``cake_slo_requests_total{class}`` and
    ``cake_slo_misses_total{class,slo}`` (slo = ttft | e2e | failed):
    ``rate(misses)/rate(requests)`` against an error budget is the
    standard multi-window burn-rate alert, and counters survive scrape
    gaps where gauges alias.
  * **goodput** — ``cake_goodput_tokens_total{class}``: tokens counted
    ONLY from requests that met their class SLO, alongside the raw
    ``cake_engine_tokens_generated_total``. goodput <= raw always;
    the gap is throughput the SLO says nobody should count.

The accountant is fed from ONE seam — ``RequestTracer.finish`` — so
every retire path lands here with the trace record's OWN latencies:
TTFT/e2e measured from the ORIGINAL admission, surviving preemption
requeues (a requeue must never reset the clock). It also feeds the
autotune controller (``ttft_p99_by_class()``, ``attainment_by_class()``)
and the sentinel's attainment detectors.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

from cake_tpu_torch.obs import metrics as _m
from cake_tpu_torch.sched.classes import PRIORITY_CLASSES

# rolling attainment windows: (label, seconds). 1m answers "are we
# burning budget NOW", 10m smooths deploy/tier blips — the classic
# short+long burn-rate pair.
WINDOWS = (("1m", 60.0), ("10m", 600.0))

SLO_ATTAINMENT = _m.gauge(
    "cake_slo_attainment",
    "Fraction of retired requests that met their class SLO targets "
    "(--slo-targets) over a rolling window (1m | 10m); unset until "
    "the first retirement lands in the window",
    labelnames=("class", "window"))
SLO_REQUESTS = _m.counter(
    "cake_slo_requests_total",
    "Requests evaluated against their class SLO targets (retired "
    "requests plus terminal failures; the burn-rate denominator)",
    labelnames=("class",))
SLO_MISSES = _m.counter(
    "cake_slo_misses_total",
    "SLO misses by class and violated target (ttft | e2e | failed = "
    "the request errored terminally; the burn-rate numerator)",
    labelnames=("class", "slo"))
GOODPUT_TOKENS = _m.counter(
    "cake_goodput_tokens_total",
    "Tokens generated by requests that MET their class SLO "
    "(--slo-targets) — goodput, vs the raw "
    "cake_engine_tokens_generated_total; the gap is throughput spent "
    "outside the latency targets",
    labelnames=("class",))


@dataclass(frozen=True)
class SLOTarget:
    """One class's latency targets (seconds). None = not enforced."""

    ttft_s: Optional[float] = None
    e2e_s: Optional[float] = None

    def met(self, ttft_s: Optional[float],
            e2e_s: Optional[float]) -> Dict[str, bool]:
        """Per-target verdicts. An unmeasured latency (None — e.g. a
        zero-token retirement with no first-token span) passes: the
        accountant judges what was measured, never guesses."""
        out = {}
        if self.ttft_s is not None:
            out["ttft"] = ttft_s is None or ttft_s <= self.ttft_s
        if self.e2e_s is not None:
            out["e2e"] = e2e_s is None or e2e_s <= self.e2e_s
        return out


# defaults: loose enough that an unconfigured CPU smoke run is not
# wall-to-wall misses, tight enough that saturation shows — operators
# set real targets via --slo-targets
DEFAULT_TARGETS: Dict[str, SLOTarget] = {
    "interactive": SLOTarget(ttft_s=1.0, e2e_s=30.0),
    "standard": SLOTarget(ttft_s=5.0, e2e_s=120.0),
    "batch": SLOTarget(ttft_s=60.0, e2e_s=600.0),
}

_METRIC_KEYS = ("ttft", "e2e")


def parse_slo_targets(spec: Optional[str]) -> Dict[str, SLOTarget]:
    """Parse ``--slo-targets "class=metric:seconds[,metric:seconds]
    [;class=...]"`` into a full per-class target map (unnamed classes
    keep DEFAULT_TARGETS). Malformed specs raise ValueError with the
    offending fragment named — Args.validate calls this at startup so
    the error is a CLI error, not a mid-serving surprise."""
    out = dict(DEFAULT_TARGETS)
    if not spec:
        return out
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"--slo-targets: {part!r} is not class=metric:seconds")
        cls, _, body = part.partition("=")
        cls = cls.strip()
        if cls not in PRIORITY_CLASSES:
            raise ValueError(
                f"--slo-targets: unknown class {cls!r} (choose one of "
                f"{', '.join(PRIORITY_CLASSES)})")
        vals: Dict[str, float] = {}
        for item in body.split(","):
            item = item.strip()
            if ":" not in item:
                raise ValueError(
                    f"--slo-targets: {item!r} is not metric:seconds")
            key, _, sval = item.partition(":")
            key = key.strip()
            if key not in _METRIC_KEYS:
                raise ValueError(
                    f"--slo-targets: unknown target {key!r} (choose "
                    f"{' or '.join(_METRIC_KEYS)})")
            try:
                v = float(sval)
            except ValueError:
                raise ValueError(
                    f"--slo-targets: {sval!r} is not a number of "
                    "seconds")
            if v <= 0:
                raise ValueError(
                    f"--slo-targets: {key}:{sval} must be > 0 seconds")
            if key in vals:
                raise ValueError(
                    f"--slo-targets: duplicate {key!r} for class "
                    f"{cls!r}")
            vals[key] = v
        # a named class replaces its defaults wholesale: naming only
        # ttft means "no e2e target", not "keep the default e2e" —
        # partial overrides would make specs unreadable
        out[cls] = SLOTarget(ttft_s=vals.get("ttft"),
                             e2e_s=vals.get("e2e"))
    return out


class SLOAccountant:
    """Rolling SLO attainment + goodput accounting, one per engine.

    observe() runs on the engine thread (via RequestTracer.finish);
    the readers (metrics scrape, autotune signal gather, bench) run on
    other threads — one lock covers the window deques. Process-global
    counters above accumulate across engines (like every cake_*
    counter); the per-instance counters (requests/misses/goodput_tokens)
    are the per-engine view bench phases diff."""

    def __init__(self, targets: Optional[Dict[str, SLOTarget]] = None,
                 clock=time.monotonic, observe_metrics: bool = True):
        self.targets = dict(targets or DEFAULT_TARGETS)
        self._clock = clock
        self._observe = observe_metrics
        self._mu = threading.Lock()
        horizon = max(w for _, w in WINDOWS)
        self._horizon = horizon
        # class -> deque of (t, met_all, ttft_s, tokens)
        self._window: Dict[str, deque] = {
            c: deque() for c in self.targets}
        # per-instance totals (bench phases diff these; the module
        # counters are process-global across engines)
        self.requests: Dict[str, int] = {c: 0 for c in self.targets}
        self.misses: Dict[str, int] = {c: 0 for c in self.targets}
        self.goodput_tokens: Dict[str, int] = {
            c: 0 for c in self.targets}

    # -- ingest (engine thread, via RequestTracer.finish) -----------------

    def observe(self, cls: str, ttft_s: Optional[float],
                e2e_s: Optional[float], tokens: int,
                failed: bool = False,
                now: Optional[float] = None) -> bool:
        """Account one finished request; returns whether it met its
        class SLO (failed=True is an unconditional miss — a poisoned
        or errored request attained nothing)."""
        target = self.targets.get(cls)
        if target is None:        # unknown class: never raises into
            return True           # the engine loop
        now = self._clock() if now is None else now
        verdicts = {} if failed else target.met(ttft_s, e2e_s)
        met = not failed and all(verdicts.values())
        with self._mu:
            dq = self._window[cls]
            dq.append((now, met, ttft_s, int(tokens)))
            self._prune(dq, now)
            self.requests[cls] += 1
            if not met:
                self.misses[cls] += 1
            if met:
                self.goodput_tokens[cls] += int(tokens)
        if self._observe:
            SLO_REQUESTS.labels(cls).inc()
            if failed:
                SLO_MISSES.labels(cls, "failed").inc()
            else:
                for key, ok in verdicts.items():
                    if not ok:
                        SLO_MISSES.labels(cls, key).inc()
            if met and tokens:
                GOODPUT_TOKENS.labels(cls).inc(int(tokens))
        # the attainment GAUGES refresh at scrape time only
        # (refresh_gauges via ApiServer.metrics): Prometheus reads
        # gauges at scrape anyway, and recomputing both windows here
        # would put O(window-length) work on the engine's retire path
        # at every retirement
        return met

    def _prune(self, dq: deque, now: float) -> None:
        while dq and now - dq[0][0] > self._horizon:
            dq.popleft()

    # -- read (any thread) -------------------------------------------------

    def attainment_by_class(self, window: str = "1m",
                            now: Optional[float] = None
                            ) -> Dict[str, float]:
        """class -> attained fraction over the window; classes with no
        finished request in the window are absent (no data is not 1.0
        and not 0.0 — the gauge stays at its last value, the signal
        consumer sees the class missing)."""
        span = dict(WINDOWS)[window]
        now = self._clock() if now is None else now
        out: Dict[str, float] = {}
        with self._mu:
            for cls, dq in self._window.items():
                ent = [(t, met) for t, met, _tt, _tk in dq
                       if now - t <= span]
                if ent:
                    out[cls] = sum(1 for _t, met in ent if met) / len(ent)
        return out

    def ttft_p99_by_class(self, window: str = "1m",
                          now: Optional[float] = None
                          ) -> Dict[str, float]:
        """class -> TTFT p99 seconds over the window (measured TTFTs
        only) — the autotune controller's quality signal."""
        span = dict(WINDOWS)[window]
        now = self._clock() if now is None else now
        out: Dict[str, float] = {}
        with self._mu:
            for cls, dq in self._window.items():
                xs = sorted(tt for t, _met, tt, _tk in dq
                            if tt is not None and now - t <= span)
                if xs:
                    out[cls] = xs[min(len(xs) - 1,
                                      int(0.99 * len(xs)))]
        return out

    def refresh_gauges(self, now: Optional[float] = None) -> None:
        """Scrape-time refresh of cake_slo_attainment (THE gauge write
        site — one window pass per scrape, nothing on the retire
        path). Classes with no data in a window keep their last value
        (a gauge with no history simply has no sample)."""
        if not self._observe:
            return
        for label, _span in WINDOWS:
            for cls, v in self.attainment_by_class(label,
                                                   now=now).items():
                SLO_ATTAINMENT.labels(cls, label).set(round(v, 4))

    def snapshot(self) -> Dict:
        """Introspection block for /api/v1/health and bench tiers."""
        with self._mu:
            reqs = dict(self.requests)
            misses = dict(self.misses)
            good = dict(self.goodput_tokens)
        return {
            "targets": {c: {"ttft_s": t.ttft_s, "e2e_s": t.e2e_s}
                        for c, t in self.targets.items()},
            "requests": reqs,
            "misses": misses,
            "goodput_tokens": good,
            "attainment_1m": {c: round(v, 4) for c, v in
                              self.attainment_by_class("1m").items()},
            "attainment_10m": {c: round(v, 4) for c, v in
                               self.attainment_by_class("10m").items()},
        }
