"""Online autotune controller: sliding-window signals -> switch/rollback.

Counterpart of `cake_tpu/autotune/controller.py`, copied as it is
(host-only). The engine thread drives it between iterations
(engine._autotune_tick): every ``interval_s`` it gathers one
``AutotuneSignals`` sample from the telemetry the engine already keeps —
step MFU / HBM utilization (obs/steps flight recorder), page-pool
occupancy, per-class queue depth and shed rate (sched/), arrival TTFT
percentiles (obs/tracing) — and asks ``decide()`` whether to move. The
controller is pure host-side state (no device work, no threads of its
own), so tests drive it on synthetic signal streams with a fake clock.

Decision discipline (the reason this is safe to run against live load):

  * **hysteresis** — a target config must win ``hold`` CONSECUTIVE
    samples before a switch is proposed; one noisy window moves nothing.
  * **cooldown** — at least ``cooldown_s`` between switches; a switch
    pays a fold-and-re-prefill of every in-flight stream, so flapping
    is strictly worse than either config.
  * **rollback guard** — after an autonomous switch the controller
    compares the measured service rate over the next
    ``rollback_window`` samples against the pre-switch window; if it
    dropped below ``rollback_frac`` of the old regime's rate, it
    reverts ONCE and pins the offending config (never re-proposed).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

from cake_tpu_torch.autotune.search import PolicyTable
from cake_tpu_torch.autotune.space import EngineConfig, config_key
from cake_tpu_torch.obs import metrics as obs_metrics

# the cake_autotune_* families, with the JAX package's names and help
SWITCHES = obs_metrics.counter(
    "cake_autotune_switches_total",
    "Live engine config switches, by reason (auto = policy-driven, "
    "manual = POST /api/v1/autotune, rollback = the guard reverting a "
    "switch whose measured service rate regressed)",
    labelnames=("reason",))
ROLLBACKS = obs_metrics.counter(
    "cake_autotune_rollbacks_total",
    "Autonomous switches reverted by the rollback guard (the offending "
    "config is pinned and never re-proposed)")
SWITCH_SECONDS = obs_metrics.histogram(
    "cake_autotune_switch_seconds",
    "Wall seconds for one live config switch: fold every in-flight "
    "stream into its prompt, rebuild step fns + KV pool, requeue")
CONFIG_INFO = obs_metrics.gauge(
    "cake_autotune_config_info",
    "Live effective engine config as key=value info labels (value 1 "
    "for the current config's pairs, 0 for superseded ones)",
    labelnames=("key",))


def set_config_info(cfg: EngineConfig) -> None:
    """Publish the live config through cake_autotune_config_info: each
    knob becomes a ``key="name=value"`` child set to 1; children from a
    superseded config drop to 0 (the Prometheus info-metric pattern —
    a scrape always shows exactly one live value per knob)."""
    live = {f"{k}={v}" for k, v in cfg.to_dict().items()}
    for (val,), _ in CONFIG_INFO.samples().items():
        if val not in live:
            CONFIG_INFO.labels(key=val).set(0)
    for val in sorted(live):
        CONFIG_INFO.labels(key=val).set(1)


@dataclass
class AutotuneSignals:
    """One sliding-window sample of the engine's load/health signals."""

    t: float
    offered_rps: float = 0.0      # request arrivals per second
    service_tps: float = 0.0      # generated tokens per second
    completed_rps: float = 0.0    # retirements per second
    queue_depth: int = 0
    queue_depth_by_class: Dict[str, int] = field(default_factory=dict)
    mfu: float = 0.0
    hbm_util: float = 0.0
    pages_in_use_frac: float = 0.0
    shed_rps: float = 0.0
    ttft_p99_s: Optional[float] = None
    # quality signals (obs/slo.py, via the engine's SLO accountant +
    # scheduler): per-class TTFT p99, per-class rolling SLO attainment
    # and the scheduler's aging pressure — what lets the policy lookup
    # and the rollback guard key on quality, not just offered rps
    ttft_p99_by_class: Dict[str, float] = field(default_factory=dict)
    attainment: Dict[str, float] = field(default_factory=dict)
    queue_pressure: float = 0.0

    def min_attainment(self) -> Optional[float]:
        """Worst-class attainment this sample, None without data —
        the rollback guard's scalar quality verdict input."""
        return min(self.attainment.values()) if self.attainment else None

    def to_dict(self) -> dict:
        out = {
            "t": round(self.t, 3),
            "offered_rps": round(self.offered_rps, 3),
            "service_tps": round(self.service_tps, 3),
            "completed_rps": round(self.completed_rps, 3),
            "queue_depth": self.queue_depth,
            "mfu": round(self.mfu, 4),
            "hbm_util": round(self.hbm_util, 4),
            "pages_in_use_frac": round(self.pages_in_use_frac, 4),
            "shed_rps": round(self.shed_rps, 3),
        }
        if self.queue_depth_by_class:
            out["queue_depth_by_class"] = dict(self.queue_depth_by_class)
        if self.ttft_p99_s is not None:
            out["ttft_p99_s"] = round(self.ttft_p99_s, 6)
        if self.ttft_p99_by_class:
            out["ttft_p99_by_class"] = {
                c: round(v, 6) for c, v in self.ttft_p99_by_class.items()}
        if self.attainment:
            out["attainment"] = {
                c: round(v, 4) for c, v in self.attainment.items()}
        if self.queue_pressure:
            out["queue_pressure"] = round(self.queue_pressure, 4)
        return out


@dataclass
class ControllerConfig:
    interval_s: float = 2.0       # engine sampling cadence
    window: int = 5               # samples per sliding decision window
    hold: int = 2                 # hysteresis: consecutive wins to switch
    cooldown_s: float = 30.0      # min seconds between switches
    rollback_window: int = 3      # post-switch samples before the verdict
    rollback_frac: float = 0.7    # revert when post < frac * pre rate
    log_size: int = 64            # retained decision-log entries
    # pool-pressure escalation: window-mean pages_in_use_frac at or
    # above this proposes narrowing an int8 pool to int4 (the one
    # switch direction that frees page capacity without shrinking the
    # pool; the widening direction stays illegal — space.switch_guard)
    page_pressure_frac: float = 0.95


class AutotuneController:
    """Policy-driven switch/rollback decisions over a signal window.

    Thread model: ``decide``/``on_switched``/``pin`` run on the engine
    thread; ``state()`` is read by API handler threads — one lock
    covers the mutable window/log."""

    # cakelint guards discipline: the one-shot rollback guard is only
    # armed across a policy switch — every dotted use is None-guarded
    OPTIONAL_PLANES = ("_guard",)

    def __init__(self, policy: PolicyTable, current: EngineConfig,
                 config: Optional[ControllerConfig] = None,
                 now_fn: Callable[[], float] = time.monotonic):
        self.policy = policy
        self.config = config or ControllerConfig()
        self._now = now_fn
        self._mu = threading.Lock()
        self._current = current
        self._window: deque = deque(maxlen=max(1, self.config.window))
        self._log: deque = deque(maxlen=max(1, self.config.log_size))
        self._target_key: Optional[tuple] = None
        self._streak = 0
        self._last_switch_t: Optional[float] = None
        self._pinned: set = set()
        # armed rollback guard: (previous config, pre-switch rate,
        # pre-switch worst-class attainment (None without SLO data),
        # samples seen since the switch)
        self._guard: Optional[tuple] = None
        # sentinel fusion (--sentinel-act, obs/actions.py): active
        # config-plane anomalies hold new policy switches; an anomaly
        # that fires while the guard is armed pins the rollback verdict
        # immediately ((kind, cause) consumed by the next decide())
        self._anomaly_active: Dict[str, Dict] = {}
        self._anomaly_rollback: Optional[tuple] = None

    # -- decisions (engine thread) ----------------------------------------

    def window_service_tps(self) -> float:
        with self._mu:
            xs = [s.service_tps for s in self._window]
        return sum(xs) / len(xs) if xs else 0.0

    def window_offered_rps(self) -> float:
        with self._mu:
            xs = [s.offered_rps for s in self._window]
        return sum(xs) / len(xs) if xs else 0.0

    def window_quality(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        """(ttft_p99_by_class, attainment) aggregated over the window:
        per class the WORST value seen — max TTFT p99, min attainment —
        so one bad-but-real sample inside the window keeps escalating a
        quality-guarded lookup (hysteresis, not the aggregate, is the
        noise filter)."""
        ttft: Dict[str, float] = {}
        attain: Dict[str, float] = {}
        with self._mu:
            samples = list(self._window)
        for s in samples:
            for c, v in s.ttft_p99_by_class.items():
                ttft[c] = max(ttft.get(c, 0.0), v)
            for c, v in s.attainment.items():
                attain[c] = min(attain.get(c, 1.0), v)
        return ttft, attain

    def _window_page_pressure(self) -> float:
        """Mean page-pool occupancy fraction over the window — the
        pool-pressure escalation's trigger signal."""
        with self._mu:
            xs = [s.pages_in_use_frac for s in self._window]
        return sum(xs) / len(xs) if xs else 0.0

    def _window_min_attainment(self) -> Optional[float]:
        """Mean worst-class attainment over the window's samples that
        carry attainment data (None without any) — the pre/post series
        the rollback guard compares."""
        with self._mu:
            xs = [a for a in (s.min_attainment() for s in self._window)
                  if a is not None]
        return sum(xs) / len(xs) if xs else None

    def decide(self, sig: AutotuneSignals
               ) -> Optional[Tuple[EngineConfig, str]]:
        """Ingest one sample; return (target config, reason) when the
        engine should switch now, else None. reason is "auto" for a
        policy-driven move and "rollback" for the guard reverting."""
        with self._mu:
            self._window.append(sig)
        rb = self._check_rollback(sig)
        if rb is not None:
            return rb, "rollback"
        now = sig.t
        cfg = self.config
        if (self._last_switch_t is not None
                and now - self._last_switch_t < cfg.cooldown_s):
            return None
        if self._guard is not None:
            return None  # verdict pending: no new move until it rules
        with self._mu:
            if self._anomaly_active:
                # anomaly hold (--sentinel-act): a recompile storm or
                # step-time regression is live — this window's signals
                # indict the environment, not a regime boundary; no
                # new policy move until the sentinel clears
                return None
        ttft_by_cls, attain = self.window_quality()
        target = self.policy.lookup(self.window_offered_rps(),
                                    ttft_p99_by_class=ttft_by_cls,
                                    attainment=attain)
        # pool-pressure escalation (takes precedence over the fitted
        # table — a starving pool throttles every config the table
        # could name): an int8 pool running at >= page_pressure_frac
        # occupancy over the window proposes the SAME point at int4,
        # doubling page capacity in place. int4 is terminal: there is
        # no narrower pool, and widening back is gated by switch_guard,
        # so the escalation converges. Flows through the normal
        # hysteresis + pin + rollback-guard machinery.
        if (self._current.paged and self._current.kv_dtype == "int8"
                and self._window_page_pressure()
                >= cfg.page_pressure_frac):
            target = replace(self._current, kv_dtype="int4")
        tkey = config_key(target)
        if tkey == config_key(self._current) or tkey in self._pinned:
            self._target_key, self._streak = None, 0
            return None
        if tkey == self._target_key:
            self._streak += 1
        else:
            self._target_key, self._streak = tkey, 1
        if self._streak < cfg.hold:
            return None
        return target, "auto"

    def _check_rollback(self, sig: AutotuneSignals
                        ) -> Optional[EngineConfig]:
        if self._guard is None:
            with self._mu:
                # a rollback proposed in the race window after the
                # guard ruled has nothing left to revert: drop it
                self._anomaly_rollback = None
            return None
        with self._mu:
            pinned_by = self._anomaly_rollback
            self._anomaly_rollback = None
        if pinned_by is not None:
            # anomaly evidence pins the verdict NOW (--sentinel-act):
            # a recompile storm / step-time regression right after an
            # autonomous switch indicts the new config — revert without
            # waiting out the rollback_window timer, and pin it
            kind, cause = pinned_by
            prev_cfg, pre_rate, _pre_attain, _seen = self._guard
            bad = self._current
            self._guard = None
            self._pinned.add(config_key(bad))
            self._note("rollback", frm=bad, to=prev_cfg,
                       pre_tps=pre_rate, cause=f"anomaly:{kind}",
                       anomaly=cause)
            return prev_cfg
        prev_cfg, pre_rate, pre_attain, seen = self._guard
        seen += 1
        self._guard = (prev_cfg, pre_rate, pre_attain, seen)
        if seen < self.config.rollback_window:
            return None
        with self._mu:
            post = list(self._window)[-self.config.rollback_window:]
        post_rate = (sum(s.service_tps for s in post) / len(post)
                     if post else 0.0)
        attains = [a for a in (s.min_attainment() for s in post)
                   if a is not None]
        post_attain = sum(attains) / len(attains) if attains else None
        bad = self._current
        self._guard = None
        rate_bad = (pre_rate > 0
                    and post_rate < self.config.rollback_frac * pre_rate)
        # quality verdict (obs/slo.py attainment riding the signals):
        # a switch that kept tok/s but collapsed SLO attainment — e.g.
        # bigger batches starving interactive TTFT — regressed the
        # thing serving exists for, and must revert just the same
        attain_bad = (pre_attain is not None and post_attain is not None
                      and pre_attain > 0
                      and post_attain
                      < self.config.rollback_frac * pre_attain)
        if rate_bad or attain_bad:
            # revert ONCE and pin: the fitted policy was wrong online
            # for this regime — never re-propose the offending config
            self._pinned.add(config_key(bad))
            self._note("rollback", frm=bad, to=prev_cfg,
                       pre_tps=pre_rate, post_tps=post_rate,
                       pre_attainment=pre_attain,
                       post_attainment=post_attain,
                       cause=("attainment" if attain_bad and not rate_bad
                              else "service_rate"))
            return prev_cfg
        self._note("accepted", frm=prev_cfg, to=bad,
                   pre_tps=pre_rate, post_tps=post_rate,
                   pre_attainment=pre_attain,
                   post_attainment=post_attain)
        return None

    def on_switched(self, new: EngineConfig, old: EngineConfig,
                    pre_rate: float, reason: str) -> None:
        """The engine completed a switch: update current, start the
        cooldown, and (for autonomous moves only) arm the rollback
        guard with the old regime's measured rate. Rollback and manual
        switches arm nothing — the guard fires exactly once."""
        self._current = new
        self._last_switch_t = self._now()
        self._target_key, self._streak = None, 0
        if reason == "auto":
            # the guard compares service rate AND worst-class SLO
            # attainment against the old regime's window
            self._guard = (old, pre_rate,
                           self._window_min_attainment(), 0)
        else:
            self._guard = None
        self._note("switch", frm=old, to=new, reason=reason,
                   pre_tps=pre_rate)

    def pin(self, cfg: EngineConfig, why: str = "switch failed") -> None:
        """Ban a config (e.g. the engine refused the switch because an
        in-flight stream cannot fit its pool)."""
        self._pinned.add(config_key(cfg))
        self._note("pinned", to=cfg, reason=why)

    # -- sentinel fusion (any thread; obs/actions.py) ----------------------

    @property
    def guard_armed(self) -> bool:
        return self._guard is not None

    def note_anomaly(self, kind: str, state: str, cause: Dict,
                     *, allow_switch: bool = True) -> Optional[str]:
        """A sentinel transition as a first-class controller signal
        (--sentinel-act). Thread-safe: called from the sentinel thread;
        it only flips host-side intent that decide() consumes on the
        engine thread.

        Returns the proposal this transition produced: ``"rollback"``
        (the post-switch guard is armed and this anomaly pins its
        verdict — the next decide() reverts through the existing
        reconfigure() seam), ``"hold"`` (no new policy switches while
        the anomaly is active), ``"resume"`` (the last active anomaly
        cleared — normal deciding resumes), or None (a clear with other
        anomalies still active). `allow_switch=False` (the action
        plane's rate bound) downgrades a would-be rollback to a plain
        hold."""
        if state not in ("fired", "cleared"):
            raise ValueError(f"state {state!r} must be fired or cleared")
        with self._mu:
            if state == "fired":
                self._anomaly_active[kind] = dict(cause)
                if (self._guard is not None and allow_switch
                        and self._anomaly_rollback is None):
                    self._anomaly_rollback = (kind, dict(cause))
                    proposal = "rollback"
                else:
                    proposal = "hold"
            else:
                self._anomaly_active.pop(kind, None)
                proposal = ("resume" if not self._anomaly_active
                            else None)
        if proposal is not None:
            self._note("anomaly", kind=kind, state=state,
                       proposal=proposal)
        return proposal

    # -- introspection (any thread) ---------------------------------------

    def _note(self, action: str, frm: Optional[EngineConfig] = None,
              to: Optional[EngineConfig] = None, **fields) -> None:
        entry = {"t": round(time.time(), 3), "action": action, **fields}
        if frm is not None:
            entry["from"] = frm.to_dict()
        if to is not None:
            entry["to"] = to.to_dict()
        with self._mu:
            self._log.append(entry)

    def decision_log(self) -> List[dict]:
        with self._mu:
            return list(self._log)

    def state(self) -> dict:
        with self._mu:
            window = [s.to_dict() for s in self._window]
            log = list(self._log)
            anomaly_hold = sorted(self._anomaly_active)
        return {
            "current": self._current.to_dict(),
            "anomaly_hold": anomaly_hold,
            "window": window,
            "offered_rps": round(self.window_offered_rps(), 3),
            "service_tps": round(self.window_service_tps(), 3),
            "cooldown_s": self.config.cooldown_s,
            "hold": self.config.hold,
            "pinned": len(self._pinned),
            "guard_armed": self._guard is not None,
            "decisions": log,
        }
