"""Runtime half of the fault plane: a seeded, thread-safe injector.

Counterpart of `cake_tpu/faults/injector.py`, copied as it is (the
`cake_fault_injections_total{site}` family keeps JAX's name and help, and
the `fault_injected` event goes to the port's bus).

`FaultInjector` evaluates a parsed `FaultPlan` at the named sites
threaded through the serving stack (see plan.SITES). Call sites do

    if self._faults is not None:
        self._faults.check("engine.decode", step=self.stats.steps)

so a disabled plane (no ``--fault-plan``) costs exactly one attribute
test per site — the injector object does not even exist. Determinism:
every rule owns its OWN ``random.Random`` seeded from (plan seed, rule
index), so probabilistic rules fire on the same matching-call indices
regardless of what other sites or rules do around them — same plan +
same seed + same per-site call sequence => same injections, which is
what makes a chaos run reproducible from its command line.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from cake_tpu_torch.faults.plan import (
    ABORT_EXIT_CODE, FaultPlan, FaultRule, InjectedOOM,
    InjectedTransient, InjectedWedge,
)
from cake_tpu_torch.obs import metrics as obs_metrics

_INJECTIONS = obs_metrics.counter(
    "cake_fault_injections_total",
    "Faults injected by the --fault-plan chaos plane, by site "
    "(cake_tpu/faults; zero without a plan)",
    labelnames=("site",))

# bounded per-injector injection log (site, kind, matching-call index):
# enough for a bench tier or health dump to show what fired, without an
# unbounded list on a long-lived p= rule
_LOG_CAP = 256


@dataclass
class _RuleState:
    """Mutable runtime state for one plan rule."""

    rule: FaultRule
    rng: random.Random
    calls: int = 0      # matching calls seen (post match_len filter)
    fired: int = 0      # injections performed (capped at rule.times)


@dataclass
class InjectionRecord:
    site: str
    kind: str
    call: int           # 1-based matching-call index that fired
    step: Optional[int] = None


@dataclass
class FaultInjector:
    """Evaluates a FaultPlan at the serving stack's named sites."""

    plan: FaultPlan
    records: List[InjectionRecord] = field(default_factory=list)
    # obs/events.EventBus (None = no bus attached — same one-attribute-
    # test discipline as the call sites' own `_faults is not None`):
    # every firing publishes a fault_injected event so chaos shows up
    # on the same timeline as what it broke
    events: Optional[object] = None
    # cakelint guards discipline for the optional bus above
    OPTIONAL_PLANES = ("events",)

    def __post_init__(self):
        self._lock = threading.Lock()
        self._by_site: Dict[str, List[_RuleState]] = {}
        for i, rule in enumerate(self.plan.rules):
            st = _RuleState(
                rule=rule,
                # independent stream per rule: other rules/sites never
                # consume from it, so p= firings are reproducible
                rng=random.Random((self.plan.seed << 20) ^ (i + 1)))
            self._by_site.setdefault(rule.site, []).append(st)
        self.total = 0
        self.by_site: Dict[str, int] = {}

    def check(self, site: str, *, step: Optional[int] = None,
              n_tokens: Optional[int] = None) -> None:
        """Raise the planned fault if a rule for `site` fires now.

        step: the engine's step counter (for step= triggers);
        n_tokens: call context for match_len= filtering (e.g. the
        token count of the prefill being dispatched)."""
        states = self._by_site.get(site)
        if not states:
            return
        fire: Optional[_RuleState] = None
        call = 0
        with self._lock:
            for st in states:
                r = st.rule
                if st.fired >= r.times:
                    continue
                if r.match_len is not None and n_tokens != r.match_len:
                    continue
                # EVERY active rule counts every matching call — even
                # when an earlier rule already claimed this one — so a
                # second nth= rule at the same site still fires on the
                # call its spec names, and p= streams stay indexed by
                # matching-call number. Only the first hit (plan
                # order) raises; a later rule whose trigger hits the
                # same call simply does not fire it.
                st.calls += 1
                if r.trigger == "always":
                    hit = True
                elif r.trigger == "nth":
                    hit = st.calls == int(r.value)
                elif r.trigger == "step":
                    hit = step is not None and step >= int(r.value)
                else:  # p
                    hit = st.rng.random() < r.value
                if hit and fire is None:
                    st.fired += 1
                    fire, call = st, st.calls
            if fire is not None:
                self.total += 1
                self.by_site[site] = self.by_site.get(site, 0) + 1
                if len(self.records) < _LOG_CAP:
                    self.records.append(InjectionRecord(
                        site=site, kind=fire.rule.error, call=call,
                        step=step))
        if fire is None:
            return
        _INJECTIONS.labels(site=site).inc()
        if self.events is not None:
            self.events.publish("fault_injected", site=site,
                                kind=fire.rule.error, call=call,
                                step=step)
        kind = fire.rule.error
        if kind == "abort":
            # staged kill -9: die NOW, with no atexit/flush courtesy —
            # only bytes already written to the OS survive, which is
            # exactly the state a crash drill must recover from. The
            # event/metric above may be lost with the process; the log
            # line below is best-effort evidence for the drill driver.
            import logging
            import os
            logging.getLogger(__name__).error(
                "injected abort at %s (call %d, step %s): os._exit(%d)",
                site, call, step, ABORT_EXIT_CODE)
            os._exit(ABORT_EXIT_CODE)
        if kind == "oom":
            raise InjectedOOM(site)
        if kind == "wedge":
            # the compressed form of a hung device/tunnel: hold the
            # calling thread (outside the lock — other sites must keep
            # evaluating), then surface as a failure
            time.sleep(fire.rule.secs)
            raise InjectedWedge(site, f"held {fire.rule.secs:g}s")
        raise InjectedTransient(site)

    def describe(self) -> dict:
        """Health-endpoint view of the plane (plan + what fired)."""
        with self._lock:
            return {
                "plan": self.plan.describe(),
                "injections_total": self.total,
                "injections_by_site": dict(self.by_site),
            }


def build_injector(spec) -> Optional[FaultInjector]:
    """--fault-plan string (or a pre-parsed FaultPlan) -> injector;
    None/empty spec -> None, and every call site's `is not None` guard
    keeps the disabled plane at zero per-step work."""
    if spec is None:
        return None
    plan = spec if isinstance(spec, FaultPlan) else FaultPlan.parse(spec)
    if plan is None:
        return None
    return FaultInjector(plan)
