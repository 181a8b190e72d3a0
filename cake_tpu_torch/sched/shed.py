"""Per-class load shedding with an honest computed Retry-After.

Counterpart of `cake_tpu/sched/shed.py`, host-only and copied as it is.

The engine's only overload response used to be a binary queue-full
error. The shed controller replaces that with graceful degradation:

  * the *service rate* is measured from request retirements over a
    sliding window (the same signal the flight recorder, obs/steps.py,
    exposes per step, aggregated to requests/s);
  * a new arrival's *estimated queue wait* is ``depth_ahead / rate``;
  * while the estimate is inside the class's ``target_wait_s`` SLO the
    request admits with probability 1; beyond it, admission probability
    falls as ``target / est_wait`` — interactive traffic (tight target)
    sheds first and hardest, batch (loose target) keeps queuing;
  * a shed request carries ``retry_after_s = est_wait - target``: the
    time the backlog needs to drain back inside the SLO at the measured
    rate — the API surfaces it as HTTP 429 + ``Retry-After`` instead of
    a generic queue-full error.

Cold start is honest too: with no measured completions yet there is no
basis to refuse, so everything admits (the queue-full bound still
backstops).
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from cake_tpu_torch.sched.classes import SchedConfig, validate_priority


class ShedError(Exception):
    """Request rejected by load shedding (HTTP 429). retry_after is the
    computed seconds until the class's backlog drains inside its SLO."""

    def __init__(self, priority: str = "standard",
                 retry_after: float = 1.0,
                 est_wait_s: Optional[float] = None):
        super().__init__(
            f"request shed: estimated {priority!r} queue wait "
            + (f"{est_wait_s:.1f}s " if est_wait_s is not None else "")
            + f"exceeds the class SLO (retry in {retry_after:.0f}s)")
        self.priority = priority
        self.retry_after = retry_after
        self.est_wait_s = est_wait_s


@dataclass(frozen=True)
class ShedDecision:
    admit: bool
    retry_after_s: float
    probability: float
    est_wait_s: Optional[float]


class ShedController:
    """Admission-probability controller fed by retirement timestamps.

    rng/clock are injectable so tests (and multi-process determinism
    experiments) can drive the decision deterministically.
    """

    def __init__(self, config: Optional[SchedConfig] = None,
                 rng: Optional[random.Random] = None, clock=None):
        self.config = config or SchedConfig()
        self._rng = rng or random.Random(0x5ED)
        self._clock = clock or time.monotonic
        self._mu = threading.Lock()
        self._retires: deque = deque(maxlen=512)

    def observe_retire(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        with self._mu:
            self._retires.append(now)

    def service_rate(self, now: Optional[float] = None
                     ) -> Optional[float]:
        """Measured completions/s over the sliding window, or None when
        there is not yet enough signal to estimate."""
        now = self._clock() if now is None else now
        window = self.config.shed_window_s
        with self._mu:
            xs = [t for t in self._retires if now - t <= window]
        if len(xs) < 2:
            return None
        span = max(now - xs[0], 1e-6)
        return len(xs) / span

    def decide(self, priority: str, depth_ahead: int,
               now: Optional[float] = None) -> ShedDecision:
        cls = validate_priority(priority)
        now = self._clock() if now is None else now
        target = self.config.target_wait_s(cls)
        rate = self.service_rate(now)
        if rate is None or rate <= 0.0:
            # no measured signal: admitting is the only honest choice
            return ShedDecision(True, 1.0, 1.0, None)
        est = depth_ahead / rate
        if est <= target:
            return ShedDecision(True, 1.0, 1.0, est)
        p = max(0.0, min(1.0, target / est))
        retry = max(1.0, est - target)
        return ShedDecision(self._rng.random() < p, retry, p, est)

    def estimate_retry_after(self, priority: str, depth_ahead: int,
                             now: Optional[float] = None) -> float:
        """Retry-After for a hard queue-full rejection: same backlog
        math as decide(), with a 1s floor when the rate is unknown."""
        d = self.decide(validate_priority(priority), depth_ahead, now)
        return d.retry_after_s if d.est_wait_s is not None else 1.0
