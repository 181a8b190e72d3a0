"""Gamma tuner: the closed loop over paged speculative acceptance.

Counterpart of `cake_tpu/autotune/spec.py`, copied as it is (host-only).
The spec plane (spec/state.py) feeds this controller the
engine-wide acceptance EMA after every batched round; the tuner's one
autonomous move is NARROWING — when acceptance stays under the shrink
threshold after warmup it halves the live gamma (gamma = max(1,
gamma // 2)), trading speculative depth for fewer wasted draft steps.
It never grows gamma back and never disables speculation engine-wide:
per-stream disable is the engine's call (acceptance-collapse /
spec.verify-fault policy in spec/state.py).

Hysteresis follows the AutotuneController discipline in miniature:
``hold`` consecutive below-threshold rounds to move, a round-counted
cooldown after each move, and the warmup keeps the cold EMA from
condemning gamma before it has seen real acceptance. Round-counted
(not wall-clock) so behaviour is deterministic under test.

The engine publishes the move as a ``spec_degraded`` event with
action="shrink_gamma" and bumps cake_spec_degraded_total — the tuner
itself only decides.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["SpecGammaTuner", "SpecTunerConfig"]


@dataclass(frozen=True)
class SpecTunerConfig:
    # engine-wide acceptance EMA below this is "gamma too deep"
    shrink_below: float = 0.3
    # rounds observed before the tuner may move at all
    warmup_rounds: int = 8
    # hysteresis: consecutive below-threshold rounds to shrink
    hold: int = 3
    # rounds after a shrink before the next one may trigger
    cooldown_rounds: int = 8


class SpecGammaTuner:
    """Narrowing-only gamma controller (engine thread, between steps)."""

    def __init__(self, gamma: int, config: SpecTunerConfig | None = None):
        self.config = config or SpecTunerConfig()
        self.gamma = int(gamma)          # the tuner's view of live gamma
        self.rounds = 0
        self._below = 0                  # consecutive below-threshold rounds
        self._cooldown = 0               # rounds left before next move
        self.shrinks = 0

    def note_round(self, accept_ema: float | None) -> None:
        """Fold one batched round's engine-wide acceptance EMA."""
        self.rounds += 1
        if self._cooldown > 0:
            self._cooldown -= 1
        if accept_ema is not None and accept_ema < self.config.shrink_below:
            self._below += 1
        else:
            self._below = 0

    def maybe_shrink(self) -> int | None:
        """New (smaller) gamma if the loop says narrow, else None.

        The caller owns the live gamma; on a non-None return it must
        adopt the value (the tuner assumes it did — its cooldown arms
        either way)."""
        cfg = self.config
        if self.gamma <= 1 or self.rounds < cfg.warmup_rounds:
            return None
        if self._cooldown > 0 or self._below < cfg.hold:
            return None
        self.gamma = max(1, self.gamma // 2)
        self.shrinks += 1
        self._below = 0
        self._cooldown = cfg.cooldown_rounds
        return self.gamma
