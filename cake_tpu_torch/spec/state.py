"""Per-stream speculative state + the spec plane's metrics surface.

Counterpart of `cake_tpu/spec/state.py`, copied (host-only), less the
plane's thread-affinity declarations, which only JAX's linter reads.
A paged-spec engine keeps ONE SpecPlane (serve/engine.py `_specp`,
declared in the engine's OPTIONAL_PLANES: None = spec disabled, and
every engine deref sits behind an `is not None` guard). The plane owns
what the device round does not: the draft model, per-slot SpecState
(page bookkeeping + the acceptance EMA the controller loop reads), the
live gamma, and the gamma tuner seam (autotune/spec.py).

Page accounting contract: a stream's BASE pages stay in the engine's
`_slot_pages` row exactly as for plain decode. Everything speculative —
the draft row's pages and the target row's suffix-extension pages past
the admission allocation — lives in its SpecState and is released by
`engine._release_spec_state` on teardown and by post-round truncation,
so `free_pages + live_pages == n_pages` holds after every round and a
degraded/finished stream leaks nothing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from cake_tpu_torch.obs import metrics as obs_metrics

# paged speculative decoding (spec/): the closed-loop
# observables — the fleet-level acceptance EMA and emitted tokens per
# round that the gamma tuner (autotune/spec.py) steers on, plus round
# and degrade counters. Per-stream EMAs ride spec_round/spec_degraded
# EVENTS (rids never label metrics).
SPEC_ACCEPT_RATIO = obs_metrics.gauge(
    "cake_spec_accept_ratio",
    "EMA of the fraction of drafted tokens the target accepted per "
    "paged speculative round, engine-wide (per-stream EMAs ride "
    "spec_round events)")
SPEC_TOKENS_PER_ROUND = obs_metrics.gauge(
    "cake_spec_tokens_per_round",
    "EMA of tokens emitted per paged speculative round engine-wide "
    "(1 = speculation is paying nothing, gamma+1 = every draft "
    "accepted)")
SPEC_ROUNDS = obs_metrics.counter(
    "cake_spec_rounds_total",
    "Paged speculative draft+verify rounds dispatched (one batched "
    "launch may cover many streams)")
SPEC_DEGRADED = obs_metrics.counter(
    "cake_spec_degraded_total",
    "Paged speculative degrade actions by kind (disabled = a stream "
    "fell back to plain decode on acceptance collapse or repeated "
    "spec.verify faults; shrink_gamma = the tuner narrowed the "
    "engine-wide draft length)",
    labelnames=("action",))

# EMA smoothing for the acceptance/tokens-per-round signals: light
# enough to react within ~10 rounds, heavy enough that one unlucky
# round cannot trip the degrade threshold on its own
EMA_ALPHA = 0.2

# per-stream degrade policy (the engine-wide gamma policy lives in the
# tuner, autotune/spec.py): a stream is disabled — falls back to plain
# decode, spec pages released — when its acceptance EMA sits below the
# floor after the warmup, or after this many CONSECUTIVE spec.verify
# faults. Warmup > 1/EMA_ALPHA so the EMA has largely forgotten its
# first-round seed before it can condemn a stream.
STREAM_ACCEPT_FLOOR = 0.1
STREAM_WARMUP_ROUNDS = 8
DISABLE_AFTER_FAILS = 3


@dataclass
class SpecState:
    """Per-slot speculative bookkeeping (host-side, engine thread).

    Created lazily by the engine once a stream is decoding and
    spec-compatible (`_spec_activate`); torn down with the slot's pages
    (`_release_spec_state`) or on per-stream degrade."""

    rid: int
    # draft-row pages (context base + per-round suffix extensions, one
    # list — the draft pool has no admission row of its own)
    d_pages: List[int] = field(default_factory=list)
    # target-row pages EXTENDING the admission allocation so a round's
    # gamma+1-token window always lands in mapped pages; truncated back
    # to the accepted frontier after every round
    t_suffix_pages: List[int] = field(default_factory=list)
    # acceptance-rate EMA (accepted/proposed per round); None until the
    # first round so the controller can tell "new" from "collapsed"
    accept_ema: Optional[float] = None
    rounds: int = 0
    proposed: int = 0
    accepted: int = 0
    # consecutive spec.verify faults (reset on a clean round): the
    # never-wedge discipline disables spec for the stream, it does not
    # retry forever
    verify_fails: int = 0
    # False = degraded tombstone: the stream decodes plain for the rest
    # of its life, its spec pages already back in the pool. The state
    # stays in the map so slot reuse cannot resurrect speculation for a
    # condemned rid (teardown pops it with the slot).
    enabled: bool = True

    def note_round(self, proposed: int, accepted: int) -> None:
        self.rounds += 1
        self.proposed += proposed
        self.accepted += accepted
        rate = accepted / max(proposed, 1)
        self.accept_ema = (rate if self.accept_ema is None
                           else (1 - EMA_ALPHA) * self.accept_ema
                           + EMA_ALPHA * rate)


class SpecPlane:
    """Engine-side container for paged speculative decoding.

    Single-writer on the ENGINE thread — the per-slot state map and the
    live gamma are read/written only between device steps by the engine
    loop (no handler-thread entry points), which is what the affinity
    declarations below pin for cakelint. The tuner seam is optional
    (None = fixed gamma), guarded per the optional-plane discipline.
    """

    def __init__(self, draft_params, draft_config, gamma: int, rope,
                 tuner=None):
        self.draft_params = draft_params
        self.draft_config = draft_config
        self.rope = rope            # draft RopeTables (draft head_dim)
        self.live_gamma = gamma     # LIVE gamma (tuner may shrink it)
        self.gamma0 = gamma
        self.tuner = tuner
        self.spec_streams: Dict[int, SpecState] = {}  # slot -> SpecState
        # engine-wide EMAs behind the two gauges
        self.accept_ema: Optional[float] = None
        self.tokens_ema: Optional[float] = None

    def note_round(self, proposed: int, accepted: int,
                   tokens: int, rows: int) -> None:
        """Fold one batched round's aggregate into the engine-wide
        EMAs + gauges and feed the tuner its steering signal."""
        SPEC_ROUNDS.inc()
        rate = accepted / max(proposed, 1)
        tpr = tokens / max(rows, 1)
        self.accept_ema = (rate if self.accept_ema is None
                           else (1 - EMA_ALPHA) * self.accept_ema
                           + EMA_ALPHA * rate)
        self.tokens_ema = (tpr if self.tokens_ema is None
                           else (1 - EMA_ALPHA) * self.tokens_ema
                           + EMA_ALPHA * tpr)
        SPEC_ACCEPT_RATIO.set(self.accept_ema)
        SPEC_TOKENS_PER_ROUND.set(self.tokens_ema)
        if self.tuner is not None:
            self.tuner.note_round(self.accept_ema)
