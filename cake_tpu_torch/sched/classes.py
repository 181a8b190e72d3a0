"""Priority classes and scheduling policy knobs of the port's scheduler.

Counterpart of `cake_tpu/sched/classes.py`, host-only and copied as it is.

Three classes order admission at "millions of users" scale, where FIFO
is the wrong policy (one batch prompt head-of-line-blocks every
interactive request):

  * ``interactive`` — latency-sensitive chat turns (best rank);
  * ``standard``    — the default for unmarked traffic;
  * ``batch``       — offline/bulk work (worst rank, cheapest to shed).

A request's admission order is its *effective score*
``rank - wait / aging_s``: lower is better, and the aging term is the
anti-starvation guarantee — any queued request's score falls without
bound as it waits, so an aged batch head eventually outranks a fresh
interactive arrival and MUST be admitted next (property-tested in
tests/test_sched.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

PRIORITY_CLASSES: Tuple[str, ...] = ("interactive", "standard", "batch")
CLASS_RANK: Dict[str, int] = {c: i for i, c in enumerate(PRIORITY_CLASSES)}
DEFAULT_PRIORITY = "standard"


def validate_priority(priority: Optional[str]) -> str:
    """Normalize a request priority: None -> the default class; an
    unknown value raises ValueError (the API maps it to HTTP 400)."""
    if priority is None:
        return DEFAULT_PRIORITY
    if priority not in CLASS_RANK:
        raise ValueError(
            f"unknown priority {priority!r} (choose one of "
            f"{', '.join(PRIORITY_CLASSES)})")
    return priority


@dataclass(frozen=True)
class ClassPolicy:
    """One priority class's scheduling knobs.

    aging_s: seconds of queue wait that cancel ONE rank step of
    disadvantage (the weighted anti-starvation aging term).
    target_wait_s: the class's SLO on estimated queue wait — load
    shedding starts rejecting probabilistically beyond it (shed.py).
    """

    name: str
    rank: int
    aging_s: float
    target_wait_s: float


DEFAULT_POLICIES: Tuple[ClassPolicy, ...] = (
    ClassPolicy("interactive", 0, aging_s=30.0, target_wait_s=2.0),
    ClassPolicy("standard", 1, aging_s=30.0, target_wait_s=15.0),
    ClassPolicy("batch", 2, aging_s=60.0, target_wait_s=120.0),
)


@dataclass(frozen=True)
class SchedConfig:
    """Policy bundle consumed by SLOScheduler and ShedController.

    preempt_budget: times one request may be preempted before it
    becomes exempt (guarantees forward progress for low classes).
    shed_window_s: sliding window over which the shed controller
    measures the engine's service rate.
    """

    policies: Tuple[ClassPolicy, ...] = DEFAULT_POLICIES
    preempt_budget: int = 2
    shed_window_s: float = 30.0
    # prefer SPILLING a preemption victim's KV pages to the host tier
    # (when --kv-host-pages capacity is free) over the recompute fold:
    # resume then restores pages instead of re-prefilling prompt +
    # generated tokens (kv/host_tier.py). False forces the recompute
    # fold even with a host tier configured.
    spill_preempt: bool = True
    # oversubscribe the KV pool: an admission the pool cannot cover
    # (even after cold-prefix spills) may park decode-RESIDENT streams
    # — LRU by admission — in the host tier instead of waiting for
    # natural retirements (serve/engine._spill_resident_stream). False
    # restricts host-tier spills to cold prefixes + preemption victims.
    spill_resident: bool = True
    # anti-thrash quantum for the resident spill: a stream may not be
    # parked until it has decoded this many tokens since its latest
    # admission, so two oversubscribed streams time-slice the pool in
    # quantum-sized turns instead of ping-ponging one token per park.
    resident_quantum: int = 8

    def policy(self, name: str) -> ClassPolicy:
        for p in self.policies:
            if p.name == name:
                return p
        raise ValueError(f"no policy for class {name!r}")

    def rank(self, name: str) -> int:
        return self.policy(name).rank

    def aging_s(self, name: str) -> float:
        return self.policy(name).aging_s

    def target_wait_s(self, name: str) -> float:
        return self.policy(name).target_wait_s
