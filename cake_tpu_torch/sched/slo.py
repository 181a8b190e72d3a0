"""SLO-aware scheduler: priority-class queues, aging, preemption.

Counterpart of `cake_tpu/sched/slo.py`, host-only and copied as it is.

Drop-in superset of the ``native/scheduler.py`` FIFO interface the engine
already drives (submit / cancel / plan / report / queue_depth / active /
completed), plus the operations the SLO layer needs:

  * ``submit(..., priority=)`` — requests carry a class;
  * ``plan()`` admits by *effective score* (class rank minus weighted
    wait-time aging), not arrival order — a fresh ``interactive``
    request leapfrogs a queue of ``batch`` work, but any aged head's
    score falls without bound, so it can never be starved;
  * ``requeue(rid, ...)`` — return an ACTIVE request to the queue
    preserving its original enqueue time (page-starvation requeues and
    recompute-style preemption both must not lose seniority; a plain
    cancel+submit would);
  * ``preemption_victims(below_rank)`` / ``slot_preemption_victims()``
    — candidate decoding slots a starved higher class may reclaim: the
    youngest slot of the worst class, preemption budget respected.

The scheduler is pure host-side bookkeeping (no device work, one lock),
so tests/test_torch_sched.py drives seeded random interleavings of
it and of the JAX scheduler side by side.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from cake_tpu_torch.sched.classes import SchedConfig, validate_priority


class SLOScheduler:
    """Priority-class continuous-batching scheduler."""

    def __init__(self, max_slots: int, max_queue: int = 1024,
                 config: Optional[SchedConfig] = None):
        if max_slots <= 0:
            raise ValueError("max_slots must be positive")
        self.max_slots = max_slots
        self.max_queue = max_queue
        self.config = config or SchedConfig()
        self._mu = threading.Lock()
        self._reqs: Dict[int, dict] = {}
        self._queued: List[int] = []
        self._slots: List[int] = [0] * max_slots
        self._active = 0
        self._completed = 0
        self._seq = 0

    # -- internals (caller holds the lock) --------------------------------

    def _score(self, e: dict, now: float) -> float:
        """Effective admission score: lower admits first. The aging
        term guarantees every queued request's score is unbounded
        below — nothing starves."""
        return e["rank"] - max(0.0, now - e["enq_t"]) / e["aging_s"]

    def _order(self, now: float) -> List[int]:
        return sorted(
            self._queued,
            key=lambda r: (self._score(self._reqs[r], now),
                           self._reqs[r]["seq"]))

    # -- the native-scheduler interface -----------------------------------

    def submit(self, rid: int, prompt_len: int, max_new_tokens: int,
               priority: Optional[str] = None,
               now: Optional[float] = None) -> bool:
        cls = validate_priority(priority)
        now = time.monotonic() if now is None else now
        with self._mu:
            if rid == 0 or rid in self._reqs:
                return False
            if len(self._queued) >= self.max_queue:
                return False
            self._seq += 1
            self._reqs[rid] = dict(
                prompt_len=prompt_len, max_new=max_new_tokens,
                generated=0, slot=-1, prefilled=False, cls=cls,
                rank=self.config.rank(cls),
                aging_s=self.config.aging_s(cls),
                enq_t=now, seq=self._seq, preempts=0)
            self._queued.append(rid)
            return True

    def cancel(self, rid: int) -> bool:
        with self._mu:
            e = self._reqs.pop(rid, None)
            if e is None:
                return False
            if e["slot"] >= 0:
                self._slots[e["slot"]] = 0
                self._active -= 1
            else:
                try:
                    self._queued.remove(rid)
                except ValueError:
                    pass
            return True

    def plan(self, now: Optional[float] = None
             ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
        now = time.monotonic() if now is None else now
        with self._mu:
            prefill: List[Tuple[int, int]] = []
            decode: List[Tuple[int, int]] = []
            if self._queued:
                free = [s for s in range(self.max_slots)
                        if self._slots[s] == 0]
                for rid in self._order(now)[:len(free)]:
                    slot = free.pop(0)
                    e = self._reqs[rid]
                    e["slot"] = slot
                    self._slots[slot] = rid
                    self._active += 1
                    self._queued.remove(rid)
                    prefill.append((rid, slot))
            for slot in range(self.max_slots):
                rid = self._slots[slot]
                if rid == 0:
                    continue
                e = self._reqs[rid]
                if e["prefilled"]:
                    decode.append((rid, slot))
                e["prefilled"] = True
            return prefill, decode

    def report(self, rid: int, n_tokens: int, eos: bool) -> bool:
        with self._mu:
            e = self._reqs.get(rid)
            if e is None or e["slot"] < 0:
                return False
            e["generated"] += n_tokens
            if eos or e["generated"] >= e["max_new"]:
                self._slots[e["slot"]] = 0
                self._active -= 1
                self._completed += 1
                del self._reqs[rid]
                return True
            return False

    # -- SLO extensions ----------------------------------------------------

    def requeue(self, rid: int, prompt_len: int, max_new_tokens: int,
                preempted: bool = False) -> bool:
        """Move an ACTIVE request back to its class queue, preserving
        its original enqueue time (seniority survives page-starvation
        requeues and preemption). prompt_len/max_new describe the
        request as it will RE-prefill (generated tokens folded into the
        prompt, budget reduced to the remainder)."""
        with self._mu:
            e = self._reqs.get(rid)
            if e is None or e["slot"] < 0:
                return False
            self._slots[e["slot"]] = 0
            self._active -= 1
            e.update(slot=-1, prefilled=False, prompt_len=prompt_len,
                     max_new=max_new_tokens, generated=0)
            if preempted:
                e["preempts"] += 1
            self._queued.append(rid)
            return True

    def preemption_victims(self, below_rank: int
                           ) -> List[Tuple[int, int]]:
        """(rid, slot) of active requests a class of rank `below_rank`
        may preempt, best victim first: strictly worse class only, the
        worst class first, youngest admission first, requests past
        their preemption budget exempt (progress guarantee)."""
        with self._mu:
            cands = [(e["rank"], e["seq"], rid, e["slot"])
                     for rid, e in self._reqs.items()
                     if e["slot"] >= 0 and e["rank"] > below_rank
                     and e["preempts"] < self.config.preempt_budget]
        cands.sort(key=lambda t: (-t[0], -t[1]))
        return [(rid, slot) for _r, _s, rid, slot in cands]

    def slot_preemption_victims(self, now: Optional[float] = None
                                ) -> List[Tuple[int, int]]:
        """Victims for the best-scored WAITING request when every slot
        is taken; empty when a slot is free or nothing waits."""
        now = time.monotonic() if now is None else now
        with self._mu:
            if not self._queued or any(s == 0 for s in self._slots):
                return []
            best = min(self._queued,
                       key=lambda r: (self._score(self._reqs[r], now),
                                      self._reqs[r]["seq"]))
            rank = self._reqs[best]["rank"]
        return self.preemption_victims(rank)

    def outranks(self, rid_a: int, rid_b: int,
                 now: Optional[float] = None) -> bool:
        """True when rid_a's effective score strictly beats rid_b's —
        the page-starved blocking head may only be leapfrogged by a
        request that outranks it, so an aged head keeps first claim on
        freed pages."""
        now = time.monotonic() if now is None else now
        with self._mu:
            ea, eb = self._reqs.get(rid_a), self._reqs.get(rid_b)
            if ea is None or eb is None:
                return False
            return ((self._score(ea, now), ea["seq"])
                    < (self._score(eb, now), eb["seq"]))

    def class_depths(self) -> Dict[str, int]:
        """Queued requests per class (the cake_queue_depth gauge)."""
        out = {p.name: 0 for p in self.config.policies}
        with self._mu:
            for rid in self._queued:
                out[self._reqs[rid]["cls"]] += 1
        return out

    def depth_ahead(self, priority: str) -> int:
        """Approximate queue positions ahead of a NEW request of this
        class: queued requests of the same or better rank (aging can
        promote worse classes past this estimate; shedding only needs
        the order of magnitude)."""
        rank = self.config.rank(validate_priority(priority))
        with self._mu:
            return sum(1 for rid in self._queued
                       if self._reqs[rid]["rank"] <= rank)

    # -- properties --------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        with self._mu:
            return len(self._queued)

    @property
    def active(self) -> int:
        with self._mu:
            return self._active

    @property
    def completed(self) -> int:
        with self._mu:
            return self._completed
