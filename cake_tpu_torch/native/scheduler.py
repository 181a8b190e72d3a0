"""Continuous-batching scheduler (FIFO), in Python.

Counterpart of `cake_tpu/native/scheduler.py` (`PyScheduler`,
`make_scheduler`); the C++ scheduler is not ported yet. Requests queue
FCFS, are admitted into decode slots between engine iterations, and
retire on EOS/max-tokens:

    submit(id, prompt_len, max_new_tokens) -> bool
    cancel(id) -> bool
    plan() -> (prefill [(id, slot)], decode [(id, slot)])
    report(id, n_tokens, eos) -> bool finished
    queue_depth / active / completed properties
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Tuple


class PyScheduler:
    """Pure-Python FIFO scheduler."""

    def __init__(self, max_slots: int, max_queue: int = 1024):
        if max_slots <= 0:
            raise ValueError("max_slots must be positive")
        self.max_slots = max_slots
        self.max_queue = max_queue
        self._mu = threading.Lock()
        self._queue: deque = deque()
        self._reqs: Dict[int, dict] = {}
        self._slots: List[int] = [0] * max_slots
        self._active = 0
        self._completed = 0

    def submit(self, rid: int, prompt_len: int, max_new_tokens: int) -> bool:
        with self._mu:
            if rid == 0 or rid in self._reqs:
                return False
            if len(self._queue) >= self.max_queue:
                return False
            self._reqs[rid] = dict(prompt_len=prompt_len,
                                   max_new=max_new_tokens, generated=0,
                                   slot=-1, prefilled=False)
            self._queue.append(rid)
            return True

    def cancel(self, rid: int) -> bool:
        with self._mu:
            r = self._reqs.pop(rid, None)
            if r is None:
                return False
            if r["slot"] >= 0:
                self._slots[r["slot"]] = 0
                self._active -= 1
            else:
                try:
                    self._queue.remove(rid)
                except ValueError:
                    pass
            return True

    def plan(self) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
        with self._mu:
            prefill, decode = [], []
            for slot in range(self.max_slots):
                if not self._queue:
                    break
                if self._slots[slot] != 0:
                    continue
                rid = self._queue.popleft()
                r = self._reqs[rid]
                r["slot"] = slot
                self._slots[slot] = rid
                self._active += 1
                prefill.append((rid, slot))
            for slot in range(self.max_slots):
                rid = self._slots[slot]
                if rid == 0:
                    continue
                r = self._reqs[rid]
                if r["prefilled"]:
                    decode.append((rid, slot))
                r["prefilled"] = True
            return prefill, decode

    def report(self, rid: int, n_tokens: int, eos: bool) -> bool:
        with self._mu:
            r = self._reqs.get(rid)
            if r is None or r["slot"] < 0:
                return False
            r["generated"] += n_tokens
            if eos or r["generated"] >= r["max_new"]:
                self._slots[r["slot"]] = 0
                self._active -= 1
                self._completed += 1
                del self._reqs[rid]
                return True
            return False

    @property
    def queue_depth(self) -> int:
        with self._mu:
            return len(self._queue)

    @property
    def active(self) -> int:
        with self._mu:
            return self._active

    @property
    def completed(self) -> int:
        with self._mu:
            return self._completed


def make_scheduler(max_slots: int, max_queue: int = 1024) -> PyScheduler:
    """The FIFO scheduler (the port has no native one yet)."""
    return PyScheduler(max_slots, max_queue)
