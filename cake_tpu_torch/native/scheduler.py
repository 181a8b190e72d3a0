"""Continuous-batching scheduler (FIFO): native (C++) with a Python
fallback.

Counterpart of `cake_tpu/native/scheduler.py`: `NativeScheduler` wraps
csrc/scheduler.cpp through ctypes, `PyScheduler` is the same FIFO in
Python, and `make_scheduler` takes the native one wherever the library
builds (cake_tpu_torch/native/__init__.py). Requests queue FCFS, are
admitted into decode slots between engine iterations, and retire on
EOS/max-tokens. Both expose:

    submit(id, prompt_len, max_new_tokens) -> bool
    cancel(id) -> bool
    plan() -> (prefill [(id, slot)], decode [(id, slot)])
    report(id, n_tokens, eos) -> bool finished
    queue_depth / active / completed properties
"""

from __future__ import annotations

import ctypes
import threading
from collections import deque
from typing import Dict, List, Tuple

from cake_tpu_torch.native import get_library


class PyScheduler:
    """Pure-Python FIFO scheduler (and the toolchain-free fallback)."""

    # cakelint lock discipline: the scheduler/shed/slo `_mu` leaf lock
    # nests strictly inside the engine's locks (the engine calls
    # scheduler methods while holding _admit_lock/_rid_lock, never the
    # reverse), and nothing may block under it: it sits on every
    # submit and every engine iteration
    LOCK_ORDER = ("_switch_lock", "_admit_lock", "_rid_lock", "_ckpt_lock",
                  "_mu")
    NO_BLOCKING_UNDER = ("_rid_lock", "_mu")

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


class NativeScheduler:
    """ctypes wrapper over csrc/scheduler.cpp: the plans and counters of
    `PyScheduler`, under the C++ side's own mutex."""

    def __init__(self, max_slots: int, max_queue: int = 1024):
        lib = get_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.max_slots = max_slots
        self.max_queue = max_queue
        self._h = lib.cake_sched_create(max_slots, max_queue)
        if not self._h:
            raise ValueError("cake_sched_create failed")
        n = max_slots
        self._pf_ids = (ctypes.c_uint64 * n)()
        self._pf_slots = (ctypes.c_int32 * n)()
        self._dc_ids = (ctypes.c_uint64 * n)()
        self._dc_slots = (ctypes.c_int32 * n)()

    def submit(self, rid: int, prompt_len: int, max_new_tokens: int) -> bool:
        return self._lib.cake_sched_submit(
            self._h, rid, prompt_len, max_new_tokens) == 0

    def cancel(self, rid: int) -> bool:
        return self._lib.cake_sched_cancel(self._h, rid) == 0

    def plan(self) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
        n_pf = ctypes.c_int32()
        n_dc = ctypes.c_int32()
        self._lib.cake_sched_plan(
            self._h, self._pf_ids, self._pf_slots, ctypes.byref(n_pf),
            self._dc_ids, self._dc_slots, ctypes.byref(n_dc))
        prefill = [(self._pf_ids[i], self._pf_slots[i])
                   for i in range(n_pf.value)]
        decode = [(self._dc_ids[i], self._dc_slots[i])
                  for i in range(n_dc.value)]
        return prefill, decode

    def report(self, rid: int, n_tokens: int, eos: bool) -> bool:
        return self._lib.cake_sched_report(
            self._h, rid, n_tokens, 1 if eos else 0) == 1

    @property
    def queue_depth(self) -> int:
        return self._lib.cake_sched_queue_depth(self._h)

    @property
    def active(self) -> int:
        return self._lib.cake_sched_active(self._h)

    @property
    def completed(self) -> int:
        return self._lib.cake_sched_completed(self._h)

    def __del__(self):
        try:
            if self._h:
                self._lib.cake_sched_destroy(self._h)
                self._h = None
        except Exception:
            pass


def make_scheduler(max_slots: int, max_queue: int = 1024):
    """The native FIFO where the library builds, else the Python one."""
    if get_library() is not None:
        return NativeScheduler(max_slots, max_queue)
    return PyScheduler(max_slots, max_queue)
