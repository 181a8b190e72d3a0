"""The engine's two device steps, each with its sampling, as CUDA graphs:
the pure-decode step (`DecodeRunner`, replayed K times a burst) and the
mixed step (`MixedRunner`, replayed once a mixed step).

`DecodeRunner` is the counterpart of the JAX engine's `make_decode_scan`
(a jitted `lax.scan` of K ragged decode steps and their sampling): where
JAX compiles the step once and runs K of them in one program, the runner
captures ONE step over static buffers and replays it K times; each
replay updates the carry in place and writes its outputs into column
`col` of [B, K] burst buffers. The step is `forward_ragged_paged` plus
`ops/sampling.masked_sample`, with the JAX scan body's row rules:

  * a row is live while it was active at the burst's start, has emitted
    fewer than budget[b] tokens in this burst, and has not sampled an
    EOS id; a frozen row writes no page (its write goes to the pool's
    sink page), and keeps its counter, ring, token, position and step;
  * the carry (token, position, step, live) stays on the card between
    bursts, so burst k + 1 chains from burst k's end with no host round
    trip; the host only writes the next budget.

`MixedRunner` is the counterpart of the JAX engine's jitted
`_mixed_step_fn` (`mixed_step_paged` over fixed [B, C] descriptors) and
the sampling of the rows that emit: `mixed_step_paged`, then
`masked_sample` over the emit mask, which advances the random counters
and the repeat-penalty rings of emitting rows only. A step in which no
row emits (every row mid-prompt) is a variant without the sampling, as
JAX skips its sampling program there, and copies nothing to the host.

On the CPU the same steps run eagerly (`replay` calls them), which is
how the tests drive the runners. On CUDA a step is captured at the first
use of each variant (the decode step's `n_top`, 0 or the engine's
top-logprobs cap, as JAX compiles two; the mixed step's also "no
sampling"), on the engine thread, after a warm-up on a side stream with
every row frozen or idle, so the warm-up's writes land on the sink page
and it changes no state the engine keeps. The pool, the table, the rope
tables, the weights, the ring and the random streams live outside the
graphs' memory pool (which the engine's two runners share) and are
updated in place; host values go up from pinned memory and outputs come
down into pinned memory behind an event, so the host does not wait for
the stream until it fetches.

Kernel launch counts (the `LAUNCHES` dicts of the kernel modules) are
bumped in Python, which a replay never runs: the runner records each
counter's increase during capture, takes it back out (a capture
launches nothing), and adds it once per replay.

On the card a run records a timing event before its first replay and
one after its last (`timing`): the engine reads their elapsed time for
the step's flight record after a fetch has passed them, so timing adds
no wait for the stream. `on_capture(variant, seconds)` is called once a
capture (the flight recorder counts captures as JAX counts compiles).
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cake_tpu_torch.models.llama.paged import (
    forward_ragged_paged, mixed_step_paged,
)
from cake_tpu_torch.ops import flash_attention, int4_matmul
from cake_tpu_torch.ops import ragged_paged_attention
from cake_tpu_torch.ops.sampling import masked_sample

# the kernel modules' launch counters
COUNTERS = (ragged_paged_attention.LAUNCHES, int4_matmul.LAUNCHES,
            flash_attention.LAUNCHES)


def _snapshot() -> List[dict]:
    return [dict(c) for c in COUNTERS]


def _increase(before: List[dict]) -> List[dict]:
    return [{k: c[k] - b.get(k, 0) for k in c if c[k] != b.get(k, 0)}
            for c, b in zip(COUNTERS, before)]


def _add(delta: List[dict], times: int) -> None:
    for c, d in zip(COUNTERS, delta):
        for k, n in d.items():
            c[k] += n * times


class BurstHandle(NamedTuple):
    """One dispatched burst or mixed step: its step count, its n_top, and
    the host copies of its outputs, ready once `event` has passed (None
    on the CPU); `timing` the (start, end) timing events around its
    replays (None on the CPU)."""

    n: int
    n_top: int
    host: Tuple[torch.Tensor, ...]
    event: Optional[torch.cuda.Event]
    timing: Optional[tuple] = None


def mark(device) -> Optional[torch.cuda.Event]:
    """A timing event recorded on the device's current stream (None on
    the CPU)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def elapsed_s(timing) -> Optional[float]:
    """Seconds between a run's timing events, or None (the CPU, or
    events the stream has not passed yet: this never waits)."""
    if timing is None or not timing[1].query():
        return None
    return timing[0].elapsed_time(timing[1]) / 1e3


class _Runner:
    """What the two runners share: the engine's sampling state, the
    outputs ([B, cols] ids and logprobs, [B, cols, n_top_cap] top ids and
    logprobs) with two pinned host copies used in turn, the captured
    step per variant, and the host-to-device puts. A subclass gives
    `step(variant)` and `_idle()` (the buffers set so that a step changes
    nothing the engine keeps)."""

    def __init__(self, params, cache, rope, config, *, attn: str,
                 ring: torch.Tensor, seeds: torch.Tensor,
                 counters: torch.Tensor, cols: int, n_top_cap: int,
                 top_k: Optional[int], pool=None, on_capture=None):
        dev = ring.device
        self.device = dev
        self.params, self.cache, self.rope = params, cache, rope
        self.config, self.attn, self.top_k = config, attn, top_k
        self.ring, self.seeds, self.counters = ring, seeds, counters
        self.B = B = ring.shape[0]
        # the last step's logits (what a comparison of two runs reads)
        self.logits = self._zeros(B, config.vocab_size, dtype=torch.float32)
        self.out = (self._zeros(B, cols, dtype=torch.int64),
                    self._zeros(B, cols, dtype=torch.float32),
                    self._zeros(B, cols, n_top_cap, dtype=torch.int64),
                    self._zeros(B, cols, n_top_cap, dtype=torch.float32))
        self._cuda = dev.type == "cuda"
        # two host copies of the outputs, used in turn (double buffering)
        self._host = [tuple(torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=self._cuda)
                            for t in self.out) for _ in range(2)]
        self._turn = 0
        self._pool = pool
        self._graphs: dict = {}
        self._on_capture = on_capture
        # the last run's timing events (None on the CPU)
        self.timing: Optional[tuple] = None

    def _zeros(self, *shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def step(self, variant) -> None:
        raise NotImplementedError

    def _idle(self) -> None:
        raise NotImplementedError

    def captured(self, variant):
        """The captured step of this variant, captured at first use: a
        warm-up on a side stream with the buffers idle (`_idle`: the
        writes land on the sink page, and the counters and ring keep
        their values), then the capture. Clears the per-step buffers."""
        got = self._graphs.get(variant)
        if got is not None:
            return got
        t0 = time.perf_counter()
        self._idle()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.step(variant)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _snapshot()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            self.step(variant)
        delta = _increase(before)
        _add(delta, -1)              # the capture launched nothing
        self._graphs[variant] = got = (graph, delta)
        if self._on_capture is not None:
            self._on_capture(variant, time.perf_counter() - t0)
        return got

    def replay(self, variant) -> None:
        """One step: the graph's replay on CUDA (its kernels' launches
        counted), the eager step on the CPU."""
        if not self._cuda:
            self.step(variant)
            return
        graph, delta = self.captured(variant)
        graph.replay()
        _add(delta, 1)

    def _put(self, dst: torch.Tensor, values) -> None:
        """Host values into a device buffer; on the card from pinned
        memory, so the host does not wait for the stream."""
        src = torch.as_tensor(np.asarray(values)).to(dst.dtype)
        if self._cuda:
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)

    def download(self, n: int, n_top: int) -> BurstHandle:
        """Dispatch the outputs' copy to the next host buffer, behind an
        event on the card; not waited for."""
        host = self._host[self._turn]
        self._turn ^= 1
        for h, o in zip(host, self.out):
            h.copy_(o, non_blocking=True)
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return BurstHandle(n, n_top, host, event, self.timing)

    @staticmethod
    def fetch(handle: BurstHandle) -> tuple:
        """The outputs as host arrays: tokens and logprobs [B, n], top
        ids and logprobs [B, n, n_top]."""
        if handle.event is not None:
            handle.event.synchronize()
        n, k = handle.n, handle.n_top
        tok, lp, ti, tl = handle.host
        return (tok[:, :n].numpy().copy(), lp[:, :n].numpy().copy(),
                ti[:, :n, :k].numpy().copy(), tl[:, :n, :k].numpy().copy())


class DecodeRunner(_Runner):
    """Static buffers, the captured step per `n_top` variant, and the
    burst protocol: `load` (a fresh burst from the host mirrors), then
    `run` (K replays, outputs copied to host behind an event; chained
    bursts call `run` again without `load`), then `fetch`."""

    def __init__(self, params, cache, rope, config, *, attn: str,
                 ring: torch.Tensor, seeds: torch.Tensor,
                 counters: torch.Tensor, max_steps: int, n_top_cap: int,
                 top_k: Optional[int], pool=None, on_capture=None):
        super().__init__(params, cache, rope, config, attn=attn, ring=ring,
                         seeds=seeds, counters=counters, cols=max_steps,
                         n_top_cap=n_top_cap, top_k=top_k, pool=pool,
                         on_capture=on_capture)
        B, zeros = self.B, self._zeros
        # the carry
        self.tok = zeros(B, dtype=torch.int64)
        self.pos = zeros(B, dtype=torch.int32)
        self.live = zeros(B, dtype=torch.bool)
        self.steps = zeros(B, dtype=torch.int64)
        # per burst
        self.steps_in = zeros(B, dtype=torch.int64)
        self.budget = zeros(B, dtype=torch.int64)
        self.col = zeros(1, dtype=torch.int64)
        # per request, fixed while a burst chain runs
        self.temp = zeros(B, dtype=torch.float32)
        self.top_p = zeros(B, dtype=torch.float32)
        self.penalty = zeros(B, dtype=torch.float32)
        self.eos = torch.tensor(list(config.eos_token_ids) or [-1],
                                dtype=torch.int64, device=self.device)

    # -- the step ---------------------------------------------------------------

    def step(self, n_top: int) -> None:
        """One decode step over the static buffers, in place (the JAX
        scan body)."""
        live = self.live & ((self.steps - self.steps_in) < self.budget)
        logits, _ = forward_ragged_paged(
            self.params, self.tok[:, None], self.cache, self.pos, live,
            self.rope, self.config, attn=self.attn)
        nxt, counters, ring, lp, t_i, t_l = masked_sample(
            live, self.seeds, self.counters, logits, self.ring, self.steps,
            self.temp, self.top_p, self.penalty, top_k=self.top_k,
            n_top=n_top)
        self.logits.copy_(logits)
        self.counters.copy_(counters)
        self.ring.copy_(ring)
        self.tok.copy_(torch.where(live, nxt, self.tok))
        self.pos.add_(live.to(torch.int32))
        self.steps.add_(live.to(torch.int64))
        eos = (nxt[:, None] == self.eos[None, :]).any(dim=-1)
        self.live.copy_(live & ~eos)
        tok_o, lp_o, ti_o, tl_o = self.out
        tok_o.index_copy_(1, self.col, nxt[:, None])
        lp_o.index_copy_(1, self.col, lp[:, None])
        if n_top:
            ti_o.index_copy_(1, self.col, t_i[:, None])
            tl_o.index_copy_(1, self.col, t_l[:, None])
        self.col.add_(1)

    def _idle(self) -> None:
        """Every row frozen (budget 0), from column 0."""
        self.live.zero_()
        self.budget.zero_()
        self.col.zero_()

    # -- the burst protocol -------------------------------------------------------

    def load(self, n_top: int, tok, pos, live, steps, temp, top_p,
             penalty) -> None:
        """Start a burst chain from the host mirrors ([B] each)."""
        if self._cuda:
            self.captured(n_top)     # before the carry: warm-up clears it
        for dst, v in ((self.tok, tok), (self.pos, pos), (self.live, live),
                       (self.steps, steps), (self.temp, temp),
                       (self.top_p, top_p), (self.penalty, penalty)):
            self._put(dst, v)

    def begin(self, budget) -> None:
        """Open a burst: row b may emit budget[b] more tokens, written
        from column 0 of the output buffers."""
        self._put(self.budget, budget)
        self.steps_in.copy_(self.steps)
        self.col.zero_()

    def run(self, n: int, budget, n_top: int) -> BurstHandle:
        """n steps (n <= max_steps) from the carry on the card, row b emitting at
        most budget[b] tokens; the outputs' copy to the host is
        dispatched, not waited for."""
        self.begin(budget)
        start = mark(self.device)
        for _ in range(n):
            self.replay(n_top)
        self.timing = (start, mark(self.device)) if self._cuda else None
        return self.download(n, n_top)


class MixedRunner(_Runner):
    """Static [B, C] descriptors, the captured mixed step per sampling
    variant (None: no row emits, no sampling; else n_top), and `run`:
    the host rows up, one replay, and when a row emits the outputs'
    copy to the host, then `fetch` ([B, 1] ids and logprobs).

    step_fn: the mixed step (`paged.mixed_step_paged`); the engine
    passes the one it imported."""

    def __init__(self, params, cache, rope, config, *, attn: str,
                 ring: torch.Tensor, seeds: torch.Tensor,
                 counters: torch.Tensor, chunk: int, n_top_cap: int,
                 top_k: Optional[int], step_fn=mixed_step_paged,
                 pool=None, on_capture=None):
        super().__init__(params, cache, rope, config, attn=attn, ring=ring,
                         seeds=seeds, counters=counters, cols=1,
                         n_top_cap=n_top_cap, top_k=top_k, pool=pool,
                         on_capture=on_capture)
        B, zeros = self.B, self._zeros
        self.step_fn = step_fn
        # the step's rows
        self.tokens = zeros(B, chunk, dtype=torch.int32)
        self.pos = zeros(B, dtype=torch.int32)
        self.q_len = zeros(B, dtype=torch.int32)
        self.active = zeros(B, dtype=torch.bool)
        # the sampling of the rows that emit
        self.emit = zeros(B, dtype=torch.bool)
        self.steps = zeros(B, dtype=torch.int64)
        self.temp = zeros(B, dtype=torch.float32)
        self.top_p = zeros(B, dtype=torch.float32)
        self.penalty = zeros(B, dtype=torch.float32)

    def step(self, n_top: Optional[int]) -> None:
        """One mixed step over the static buffers, the pool written in
        place; with `n_top` not None, then the emitting rows' sample (the
        engine's eager `masked_sample` call, counters and rings advanced
        for those rows only)."""
        logits, _ = self.step_fn(
            self.params, self.tokens, self.pos, self.q_len, self.active,
            self.cache, self.rope, self.config, attn=self.attn)
        self.logits.copy_(logits)
        if n_top is None:
            return
        nxt, counters, ring, lp, t_i, t_l = masked_sample(
            self.emit, self.seeds, self.counters, logits, self.ring,
            self.steps, self.temp, self.top_p, self.penalty,
            top_k=self.top_k, n_top=n_top)
        self.counters.copy_(counters)
        self.ring.copy_(ring)
        tok_o, lp_o, ti_o, tl_o = self.out
        tok_o[:, 0].copy_(nxt)
        lp_o[:, 0].copy_(lp)
        if n_top:
            ti_o[:, 0, :n_top].copy_(t_i)
            tl_o[:, 0, :n_top].copy_(t_l)

    def _idle(self) -> None:
        """Every row idle (q_len 0, inactive) and none emitting."""
        self.q_len.zero_()
        self.active.zero_()
        self.emit.zero_()

    def load(self, n_top: Optional[int], tokens, pos, q_len, active, emit,
             steps, temp, top_p, penalty) -> None:
        """The host rows (tokens [B, C], the rest [B]) into the static
        buffers, after the variant's capture (whose warm-up clears
        them)."""
        if self._cuda:
            self.captured(n_top)
        for dst, v in ((self.tokens, tokens), (self.pos, pos),
                       (self.q_len, q_len), (self.active, active),
                       (self.emit, emit), (self.steps, steps),
                       (self.temp, temp), (self.top_p, top_p),
                       (self.penalty, penalty)):
            self._put(dst, v)

    def run(self, n_top: Optional[int], *rows) -> Optional[BurstHandle]:
        """One mixed step of the host rows (`load`'s), sampling the emit
        rows with `n_top` alternatives (None: no row emits). Returns the
        handle of the outputs' copy to the host, dispatched and not
        waited for, or None when nothing emits. `timing` holds the
        replay's timing events either way."""
        self.load(n_top, *rows)
        start = mark(self.device)
        self.replay(n_top)
        self.timing = (start, mark(self.device)) if self._cuda else None
        return None if n_top is None else self.download(1, n_top)
