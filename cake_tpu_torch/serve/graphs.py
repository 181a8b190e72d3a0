"""Every step the JAX package compiles, as CUDA graphs replayed over
static buffers: the engine's two device steps with their sampling, the
pure-decode step (`DecodeRunner`, replayed K times a burst; over the
paged pool, the dense cache or the ring) and the mixed step
(`MixedRunner`, replayed once a mixed step); the phase-split loop's
one-slot prefills (`PrefillRunner` over the pool, `DensePrefillRunner`
over the dense or ring cache); the speculative rounds (`SpecRunner`,
`DenseSpecRunner`, `SpecGeneratorRunner`); and the sequential
generator's decode step (`GeneratorRunner`). Each reads every per-call
value (position, slot, real tokens) from a device buffer written in
place, so a graph outlives anything that does not change a shape: a
recovery resets the buffers where they are (`reset_carry`) and keeps
every graph.

`DecodeRunner` is the counterpart of the JAX engine's `make_decode_scan`
(a jitted `lax.scan` of K ragged decode steps and their sampling): where
JAX compiles the step once and runs K of them in one program, the runner
captures ONE step over static buffers and replays it K times; each
replay updates the carry in place and writes its outputs into column
`col` of [B, K] burst buffers. The step is the engine's ragged forward
(`forward_ragged_paged` over pages, `forward_ragged` or
`forward_ragged_ring` over a dense or ring cache) plus
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
sampling"; a prefill's JAX compile key), on the engine thread, after a
warm-up on a side stream with every row frozen or idle, so the warm-up's
writes land on the sink page and it changes no state the engine keeps.
The pool, the table, the rope tables, the weights, the ring and the
random streams live outside the graphs' memory pool (which the engine's
three runners share) and are updated in place; host values go up from pinned memory and outputs come
down into pinned memory behind an event, so the host does not wait for
the stream until it fetches.

Kernel launch counts (the `LAUNCHES` dicts of the kernel modules) are
bumped in Python, which a replay never runs: the runner records each
counter's increase during capture, takes it back out (a capture
launches nothing), and adds it once per replay. Other host-side
accounting of a step registers a hook inside the capture (`on_replay`),
which each replay calls with its host wall.

A step over a mesh that spans processes hops between processes inside
the step (parallel/hop.py), which no graph can hold: each hop cuts the
capture (`segment_cut`), so the variant is a chain of graphs with the
hops as host code between their replays. Its kernels are the captured
graphs' all the same, and a warm wave captures nothing.

On the card a run records a timing event before its first replay and
one after its last (`timing`): the engine reads their elapsed time for
the step's flight record after a fetch has passed them, so timing adds
no wait for the stream. `on_capture(variant, seconds)` is called once a
capture (the flight recorder counts captures as JAX counts compiles).
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import warnings
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cake_tpu_torch.kv.quantized_pool import WindowTargets
from cake_tpu_torch.models.llama.model import (
    forward, forward_logits_all, install_prefix_slot, prefill_slot,
    prefill_slot_chunk, prefill_slot_chunk_ring, prefill_slot_prefixed,
)
from cake_tpu_torch.models.llama.paged import (
    mixed_step_paged, prefill_slot_paged, prefill_slot_paged_chunk,
    prefill_slot_paged_prefixed,
)
from cake_tpu_torch.ops import flash_attention, int4_matmul
from cake_tpu_torch.ops import ragged_paged_attention
from cake_tpu_torch.ops.sampling import masked_sample
from cake_tpu_torch.spec.accept import (
    advance_counters, assemble_sampled, categorical, greedy_accept,
    rejection_accept, uniforms,
)
from cake_tpu_torch.spec.round import spec_round_paged
from cake_tpu_torch.utils.devices import zero_

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


# host-side hooks registered inside a capture (`on_replay`), collected
# by the capturing thread
_HOOKS = threading.local()


def on_replay(hook) -> bool:
    """Inside a capture: every replay of the graph being captured calls
    hook(seconds), the replay's host wall, and True is returned; outside
    one, False. Host-side accounting of a captured step (the sp engine's
    dispatch counters) runs this way, since a replay runs no Python."""
    hooks = getattr(_HOOKS, "hooks", None)
    if hooks is None:
        return False
    hooks.append(hook)
    return True


_CAPTURE_LOCK = threading.RLock()
# the warm-ups' side stream, one a device: cuBLAS keeps a workspace for
# every stream it has run on for the life of the process, so a fresh
# stream a capture would hold ~32 MiB more each time
_SIDE_STREAMS: dict = {}


@contextlib.contextmanager
def _capturing():
    """One capture at a time in the process, with the cyclic garbage
    collector paused. Engines in one process (a disaggregated pair) may
    reach a first use at once, and `torch.cuda.graph` synchronizes the
    device and frees cached memory before it begins, which must not
    land inside another thread's capture. A collection in the capturing
    thread would run the finalizers of unreachable objects there, and a
    dropped engine's CUDAGraph destroys its graph, an operation a
    capturing stream forbids: the capture would be invalidated. What
    became garbage meanwhile is collected after."""
    with _CAPTURE_LOCK:
        was = gc.isenabled()
        gc.disable()
        try:
            yield
        finally:
            if was:
                gc.enable()


class _Segments:
    """A capture cut at the hops (`segment_cut`): the graphs captured so
    far, each with the host action that runs after its replay (None
    for the last). The context's `cuda_graph` is moved to the open
    graph, so `torch.cuda.graph`'s exit ends the last one."""

    def __init__(self, ctx, pool):
        self.ctx, self.pool = ctx, pool
        self.parts = [[ctx.cuda_graph, None]]

    def cut(self, make):
        self._end(self.parts[-1][0])
        action, out = make()
        self.parts[-1][1] = action
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool,
                            capture_error_mode="thread_local")
        self.parts.append([graph, None])
        self.ctx.cuda_graph = graph
        return out

    @staticmethod
    def _end(graph) -> None:
        with warnings.catch_warnings():
            # a segment may hold no kernel (a step that begins with a
            # hop): its graph is empty, and its replay runs nothing
            warnings.filterwarnings("ignore", message=".*CUDA Graph is empty")
            graph.capture_end()


_SEGMENTS = threading.local()


def segment_cut(make):
    """Inside a capture: end the graph being captured, call make() ->
    (action, out) with no capture open (an allocation there is a
    static buffer outside the graphs' pool), and open the next graph;
    every replay of the variant runs action() between the two graphs.
    Returns (True, out). Outside a capture: (False, None), and the
    caller hops at once."""
    seg = getattr(_SEGMENTS, "seg", None)
    if seg is None:
        return False, None
    return True, seg.cut(make)


def _side_stream(device) -> torch.cuda.Stream:
    """The device's warm-up stream (callers hold _CAPTURE_LOCK)."""
    key = torch.device(device).index
    got = _SIDE_STREAMS.get(key)
    if got is None:
        got = _SIDE_STREAMS[key] = torch.cuda.Stream(device)
    return got


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


class _Graphs:
    """Captured steps over static buffers, one CUDA graph per variant,
    captured at the variant's first use and replayed after; on the CPU
    `replay` runs the step eagerly. A subclass gives `step(variant)` and
    `_idle(variant)` (the buffers set so that the warm-up changes
    nothing kept; it may return a callable that restores them after
    the warm-up). Runners given one `pool` share its memory."""

    def __init__(self, device, pool=None, on_capture=None):
        self.device = device
        self._cuda = device.type == "cuda"
        self._pool = pool
        self._graphs: dict = {}
        self._on_capture = on_capture
        # the last run's timing events (None on the CPU)
        self.timing: Optional[tuple] = None

    @property
    def captures(self) -> int:
        """Variants captured so far (0 on the CPU)."""
        return len(self._graphs)

    def _zeros(self, *shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def step(self, variant) -> None:
        raise NotImplementedError

    def _idle(self, variant):
        raise NotImplementedError

    def captured(self, variant):
        """The captured step of this variant, captured at first use: a
        warm-up on a side stream with the buffers idle (`_idle`), then
        the capture (which runs nothing)."""
        got = self._graphs.get(variant)
        if got is not None:
            return got
        t0 = time.perf_counter()
        with _capturing():
            undo = self._idle(variant)
            cur = torch.cuda.current_stream(self.device)
            side = _side_stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self.step(variant)
            cur.wait_stream(side)
            if undo is not None:
                undo()
            graph = torch.cuda.CUDAGraph()
            before = _snapshot()
            _HOOKS.hooks = hooks = []
            # the segments of one variant share a pool (a tensor one
            # hands the next stays alive while the next is captured)
            pool = (self._pool if self._pool is not None
                    else torch.cuda.graph_pool_handle())
            ctx = torch.cuda.graph(graph, pool=pool,
                                   capture_error_mode="thread_local")
            try:
                with ctx:
                    _SEGMENTS.seg = seg = _Segments(ctx, pool)
                    try:
                        self.step(variant)
                    finally:
                        _SEGMENTS.seg = None
            finally:
                _HOOKS.hooks = None
        delta = _increase(before)
        _add(delta, -1)              # the capture launched nothing
        self._graphs[variant] = got = (seg.parts, delta, hooks)
        if self._on_capture is not None:
            self._on_capture(variant, time.perf_counter() - t0)
        return got

    def replay(self, variant) -> None:
        """One step: the graph's replay on CUDA (its kernels' launches
        counted), the eager step on the CPU."""
        if not self._cuda:
            self.step(variant)
            return
        parts, delta, hooks = self.captured(variant)
        t0 = time.perf_counter()
        for graph, hop in parts:
            graph.replay()
            if hop is not None:
                hop()
        _add(delta, 1)
        if hooks:
            dt = time.perf_counter() - t0
            for hook in hooks:
                hook(dt)

    def _put(self, dst: torch.Tensor, values) -> None:
        """Host values into a device buffer; on the card from pinned
        memory (a fresh block of the caching host allocator, which reuses
        it only after this copy has run), so the host does not wait for
        the stream and two puts in flight never share their staging."""
        src = torch.as_tensor(np.asarray(values)).to(dst.dtype)
        if self._cuda:
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)


class _Runner(_Graphs):
    """What the engine's two step runners share: the engine's sampling
    state, the outputs ([B, cols] ids and logprobs, [B, cols, n_top_cap]
    top ids and logprobs) with two pinned host copies used in turn, and
    the step's last logits."""

    def __init__(self, params, cache, rope, config, *, ring: torch.Tensor,
                 seeds: torch.Tensor, counters: torch.Tensor, cols: int,
                 n_top_cap: int, top_k: Optional[int], pool=None,
                 on_capture=None):
        super().__init__(ring.device, pool=pool, on_capture=on_capture)
        self.params, self.cache, self.rope = params, cache, rope
        self.config, self.top_k = config, top_k
        self.ring, self.seeds, self.counters = ring, seeds, counters
        self.B = B = ring.shape[0]
        # the last step's logits (what a comparison of two runs reads)
        self.logits = self._zeros(B, config.vocab_size, dtype=torch.float32)
        self.out = (self._zeros(B, cols, dtype=torch.int64),
                    self._zeros(B, cols, dtype=torch.float32),
                    self._zeros(B, cols, n_top_cap, dtype=torch.int64),
                    self._zeros(B, cols, n_top_cap, dtype=torch.float32))
        # two host copies of the outputs, used in turn (double buffering)
        self._host = [tuple(torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=self._cuda)
                            for t in self.out) for _ in range(2)]
        self._turn = 0

    def reset_carry(self) -> None:
        """Zero the per-step buffers in place (a recovery keeps the
        graphs, whose addresses these are)."""
        raise NotImplementedError

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

    def __init__(self, params, cache, rope, config, *, forward_fn,
                 ring: torch.Tensor, seeds: torch.Tensor,
                 counters: torch.Tensor, max_steps: int, n_top_cap: int,
                 top_k: Optional[int], pool=None, on_capture=None):
        super().__init__(params, cache, rope, config, ring=ring, seeds=seeds,
                         counters=counters, cols=max_steps,
                         n_top_cap=n_top_cap, top_k=top_k, pool=pool,
                         on_capture=on_capture)
        # the ragged forward(params, tokens, cache, pos, live, rope,
        # config): paged.forward_ragged_paged with its attn bound, or
        # model.forward_ragged (dense) or forward_ragged_ring (ring)
        self.forward_fn = forward_fn
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
        logits, _ = self.forward_fn(
            self.params, self.tok[:, None], self.cache, self.pos, live,
            self.rope, self.config)
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

    def _idle(self, _variant) -> None:
        """Every row frozen (budget 0), from column 0: a frozen row's
        write lands on the pool's sink page, or on a dense cache is its
        own old line written back."""
        self.live.zero_()
        self.budget.zero_()
        self.col.zero_()

    def reset_carry(self) -> None:
        for t in (self.tok, self.pos, self.live, self.steps, self.steps_in,
                  self.budget, self.col, self.temp, self.top_p,
                  self.penalty):
            t.zero_()

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
        super().__init__(params, cache, rope, config, ring=ring, seeds=seeds,
                         counters=counters, cols=1, n_top_cap=n_top_cap,
                         top_k=top_k, pool=pool, on_capture=on_capture)
        B, zeros = self.B, self._zeros
        self.attn, self.step_fn = attn, step_fn
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

    def _idle(self, _variant) -> None:
        """Every row idle (q_len 0, inactive) and none emitting."""
        self.q_len.zero_()
        self.active.zero_()
        self.emit.zero_()

    def reset_carry(self) -> None:
        for t in (self.tokens, self.pos, self.q_len, self.active, self.emit,
                  self.steps, self.temp, self.top_p, self.penalty):
            t.zero_()

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


# the JAX function each kind of one-slot prefill counts its captures as
PREFILL_FNS = {"slot": "prefill_slot_paged",
               "prefixed": "prefill_slot_paged_prefixed",
               "chunk": "prefill_slot_paged_chunk"}


class _PrefillBuffers(NamedTuple):
    tokens: torch.Tensor    # [1, S] int32
    n: torch.Tensor         # [1] int32: prompt_len / suffix_len / n_real
    slot: torch.Tensor      # [1] int64
    pos0: torch.Tensor      # [1] int32 (the chunk's window start)
    targets: tuple          # the writes' targets, fixed shapes


class PrefillRunner(_Graphs):
    """The phase-split loop's one-slot prefills (`--mixed-batch off`) as
    CUDA graphs: JAX's jitted `prefill_slot_paged`,
    `prefill_slot_paged_prefixed` and `prefill_slot_paged_chunk`, one
    variant per JAX compile key, ("slot", S) by bucket, ("prefixed",
    n_prefix, S) and ("chunk", C). Each variant has static buffers: the
    window's tokens, the real token count, the slot and the chunk's pos0,
    which the prefills read on the device (the table row by
    index_select, the rope rows and the last token by device index, pos0
    by the cached flash kernel), and the write targets, computed on the
    host from the host's copy of the slot's row with fixed shapes (an
    unmapped window or a dropped position on the sink page).

    `run` puts the host inputs (from pinned memory, no wait for the
    stream), replays, and returns the logits buffer [1, V]; the engine
    samples it before the next replay overwrites it (stream order). A
    variant is captured at its first use after a warm-up on a side
    stream whose writes all land on the sink page. On the CPU `replay`
    runs the prefill eagerly over the same buffers."""

    def __init__(self, params, cache, rope, config, *, attn: str,
                 pool=None, on_capture=None):
        super().__init__(cache.table.device, pool=pool,
                         on_capture=on_capture)
        self.params, self.cache, self.rope = params, cache, rope
        self.config, self.attn = config, attn
        self.logits = self._zeros(1, config.vocab_size, dtype=torch.float32)
        self._bufs: dict = {}

    def _buffers(self, variant, targets) -> _PrefillBuffers:
        got = self._bufs.get(variant)
        if got is None:
            moved = [self._zeros(*t.shape, dtype=t.dtype) for t in targets]
            got = _PrefillBuffers(
                tokens=self._zeros(1, variant[-1], dtype=torch.int32),
                n=self._zeros(1, dtype=torch.int32),
                slot=self._zeros(1, dtype=torch.int64),
                pos0=self._zeros(1, dtype=torch.int32),
                targets=(targets._make(moved) if hasattr(targets, "_make")
                         else tuple(moved)))
            self._bufs[variant] = got
        return got

    def step(self, variant) -> None:
        b = self._bufs[variant]
        kw = dict(attn=self.attn, targets=b.targets)
        if variant[0] == "slot":
            logits, _ = prefill_slot_paged(
                self.params, b.tokens, b.n, b.slot, self.cache, self.rope,
                self.config, **kw)
        elif variant[0] == "prefixed":
            logits, _ = prefill_slot_paged_prefixed(
                self.params, b.tokens, b.n, b.slot, self.cache, self.rope,
                self.config, n_prefix=variant[1], **kw)
        else:
            logits, _ = prefill_slot_paged_chunk(
                self.params, b.tokens, b.n, b.slot, b.pos0, self.cache,
                self.rope, self.config, **kw)
        self.logits.copy_(logits)

    def _idle(self, variant) -> None:
        """Every write on the sink page (one real token, slot 0, pos0
        0): the warm-up reads real pages and writes none."""
        b = self._bufs[variant]
        b.n.fill_(1)
        b.slot.zero_()
        b.pos0.zero_()
        t = b.targets
        # the pages of (windows, pages), (rows, cols, pages, offsets) or
        # a quantized pool's WindowTargets
        pages = (t.pages if isinstance(t, WindowTargets)
                 else t[1] if len(t) == 2 else t[2])
        pages.fill_(self.cache.n_pages)

    def reset_carry(self) -> None:
        """Zero every variant's inputs in place (a recovery keeps the
        graphs)."""
        for b in self._bufs.values():
            for t in (b.tokens, b.n, b.slot, b.pos0, *b.targets):
                t.zero_()

    def run(self, variant, tokens, n: int, slot: int, pos0: int,
            targets) -> torch.Tensor:
        """One prefill of `variant`: tokens (the window's S ids), n (its
        real tokens), slot, pos0 (the chunk's start; 0 otherwise) and the
        host write targets up, then the replay. Returns the logits buffer
        [1, V] (valid until the next replay)."""
        b = self._buffers(variant, targets)
        if self._cuda:
            self.captured(variant)   # before the puts: the warm-up idles
        self._put(b.tokens, [list(tokens)])
        for dst, v in ((b.n, [n]), (b.slot, [slot]), (b.pos0, [pos0])):
            self._put(dst, v)
        for dst, v in zip(b.targets, targets):
            self._put(dst, v)
        self.replay(variant)
        return self.logits


# the JAX function each kind of dense one-slot step counts its captures as
DENSE_PREFILL_FNS = {"slot": "prefill_slot", "chunk": "prefill_slot_chunk",
                     "ring": "prefill_slot_chunk_ring",
                     "prefixed": "prefill_slot_prefixed",
                     "install": "install_prefix_slot"}


class DensePrefillRunner(_Graphs):
    """The dense and ring engines' one-slot steps as CUDA graphs: JAX's
    jitted `prefill_slot` (a variant ("slot", S) a bucket),
    `prefill_slot_chunk` (("chunk", C)), `prefill_slot_chunk_ring`
    (("ring", C)), `prefill_slot_prefixed` (("prefixed", P, S)) and
    `install_prefix_slot` (("install", P)), one variant per JAX compile
    key. Static buffers a variant: the window's tokens [1, S], its real
    token count, the slot and the window's pos0, which the step reads on
    the device (the slot by the per-layer splice, pos0 by the rope rows,
    the mask, the cache writes and the cached flash kernel), and for a
    prefix the registered head's k/v [L, 1, P, KV, hd], copied in on the
    device before the replay. One graph serves every slot.

    `run` puts the host inputs (from pinned memory, no wait for the
    stream), captures the variant at its first use, replays, and returns
    the logits buffer [1, V]. The warm-up before a capture runs the real
    step: a dense window's writes land where the replay writes the same
    values, since they depend only on the window's tokens and the cache
    before pos0, which no window writes. A ring window reads the ring
    before it writes it, so its warm-up runs with no real token (every
    entry keeps its slot) and the count is restored after it. On the CPU
    `replay` runs the step eagerly over the same buffers.

    fns: {"slot", "chunk", "ring"} -> the engine's custom step fns (a
    topology-sharded model's pipelined prefills, the sp engine's ring
    prefill) in place of the model's functions, with their signatures;
    device: the steps' device (default the cache's k's)."""

    def __init__(self, params, cache, rope, config, *, pool=None,
                 on_capture=None, fns=None, device=None):
        super().__init__(device if device is not None else cache.k.device,
                         pool=pool, on_capture=on_capture)
        self.params, self.cache, self.rope = params, cache, rope
        self.config = config
        self._fns = {"slot": prefill_slot, "chunk": prefill_slot_chunk,
                     "ring": prefill_slot_chunk_ring}
        self._fns.update(fns or {})
        self.logits = self._zeros(1, config.vocab_size, dtype=torch.float32)
        self._bufs: dict = {}
        self._prefix: dict = {}     # P -> (k, v) static buffers

    def _buffers(self, variant) -> _PrefillBuffers:
        got = self._bufs.get(variant)
        if got is None:
            S = variant[-1] if variant[0] != "install" else 1
            got = _PrefillBuffers(
                tokens=self._zeros(1, S, dtype=torch.int32),
                n=self._zeros(1, dtype=torch.int32),
                slot=self._zeros(1, dtype=torch.int64),
                pos0=self._zeros(1, dtype=torch.int32),
                targets=())
            self._bufs[variant] = got
        return got

    def _prefix_buffers(self, P: int):
        got = self._prefix.get(P)
        if got is None:
            k = self.cache.k
            shape = (k.shape[0], 1, P, k.shape[3], k.shape[4])
            got = (torch.zeros(shape, dtype=k.dtype, device=self.device),
                   torch.zeros(shape, dtype=k.dtype, device=self.device))
            self._prefix[P] = got
        return got

    def step(self, variant) -> None:
        b = self._bufs[variant]
        kind = variant[0]
        if kind == "install":
            pk, pv = self._prefix[variant[1]]
            install_prefix_slot(self.cache, pk, pv, b.slot)
            return
        args = (self.params, b.tokens, b.n, b.slot)
        if kind == "slot":
            logits, _ = self._fns["slot"](*args, self.cache, self.rope,
                                          self.config)
        elif kind in ("chunk", "ring"):
            logits, _ = self._fns[kind](*args, b.pos0, self.cache,
                                        self.rope, self.config)
        else:
            pk, pv = self._prefix[variant[1]]
            logits, _ = prefill_slot_prefixed(*args, pk, pv, self.cache,
                                              self.rope, self.config)
        self.logits.copy_(logits)

    def _idle(self, variant):
        """The real step, except a ring window: no real token, so it
        writes no slot (the count is restored after the warm-up)."""
        if variant[0] != "ring":
            return None
        b = self._bufs[variant]
        n = b.n.clone()
        b.n.zero_()
        return lambda: b.n.copy_(n)

    def reset_carry(self) -> None:
        """Zero every variant's inputs and the prefix buffers in place (a
        recovery keeps the graphs)."""
        for b in self._bufs.values():
            for t in (b.tokens, b.n, b.slot, b.pos0):
                t.zero_()
        for pk, pv in self._prefix.values():
            zero_(pk)
            zero_(pv)

    def run(self, variant, tokens=(), n: int = 0, slot: int = 0,
            pos0: int = 0, prefix=None) -> torch.Tensor:
        """One step of `variant`: tokens (the window's S ids), n (its real
        tokens), slot, pos0 (a chunk's start) and a prefix's (k, v) in,
        then the capture at first use and the replay. Returns the logits
        buffer [1, V] (valid until the next replay; an install leaves it
        as it was)."""
        b = self._buffers(variant)
        if tokens:
            self._put(b.tokens, [list(tokens)])
        for dst, v in ((b.n, [n]), (b.slot, [slot]), (b.pos0, [pos0])):
            self._put(dst, v)
        if prefix is not None:
            for dst, src in zip(self._prefix_buffers(prefix[0].shape[2]),
                                prefix):
                dst.copy_(src)
        if self._cuda:
            self.captured(variant)   # after the puts: the warm-up is real
        self.replay(variant)
        return self.logits


class GeneratorRunner(_Graphs):
    """The sequential generator's decode step as a CUDA graph: JAX's
    jitted `decode_step` and its `sample_tokens` (the body of
    `_generate_scan`'s scan), captured once per `top_k` and replayed a
    token. Static buffers: the token [B], the position [1] (the dense
    forward's rope rows, mask and cache write read it on the device),
    the ring [B, N], the rows' random streams (seeds and counters, the
    engine's counter-based streams: every step samples, so every step
    advances them), the sampling options [B], and the tokens out
    [B, cols], written at column `col`. A replay needs no host value, so
    `generate_on_device` replays it num_tokens - 1 times and fetches
    `out` once; `next_token` fetches `tok` after each.

    The warm-up before a capture runs the real step (its cache write
    lands where the first replay writes the same values) and the carry
    is restored after it. On the CPU `replay` runs the step eagerly.
    forward_fn(params, tokens, cache, pos, rope): a sharded model's
    pipelined forward in place of the dense `forward`."""

    def __init__(self, params, cache, rope, config, ring: torch.Tensor, *,
                 cols: int, pool=None, forward_fn=None):
        super().__init__(ring.device, pool=pool)
        self.params, self.cache, self.rope = params, cache, rope
        self.forward_fn = forward_fn
        self.config, self.ring, self.cols = config, ring, cols
        self.B = B = ring.shape[0]
        z = self._zeros
        self.tok = z(B, dtype=torch.int64)
        self.pos = z(1, dtype=torch.int64)
        self.steps = z(B, dtype=torch.int64)
        self.col = z(1, dtype=torch.int64)
        self.seeds = z(B, dtype=torch.int64)
        self.counters = z(B, dtype=torch.int64)
        self.live = torch.ones(B, dtype=torch.bool, device=self.device)
        self.temp = z(B, dtype=torch.float32)
        self.top_p = z(B, dtype=torch.float32)
        self.penalty = z(B, dtype=torch.float32)
        self.logits = z(B, config.vocab_size, dtype=torch.float32)
        self.out = z(B, cols, dtype=torch.int64)
        # the SamplingConfig whose options the buffers hold
        self.options = None

    @torch.inference_mode()
    def set_options(self, sampling) -> None:
        """A SamplingConfig's options into the rows' buffers (greedy at
        temperature None or <= 0, no nucleus at top_p None); top_k is
        the variant `replay` and `sample` take."""
        B, t = self.B, sampling.temperature
        self._put(self.temp, [0.0 if t is None else t] * B)
        self._put(self.top_p, [1.0 if sampling.top_p is None
                               else sampling.top_p] * B)
        self._put(self.penalty, [sampling.repeat_penalty] * B)
        self.options = sampling

    @torch.inference_mode()
    def begin(self, pos: int, steps: int, tok: Optional[int] = None,
              col: int = 0, seeds=None) -> None:
        """The host's values up (no wait for the stream): the position
        of the next forward, the ring slot of the next sample (`steps`),
        the last token when given, the output column, and with `seeds`
        new random streams from counter 0."""
        B = self.B
        self._put(self.pos, [pos])
        self._put(self.steps, [steps] * B)
        self._put(self.col, [col])
        if tok is not None:
            self._put(self.tok, [tok] * B)
        if seeds is not None:
            self._put(self.seeds, seeds)
            self.counters.zero_()

    @torch.inference_mode()
    def sample(self, logits, top_k: Optional[int]) -> torch.Tensor:
        """Sample every row from `logits` [B, V] (`masked_sample`), push
        the ring, write the token at column `col`; in place."""
        nxt, counters, ring, _, _, _ = masked_sample(
            self.live, self.seeds, self.counters, logits, self.ring,
            self.steps, self.temp, self.top_p, self.penalty, top_k=top_k)
        self.counters.copy_(counters)
        self.ring.copy_(ring)
        self.tok.copy_(nxt)
        self.steps.add_(1)
        self.out.index_copy_(1, self.col, nxt[:, None])
        self.col.add_(1).remainder_(self.cols)
        return nxt

    @torch.inference_mode()
    def step(self, top_k: Optional[int]) -> None:
        """One decode step from the carry: the forward at `pos`, then
        the sample."""
        if self.forward_fn is None:
            logits, _ = forward(self.params, self.tok[:, None], self.cache,
                                self.pos, self.rope, self.config)
        else:
            logits, _ = self.forward_fn(self.params, self.tok[:, None],
                                        self.cache, self.pos, self.rope)
        self.logits.copy_(logits)
        self.pos.add_(1)
        self.sample(logits, top_k)

    def _idle(self, _variant):
        carry = (self.tok, self.pos, self.steps, self.col, self.counters,
                 self.ring)
        saved = [t.clone() for t in carry]

        def undo():
            for t, v in zip(carry, saved):
                t.copy_(v)
        return undo


class SpecHandle(NamedTuple):
    """One dispatched speculative round: its gamma, the host copies of
    (out, n_emit), ready once `event` has passed (None on the CPU), and
    the round's timing events (None on the CPU)."""

    gamma: int
    host: Tuple[torch.Tensor, torch.Tensor]
    event: Optional[torch.cuda.Event]
    timing: Optional[tuple] = None


class SpecRunner(_Graphs):
    """The engine's paged speculative round (`spec/round.spec_round_paged`,
    one jitted program per gamma in JAX) as a CUDA graph per gamma: gamma
    + 1 draft decode steps over the draft pool, the verify window over
    the target pool and the acceptance. Static buffers: the rows' last
    token, position, spec mask and temperature [B], the engine's random
    streams (seeds and counters, advanced in place by gamma + 3 for the
    active sampled rows), and the outputs out [B, max_gamma + 1] and
    n_emit [B]. The table rows change between rounds in place
    (`table_set_slot`), never inside a capture.

    `run` puts the host rows up from pinned memory, replays once, and
    dispatches the copy of (out, n_emit) to pinned host memory behind an
    event; `fetch` waits for that event, the round's one sync. The
    warm-up before a capture runs with every row inactive, so its writes
    land on both pools' sink pages and no counter moves. On the CPU
    `replay` runs the round eagerly over the same buffers."""

    def __init__(self, t_params, d_params, t_cache, d_cache, t_rope, d_rope,
                 t_config, d_config, *, attn: str, seeds: torch.Tensor,
                 counters: torch.Tensor, max_gamma: int, pool=None,
                 on_capture=None):
        super().__init__(seeds.device, pool=pool, on_capture=on_capture)
        self.t_params, self.d_params = t_params, d_params
        self.t_cache, self.d_cache = t_cache, d_cache
        self.t_rope, self.d_rope = t_rope, d_rope
        self.t_config, self.d_config, self.attn = t_config, d_config, attn
        self.seeds, self.counters = seeds, counters
        self.B = B = seeds.shape[0]
        z = self._zeros
        self.last = z(B, dtype=torch.int64)
        self.pos = z(B, dtype=torch.int32)
        self.active = z(B, dtype=torch.bool)
        self.temp = z(B, dtype=torch.float32)
        self.out = z(B, max_gamma + 1, dtype=torch.int64)
        self.n_emit = z(B, dtype=torch.int64)
        self._host = (torch.empty(self.out.shape, dtype=torch.int64,
                                  pin_memory=self._cuda),
                      torch.empty(B, dtype=torch.int64,
                                  pin_memory=self._cuda))

    def step(self, gamma: int) -> None:
        out, n_emit, counters = spec_round_paged(
            self.t_params, self.d_params, self.t_cache, self.d_cache,
            self.last[:, None], self.pos, self.active, self.seeds,
            self.counters, self.temp, self.t_rope, self.d_rope,
            self.t_config, self.d_config, gamma, attn=self.attn)
        self.out[:, :gamma + 1].copy_(out)
        self.n_emit.copy_(n_emit)
        self.counters.copy_(counters)

    def _idle(self, _gamma) -> None:
        """Every row inactive: the warm-up writes only the sink pages."""
        self.active.zero_()

    def reset_carry(self) -> None:
        for t in (self.last, self.pos, self.active, self.temp, self.out,
                  self.n_emit):
            t.zero_()

    def run(self, gamma: int, last, pos, active, temp) -> SpecHandle:
        """One round of the host rows ([B] each): the capture at gamma's
        first use, the puts, one replay, and the outputs' copy to the
        host, dispatched and not waited for."""
        if self._cuda:
            self.captured(gamma)     # before the puts: the warm-up idles
        for dst, v in ((self.last, last), (self.pos, pos),
                       (self.active, active), (self.temp, temp)):
            self._put(dst, v)
        start = mark(self.device)
        self.replay(gamma)
        self.timing = (start, mark(self.device)) if self._cuda else None
        for h, o in zip(self._host, (self.out, self.n_emit)):
            h.copy_(o, non_blocking=True)
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return SpecHandle(gamma, self._host, event, self.timing)

    @staticmethod
    def fetch(handle: SpecHandle):
        """(out [B, gamma + 1], n_emit [B]) as host arrays: the round's
        one wait for the stream."""
        if handle.event is not None:
            handle.event.synchronize()
        out, n_emit = handle.host
        return (out[:, :handle.gamma + 1].numpy().copy(),
                n_emit.numpy().copy())


class SpecGeneratorRunner(_Graphs):
    """The batch-1 speculative generator's round as a CUDA graph: JAX's
    jitted `spec_step` (and the body of `spec_scan`), captured once per
    (gamma, greedy) over the generator's dense caches. One round is
    gamma + 1 draft decode steps over the draft cache, one
    `forward_logits_all` verify of the gamma + 1-token window over the
    target cache, and the acceptance (spec/accept.py). Static buffers:
    the last token and its position [1] (the carry: a replay advances
    them to the round's last emitted token and the next frontier, so R
    chained replays are `spec_scan`'s R rounds), the row's random stream
    (a seed and a counter, advanced by gamma + 3 a sampled round), the
    temperature, and the outputs outs [R, gamma + 1] and ns [R], written
    at row `col`.

    The warm-up before a capture runs the real round (its cache writes
    land where the first replay writes the same values) and the carry is
    restored after it. On the CPU `replay` runs the round eagerly."""

    def __init__(self, t_params, d_params, t_cache, d_cache, t_rope, d_rope,
                 t_config, d_config, *, rounds: int, max_gamma: int,
                 pool=None, on_capture=None):
        super().__init__(t_cache.k.device, pool=pool, on_capture=on_capture)
        self.t_params, self.d_params = t_params, d_params
        self.t_cache, self.d_cache = t_cache, d_cache
        self.t_rope, self.d_rope = t_rope, d_rope
        self.t_config, self.d_config = t_config, d_config
        z = self._zeros
        self.tok = z(1, dtype=torch.int64)
        self.pos = z(1, dtype=torch.int64)
        self.seeds = z(1, dtype=torch.int64)
        self.counters = z(1, dtype=torch.int64)
        self.temp = torch.ones(1, dtype=torch.float32, device=self.device)
        self.col = z(1, dtype=torch.int64)
        self.outs = z(rounds, max_gamma + 1, dtype=torch.int64)
        self.ns = z(rounds, dtype=torch.int64)
        self._host = (torch.empty(self.outs.shape, dtype=torch.int64,
                                  pin_memory=self._cuda),
                      torch.empty(rounds, dtype=torch.int64,
                                  pin_memory=self._cuda))

    @torch.inference_mode()
    def step(self, variant) -> None:
        """One round from the carry, in place (JAX's `_spec_round`)."""
        gamma, greedy = variant
        temp = self.temp[:, None]
        tok = self.tok[:, None]
        drafts, d_probs = [], []
        for k in range(gamma + 1):
            logits, _ = forward(self.d_params, tok, self.d_cache,
                                self.pos + k, self.d_rope, self.d_config)
            if k == gamma:
                break     # the last draft's KV written; no proposal
            if greedy:
                probs = torch.softmax(logits, dim=-1)
                nxt = logits.argmax(dim=-1)
            else:
                probs = torch.softmax(logits / temp, dim=-1)
                nxt = categorical(self.seeds, self.counters + k, probs)
            drafts.append(nxt)
            d_probs.append(probs)
            tok = nxt[:, None]
        drafts = torch.stack(drafts, dim=1)              # [1, gamma]
        tokens_v = torch.cat([self.tok[:, None], drafts], dim=1)
        t_logits, _ = forward_logits_all(self.t_params, tokens_v,
                                         self.t_cache, self.pos, self.t_rope,
                                         self.t_config)  # [1, g+1, V]
        if greedy:
            out = t_logits.argmax(dim=-1)
            n_emit = greedy_accept(drafts, out) + 1
        else:
            t_probs = torch.softmax(t_logits / temp[..., None], dim=-1)
            u = uniforms(self.seeds, self.counters + gamma + 1, gamma)
            n_acc, resid = rejection_accept(
                drafts, torch.stack(d_probs, dim=1), t_probs, u, gamma)
            corr = categorical(self.seeds, self.counters + gamma + 2, resid)
            out = assemble_sampled(drafts, corr, n_acc, gamma)
            n_emit = n_acc + 1
            self.counters.copy_(advance_counters(
                self.counters, torch.ones_like(self.counters, dtype=torch.bool),
                gamma))
        cols = torch.arange(gamma + 1, device=out.device)
        out = torch.where(cols[None] < n_emit[:, None], out,
                          torch.full_like(out, -1))
        row = torch.full_like(self.outs[:1], -1)
        row[:, :gamma + 1] = out
        self.outs.index_copy_(0, self.col, row)
        self.ns.index_copy_(0, self.col, n_emit)
        self.col.add_(1)
        # the carry: the round's last emitted token at the next frontier
        self.tok.copy_(out.gather(1, (n_emit - 1)[:, None])[:, 0])
        self.pos.add_(n_emit)

    def _idle(self, _variant):
        carry = (self.tok, self.pos, self.counters, self.col)
        saved = [t.clone() for t in carry]

        def undo():
            for t, v in zip(carry, saved):
                t.copy_(v)
        return undo

    def begin(self, tok: int, pos: int, temp: float) -> None:
        """The round's start from the host (pinned puts, no wait): the
        last token, its position, the temperature; rows from 0."""
        for dst, v in ((self.tok, [tok]), (self.pos, [pos]),
                       (self.temp, [temp]), (self.col, [0])):
            self._put(dst, v)

    def set_stream(self, seed: int) -> None:
        """A new random stream from counter 0."""
        self._put(self.seeds, [seed])
        self.counters.zero_()

    def run(self, variant, rounds: int):
        """`rounds` chained replays from `begin`'s carry, then one fetch
        of (outs [rounds, gamma + 1], ns [rounds]) as host arrays."""
        if self._cuda:
            self.captured(variant)
        start = mark(self.device)
        for _ in range(rounds):
            self.replay(variant)
        self.timing = (start, mark(self.device)) if self._cuda else None
        for h, o in zip(self._host, (self.outs, self.ns)):
            h.copy_(o, non_blocking=True)
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()
        gamma = variant[0]
        outs, ns = self._host
        return (outs[:rounds, :gamma + 1].numpy().copy(),
                ns[:rounds].numpy().copy())


class DenseSpecRunner(_Graphs):
    """The dense spec engine's round (`speculative.spec_round_batched`,
    one jitted program per gamma in JAX) as a CUDA graph per gamma:
    gamma + 1 batched ragged draft steps over the draft cache, one
    windowed verify over the target cache and the acceptance. Static
    buffers: the carry, the rows' last token and position [B], which a
    replay advances to each active row's last emitted token and next
    frontier (so a chained round needs no host value, as JAX feeds the
    round's `state` back), the active mask and temperatures [B], the
    engine's random streams (seeds and counters, advanced in place by
    gamma + 3 for active sampled rows), and the outputs out
    [B, max_gamma + 1] and n_emit [B], copied after each round to one of
    two pinned host buffers in turn (two rounds may be in flight).

    The warm-up before a capture runs with every row inactive: an
    inactive row writes its own old lines back in both caches and keeps
    its carry and counter. On the CPU `replay` runs the round eagerly."""

    def __init__(self, t_params, d_params, t_cache, d_cache, t_rope, d_rope,
                 t_config, d_config, *, seeds: torch.Tensor,
                 counters: torch.Tensor, max_gamma: int, pool=None,
                 on_capture=None):
        super().__init__(seeds.device, pool=pool, on_capture=on_capture)
        self.t_params, self.d_params = t_params, d_params
        self.t_cache, self.d_cache = t_cache, d_cache
        self.t_rope, self.d_rope = t_rope, d_rope
        self.t_config, self.d_config = t_config, d_config
        self.seeds, self.counters = seeds, counters
        self.B = B = seeds.shape[0]
        z = self._zeros
        self.last = z(B, dtype=torch.int64)
        self.pos = z(B, dtype=torch.int32)
        self.active = z(B, dtype=torch.bool)
        self.temp = z(B, dtype=torch.float32)
        self.out = z(B, max_gamma + 1, dtype=torch.int64)
        self.n_emit = z(B, dtype=torch.int64)
        self._host = [(torch.empty(self.out.shape, dtype=torch.int64,
                                   pin_memory=self._cuda),
                       torch.empty(B, dtype=torch.int64,
                                   pin_memory=self._cuda))
                      for _ in range(2)]
        self._turn = 0

    def step(self, gamma: int) -> None:
        from cake_tpu_torch.models.llama.speculative import (
            spec_round_batched,
        )
        out, n_emit, counters, (last, pos) = spec_round_batched(
            self.t_params, self.d_params, self.t_cache, self.d_cache,
            self.last[:, None], self.pos, self.active, self.seeds,
            self.counters, self.temp, self.t_rope, self.d_rope,
            self.t_config, self.d_config, gamma)
        self.out[:, :gamma + 1].copy_(out)
        self.n_emit.copy_(n_emit)
        self.counters.copy_(counters)
        self.last.copy_(last[:, 0])
        self.pos.copy_(pos)

    def _idle(self, _gamma):
        active = self.active.clone()
        self.active.zero_()
        return lambda: self.active.copy_(active)

    def reset_carry(self) -> None:
        for t in (self.last, self.pos, self.active, self.temp, self.out,
                  self.n_emit):
            t.zero_()

    def load(self, last, pos, active, temp) -> None:
        """A fresh chain of rounds from the host rows ([B] each)."""
        for dst, v in ((self.last, last), (self.pos, pos),
                       (self.active, active), (self.temp, temp)):
            self._put(dst, v)

    def run(self, gamma: int) -> SpecHandle:
        """One round from the carry: the capture at gamma's first use, one
        replay, and the outputs' copy to the next host buffer,
        dispatched and not waited for."""
        if self._cuda:
            self.captured(gamma)
        start = mark(self.device)
        self.replay(gamma)
        self.timing = (start, mark(self.device)) if self._cuda else None
        host = self._host[self._turn]
        self._turn ^= 1
        for h, o in zip(host, (self.out, self.n_emit)):
            h.copy_(o, non_blocking=True)
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return SpecHandle(gamma, host, event, self.timing)
