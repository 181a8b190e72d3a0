"""Continuous-batching inference engine over the paged KV pool.

Counterpart of `cake_tpu/serve/engine.py`, restricted to its
`--kv-pages` + mixed-batch path:

  * a fixed pool of B decode slots shares ONE paged KV cache; the page
    allocator gates admission, and a slot maps its positions to pages
    through its table row (models/llama/paged.py);
  * admissions map their pages and join the very next device step as
    prefill-chunk rows beside the decode rows (`mixed_step_paged`), in
    fixed C-token windows; when no prompt is mid-prefill the engine runs
    the cheaper C=1 decode step (`forward_ragged_paged` + sampling);
  * every slot carries its own position, random stream (a seed and a
    counter on the device), repeat-penalty ring and sampling options,
    so a row's output depends only on its own request
    (ops/sampling.masked_sample);
  * tokens stream to per-request callbacks from the engine thread;
    EOS / max-token retirement releases the slot's pages.

The decode step, its sampling and its carry run through
`serve/graphs.DecodeRunner`: on CUDA always as a captured CUDA graph
(there is no eager decode step on the card), on the CPU eagerly.
`decode_scan_steps` K > 1 (--decode-scan) runs K steps a host round
trip while nobody waits and no prompt is mid-prefill, in double-buffered
bursts with the JAX engine's row rules (`_decode_burst`).

Device work happens only on the engine thread, under
torch.inference_mode(). Not ported yet: prefix sharing, SLO scheduling,
speculation, the host KV tier, fault injection and recovery, the
journal, autotune, multi-host, and the metrics planes.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from cake_tpu_torch.kv.quantized_pool import (
    QUANTIZED_CACHES, reset_page_scales,
)
from cake_tpu_torch.models.chat import History, Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import (
    encode_text, incremental_decode,
)
from cake_tpu_torch.models.llama.model import RopeTables
from cake_tpu_torch.models.llama.paged import (
    ATTN_IMPLS, PageAllocator, PagedKVCache, mixed_step_paged,
    table_set_slot,
)
from cake_tpu_torch.native.scheduler import make_scheduler
from cake_tpu_torch.ops.sampling import SamplingConfig, masked_sample
from cake_tpu_torch.serve.graphs import DecodeRunner
from cake_tpu_torch.utils.devices import resolve_device, resolve_dtype

log = logging.getLogger(__name__)


@dataclass
class _Request:
    rid: int
    prompt_ids: List[int]
    max_new_tokens: int
    temperature: float
    top_p: float
    repeat_penalty: float
    # (delta, is_final) — or (delta, is_final, n_done) when the callback
    # declares wants_count: n_done counts the finalized (token, logprob,
    # top) entries up to and including this delta
    stream: Optional[Callable[..., None]]
    stream_wants_count: bool = False
    # request asked for top-N alternatives (OpenAI top_logprobs)
    want_top: bool = False
    out_tokens: List[int] = field(default_factory=list)
    out_logprobs: List[float] = field(default_factory=list)
    # per emitted token: [(alt_token_id, alt_logprob), ...] top-N list
    out_top: List[list] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[Exception] = None
    slot: int = -1
    submit_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0
    _pending_text: str = ""


class RequestHandle:
    """Caller-side view of a submitted request."""

    def __init__(self, req: _Request, tokenizer, eos_ids):
        self._req = req
        self._tokenizer = tokenizer
        self._eos_ids = eos_ids

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._req.done.wait(timeout)

    @property
    def token_ids(self) -> List[int]:
        return [t for t in self._req.out_tokens if t not in self._eos_ids]

    @property
    def token_logprobs(self) -> List[tuple]:
        """(token_id, logprob) pairs aligned with token_ids (EOS dropped)."""
        return [(t, lp) for t, lp in zip(self._req.out_tokens,
                                         self._req.out_logprobs)
                if t not in self._eos_ids]

    @property
    def token_top_logprobs(self) -> List[list]:
        """Per emitted token, the top-N alternatives [(id, logprob)],
        aligned with token_ids (EOS dropped)."""
        return [top for t, top in zip(self._req.out_tokens,
                                      self._req.out_top)
                if t not in self._eos_ids]

    def text(self) -> str:
        if self._req.error is not None:
            raise self._req.error
        return self._tokenizer.decode(self.token_ids)


@dataclass
class EngineStats:
    """Aggregate throughput counters."""

    steps: int = 0
    tokens_generated: int = 0
    requests_completed: int = 0
    decode_time_s: float = 0.0
    prefill_time_s: float = 0.0
    errors: int = 0
    last_error: str = ""

    @property
    def decode_tokens_per_s(self) -> float:
        return (self.tokens_generated / self.decode_time_s
                if self.decode_time_s > 0 else 0.0)


class QueueFullError(Exception):
    """Admission queue full; retry_after seconds ride the API's 429."""

    def __init__(self, msg: str = "engine queue full",
                 retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = retry_after


class InferenceEngine:
    """Slot-based continuous batching over one shared paged KV pool."""

    def __init__(
        self,
        config: LlamaConfig,
        params,
        tokenizer,
        *,
        device="cuda",
        max_slots: int = 8,
        max_seq_len: int = 4096,
        max_queue: int = 1024,
        sampling: Optional[SamplingConfig] = None,
        seed: int = 299792458,
        cache_dtype=torch.bfloat16,
        prefill_chunk: Optional[int] = None,
        top_logprobs_cap: int = 20,
        kv_pages: Optional[int] = None,
        kv_page_size: int = 128,
        paged_attn: Optional[str] = None,
        mixed_batch: Optional[str] = None,
        kv_dtype: Optional[str] = None,
        decode_scan_steps: int = 1,
    ):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on "
                f"{self.device}")
        if kv_pages is None:
            raise NotImplementedError(
                "the dense-cache engine is not ported to cake_tpu_torch "
                "yet: pass kv_pages (--kv-pages) for the paged engine")
        mb = mixed_batch or "auto"
        if mb not in ("auto", "on", "off"):
            raise ValueError(
                f"--mixed-batch must be auto, on or off, got {mb!r}")
        if mb == "off":
            raise NotImplementedError(
                "--mixed-batch off (the phase-split prefill loop) is not "
                "ported to cake_tpu_torch yet")
        impl = paged_attn or "auto"
        if impl not in ATTN_IMPLS:
            raise ValueError(
                f"--paged-attn must be one of {ATTN_IMPLS}, got {impl!r}")
        if impl == "kernel" and self.device.type != "cuda":
            raise ValueError("--paged-attn kernel needs a CUDA device: the "
                             "ragged paged-attention kernels run only on "
                             "the card")
        if decode_scan_steps < 1:
            raise ValueError(
                f"--decode-scan must be >= 1, got {decode_scan_steps}")
        if prefill_chunk is not None and (
                prefill_chunk < 1 or max_seq_len % prefill_chunk != 0):
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must be >= 1 and divide "
                f"max_seq_len {max_seq_len}")
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.defaults = sampling or SamplingConfig()
        self.n_top = top_logprobs_cap
        self.paged_attn = impl
        # decode steps a host round trip (bursts of the captured step)
        self._decode_scan = decode_scan_steps
        # fixed mixed-chunk width: prompts walk the mixed step C tokens
        # per iteration
        self._mixed_chunk = (prefill_chunk if prefill_chunk is not None
                             else min(256, max_seq_len))
        self.rope = RopeTables.create(config, max_seq_len,
                                      device=self.device)
        # --kv-dtype: "int8"/"int4" select the quantized page pools (int8
        # pages or nibble-packed int4 pages + per-page, per-kv-head f32
        # scales); another name is a plain pool dtype; None keeps
        # cache_dtype
        self._quant_cache = QUANTIZED_CACHES.get(kv_dtype)
        self.kv_quant = self._quant_cache is not None
        self._pool_dtype = (resolve_dtype(kv_dtype)
                            if kv_dtype is not None and not self.kv_quant
                            else cache_dtype)
        self._pager = PageAllocator(kv_pages, kv_page_size)
        self.cache = self._new_cache(kv_pages, kv_page_size)
        self._slot_pages: dict = {}
        # slot -> in-flight prefill progress (req, ids, next window offset)
        self._mixed_pending: dict = {}
        self._page_blocked_rid: Optional[int] = None
        self._page_starved = False
        log.info("paged KV: %d pages x %d tokens, %s attention, %s storage "
                 "(%.2f GiB pool) on %s", kv_pages, kv_page_size, impl,
                 kv_dtype + "+scales" if self.kv_quant else self._pool_dtype,
                 self.cache.memory_bytes() / 2**30, self.device)

        self.scheduler = make_scheduler(max_slots, max_queue)
        self.stats = EngineStats()
        # the last retired requests, newest last (bench and smoke stats)
        self.retired: deque = deque(maxlen=1024)

        B = max_slots
        self._pos = np.zeros(B, np.int64)            # next write position
        self._last_tok = np.zeros(B, np.int64)
        self._steps = np.zeros(B, np.int64)          # generated per slot
        self._temp = np.full(B, self.defaults.temperature or 0.0,
                             np.float32)
        self._top_p = np.ones(B, np.float32)
        self._penalty = np.full(B, self.defaults.repeat_penalty,
                                np.float32)
        self._seed = seed
        self._reset_count = 0
        self._fresh_sampling_state()
        self._slot_req: List[Optional[_Request]] = [None] * B

        self._next_rid = 1
        self._rid_lock = threading.Lock()
        self._requests: dict = {}
        # rids whose callers gave up: drained by the ENGINE thread
        self._cancel_q: List[int] = []
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _fresh_sampling_state(self) -> None:
        """The device state of the rows' sampling, updated in place from
        here on: the repeat-penalty rings, and one random stream per slot
        (a seed and a counter), so a row's draws are independent of the
        other rows; the reset count keeps a post-error rebuild from
        replaying consumed streams. The decode runner holds these
        tensors, so a new set drops it."""
        B, dev = self.max_slots, self.device
        self._ring = torch.full((B, self.defaults.repeat_last_n), -1,
                                dtype=torch.int64, device=dev)
        base = self._seed * 1_000_003 + self._reset_count * 65_537
        self._seeds = torch.tensor([base + b for b in range(B)],
                                   dtype=torch.int64, device=dev)
        self._counters = torch.zeros(B, dtype=torch.int64, device=dev)
        self._runner: Optional[DecodeRunner] = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "InferenceEngine":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="cake-engine")
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self._drain_cancellations()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- submission -----------------------------------------------------------

    def submit(
        self,
        prompt_ids: Sequence[int],
        *,
        max_new_tokens: int = 100,
        temperature: Optional[float] = None,
        top_p: Optional[float] = None,
        repeat_penalty: Optional[float] = None,
        stream: Optional[Callable[..., None]] = None,
        want_top_logprobs: bool = False,
    ) -> RequestHandle:
        """Queue one generation. stream(text_delta, is_final) is called
        from the engine thread as tokens finalize; a callback with
        attribute `wants_count = True` instead gets (text_delta,
        is_final, n_done). The handle's wait()/text() is the blocking
        interface."""
        if self._stop.is_set():
            from cake_tpu_torch.serve.errors import EngineResetError
            raise EngineResetError("engine stopped")
        ids = list(prompt_ids)
        if not ids:
            raise ValueError("empty prompt")
        if len(ids) >= self.max_seq_len:
            raise ValueError(
                f"prompt length {len(ids)} exceeds max_seq_len "
                f"{self.max_seq_len}")
        max_new = min(max_new_tokens, self.max_seq_len - len(ids))
        need = self._pager.pages_for(len(ids) + max_new)
        if need > self.cache.n_pages:
            # can NEVER be admitted: fail fast instead of requeueing
            raise ValueError(
                f"request needs {need} kv pages; the pool has "
                f"{self.cache.n_pages} total (raise --kv-pages or lower "
                "max_tokens)")
        with self._rid_lock:
            rid = self._next_rid
            self._next_rid += 1
        d = self.defaults
        eff_temp = temperature if temperature is not None else d.temperature
        eff_top_p = top_p if top_p is not None else d.top_p
        req = _Request(
            rid=rid, prompt_ids=ids, max_new_tokens=max_new,
            temperature=eff_temp if eff_temp is not None else 0.0,
            top_p=eff_top_p if eff_top_p is not None else 1.0,
            repeat_penalty=(d.repeat_penalty if repeat_penalty is None
                            else repeat_penalty),
            stream=stream,
            stream_wants_count=bool(getattr(stream, "wants_count", False)),
            want_top=want_top_logprobs,
            submit_t=time.perf_counter(),
        )
        # register BEFORE scheduler.submit: the engine thread may plan
        # the rid immediately, and an unknown rid counts as cancelled
        self._requests[rid] = req
        if not self.scheduler.submit(rid, len(ids), max_new):
            self._requests.pop(rid, None)
            raise QueueFullError()
        self._wake.set()
        return RequestHandle(req, self.tokenizer, self.config.eos_token_ids)

    def chat(self, messages: Sequence[Message], **kw) -> RequestHandle:
        """Render a chat history through the model's template and submit."""
        hist = History(self.config.chat_template)
        for m in messages:
            hist.add_message(m)
        return self.submit(encode_text(self.tokenizer, hist.render()), **kw)

    def cancel(self, handle: RequestHandle) -> None:
        """Abandon a request (e.g. the streaming client disconnected):
        the engine thread frees its slot and pages."""
        with self._rid_lock:
            self._cancel_q.append(handle._req.rid)
        self._wake.set()
        if self._stop.is_set() and self._thread is None:
            self._drain_cancellations()

    def _drain_cancellations(self) -> None:
        with self._rid_lock:
            rids, self._cancel_q = self._cancel_q, []
        for rid in rids:
            req = self._requests.pop(rid, None)
            if req is None:
                continue
            self.scheduler.cancel(rid)
            if req.slot >= 0 and self._slot_req[req.slot] is req:
                self._slot_req[req.slot] = None
                self._release_slot_pages(req.slot)
            req.finish_t = time.perf_counter()
            req.done.set()

    @property
    def queue_depth(self) -> int:
        return self.scheduler.queue_depth

    @property
    def active(self) -> int:
        return self.scheduler.active

    # -- engine loop ----------------------------------------------------------

    def _run(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            with torch.inference_mode():
                self._run_loop()
        finally:
            self._drain_cancellations()

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            self._drain_cancellations()
            prefill_plan, decode_plan = self.scheduler.plan()
            if not prefill_plan and not decode_plan:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            if self._page_starved:
                # a page-starved admission was requeued last iteration;
                # with no decode work to retire pages, back off instead
                # of spin-planning the same admission
                self._page_starved = False
                if not decode_plan:
                    self._wake.wait(timeout=0.02)
                    self._wake.clear()
            try:
                self._do_mixed(prefill_plan, decode_plan)
            except Exception as e:  # noqa: BLE001
                log.exception("engine iteration failed")
                self.stats.errors += 1
                self.stats.last_error = f"{type(e).__name__}: {e}"
                self._fail_all(e)
                self._reset_after_error()

    def _new_cache(self, n_pages: int, page_size: int):
        """An empty pool of the configured storage: int8 or int4 pages
        with scales, or f32/bf16 pages."""
        if self.kv_quant:
            return self._quant_cache.create(
                self.config, self.max_slots, n_pages, page_size,
                self.max_seq_len, device=self.device)
        return PagedKVCache.create(
            self.config, self.max_slots, n_pages, page_size,
            self.max_seq_len, dtype=self._pool_dtype, device=self.device)

    def _reset_after_error(self) -> None:
        """A failed step may leave the pool half-written: rebuild the
        pool (of the same storage), the allocator, every per-slot mirror
        and the sampling state, and drop the decode runner."""
        self.cache = self._new_cache(self.cache.n_pages,
                                     self.cache.page_size)
        self._pager = PageAllocator(self.cache.n_pages, self.cache.page_size)
        self._slot_pages = {}
        self._mixed_pending = {}
        self._page_blocked_rid = None
        self._pos[:] = 0
        self._last_tok[:] = 0
        self._steps[:] = 0
        self._reset_count += 1
        # the runner's graphs captured the old pool: capture anew
        self._fresh_sampling_state()

    # -- pages ----------------------------------------------------------------

    def _release_slot_pages(self, slot: int) -> None:
        """Release a slot's pages (idempotent: every teardown path pops
        the same entry) and drop any prefill still pending for it. The
        slot's table row is unmapped too: a decode step still passes the
        idle row's stale position, and an unmapped row reads no pages."""
        if slot < 0:
            return
        self._mixed_pending.pop(slot, None)
        pages = self._slot_pages.pop(slot, None)
        if pages:
            self._pager.release(pages)
            table_set_slot(self.cache.table, slot, [])

    def _alloc_slot_pages(self, req: _Request, slot: int) -> bool:
        """Admission by pages: map the slot's table row when the pool
        covers prompt + budget, else requeue the request. A page-starved
        request becomes the blocking head: younger requests requeue
        behind it instead of being admitted past it."""
        blocked = self._page_blocked_rid
        if blocked is not None and blocked not in self._requests:
            blocked = self._page_blocked_rid = None     # cancelled/failed
        if blocked is not None and req.rid != blocked:
            return self._requeue_for_pages(req, slot, starved=False)
        pages = self._pager.alloc(len(req.prompt_ids) + req.max_new_tokens)
        if pages is None:
            return self._requeue_for_pages(req, slot, starved=True)
        self._slot_pages[slot] = pages
        table_set_slot(self.cache.table, slot, pages)
        if self.kv_quant:
            # fresh pages must not inherit a previous occupant's scales
            reset_page_scales(self.cache, pages)
        if req.rid == blocked:
            self._page_blocked_rid = None
        return True

    def _requeue_for_pages(self, req: _Request, slot: int,
                           starved: bool) -> bool:
        self._slot_req[slot] = None
        req.slot = -1
        self._page_starved = True
        if starved and self._page_blocked_rid is None:
            self._page_blocked_rid = req.rid
        self.scheduler.cancel(req.rid)
        if not self.scheduler.submit(req.rid, len(req.prompt_ids),
                                     req.max_new_tokens):
            req.error = RuntimeError(
                "kv page pool exhausted and admission queue full")
            self._requests.pop(req.rid, None)
            if self._page_blocked_rid == req.rid:
                self._page_blocked_rid = None
            req.done.set()
        return False

    # -- steps ----------------------------------------------------------------

    def _do_mixed(self, prefill_plan, decode_plan) -> None:
        """One engine iteration of token-level continuous batching:
        admissions map their pages and join the very next device step as
        prefill-chunk rows beside the decode rows. With no prompt
        mid-prefill, the C=1 decode step is the cheaper program."""
        for rid, slot in prefill_plan:
            self._mixed_admit(rid, slot)
        if not self._mixed_pending:
            # pure decode: K-step bursts while nothing is admitting
            if decode_plan:
                n = self._scan_steps_for(decode_plan)
                if n > 1:
                    self._decode_burst(decode_plan, n)
                else:
                    self._do_decode(decode_plan)
            return
        self._mixed_dispatch(decode_plan)

    def _mixed_admit(self, rid: int, slot: int) -> None:
        """Admission for the mixed path: page mapping and sampling-state
        setup, no device dispatch; the prompt's windows ride the next
        mixed step(s) as chunk rows."""
        req = self._requests.get(rid)
        if req is None:  # cancelled between plan and here
            self.scheduler.cancel(rid)
            return
        req.slot = slot
        self._slot_req[slot] = req
        if not self._alloc_slot_pages(req, slot):
            return   # pool exhausted: requeued (or failed) inside
        self._temp[slot] = req.temperature
        self._top_p[slot] = req.top_p
        self._penalty[slot] = req.repeat_penalty
        self._ring[slot] = -1          # a fresh repeat-penalty ring
        self._steps[slot] = 0
        self._pos[slot] = 0
        self._mixed_pending[slot] = {"req": req, "ids": req.prompt_ids,
                                     "off": 0}

    def _device_rows(self, tokens, pos, qlen=None, active=None):
        dev = self.device
        out = [torch.as_tensor(tokens, dtype=torch.int32, device=dev),
               torch.as_tensor(pos, dtype=torch.int32, device=dev)]
        if qlen is not None:
            out.append(torch.as_tensor(qlen, dtype=torch.int32, device=dev))
        out.append(torch.as_tensor(active, dtype=torch.bool, device=dev))
        return out

    def _mixed_dispatch(self, decode_plan) -> None:
        """Build and run ONE mixed step: every decode row contributes its
        last token (q_len=1), every mid-prefill slot its next window;
        rows whose window ends their prompt sample their first token from
        the same launch the decode rows sample their next."""
        t0 = time.perf_counter()
        B, C = self.max_slots, self._mixed_chunk
        tokens = np.zeros((B, C), np.int64)
        pos = np.zeros(B, np.int64)
        qlen = np.zeros(B, np.int64)
        active = np.zeros(B, bool)
        decode_rows: List[int] = []
        for rid, slot in decode_plan:
            if slot in self._mixed_pending:
                continue    # still prefilling: rides as a chunk row
            req = self._slot_req[slot]
            if req is None or req.rid != rid:
                continue
            tokens[slot, 0] = self._last_tok[slot]
            pos[slot] = min(self._pos[slot], self.max_seq_len - 1)
            qlen[slot] = 1
            active[slot] = True
            decode_rows.append(slot)
        chunk_rows: List[int] = []
        finished: List[int] = []
        for slot in sorted(self._mixed_pending):
            p = self._mixed_pending[slot]
            ids, off = p["ids"], p["off"]
            n = min(C, len(ids) - off)
            tokens[slot, :n] = ids[off:off + n]
            pos[slot] = off
            qlen[slot] = n
            active[slot] = True
            chunk_rows.append(slot)
            if off + n >= len(ids):
                finished.append(slot)
        if not decode_rows and not chunk_rows:
            return
        tok_d, pos_d, qlen_d, act_d = self._device_rows(tokens, pos, qlen,
                                                        active)
        logits, self.cache = mixed_step_paged(
            self.params, tok_d, pos_d, qlen_d, act_d, self.cache, self.rope,
            self.config, attn=self.paged_attn)
        emit_rows = decode_rows + finished
        # advance the prefill frontiers BEFORE sampling/emit: a finishing
        # row's _pos must read prompt-end when _emit checks the window cap
        for slot in chunk_rows:
            p = self._mixed_pending[slot]
            p["off"] += int(qlen[slot])
            self._pos[slot] = p["off"]
        nxt = lp = tids = tlps = None
        if emit_rows:
            nxt, lp, tids, tlps = self._sample_rows(
                logits, rows=emit_rows, n_top=self._n_top_for(emit_rows))
        self.stats.steps += 1
        dt = time.perf_counter() - t0
        # split the step wall by token share between prefill and decode
        chunk_toks = int(sum(qlen[s] for s in chunk_rows))
        pf = dt * chunk_toks / (chunk_toks + len(decode_rows))
        self.stats.prefill_time_s += pf
        self.stats.decode_time_s += dt - pf

        for slot in decode_rows:
            req = self._slot_req[slot]
            if req is None:
                continue
            self._pos[slot] += 1
            self._emit(req, int(nxt[slot]), logprob=float(lp[slot]),
                       top=self._top(tids, tlps, slot))
        for slot in finished:
            p = self._mixed_pending.pop(slot, None)
            if p is None:
                continue
            self._emit(p["req"], int(nxt[slot]), logprob=float(lp[slot]),
                       top=self._top(tids, tlps, slot))

    @staticmethod
    def _top(tids, tlps, slot) -> list:
        return (list(zip(tids[slot].tolist(), tlps[slot].tolist()))
                if tids.size else [])

    # -- the decode step and its bursts ---------------------------------------

    def _decode_runner(self) -> DecodeRunner:
        if self._runner is None:
            self._runner = DecodeRunner(
                self.params, self.cache, self.rope, self.config,
                attn=self.paged_attn, ring=self._ring, seeds=self._seeds,
                counters=self._counters, max_steps=self._decode_scan,
                n_top_cap=self.n_top, top_k=self.defaults.top_k)
        return self._runner

    def _dispatch_scan(self, rows, n: int, n_top: int, budget,
                       fresh: bool):
        """Dispatch n decode steps of the runner (no fetch). fresh: load
        the carry from the host mirrors; otherwise chain from the
        previous burst's carry on the device."""
        runner = self._decode_runner()
        if fresh:
            live = np.zeros(self.max_slots, bool)
            live[rows] = True
            runner.load(n_top, self._last_tok,
                        np.minimum(self._pos, self.max_seq_len - 1), live,
                        self._steps, self._temp, self._top_p,
                        self._penalty)
        return runner.run(n, budget, n_top)

    def _do_decode(self, decode_plan) -> None:
        """One decode step of every planned row (a burst of one)."""
        t0 = time.perf_counter()
        rows = [s for _, s in decode_plan]
        budget = self._scan_budget(decode_plan, 1)
        handle = self._dispatch_scan(rows, 1, self._n_top_for(rows), budget,
                                     fresh=True)
        fetched = DecodeRunner.fetch(handle)
        self.stats.steps += 1
        self.stats.decode_time_s += time.perf_counter() - t0
        self._complete_scan(decode_plan, 1, fetched, budget)

    def _scan_steps_for(self, decode_plan) -> int:
        """Steps a burst when multi-step decode is safe right now: nobody
        queued (a waiting request must not see its admission delayed by a
        whole burst) and K more writes fit every row's window. Rows with
        under K tokens of budget are fine (the step freezes each row at
        its budget); only when EVERY row is on its last token is one step
        the cheaper dispatch."""
        n = self._decode_scan
        if n <= 1 or self.scheduler.queue_depth > 0:
            return 1
        max_left = 0
        for _, slot in decode_plan:
            req = self._slot_req[slot]
            if req is None:
                return 1
            max_left = max(max_left,
                           req.max_new_tokens - len(req.out_tokens))
            if self._pos[slot] + n >= self.max_seq_len:
                return 1
        return n if max_left > 1 else 1

    def _scan_budget(self, decode_plan, n: int,
                     shipped: Optional[dict] = None) -> np.ndarray:
        """Per-row token allowance for one n-step burst: the request's
        remaining max_new_tokens, minus tokens already dispatched in
        not-yet-fetched bursts (`shipped`), capped at n. A row with 0
        allowance is frozen by the step."""
        budget = np.zeros(self.max_slots, np.int64)
        for _, slot in decode_plan:
            req = self._slot_req[slot]
            if req is None:
                continue
            left = req.max_new_tokens - len(req.out_tokens)
            if shipped:
                left -= shipped.get(slot, 0)
            budget[slot] = max(0, min(n, left))
        return budget

    def _host_attention_pending(self) -> bool:
        """Something on the host side needs the run loop back: stop,
        admissions waiting, or cancellations."""
        with self._rid_lock:
            cancels = bool(self._cancel_q)
        return (self._stop.is_set() or self.scheduler.queue_depth > 0
                or cancels)

    def _drive_burst(self, dispatch, complete, can_chain) -> None:
        """The double-buffered dispatch/fetch loop: dispatch burst k+1
        (chained from k's carry on the device) BEFORE completing k, so
        k's copy to the host and its emits overlap k+1's device work.
        dispatch(state) -> (devs, state'); complete(devs) fetches and
        emits one burst; can_chain(n_inflight) gates a dispatch after
        the host-attention gate."""
        inflight: list = []
        state = None
        while True:
            chain = (not self._host_attention_pending()
                     and can_chain(len(inflight)))
            if chain:
                devs, state = dispatch(state)
                inflight.append(devs)
            if not inflight:
                break
            if not chain or len(inflight) >= 2:
                complete(inflight.pop(0))

    def _decode_burst(self, decode_plan, n: int) -> None:
        """Chained n-step bursts while nothing needs the host: each
        dispatch is chained on the device from the previous burst's
        carry, and `shipped` projects the stale host mirrors past the
        bursts not yet fetched (budgets and the window guard). The
        decode time is counted as each burst is fetched, before its
        tokens are emitted, so a reader who sees a request retire also
        sees the time that produced its tokens."""
        clock = [time.perf_counter()]
        rows = [s for _, s in decode_plan]
        n_top = self._n_top_for(rows)
        shipped: dict = {}

        def can_chain(_n_inflight) -> bool:
            return (self._scan_budget(decode_plan, n, shipped).any()
                    and all(self._pos[s] + shipped.get(s, 0) + n
                            < self.max_seq_len for s in rows))

        def dispatch(state):
            budget = self._scan_budget(decode_plan, n, shipped)
            handle = self._dispatch_scan(rows, n, n_top, budget,
                                         fresh=state is None)
            for _, slot in decode_plan:
                shipped[slot] = shipped.get(slot, 0) + int(budget[slot])
            self.stats.steps += n
            return (handle, budget), True

        def complete(devs):
            handle, budget = devs
            fetched = DecodeRunner.fetch(handle)
            now = time.perf_counter()
            self.stats.decode_time_s += now - clock[0]
            clock[0] = now
            self._complete_scan(decode_plan, n, fetched, budget)
            for _, slot in decode_plan:
                shipped[slot] = shipped.get(slot, 0) - int(budget[slot])

        self._drive_burst(dispatch, complete, can_chain)
        self.stats.decode_time_s += time.perf_counter() - clock[0]

    def _complete_scan(self, decode_plan, n: int, fetched, budget) -> None:
        """Emit one fetched burst's tokens and advance the host mirrors.
        A row emits min(its budget, EOS cut) tokens, where the step froze
        it, so the mirrors advance by the emitted count."""
        toks, lps, tops_i, tops_l = fetched
        for rid, slot in decode_plan:
            req = self._slot_req[slot]
            if req is None or req.rid != rid:
                continue
            pos0 = int(self._pos[slot])
            emitted = 0
            for j in range(int(budget[slot])):
                # per-token position so _emit's cap check sees the value a
                # single step would have had
                self._pos[slot] = pos0 + j + 1
                emitted = j + 1
                self._last_tok[slot] = toks[slot, j]
                self._emit(req, int(toks[slot, j]),
                           logprob=float(lps[slot, j]),
                           top=(list(zip(tops_i[slot, j].tolist(),
                                         tops_l[slot, j].tolist()))
                                if tops_i.size else []))
                if req.done.is_set():
                    break            # EOS/budget: the step froze it here too
            self._steps[slot] += emitted
            self._pos[slot] = pos0 + emitted

    # -- sampling ---------------------------------------------------------------

    def _n_top_for(self, rows) -> int:
        for r in rows:
            req = self._slot_req[r]
            if req is not None and req.want_top:
                return self.n_top
        return 0

    def _sample_rows(self, logits, rows: List[int], n_top: int) -> tuple:
        """The mixed step's sampling: all B rows; counters and rings
        advance only for `rows` (an inactive slot's stream is untouched).
        Returns host arrays (next ids, logprobs, top ids, top logprobs)."""
        B = self.max_slots
        in_rows = np.zeros(B, bool)
        in_rows[rows] = True
        dev = self.device
        nxt, counters, ring, lp, top_ids, top_lps = masked_sample(
            torch.as_tensor(in_rows, device=dev), self._seeds,
            self._counters, logits, self._ring,
            torch.as_tensor(self._steps, device=dev),
            torch.as_tensor(self._temp, device=dev),
            torch.as_tensor(self._top_p, device=dev),
            torch.as_tensor(self._penalty, device=dev),
            top_k=self.defaults.top_k, n_top=n_top)
        self._counters.copy_(counters)
        self._ring.copy_(ring)
        nxt_h = nxt.cpu().numpy()
        for r in rows:
            self._steps[r] += 1
            self._last_tok[r] = nxt_h[r]
        return (nxt_h, lp.cpu().numpy(), top_ids.cpu().numpy(),
                top_lps.cpu().numpy())

    # -- token plumbing -------------------------------------------------------

    def _emit(self, req: _Request, token_id: int,
              logprob: float = 0.0, top=None) -> None:
        now = time.perf_counter()
        req.out_logprobs.append(logprob)
        req.out_top.append(top or [])
        if not req.out_tokens:
            req.first_token_t = now
        req.out_tokens.append(token_id)
        self.stats.tokens_generated += 1
        eos = token_id in self.config.eos_token_ids
        hit_cap = self._pos[req.slot] + 1 >= self.max_seq_len
        finished = self.scheduler.report(req.rid, 1, eos or hit_cap)
        if req.stream is not None:
            # final=finished flushes a held-back UTF-8 tail
            delta = self._incremental_text(req, final=finished)
            if delta or finished:
                try:
                    if req.stream_wants_count:
                        req.stream(delta, finished, len(req.out_tokens))
                    else:
                        req.stream(delta, finished)
                except Exception:  # noqa: BLE001
                    log.exception("stream callback failed rid=%d", req.rid)
        if finished:
            req.finish_t = now
            self._slot_req[req.slot] = None
            self._release_slot_pages(req.slot)
            self._requests.pop(req.rid, None)
            self.stats.requests_completed += 1
            self.retired.append(req)
            req.done.set()

    def _incremental_text(self, req: _Request, final: bool = False) -> str:
        ids = [t for t in req.out_tokens
               if t not in self.config.eos_token_ids]
        new, req._pending_text = incremental_decode(
            self.tokenizer, ids, req._pending_text, final=final)
        return new

    def _fail_all(self, err: Exception) -> None:
        """Fail every in-flight request with the typed (retryable) error."""
        from cake_tpu_torch.serve.errors import as_engine_error
        err = as_engine_error(err)
        for rid in list(self._requests):
            req = self._requests.pop(rid, None)
            if req is None:
                continue
            req.error = err
            self.scheduler.cancel(rid)
            if req.slot >= 0:
                self._slot_req[req.slot] = None
                self._release_slot_pages(req.slot)
            req.done.set()
