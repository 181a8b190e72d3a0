"""Continuous-batching inference engine over the paged KV pool.

Counterpart of `cake_tpu/serve/engine.py`, restricted to its
`--kv-pages` engine:

  * a fixed pool of B decode slots shares ONE paged KV cache; the page
    allocator gates admission, and a slot maps its positions to pages
    through its table row (models/llama/paged.py);
  * admissions map their pages and join the very next device step as
    prefill-chunk rows beside the decode rows (`mixed_step_paged` and
    the emitting rows' sampling, over fixed [B, C] descriptors), in
    C-token windows; when no prompt is mid-prefill the engine runs the
    cheaper C=1 decode step (`forward_ragged_paged` + sampling);
  * every slot carries its own position, random stream (a seed and a
    counter on the device), repeat-penalty ring and sampling options,
    so a row's output depends only on its own request
    (ops/sampling.masked_sample);
  * tokens stream to per-request callbacks from the engine thread;
    EOS / max-token retirement releases the slot's pages;
  * `--mixed-batch off` keeps the phase-split loop instead: each
    admission prefills alone (`prefill_slot_paged`, or C-token windows
    with --prefill-chunk), its first token sampled on the slot's own
    stream, PREFILL_FLUSH admissions a host round trip, then the planned
    rows decode;
  * shared prefixes (`register_prefix`, or `auto_prefix_system`: each
    distinct system prompt's rendered head) prefill once into pool pages
    (`prefill_prefix_pages`); a prompt that starts with one maps those
    pages, refcounted and read-only, at the head of its table row and
    prefills only its suffix.

Both steps run as captured CUDA graphs on the card (there is no eager
step there), and eagerly on the CPU: the decode step, its sampling and
its carry through `serve/graphs.DecodeRunner`, the mixed step and its
sampling through `serve/graphs.MixedRunner`. A mixed step's rows go up
from pinned memory without a wait for the stream; a step in which no
row emits (every row mid-prompt) fetches nothing, so a long prompt's
chunk-only steps queue back to back, and only a step with a row that
emits waits, once, for its outputs. A row leaving the mixed steps enters
the decode graph from the host mirrors. `decode_scan_steps` K > 1
(--decode-scan) runs K decode steps a host round trip while nobody
waits and no prompt is mid-prefill, in double-buffered bursts with the
JAX engine's row rules (`_decode_burst`).

Device work happens only on the engine thread, under
torch.inference_mode(); commands from other threads (a prefix
registration from an HTTP handler) run there between iterations
(`_run_on_engine_thread`). Not ported yet: SLO scheduling, speculation,
the host KV tier, fault injection and recovery, the journal, autotune,
multi-host, and the metrics planes.
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
from cake_tpu_torch.models.chat import BEGIN_OF_TEXT, History, Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import (
    bucket_length, chunk_windows, encode_text, incremental_decode,
)
from cake_tpu_torch.models.llama.model import RopeTables
from cake_tpu_torch.models.llama.paged import (
    ATTN_IMPLS, PageAllocator, PagedKVCache, mixed_step_paged,
    prefill_prefix_pages, prefill_slot_paged, prefill_slot_paged_chunk,
    prefill_slot_paged_prefixed, table_set_slot,
)
from cake_tpu_torch.native.scheduler import make_scheduler
from cake_tpu_torch.ops.sampling import SamplingConfig, masked_sample
from cake_tpu_torch.serve.graphs import DecodeRunner, MixedRunner
from cake_tpu_torch.utils.devices import (
    resolve_device, resolve_dtype, to_device,
)

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
    prefix_hits: int = 0     # prefills served from a registered prefix

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
        auto_prefix_system: bool = False,
        max_auto_prefixes: int = 8,
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
        # --mixed-batch off: the phase-split loop (whole-prompt or
        # C-token-window prefills, then decode)
        self._mixed = mb != "off"
        # the phase-split prefill's window (None = whole-prompt buckets);
        # it also decides which prefix hits can be served
        # (_prefix_window_plan), on both loops, as in JAX
        self.prefill_chunk = prefill_chunk
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
        # slot -> count of SHARED prefix pages at the head of its row
        # (the pages themselves ride _slot_pages for the refcounted
        # release)
        self._slot_prefix_pages: dict = {}
        self._prefix_pages_shared = 0
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
        # (fn, result box, done event): run on the engine thread
        self._cmd_q: list = []
        # registered prefixes: id -> (token ids, pool pages)
        self._prefixes: dict = {}
        self._next_prefix_id = 1
        # auto_prefix_system: chat() registers each distinct system
        # prompt's rendered head once, FIFO-capped at max_auto_prefixes;
        # head str -> prefix id | None (registration in flight) | -1
        # (a head too short or too long to share, negative-cached)
        self._auto_prefix = auto_prefix_system
        self._max_auto = max_auto_prefixes
        self._auto_pids: dict = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _fresh_sampling_state(self) -> None:
        """The device state of the rows' sampling, updated in place from
        here on: the repeat-penalty rings, and one random stream per slot
        (a seed and a counter), so a row's draws are independent of the
        other rows; the reset count keeps a post-error rebuild from
        replaying consumed streams. The runners hold these tensors, so
        a new set drops them."""
        B, dev = self.max_slots, self.device
        self._ring = torch.full((B, self.defaults.repeat_last_n), -1,
                                dtype=torch.int64, device=dev)
        base = self._seed * 1_000_003 + self._reset_count * 65_537
        self._seeds = torch.tensor([base + b for b in range(B)],
                                   dtype=torch.int64, device=dev)
        self._counters = torch.zeros(B, dtype=torch.int64, device=dev)
        self._runner: Optional[DecodeRunner] = None
        self._mixed_runner: Optional[MixedRunner] = None
        # the two runners' graphs share one memory pool on the card
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if dev.type == "cuda" else None)
        # mixed steps dispatched and not yet counted in the stats' times:
        # [first dispatch's clock, chunk tokens, decode rows]
        self._mixed_open: Optional[list] = None

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
        self._fail_pending_commands()

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
        """Render a chat history through the model's template and submit.

        With auto_prefix_system on, the system message's rendered head is
        prefilled once into shared pages per distinct system prompt, so
        every conversation sharing it prefills only its own turns."""
        hist = History(self.config.chat_template)
        for m in messages:
            hist.add_message(m)
        if (self._auto_prefix and messages
                and messages[0].role.value == "system"
                and hist.template == "llama3"):
            # the head below is the llama3 system block; other templates
            # have no standalone shared head
            self._auto_register_system(messages[0])
        return self.submit(encode_text(self.tokenizer, hist.render()), **kw)

    def _auto_register_system(self, system_msg: Message) -> None:
        head = BEGIN_OF_TEXT + History.encode_message(system_msg)
        evict = None
        with self._rid_lock:
            if head in self._auto_pids:
                pid = self._auto_pids[head]
                if pid is None or pid < 0 or pid in self._prefixes:
                    return   # in flight, negative-cached, or live
                # a stale head -> pid: the registry was cleared under a
                # finished registration (_reset_after_error racing a
                # handler thread); register it again
                del self._auto_pids[head]
            if len(self._auto_pids) >= self._max_auto:
                # evict the oldest finished registration (in-flight
                # reservations, None, are skipped)
                for k, pid in list(self._auto_pids.items()):
                    if pid is not None:
                        del self._auto_pids[k]
                        evict = pid
                        break
                else:
                    return    # every entry is in flight
            self._auto_pids[head] = None   # reserve before the prefill
        if evict is not None and evict >= 0:
            # outside the lock: the engine thread may need _rid_lock
            try:
                self.unregister_prefix(evict)
            except Exception:  # noqa: BLE001
                log.exception("auto-prefix eviction failed")
        try:
            ids = encode_text(self.tokenizer, head)
            # page-granular sharing: a head shorter than one page has
            # nothing to share (register_prefix would refuse it)
            min_len = max(8, self._pager.page_size)
            if len(ids) < min_len or len(ids) >= self.max_seq_len - 1:
                with self._rid_lock:
                    self._auto_pids[head] = -1
                return
            pid = self.register_prefix(ids)
        except Exception:  # noqa: BLE001
            # the reference's documented behaviour: a failed registration
            # is logged and the request is served whole
            log.exception("auto prefix registration failed; serving "
                          "without prefix cache")
            with self._rid_lock:
                self._auto_pids.pop(head, None)
        else:
            with self._rid_lock:
                self._auto_pids[head] = pid

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

    # -- shared prefixes --------------------------------------------------------

    def register_prefix(self, prefix_ids: Sequence[int]) -> int:
        """Prefill a shared prompt head (e.g. the rendered system prompt)
        once into pool pages. Later prompts that start with it map those
        pages at the head of their table rows and prefill only their
        suffix. The head is rounded down to a page; the remainder joins
        each suffix. Returns a prefix id (for unregister_prefix). Runs on
        the engine thread when it is running (the pool and the table
        have one writer)."""
        ids = list(prefix_ids)
        if not ids:
            raise ValueError("empty prefix")
        if len(ids) >= self.max_seq_len - 1:
            raise ValueError(
                f"prefix length {len(ids)} leaves no room for a suffix "
                f"(max_seq_len {self.max_seq_len})")
        P = self._pager.page_size
        if len(ids) < P:
            raise ValueError(
                f"paged prefix sharing is page-granular: the prefix "
                f"({len(ids)} tokens) is shorter than one kv page "
                f"({P} tokens), so there is nothing to share "
                "(lower --kv-page-size or skip registration)")
        if self._thread is not None and self._thread.is_alive():
            return self._run_on_engine_thread(
                lambda: self._register_prefix_paged(ids))
        return self._register_prefix_paged(ids)

    def _register_prefix_paged(self, ids: List[int]) -> int:
        """Round the prefix down to a page, allocate its pages, prefill
        it into them (`prefill_prefix_pages`) and record the page list;
        the pages go back to the pool if the prefill fails."""
        P = self._pager.page_size
        aligned = (len(ids) // P) * P
        p_ids = ids[:aligned]
        n_pp = aligned // P
        pages = self._pager.alloc(aligned)
        if pages is None:
            raise ValueError(
                f"kv page pool cannot hold the prefix: needs {n_pp} "
                f"pages, {self._pager.free_pages} free (raise "
                "--kv-pages, or register before taking load)")
        with self._rid_lock:
            pid = self._next_prefix_id
            self._next_prefix_id += 1
        row = torch.full((self.cache.max_pages,), -1, dtype=torch.int32)
        row[:n_pp] = torch.tensor(pages, dtype=torch.int32)
        try:
            self.cache = prefill_prefix_pages(
                self.params, self._tokens(p_ids), to_device(row, self.device),
                self.cache, self.rope, self.config, attn=self.paged_attn,
                row=pages)
        except Exception:
            self._pager.release(pages)
            raise
        with self._rid_lock:
            self._prefixes[pid] = (p_ids, pages)
        log.info("registered paged prefix %d: %d tokens in %d shared "
                 "pages (%d trailing tokens fall to each suffix)",
                 pid, aligned, n_pp, len(ids) - aligned)
        return pid

    def unregister_prefix(self, prefix_id: int) -> None:
        """Drop a registration: the registry's page references go;
        slots still decoding on those pages hold their own, so the pages
        outlive it until the last such request retires."""
        if self._thread is not None and self._thread.is_alive():
            self._run_on_engine_thread(
                lambda: self._unregister_paged_sync(prefix_id))
            return
        self._unregister_paged_sync(prefix_id)

    def _unregister_paged_sync(self, prefix_id: int) -> None:
        with self._rid_lock:
            entry = self._prefixes.pop(prefix_id, None)
        if entry is not None:
            self._pager.release(entry[1])

    def _match_prefix(self, ids: List[int]):
        """Longest registered prefix that is a proper head of `ids`:
        (pid, (p_ids, pages)) or None."""
        best = None
        with self._rid_lock:
            entries = list(self._prefixes.items())
        for pid, entry in entries:
            n = len(entry[0])
            if n < len(ids) and ids[:n] == entry[0]:
                if best is None or n > len(best[1][0]):
                    best = (pid, entry)
        return best

    def _match_and_validate_prefix(self, ids: List[int]):
        """(pid, (p_ids, pages)) of the longest matching prefix that can
        serve this prompt (`_prefix_window_plan`), or None. Returns the
        entry, not just the pid, so a concurrent eviction cannot turn a
        later lookup into a KeyError."""
        hit = self._match_prefix(ids)
        if hit is None or self._prefix_window_plan(hit[1][0], ids) is None:
            return None
        return hit

    def _prefix_window_plan(self, p_ids: List[int], ids: List[int]):
        """(chunk_suffix, C_or_bucket) for a prefix-hit prefill, or None
        when the suffix's windows (--prefill-chunk, when the suffix is
        longer than C) or its padded bucket would run past max_seq_len
        after the prefix. The JAX engine's rule, applied on both loops."""
        C = self.prefill_chunk
        suffix = ids[len(p_ids):]
        if C and len(suffix) > C:
            n_win = -(-len(suffix) // C)
            if len(p_ids) + n_win * C <= self.max_seq_len:
                return (True, C)
            return None
        bucket = bucket_length(len(suffix), self.max_seq_len)
        if len(p_ids) + bucket > self.max_seq_len:
            return None
        return (False, bucket)

    # -- commands on the engine thread ------------------------------------------

    def _run_on_engine_thread(self, fn, timeout: float = 300.0):
        """Run fn on the engine thread between iterations and return its
        result (or raise its error)."""
        if self._thread is None or not self._thread.is_alive():
            raise RuntimeError("engine not running: start() first")
        box: dict = {}
        ev = threading.Event()
        with self._rid_lock:
            self._cmd_q.append((fn, box, ev))
        self._wake.set()
        if not ev.wait(timeout):
            raise TimeoutError("engine thread did not run the command "
                               f"within {timeout:.0f}s")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _drain_commands(self) -> None:
        with self._rid_lock:
            cmds, self._cmd_q = self._cmd_q, []
        for fn, box, ev in cmds:
            try:
                box["result"] = fn()
            except Exception as e:  # noqa: BLE001
                box["error"] = e
            finally:
                ev.set()

    def _fail_pending_commands(self) -> None:
        """Engine exit: release command waiters with an error instead of
        letting them time out against a dead thread."""
        with self._rid_lock:
            cmds, self._cmd_q = self._cmd_q, []
        for _fn, box, ev in cmds:
            box["error"] = RuntimeError("engine stopped")
            ev.set()

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
            self._fail_pending_commands()

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            self._drain_cancellations()
            self._drain_commands()
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
                if self._mixed:
                    self._do_mixed(prefill_plan, decode_plan)
                else:
                    self._do_phases(prefill_plan, decode_plan)
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
        and the sampling state, and drop both runners. Registered
        prefixes lived in the old pool's pages, so the registry is
        cleared too; auto-prefix heads register again on their next
        request."""
        self.cache = self._new_cache(self.cache.n_pages,
                                     self.cache.page_size)
        self._pager = PageAllocator(self.cache.n_pages, self.cache.page_size)
        self._slot_pages = {}
        self._slot_prefix_pages = {}
        self._prefix_pages_shared = 0
        with self._rid_lock:
            self._prefixes.clear()
            self._auto_pids.clear()
        self._mixed_pending = {}
        self._page_blocked_rid = None
        self._pos[:] = 0
        self._last_tok[:] = 0
        self._steps[:] = 0
        self._reset_count += 1
        # the runners' graphs captured the old pool: capture anew
        self._fresh_sampling_state()

    # -- pages ----------------------------------------------------------------

    def _release_slot_pages(self, slot: int) -> None:
        """Refcounted release of a slot's pages (idempotent: every
        teardown path pops the same entry); shared prefix pages drop to
        the registry's reference instead of being freed. Any prefill
        still pending for the slot is dropped. The slot's table row is
        unmapped too: a decode step still passes the idle row's stale
        position, and an unmapped row reads no pages."""
        if slot < 0:
            return
        self._mixed_pending.pop(slot, None)
        pages = self._slot_pages.pop(slot, None)
        if pages:
            self._pager.release(pages)
            table_set_slot(self.cache.table, slot, [])
        self._prefix_pages_shared -= self._slot_prefix_pages.pop(slot, 0)

    def _alloc_slot_pages(self, req: _Request, slot: int,
                          hit=None) -> bool:
        """Admission by pages: map the slot's table row when the pool
        covers prompt + budget, else requeue the request. A page-starved
        request becomes the blocking head: younger requests requeue
        behind it instead of being admitted past it.

        hit: a validated prefix match (pid, (p_ids, pages)) from
        _match_and_validate_prefix: the slot then allocates only suffix
        + budget pages and maps the shared pages, retained, at the head
        of its row."""
        blocked = self._page_blocked_rid
        if blocked is not None and blocked not in self._requests:
            blocked = self._page_blocked_rid = None     # cancelled/failed
        if blocked is not None and req.rid != blocked:
            return self._requeue_for_pages(req, slot, starved=False)
        prefix_pages: List[int] = []
        n_prefix = 0
        if hit is not None:
            p_ids, prefix_pages = hit[1]
            n_prefix = len(p_ids)
        pages = self._pager.alloc(len(req.prompt_ids) - n_prefix
                                  + req.max_new_tokens)
        if pages is None:
            return self._requeue_for_pages(req, slot, starved=True)
        if prefix_pages:
            # retain AFTER the alloc: a requeued admission leaves no
            # reference behind
            self._pager.retain(prefix_pages)
            self._slot_prefix_pages[slot] = len(prefix_pages)
            self._prefix_pages_shared += len(prefix_pages)
        row = list(prefix_pages) + pages
        self._slot_pages[slot] = row
        table_set_slot(self.cache.table, slot, row)
        if self.kv_quant:
            # the slot's own fresh pages must not inherit a previous
            # occupant's scales; the shared pages keep theirs
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
            # the last mixed step fetched, unless its prompts were
            # cancelled mid-window: count what is still open
            self._count_mixed_time()
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
        hit = self._match_and_validate_prefix(req.prompt_ids)
        if not self._alloc_slot_pages(req, slot, hit):
            return   # pool exhausted: requeued (or failed) inside
        off = 0
        if hit is not None:
            # the shared pages are mapped at the row head: the windows
            # start after them
            off = len(hit[1][0])
            self.stats.prefix_hits += 1
        self._temp[slot] = req.temperature
        self._top_p[slot] = req.top_p
        self._penalty[slot] = req.repeat_penalty
        self._ring[slot] = -1          # a fresh repeat-penalty ring
        self._steps[slot] = 0
        self._pos[slot] = off
        self._mixed_pending[slot] = {"req": req, "ids": req.prompt_ids,
                                     "off": off}

    def _mixed_step_runner(self) -> MixedRunner:
        if self._mixed_runner is None:
            self._mixed_runner = MixedRunner(
                self.params, self.cache, self.rope, self.config,
                attn=self.paged_attn, ring=self._ring, seeds=self._seeds,
                counters=self._counters, chunk=self._mixed_chunk,
                n_top_cap=self.n_top, top_k=self.defaults.top_k,
                step_fn=mixed_step_paged, pool=self._graph_pool)
        return self._mixed_runner

    def _mixed_dispatch(self, decode_plan) -> None:
        """Build and run ONE mixed step: every decode row contributes its
        last token (q_len=1), every mid-prefill slot its next window;
        rows whose window ends their prompt sample their first token from
        the same replay the decode rows sample their next. A step in
        which no row emits (every row mid-prompt) fetches nothing: the
        host goes on to build the next step, which queues behind it."""
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
        emit_rows = decode_rows + finished
        emit = np.zeros(B, bool)
        emit[emit_rows] = True
        handle = self._mixed_step_runner().run(
            self._n_top_for(emit_rows) if emit_rows else None, tokens, pos,
            qlen, active, emit, self._steps, self._temp, self._top_p,
            self._penalty)
        self.stats.steps += 1
        # the step's wall is counted when outputs are fetched, over every
        # step dispatched since the last fetch, split by token share
        # between prefill and decode
        if self._mixed_open is None:
            self._mixed_open = [t0, 0, 0]
        self._mixed_open[1] += int(sum(qlen[s] for s in chunk_rows))
        self._mixed_open[2] += len(decode_rows)
        # advance the prefill frontiers BEFORE emit: a finishing row's
        # _pos must read prompt-end when _emit checks the window cap
        for slot in chunk_rows:
            p = self._mixed_pending[slot]
            p["off"] += int(qlen[slot])
            self._pos[slot] = p["off"]
        if handle is None:
            return
        nxt, lp, tids, tlps = (a[:, 0] for a in MixedRunner.fetch(handle))
        self._count_mixed_time()
        self._advance_mirrors(emit_rows, nxt)
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

    def _count_mixed_time(self) -> None:
        """Add the wall since the first mixed step not yet counted to the
        prefill and decode times, split by the steps' token shares."""
        if self._mixed_open is None:
            return
        t0, chunk_toks, decode_toks = self._mixed_open
        self._mixed_open = None
        dt = time.perf_counter() - t0
        pf = dt * chunk_toks / (chunk_toks + decode_toks)
        self.stats.prefill_time_s += pf
        self.stats.decode_time_s += dt - pf

    @staticmethod
    def _top(tids, tlps, slot) -> list:
        return (list(zip(tids[slot].tolist(), tlps[slot].tolist()))
                if tids.size else [])

    # -- the phase-split loop (--mixed-batch off) ---------------------------------

    def _do_phases(self, prefill_plan, decode_plan) -> None:
        """One iteration of the phase-split loop: the admissions prefill
        (PREFILL_FLUSH a host round trip), then the rows planned to
        decode take their step or burst."""
        if prefill_plan:
            self._do_prefill_batch(prefill_plan)
        if decode_plan:
            n = self._scan_steps_for(decode_plan)
            if n > 1:
                self._decode_burst(decode_plan, n)
            else:
                self._do_decode(decode_plan)

    def _do_prefill(self, rid: int, slot: int):
        """Dispatch one admission's prefill and first-token sample, with
        no fetch: returns (req, t0, slot, device sample) for
        _do_prefill_batch, which fetches a group's first tokens in one
        host round trip; None when the request was cancelled or
        requeued."""
        req = self._requests.get(rid)
        if req is None:  # cancelled between plan and here
            self.scheduler.cancel(rid)
            return None
        t0 = time.perf_counter()
        req.slot = slot
        self._slot_req[slot] = req
        ids = req.prompt_ids
        # match BEFORE page admission: a hit changes the allocation
        hit = self._match_and_validate_prefix(ids)
        if not self._alloc_slot_pages(req, slot, hit):
            return None   # pool exhausted: requeued (or failed) inside
        n_top = self._n_top_for([slot])
        if hit is not None:
            out = self._prefixed_prefill_device(ids, slot, req, hit[1],
                                                n_top)
            self.stats.prefix_hits += 1
        else:
            out = self._prefill_device(ids, slot, req, n_top)
        return (req, t0, slot, out)

    # admissions a first-token fetch in _do_prefill_batch: each group's
    # prefills and samples are dispatched back to back with no wait for
    # the stream (tokens, write targets and sampling inputs go up from
    # pinned memory; the targets come from the host's copy of the row),
    # then fetched together, so early arrivals of a wave stream their
    # first token after a few prefills instead of after the whole wave
    PREFILL_FLUSH = 4

    def _do_prefill_batch(self, prefill_plan) -> None:
        """Admit a wave with one first-token fetch per PREFILL_FLUSH
        admissions."""
        pend: list = []

        def flush():
            hosts = self._fetch_samples([dev for (_, _, _, dev) in pend])
            # one wall interval a group: its admissions overlap
            self.stats.prefill_time_s += time.perf_counter() - pend[0][1]
            for (req, _t0, slot, _), host in zip(pend, hosts):
                self._advance_mirrors([slot], host[0])
                first, first_lp, tids, tlps = host
                self._emit(req, int(first[slot]),
                           logprob=float(first_lp[slot]),
                           top=self._top(tids, tlps, slot))
            pend.clear()

        for rid, slot in prefill_plan:
            p = self._do_prefill(rid, slot)
            if p is not None:
                pend.append(p)
            if len(pend) >= self.PREFILL_FLUSH:
                flush()
        if pend:
            flush()

    def _prefill_device(self, ids, slot: int, req: _Request, n_top: int):
        """Prefill one slot, whole-prompt or in --prefill-chunk windows
        (prompts longer than C), and sample its first token."""
        C = self.prefill_chunk
        if C and len(ids) > C:
            logits = self._prefill_chunked(ids, slot, C)
        else:
            logits = self._prefill_raw(ids, slot)
        return self._finish_prefill(logits, slot, len(ids), req, n_top)

    def _tokens(self, ids) -> torch.Tensor:
        """A prefill window's tokens [1, S] on the engine's device, with
        no wait for the stream."""
        return to_device(torch.tensor([list(ids)], dtype=torch.int32),
                         self.device)

    def _prefill_raw(self, ids, slot: int):
        """Whole-prompt prefill of the prompt's bucket."""
        bucket = bucket_length(len(ids), self.max_seq_len)
        padded = list(ids) + [0] * (bucket - len(ids))
        logits, self.cache = prefill_slot_paged(
            self.params, self._tokens(padded), len(ids), slot, self.cache,
            self.rope, self.config, attn=self.paged_attn,
            row=self._slot_pages[slot])
        return logits

    def _prefill_chunked(self, ids: List[int], slot: int, C: int,
                         pos0: int = 0):
        """Walk a prompt (or a prefix hit's suffix, from absolute
        position pos0) through the slot's pages in C-token windows."""
        logits = None
        for window, n_real, start in chunk_windows(ids, C):
            logits, self.cache = prefill_slot_paged_chunk(
                self.params, self._tokens(window), n_real, slot,
                pos0 + start, self.cache, self.rope, self.config,
                attn=self.paged_attn, row=self._slot_pages[slot])
        return logits

    def _prefixed_prefill_device(self, ids, slot: int, req: _Request,
                                 entry, n_top: int):
        """A prefix hit's prefill: the shared pages are already mapped at
        the head of the slot's row (_alloc_slot_pages), so only the
        suffix runs, as one window (`prefill_slot_paged_prefixed`) or in
        --prefill-chunk windows from pos0 = n_prefix (which attend the
        shared pages through the table); then the first token."""
        p_ids = entry[0]
        plan = self._prefix_window_plan(p_ids, ids)
        if plan is None:  # validated at the match
            raise RuntimeError(
                f"prefix no longer serves a prompt of len {len(ids)}")
        chunk_suffix, width = plan
        suffix = list(ids[len(p_ids):])
        if chunk_suffix:
            logits = self._prefill_chunked(suffix, slot, width,
                                           pos0=len(p_ids))
        else:
            padded = suffix + [0] * (width - len(suffix))
            logits, self.cache = prefill_slot_paged_prefixed(
                self.params, self._tokens(padded), len(suffix), slot,
                self.cache, self.rope, self.config, n_prefix=len(p_ids),
                attn=self.paged_attn, row=self._slot_pages[slot])
        return self._finish_prefill(logits, slot, len(ids), req, n_top)

    def _finish_prefill(self, logits, slot: int, prompt_len: int,
                        req: _Request, n_top: int):
        """Set the slot's sampling state and sample its first token on
        its own stream. Returns the device sample (_do_prefill_batch
        fetches it and moves the slot's mirrors)."""
        self._pos[slot] = prompt_len
        self._temp[slot] = req.temperature
        self._top_p[slot] = req.top_p
        self._penalty[slot] = req.repeat_penalty
        self._ring[slot] = -1          # a fresh repeat-penalty ring
        self._steps[slot] = 0
        return self._sample_rows(
            logits.expand(self.max_slots, logits.shape[-1]), rows=[slot],
            n_top=n_top)

    # -- the decode step and its bursts ---------------------------------------

    def _decode_runner(self) -> DecodeRunner:
        if self._runner is None:
            self._runner = DecodeRunner(
                self.params, self.cache, self.rope, self.config,
                attn=self.paged_attn, ring=self._ring, seeds=self._seeds,
                counters=self._counters, max_steps=self._decode_scan,
                n_top_cap=self.n_top, top_k=self.defaults.top_k,
                pool=self._graph_pool)
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
        admissions waiting, cancellations, or commands."""
        with self._rid_lock:
            pending = bool(self._cancel_q) or bool(self._cmd_q)
        return (self._stop.is_set() or self.scheduler.queue_depth > 0
                or pending)

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
        """The phase-split prefills' sampling: all B rows; counters and
        rings advance only for `rows` (an inactive slot's stream is
        untouched). Returns the device tensors (next ids, logprobs, top
        ids, top logprobs): `_fetch_samples`, then `_advance_mirrors`."""
        B = self.max_slots
        in_rows = np.zeros(B, bool)
        in_rows[rows] = True
        def dev(a):   # no wait for the stream: a group dispatches whole
            return to_device(torch.from_numpy(a), self.device)

        nxt, counters, ring, lp, top_ids, top_lps = masked_sample(
            dev(in_rows), self._seeds, self._counters, logits, self._ring,
            dev(self._steps), dev(self._temp), dev(self._top_p),
            dev(self._penalty), top_k=self.defaults.top_k, n_top=n_top)
        self._counters.copy_(counters)
        self._ring.copy_(ring)
        return nxt, lp, top_ids, top_lps

    def _advance_mirrors(self, rows: List[int], nxt_h) -> None:
        for r in rows:
            self._steps[r] += 1
            self._last_tok[r] = nxt_h[r]

    @staticmethod
    def _fetch_samples(devs: list) -> list:
        """Device sample tuples as host arrays, with one wait for the
        stream (copies into pinned memory on the card)."""
        if not devs:
            return []
        flat = [t for dev in devs for t in dev]
        if flat[0].is_cuda:
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in flat]
            for h, t in zip(host, flat):
                h.copy_(t, non_blocking=True)
            torch.cuda.current_stream(flat[0].device).synchronize()
        else:
            host = flat
        arrays = [h.numpy() for h in host]
        k = len(devs[0])
        return [tuple(arrays[i:i + k]) for i in range(0, len(arrays), k)]

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
