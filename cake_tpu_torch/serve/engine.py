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
    prefills only its suffix;
  * SLO scheduling (`priority_classes`, `preemption`, `shed`; sched/):
    requests carry a class and are admitted by class with aging;
    between iterations a starved higher class preempts the youngest
    lowest-class slot (`_maybe_preempt`): its generated tokens fold into
    its prompt, its pages go back through the refcounted allocator, and
    it requeues with its seniority to re-prefill; shedding refuses an
    arrival with a computed Retry-After;
  * observability (obs/): a lifecycle trace per request (`tracer`), a
    flight record per device step (`flight`, with the step's counted
    FLOPs and bytes and its device time from CUDA events read at the
    fetch that already happens), the event bus (`events`) and SLO
    accounting (`slo`), all built from values the host already has.

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
(`_run_on_engine_thread`). Not ported yet: speculation, the host KV tier
(so a preemption always takes the recompute fold), fault injection and
recovery, the journal, autotune and multi-host.
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
from cake_tpu_torch.models.llama.params import params_bytes
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs import steps as obs_steps
from cake_tpu_torch.obs.events import EventBus
from cake_tpu_torch.obs.slo import SLOAccountant, parse_slo_targets
from cake_tpu_torch.obs.tracing import RequestTracer
from cake_tpu_torch.ops.sampling import SamplingConfig, masked_sample
from cake_tpu_torch.sched import (
    SchedConfig, ShedController, ShedError, make_scheduler,
)
from cake_tpu_torch.sched.classes import CLASS_RANK, validate_priority
from cake_tpu_torch.serve.graphs import (
    DecodeRunner, MixedRunner, elapsed_s, mark,
)
from cake_tpu_torch.utils.devices import (
    resolve_device, resolve_dtype, to_device,
)
from cake_tpu_torch.utils.profiling import StepStats

log = logging.getLogger(__name__)

# the metric families of the JAX engine (`cake_tpu/serve/engine.py`)
# that apply to the paged engine, with the same names and help

# paged-engine device-step wall latency (dispatch+fetch, sampling
# included), split by path; bursts observe their per-step average
_PAGED_ATTN_STEP = obs_metrics.histogram(
    "cake_paged_attn_step_seconds",
    "Paged-engine step wall latency by path (prefill|decode|mixed)",
    labelnames=("path",))

# page-granular prefix sharing: the gauge tracks how many pool pages are
# currently backing more than their first mapping, the counters how
# often and how many prompt tokens the sharing saved
_PREFIX_PAGES_SHARED = obs_metrics.gauge(
    "cake_prefix_pages_shared",
    "Shared prefix pages currently mapped into admitted slots' table "
    "rows (pool pages saved vs unshared admission)")
_PREFIX_PAGED_HITS = obs_metrics.counter(
    "cake_prefix_paged_hits_total",
    "Paged prefills served from pool-resident shared prefix pages")
_PREFIX_TOKENS_SAVED = obs_metrics.counter(
    "cake_prefix_tokens_saved_total",
    "Prompt tokens whose prefill was skipped via a cached prefix")

# SLO scheduling: preemption/shed outcomes and per-class queue state
_PREEMPTIONS = obs_metrics.counter(
    "cake_preemptions_total",
    "Decoding slots preempted for a starved higher priority class, by "
    "trigger (slots = slot-starved, pages = kv-page-starved)",
    labelnames=("reason",))
_SHED_REQUESTS = obs_metrics.counter(
    "cake_shed_requests_total",
    "Requests rejected by per-class load shedding (HTTP 429 with a "
    "computed Retry-After)",
    labelnames=("class",))
_QUEUE_DEPTH = obs_metrics.gauge(
    "cake_queue_depth",
    "Queued requests by priority class (SLO scheduler; refreshed at "
    "submit, each engine iteration, and metrics scrape)",
    labelnames=("class",))
_SCHED_TTFT = obs_metrics.histogram(
    "cake_sched_ttft_seconds",
    "Submit-to-first-token latency by priority class (includes queue "
    "wait and any preemption-induced requeues)",
    labelnames=("class",))


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
    # admission class, and how many times its slot was reclaimed for a
    # higher class
    priority: str = "standard"
    preemptions: int = 0
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
    preemptions: int = 0     # slots reclaimed for a starved higher class
    shed: int = 0            # arrivals refused by load shedding

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
        trace_events: Optional[str] = None,
        trace_ring: int = 256,
        step_log: Optional[str] = None,
        step_ring: int = 512,
        event_log: Optional[str] = None,
        event_ring: int = 1024,
        slo_targets=None,
        priority_classes: bool = False,
        preemption: Optional[bool] = None,
        shed: bool = False,
        sched_config: Optional[SchedConfig] = None,
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

        # the step cost's constants (obs/steps.step_cost): the weights a
        # forward pass reads at their stored size, the embedding left
        # out (a pass gathers one row a token of it), and the pool's
        # bytes a token (scales and the sink page's share included)
        self._weight_bytes = (params_bytes(params)
                              - params_bytes(params["embed"]))
        self._embed_row_bytes = (params_bytes(params["embed"])
                                 // config.vocab_size)
        self._kv_bytes_per_token = self.cache.memory_bytes() / (
            (self.cache.n_pages + 1) * self.cache.page_size)

        # the event bus (obs/events.py): preemption, prefix hits,
        # shedding and graph captures publish request-linked events
        # (GET /api/v1/events; --event-log JSONL). --event-ring 0
        # disables it: self.events is then None and every publish site
        # costs one attribute test
        self.events = (EventBus(capacity=event_ring, log_path=event_log)
                       if event_ring > 0 else None)
        # SLO attainment and goodput (obs/slo.py), fed from the tracer's
        # finish seam, so verdicts use the original admission's clock
        self.slo = SLOAccountant(
            slo_targets if isinstance(slo_targets, dict)
            else parse_slo_targets(slo_targets))
        # SLO scheduling (sched/): priority-class queues with aging
        # replace FIFO admission; preemption recompute-folds a lower-
        # class slot back into the queue when a higher class is slot-
        # or page-starved (None: on with the classes); shedding turns
        # overload into 429s with a computed Retry-After. The FIFO
        # stays the priority-free fallback.
        self._sched_cfg = sched_config or SchedConfig()
        self._slo = bool(priority_classes)
        self._preemption = (self._slo if preemption is None
                            else bool(preemption))
        if self._preemption and not self._slo:
            log.warning("--preemption requires --priority-classes; "
                        "preemption disabled")
            self._preemption = False
        self._shed = ShedController(self._sched_cfg) if shed else None
        # rank of a page-starved higher-class admission awaiting a
        # victim; consumed at the top of the next iteration (a mid-wave
        # preemption would leave already-planned decode rows writing
        # through a released table row)
        self._pending_page_preempt: Optional[int] = None
        self.scheduler = make_scheduler(
            max_slots, max_queue, priority_classes=self._slo,
            config=self._sched_cfg)
        self.stats = EngineStats()
        # request-lifecycle traces (obs/tracing.py), always on: spans at
        # the submit, admission, first-token, emit, preemption, requeue
        # and retire seams; --trace-events appends them as JSONL
        self.tracer = RequestTracer(capacity=trace_ring,
                                    events_path=trace_events,
                                    slo=self.slo)
        self._step_stats = StepStats(name="engine", window=100)
        # the step flight recorder (obs/steps.py), always on: one record
        # per device step at the step seams, GET /api/v1/steps and
        # --step-log; MFU and HBM utilization against this card's peaks
        self.flight = obs_steps.StepTelemetry(
            impl=f"paged-{impl}", capacity=step_ring, log_path=step_log,
            kind=obs_steps.device_kind(self.device), events=self.events)
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
        # mixed steps dispatched and not yet counted in the stats' times
        # nor recorded: [first dispatch's clock, chunk tokens, decode
        # rows, the steps' pending flight records]
        self._mixed_open: Optional[list] = None
        # a runner captured a graph for the step being dispatched
        self._compiled_step = False

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
        # flush and fsync the optional JSONL logs (a later start reopens
        # them on the next append)
        self.tracer.close()
        self.flight.close()
        if self.events is not None:
            self.events.close()

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
        priority: Optional[str] = None,
    ) -> RequestHandle:
        """Queue one generation. stream(text_delta, is_final) is called
        from the engine thread as tokens finalize; a callback with
        attribute `wants_count = True` instead gets (text_delta,
        is_final, n_done). The handle's wait()/text() is the blocking
        interface. priority: the request's class (interactive |
        standard | batch; None = standard; an unknown one raises
        ValueError); it orders admission under priority_classes and
        labels the TTFT histogram always. Raises ShedError (shedding) or
        QueueFullError, each with a Retry-After."""
        if self._stop.is_set():
            from cake_tpu_torch.serve.errors import EngineResetError
            raise EngineResetError("engine stopped")
        cls = validate_priority(priority)
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
            priority=cls,
            submit_t=time.perf_counter(),
        )
        if self._shed is not None:
            # after every validation above: an invalid request gets its
            # 400, never a 429 inviting a retry that cannot succeed
            depth = (self.scheduler.depth_ahead(cls)
                     if hasattr(self.scheduler, "depth_ahead")
                     else self.scheduler.queue_depth)
            dec = self._shed.decide(cls, depth)
            if not dec.admit:
                self.stats.shed += 1
                _SHED_REQUESTS.labels(cls).inc()
                if self.events is not None:
                    self.events.publish(
                        "shed", rid=rid, priority=cls,
                        retry_after_s=round(dec.retry_after_s, 3),
                        est_wait_s=(round(dec.est_wait_s, 3)
                                    if dec.est_wait_s is not None
                                    else None))
                raise ShedError(cls, dec.retry_after_s,
                                est_wait_s=dec.est_wait_s)
        # register (and trace) BEFORE scheduler.submit: the engine
        # thread may plan the rid immediately, and an unknown rid counts
        # as cancelled
        self._requests[rid] = req
        self.tracer.admit(rid, len(ids), max_new, priority=cls)
        ok = (self.scheduler.submit(rid, len(ids), max_new, priority=cls)
              if self._slo else
              self.scheduler.submit(rid, len(ids), max_new))
        if not ok:
            self._requests.pop(rid, None)
            self.tracer.drop(rid)
            retry = 1.0
            if self._shed is not None:
                retry = self._shed.estimate_retry_after(
                    cls, self.scheduler.queue_depth)
            raise QueueFullError(retry_after=retry)
        self._set_queue_gauges()
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
            self.tracer.finish(rid, "cancelled",
                               output_tokens=len(req.out_tokens))
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
            if self._slo and self._preemption:
                # between iterations only: every burst has been fetched
                # and no step reads a table row this releases, except
                # chunk-only mixed steps still on the stream, which the
                # release and any re-allocation are ordered after
                self._maybe_preempt()
            prefill_plan, decode_plan = self.scheduler.plan()
            if self._slo:
                self._set_queue_gauges()
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
        self._pending_page_preempt = None
        _PREFIX_PAGES_SHARED.set(0)
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
        n_shared = self._slot_prefix_pages.pop(slot, 0)
        if n_shared:
            self._prefix_pages_shared -= n_shared
            _PREFIX_PAGES_SHARED.set(self._prefix_pages_shared)

    def _alloc_slot_pages(self, req: _Request, slot: int,
                          hit=None) -> bool:
        """Admission by pages: map the slot's table row when the pool
        covers prompt + budget, else requeue the request. A page-starved
        request becomes the blocking head: younger requests requeue
        behind it instead of being admitted past it.

        hit: a validated prefix match (pid, (p_ids, pages)) from
        _match_and_validate_prefix: the slot then allocates only suffix
        + budget pages and maps the shared pages, retained, at the head
        of its row. Under priority classes a request that outranks the
        blocking head may try the pool past it (an aged head's score is
        the best, so it keeps first claim on freed pages)."""
        blocked = self._page_blocked_rid
        if blocked is not None and blocked not in self._requests:
            blocked = self._page_blocked_rid = None     # cancelled/failed
        if blocked is not None and req.rid != blocked:
            leapfrog = (self._slo
                        and self.scheduler.outranks(req.rid, blocked))
            if not leapfrog:
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
            _PREFIX_PAGES_SHARED.set(self._prefix_pages_shared)
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
        # the folded shape (a preempted request re-prefills prompt +
        # generated tokens for the rest of its budget)
        n_prompt = len(req.prompt_ids) + len(req.out_tokens)
        n_left = req.max_new_tokens - len(req.out_tokens)
        if self._slo:
            # requeue, not cancel + submit: the aging score keeps
            # counting from the original admission
            ok = self.scheduler.requeue(req.rid, n_prompt, n_left)
        else:
            self.scheduler.cancel(req.rid)
            ok = self.scheduler.submit(req.rid, n_prompt, n_left)
        if not ok:
            req.error = RuntimeError(
                "kv page pool exhausted and admission queue full")
            self._requests.pop(req.rid, None)
            if self._page_blocked_rid == req.rid:
                self._page_blocked_rid = None
            self.tracer.finish(req.rid, "error", error=str(req.error))
            req.done.set()
        else:
            self.tracer.span(req.rid, "requeued")
            if starved and self._slo and self._preemption:
                # note the starved class for the top of the next
                # iteration: preempting mid-wave would leave the planned
                # decode rows writing through a released table row
                r = CLASS_RANK[req.priority]
                cur = self._pending_page_preempt
                self._pending_page_preempt = (r if cur is None
                                              else min(cur, r))
        return False

    # -- SLO scheduling: preemption and queue gauges ----------------------------

    def _set_queue_gauges(self) -> None:
        depths = getattr(self.scheduler, "class_depths", None)
        if depths is None:
            return
        for c, d in depths().items():
            _QUEUE_DEPTH.labels(c).set(d)

    def _maybe_preempt(self) -> None:
        """Reclaim at most one slot an iteration for a starved higher
        class: first for a page-starved admission noted last iteration
        (reason "pages"), else for the best-scored waiting request when
        every slot is taken (reason "slots"). The scheduler picks the
        victim (the youngest slot of the worst class, preemption budget
        respected); the recompute fold is `_preempt_slot`'s."""
        pend, self._pending_page_preempt = self._pending_page_preempt, None
        cands = []
        if pend is not None:
            cands = [(v, "pages")
                     for v in self.scheduler.preemption_victims(pend)]
        if not cands:
            cands = [(v, "slots")
                     for v in self.scheduler.slot_preemption_victims()]
        for (rid, slot), reason in cands:
            if self._preempt_slot(rid, slot, reason):
                return

    def _preempt_slot(self, rid: int, slot: int, reason: str) -> bool:
        """Recompute-style preemption of one slot: the victim requeues
        with its seniority as prompt + generated tokens for the rest of
        its budget (its admission re-prefills that fold through the
        mixed step, or the phase-split prefill, and the next greedy token
        is the one an uninterrupted run emits), and its pages go back
        through the refcounted allocator (shared prefix pages only drop
        a reference). The JAX engine's host-tier spill of the victim's
        pages is not ported."""
        req = (self._slot_req[slot]
               if 0 <= slot < self.max_slots else None)
        if req is None or req.rid != rid or req.done.is_set():
            return False
        remaining = req.max_new_tokens - len(req.out_tokens)
        if remaining <= 0:
            return False    # retiring this iteration anyway
        if not self.scheduler.requeue(
                rid, len(req.prompt_ids) + len(req.out_tokens),
                remaining, preempted=True):
            return False
        self._slot_req[slot] = None
        req.slot = -1
        req.preemptions += 1
        self._release_slot_pages(slot)
        self.stats.preemptions += 1
        _PREEMPTIONS.labels(reason=reason).inc()
        self.tracer.span(rid, "preempted", reason=reason,
                         generated=len(req.out_tokens), spilled=False)
        if self.events is not None:
            self.events.publish("preempted", rid=rid, reason=reason,
                                priority=req.priority,
                                generated=len(req.out_tokens),
                                spilled=False)
        log.debug("preempted rid=%d (%s, %d tokens fold into the prompt)",
                  rid, reason, len(req.out_tokens))
        return True

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
        self.tracer.prefill_start(rid)
        req.slot = slot
        self._slot_req[slot] = req
        # a preempted request re-prefills prompt + generated tokens, and
        # its penalty ring is rebuilt over the generated ones
        ids, prime = self._folded(req)
        hit = self._match_and_validate_prefix(ids)
        if not self._alloc_slot_pages(req, slot, hit):
            return   # pool exhausted: requeued (or failed) inside
        off = 0
        if hit is not None:
            # the shared pages are mapped at the row head: the windows
            # start after them
            off = len(hit[1][0])
            self.stats.prefix_hits += 1
            _PREFIX_PAGED_HITS.inc()
            _PREFIX_TOKENS_SAVED.inc(off)
            if self.events is not None:
                self.events.publish("prefix_hit", rid=rid, pid=hit[0],
                                    tokens_saved=off)
        self._temp[slot] = req.temperature
        self._top_p[slot] = req.top_p
        self._penalty[slot] = req.repeat_penalty
        self._prime_ring(slot, prime)
        self._pos[slot] = off
        self._mixed_pending[slot] = {"req": req, "ids": ids, "off": off}

    @staticmethod
    def _folded(req: _Request):
        """(ids to prefill, tokens to prime the penalty ring with): the
        prompt, or after a preemption the prompt and the generated
        tokens (the recompute fold)."""
        if req.out_tokens:
            return list(req.prompt_ids) + list(req.out_tokens), \
                list(req.out_tokens)
        return req.prompt_ids, []

    def _prime_ring(self, slot: int, prime) -> None:
        """Reset a slot's repeat-penalty ring and step counter, seeded
        from `prime` (a preemption fold): each prior token at its step
        index and the counter continuing from there, so later writes
        land where an uninterrupted run's would. No wait for the stream:
        a seeded row goes up from pinned memory."""
        self._steps[slot] = 0
        if not prime:
            self._ring[slot] = -1
            return
        N = self._ring.shape[1]
        row = torch.full((N,), -1, dtype=torch.int64)
        start = max(0, len(prime) - N)
        for i, t in enumerate(prime[start:], start=start):
            row[i % N] = t
        self._ring[slot].copy_(to_device(row, self.device))
        self._steps[slot] = len(prime)

    def _mixed_step_runner(self) -> MixedRunner:
        if self._mixed_runner is None:
            self._mixed_runner = MixedRunner(
                self.params, self.cache, self.rope, self.config,
                attn=self.paged_attn, ring=self._ring, seeds=self._seeds,
                counters=self._counters, chunk=self._mixed_chunk,
                n_top_cap=self.n_top, top_k=self.defaults.top_k,
                step_fn=mixed_step_paged, pool=self._graph_pool,
                on_capture=self._captured("mixed_step"))
        return self._mixed_runner

    def _captured(self, fn_name: str):
        """A runner's capture hook: the flight recorder counts the
        capture as a compile of `fn_name`, and the step that caused it
        is recorded as compiled."""
        def hook(_variant, seconds: float) -> None:
            self.flight.count_capture(fn_name, seconds)
            self._compiled_step = True
        return hook

    def _took_capture(self) -> bool:
        got, self._compiled_step = self._compiled_step, False
        return got

    def _cost(self, kind: str, rows: int, tokens: int, ctx_lens,
              emit_rows: int, passes: int = 1) -> obs_steps.CostInfo:
        """The step's counted FLOPs and bytes (obs/steps.step_cost)
        from the engine's weight and pool sizes."""
        return obs_steps.step_cost(
            self.config, kind, rows, tokens, ctx_lens,
            emit_rows=emit_rows, passes=passes,
            weight_bytes=self._weight_bytes,
            embed_row_bytes=self._embed_row_bytes,
            kv_bytes_per_token=self._kv_bytes_per_token)

    def _record(self, kind: str, *, rows: int, tokens: int, cost,
                wall_s: float, dispatch_s: Optional[float] = None,
                timing=None, compiled: bool = False, rids=(),
                **split) -> None:
        """One flight record: the step's device time from its timing
        events (read without a wait; the wall when there are none), its
        cost and the pool's occupancy; and the step-latency histogram
        of its path."""
        self.flight.record(
            kind, rows=rows, tokens=tokens, dispatch_s=dispatch_s,
            device_s=elapsed_s(timing), wall_s=wall_s, cost=cost,
            compiled=compiled, pages_free=self._pager.free_pages,
            pages_total=self.cache.n_pages, rids=list(rids), **split)

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
        runner = self._mixed_step_runner()
        handle = runner.run(
            self._n_top_for(emit_rows) if emit_rows else None, tokens, pos,
            qlen, active, emit, self._steps, self._temp, self._top_p,
            self._penalty)
        self.stats.steps += 1
        self._step_stats.step(bytes_out=len(emit_rows))
        # the step's wall is counted when outputs are fetched, over every
        # step dispatched since the last fetch, split by token share
        # between prefill and decode; so is its flight record, with the
        # device time of its replay's timing events
        if self._mixed_open is None:
            self._mixed_open = [t0, 0, 0, []]
        self._mixed_open[1] += int(sum(qlen[s] for s in chunk_rows))
        self._mixed_open[2] += len(decode_rows)
        n_rows = len(decode_rows) + len(chunk_rows)
        self._mixed_open[3].append(dict(
            t0=t0, dispatch_s=time.perf_counter() - t0,
            timing=runner.timing, compiled=self._took_capture(),
            rows=n_rows, tokens=len(emit_rows),
            rows_decode=len(decode_rows), rows_prefill=len(chunk_rows),
            rows_idle=B - n_rows,
            rids=[self._slot_req[s].rid for s in decode_rows]
            + [self._mixed_pending[s]["req"].rid for s in chunk_rows],
            cost=self._cost(
                "mixed", n_rows, len(emit_rows),
                [(int(pos[s]), 1) for s in decode_rows]
                + [(int(pos[s]), int(qlen[s])) for s in chunk_rows],
                len(emit_rows))))
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
        prefill and decode times, split by the steps' token shares, and
        record each of those steps: its wall is its dispatch, the last
        one's up to now (its fetch); its device time its timing events'
        (read only when the stream has passed them)."""
        if self._mixed_open is None:
            return
        t0, chunk_toks, decode_toks, steps = self._mixed_open
        self._mixed_open = None
        now = time.perf_counter()
        dt = now - t0
        pf = dt * chunk_toks / (chunk_toks + decode_toks)
        self.stats.prefill_time_s += pf
        self.stats.decode_time_s += dt - pf
        for i, st in enumerate(steps):
            wall = (now - st["t0"] if i == len(steps) - 1
                    else st["dispatch_s"])
            _PAGED_ATTN_STEP.labels(path="mixed").observe(wall)
            self._record("mixed", rows=st["rows"], tokens=st["tokens"],
                         cost=st["cost"], wall_s=wall,
                         dispatch_s=st["dispatch_s"], timing=st["timing"],
                         compiled=st["compiled"], rids=st["rids"],
                         rows_decode=st["rows_decode"],
                         rows_prefill=st["rows_prefill"],
                         rows_idle=st["rows_idle"])

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
        self.tracer.prefill_start(rid)
        t0 = time.perf_counter()
        req.slot = slot
        self._slot_req[slot] = req
        # a preempted request re-prefills prompt + generated tokens
        ids, prime = self._folded(req)
        # match BEFORE page admission: a hit changes the allocation
        hit = self._match_and_validate_prefix(ids)
        if not self._alloc_slot_pages(req, slot, hit):
            return None   # pool exhausted: requeued (or failed) inside
        n_top = self._n_top_for([slot])
        if hit is not None:
            out = self._prefixed_prefill_device(ids, slot, req, hit[1],
                                                n_top, prime)
            n_pre = len(hit[1][0])
            self.stats.prefix_hits += 1
            _PREFIX_PAGED_HITS.inc()
            _PREFIX_TOKENS_SAVED.inc(n_pre)
            if self.events is not None:
                self.events.publish("prefix_hit", rid=rid, pid=hit[0],
                                    tokens_saved=n_pre)
        else:
            out = self._prefill_device(ids, slot, req, n_top, prime)
            n_pre = 0
        return (req, t0, slot, out, self._prefill_runs(ids, n_pre))

    def _prefill_runs(self, ids, n_prefix: int) -> list:
        """(pos, n) of each window a phase-split prefill runs for `ids`
        after `n_prefix` shared tokens (the step cost's runs; bucket
        padding left out): one window, or --prefill-chunk windows when
        the part to prefill is longer than the chunk."""
        C = self.prefill_chunk
        n = len(ids) - n_prefix
        if not (C and n > C):
            return [(n_prefix, n)]
        return [(n_prefix + a, min(C, n - a)) for a in range(0, n, C)]

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
        timing = [None]

        def flush():
            end = mark(self.device)
            hosts = self._fetch_samples([p[3] for p in pend])
            # one wall interval a group: its admissions overlap
            dt = time.perf_counter() - pend[0][1]
            self.stats.prefill_time_s += dt
            _PAGED_ATTN_STEP.labels(path="prefill").observe(dt / len(pend))
            # one record a group (per-admission walls would count the
            # overlap several times), with the group's summed cost and
            # the device time between the group's timing events
            runs = [r for p in pend for r in p[4]]
            self._record(
                "prefill", rows=len(pend), tokens=len(pend),
                cost=self._cost("prefill", len(pend), len(pend), runs,
                                len(pend), passes=len(runs)),
                wall_s=dt, timing=(timing[0], end) if end else None,
                rids=[p[0].rid for p in pend])
            for (req, _t0, slot, _, _), host in zip(pend, hosts):
                self._advance_mirrors([slot], host[0])
                first, first_lp, tids, tlps = host
                self._emit(req, int(first[slot]),
                           logprob=float(first_lp[slot]),
                           top=self._top(tids, tlps, slot))
            pend.clear()

        for rid, slot in prefill_plan:
            if not pend:
                timing[0] = mark(self.device)
            p = self._do_prefill(rid, slot)
            if p is not None:
                pend.append(p)
            if len(pend) >= self.PREFILL_FLUSH:
                flush()
        if pend:
            flush()

    def _prefill_device(self, ids, slot: int, req: _Request, n_top: int,
                        prime=()):
        """Prefill one slot, whole-prompt or in --prefill-chunk windows
        (prompts longer than C), and sample its first token."""
        C = self.prefill_chunk
        if C and len(ids) > C:
            logits = self._prefill_chunked(ids, slot, C)
        else:
            logits = self._prefill_raw(ids, slot)
        return self._finish_prefill(logits, slot, len(ids), req, n_top,
                                    prime)

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
                                 entry, n_top: int, prime=()):
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
        return self._finish_prefill(logits, slot, len(ids), req, n_top,
                                    prime)

    def _finish_prefill(self, logits, slot: int, prompt_len: int,
                        req: _Request, n_top: int, prime=()):
        """Set the slot's sampling state (its penalty ring primed with
        a preemption fold's generated tokens) and sample its first token
        on its own stream. Returns the device sample (_do_prefill_batch
        fetches it and moves the slot's mirrors)."""
        self._pos[slot] = prompt_len
        self._temp[slot] = req.temperature
        self._top_p[slot] = req.top_p
        self._penalty[slot] = req.repeat_penalty
        self._prime_ring(slot, prime)
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
                pool=self._graph_pool,
                on_capture=self._captured("decode_scan"))
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
        disp = time.perf_counter() - t0
        fetched = DecodeRunner.fetch(handle)
        self.stats.steps += 1
        dt = time.perf_counter() - t0
        self.stats.decode_time_s += dt
        _PAGED_ATTN_STEP.labels(path="decode").observe(dt)
        self._complete_scan(decode_plan, 1, fetched, budget,
                            record=("decode", disp, dt, handle.timing,
                                    self._took_capture()))

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
            t0d = time.perf_counter()
            handle = self._dispatch_scan(rows, n, n_top, budget,
                                         fresh=state is None)
            disp = time.perf_counter() - t0d
            for _, slot in decode_plan:
                shipped[slot] = shipped.get(slot, 0) + int(budget[slot])
            self.stats.steps += n
            return (handle, budget, disp, self._took_capture()), True

        def complete(devs):
            handle, budget, disp, compiled = devs
            t0f = time.perf_counter()
            fetched = DecodeRunner.fetch(handle)
            now = time.perf_counter()
            self.stats.decode_time_s += now - clock[0]
            clock[0] = now
            # one record a burst: its own dispatch wall, and the fetch
            # wall beside it (the device time is its timing events')
            self._complete_scan(decode_plan, n, fetched, budget,
                                record=("decode_scan", disp,
                                        disp + now - t0f, handle.timing,
                                        compiled))
            for _, slot in decode_plan:
                shipped[slot] = shipped.get(slot, 0) - int(budget[slot])

        steps0 = self.stats.steps
        t_burst = time.perf_counter()
        self._drive_burst(dispatch, complete, can_chain)
        self.stats.decode_time_s += time.perf_counter() - clock[0]
        _PAGED_ATTN_STEP.labels(path="decode").observe(
            (time.perf_counter() - t_burst)
            / max(1, self.stats.steps - steps0))

    def _complete_scan(self, decode_plan, n: int, fetched, budget,
                       record=None) -> None:
        """Record one fetched burst (record: its kind, dispatch wall,
        wall and timing events, and whether it captured a graph), then
        emit its tokens and advance the host mirrors. A row emits
        min(its budget, EOS cut) tokens, where the step froze it, so the
        mirrors advance by the emitted count."""
        if record is not None:
            kind, disp, wall, timing, compiled = record
            live = [(rid, s) for rid, s in decode_plan if budget[s] > 0]
            tokens = int(budget.sum())
            self._record(
                kind, rows=len(decode_plan), tokens=tokens,
                cost=self._cost(
                    kind, len(decode_plan), tokens,
                    [(int(self._pos[s]) + j, 1) for _, s in live
                     for j in range(int(budget[s]))], tokens, passes=n),
                wall_s=wall, dispatch_s=disp, timing=timing,
                compiled=compiled, rids=[r for r, _ in decode_plan])
            self._step_stats.step(bytes_out=tokens)
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
            self.tracer.first_token(req.rid)
            # per-class TTFT, queue wait and preemption requeues included
            _SCHED_TTFT.labels(req.priority).observe(now - req.submit_t)
        else:
            self.tracer.token(req.rid)
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
            if self._shed is not None:
                self._shed.observe_retire()
            self.tracer.finish(req.rid, "retired",
                               output_tokens=len(req.out_tokens))
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
            self.tracer.finish(rid, "error", error=str(err),
                               output_tokens=len(req.out_tokens))
            req.done.set()
