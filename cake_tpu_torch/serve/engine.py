"""Continuous-batching inference engine over the paged KV pool or a
dense cache.

Counterpart of `cake_tpu/serve/engine.py`: its `--kv-pages` engine
(below), and without pages its dense flavors, which share the
phase-split loop, scheduling, preemption, recovery, the journal and
reconfiguration with it:

  * the dense engine: one [L, B, T] KVCache, a row of T positions a
    slot; admissions prefill alone into their slot (`prefill_slot` by
    bucket, `prefill_slot_chunk` windows with --prefill-chunk, a
    registered prefix's KV installed from the registry by
    `prefill_slot_prefixed` or `install_prefix_slot`), then the planned
    rows take the ragged decode step (`forward_ragged`, the masked
    einsum over every slot) or its K-step bursts;
  * the ring engine, for a sliding-window config whose window W is
    shorter than max_seq_len: the cache holds W slots, position p in
    slot p % W; every prompt prefills in windows of at most W
    (`prefill_slot_chunk_ring`: the pre-write ring plus the fresh
    window, then the write), decode writes wrap
    (`forward_ragged_ring`); it serves no prefix and takes no switch;
  * the dense spec engine (`draft_params`, --draft-model behind --api):
    a draft KVCache beside the target's, both prefilled at admission,
    and batched propose-verify rounds over every decoding slot
    (`speculative.spec_round_batched`) chained on the device; no
    preemption, recovery or switch, as in JAX.

The paged engine:

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
    lowest-class slot (`_maybe_preempt`): its pages go back through the
    refcounted allocator and it requeues with its seniority, to resume
    from its spilled pages (below) or re-prefill its prompt and
    generated tokens (the recompute fold); shedding refuses an arrival
    with a computed Retry-After;
  * the host KV tier (`kv_host_pages`, --kv-host-pages; kv/host_tier.py):
    a preemption victim's own pages spill to pinned host RAM and its
    re-admission installs them and resumes decoding at the spilled
    frontier, without a prefill (`_spill_victim_pages`,
    `_restore_victim`); a cold shared prefix spills under page pressure
    and streams back on its next hit (`_spill_cold_prefixes`,
    `_restore_prefix`); an admission that still does not fit parks the
    least recently admitted decoding stream (`_spill_resident_stream`).
    A spill that fails is logged and counted, and the fold serves;
  * fp8 pools (--kv-dtype f8_e4m3 | f8_e5m2) run the fp8 instantiations
    of the paged-attention kernels, which convert a page on load;
  * observability (obs/): a lifecycle trace per request (`tracer`), a
    flight record per device step (`flight`, with the step's counted
    FLOPs and bytes and its device time from CUDA events read at the
    fetch that already happens), the event bus (`events`) and SLO
    accounting (`slo`), all built from values the host already has;
  * crash recovery (`recovery`; --recovery, on by default at the
    serving entry points, as in JAX): a failed iteration
    implicates the rows of the dispatch that failed, rebuilds the pool
    and the sampling state (the old pool and the captured graphs are
    released first), and resubmits every surviving request through the
    recompute fold, so greedy streams finish with the tokens an
    uninterrupted run gives; a request implicated in implication_budget
    consecutive failures is quarantined (PoisonRequestError), and a
    reset storm or a rebuild that itself fails snapshots the in-flight
    requests (`snapshot_path`) and stops the engine cleanly;
  * deterministic fault injection (`fault_plan`, faults/): named sites
    (engine.step, engine.prefill, engine.mixed, engine.decode,
    pager.alloc, host_tier.fetch, host_tier.install, journal.*), each
    one `is not None` test on the host, none inside a graph capture;
  * durable serving: the write-ahead request journal (`journal`,
    serve/journal.py) with idempotency keys that attach a retried
    submit to its stream, the runtime checkpoint (serve/checkpoint.py,
    `shutdown_save`, the pre-fail snapshot), and drain (`begin_drain`:
    new submits raise DrainingError while in-flight work finishes);
  * live reconfiguration (`autotune`, --autotune manual | auto;
    autotune/): `reconfigure` hot-switches the engine to another
    EngineConfig (slots, --decode-scan, pool pages, page size, KV dtype,
    mixed batching, attention impl) between iterations: every in-flight
    stream folds its generated tokens into its prompt, the old pool and
    its captured graphs are freed before the new ones are allocated and
    captured, and every request requeues with its seniority, so greedy
    streams finish token-identical at f32; `auto` runs the policy
    controller from the loop (`_autotune_tick`);
  * the control plane of obs/: the anomaly sentinel (`sentinel`,
    --sentinel; obs/sentinel.py) over the engine's own rings, its action
    plane (--sentinel-act; obs/actions.py), which can hold or roll back
    a switch, the per-request timeline (`request_timeline`;
    obs/timeline.py) and the black-box postmortem bundles
    (--postmortem-dir), written at a breaker or failed-rebuild stop and
    at a poison quarantine;
  * paged speculative decoding (`spec_draft_params`, --spec-draft;
    spec/): a draft model's KV lives in a second pool of the same page
    geometry whose pages come from the one allocator; a decoding row
    whose sampling is temperature-only rides one batched draft+verify
    round (`_do_spec_paged`, spec/round.spec_round_paged) in a
    pure-decode iteration, its draft row prefilled at activation, both
    table rows extended to cover the round before it and truncated back
    to the accepted frontier after it; a collapsing stream degrades to
    plain decode, and the gamma tuner narrows gamma engine-wide;
  * disaggregated prefill/decode (`disagg`, --disagg prefill | decode;
    kv/transfer.py): the decode engine is the front door and holds an
    admission out of the scheduler while its prompt goes to the prefill
    peer, which prefills it as a one-token request and, at retirement,
    fetches the written pages before they are freed
    (`_capture_shipment`) and ships them; the decode engine installs
    them into the admitted row and emits the peer's first token
    verbatim (`_adopt_install`). Any failure (a `kv.ship` or `kv.adopt`
    fault, a peer that is down, a timeout, a corrupt or stale shipment)
    degrades to whole-prompt prefill on the decode engine;
  * fleet telemetry (`telemetry`: the API server's federation
    collector, obs/federation.py): `request_timeline` merges the
    collector's remote events for the request.

Both steps, and the phase-split loop's one-slot prefills, run as
captured CUDA graphs on the card (there is no eager step there), and
eagerly on the CPU: the decode step, its sampling and its carry through
`serve/graphs.DecodeRunner` (over the pool, the dense cache or the
ring), the mixed step and its sampling through
`serve/graphs.MixedRunner`, the paged prefills through
`serve/graphs.PrefillRunner` and the dense ones through
`serve/graphs.DensePrefillRunner`, the paged speculative round through
`serve/graphs.SpecRunner`, the dense one through
`serve/graphs.DenseSpecRunner`, and each draft prefill through a second
prefill runner (each capture counted as a compile of its JAX
function). A recovery resets the pool, the table and the sampling
state in place and keeps every graph, as JAX's reset keeps its jitted
steps; only when that raises does it rebuild. A mixed step's rows go up
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
(`_run_on_engine_thread`).

Topology-sharded serving (`step_fns`, `cache`, `ring`: JAX's seam) runs
the dense or ring engine over the caller's steps and cache: a sharded
model's pipelined prefill, decode and chunk steps
(parallel/pipeline.make_engine_step_fns) captured by the same runners,
its ShardedKVCache reset in place by a recovery. Such an engine serves
a prefix by installing its sharded lines and windowing the suffix
through the chunk step, takes no --kv-pages, speculation or live
switch, as in JAX. The sp engine runs the same seam over the sequence-
parallel steps (parallel/context_parallel.make_sp_engine_step_fns: the
ring slot prefill, one captured step for the whole window, and the
merged-stats ragged decode) and an SPEngineCache, with JAX's windowed
limits: `prompt_limit` refuses a longer prompt, `decode_budget` caps
each request's generation at the decode tail, and preemption is off
unless asked for.

Multi-process serving (JAX's control channel, serve/control.py): over a
mesh whose stages live in several processes, the coordinator's engine
publishes one op record before each device step (`attach_control`,
`_publish`: prefill, prefill_prefixed, decode, decode_scan,
register_prefix, unregister_prefix, reset, stop) and every follower
replays it (`run_follower_loop`), so the processes run the same steps in
the same order and their hops meet. A decode op carries the carry a
fresh burst loads from the host mirrors, so a follower keeps none.
"""

from __future__ import annotations

import functools
import logging
import threading
import time
import traceback
import weakref
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from cake_tpu_torch.analysis import engine_thread_only
from cake_tpu_torch.autotune.space import resolve_paged_attn
from cake_tpu_torch.autotune.spec import SpecGammaTuner
from cake_tpu_torch.faults import build_injector
from cake_tpu_torch.faults.plan import InjectedFault
from cake_tpu_torch.kv.host_tier import (
    HostTier, SpilledPages, note_resident_spill, pool_dtype_name,
)
from cake_tpu_torch.kv.quantized_pool import (
    QUANTIZED_CACHES, page_bytes, reset_page_scales,
)
from cake_tpu_torch.kv.transfer import Shipment, note_adopt
from cake_tpu_torch.models.chat import BEGIN_OF_TEXT, History, Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import (
    bucket_length, chunk_windows, encode_text, incremental_decode,
)
from cake_tpu_torch.models.llama.cache import KVCache
from cake_tpu_torch.models.llama.model import (
    RopeTables, forward_ragged, forward_ragged_ring, prefill,
)
from cake_tpu_torch.models.llama.paged import (
    ATTN_IMPLS, PageAllocator, PagedKVCache, chunk_write_targets,
    fixed_prompt_targets, forward_ragged_paged, mixed_step_paged,
    prefill_prefix_pages, table_set_slot,
)
from cake_tpu_torch.models.llama.params import params_bytes
from cake_tpu_torch.obs import metrics as obs_metrics
from cake_tpu_torch.obs import steps as obs_steps
from cake_tpu_torch.obs.events import EventBus
from cake_tpu_torch.obs.slo import SLOAccountant, parse_slo_targets
from cake_tpu_torch.obs.tracing import RequestTracer
from cake_tpu_torch.ops.sampling import SamplingConfig, masked_sample
from cake_tpu_torch.parallel.pipeline import (
    install_prefix_sharded, prefix_lines,
)
from cake_tpu_torch.parallel.sharding import zeros_placed
from cake_tpu_torch.sched import (
    SchedConfig, ShedController, ShedError, make_scheduler,
)
from cake_tpu_torch.sched.classes import CLASS_RANK, validate_priority
from cake_tpu_torch.serve.errors import (
    DrainingError, EngineResetError, PoisonRequestError, RecoveryConfig,
    as_engine_error,
)
from cake_tpu_torch.serve.graphs import (
    DENSE_PREFILL_FNS, PREFILL_FNS, DecodeRunner, DensePrefillRunner,
    DenseSpecRunner, MixedRunner, PrefillRunner, SpecRunner, elapsed_s,
    mark,
)
from cake_tpu_torch.spec.state import (
    DISABLE_AFTER_FAILS, SPEC_DEGRADED, STREAM_ACCEPT_FLOOR,
    STREAM_WARMUP_ROUNDS, SpecPlane, SpecState,
)
from cake_tpu_torch.utils.devices import (
    resolve_device, resolve_kv_dtype, to_device, zero_,
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

# crash recovery: a rebuild that itself failed, recovery outcomes,
# requests carried across a reset, and requests quarantined as poison
_RESET_FAILURES = obs_metrics.counter(
    "cake_engine_reset_failures_total",
    "Post-error engine resets that themselves failed (engine stopped)")
_RECOVERIES = obs_metrics.counter(
    "cake_engine_recoveries_total",
    "Engine step-failure recovery attempts by outcome (recovered = "
    "reset + in-flight requests resubmitted; storm_breaker = too many "
    "resets in the window, snapshot + clean stop; reset_failed = the "
    "rebuild itself failed, engine stopped)",
    labelnames=("outcome",))
_RECOVERED_REQUESTS = obs_metrics.counter(
    "cake_requests_recovered_total",
    "In-flight requests carried across an engine reset via the "
    "fold-tokens-into-prompt resubmit (no client-visible failure)")
_POISON_REQUESTS = obs_metrics.counter(
    "cake_poison_requests_total",
    "Requests quarantined with a typed non-retryable error, by reason "
    "(implicated = present in implication_budget consecutive failed "
    "steps; resubmit_failed = recovery could not requeue it)",
    labelnames=("reason",))
_RECOVERY_SECONDS = obs_metrics.histogram(
    "cake_engine_recovery_seconds",
    "Wall seconds from deciding to recover to every surviving request "
    "requeued (backoff wait + cache rebuild + resubmission)")

# how long a failure's request capture stays the pre-fail snapshot's
# fallback (a snapshot asked for after the registry was emptied)
_FAIL_RECS_TTL_S = 60.0


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
    # tokens generated before a checkpoint or journal resume: they seed
    # the slot's repeat-penalty ring
    prime_tokens: List[int] = field(default_factory=list)
    # consecutive failed steps this request was dispatched in; an emit
    # resets it, and recovery quarantines it at the implication budget
    crash_count: int = 0
    # durable serving: the client's idempotency key (a retried submit
    # with the same key attaches instead of admitting again), and the
    # tokens of earlier process generations a replay folded into
    # prompt_ids; the absolute stream position (SSE event ids, journal
    # emit counts) is len(replayed_tokens) + len(out_tokens)
    idempotency_key: Optional[str] = None
    replayed_tokens: List[int] = field(default_factory=list)
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
    # host tier: the admission installed the request's spilled pages
    # (no prefill to run); the prefix hit the admission really mapped (a
    # spilled prefix that could not come back downgrades it to None);
    # the admission's LRU stamp and the tokens it had, for the resident
    # spill's victim choice and anti-thrash quantum
    _kv_restored: bool = False
    _effective_hit: object = None
    _admit_seq: int = 0
    _resident_base: int = 0
    # disaggregated serving (kv/transfer.py): on the PREFILL engine, the
    # callback handed the captured page shipment at retirement; on the
    # DECODE engine, True while the admission waits for the peer's
    # shipment (disagg_complete enters it into the scheduler)
    ship_sink: Optional[Callable] = None
    _disagg_pending: bool = False


class RequestHandle:
    """Caller-side view of a submitted request (`attached`: an
    idempotent submit that attached to an existing stream)."""

    attached = False

    def __init__(self, req: _Request, tokenizer, eos_ids):
        self._req = req
        self._tokenizer = tokenizer
        self._eos_ids = eos_ids

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._req.done.wait(timeout)

    def finished(self) -> bool:
        """True once the request retired (tokens final or error set),
        without blocking; the disagg prefill plane's writer uses it to
        spot admissions that died before capturing a shipment."""
        return self._req.done.is_set()

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

    @property
    def ttft(self) -> float:
        """Seconds from submit to first token (queueing included); 0.0
        before the first token."""
        r = self._req
        return (r.first_token_t - r.submit_t) if r.first_token_t else 0.0

    @property
    def tokens_per_s(self) -> float:
        """Tokens after the first over the seconds since the first (to
        the finish, or now while the stream runs); 0.0 below two
        tokens."""
        r = self._req
        n = len(r.out_tokens)
        dt = (r.finish_t or time.perf_counter()) - (r.first_token_t or 0)
        return (n - 1) / dt if n > 1 and dt > 0 else 0.0


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
    # host KV tier: spill/restore EVENTS (cake_kv_spill_total counts
    # pages); resident spills are the subset that parked an actively
    # decoding stream to admit a new one
    kv_spills: int = 0
    kv_restores: int = 0
    kv_resident_spills: int = 0
    # spills that failed (logged; the victim takes the recompute fold,
    # a cold prefix stays on the device)
    kv_spill_failures: int = 0
    # crash recovery: successful reset + resubmits, the requests carried
    # across them, and the requests quarantined as poison
    recoveries: int = 0
    requests_recovered: int = 0
    poisoned: int = 0
    # paged speculative decoding: drafts offered / kept across all slots
    spec_proposed: int = 0
    spec_accepted: int = 0
    # live reconfiguration: switches applied, and the autonomous ones the
    # rollback guard reverted
    config_switches: int = 0
    config_rollbacks: int = 0
    # disaggregated serving: shipments captured (prefill engine) and
    # adopted (decode engine)
    kv_ships: int = 0
    kv_adopts: int = 0

    @property
    def spec_acceptance(self) -> float:
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0)

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


def _decode_as_forward(decode_fn):
    """A decode_ragged_fn(params, tokens, pos, active, cache, rope,
    config) in the ragged forward's argument order (params, tokens,
    cache, pos, active, rope, config), which the decode runner calls."""
    def forward_fn(params, tokens, cache, pos, active, rope, config):
        return decode_fn(params, tokens, pos, active, cache, rope, config)
    return forward_fn


class InferenceEngine:
    """Slot-based continuous batching over one shared paged KV pool."""

    # -- cakelint vocabulary (python -m cake_tpu_torch.tools.cakelint) --
    # The JAX engine's declarations (cake_tpu/serve/engine.py), over the
    # port's locks: the live switch runs under _admit_lock (the lock
    # submit() registers under), which therefore guards the pager swap;
    # _switch_lock guards only the switch's in-flight flag.
    # ENGINE_THREAD_ATTRS is single-writer engine-thread state: the
    # mapped lock (if any) is the ONE lock whose holder may touch the
    # attr from a handler thread; None means only _run_on_engine_thread
    # reaches it. HANDLER_THREAD_METHODS are the entry points that run
    # on HTTP handler / scrape / signal / health threads and are
    # statically checked against that table.
    ENGINE_THREAD_ATTRS = {
        # paged pool + page-table row state (the pager swaps wholesale
        # during a live reconfigure: admission reads its bounds under
        # the same lock the switch holds)
        "_pager": "_admit_lock",
        # slot -> request mapping and the per-slot device mirrors:
        # written only between device steps by the engine loop
        "_slot_req": None,
        "_mixed_pending": None,
        "_implicated": None,
        "_last_tok": None,
        "_page_starved": None,
        "_pending_page_preempt": None,
        # decode-resident spill state (_spill_resident_stream): the
        # admission-order stamp for LRU victim choice, the iteration's
        # decode-resident candidate set, and the parked flag that
        # forces the decode dispatch to re-validate its (stale) plan
        "_admit_seq": None,
        "_cur_decode": None,
        "_resident_parked": None,
        # handler<->engine mailboxes: strictly lock-guarded
        "_cancel_q": "_rid_lock",
        "_cmd_q": "_rid_lock",
        # disaggregated serving: shipments staged by the decode plane's
        # channel thread (disagg_complete) for the engine thread's
        # adoption in _do_prefill/_mixed_admit
        "_adopt_store": "_rid_lock",
    }
    HANDLER_THREAD_METHODS = (
        "submit", "chat", "cancel", "stop", "begin_drain",
        "drain_state", "_drain_eta_s", "register_prefix",
        "unregister_prefix", "_auto_register_system",
        "_attach_idempotent", "seed_finished_idempotent",
        "reconfigure", "request_timeline", "recovery_state",
        "autotune_state", "current_config", "_set_queue_gauges",
        "shutdown_save", "_snapshot_before_fail", "_fail_all",
        "disagg_complete",
    )
    # optional subsystems (None = disabled plane): every dotted use
    # must sit under an `is not None` guard so a disabled plane costs
    # exactly one attribute read per site
    OPTIONAL_PLANES = ("_faults", "events", "_journal", "_shed",
                       "_control", "_host_tier", "_autotuner",
                       "telemetry", "sentinel", "_actions",
                       "_postmortem", "_disagg", "_specp")
    # the only legal nesting order; _rid_lock sits on the submit/emit
    # hot path, so nothing may block under it
    LOCK_ORDER = ("_switch_lock", "_admit_lock", "_rid_lock", "_ckpt_lock")
    NO_BLOCKING_UNDER = ("_rid_lock",)

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
        kv_host_pages: Optional[int] = None,
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
        fault_plan=None,
        recovery: Optional[bool] = None,
        recovery_config: Optional[RecoveryConfig] = None,
        journal: Optional[str] = None,
        journal_fsync: str = "batch",
        spec_draft_params=None,
        spec_draft_config: Optional[LlamaConfig] = None,
        spec_gamma: int = 4,
        draft_params=None,
        draft_config: Optional[LlamaConfig] = None,
        autotune: Optional[str] = None,
        autotune_policy=None,
        autotune_config=None,
        sentinel: bool = False,
        sentinel_interval: float = 2.0,
        sentinel_act: bool = False,
        postmortem_dir: Optional[str] = None,
        disagg: Optional[str] = None,
        disagg_peer: Optional[str] = None,
        disagg_token: Optional[str] = None,
        disagg_timeout_s: float = 30.0,
        step_fns=None,
        cache=None,
        ring: Optional[bool] = None,
        prompt_limit: Optional[int] = None,
        decode_budget: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the engine on "
                f"{self.device}")
        # paged speculative decoding (spec/): spec as a row KIND of the
        # paged engine, with JAX's constructor checks
        if spec_draft_params is not None:
            if draft_params is not None:
                raise ValueError(
                    "--spec-draft (paged spec rows) and --draft-model "
                    "(the dense spec engine) are mutually exclusive")
            if kv_pages is None:
                raise ValueError(
                    "--spec-draft requires --kv-pages: paged "
                    "speculative decoding shares the page allocator")
            if kv_dtype in ("int8", "int4"):
                raise ValueError(
                    f"--spec-draft requires f32/bf16/fp8 KV pages, got "
                    f"--kv-dtype {kv_dtype}: the draft pool has no "
                    "quantized flavor")
            if spec_draft_config.vocab_size != config.vocab_size:
                raise ValueError(
                    "spec draft and target must share a vocabulary")
            if spec_gamma < 1:
                raise ValueError(
                    f"spec_gamma must be >= 1, got {spec_gamma}")
            if mixed_batch == "off":
                raise ValueError(
                    "--spec-draft runs its rounds in the mixed loop's "
                    "pure-decode iterations: --mixed-batch off is not "
                    "supported with it")
            if spec_draft_params["embed"].device != self.device:
                raise ValueError(
                    f"draft params live on "
                    f"{spec_draft_params['embed'].device}, the engine on "
                    f"{self.device}")
        # the engine's flavor, JAX's choice: the paged pool with
        # kv_pages; else a dense [L, B, T] cache, or a ring of W = window
        # slots for a sliding-window config shorter than max_seq_len;
        # with a draft model the dense spec engine
        self.paged = kv_pages is not None
        self.ring = (not self.paged and config.sliding_window is not None
                     and config.sliding_window < max_seq_len)
        # step_fns: JAX's seam, 2-4 fns replacing the dense engine's
        # steps, (prefill_slot_fn, decode_ragged_fn[, decode_scan_fn
        # [, prefill_chunk_fn]]) with the signatures of
        # model.prefill_slot, model.decode_step_ragged, the ragged
        # forward the decode runner replays K times a burst
        # (model.forward_ragged's) and model.prefill_slot_chunk, over
        # `cache`, placed for them (parallel/pipeline
        # .make_engine_step_fns: topology-sharded serving); ring=True:
        # they run a ring cache (the caller passes a W-long one)
        self._custom_steps = step_fns is not None
        self._step_fns = None
        if self._custom_steps:
            fns = tuple(step_fns)
            if not 2 <= len(fns) <= 4:
                raise ValueError(
                    f"step_fns takes 2-4 functions, got {len(fns)}")
            self._step_fns = fns = fns + (None,) * (4 - len(fns))
            self.ring = bool(ring) and not self.paged
            if ring and fns[3] is None:
                raise ValueError(
                    "ring step fns require a chunked-prefill variant "
                    "(every ring prompt prefills in windows <= W)")
            if cache is None and not self.paged:
                raise ValueError(
                    "custom step fns run over the cache placed for them: "
                    "pass cache=")
        self._spec = draft_params is not None
        if self._spec:
            if self._custom_steps or (
                    config.sliding_window is not None
                    and config.sliding_window < max_seq_len):
                raise ValueError(
                    "the speculative engine requires the built-in dense "
                    "single-device path (no topology/ring step fns)")
            if draft_config.vocab_size != config.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            if spec_gamma < 1:
                raise ValueError(
                    f"spec_gamma must be >= 1, got {spec_gamma}")
            if draft_params["embed"].device != self.device:
                raise ValueError(
                    f"draft params live on {draft_params['embed'].device}, "
                    f"the engine on {self.device}")
        if self.paged and (self._spec or self._custom_steps or (
                config.sliding_window is not None
                and config.sliding_window < max_seq_len)):
            raise ValueError(
                "--kv-pages requires the built-in dense single-device "
                "path (no topology/ring/speculative mode)")
        if self.paged and cache is not None:
            raise ValueError(
                "--kv-pages builds its own page pool; a pre-placed "
                "cache= cannot apply")
        if disagg is not None and kv_pages is None:
            raise ValueError(
                "--disagg requires the paged KV pool (--kv-pages): "
                "pages are the transfer unit")
        if kv_dtype in QUANTIZED_CACHES and not self.paged:
            raise ValueError(
                f"--kv-dtype {kv_dtype} requires --kv-pages: quantized "
                "KV pages live in the paged pool"
                + (" (speculative serving is gated off the paged "
                   "engine, so it cannot quantize KV)" if self._spec
                   else ""))
        mb = mixed_batch or "auto"
        if mb not in ("auto", "on", "off"):
            raise ValueError(
                f"--mixed-batch must be auto, on or off, got {mb!r}")
        if mb == "on" and not self.paged:
            raise ValueError(
                "--mixed-batch on requires --kv-pages: the mixed "
                "ragged step dispatches over the paged pool")
        impl = None
        if self.paged:
            impl = paged_attn or "auto"
            if impl not in ATTN_IMPLS:
                raise ValueError(f"--paged-attn must be one of "
                                 f"{ATTN_IMPLS}, got {impl!r}")
            # "auto" resolves by the ONE rule the autotuner's comparison
            # key uses too (autotune/space.resolve_paged_attn): the
            # kernels on a card, their plain versions on the CPU
            impl = self._check_attn(resolve_paged_attn(impl, self.device))
        elif kv_host_pages is not None:
            log.warning("--kv-host-pages ignored: the host KV tier "
                        "spills paged pool pages (set --kv-pages)")
            kv_host_pages = None
        if decode_scan_steps < 1:
            raise ValueError(
                f"--decode-scan must be >= 1, got {decode_scan_steps}")
        if self._custom_steps:
            if decode_scan_steps > 1 and self._step_fns[2] is None:
                log.warning(
                    "decode_scan_steps=%d ignored: these custom step fns "
                    "provide no scan variant", decode_scan_steps)
                decode_scan_steps = 1
            if prefill_chunk is not None and self._step_fns[3] is None:
                # before validation: an engine whose step fns lack a
                # chunk variant ignores the knob with a warning
                log.warning("prefill_chunk ignored: these custom step fns "
                            "provide no chunked-prefill variant")
                prefill_chunk = None
        if self._spec:
            if prefill_chunk is not None:
                log.warning("prefill_chunk ignored in speculative mode "
                            "(whole-prompt prefill keeps the draft cache "
                            "aligned)")
                prefill_chunk = None
            if decode_scan_steps > 1:
                log.warning("decode_scan ignored in speculative mode "
                            "(each spec round already amortizes up to "
                            "gamma+1 tokens per dispatch)")
                decode_scan_steps = 1
        if self.ring:
            # every ring prefill is a window of at most W tokens
            W = config.sliding_window
            prefill_chunk = min(prefill_chunk or min(512, W), W)
        if prefill_chunk is not None and (
                prefill_chunk < 1 or max_seq_len % prefill_chunk != 0):
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must be >= 1 and divide "
                f"max_seq_len {max_seq_len}"
                + (" (ring/sliding-window serving requires a chunk that "
                   "divides max_seq_len; pass --prefill-chunk)"
                   if self.ring else ""))
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        # a windowed layout (the sp engine: a prompt window and a decode
        # tail) bounds prompts and each request's generation apart from
        # max_seq_len; None = the single-window rules
        self.prompt_limit = prompt_limit
        self.decode_budget = decode_budget
        self.defaults = sampling or SamplingConfig()
        self.n_top = top_logprobs_cap
        self.paged_attn = impl
        # decode steps a host round trip (bursts of the captured step)
        self._decode_scan = decode_scan_steps
        # --mixed-batch off (and every dense flavor): the phase-split
        # loop (whole-prompt or C-token-window prefills, then decode)
        self._mixed = self.paged and mb != "off"
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
        # a ring cache owns its layout (a prefix install writes dense
        # positions), and the spec engine keeps its draft cache aligned
        # with the target (a prefix-cached target prefill would leave
        # the draft cold): neither serves prefixes
        # a pipelined path serves prefixes when it has a chunk variant
        # (the suffix windows at pos0 = P through it)
        self._prefix_capable = (not self.ring and not self._spec and (
            not self._custom_steps or self._step_fns[3] is not None))
        # --kv-dtype: "int8"/"int4" select the quantized page pools (int8
        # pages or nibble-packed int4 pages + per-page, per-kv-head f32
        # scales); another name is a plain pool dtype, fp8 ("f8_e4m3",
        # "f8_e5m2") included; None keeps cache_dtype. The dense flavors
        # keep cache_dtype, as JAX's do
        self._quant_cache = QUANTIZED_CACHES.get(kv_dtype)
        self.kv_quant = self._quant_cache is not None
        # the --kv-dtype name and the cache dtype an unset one follows:
        # what current_config reports and a live switch resolves against
        self._kv_dtype_name = kv_dtype
        self._base_cache_dtype = cache_dtype
        self._kv_host_pages = kv_host_pages
        self._max_queue = max_queue
        self._pool_dtype = (resolve_kv_dtype(kv_dtype)
                            if self.paged and kv_dtype is not None
                            and not self.kv_quant else cache_dtype)
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
        # the paged speculative plane (spec/, --spec-draft) and the dense
        # spec engine's draft (--draft-model behind --api)
        self._specp: Optional[SpecPlane] = None
        self.d_cache = None
        self.draft_params = draft_params
        self.draft_config = draft_config
        self.spec_gamma = spec_gamma
        if self.paged:
            self._pager: Optional[PageAllocator] = PageAllocator(
                kv_pages, kv_page_size)
            self.cache = self._new_cache(kv_pages, kv_page_size)
            log.info("paged KV: %d pages x %d tokens, %s attention, %s "
                     "storage (%.2f GiB pool) on %s", kv_pages,
                     kv_page_size, impl,
                     kv_dtype + "+scales" if self.kv_quant
                     else self._pool_dtype,
                     self.cache.memory_bytes() / 2**30, self.device)
        else:
            self._pager = None
            if self._custom_steps:
                # the caller's placement, kept (not its tensors) for a
                # rebuild after an error
                self.cache = cache
                self._cache_placement = cache.placement()
            else:
                self.cache = self._new_dense_cache(config)
            log.info("%s KV cache: %d slots x %d positions, %s (%.2f GiB) "
                     "on %s", "ring" if self.ring else "dense", max_slots,
                     self.cache.max_seq_len, cache_dtype,
                     self.cache.memory_bytes() / 2**30, self.device)
        if self._spec:
            self.d_rope = RopeTables.create(draft_config, max_seq_len,
                                            device=self.device)
            self.d_cache = self._new_dense_cache(draft_config)
            self._d_weight_bytes = (params_bytes(draft_params)
                                    - params_bytes(draft_params["embed"]))
            self._d_embed_row_bytes = (params_bytes(draft_params["embed"])
                                       // draft_config.vocab_size)
            log.info("dense spec: draft cache %.2f GiB, gamma=%d",
                     self.d_cache.memory_bytes() / 2**30, spec_gamma)

        # paged speculative decoding: the draft model's KV pages live in
        # a SECOND pool with the target pool's page geometry, addressed
        # by the SAME allocator (one page-id space, one budget for the
        # admission gate), and a sink page of its own
        if spec_draft_params is not None:
            self._specp = SpecPlane(
                spec_draft_params, spec_draft_config, spec_gamma,
                rope=RopeTables.create(spec_draft_config, max_seq_len,
                                       device=self.device),
                tuner=SpecGammaTuner(gamma=spec_gamma))
            self.d_cache = self._new_draft_cache()
            self._d_weight_bytes = (
                params_bytes(spec_draft_params)
                - params_bytes(spec_draft_params["embed"]))
            self._d_embed_row_bytes = (params_bytes(
                spec_draft_params["embed"]) // spec_draft_config.vocab_size)
            log.info("paged spec: draft pool %d pages x %d tokens "
                     "(%.2f GiB), gamma=%d", kv_pages, kv_page_size,
                     self.d_cache.memory_bytes() / 2**30, spec_gamma)

        self._cost_constants()

        # the event bus (obs/events.py): preemption, prefix hits,
        # shedding and graph captures publish request-linked events
        # (GET /api/v1/events; --event-log JSONL). --event-ring 0
        # disables it: self.events is then None and every publish site
        # costs one attribute test
        self.events = (EventBus(capacity=event_ring, log_path=event_log)
                       if event_ring > 0 else None)
        # --kv-host-pages: the host-RAM spill tier behind the page
        # allocator (kv/host_tier.py): preemption victims' own pages,
        # cold shared prefixes' pages and parked decode-resident
        # streams' pages spill to pinned host memory and stream back on
        # demand, instead of being dropped and recomputed
        self._host_tier: Optional[HostTier] = None
        if kv_host_pages is not None:
            self._host_tier = HostTier(
                kv_host_pages,
                page_bytes=page_bytes(
                    config, kv_page_size,
                    kv_dtype if self.kv_quant else self._pool_dtype),
                events=self.events,
                dtype_name=pool_dtype_name(self.cache))
            log.info("kv host tier: %d pages (%.1f MiB capacity)",
                     kv_host_pages,
                     kv_host_pages * self._host_tier.page_bytes / 2**20)
        # cold-prefix spill order: pid -> clock of its latest hit
        self._prefix_last_hit: dict = {}
        # resident spill: the admission stamp counter, this iteration's
        # planned decode rows (slot -> rid, the only candidates), and
        # whether an admission parked one (the plan is then re-validated)
        self._admit_seq = 0
        self._cur_decode: dict = {}
        self._resident_parked = False
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
        # unset: on with the classes, except over a windowed layout, whose
        # recompute fold would re-prefill past the prompt window
        self._preemption = ((self._slo and decode_budget is None)
                            if preemption is None else bool(preemption))
        if self._preemption and not self._slo:
            log.warning("--preemption requires --priority-classes; "
                        "preemption disabled")
            self._preemption = False
        if self._preemption and self._spec:
            log.warning("preemption disabled: speculative serving keeps "
                        "the draft cache aligned with the target per "
                        "round (no recompute-resume path)")
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
        # crash recovery: on a step failure, reset and resubmit the
        # in-flight requests through the recompute fold instead of
        # failing them all. An engine built directly keeps the
        # fail-everything contract unless asked (None = off); the
        # serving entry points pass --recovery, on by default as in JAX
        # (master.make_engine)
        self._recovery_cfg = recovery_config or RecoveryConfig()
        self._recover = bool(recovery)
        if self._recover and self._spec:
            log.warning("crash recovery disabled: speculative serving has "
                        "no recompute-resume fold")
            self._recover = False
        # the reset-storm breaker's window (monotonic reset times), the
        # consecutive resets (backoff), and each recovery's seconds
        self._reset_times: List[float] = []
        self._consec_resets = 0
        self.recovery_seconds: List[float] = []
        self._breaker_tripped = False
        # deterministic fault injection (faults/): None without a plan,
        # and every site is then one attribute test
        self._faults = build_injector(fault_plan)
        if self._faults is not None:
            self._faults.events = self.events
            log.warning("fault plan armed: %s",
                        self._faults.plan.describe())
        # the rows of the dispatch in flight: the blast radius recovery
        # implicates (set at each dispatch, cleared after a clean
        # iteration)
        self._implicated: Sequence = ()
        # --journal: the write-ahead request journal (serve/journal.py),
        # replayed at a cold restart; None without the flag
        self._journal = None
        if journal:
            from cake_tpu_torch.serve.journal import RequestJournal
            self._journal = RequestJournal(journal, fsync=journal_fsync)
            self._journal.faults = self._faults
            self._journal.owner = self
            log.info("request journal armed: %s (fsync=%s)", journal,
                     journal_fsync)
        # idempotent submits: key -> live rid, and a bounded ring of
        # finished keyed requests (a retry after retirement attaches to
        # the transcript); both under _rid_lock
        self._idem_live: dict = {}
        self._idem_done: "OrderedDict" = OrderedDict()
        self._idem_done_cap = 128
        # drain (POST /api/v1/drain, SIGTERM): new submits refuse while
        # in-flight work finishes
        self._draining = False
        # the checkpoint: api.start arms snapshot_path (the pre-fail
        # snapshot); _ckpt_lock serializes the pre-fail and shutdown
        # writes; _fail_recs is the last failure's request capture
        self.snapshot_path: Optional[str] = None
        self._ckpt_lock = threading.Lock()
        self._fail_recs = None
        self._prefail_written = False
        # how long a failure's request capture may serve a later fatal
        # declaration (cli sets it past --heartbeat-timeout: the
        # heartbeat monitor is the late arrival)
        self.fail_recs_ttl = _FAIL_RECS_TTL_S
        # multi-process serving: the coordinator's ControlServer
        # (attach_control), the follower's last applied op seq
        # (run_follower_loop; its telemetry frames report it)
        self._control = None
        self._multihost = False
        self.applied_op_seq = 0
        # submit's critical section: an idempotency key's re-check and
        # its registration land together
        self._admit_lock = threading.Lock()
        # request-lifecycle traces (obs/tracing.py), always on: spans at
        # the submit, admission, first-token, emit, preemption, requeue
        # and retire seams; --trace-events appends them as JSONL
        self.tracer = RequestTracer(capacity=trace_ring,
                                    events_path=trace_events,
                                    slo=self.slo)
        # events published with a rid carry the request's x-cake-trace
        if self.events is not None:
            self.events.trace_of = self.tracer.trace_for
        self._step_stats = StepStats(name="engine", window=100)
        # the step flight recorder (obs/steps.py), always on: one record
        # per device step at the step seams, GET /api/v1/steps and
        # --step-log; MFU and HBM utilization against this card's peaks
        self.flight = obs_steps.StepTelemetry(
            impl=self._flavor(), capacity=step_ring, log_path=step_log,
            kind=obs_steps.device_kind(self.device), events=self.events)
        # the anomaly sentinel (--sentinel, obs/sentinel.py): rolling-
        # window detectors over the flight recorder, the event bus and
        # the SLO accountant, ticked from a daemon thread between start()
        # and stop(); it reads host numbers only. None without the flag
        self.sentinel = None
        if sentinel:
            from cake_tpu_torch.obs.sentinel import attach_engine_sentinel
            self.sentinel = attach_engine_sentinel(
                self, interval_s=sentinel_interval)
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
        self._setup_control_plane(autotune, autotune_policy,
                                  autotune_config, sentinel_act,
                                  postmortem_dir)
        # the fleet collector (obs/federation.TelemetryCollector), set by
        # the API server: request_timeline merges its remote events
        self.telemetry = None
        self._setup_disagg(disagg, disagg_peer, disagg_token,
                           disagg_timeout_s)

    def _setup_disagg(self, role: Optional[str], peer: Optional[str],
                      token: Optional[str], timeout_s: float) -> None:
        """Disaggregated prefill/decode (--disagg, kv/transfer.py): one
        engine runs prefill only and ships pool pages; the other is the
        front door and adopts shipped prefills into its own pool.
        _adopt_store stages reassembled shipments (channel thread ->
        engine thread) by rid; it exists without the plane too, so the
        adoption peeks stay branch-free."""
        import os

        self._adopt_store: dict = {}
        self._disagg = None
        if role is None:
            return
        if not peer:
            raise ValueError(
                "--disagg requires --disagg-peer host:port (the "
                "prefill engine binds it; the decode engine "
                "connects to it)")
        from cake_tpu_torch.kv.transfer import build_disagg_plane
        self._disagg = build_disagg_plane(
            self, role, peer, token or os.environ.get(
                "CAKE_DISAGG_TOKEN", ""),
            events=self.events, timeout_s=timeout_s,
            pin=self.device.type == "cuda")
        log.info("disagg: %s role, peer %s", role, peer)

    def _setup_control_plane(self, autotune, autotune_policy,
                             autotune_config, sentinel_act: bool,
                             postmortem_dir: Optional[str]) -> None:
        """Live reconfiguration (--autotune off | manual | auto), the
        action plane (--sentinel-act) and the postmortem sink
        (--postmortem-dir), as the JAX engine's constructor wires them.
        `manual` arms POST /api/v1/autotune; `auto` also runs the policy
        controller from the engine loop (_autotune_tick). The switch seam
        (reconfigure) exists whatever the mode: tests drive it directly."""
        self.config_epoch = 0
        # guards the in-flight flag only; the switch itself runs under
        # _admit_lock, the lock submit() registers under
        self._switch_lock = threading.Lock()
        self._switch_inflight = False
        self._switch_log: deque = deque(maxlen=64)
        mode = autotune or "off"
        if mode not in ("off", "manual", "auto"):
            raise ValueError(
                f"--autotune must be off, manual or auto, got {mode!r}")
        if mode != "off" and not self._reconfig_supported():
            log.warning("--autotune disabled: %s", self._reconfig_refusal())
            mode = "off"
        self.autotune_mode = mode
        if mode != "off":
            # the startup config through the info gauge: the "live
            # effective config" holds before (and without) any switch
            from cake_tpu_torch.autotune import set_config_info
            set_config_info(self.current_config())
        self._autotuner = None
        self._autotune_last = 0.0
        # (t, submitted, completed, tokens, shed) for the signal deltas
        self._autotune_prev: Optional[tuple] = None
        if mode == "auto":
            from cake_tpu_torch.autotune import (
                AutotuneController, ControllerConfig, PolicyTable,
            )
            if autotune_policy is None:
                raise ValueError(
                    "--autotune auto requires --autotune-policy (fit one "
                    "with python -m cake_tpu_torch.tools.autotune_fit)")
            if isinstance(autotune_policy, str):
                policy = PolicyTable.load(autotune_policy)
            elif isinstance(autotune_policy, dict):
                policy = PolicyTable.from_dict(autotune_policy).validate()
            else:
                policy = autotune_policy
            policy.validate(max_seq_len=self.max_seq_len)
            self._autotuner = tuner = AutotuneController(
                policy, self.current_config(),
                config=autotune_config or ControllerConfig())
            log.info("autotune: auto mode, %d policy regime(s), interval "
                     "%.1fs", len(policy.regimes), tuner.config.interval_s)
        # the action plane (--sentinel-act): sentinel anomalies become
        # autotune signals with a typed, rate-bounded audit trail
        self._actions = None
        if sentinel_act:
            if self.sentinel is None:
                raise ValueError(
                    "--sentinel-act requires --sentinel (nothing to act on "
                    "without the anomaly sentinel)")
            from cake_tpu_torch.obs.actions import (
                ActionPlane, EngineAnomalyActuator,
            )
            self._actions = ActionPlane(events=self.events)
            EngineAnomalyActuator(self, self._actions).attach(self.sentinel)
        # the black-box postmortem sink (--postmortem-dir): breaker and
        # failed-rebuild stops, poison quarantines and SIGTERM dump one
        # bundle each (tools/postmortem.py renders them)
        self._postmortem = None
        if postmortem_dir:
            from cake_tpu_torch.obs.actions import PostmortemSink
            self._postmortem = PostmortemSink(postmortem_dir)

    def _flavor(self) -> str:
        """The flight record's impl name, JAX's: "spec", "paged-<impl>",
        "ring" or "dense"."""
        return ("spec" if self._spec else
                f"paged-{self.paged_attn}" if self.paged else
                "ring" if self.ring else "dense")

    def _check_attn(self, impl: str) -> str:
        """A resolved attention impl the engine's device can run."""
        if impl == "kernel" and self.device.type != "cuda":
            raise ValueError("--paged-attn kernel needs a CUDA device: the "
                             "ragged paged-attention kernels run only on "
                             "the card")
        return impl

    def _cost_constants(self) -> None:
        """The step cost's constants (obs/steps.step_cost), recomputed
        after a live switch: the weights a forward pass reads at their
        stored size, the embedding left out (a pass gathers one row a
        token of it), and the pool's bytes a token (scales and the sink
        page's share included)."""
        self._weight_bytes = (params_bytes(self.params)
                              - params_bytes(self.params["embed"]))
        self._embed_row_bytes = (params_bytes(self.params["embed"])
                                 // self.config.vocab_size)
        if self.paged:
            self._kv_bytes_per_token = self.cache.memory_bytes() / (
                (self.cache.n_pages + 1) * self.cache.page_size)
        else:
            self._kv_bytes_per_token = self.cache.memory_bytes() / (
                self.max_slots * self.cache.max_seq_len)

    def _seed_values(self) -> torch.Tensor:
        """Slot b's stream seed (host): the reset count folds in, so the
        streams after a reset never replay consumed draws."""
        base = self._seed * 1_000_003 + self._reset_count * 65_537
        return torch.tensor([base + b for b in range(self.max_slots)],
                            dtype=torch.int64)

    def _fresh_sampling_state(self) -> None:
        """The device state of the rows' sampling, updated in place from
        here on (a recovery resets it where it is,
        `_reset_device_in_place`): the repeat-penalty rings, and one
        random stream per slot (a seed and a counter), so a row's draws
        are independent of the other rows. The runners hold these
        tensors, so a new set drops them."""
        B, dev = self.max_slots, self.device
        self._ring = torch.full((B, self.defaults.repeat_last_n), -1,
                                dtype=torch.int64, device=dev)
        self._seeds = self._seed_values().to(dev)
        self._counters = torch.zeros(B, dtype=torch.int64, device=dev)
        self._runner: Optional[DecodeRunner] = None
        self._mixed_runner: Optional[MixedRunner] = None
        self._prefill_runner: Optional[PrefillRunner] = None
        # the speculative round and the draft prefill (spec engines)
        self._spec_runner: Optional[SpecRunner] = None
        self._draft_prefill_runner: Optional[PrefillRunner] = None
        # the runners' graphs share one memory pool on the card
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
            from cake_tpu_torch.utils.profiling import log_memory
            log_memory("engine start")
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="cake-engine")
            self._thread.start()
            if self.sentinel is not None:
                self.sentinel.start()
            if self._disagg is not None:
                self._disagg.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        if self.sentinel is not None:
            self.sentinel.close()
        if self._disagg is not None:
            # first: a decode plane degrades its in-flight shipments to
            # local prefill while the engine thread can still run them
            self._disagg.stop()
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        # cakelint: skip[affinity] engine thread joined above: inline teardown is single-threaded; the runtime assert checks liveness
        self._drain_cancellations()
        self._fail_pending_commands()
        # flush and fsync the optional JSONL logs (a later start reopens
        # them on the next append)
        self.tracer.close()
        self.flight.close()
        if self.events is not None:
            self.events.close()
        if self._journal is not None:
            # flush buffered emits and fsync: a clean stop's journal is
            # durable (shutdown_save may then truncate it)
            self._journal.close()
        if self._control is not None:
            # published only after the engine thread has exited, so no
            # step op can be ordered after the stop on the wire
            try:
                self._control.publish({"op": "stop"})
            except Exception:  # noqa: BLE001
                log.warning("control: stop publish failed (followers "
                            "will exit on channel close)")

    # -- multi-process serving --------------------------------------------------

    def attach_control(self, control) -> None:
        """Coordinator side of multi-process serving: publish every
        device step through `control` (a serve.control.ControlServer)
        before dispatching it, so every follower process runs the same
        step and its hops meet. Must be called before start()."""
        if not self._custom_steps or self.paged:
            raise ValueError(
                "multi-host control requires pipelined step fns (a mesh "
                "spanning processes); the single-device engine (incl. "
                "--kv-pages) has no cross-process computation to "
                "coordinate")
        if self._prefixes:
            raise ValueError(
                "multi-host control cannot be attached after prefix "
                "registrations (registrations are not replayed)")
        self._control = control
        # a --fault-plan with control.publish rules fires inside the
        # channel itself, so the failure shape (publish raises) is the
        # one a dead follower produces
        if self._faults is not None:
            control.faults = self._faults
        self._multihost = True

    def run_follower_loop(self, client, reset_wait_s: float = 120.0,
                          op_timeout_s: Optional[float] = None,
                          liveness=None) -> None:
        """Non-coordinator side: replay the coordinator's op stream.
        Blocks until the coordinator publishes a stop or closes the
        channel. The engine thread never starts here: this process only
        runs the device steps (its stages, its hops) in the
        coordinator's order.

        After a failed op this process is out of step. A failure on
        every process is recovered by the coordinator's reset op; if no
        reset arrives within reset_wait_s the failure was this
        process's alone, and the only safe move is to disconnect (the
        coordinator's next publish or hop then fails instead of
        waiting forever).

        op_timeout_s / liveness: a coordinator that dies between ops
        (no FIN) would hang recv() forever; with op_timeout_s set each
        quiet interval re-checks liveness() (the heartbeat channel:
        the monitor lives in the coordinator's process) and exits when
        it is gone. An idle but live coordinator keeps the loop
        waiting."""
        import socket as _socket
        from types import SimpleNamespace

        self._multihost = True
        log.info("engine follower: replaying coordinator ops")
        failed = False
        while True:
            try:
                op = client.recv(
                    timeout=reset_wait_s if failed else op_timeout_s)
            except (_socket.timeout, TimeoutError):
                if not failed:
                    if liveness is not None and liveness():
                        continue    # quiet but provably alive: keep on
                    log.error(
                        "engine follower: no op for %.0fs and the "
                        "coordinator shows no liveness; exiting "
                        "instead of hanging the process", op_timeout_s)
                    return
                log.error("engine follower: op failed and no reset came "
                          "within %.0fs; disconnecting", reset_wait_s)
                return
            if op is None or op.get("op") == "stop":
                if op is not None and isinstance(op.get("seq"), int):
                    # count the stop as applied: a drained follower
                    # must report zero lag, not one phantom op
                    self.applied_op_seq = op["seq"]
                log.info("engine follower: coordinator %s",
                         "stopped" if op else "closed the channel")
                return
            if failed and op.get("op") != "reset":
                log.error("engine follower: op %r after a local failure "
                          "(no reset) — out of sync; disconnecting",
                          op.get("op"))
                return
            try:
                kind = op["op"]
                with torch.inference_mode():
                    if kind in ("prefill", "prefill_prefixed"):
                        req = SimpleNamespace(temperature=op["temp"],
                                              top_p=op["top_p"],
                                              repeat_penalty=op["penalty"])
                        if kind == "prefill":
                            self._prefill_device(
                                op["ids"], op["slot"], req,
                                op.get("n_top", 0), op.get("prime", ()))
                        else:
                            with self._rid_lock:
                                entry = self._prefixes[op["pid"]]
                            self._prefixed_prefill_device(
                                op["ids"], op["slot"], req, entry,
                                op.get("n_top", 0), op.get("prime", ()))
                    elif kind in ("decode", "decode_scan"):
                        carry = op.get("carry")
                        if carry is not None:
                            self._last_tok[:] = carry["tok"]
                            self._pos[:] = carry["pos"]
                            self._steps[:] = carry["steps"]
                            self._temp[:] = carry["temp"]
                            self._top_p[:] = carry["top_p"]
                            self._penalty[:] = carry["penalty"]
                        self._dispatch_scan(
                            op["rows"], op["n"], op.get("n_top", 0),
                            np.asarray(op["budget"], np.int64),
                            fresh=carry is not None)
                    elif kind == "register_prefix":
                        ids = list(op["ids"])
                        P = len(ids)
                        kv = self._prefix_kv_device(
                            ids, P, bucket_length(P, self.max_seq_len))
                        with self._rid_lock:
                            self._prefixes[op["pid"]] = (ids, kv)
                            self._next_prefix_id = max(
                                self._next_prefix_id, op["pid"] + 1)
                    elif kind == "unregister_prefix":
                        with self._rid_lock:
                            self._prefixes.pop(op["pid"], None)
                    elif kind == "reset":
                        self._reset_after_error()
                    else:
                        log.error("engine follower: unknown op %r", kind)
                failed = False
                if isinstance(op.get("seq"), int):
                    # applied (not merely received): telemetry frames
                    # report this, and lag vs the published seq is the
                    # fleet view's behind-ness signal
                    self.applied_op_seq = op["seq"]
            except Exception:  # noqa: BLE001
                log.exception("follower op failed (awaiting reset)")
                failed = True

    def _publish(self, op: dict) -> None:
        if self._control is not None:
            self._control.publish(op)

    @property
    def stopped(self) -> bool:
        """The engine serves no more: stopped, or its loop ended (a
        storm-breaker or failed-rebuild stop)."""
        return self._stop.is_set()

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
        prime_penalty_tokens: Optional[Sequence[int]] = None,
        idempotency_key: Optional[str] = None,
        replay_tokens: Optional[Sequence[int]] = None,
        ship_sink: Optional[Callable] = None,
        trace_id: Optional[str] = None,
    ) -> RequestHandle:
        """Queue one generation. stream(text_delta, is_final) is called
        from the engine thread as tokens finalize; a callback with
        attribute `wants_count = True` instead gets (text_delta,
        is_final, n_done). The handle's wait()/text() is the blocking
        interface. priority: the request's class (interactive |
        standard | batch; None = standard; an unknown one raises
        ValueError); it orders admission under priority_classes and
        labels the TTFT histogram always. Raises ShedError (shedding),
        QueueFullError (each with a Retry-After), DrainingError while
        draining, EngineResetError once stopped.

        prime_penalty_tokens: tokens generated before a resume, which
        seed the penalty ring. idempotency_key: a submit whose key names
        a live or finished request attaches to it (the handle's
        `attached` is True) instead of admitting again. replay_tokens:
        the suffix of prompt_ids that earlier process generations
        generated (a checkpoint or journal resume), which counts in the
        request's absolute stream position. ship_sink (the disagg prefill
        plane): called from the engine thread at retirement with the
        captured page shipment (None when the capture failed). trace_id:
        the originating x-cake-trace, the key a router's federated
        timeline finds this request's trace and events under."""
        if self._stop.is_set():
            raise EngineResetError("engine stopped")
        if idempotency_key is not None:
            # before validation: the key names an existing stream, which
            # its admission validated
            prev = self._attach_idempotent(idempotency_key, stream)
            if prev is not None:
                return prev
        cls = validate_priority(priority)
        ids = list(prompt_ids)
        if not ids:
            raise ValueError("empty prompt")
        if len(ids) >= self.max_seq_len:
            raise ValueError(
                f"prompt length {len(ids)} exceeds max_seq_len "
                f"{self.max_seq_len}")
        if self.prompt_limit is not None and len(ids) > self.prompt_limit:
            raise ValueError(
                f"prompt length {len(ids)} exceeds this serving mode's "
                f"prompt window {self.prompt_limit}")
        max_new = min(max_new_tokens, self.max_seq_len - len(ids))
        if self.decode_budget is not None:
            # a windowed layout caps generation by its tail, not by
            # max_seq_len - prompt
            max_new = min(max_new, self.decode_budget)
        if self.paged:
            with self._admit_lock:
                # a live reconfigure swaps the pager wholesale under
                # this lock: it pins one consistent pool for the bound
                need = self._pager.pages_for(len(ids) + max_new)
                n_pages = self._pager.n_pages
            if need > n_pages:
                # can NEVER be admitted: fail fast instead of requeueing
                raise ValueError(
                    f"request needs {need} kv pages; the pool has "
                    f"{n_pages} total (raise --kv-pages or "
                    "lower max_tokens)")
        d = self.defaults
        if self._spec:
            # the accept/resample identity assumes the unfiltered
            # temperature softmax, and the verify pass scores the burst
            # in parallel (no within-burst penalty ring)
            eff_top_p = top_p if top_p is not None else d.top_p
            eff_pen = (d.repeat_penalty if repeat_penalty is None
                       else repeat_penalty)
            if (eff_top_p or 1.0) < 1.0 or eff_pen != 1.0:
                raise ValueError(
                    "speculative serving supports temperature-only "
                    "sampling (top_p=1, repeat_penalty=1)")
            if want_top_logprobs:
                raise ValueError(
                    "logprobs are unavailable in speculative serving "
                    "(accepted drafts are not sampled step-by-step)")
        replayed = list(replay_tokens or ())
        if replayed and ids[-len(replayed):] != replayed:
            # the replay coordinate must be a literal suffix of the
            # folded prompt, or SSE event ids would be wrong
            raise ValueError(
                "replay_tokens must be the folded suffix of prompt_ids")
        with self._rid_lock:
            rid = self._next_rid
            self._next_rid += 1
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
            prime_tokens=list(prime_penalty_tokens or ()),
            idempotency_key=idempotency_key,
            replayed_tokens=replayed,
            ship_sink=ship_sink,
        )
        with self._admit_lock:
            return self._admit(req, cls, replay_tokens is not None,
                               want_top_logprobs, trace_id=trace_id)

    def _admit(self, req: _Request, cls: str, replay: bool,
               want_top: bool = False,
               trace_id: Optional[str] = None) -> RequestHandle:
        """submit's critical section (under _admit_lock): the key's
        re-check, the drain and shed refusals, the journal's admit
        record, then the registration and the scheduler (or, on a
        disagg decode engine, the prefill peer)."""
        rid = req.rid
        key = req.idempotency_key
        if key is not None:
            # two concurrent first submits of one key serialize here:
            # the second attaches to the first
            prev = self._attach_idempotent(key, req.stream)
            if prev is not None:
                return prev
        if self.paged:
            need = self._pager.pages_for(len(req.prompt_ids)
                                         + req.max_new_tokens)
            if need > self._pager.n_pages:
                # submit() checked the pool it saw; a live switch to a
                # smaller pool may have landed since (this lock is the
                # one the switch holds)
                raise ValueError(
                    f"request needs {need} kv pages; the pool has "
                    f"{self._pager.n_pages} total (raise --kv-pages or "
                    "lower max_tokens)")
        if self._draining and not replay:
            # admissions are closed; a resume's resubmits still land
            raise DrainingError(self._drain_eta_s())
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
        if self._journal is not None:
            # write-ahead: the admit record lands before the engine
            # thread can see the request (a refusal below tombstones it)
            self._journal.note_admit(req, self.config_epoch)
        # register (and trace) BEFORE scheduler.submit: the engine
        # thread may plan the rid immediately, and an unknown rid counts
        # as cancelled
        n_ids, max_new = len(req.prompt_ids), req.max_new_tokens
        self._requests[rid] = req
        # config_epoch attributes the trace to the engine config that
        # admitted it (a live switch bumps the epoch)
        self.tracer.admit(rid, n_ids, max_new, priority=cls,
                          config_epoch=self.config_epoch, trace=trace_id)
        if (self._disagg is not None and self._disagg.role == "decode"
                and not replay and not want_top
                and self._disagg.request_prefill(req)):
            # the disaggregated front door: the admission is held OUT of
            # the scheduler while the prefill peer computes its pages;
            # disagg_complete enters it (with the shipment to adopt, or
            # without one after any channel failure). Replays and
            # top-logprob requests stay local: a replay suffix already
            # holds generated tokens, and the shipped first token carries
            # no top-N alternatives. request_prefill False means the
            # channel is down: the local path, as colocated
            req._disagg_pending = True
            ok = True
        else:
            ok = (self.scheduler.submit(rid, n_ids, max_new, priority=cls)
                  if self._slo else
                  self.scheduler.submit(rid, n_ids, max_new))
        if not ok:
            self._requests.pop(rid, None)
            self.tracer.drop(rid)
            if self._journal is not None:
                self._journal.note_retire(rid, "cancelled")
            retry = 1.0
            if self._shed is not None:
                retry = self._shed.estimate_retry_after(
                    cls, self.scheduler.queue_depth)
            raise QueueFullError(retry_after=retry)
        if key is not None:
            with self._rid_lock:
                self._idem_live[key] = rid
        self._set_queue_gauges()
        self._wake.set()
        return RequestHandle(req, self.tokenizer, self.config.eos_token_ids)

    # -- disaggregated serving (kv/transfer.py) ---------------------------------

    def disagg_complete(self, rid: int, shipment) -> None:
        """Decode plane's channel thread: the peer's answer for a
        deferred admission arrived, a reassembled Shipment to adopt or
        None (peer down / timeout / refused / corrupt), which means
        whole-prompt prefill here. Either way the request NOW enters the
        scheduler; the adoption itself happens on the engine thread when
        _do_prefill / _mixed_admit reach the rid. Under _admit_lock, the
        lock submit registers under and a live switch holds."""
        with self._admit_lock:
            req = self._requests.get(rid)
            if req is None or not req._disagg_pending:
                return   # cancelled / failed while the shipment flew
            req._disagg_pending = False
            if shipment is not None:
                with self._rid_lock:
                    self._adopt_store[rid] = shipment
            ids, max_new = req.prompt_ids, req.max_new_tokens
            ok = (self.scheduler.submit(rid, len(ids), max_new,
                                        priority=req.priority)
                  if self._slo else
                  self.scheduler.submit(rid, len(ids), max_new))
            if not ok:
                # submit's refusal, late: the deferred admission was
                # already registered and journaled, so the handle
                # finishes with the retryable error a synchronous
                # refusal raises
                self._requests.pop(rid, None)
                with self._rid_lock:
                    self._adopt_store.pop(rid, None)
                self.tracer.drop(rid)
                if self._journal is not None:
                    self._journal.note_retire(rid, "cancelled")
                req.error = QueueFullError(retry_after=1.0)
                req.done.set()
                return
        self._set_queue_gauges()
        self._wake.set()

    # -- durable serving: idempotency, drain, journal seams ---------------------

    def _attach_idempotent(self, key: str,
                           stream=None) -> Optional[RequestHandle]:
        """A submit whose idempotency key matches a live or finished
        request attaches to that stream (a safe client retry, across
        reconnects and, with the journal, restarts). The new callback
        replaces the gone client's; tokens the swap races are covered by
        the reconnect's replay (the API dedupes by absolute event id).
        None: no match (admit normally)."""
        with self._rid_lock:
            rid = self._idem_live.get(key)
            req = self._requests.get(rid) if rid is not None else None
            if req is None:
                req = self._idem_done.get(key)
            if req is None:
                return None
        if not req.done.is_set() and stream is not None:
            req.stream = stream
            req.stream_wants_count = bool(
                getattr(stream, "wants_count", False))
        h = RequestHandle(req, self.tokenizer, self.config.eos_token_ids)
        h.attached = True
        return h

    def seed_finished_idempotent(self, rec: dict) -> None:
        """Journal replay (serve/journal.recover): a request that
        completed before the crash, whose client may still retry: its
        finished state goes into the idempotency registry, so the retry
        attaches to the transcript. Errored and cancelled records are
        not seeded (a fresh retry is right for those)."""
        key = rec.get("idempotency_key")
        if not key or rec.get("error") \
                or rec.get("status") == "cancelled":
            return
        out = list(rec.get("out_tokens") or ())
        req = _Request(
            rid=int(rec.get("rid") or 0),
            prompt_ids=list(rec.get("prompt_ids") or ()),
            max_new_tokens=int(rec.get("max_new")
                               or rec.get("remaining") or 0),
            temperature=rec.get("temperature", 0.0),
            top_p=rec.get("top_p", 1.0),
            repeat_penalty=rec.get("repeat_penalty", 1.0),
            stream=None,
            priority=rec.get("priority", "standard"),
            idempotency_key=key,
            replayed_tokens=list(rec.get("replayed") or ()),
        )
        req.out_tokens = out
        # the journal stores no logprobs: a replayed transcript serves
        # text and ids only
        req.out_logprobs = [0.0] * len(out)
        req.out_top = [[] for _ in out]
        req.done.set()
        with self._rid_lock:
            self._idem_done[key] = req
            while len(self._idem_done) > self._idem_done_cap:
                self._idem_done.popitem(last=False)

    def _journal_retire(self, req: _Request, status: str,
                        error: Optional[str] = None) -> None:
        """The terminal side channel of every retire seam (emit finish,
        recovered finish, drop, fail-all, cancel, a refused requeue):
        the journal's tombstone, and the idempotency registry's move (a
        completed keyed request stays attachable in the done ring; a
        failed or cancelled one frees its key, so a retry runs again)."""
        if self._journal is not None:
            self._journal.note_retire(req.rid, status, error=error)
        key = req.idempotency_key
        if key is None:
            return
        with self._rid_lock:
            if self._idem_live.get(key) == req.rid:
                del self._idem_live[key]
            if status == "retired":
                self._idem_done[key] = req
                while len(self._idem_done) > self._idem_done_cap:
                    self._idem_done.popitem(last=False)

    def begin_drain(self) -> dict:
        """Close admissions (new submits raise DrainingError, which the
        API maps to 429 with the computed Retry-After) while in-flight
        work keeps decoding. POST /api/v1/drain and SIGTERM call this."""
        if not self._draining:
            log.info("drain: admissions closed (%d in flight)",
                     len(self._requests))
        self._draining = True
        self._wake.set()
        return self.drain_state()

    def _drain_eta_s(self) -> float:
        """Computed seconds until the drain completes: the remaining
        budgeted tokens over the measured decode rate (at most 600 s,
        at least 1 s, the API's Retry-After floor)."""
        remaining = sum(max(0, r.max_new_tokens - len(r.out_tokens))
                        for r in list(self._requests.values())
                        if not r.done.is_set())
        if remaining == 0:
            return 1.0
        rate = self.stats.decode_tokens_per_s
        if rate > 0:
            return min(600.0, max(1.0, remaining / rate))
        return min(600.0, max(1.0, remaining / 8.0))

    def drain_state(self) -> dict:
        """/api/v1/health's `draining` block, and the drain response."""
        pending = sum(1 for r in list(self._requests.values())
                      if not r.done.is_set())
        out = {"draining": self._draining,
               "pending_requests": pending,
               "queue_depth": self.queue_depth}
        if self._draining:
            out["eta_s"] = round(self._drain_eta_s(), 3)
        return out

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
                and self._prefix_capable
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
            min_len = 8
            if self.paged:
                with self._admit_lock:
                    min_len = max(min_len, self._pager.page_size)
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
            # cakelint: skip[affinity] shutdown window: the engine thread has exited (checked above); runtime assert backstops
            self._drain_cancellations()

    @engine_thread_only
    def _drain_cancellations(self) -> None:
        with self._rid_lock:
            rids, self._cancel_q = self._cancel_q, []
        for rid in rids:
            req = self._requests.pop(rid, None)
            if req is None:
                continue
            self.scheduler.cancel(rid)
            with self._rid_lock:
                # a shipment staged for a cancelled admission must not
                # outlive it in the adoption store
                self._adopt_store.pop(rid, None)
            if self._host_tier is not None:
                # a victim cancelled while parked leaves its spilled
                # pages orphaned in the LRU: drop them now
                self._host_tier.drop(("victim", rid))
            if req.slot >= 0 and self._slot_req[req.slot] is req:
                self._slot_req[req.slot] = None
                self._release_slot_pages(req.slot)
            req.finish_t = time.perf_counter()
            self._journal_retire(req, "cancelled")
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
        if not self._prefix_capable:
            # name the flavor's actual refusal, as JAX does
            if self._spec:
                reason = ("speculative serving keeps the draft cache "
                          "aligned with the target, and a prefix-cached "
                          "target prefill would leave the draft cold "
                          "(acceptance would silently collapse)")
            elif self.ring:
                reason = ("ring sliding-window caches own their layout "
                          "(a prefix install writes dense positions the "
                          "ring would misplace)")
            else:
                reason = ("these custom step fns provide no "
                          "chunked-prefill variant to window the suffix "
                          "at the prefix boundary")
            raise ValueError(f"prefix caching is unavailable here: {reason}")
        ids = list(prefix_ids)
        if not ids:
            raise ValueError("empty prefix")
        if len(ids) >= self.max_seq_len - 1:
            raise ValueError(
                f"prefix length {len(ids)} leaves no room for a suffix "
                f"(max_seq_len {self.max_seq_len})")
        if not self.paged:
            fn = (lambda: self._register_prefix_sync(ids))
        else:
            with self._admit_lock:
                # a live reconfigure swaps the pager wholesale; the lock
                # pins one consistent page size for this validation
                # (submit's pool-bound discipline)
                P = self._pager.page_size
            if len(ids) < P:
                raise ValueError(
                    f"paged prefix sharing is page-granular: the prefix "
                    f"({len(ids)} tokens) is shorter than one kv page "
                    f"({P} tokens), so there is nothing to share "
                    "(lower --kv-page-size or skip registration)")
            # cakelint: skip[affinity] routed through _run_on_engine_thread below while the engine thread is alive, inline only as a pre-start direct drive; the runtime assert enforces this
            fn = (lambda: self._register_prefix_paged(ids))
        # the device work runs on the engine thread when it is running
        # (the cache and the table have one writer)
        if self._thread is not None and self._thread.is_alive():
            return self._run_on_engine_thread(fn)
        return fn()

    def _register_prefix_sync(self, ids: List[int]) -> int:
        """The dense registration: compute the prefix's KV once, into a
        one-slot scratch cache of its bucket (`_prefix_kv_device`), and
        keep its first P positions [L, 1, P, KV, hd] in the registry,
        outside the serving cache (a reset or a switch to another dense
        config keeps them, as JAX's registry does)."""
        P = len(ids)
        bucket = bucket_length(P, self.max_seq_len)
        with self._rid_lock:
            pid = self._next_prefix_id
            self._next_prefix_id += 1
        self._publish({"op": "register_prefix", "pid": pid,
                       "ids": list(ids)})
        kv = self._prefix_kv_device(ids, P, bucket)
        with self._rid_lock:
            self._prefixes[pid] = (list(ids), kv)
        log.info("registered prefix %d: %d tokens", pid, P)
        return pid

    def _prefix_kv_device(self, ids: List[int], P: int, bucket: int):
        """A prefix's KV: the whole-prompt prefill of its bucket into a
        one-slot cache of that length (flash on the card, as every
        fresh prefill), its first P positions kept. Eager: JAX compiles
        it once a bucket, at registration time only."""
        padded = list(ids) + [0] * (bucket - P)
        plen = to_device(torch.tensor([P], dtype=torch.int32), self.device)
        if self._custom_steps:
            # slot 0 of a one-slot cache of the serving cache's
            # placement, through the pipelined prefill: the prefix's
            # lines stay sharded as the install target is
            tmp = zeros_placed(self._cache_placement, batch=1, length=bucket)
            with torch.inference_mode():
                self._step_fns[0](self.params, self._tokens(padded), plen,
                                  0, tmp, self.rope, self.config)
            return prefix_lines(tmp, P)
        tmp = KVCache.create(self.config, 1, bucket,
                             dtype=self.cache.k.dtype, device=self.device)
        prefill(self.params, self._tokens(padded), plen, tmp, self.rope,
                self.config)
        return (tmp.k[:, :, :P].contiguous(), tmp.v[:, :, :P].contiguous())

    @engine_thread_only
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
        self._prefix_last_hit[pid] = time.monotonic()
        row = torch.full((self.cache.max_pages,), -1, dtype=torch.int32)
        row[:n_pp] = torch.tensor(pages, dtype=torch.int32)
        try:
            self.cache = prefill_prefix_pages(
                self.params, self._tokens(p_ids), to_device(row, self.device),
                self.cache, self.rope, self.config, attn=self.paged_attn,
                row=pages)
        except Exception:
            self._pager.release(pages)
            self._prefix_last_hit.pop(pid, None)
            raise
        with self._rid_lock:
            # (token ids, pool pages): pages None while the prefix is
            # spilled to the host tier, under the key ("prefix", pid)
            self._prefixes[pid] = (p_ids, pages)
        log.info("registered paged prefix %d: %d tokens in %d shared "
                 "pages (%d trailing tokens fall to each suffix)",
                 pid, aligned, n_pp, len(ids) - aligned)
        return pid

    def unregister_prefix(self, prefix_id: int) -> None:
        """Drop a registration: the registry's page references go;
        slots still decoding on those pages hold their own, so the pages
        outlive it until the last such request retires. A dense
        registration's KV lives outside the cache and just goes."""
        if not self.paged:
            if (self._control is not None and self._thread is not None
                    and self._thread.is_alive()):
                # ordered with the engine thread's prefill ops: a
                # follower must not drop a registration a published
                # prefill still names
                self._run_on_engine_thread(
                    lambda: self._unregister_dense(prefix_id))
                return
            self._unregister_dense(prefix_id)
            return
        if self._thread is not None and self._thread.is_alive():
            self._run_on_engine_thread(
                lambda: self._unregister_paged_sync(prefix_id))
            return
        # cakelint: skip[affinity] reached only with the engine thread not running (checked above); runtime assert backstops
        self._unregister_paged_sync(prefix_id)

    def _unregister_dense(self, prefix_id: int) -> None:
        with self._rid_lock:
            entry = self._prefixes.pop(prefix_id, None)
        self._prefix_last_hit.pop(prefix_id, None)
        if entry is not None:
            self._publish({"op": "unregister_prefix", "pid": prefix_id})

    @engine_thread_only
    def _unregister_paged_sync(self, prefix_id: int) -> None:
        with self._rid_lock:
            entry = self._prefixes.pop(prefix_id, None)
        self._prefix_last_hit.pop(prefix_id, None)
        if entry is not None:
            if entry[1] is not None:
                self._pager.release(entry[1])
            elif self._host_tier is not None:
                # a spilled registration: its pages live in the host
                # tier, not the pool; drop the host copy instead
                self._host_tier.drop(("prefix", prefix_id))

    def _match_prefix(self, ids: List[int]):
        """Longest registered prefix that is a proper head of `ids`:
        (pid, (p_ids, pages)) or None (pages None: spilled); a dense
        entry is (p_ids, (k, v))."""
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
        serve this prompt (`_prefix_window_plan`), or None.
        Returns the entry, not just the pid, so a concurrent eviction
        cannot turn a later lookup into a KeyError. A hit stamps the
        prefix's recency for the cold-prefix spill order."""
        hit = self._match_prefix(ids)
        if hit is None or self._prefix_window_plan(hit[1][0], ids) is None:
            return None
        self._prefix_last_hit[hit[0]] = time.monotonic()
        return hit

    def _prefix_window_plan(self, p_ids: List[int], ids: List[int]):
        """(chunk_suffix, C_or_bucket) for a prefix-hit prefill, or None
        when the suffix's windows (--prefill-chunk, when the suffix is
        longer than C) or its padded bucket would run past max_seq_len
        after the prefix. The JAX engine's rule, applied on both loops."""
        C = self.prefill_chunk
        suffix = ids[len(p_ids):]
        # a pipelined path always windows the suffix at pos0 = P (it has
        # no one-program prefixed prefill)
        if (self._custom_steps and not self.paged) or (C and len(suffix) > C):
            Cw = C or bucket_length(len(suffix), self.max_seq_len)
            n_win = -(-len(suffix) // Cw)
            if len(p_ids) + n_win * Cw <= self.max_seq_len:
                return (True, Cw)
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

    @engine_thread_only
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
            if self._autotuner is not None:
                # between iterations only: a switch folds every slot, so
                # it never lands mid-wave; off-interval it is a no-op
                self._autotune_tick()
            if self._slo and self._preemption:
                # between iterations only: every burst has been fetched
                # and no step reads a table row this releases, except
                # chunk-only mixed steps still on the stream, which the
                # release and any re-allocation are ordered after
                self._maybe_preempt()
            prefill_plan, decode_plan = self.scheduler.plan()
            # this iteration's planned decode rows: the candidates of
            # _spill_resident_stream (never same-wave admissions, whose
            # prefill may still be in flight)
            self._resident_parked = False
            self._cur_decode = {s: r for r, s in decode_plan}
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
                if self._faults is not None:
                    # the top-of-iteration site (step= triggers key off
                    # the engine's step counter)
                    self._faults.check("engine.step", step=self.stats.steps)
                if self._mixed:
                    self._do_mixed(prefill_plan, decode_plan)
                else:
                    self._do_phases(prefill_plan, decode_plan)
                # a clean iteration: an earlier failure's capture must
                # not come back in a later failure's snapshot, the next
                # failure backs off from scratch, and a failure before
                # the next dispatch implicates nobody
                self._fail_recs = None
                self._consec_resets = 0
                self._implicated = ()
                if self._journal is not None:
                    # one emit record per request touched this
                    # iteration (and the batch-mode fsync), then the
                    # size-triggered compaction, while the registry is
                    # stable
                    self._journal.flush()
                    self._journal.maybe_compact(self)
            except Exception as e:  # noqa: BLE001
                log.exception("engine iteration failed")
                # the traceback's frames hold the failed step's runners
                # (and through them the pool), and a log handler may keep
                # the record: clear their locals, so the reset frees the
                # pool before it allocates the new one
                traceback.clear_frames(e.__traceback__)
                # the request records first (pure Python); written as
                # the pre-fail snapshot only if the failure is fatal
                recs = None
                if self.snapshot_path:
                    from cake_tpu_torch.serve import checkpoint
                    recs = checkpoint.snapshot_requests(self)
                    self._fail_recs = (time.monotonic(), recs)
                if not self._continue_after_failure(e, recs):
                    return

    def _new_draft_cache(self) -> PagedKVCache:
        """An empty draft pool: the target pool's pages and page size, the
        draft config's layers and heads, its own sink page, the pool's
        storage dtype (fp8 included)."""
        assert self._specp is not None
        return PagedKVCache.create(
            self._specp.draft_config, self.max_slots, self._pager.n_pages,
            self._pager.page_size, self.max_seq_len,
            dtype=self._pool_dtype, device=self.device)

    def _new_dense_cache(self, config: LlamaConfig) -> KVCache:
        """An empty dense cache for `config` (the target's or the
        draft's): max_slots rows of max_seq_len positions, or of the
        window's W on a ring engine, in the cache dtype; over custom
        step fns, a new zeroed cache of the caller's placement."""
        if self._custom_steps:
            p = self._cache_placement
            # a placement tuple, or a cache's own allocator (the sp cache)
            return p() if callable(p) else zeros_placed(p)
        length = (self.config.sliding_window if self.ring
                  else self.max_seq_len)
        return KVCache.create(config, self.max_slots, length,
                              dtype=self._base_cache_dtype,
                              device=self.device)

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

    # -- crash recovery ---------------------------------------------------------

    def _note_reset(self) -> bool:
        """Record one reset in the storm window; True: the breaker trips
        (storm_resets resets within storm_window_s: the fault is not
        transient, so stop cleanly instead of thrashing)."""
        cfg = self._recovery_cfg
        now = time.monotonic()
        self._reset_times.append(now)
        cut = now - cfg.storm_window_s
        while self._reset_times and self._reset_times[0] < cut:
            self._reset_times.pop(0)
        return (self._recover
                and len(self._reset_times) >= cfg.storm_resets)

    def _continue_after_failure(self, e: Exception, recs) -> bool:
        """The policy after a failed iteration: recovery (reset and
        resubmit the in-flight requests), the fail-everything path
        (--no-recovery), or on a reset storm the breaker's snapshot and
        clean stop. False: the engine must stop."""
        storm = self._note_reset()
        if self._recover and not storm and not self._stop.is_set():
            return self._attempt_recovery(e, recs)
        err = as_engine_error(e)
        if storm:
            log.error("reset storm: %d resets within %.0fs; breaker open, "
                      "snapshotting in-flight requests and stopping",
                      len(self._reset_times),
                      self._recovery_cfg.storm_window_s)
            self._breaker_tripped = True
            _RECOVERIES.labels(outcome="storm_breaker").inc()
            self.stats.errors += 1
            self.stats.last_error = f"{type(e).__name__}: {e}"
            return self._stop_with_snapshot(recs, err,
                                             trigger="breaker_stop")
        # fail everything, then rebuild
        self._fail_all(err)
        try:
            self._publish({"op": "reset"})
        except Exception:  # noqa: BLE001
            # followers unreachable: the mesh is no longer fully driven;
            # stop serving instead of blocking on the next hop
            log.exception("control publish failed; stopping")
            self.stats.last_error = "control lost"
            return self._stop_with_snapshot(recs, trigger="control_lost")
        try:
            self._reset_after_error()
        except Exception:  # noqa: BLE001
            return self._reset_failed(recs)
        self.stats.errors += 1
        self.stats.last_error = f"{type(e).__name__}: {e}"
        return True

    def _reset_failed(self, recs, err: Optional[Exception] = None) -> bool:
        """The rebuild itself failed (an OOM while rebuilding, a sticky
        CUDA error): the engine cannot serve again. Snapshot what the
        failure captured and stop cleanly, instead of letting the raise
        kill the engine thread while queued requests hang."""
        log.exception("post-error engine reset failed; stopping the engine")
        # the pool is dead: the clients' teardown below must not write
        # its table (a poisoned CUDA context fails every call)
        self._slot_pages = {}
        self._slot_prefix_pages = {}
        self._mixed_pending = {}
        self._slot_req = [None] * self.max_slots
        for req in list(self._requests.values()):
            req.slot = -1
        _RESET_FAILURES.inc()
        _RECOVERIES.labels(outcome="reset_failed").inc()
        self.stats.errors += 1
        self.stats.last_error = "reset failed"
        return self._stop_with_snapshot(recs, err, trigger="reset_failed")

    def _stop_with_snapshot(self, recs, err: Optional[Exception] = None,
                            trigger: str = "engine_stop") -> bool:
        """The tail of every stop branch: fail the waiting clients (when
        the caller has not), write the pre-fail snapshot from the
        failure's capture, dump the postmortem bundle (--postmortem-dir;
        `trigger` names the terminal cause), stop the engine thread.
        Always False (the engine must stop)."""
        if err is not None:
            self._fail_all(err)
        # best effort: a breaker or reset-failed stop leaves this process
        # alive (the API serves 503s, heartbeats answer), so followers
        # would wait forever on a channel that carries no more ops. This
        # runs on the engine thread as its loop ends: no step op can
        # follow it on the wire
        try:
            self._publish({"op": "stop"})
        except Exception:  # noqa: BLE001
            log.warning("control: stop publish failed (followers will "
                        "exit on channel close)")
        with self._ckpt_lock:
            self._snapshot_before_fail(requests=recs)
        if self._postmortem is not None:
            # terminal: always leaves a bundle, even right after an
            # interval-bounded poison dump
            self._postmortem.dump(
                trigger, engine=self,
                reason=str(err) if err is not None
                else self.stats.last_error, force=True)
        log.error("engine stopped (%s): %s", trigger, self.stats.last_error)
        self._stop.set()
        return False

    def _attempt_recovery(self, e: Exception, recs) -> bool:
        """The fail-everything replacement: implicate the failed
        dispatch's requests, back off if resets are consecutive, rebuild
        the device state, then resubmit every surviving request through
        the recompute fold, so greedy streams complete with the tokens
        an uninterrupted run gives. False: the engine must stop."""
        t0 = time.perf_counter()
        # a request counts once a failed step: a mid-prefill slot is in
        # a mixed step's decode plan too (the JAX engine counts it twice
        # there, which quarantines it after one failure)
        implicated = sorted({rid for rid, _slot in self._implicated})
        self._implicated = ()
        for rid in implicated:
            req = self._requests.get(rid)
            if req is not None and not req.done.is_set():
                req.crash_count += 1
        # exponential backoff between consecutive resets (the first is
        # immediate), interruptible by stop()
        cfg = self._recovery_cfg
        self._consec_resets += 1
        if self._consec_resets > 1:
            delay = min(cfg.backoff_cap_s,
                        cfg.backoff_base_s
                        * (2.0 ** (self._consec_resets - 2)))
            log.warning("recovery: consecutive reset #%d, backing off "
                        "%.2fs", self._consec_resets, delay)
            if self._stop.wait(delay):
                self._fail_all(as_engine_error(e))
                return False
        try:
            # followers replay the reset, so every process rebuilds
            self._publish({"op": "reset"})
        except Exception:  # noqa: BLE001
            log.exception("control publish failed; stopping")
            self.stats.last_error = "control lost"
            return self._stop_with_snapshot(recs, as_engine_error(e),
                                            trigger="control_lost")
        try:
            self._reset_after_error()
        except Exception:  # noqa: BLE001
            return self._reset_failed(recs, as_engine_error(e))
        n_rec, n_poison = self._resubmit_after_reset(e)
        self.stats.errors += 1
        self.stats.last_error = f"{type(e).__name__}: {e}"
        self.stats.recoveries += 1
        dt = time.perf_counter() - t0
        _RECOVERY_SECONDS.observe(dt)
        if len(self.recovery_seconds) < 512:
            self.recovery_seconds.append(dt)
        _RECOVERIES.labels(outcome="recovered").inc()
        log.warning("recovered from step failure (%s: %s): %d "
                    "request(s) resubmitted, %d quarantined, %.3fs",
                    type(e).__name__, e, n_rec, n_poison, dt)
        self._wake.set()
        return True

    def _resubmit_after_reset(self, cause: Exception):
        """The request side of a reset: quarantine poison requests
        (implicated in implication_budget consecutive failed steps),
        requeue everyone else with their generated tokens folded into
        the prompt; class, seniority and preemption budget survive, as
        the same _Request is resubmitted. Returns (resubmitted,
        quarantined)."""
        cfg = self._recovery_cfg
        cause_s = f"{type(cause).__name__}: {cause}"
        self._slot_req = [None] * self.max_slots
        n_rec = n_poison = 0
        for rid, req in sorted(self._requests.items()):
            if req.done.is_set() or req._disagg_pending:
                # a disagg admission still waiting for its shipment is
                # in no scheduler: disagg_complete enters it
                continue
            req.slot = -1
            req._kv_restored = False
            if req.crash_count >= cfg.implication_budget:
                self._drop_request(
                    req, PoisonRequestError(rid, req.crash_count, cause_s),
                    poison_reason="implicated")
                n_poison += 1
                continue
            remaining = req.max_new_tokens - len(req.out_tokens)
            if remaining <= 0:
                # it was retiring in the failed step and holds every
                # token it asked for
                self._finish_recovered(req)
                n_rec += 1
                continue
            n_tok = len(req.prompt_ids) + len(req.out_tokens)
            if self._slo:
                # keeps the original enqueue time and the preemption
                # count; False means the request was still queued
                self.scheduler.requeue(rid, n_tok, remaining)
                ok = True
            else:
                # FIFO: cancel + resubmit in rid order keeps the arrival
                # order
                self.scheduler.cancel(rid)
                ok = self.scheduler.submit(rid, n_tok, remaining)
            if not ok:
                self._drop_request(req, as_engine_error(cause),
                                   poison_reason="resubmit_failed")
                n_poison += 1
                continue
            self.tracer.span(rid, "crash_recovered",
                             generated=len(req.out_tokens),
                             crashes=req.crash_count)
            if self.events is not None:
                self.events.publish("recovered", rid=rid,
                                    generated=len(req.out_tokens),
                                    crashes=req.crash_count)
            _RECOVERED_REQUESTS.inc()
            self.stats.requests_recovered += 1
            n_rec += 1
        return n_rec, n_poison

    def _drop_request(self, req: _Request, err: Exception,
                      poison_reason: Optional[str] = None) -> None:
        """Fail one request with a typed error during recovery (the
        quarantine, a failed resubmit); the reset already cleared its
        slot."""
        req.error = err
        self.scheduler.cancel(req.rid)
        if self._host_tier is not None:
            self._host_tier.drop(("victim", req.rid))
        self._requests.pop(req.rid, None)
        self._journal_retire(req, "error", error=str(err))
        if poison_reason is not None:
            self.stats.poisoned += 1
            _POISON_REQUESTS.labels(reason=poison_reason).inc()
            if self.events is not None:
                self.events.publish("poisoned", rid=req.rid,
                                    reason=poison_reason,
                                    crashes=req.crash_count)
            log.error("quarantined rid=%d as poison (%s): %s",
                      req.rid, poison_reason, err)
            if self._postmortem is not None:
                # interval-bounded (not forced): a quarantine cascade
                # leaves ONE bundle, not one a rid
                self._postmortem.dump(
                    "poison", engine=self,
                    reason=f"rid={req.rid} {poison_reason}: {err}")
        self.tracer.finish(req.rid, "error", error=str(err),
                           output_tokens=len(req.out_tokens))
        req.done.set()

    def _finish_recovered(self, req: _Request) -> None:
        """Retire a request whose budget was exhausted when the step
        failed: it has every token it asked for, so it gets its final
        delta instead of a zero-budget prefill."""
        if req.stream is not None:
            delta = self._incremental_text(req, final=True)
            try:
                if req.stream_wants_count:
                    req.stream(delta, True, len(req.out_tokens))
                else:
                    req.stream(delta, True)
            except Exception:  # noqa: BLE001
                log.exception("stream callback failed rid=%d", req.rid)
        req.finish_t = time.perf_counter()
        self.scheduler.cancel(req.rid)
        self._journal_retire(req, "retired")
        self._requests.pop(req.rid, None)
        self.stats.requests_completed += 1
        if self._shed is not None:
            self._shed.observe_retire()
        self.tracer.finish(req.rid, "retired",
                           output_tokens=len(req.out_tokens))
        self.retired.append(req)
        req.done.set()

    def recovery_state(self) -> dict:
        """Recovery and breaker state for /api/v1/health."""
        cfg = self._recovery_cfg
        out = {
            "enabled": self._recover,
            "recoveries": self.stats.recoveries,
            "requests_recovered": self.stats.requests_recovered,
            "poisoned": self.stats.poisoned,
            "consecutive_resets": self._consec_resets,
            "breaker": {
                "tripped": self._breaker_tripped,
                "resets_in_window": len(self._reset_times),
                "storm_resets": cfg.storm_resets,
                "window_s": cfg.storm_window_s,
            },
        }
        if self._faults is not None:
            out["fault_plan"] = self._faults.describe()
        if self._control is not None and hasattr(self._control,
                                                 "wire_state"):
            # the control plane's wire state (published seq, each
            # follower's last-sent and last-acked seqs): a follower
            # disconnect is diagnosable from the health route
            out["control"] = self._control.wire_state()
        return out

    def _reset_after_error(self) -> None:
        """A failed step may leave the pool half-written: reset the pool
        (of the same storage), the allocator, every per-slot mirror and
        the sampling state. Registered prefixes lived in the pool's
        pages, so the registry is cleared too (auto-prefix heads
        register again on their next request), and so is the host tier
        (its entries belonged to the failed requests and the cleared
        registry). The reset count folds into the new seeds.

        The reset is made in place (`_reset_in_place`): every captured
        graph stays valid and nothing is captured anew, as JAX's reset
        keeps its jitted steps. Only when that raises (a sticky CUDA
        error) does the rebuild run (`_rebuild_after_error`), which
        drops the graphs and allocates a new pool; a raise there goes
        to the caller's reset_failed stop."""
        self._reset_count += 1
        try:
            self._reset_in_place()
            return
        except Exception as e:  # noqa: BLE001
            log.exception("in-place reset failed; rebuilding the pool "
                          "and the graphs")
            # a log handler may keep the record: its frames must not
            # hold the pool through the rebuild
            traceback.clear_frames(e.__traceback__)
        self._rebuild_after_error()

    @engine_thread_only
    def _reset_in_place(self) -> None:
        """The reset at the same addresses, after a wait for the
        engine's stream (a chained --decode-scan burst or a chunk-only
        mixed step may still run on it): the host state as the rebuild
        resets it, then `_reset_device_in_place`."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._mixed_open = None
        self._compiled_step = False
        self._reset_host_state()
        self._reset_device_in_place()

    def _reset_device_in_place(self) -> None:
        """Every pool leaf zeroed (values and int8/int4 scales, the sink
        page included, which stays the sink), every table row unmapped,
        the rings emptied, the seeds recomputed into their tensor and
        the counters zeroed, and the runners' per-step buffers zeroed:
        no tensor a graph holds moves."""
        if not self.paged:
            # the dense or ring cache, and the dense spec engine's draft
            self.cache.zero_()
            if self.d_cache is not None:
                self.d_cache.zero_()
        else:
            for st in (self.cache.k_store, self.cache.v_store):
                for t in (st if isinstance(st, tuple) else (st,)):
                    zero_(t)
            self.cache.table.fill_(-1)
            if self.d_cache is not None:
                for t in (self.d_cache.k_store, self.d_cache.v_store):
                    zero_(t)
                self.d_cache.table.fill_(-1)
        self._ring.fill_(-1)
        self._seeds.copy_(to_device(self._seed_values(), self.device))
        self._counters.zero_()
        for r in (self._runner, self._mixed_runner, self._prefill_runner,
                  self._spec_runner, self._draft_prefill_runner):
            if r is not None:
                r.reset_carry()

    @engine_thread_only
    def _rebuild_after_error(self) -> None:
        """The fallback reset: wait for the stream, drop all three
        runners, their graphs' memory pool, the pending mixed records
        and the pool before the new pool is allocated (a rebuild needs
        one pool's memory, not two), then new sampling state. The next
        steps capture their graphs anew (counted as compiles)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._drop_device_state()
        self._reset_host_state()
        if not self.paged:
            self.cache = self._new_dense_cache(self.config)
            if self._spec:
                self.d_cache = self._new_dense_cache(self.draft_config)
        else:
            self.cache = self._new_cache(self._pager.n_pages,
                                         self._pager.page_size)
            if self._specp is not None:
                self.d_cache = self._new_draft_cache()
        # new rings and random streams; the runners capture anew over
        # the new pool
        self._fresh_sampling_state()

    def _drop_device_state(self) -> None:
        """Drop every reference to the pool and the graphs that hold it:
        the runners, their graphs' memory pool, the pending mixed
        records, the sampling state and the pools (the caller allocates
        the new ones after this, so it needs one pool's memory, not
        two)."""
        self._runner = None
        self._mixed_runner = None
        self._prefill_runner = None
        self._spec_runner = None
        self._draft_prefill_runner = None
        self._graph_pool = None
        self._mixed_open = None
        self._ring = self._seeds = self._counters = None
        self.cache = None
        self.d_cache = None

    def _reset_host_state(self) -> None:
        """The host side of a reset: the host tier, the allocator (of the
        same geometry), the slot maps, the prefix registry and the
        per-slot mirrors. A dense registry lives outside the cache and
        stays, as JAX's does."""
        if self._host_tier is not None:
            self._host_tier.clear()
        with self._rid_lock:
            # staged shipments referenced the failed requests'
            # admissions; post-reset resubmits prefill locally
            self._adopt_store.clear()
        if self._specp is not None:
            # every stream's draft and suffix pages lived in the
            # allocator reset here; streams re-activate lazily after
            # their recovery resubmit
            self._specp.spec_streams.clear()
        if self.paged:
            self._pager = PageAllocator(self._pager.n_pages,
                                        self._pager.page_size)
            with self._rid_lock:
                self._prefixes.clear()
                self._auto_pids.clear()
            self._prefix_last_hit = {}
        self._slot_pages = {}
        self._slot_prefix_pages = {}
        self._prefix_pages_shared = 0
        self._mixed_pending = {}
        self._page_blocked_rid = None
        self._pending_page_preempt = None
        self._cur_decode = {}
        _PREFIX_PAGES_SHARED.set(0)
        self._pos[:] = 0
        self._last_tok[:] = 0
        self._steps[:] = 0

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
        # spec teardown rides the same idempotent hook: the stream's
        # draft pages and target suffix pages go back with its base
        # pages, whatever path tears the slot down
        self._release_spec_state(slot)
        pages = self._slot_pages.pop(slot, None)
        if pages:
            self._pager.release(pages)
            table_set_slot(self.cache.table, slot, [])
        n_shared = self._slot_prefix_pages.pop(slot, 0)
        if n_shared:
            self._prefix_pages_shared -= n_shared
            _PREFIX_PAGES_SHARED.set(self._prefix_pages_shared)

    def _release_spec_state(self, slot: int) -> None:
        """Release a slot's speculative pages (idempotent): the draft
        row's pages and the target row's suffix pages return to the
        shared allocator, and the draft row is unmapped."""
        if self._specp is None:
            return
        st = self._specp.spec_streams.pop(slot, None)
        if st is None:
            return
        if st.d_pages:
            self._pager.release(st.d_pages)
            table_set_slot(self.d_cache.table, slot, [])
        if st.t_suffix_pages:
            self._pager.release(st.t_suffix_pages)

    def _alloc_slot_pages(self, req: _Request, slot: int,
                          hit=None) -> bool:
        """Admission by pages: map the slot's table row when the pool
        covers prompt + budget, else requeue the request. A page-starved
        request becomes the blocking head: younger requests requeue
        behind it instead of being admitted past it.

        hit: a validated prefix match (pid, (p_ids, pages)) from
        _match_and_validate_prefix: the slot then allocates only
        suffix + budget pages and maps the shared pages, retained, at the
        head of its row (a spilled prefix is restored first; when it
        cannot be, the admission goes without it: req._effective_hit is
        the hit really mapped). Under priority classes a request that
        outranks the blocking head may try the pool past it (an aged
        head's score is the best, so it keeps first claim on freed
        pages).

        With the host tier, a pool that cannot cover the admission first
        spills cold prefixes, then parks decode-resident streams, before
        the request requeues; and a spilled preemption victim whose entry
        fits this admission's row has its pages installed
        (`_restore_victim`), so it needs no prefill."""
        if self._faults is not None:
            # an injected OOM here surfaces as a real allocation failure
            self._faults.check("pager.alloc", step=self.stats.steps)
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
        hit_pid = None
        if hit is not None:
            hit_pid = hit[0]
            p_ids, prefix_pages = hit[1]
            n_prefix = len(p_ids)
            if prefix_pages is None:
                # the prefix was spilled to the host tier under page
                # pressure: stream it back before mapping it
                prefix_pages = self._restore_prefix(hit_pid)
                if prefix_pages is None:
                    # gone from the host too, or no room for it now:
                    # this admission goes without the prefix
                    hit = hit_pid = None
                    n_prefix = 0
                    prefix_pages = []
        # the prefills run against the hit that is really mapped
        req._effective_hit = hit
        need = len(req.prompt_ids) - n_prefix + req.max_new_tokens
        if self._specp is not None:
            # spec admission gate: admit only when the pool can also
            # cover the stream's worst-case speculative pages, the draft
            # row's whole-context pages (the draft pool shares no
            # prefixes) plus the target row's gamma-token overhang past
            # the base allocation; activation and extension stay
            # best-effort (a shortfall decodes the row plain)
            g = self._specp.live_gamma
            base = len(req.prompt_ids) + req.max_new_tokens
            cap = min(base + g, self.max_seq_len)
            spec_extra = (self._pager.pages_for(cap)
                          + max(self._pager.pages_for(cap)
                                - self._pager.pages_for(base), 0))
            if (self._pager.pages_for(need) + spec_extra
                    > self._pager.free_pages):
                return self._requeue_for_pages(req, slot, starved=True)
        pages = self._pager.alloc(need)
        if pages is None and self._host_tier is not None:
            # cold shared prefixes (only the registry holds their pages)
            # spill to host RAM before the admission is refused
            missing = self._pager.pages_for(need) - self._pager.free_pages
            if self._spill_cold_prefixes(missing, keep_pid=hit_pid):
                pages = self._pager.alloc(need)
        if pages is None and self._host_tier is not None:
            # still short: oversubscribe, parking decode-resident streams
            # (LRU by admission) until the admission fits or none is left
            while (pages is None
                   and self._spill_resident_stream(req.rid)):
                pages = self._pager.alloc(need)
        if pages is None:
            return self._requeue_for_pages(req, slot, starved=True)
        # a spilled preemption victim: its entry must fit the CURRENT
        # admission's row (a prefix dropped or registered between spill
        # and resume changes the row's layout)
        ent = None
        if self._host_tier is not None:
            ent = self._host_tier.peek(("victim", req.rid))
            if ent is not None and (ent.n_prefix_tokens != n_prefix
                                    or ent.n_pages != len(pages)):
                self._host_tier.drop(("victim", req.rid))
                ent = None
            elif ent is not None:
                # counted as a restore; _restore_victim installs it
                ent = self._host_tier.pop(("victim", req.rid))
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
            # occupant's scales (a restore overwrites them with the
            # spilled ones anyway); the shared pages keep theirs
            reset_page_scales(self.cache, pages)
        if ent is not None:
            self._restore_victim(req, slot, pages, ent)
        if req.rid == blocked:
            self._page_blocked_rid = None
        # the resident spill's LRU stamp: a re-admission counts as recent
        # use, and its token count starts the anti-thrash quantum
        req._admit_seq = self._admit_seq
        req._resident_base = len(req.out_tokens)
        self._admit_seq += 1
        return True

    def _restore_victim(self, req: _Request, slot: int,
                        pages: List[int], ent: SpilledPages) -> None:
        """Host-to-device restore of a spilled preemption victim: its
        pages go into the slot's fresh pages (bit for bit), and the
        slot's mirrors resume at the spilled frontier, so the next decode
        step (its row loaded from the host mirrors: its own pos and last
        token) samples the token an uninterrupted run would. Sets
        _kv_restored: the admission skips the prefill. ent: the entry
        _alloc_slot_pages already popped."""
        if self._faults is not None:
            # an injected install fault fails the iteration: recovery
            # resubmits the victim through the recompute fold (its entry
            # was already popped)
            self._faults.check("host_tier.install", step=self.stats.steps)
        HostTier.install_pages(self.cache, pages, ent.arrays)
        self._temp[slot] = req.temperature
        self._top_p[slot] = req.top_p
        self._penalty[slot] = req.repeat_penalty
        self._prime_ring(slot, list(req.prime_tokens) + list(req.out_tokens))
        self._pos[slot] = ent.pos
        self._last_tok[slot] = ent.last_tok
        self.stats.kv_restores += 1
        req._kv_restored = True
        self.tracer.span(req.rid, "kv_restored", pages=ent.n_pages)
        log.debug("restored rid=%d from the host tier (%d pages, pos %d)",
                  req.rid, ent.n_pages, ent.pos)

    def _capture_shipment(self, req: _Request) -> None:
        """Disaggregated PREFILL engine (engine thread, inside _emit's
        retirement, before _release_slot_pages frees the row): fetch the
        pages holding the prompt's KV (raw pool slices, scales included,
        dtype-blind) and hand a Shipment to the request's ship_sink.
        On the card the fetch only queues non-blocking copies into
        pinned memory; the event recorded after them (`Shipment.ready`)
        is what the plane's writer thread waits on, so nothing here
        waits for the stream. Failure hands None (the decode peer
        degrades to local prefill), so this never raises."""
        ship = None
        try:
            if self._faults is not None:
                # inside the try: an injected ship fault degrades to the
                # peer's local prefill, as a real fetch failure does
                self._faults.check("kv.ship", step=self.stats.steps)
            if not req.out_tokens:
                raise ValueError("nothing to ship (no first token)")
            row = self._slot_pages.get(req.slot) or []
            P = self._pager.page_size
            n_tokens = len(req.prompt_ids)
            n_written = -(-n_tokens // P)
            if n_written > len(row):
                raise ValueError(
                    f"slot row holds {len(row)} pages; prompt needs "
                    f"{n_written}")
            pages = row[:n_written]
            arrays = HostTier.fetch_pages(self.cache, pages)
            ready = None
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
            ship = Shipment(
                epoch=0,   # stamped by the plane with the PEER's epoch
                dtype=pool_dtype_name(self.cache),
                page_size=P, n_tokens=n_tokens, n_written=n_written,
                first_tok=int(req.out_tokens[0]), pages=list(pages),
                arrays=arrays, ready=ready,
                handoff={
                    # the journal admit/emit schema's fields: what the
                    # decode engine needs to adopt the stream
                    "rid": req.rid, "prompt_len": n_tokens,
                    "max_new_tokens": req.max_new_tokens,
                    "temperature": req.temperature,
                    "top_p": req.top_p,
                    "repeat_penalty": req.repeat_penalty,
                    "priority": req.priority,
                    "first_lp": float(req.out_logprobs[0])
                    if req.out_logprobs else 0.0,
                })
            self.stats.kv_ships += 1
            self.tracer.span(req.rid, "kv_shipped", pages=n_written)
        except Exception:  # noqa: BLE001 — shipping is best-effort
            log.exception("kv shipment capture failed rid=%d; the peer "
                          "will prefill locally", req.rid)
            ship = None
        try:
            req.ship_sink(ship)
        except Exception:  # noqa: BLE001 — never raise into _emit
            log.exception("ship_sink failed rid=%d", req.rid)

    def _adopt_install(self, req: _Request, slot: int, ent) -> bool:
        """Disaggregated DECODE engine (engine thread, from _do_prefill /
        _mixed_admit after the row is allocated): install the shipped
        pages into the slot's fresh row and resume the stream at the
        shipped frontier, as _restore_victim does, with the peer's
        first token emitted verbatim. The upload leaves pinned memory
        with non_blocking on the steps' stream; PyTorch's pinned-memory
        allocator keeps each block from reuse until the event it records
        with the copy has passed. Every buffer a graph holds is written
        in place (pool leaves, table, penalty ring; the rest are host
        mirrors the steps load). False = refused (a stale epoch, a geometry that does not fit, an
        injected fault): the caller falls through to whole-prompt local
        prefill, which rewrites the row's pages and scales."""
        outcome = "fault"
        try:
            if self._faults is not None:
                self._faults.check("kv.adopt", step=self.stats.steps)
            if ent.epoch != self.config_epoch:
                outcome = "epoch"
                raise ValueError(
                    f"shipment config epoch {ent.epoch} != engine "
                    f"epoch {self.config_epoch} (reconfigured while "
                    "the shipment flew)")
            pool_dt = pool_dtype_name(self.cache)
            row = self._slot_pages.get(slot) or []
            if (ent.page_size != self._pager.page_size
                    or ent.dtype != pool_dt
                    or ent.n_tokens != len(req.prompt_ids)
                    or ent.n_written > len(row)):
                outcome = "geometry"
                raise ValueError(
                    f"shipment geometry (page_size={ent.page_size}, "
                    f"dtype={ent.dtype}, n_tokens={ent.n_tokens}, "
                    f"n_written={ent.n_written}) does not fit this "
                    f"pool (page_size={self._pager.page_size}, "
                    f"dtype={pool_dt}, row={len(row)} pages)")
            HostTier.install_pages(self.cache, row[:ent.n_written],
                                   ent.arrays)
        except Exception:  # noqa: BLE001 — adoption is best-effort
            note_adopt(outcome)
            log.exception("kv adoption refused rid=%d; degrading to "
                          "local prefill", req.rid)
            return False
        self._temp[slot] = req.temperature
        self._top_p[slot] = req.top_p
        self._penalty[slot] = req.repeat_penalty
        self._prime_ring(slot, list(req.prime_tokens) + [ent.first_tok])
        self._pos[slot] = ent.n_tokens
        self._last_tok[slot] = ent.first_tok
        self.stats.kv_adopts += 1
        note_adopt("adopted")
        self.tracer.span(req.rid, "kv_adopted", pages=ent.n_written)
        if self.events is not None:
            self.events.publish("kv_adopted", rid=req.rid,
                                pages=ent.n_written, dtype=ent.dtype)
        # the peer's first token emits verbatim: identity with the
        # colocated engine is by construction, and the stream starts
        # here, not after a local re-prefill
        self._emit(req, ent.first_tok,
                   logprob=float(ent.handoff.get("first_lp", 0.0)))
        return True

    def _spill_victim_pages(self, req: _Request, slot: int) -> bool:
        """Device-to-host spill of a preemption victim's (or a parked
        stream's) own pages, called before _release_slot_pages while
        they are still live; shared prefix pages only drop a reference.
        False (no tier, spill_preempt off, a victim mid-prefill or with
        no token out, no room, or a failed copy, which is logged and
        counted): the recompute fold serves."""
        if (self._host_tier is None
                or not self._sched_cfg.spill_preempt
                or slot in self._mixed_pending
                or not req.out_tokens):
            return False
        row = self._slot_pages.get(slot) or []
        n_shared = self._slot_prefix_pages.get(slot, 0)
        own = row[n_shared:]
        if not own or not self._host_tier.can_hold(len(own)):
            return False
        try:
            if self._faults is not None:
                # inside the try: an injected fetch fault takes the
                # documented fallback (the recompute fold)
                self._faults.check("host_tier.fetch", step=self.stats.steps)
            arrays = HostTier.fetch_pages(self.cache, own)
        except Exception:  # noqa: BLE001 — the fold is the fallback
            self.stats.kv_spill_failures += 1
            log.exception("victim spill failed (rid=%d); it resumes by "
                          "the recompute fold", req.rid)
            return False
        ok = self._host_tier.put(("victim", req.rid), SpilledPages(
            n_pages=len(own), arrays=arrays, kind="victim",
            pos=int(self._pos[slot]), last_tok=int(self._last_tok[slot]),
            n_prefix_tokens=n_shared * self._pager.page_size))
        if ok:
            self.stats.kv_spills += 1
        return ok

    def _spill_cold_prefixes(self, n_pages_needed: int,
                             keep_pid=None) -> int:
        """Spill least-recently-hit COLD prefixes (every page at refcount
        1: only the registry holds them) to the host tier until
        n_pages_needed device pages are free, skipping keep_pid (the
        admission's own match). Returns the pages freed."""
        if self._host_tier is None or n_pages_needed <= 0:
            return 0
        with self._rid_lock:
            entries = list(self._prefixes.items())
        entries.sort(key=lambda kv: self._prefix_last_hit.get(kv[0], 0.0))
        freed = 0
        for pid, (p_ids, pages) in entries:
            if freed >= n_pages_needed:
                break
            if pid == keep_pid or pages is None:
                continue
            if any(self._pager.refcount(p) != 1 for p in pages):
                continue          # hot: some slot maps these pages
            if not self._host_tier.can_hold(len(pages)):
                continue
            try:
                if self._faults is not None:
                    self._faults.check("host_tier.fetch",
                                       step=self.stats.steps)
                arrays = HostTier.fetch_pages(self.cache, pages)
            except Exception:  # noqa: BLE001 — the prefix stays put
                self.stats.kv_spill_failures += 1
                log.exception("cold prefix spill failed (pid=%d)", pid)
                continue
            if not self._host_tier.put(
                    ("prefix", pid),
                    SpilledPages(n_pages=len(pages), arrays=arrays,
                                 kind="prefix")):
                continue
            with self._rid_lock:
                self._prefixes[pid] = (p_ids, None)
            self._pager.release(pages)
            self.stats.kv_spills += 1
            freed += len(pages)
            log.debug("spilled cold prefix %d (%d pages) to the host tier",
                      pid, len(pages))
        return freed

    def _restore_prefix(self, pid: int) -> Optional[List[int]]:
        """Host-to-device restore of a spilled prefix: fresh pool pages,
        the saved contents installed, the registry entry re-pointed.
        None when the host entry was evicted (the prefix exists nowhere:
        it is unregistered, so matches stop) or the pool has no room now
        (the entry stays; this hit degrades to a whole-prompt
        prefill)."""
        if self._host_tier is None:
            return None
        ent = self._host_tier.peek(("prefix", pid))
        with self._rid_lock:
            entry = self._prefixes.get(pid)
        if entry is None:
            if ent is not None:
                self._host_tier.drop(("prefix", pid))
            return None
        if ent is None:
            # evicted from the host tier: drop the registration
            # (auto-prefix registers the head again on its next request)
            with self._rid_lock:
                self._prefixes.pop(pid, None)
            self._prefix_last_hit.pop(pid, None)
            return None
        pages = self._pager.alloc(ent.n_pages * self._pager.page_size)
        if pages is None:
            return None
        if self._faults is not None:
            self._faults.check("host_tier.install", step=self.stats.steps)
        ent = self._host_tier.pop(("prefix", pid))
        HostTier.install_pages(self.cache, pages, ent.arrays)
        with self._rid_lock:
            self._prefixes[pid] = (entry[0], pages)
        self._prefix_last_hit[pid] = time.monotonic()
        self.stats.kv_restores += 1
        log.debug("restored prefix %d from the host tier (%d pages)", pid,
                  ent.n_pages)
        return pages

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
            if self._host_tier is not None:
                self._host_tier.drop(("victim", req.rid))
            self._journal_retire(req, "error", error=str(req.error))
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

    @engine_thread_only
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
        """Preemption of one slot: the victim requeues with its seniority
        as prompt + generated tokens for the rest of its budget, and its
        pages go back through the refcounted allocator (shared prefix
        pages only drop a reference). With the host tier its own pages
        spill first (`_spill_victim_pages`), and its admission installs
        them and resumes decoding where it stopped; otherwise the
        admission re-prefills the fold through the mixed step, or the
        phase-split prefill (the recompute fold). Either way the next
        greedy token is the one an uninterrupted run emits."""
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
        spilled = self._spill_victim_pages(req, slot)
        self._release_slot_pages(slot)
        self.stats.preemptions += 1
        _PREEMPTIONS.labels(reason=reason).inc()
        self.tracer.span(rid, "preempted", reason=reason,
                         generated=len(req.out_tokens), spilled=spilled)
        if self.events is not None:
            self.events.publish("preempted", rid=rid, reason=reason,
                                priority=req.priority,
                                generated=len(req.out_tokens),
                                spilled=spilled)
        log.debug("preempted rid=%d (%s, %d tokens %s)", rid, reason,
                  len(req.out_tokens),
                  "spilled to the host tier" if spilled
                  else "fold into the prompt")
        return True

    def _live_decode_rows(self, decode_plan):
        """The decode plan re-validated after a mid-wave resident spill:
        plan() ran before the admissions, so a slot that
        _spill_resident_stream parked may still carry a planned decode
        row, pointing at pages already released (and maybe re-allocated
        to the admission that parked it)."""
        self._resident_parked = False
        return [(rid, slot) for rid, slot in decode_plan
                if self._slot_req[slot] is not None
                and self._slot_req[slot].rid == rid]

    @engine_thread_only
    def _spill_resident_stream(self, exclude_rid: int) -> bool:
        """Decode-resident spill, oversubscribing the pool like virtual
        memory: when an admission would be refused even after the cold
        prefix spills, park the least recently admitted decoding stream
        (its own pages to the host tier) and requeue it. It resumes as a
        preemption victim does (`_restore_victim`, or the recompute fold
        when its pages did not go to the host), so its stream is the one
        an uninterrupted run emits. True when a stream was parked (its
        pages are free now), False when no candidate qualifies.

        Candidates are this iteration's planned decode rows
        (_cur_decode), never same-wave admissions, whose prefill may
        still be in flight; a candidate must have decoded
        resident_quantum tokens since its admission (anti-thrash), and
        its pages must fit the tier's FREE capacity (a park never
        evicts: a spilled prefix is its only copy)."""
        if self._host_tier is None or not self._sched_cfg.spill_resident:
            return False
        quantum = self._sched_cfg.resident_quantum
        best = None
        for slot, rid in self._cur_decode.items():
            req = (self._slot_req[slot]
                   if 0 <= slot < self.max_slots else None)
            if (req is None or req.rid != rid or req.rid == exclude_rid
                    or req.done.is_set() or slot in self._mixed_pending
                    or not req.out_tokens
                    or req.max_new_tokens - len(req.out_tokens) <= 0):
                continue
            if len(req.out_tokens) - req._resident_base < quantum:
                continue
            own = (self._slot_pages.get(slot)
                   or [])[self._slot_prefix_pages.get(slot, 0):]
            if not own or len(own) > self._host_tier.free_pages:
                continue
            if best is None or req._admit_seq < best[0]:
                best = (req._admit_seq, rid, slot)
        if best is None:
            return False
        _, rid, slot = best
        req = self._slot_req[slot]
        remaining = req.max_new_tokens - len(req.out_tokens)
        folded = len(req.prompt_ids) + len(req.out_tokens)
        if self._slo:
            # seniority survives (the _preempt_slot discipline)
            if not self.scheduler.requeue(rid, folded, remaining):
                return False
        else:
            # resubmitted as it will re-admit: generated tokens folded
            # into the prompt, the budget cut to the remainder
            self.scheduler.cancel(rid)
            if not self.scheduler.submit(rid, folded, remaining):
                # the queue is full: the stream has nowhere to wait and
                # errors as a page-starved admission with a full queue
                # does; its pages still come back
                self._slot_req[slot] = None
                req.slot = -1
                self._release_slot_pages(slot)
                self._resident_parked = True
                req.error = RuntimeError(
                    "kv page pool exhausted and admission queue full")
                self._requests.pop(rid, None)
                self._journal_retire(req, "error", error=str(req.error))
                self.tracer.finish(rid, "error", error=str(req.error))
                req.done.set()
                return True
        self._slot_req[slot] = None
        req.slot = -1
        spilled = self._spill_victim_pages(req, slot)
        self._release_slot_pages(slot)
        self._resident_parked = True
        self.stats.kv_resident_spills += 1
        note_resident_spill()
        self.tracer.span(rid, "resident_spilled",
                         generated=len(req.out_tokens), spilled=spilled)
        if self.events is not None:
            self.events.publish("resident_spilled", rid=rid,
                                generated=len(req.out_tokens),
                                spilled=spilled)
        log.debug("parked decode-resident rid=%d (%d tokens %s)", rid,
                  len(req.out_tokens),
                  "spilled to the host tier" if spilled
                  else "fold into the prompt")
        return True

    # -- steps ----------------------------------------------------------------

    @engine_thread_only
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
            if decode_plan and self._resident_parked:
                # an admission above parked a decode-resident slot: drop
                # its stale row before the decode step is dispatched
                # (_mixed_dispatch re-validates its rows itself)
                decode_plan = self._live_decode_rows(decode_plan)
            if decode_plan and self._specp is not None:
                # spec rows ride one batched draft+verify round; the rows
                # it leaves (sampling options, page pressure, window cap,
                # degraded) fall through to the plain decode paths
                decode_plan = self._do_spec_paged(decode_plan)
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
        # this admission is the blast radius from here on; the site
        # carries the prefill length, so a match_len= rule can target
        # one request's prefill (the poison-request drill)
        self._implicated = ((rid, slot),)
        if self._faults is not None:
            self._faults.check("engine.prefill", step=self.stats.steps,
                               n_tokens=len(ids))
        # shipped-prefill adoption (disagg decode engine): a staged
        # shipment replaces both the prefix match and the local compute,
        # since the peer's pages hold the whole prompt (the row
        # allocates unshared). PEEK only: the entry must survive a
        # pool-exhausted requeue; it pops after the row exists
        with self._rid_lock:
            adopt = self._adopt_store.get(rid)
        hit = (self._match_and_validate_prefix(ids) if adopt is None
               else None)
        if not self._alloc_slot_pages(req, slot, hit):
            return   # pool exhausted: requeued (or failed) inside
        hit = req._effective_hit      # a spilled prefix may not be back
        if req._kv_restored:
            # a spilled victim restored from the host tier resumes as a
            # decode row: it must not ride the next mixed step as a
            # chunk row
            req._kv_restored = False
            return
        if adopt is not None:
            with self._rid_lock:
                self._adopt_store.pop(rid, None)
            if not req.out_tokens and self._adopt_install(req, slot,
                                                          adopt):
                # the slot resumes as a DECODE row from the shipped
                # frontier: it must not also ride as a chunk row
                return
            # refused: fall through to local chunked prefill
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
        prompt and a resume's prime tokens, or after a preemption or a
        recovery the prompt and the generated tokens (the recompute
        fold), the ring primed over the whole generated history."""
        if req.out_tokens:
            return (list(req.prompt_ids) + list(req.out_tokens),
                    list(req.prime_tokens) + list(req.out_tokens))
        return req.prompt_ids, list(req.prime_tokens)

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

    def _captured(self, fn_name):
        """A runner's capture hook: the flight recorder counts the
        capture as a compile of `fn_name` (a dict: of the JAX function
        its variant's kind names), and the step that caused it is
        recorded as compiled. The hook holds the engine weakly: the
        engine owns the runner, and a stopped engine is freed by its
        refcount, not by a cyclic collection."""
        ref = weakref.ref(self)

        def hook(variant, seconds: float) -> None:
            eng = ref()
            if eng is not None:
                eng.flight.count_capture(
                    fn_name[variant[0]] if isinstance(fn_name, dict)
                    else fn_name, seconds)
                eng._compiled_step = True
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
            kv_bytes_per_token=self._kv_bytes_per_token,
            kv_span=None if self.paged else self.cache.max_seq_len)

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
            compiled=compiled,
            pages_free=self._pager.free_pages if self.paged else None,
            pages_total=self.cache.n_pages if self.paged else None,
            rids=list(rids), **split)

    def _mixed_dispatch(self, decode_plan) -> None:
        """Build and run ONE mixed step: every decode row contributes its
        last token (q_len=1), every mid-prefill slot its next window;
        rows whose window ends their prompt sample their first token from
        the same replay the decode rows sample their next. A step in
        which no row emits (every row mid-prompt) fetches nothing: the
        host goes on to build the next step, which queues behind it."""
        t0 = time.perf_counter()
        # the blast radius: every decode row and every mid-prefill slot
        # rides this one step (a chunk-only step fetches nothing, so a
        # fault of its own is raised here, at its dispatch)
        self._implicated = tuple(
            [(rid, slot) for rid, slot in decode_plan]
            + [(p["req"].rid, slot)
               for slot, p in self._mixed_pending.items()])
        if self._faults is not None:
            self._faults.check("engine.mixed", step=self.stats.steps)
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

    @engine_thread_only
    def _do_phases(self, prefill_plan, decode_plan) -> None:
        """One iteration of the phase-split loop: the admissions prefill
        (PREFILL_FLUSH a host round trip), then the rows planned to
        decode take their step or burst."""
        if prefill_plan:
            self._do_prefill_batch(prefill_plan)
        if decode_plan and self._resident_parked:
            # an admission above parked a decode-resident slot: the plan
            # predates the park, and no step may write through a
            # released table row
            decode_plan = self._live_decode_rows(decode_plan)
        if decode_plan:
            if self._spec:
                self._do_decode_spec(decode_plan)
                return
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
        # the blast radius, and the content-keyed site (_mixed_admit's)
        self._implicated = ((rid, slot),)
        if self._faults is not None:
            self._faults.check("engine.prefill", step=self.stats.steps,
                               n_tokens=len(ids))
        # a staged shipment (disagg decode engine): peeked here, popped
        # once the row exists (_mixed_admit's discipline)
        with self._rid_lock:
            adopt = self._adopt_store.get(rid)
        # match BEFORE page admission: a hit changes the allocation
        hit = (self._match_and_validate_prefix(ids)
               if adopt is None and self._prefix_capable else None)
        if self.paged:
            if not self._alloc_slot_pages(req, slot, hit):
                return None   # pool exhausted: requeued (or failed) inside
            hit = req._effective_hit   # a spilled prefix may not be back
        if req._kv_restored:
            # a spilled victim restored from the host tier: its KV and
            # sampling state sit at its frontier; no prefill at all (the
            # token the fold would re-derive was already emitted)
            req._kv_restored = False
            return None
        if adopt is not None:
            with self._rid_lock:
                self._adopt_store.pop(rid, None)
            if not req.out_tokens and self._adopt_install(req, slot,
                                                          adopt):
                return None   # pages installed, first token emitted
            # refused: whole-prompt prefill rewrites the row's pages
            # and scales, the documented degradation
        n_top = self._n_top_for([slot])
        if self._control is not None:
            op = {"op": "prefill", "ids": list(ids), "slot": slot,
                  "temp": req.temperature, "top_p": req.top_p,
                  "penalty": req.repeat_penalty, "prime": list(prime),
                  "n_top": n_top}
            if hit is not None:
                op.update(op="prefill_prefixed", pid=hit[0])
            self._publish(op)
        if hit is not None:
            out = self._prefixed_prefill_device(ids, slot, req, hit[1],
                                                n_top, prime)
            n_pre = len(hit[1][0])
            self.stats.prefix_hits += 1
            if self.paged:
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
        if not (C and (n > C or self.ring)):
            return [(n_prefix, n)]
        return [(n_prefix + a, min(C, n - a)) for a in range(0, n, C)]

    # admissions a first-token fetch in _do_prefill_batch: each group's
    # prefills and samples are dispatched back to back with no wait for
    # the stream (tokens, write targets and sampling inputs go up from
    # pinned memory; the targets come from the host's copy of the row),
    # then fetched together, so early arrivals of a wave stream their
    # first token after a few prefills instead of after the whole wave
    PREFILL_FLUSH = 4

    @engine_thread_only
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
        if C and (len(ids) > C or self.ring):
            # a ring prompt always walks windows of at most W: a whole
            # bucket would write past the ring
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

    def _prefill_step_runner(self) -> PrefillRunner:
        """The captured one-slot prefills (serve/graphs.PrefillRunner),
        each capture counted as a compile of its JAX function."""
        if self._prefill_runner is None:
            self._prefill_runner = PrefillRunner(
                self.params, self.cache, self.rope, self.config,
                attn=self.paged_attn, pool=self._graph_pool,
                on_capture=self._captured(PREFILL_FNS))
        return self._prefill_runner

    def _dense_prefill_runner(self) -> DensePrefillRunner:
        """The dense and ring engines' captured one-slot steps
        (serve/graphs.DensePrefillRunner), each capture counted as a
        compile of its JAX function."""
        if self._prefill_runner is None:
            self._prefill_runner = self._new_dense_prefill_runner(
                self.params, self.cache, self.rope, self.config)
        return self._prefill_runner

    def _draft_dense_prefill_runner(self) -> DensePrefillRunner:
        """The dense spec engine's draft prefill: JAX's same jitted
        `prefill_slot` over the draft's params and cache."""
        if self._draft_prefill_runner is None:
            self._draft_prefill_runner = self._new_dense_prefill_runner(
                self.draft_params, self.d_cache, self.d_rope,
                self.draft_config)
        return self._draft_prefill_runner

    def _new_dense_prefill_runner(self, params, cache, rope, config):
        fns = None
        if self._custom_steps and params is self.params:
            slot_fn, _, _, chunk_fn = self._step_fns
            fns = {"slot": slot_fn, "chunk": chunk_fn, "ring": chunk_fn}
        return DensePrefillRunner(
            params, cache, rope, config, pool=self._graph_pool,
            on_capture=self._captured(DENSE_PREFILL_FNS), fns=fns,
            device=self.device)

    def _host_row(self, slot: int) -> torch.Tensor:
        """Slot `slot`'s table row on the host, from its page list (the
        write targets are computed from it, with no wait)."""
        pages = self._slot_pages[slot]
        row = torch.full((self.cache.max_pages,), -1, dtype=torch.int32)
        row[:len(pages)] = torch.tensor(list(pages), dtype=torch.int32)
        return row

    def _prefill_raw(self, ids, slot: int):
        """Whole-prompt prefill of the prompt's bucket (the captured
        `prefill_slot_paged` of that bucket). Returns the runner's
        logits buffer."""
        # a windowed layout pads every prompt to its window (the sp slot
        # prefill's one shape: one captured step)
        bucket = (self.prompt_limit if self.prompt_limit is not None
                  else bucket_length(len(ids), self.max_seq_len))
        padded = list(ids) + [0] * (bucket - len(ids))
        if not self.paged:
            logits = self._dense_prefill_runner().run(
                ("slot", bucket), padded, len(ids), slot)
            if self._spec:
                # the draft's KV must cover the prompt too (its proposals
                # attend the positions the target verifies)
                self._draft_dense_prefill_runner().run(
                    ("slot", bucket), padded, len(ids), slot)
            return logits
        targets = fixed_prompt_targets(self._host_row(slot), bucket,
                                       self.cache.page_size,
                                       self.cache.n_pages)
        return self._prefill_step_runner().run(
            ("slot", bucket), padded, len(ids), slot, 0, targets)

    def _prefill_chunked(self, ids: List[int], slot: int, C: int,
                         pos0: int = 0):
        """Walk a prompt (or a prefix hit's suffix, from absolute
        position pos0) through the slot's pages in C-token windows (the
        captured `prefill_slot_paged_chunk`, one replay a window)."""
        if not self.paged:
            runner = self._dense_prefill_runner()
            kind = "ring" if self.ring else "chunk"
            logits = None
            for window, n_real, start in chunk_windows(ids, C):
                logits = runner.run((kind, C), window, n_real, slot,
                                    pos0 + start)
            return logits
        runner = self._prefill_step_runner()
        row = self._host_row(slot)
        logits = None
        for window, n_real, start in chunk_windows(ids, C):
            targets = chunk_write_targets(self.cache, pos0 + start, C,
                                          n_real, row)
            logits = runner.run(("chunk", C), window, n_real, slot,
                                pos0 + start, targets)
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
        if not self.paged:
            # the registered head's KV goes into the slot's positions
            # 0..P-1, then the suffix prefills after it: one program, or
            # an install and the suffix's windows
            P = len(p_ids)
            runner = self._dense_prefill_runner()
            if self._custom_steps:
                # the sharded prefix's lines into the slot (eager copies;
                # JAX's install is its own small program), then the
                # suffix's windows through the pipelined chunk step
                install_prefix_sharded(self.cache, entry[1], slot)
                logits = self._prefill_chunked(suffix, slot, width, pos0=P)
            elif chunk_suffix:
                runner.run(("install", P), slot=slot, prefix=entry[1])
                logits = self._prefill_chunked(suffix, slot, width, pos0=P)
            else:
                padded = suffix + [0] * (width - len(suffix))
                logits = runner.run(("prefixed", P, width), padded,
                                    len(suffix), slot, prefix=entry[1])
            return self._finish_prefill(logits, slot, len(ids), req, n_top,
                                        prime)
        if chunk_suffix:
            logits = self._prefill_chunked(suffix, slot, width,
                                           pos0=len(p_ids))
        else:
            padded = suffix + [0] * (width - len(suffix))
            P = self.cache.page_size
            targets = fixed_prompt_targets(
                self._host_row(slot)[len(p_ids) // P:], width, P,
                self.cache.n_pages)
            logits = self._prefill_step_runner().run(
                ("prefixed", len(p_ids), width), padded, len(suffix), slot,
                0, targets)
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
            # the paged forward, or the dense engine's ragged forward
            # over its cache (modular over a ring)
            fwd = (functools.partial(forward_ragged_paged,
                                     attn=self.paged_attn) if self.paged
                   else forward_ragged_ring if self.ring else forward_ragged)
            if self._custom_steps:
                # the scan variant (the ragged forward replayed K times a
                # burst), else the single step in the forward's order
                fwd = self._step_fns[2] or _decode_as_forward(
                    self._step_fns[1])
            self._runner = DecodeRunner(
                self.params, self.cache, self.rope, self.config,
                forward_fn=fwd, ring=self._ring, seeds=self._seeds,
                counters=self._counters, max_steps=self._decode_scan,
                n_top_cap=self.n_top, top_k=self.defaults.top_k,
                pool=self._graph_pool,
                on_capture=self._captured("decode_scan"))
        return self._runner

    @engine_thread_only
    def _dispatch_scan(self, rows, n: int, n_top: int, budget,
                       fresh: bool):
        """Dispatch n decode steps of the runner (no fetch). fresh: load
        the carry from the host mirrors; otherwise chain from the
        previous burst's carry on the device."""
        if self._control is not None:
            op = {"op": "decode" if n == 1 and fresh else "decode_scan",
                  "rows": [int(r) for r in rows], "n": n, "n_top": n_top,
                  "budget": [int(b) for b in budget]}
            if fresh:
                # what the fresh load reads from the host mirrors: the
                # follower keeps no mirrors of its own
                op["carry"] = {
                    "tok": self._last_tok.tolist(),
                    "pos": self._pos.tolist(),
                    "steps": self._steps.tolist(),
                    "temp": self._temp.tolist(),
                    "top_p": self._top_p.tolist(),
                    "penalty": self._penalty.tolist()}
            self._publish(op)
        runner = self._decode_runner()
        if fresh:
            live = np.zeros(self.max_slots, bool)
            live[rows] = True
            runner.load(n_top, self._last_tok,
                        np.minimum(self._pos, self.max_seq_len - 1), live,
                        self._steps, self._temp, self._top_p,
                        self._penalty)
        return runner.run(n, budget, n_top)

    @engine_thread_only
    def _do_decode(self, decode_plan) -> None:
        """One decode step of every planned row (a burst of one)."""
        t0 = time.perf_counter()
        self._implicated = decode_plan
        if self._faults is not None:
            self._faults.check("engine.decode", step=self.stats.steps)
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

    def _drive_burst(self, dispatch, complete, can_chain,
                     first_unconditional: bool = False) -> None:
        """The double-buffered dispatch/fetch loop: dispatch burst k+1
        (chained from k's carry on the device) BEFORE completing k, so
        k's copy to the host and its emits overlap k+1's device work.
        dispatch(state) -> (devs, state'); complete(devs) fetches and
        emits one burst; can_chain(n_inflight) gates a dispatch after
        the host-attention gate. first_unconditional: one dispatch
        whatever the gates say (the spec burst, whose planning loop has
        no other progress path with full slots and a waiting queue)."""
        inflight: list = []
        state = None
        first = first_unconditional
        while True:
            chain = first or (not self._host_attention_pending()
                              and can_chain(len(inflight)))
            first = False
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
        self._implicated = decode_plan
        if self._faults is not None:
            self._faults.check("engine.decode", step=self.stats.steps)
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

    # -- the dense spec engine (--draft-model behind --api) ---------------------

    def _dense_spec_runner(self) -> DenseSpecRunner:
        """The captured dense round (serve/graphs.DenseSpecRunner), one
        graph per gamma, each capture counted as a compile of
        spec_round_batched."""
        if self._spec_runner is None:
            self._spec_runner = DenseSpecRunner(
                self.params, self.draft_params, self.cache, self.d_cache,
                self.rope, self.d_rope, self.config, self.draft_config,
                seeds=self._seeds, counters=self._counters,
                max_gamma=self.spec_gamma, pool=self._graph_pool,
                on_capture=self._captured("spec_round_batched"))
        return self._spec_runner

    @engine_thread_only
    def _do_decode_spec(self, decode_plan) -> None:
        """One propose-verify-accept round for ALL planned slots in one
        captured program (speculative.spec_round_batched): batched ragged
        draft steps and one windowed verify, so the weights stream once a
        round. Rounds chain on the device (the runner's carry) in
        double-buffered bursts while nothing needs the host, JAX's
        `_do_decode_spec` rules: a row that cannot take another round
        before the window's end is finished at the cap; a chained round
        past a row's EOS or budget computes junk the emit loop drops."""
        self._implicated = decode_plan
        if self._faults is not None:
            self._faults.check("engine.decode", step=self.stats.steps)
        t0 = time.perf_counter()
        g = self.spec_gamma
        plan = []
        for rid, slot in decode_plan:
            req = self._slot_req[slot]
            if req is None:
                continue
            if self._pos[slot] + g + 1 >= self.max_seq_len:
                # the round writes g + 1 positions; too close to the
                # window's end, finish at the cap
                self._force_finish(req)
                continue
            plan.append((req, slot))
        if not plan:
            self.stats.decode_time_s += time.perf_counter() - t0
            return
        active = np.zeros(self.max_slots, bool)
        active[[s for _, s in plan]] = True
        runner = self._dense_spec_runner()

        def dispatch(state):
            if state is None:
                runner.load(self._last_tok,
                            np.minimum(self._pos, self.max_seq_len - 1),
                            active, self._temp)
            t0d = time.perf_counter()
            handle = runner.run(g)
            disp = time.perf_counter() - t0d
            return (handle, disp, self._took_capture(),
                    [(int(self._pos[s]), s) for _, s in plan]), True

        def complete(devs):
            handle, disp_k, compiled, pos_rows = devs
            t0f = time.perf_counter()
            out_h, n_emit_h = SpecRunner.fetch(handle)
            fetch = time.perf_counter() - t0f
            round_tokens = 0
            for req, slot in plan:
                if req.done.is_set():
                    # a round chained before this row's EOS or budget end
                    # was known: its junk (and its stats) are dropped
                    continue
                n = int(n_emit_h[slot])
                round_tokens += n
                toks = [int(t) for t in out_h[slot, :n]]
                self.stats.spec_proposed += g
                self.stats.spec_accepted += n - 1
                pos0 = int(self._pos[slot])
                self._last_tok[slot] = toks[-1]
                self._steps[slot] += n
                for j, tok in enumerate(toks):
                    # per-token position, so _emit's cap check sees what
                    # a single-step loop would
                    self._pos[slot] = pos0 + j + 1
                    self._emit(req, tok)
                    if req.done.is_set():
                        break   # EOS / budget mid-round: the tail drops
                # the next round's frontier: the round wrote n accepted
                # positions whatever the emission budget
                self._pos[slot] = pos0 + n
            self.stats.steps += 1
            self._record("spec", rows=len(plan), tokens=round_tokens,
                         cost=self._spec_cost(pos_rows, g),
                         wall_s=disp_k + fetch, dispatch_s=disp_k,
                         timing=handle.timing, compiled=compiled,
                         rids=[req.rid for req, _s in plan])

        # the window guard projects the device frontier by the worst case
        # (g + 1 a round in flight); the first round is unconditional:
        # every planned row has room for one (the cap finish above)
        def can_chain(n_inflight: int) -> bool:
            return (all(not req.done.is_set()
                        and (req.max_new_tokens - len(req.out_tokens)
                             - n_inflight * (g + 1)) > 0
                        for req, _ in plan)
                    and all(self._pos[s] + (n_inflight + 1) * (g + 1)
                            < self.max_seq_len for _, s in plan))

        self._drive_burst(dispatch, complete, can_chain,
                          first_unconditional=True)
        self.stats.decode_time_s += time.perf_counter() - t0

    def _force_finish(self, req: _Request) -> None:
        """Finish a request that cannot take another token (the spec
        round's window cap): the _emit finish tail, minus the token."""
        self.scheduler.report(req.rid, 0, True)
        req.finish_t = time.perf_counter()
        if req.slot >= 0 and self._slot_req[req.slot] is req:
            self._slot_req[req.slot] = None
        self._requests.pop(req.rid, None)
        if self._shed is not None:
            self._shed.observe_retire()
        self.stats.requests_completed += 1
        self._journal_retire(req, "retired")
        self.tracer.finish(req.rid, "retired",
                           output_tokens=len(req.out_tokens))
        if req.stream is not None:
            try:
                delta = self._incremental_text(req, final=True)
                if req.stream_wants_count:
                    req.stream(delta, True, len(req.out_tokens))
                else:
                    req.stream(delta, True)
            except Exception:  # noqa: BLE001
                log.exception("stream callback failed rid=%d", req.rid)
        self.retired.append(req)
        req.done.set()

    # -- paged speculative decoding (spec/) ------------------------------------

    @engine_thread_only
    def _do_spec_paged(self, decode_plan):
        """One batched draft+verify round over the paged pools for this
        iteration's spec-ready decode rows; returns the rows the round
        did not cover (the plain decode paths take them). Page
        discipline per row and round: both table rows are extended to
        cover pos..pos+gamma before the round (it writes gamma + 1
        positions in each pool; a write past the mapped pages lands on
        the sink, which would lose an accepted position's KV), then
        truncated back to the accepted frontier after the fetch, so
        `free_pages + live_pages == n_pages` holds again when this
        returns. The extension, the dispatch and the truncation wait for
        nothing on the stream; the fetch of (out, n_emit) is the round's
        one sync (JAX's single device_get)."""
        if self._specp is None:
            return decode_plan
        sp = self._specp
        g = sp.live_gamma
        spec_rows, plain = [], []
        for rid, slot in decode_plan:
            (spec_rows if self._spec_row_ready(rid, slot, g)
             else plain).append((rid, slot))
        if not spec_rows:
            return plain
        t0 = time.perf_counter()
        plan = []
        for rid, slot in spec_rows:
            if self._spec_extend_rows(slot, g):
                plan.append((self._slot_req[slot], slot))
            else:
                # pool pressure: the row decodes plain this iteration
                plain.append((rid, slot))
        if not plan:
            self.stats.decode_time_s += time.perf_counter() - t0
            return plain
        if self._faults is not None:
            # the verify pass's chaos site: an injected fault is
            # absorbed here (the rows' acceptance charged, their
            # extensions truncated, repeat offenders degraded, the rows
            # decode plain this iteration); a real dispatch error below
            # goes to recovery with the round's rows implicated
            try:
                self._faults.check("spec.verify", step=self.stats.steps)
            except InjectedFault as exc:
                self._spec_verify_failed(plan, g, exc)
                self.stats.decode_time_s += time.perf_counter() - t0
                return plain + [(req.rid, s) for req, s in plan]
        self._implicated = tuple((req.rid, s) for req, s in plan)
        active = np.zeros(self.max_slots, bool)
        for _req, slot in plan:
            active[slot] = True
        pos_rows = [(int(self._pos[s]), s) for _req, s in plan]
        t0d = time.perf_counter()
        handle = self._spec_round_runner().run(
            g, self._last_tok, np.minimum(self._pos, self.max_seq_len - 1),
            active, self._temp)
        disp = time.perf_counter() - t0d
        out_h, n_emit_h = SpecRunner.fetch(handle)
        wall = time.perf_counter() - t0d
        round_tokens = proposed = accepted = 0
        for req, slot in plan:
            if req.done.is_set():
                continue
            n = int(n_emit_h[slot])
            round_tokens += n
            proposed += g
            accepted += n - 1
            self.stats.spec_proposed += g
            self.stats.spec_accepted += n - 1
            pos0 = int(self._pos[slot])
            toks = [int(t) for t in out_h[slot, :n]]
            self._last_tok[slot] = toks[-1]
            self._steps[slot] += n
            for j, tok in enumerate(toks):
                # per-token position, so _emit's cap check sees the value
                # a single-step loop would have had
                self._pos[slot] = pos0 + j + 1
                self._emit(req, tok)
                if req.done.is_set():
                    break       # EOS / budget mid-round: the tail dropped
            # the cache frontier: the round wrote n accepted positions
            # whatever the emission budget took
            self._pos[slot] = pos0 + n
            # a finished row's teardown already released its spec state;
            # a live row folds the round into its controller signal and
            # gives the unaccepted suffix pages back
            st = sp.spec_streams.get(slot)
            if st is not None and st.enabled:
                st.verify_fails = 0
                st.note_round(g, n - 1)
                self._spec_truncate(slot)
                if (st.rounds >= STREAM_WARMUP_ROUNDS
                        and (st.accept_ema or 0.0) < STREAM_ACCEPT_FLOOR):
                    self._spec_disable(req, slot, "acceptance_collapse")
        self.stats.steps += 1
        sp.note_round(proposed, accepted, round_tokens, len(plan))
        if sp.tuner is not None:
            ng = sp.tuner.maybe_shrink()
            if ng is not None and ng < sp.live_gamma:
                sp.live_gamma = ng
                SPEC_DEGRADED.labels(action="shrink_gamma").inc()
                log.warning("spec: acceptance EMA %.2f below the tuner's "
                            "threshold: gamma shrunk to %d",
                            sp.accept_ema or 0.0, ng)
                if self.events is not None:
                    self.events.publish(
                        "spec_degraded", action="shrink_gamma", gamma=ng,
                        accept_ema=sp.accept_ema)
        if self.events is not None:
            self.events.publish("spec_round", rows=len(plan),
                                proposed=proposed, accepted=accepted,
                                tokens=round_tokens, gamma=g)
        self._record("spec", rows=len(plan), tokens=round_tokens,
                     cost=self._spec_cost(pos_rows, g), wall_s=wall,
                     dispatch_s=disp, timing=handle.timing,
                     compiled=self._took_capture(),
                     rids=[req.rid for req, _s in plan])
        self.stats.decode_time_s += time.perf_counter() - t0
        return plain

    def _spec_cost(self, pos_rows, g: int) -> obs_steps.CostInfo:
        """A round's counted FLOPs and bytes (obs/steps.step_cost): gamma
        + 1 draft decode steps of every row over the draft's weights and
        pool, plus one verify window of gamma + 1 tokens a row with
        logits at every position over the target's."""
        rows, dc = len(pos_rows), self.d_cache
        if self._specp is not None:
            d_cfg, span = self._specp.draft_config, None
            d_kv = dc.memory_bytes() / ((dc.n_pages + 1) * dc.page_size)
        else:   # the dense spec engine's draft cache
            d_cfg, span = self.draft_config, dc.max_seq_len
            d_kv = dc.memory_bytes() / (self.max_slots * dc.max_seq_len)
        draft = obs_steps.step_cost(
            d_cfg, "spec", rows, rows * (g + 1),
            [(p + j, 1) for p, _s in pos_rows for j in range(g + 1)],
            emit_rows=rows * (g + 1), passes=g + 1,
            weight_bytes=self._d_weight_bytes,
            embed_row_bytes=self._d_embed_row_bytes,
            kv_bytes_per_token=d_kv, kv_span=span)
        verify = self._cost("spec", rows, rows * (g + 1),
                            [(p, g + 1) for p, _s in pos_rows],
                            emit_rows=rows * (g + 1))
        return obs_steps.CostInfo(
            flops=draft.flops + verify.flops,
            bytes_accessed=draft.bytes_accessed + verify.bytes_accessed)

    def _spec_round_runner(self) -> SpecRunner:
        """The captured round (serve/graphs.SpecRunner), one graph per
        gamma, each capture counted as a compile of spec_round_paged."""
        if self._spec_runner is None:
            sp = self._specp
            self._spec_runner = SpecRunner(
                self.params, sp.draft_params, self.cache, self.d_cache,
                self.rope, sp.rope, self.config, sp.draft_config,
                attn=self.paged_attn, seeds=self._seeds,
                counters=self._counters, max_gamma=sp.gamma0,
                pool=self._graph_pool,
                on_capture=self._captured("spec_round_paged"))
        return self._spec_runner

    def _draft_prefill_step_runner(self) -> PrefillRunner:
        """The draft's captured one-slot prefill over the draft pool, one
        graph per bucket, counted as spec_draft_prefill."""
        if self._draft_prefill_runner is None:
            sp = self._specp
            self._draft_prefill_runner = PrefillRunner(
                sp.draft_params, self.d_cache, sp.rope, sp.draft_config,
                attn=self.paged_attn, pool=self._graph_pool,
                on_capture=self._captured("spec_draft_prefill"))
        return self._draft_prefill_runner

    def _spec_row_ready(self, rid: int, slot: int, g: int) -> bool:
        """Does this decode row ride this iteration's round?
        Temperature-only sampling (top-p, repeat-penalty and top-logprobs
        rows decode plain), window room for a whole round, at least one
        emitted token (last_tok's KV unwritten at the frontier), and an
        enabled SpecState, activated here at the row's first chance
        whatever path brought it to its frontier."""
        if self._specp is None:
            return False
        req = self._slot_req[slot]
        if req is None or req.rid != rid or req.done.is_set():
            return False
        if not req.out_tokens:
            return False
        if req.top_p < 1.0 or req.repeat_penalty != 1.0 or req.want_top:
            return False
        if self._pos[slot] + g + 1 >= self.max_seq_len:
            # too close to the window: the plain path finishes the row
            return False
        st = self._specp.spec_streams.get(slot)
        if st is not None and st.rid != req.rid:
            # a slot reused without the teardown hook must not speculate
            # against a stale draft row
            self._release_spec_state(slot)
            st = None
        if st is None:
            return self._spec_activate(req, slot)
        return st.enabled

    def _spec_activate(self, req: _Request, slot: int) -> bool:
        """Opt a decoding stream into speculation: the draft row's
        context pages from the shared allocator and one whole-context
        draft prefill (the captured `prefill_slot_paged` of its bucket
        over the draft params and pool), leaving the draft pool with KV
        for positions 0..pos-1, the round's contract. Best-effort: a
        shortfall keeps the row plain (False)."""
        if self._specp is None:
            return False
        pos = int(self._pos[slot])
        ctx = (list(req.prompt_ids) + list(req.out_tokens))[:pos]
        if len(ctx) != pos:
            return False    # frontier and transcript disagree: stay plain
        d_pages = self._pager.alloc(len(ctx))
        if d_pages is None:
            return False    # pool pressure: retry on a later iteration
        self._specp.spec_streams[slot] = SpecState(rid=req.rid,
                                                   d_pages=d_pages)
        table_set_slot(self.d_cache.table, slot, d_pages)
        bucket = bucket_length(len(ctx), self.max_seq_len)
        row = torch.full((self.d_cache.max_pages,), -1, dtype=torch.int32)
        row[:len(d_pages)] = torch.tensor(d_pages, dtype=torch.int32)
        targets = fixed_prompt_targets(row, bucket, self.d_cache.page_size,
                                       self.d_cache.n_pages)
        self._draft_prefill_step_runner().run(
            ("slot", bucket), ctx + [0] * (bucket - len(ctx)), len(ctx),
            slot, 0, targets)
        return True

    def _spec_extend_rows(self, slot: int, g: int) -> bool:
        """Both table rows cover positions pos..pos+gamma before the
        round: the draft row (its SpecState's one list) and the target
        row (the admission's base row, untouched, plus the state's
        suffix pages). False = the pool cannot cover the round; what was
        extended stays until the truncation or the teardown."""
        if self._specp is None:
            return False
        st = self._specp.spec_streams[slot]
        ps = self.cache.page_size
        cover = int(self._pos[slot]) + g + 1
        if cover > len(st.d_pages) * ps:
            extra = self._pager.alloc(cover - len(st.d_pages) * ps)
            if extra is None:
                return False
            st.d_pages = st.d_pages + extra
            table_set_slot(self.d_cache.table, slot, st.d_pages)
        base = self._slot_row_pages(slot)
        have = (len(base) + len(st.t_suffix_pages)) * ps
        if cover > have:
            extra = self._pager.alloc(cover - have)
            if extra is None:
                return False
            st.t_suffix_pages = st.t_suffix_pages + extra
            table_set_slot(self.cache.table, slot, base + st.t_suffix_pages)
        return True

    def _slot_row_pages(self, slot: int) -> list:
        """A slot's base target row (shared prefix pages and its own
        admission pages, in table order): the part spec never owns."""
        return list(self._slot_pages.get(slot, []))

    def _spec_truncate(self, slot: int) -> None:
        """Give back every speculative page past the accepted frontier:
        the draft row shrinks to its context, the target row to what its
        base allocation does not already cover, and the shrunk rows are
        mapped again."""
        if self._specp is None:
            return
        st = self._specp.spec_streams.get(slot)
        if st is None:
            return
        need = self._pager.pages_for(int(self._pos[slot]))
        keep = max(need, 1)      # a decoding row always keeps a page
        if keep < len(st.d_pages):
            self._pager.release(st.d_pages[keep:])
            st.d_pages = st.d_pages[:keep]
            table_set_slot(self.d_cache.table, slot, st.d_pages)
        base = self._slot_row_pages(slot)
        keep_sfx = max(need - len(base), 0)
        if keep_sfx < len(st.t_suffix_pages):
            self._pager.release(st.t_suffix_pages[keep_sfx:])
            st.t_suffix_pages = st.t_suffix_pages[:keep_sfx]
            table_set_slot(self.cache.table, slot, base + st.t_suffix_pages)

    def _spec_disable(self, req: _Request, slot: int, reason: str) -> None:
        """Degrade one stream to plain decode, never wedging it: every
        speculative page back to the pool, a disabled tombstone so the
        stream is not activated again, and the degrade published."""
        if self._specp is None:
            return
        st = self._specp.spec_streams.get(slot)
        if st is None or not st.enabled:
            return
        if st.d_pages:
            self._pager.release(st.d_pages)
            st.d_pages = []
            table_set_slot(self.d_cache.table, slot, [])
        if st.t_suffix_pages:
            self._pager.release(st.t_suffix_pages)
            st.t_suffix_pages = []
            table_set_slot(self.cache.table, slot,
                           self._slot_row_pages(slot))
        st.enabled = False
        SPEC_DEGRADED.labels(action="disabled").inc()
        log.warning("spec: rid=%d degraded to plain decode (%s, "
                    "accept_ema=%.2f after %d rounds)", req.rid, reason,
                    st.accept_ema or 0.0, st.rounds)
        if self.events is not None:
            self.events.publish("spec_degraded", rid=req.rid,
                                action="disabled", reason=reason,
                                accept_ema=st.accept_ema, rounds=st.rounds)

    def _spec_verify_failed(self, plan, g: int, exc) -> None:
        """An injected spec.verify fault: a zero-acceptance round charged
        to every planned row (the controller sees collapse, not
        silence), their extensions truncated back, repeat offenders
        disabled; the rows finish on the plain path either way."""
        if self._specp is None:
            return
        log.warning("spec.verify fault (%s): %d rows decode plain this "
                    "iteration", exc, len(plan))
        for req, slot in plan:
            st = self._specp.spec_streams.get(slot)
            if st is None or not st.enabled:
                continue
            st.verify_fails += 1
            st.note_round(g, 0)
            self._spec_truncate(slot)
            if st.verify_fails >= DISABLE_AFTER_FAILS:
                self._spec_disable(req, slot, "verify_faults")
        self._specp.note_round(g * len(plan), 0, 0, len(plan))
        if self.events is not None:
            self.events.publish("spec_round", rows=len(plan),
                                proposed=g * len(plan), accepted=0,
                                tokens=0, gamma=g, fault=True)

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
        if req.crash_count:
            # a step that emits for the request succeeded: its crash
            # implication is no longer consecutive
            req.crash_count = 0
        if self._journal is not None:
            # buffered: one emit record per (request, iteration) at the
            # run loop's flush; the count is absolute (replayed tokens
            # of earlier generations included), the SSE event id
            self._journal.note_emit(
                req.rid, token_id,
                len(req.replayed_tokens) + len(req.out_tokens))
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
            if req.ship_sink is not None:
                # disaggregated prefill engine: fetch the slot's written
                # pages BEFORE the release frees them; the sink queues
                # the shipment for the transfer channel's writer thread
                self._capture_shipment(req)
            self._slot_req[req.slot] = None
            self._release_slot_pages(req.slot)
            # the key moves to the done ring before the request leaves the
            # registry: a retry in between must find one or the other
            self._journal_retire(req, "retired")
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

    def _fail_all(self, err: Exception, snapshot: bool = False) -> None:
        """Fail every in-flight request with the typed error (retryable
        unless it says otherwise). snapshot: a fatal failure (a lost
        follower, serving/health.py) first writes the pre-fail snapshot
        of the requests, so a restarted pair resumes them. The registry
        is claimed under _ckpt_lock (a pre-fail snapshot and a shutdown
        may race), the teardown runs outside it."""
        err = as_engine_error(err)
        with self._ckpt_lock:
            if snapshot:
                self._snapshot_before_fail()
            doomed = []
            for rid in list(self._requests):
                req = self._requests.pop(rid, None)
                if req is not None:
                    doomed.append((rid, req))
        for rid, req in doomed:
            req.error = err
            self.scheduler.cancel(rid)
            with self._rid_lock:
                self._adopt_store.pop(rid, None)
            if self._host_tier is not None:
                self._host_tier.drop(("victim", rid))
            if req.slot >= 0:
                # cakelint: skip[affinity] fatal path: the engine thread is wedged or has exited; cross-thread teardown is deliberate
                self._slot_req[req.slot] = None
                self._release_slot_pages(req.slot)
            self._journal_retire(req, "error", error=str(err))
            self.tracer.finish(rid, "error", error=str(err),
                               output_tokens=len(req.out_tokens))
            req.done.set()

    # -- per-request explain (obs/timeline.py) ----------------------------------

    def request_timeline(self, rid: int) -> Optional[dict]:
        """GET /api/v1/requests/{rid}/timeline: one merged, time-ordered
        view of the request's trace spans, its event-bus events and the
        step records whose batch contained it, so a slow TTFT reads as
        its causes (preempted twice, a prefix spilled then restored,
        folded by a config switch, ...). None when the rid is unknown
        (never admitted, or out of the finished ring): the API's 404.
        With a fleet collector (`telemetry`), its remote events for the
        rid join, tagged with their origin host and clock-offset
        corrected, so a request that prefilled on one host and decoded on
        another reads as one chronology."""
        from cake_tpu_torch.obs.timeline import build_timeline
        trace = self.tracer.get(rid)
        if trace is None:
            return None
        events = (self.events.dump(rid=rid)
                  if self.events is not None else [])
        local_host = None
        if self.telemetry is not None:
            local_host = getattr(self.telemetry, "local_host", None)
            try:
                events = events + self.telemetry.events_for(rid=rid)
            except Exception:  # noqa: BLE001 — explain must not fail
                log.debug("remote event merge failed", exc_info=True)
        return build_timeline(trace, events, self.flight.records_for(rid),
                              local_host=local_host)

    # -- live reconfiguration (autotune/) ---------------------------------------

    def _reconfig_supported(self) -> bool:
        return (not self._custom_steps and not self.ring and not self._spec
                and self._specp is None)

    def _reconfig_refusal(self) -> str:
        if self._spec:
            return ("speculative serving has no hot-switch fold (the "
                    "draft cache cannot be rebuilt mid-round)")
        if self._specp is not None:
            return ("paged speculative serving has no hot-switch fold "
                    "(the draft pool shares the page allocator a switch "
                    "would swap wholesale)")
        if self.ring:
            return ("ring (sliding-window) caches own their layout; a "
                    "rebuilt ring cannot replay folded positions")
        if self._multihost:
            return ("multi-host serving replays a fixed op stream; "
                    "followers cannot rebuild mid-stream")
        return ("custom step fns own their cache contract; only the "
                "built-in dense/paged engines can hot-switch")

    def current_config(self):
        """The LIVE effective engine config as an autotune point
        (autotune/space.EngineConfig): what /api/v1/health and
        GET /api/v1/autotune report. The storage name is reported only
        when it differs from what an unset --kv-dtype resolves to, so a
        policy config omitting kv_dtype compares equal."""
        from cake_tpu_torch.autotune.space import EngineConfig
        kv_dtype = None
        if self.paged and (self.kv_quant
                           or self._pool_dtype != self._base_cache_dtype):
            kv_dtype = self._kv_dtype_name
        # cakelint: skip[affinity] taking _admit_lock here would invert the declared order: checkpoint.snapshot calls this under _ckpt_lock (shutdown_save/_snapshot_before_fail); the unlocked read tolerates a torn value mid-switch (informational health/snapshot metadata only)
        pager = self._pager if self.paged else None
        return EngineConfig(
            slots=self.max_slots,
            decode_scan=self._decode_scan,
            kv_pages=pager.n_pages if pager is not None else None,
            kv_page_size=pager.page_size if pager is not None else 128,
            kv_dtype=kv_dtype,
            mixed_batch="on" if self._mixed else "off",
            paged_attn=self.paged_attn or "auto")

    def reconfigure(self, config, reason: str = "manual") -> bool:
        """Hot-switch the engine to a new EngineConfig under live load:
        every in-flight request folds its generated tokens into its
        prompt (the recovery resubmit minus backoff and implication),
        the pool and its graphs are dropped and rebuilt under the new
        knobs, and everything requeues with seniority, class and
        preemption budget kept. Greedy streams finish token-identical at
        f32 KV across the switch, shared-prefix slots included.

        Thread-safe: routed onto the engine thread between iterations
        when the engine runs; a concurrent switch raises
        SwitchInFlightError (the API's 409). An invalid or refused
        config, or a rebuild that failed and restored the previous
        config, raises ValueError (the API's 400). Returns True when a
        switch happened, False for a no-op (already at `config`)."""
        from cake_tpu_torch.autotune.space import EngineConfig
        from cake_tpu_torch.serve.errors import SwitchInFlightError
        cfg = (config if isinstance(config, EngineConfig)
               else EngineConfig.from_dict(dict(config)))
        if (self._thread is not None and self._thread.is_alive()
                and threading.current_thread() is not self._thread):
            with self._switch_lock:
                if self._switch_inflight:
                    raise SwitchInFlightError(
                        "a config switch is already in flight")
                self._switch_inflight = True
            try:
                return self._run_on_engine_thread(
                    lambda: self._reconfigure_sync(cfg, reason))
            finally:
                with self._switch_lock:
                    self._switch_inflight = False
        # cakelint: skip[affinity] engine thread not running, or this IS the engine thread (autotune tick); runtime assert distinguishes
        return self._reconfigure_sync(cfg, reason)

    def _config_key(self, cfg) -> tuple:
        """The comparison key as this engine resolves it: an unset
        kv_dtype is the base cache dtype, "auto" the device's impl."""
        from cake_tpu_torch.autotune.space import config_key
        return config_key(
            cfg, default_kv_dtype=str(self._base_cache_dtype).replace(
                "torch.", ""), device=self.device)

    @engine_thread_only
    def _reconfigure_sync(self, new, reason: str) -> bool:
        """The engine-thread body of reconfigure(), between iterations."""
        from cake_tpu_torch.autotune import (
            SWITCH_SECONDS, SWITCHES, set_config_info,
        )
        from cake_tpu_torch.autotune.space import (
            switch_guard, validate_config,
        )
        cur = self.current_config()
        if self._config_key(new) == self._config_key(cur):
            return False
        if not self._reconfig_supported():
            raise ValueError("live reconfiguration is unavailable: "
                             + self._reconfig_refusal())
        guard = switch_guard(cur, new)
        if guard is not None:
            raise ValueError(guard)
        validate_config(new, max_seq_len=self.max_seq_len)
        if new.paged:
            self._check_attn(resolve_paged_attn(new.paged_attn,
                                                self.device))
        t0 = time.perf_counter()
        # the whole mutation runs under _admit_lock, the lock submit()
        # registers under: an admission lands fully before this switch
        # (fit-checked below and carried) or fully after it (checked
        # against the NEW pool), never half-registered across the swap
        with self._admit_lock:
            # ZERO dropped streams: refuse a pool an in-flight request
            # does not fit (the bound submit() enforces at admission)
            per = new.kv_page_size
            for req in list(self._requests.values()):
                if req.done.is_set() or not new.paged:
                    continue
                need = -(-(len(req.prompt_ids) + req.max_new_tokens)
                         // per)
                if need > new.kv_pages:
                    raise ValueError(
                        f"refusing switch: rid={req.rid} needs {need} kv "
                        f"pages, the proposed pool has {new.kv_pages} (no "
                        "stream may be dropped)")
            self._quiesce()
            folded = self._prepare_fold(new)
            applied, apply_err = new, None
            try:
                self._apply_exec_config(new)
            except Exception as e:  # noqa: BLE001 — e.g. the new pool
                # does not fit the card after the old one was freed:
                # restore the OLD geometry (an empty pool: the folded
                # streams re-prefill from token ids either way) instead
                # of leaving the engine poolless
                log.exception("reconfigure rebuild failed; restoring the "
                              "previous config")
                # the frames hold whatever the failed rebuild allocated
                traceback.clear_frames(e.__traceback__)
                applied, apply_err = cur, e
                self._apply_exec_config(cur)
            carried = self._requeue_folded(applied, folded)
        if apply_err is not None:
            self._wake.set()
            raise ValueError(
                f"switch to {new.to_dict()} failed; previous config "
                f"restored with {carried} stream(s) requeued: "
                f"{type(apply_err).__name__}: {apply_err}") from apply_err
        self.config_epoch += 1
        self.stats.config_switches += 1
        dt = time.perf_counter() - t0
        SWITCHES.labels(reason=reason).inc()
        SWITCH_SECONDS.observe(dt)
        set_config_info(self.current_config())
        self._switch_log.append({
            "t": round(time.time(), 3), "reason": reason,
            "from": cur.to_dict(), "to": new.to_dict(),
            "seconds": round(dt, 4), "carried": carried,
            "epoch": self.config_epoch})
        if self.events is not None:
            # the engine-level summary beside the per-request events
            self.events.publish("reconfigured", reason=reason,
                                epoch=self.config_epoch, carried=carried,
                                seconds=round(dt, 4), to=new.to_dict())
        if self._autotuner is not None and reason == "manual":
            # keep the controller's "current" in step with an operator's
            # switch; a manual reason never arms the rollback guard
            self._autotuner.on_switched(
                new, cur, self._autotuner.window_service_tps(), reason)
        log.warning("engine reconfigured (%s) in %.3fs: %s -> %s, %d "
                    "stream(s) carried (epoch %d)", reason, dt,
                    cur.to_dict(), new.to_dict(), carried,
                    self.config_epoch)
        self._wake.set()
        return True

    def _quiesce(self) -> None:
        """Nothing of the old config may still run when its pool goes: a
        chained --decode-scan burst or a chunk-only mixed step may still
        be on the stream, so wait for it, then record the mixed steps
        dispatched and not yet counted."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._count_mixed_time()

    def _storage_name(self) -> str:
        """The LIVE pool's storage name ("int8"/"int4", else the dtype's
        name): the identity a host-tier entry's raw slices are bound to."""
        if self.kv_quant:
            return self._kv_dtype_name
        return str(self._pool_dtype).replace("torch.", "")

    def _target_storage_name(self, new) -> str:
        """What _apply_exec_config resolves `new`'s storage to."""
        if new.kv_dtype in QUANTIZED_CACHES:
            return new.kv_dtype
        dt = (resolve_kv_dtype(new.kv_dtype) if new.kv_dtype is not None
              else self._base_cache_dtype)
        return str(dt).replace("torch.", "")

    def _host_tier_survives(self, new) -> bool:
        """Whether spilled host-tier entries stay valid across a switch
        to `new`: the same page size and storage, so a rebuilt pool
        installs them verbatim (the page COUNT may change: entries hold
        contents, not page ids)."""
        return (self.paged and new.paged
                and new.kv_page_size == self._pager.page_size
                and self._target_storage_name(new) == self._storage_name())

    def _prepare_fold(self, new) -> set:
        """The host half of the fold: clear every slot's mapping and
        release its pages through the OLD allocator, and drop what the
        old pool's bytes back (spilled pages a new layout cannot take,
        the prefix registry). Every unfinished request is then slotless
        and re-prefills from token ids, whether the rebuild lands `new`
        or rolls back to the old geometry. Returns the rids that held
        slots: the streams the switch folds (queued requests ride
        along)."""
        folded = set()
        for slot in range(self.max_slots):
            req = self._slot_req[slot]
            self._slot_req[slot] = None
            if req is not None:
                req.slot = -1
                folded.add(req.rid)
            self._release_slot_pages(slot)
        self._mixed_pending = {}
        self._page_blocked_rid = None
        self._pending_page_preempt = None
        self._page_starved = False
        self._cur_decode = {}
        self._implicated = ()
        if self._host_tier is not None:
            if self._host_tier_survives(new):
                # victim entries are raw page slices, valid in a pool of
                # the same page size and storage: kept, so preempted and
                # parked streams resume from their pages; prefix entries
                # die with the registry below
                for key in self._host_tier.keys():
                    if not (isinstance(key, tuple) and key
                            and key[0] == "victim"):
                        self._host_tier.drop(key)
            else:
                self._host_tier.clear()
        if self.paged or new.paged:
            # the paged registry's pages die with the old pool (and a
            # dense registry's (k, v) entries mean nothing to a paged
            # successor): auto-prefix heads register again on their next
            # request. A dense -> dense switch keeps the registry, whose
            # KV lives outside the cache
            with self._rid_lock:
                self._prefixes.clear()
                self._auto_pids.clear()
            self._prefix_last_hit = {}
        self._prefix_pages_shared = 0
        _PREFIX_PAGES_SHARED.set(0)
        return folded

    def _requeue_folded(self, applied, folded: set) -> int:
        """The scheduler half of the fold, after the rebuild landed:
        every unfinished request requeues under the config actually
        applied (the target, or the restored old one), its generated
        tokens folded into its prompt; seniority, class and preemption
        budget survive, nothing is quarantined. Caller holds _admit_lock.
        Returns the streams the switch folded (the requests that held a
        slot; queued ones requeue too but are neither counted nor
        stamped)."""
        carried = 0

        def stamp(rid: int, req: _Request) -> None:
            self.tracer.span(rid, "reconfigured",
                             generated=len(req.out_tokens))
            if self.events is not None:
                self.events.publish("reconfigured", rid=rid,
                                    generated=len(req.out_tokens))

        if self._slo:
            for rid, req in sorted(self._requests.items()):
                if req.done.is_set() or req._disagg_pending:
                    continue
                req._kv_restored = False
                remaining = req.max_new_tokens - len(req.out_tokens)
                if remaining <= 0:
                    # it was retiring this iteration: it holds every
                    # token it asked for
                    self._finish_recovered(req)
                    continue
                # keeps the enqueue time (seniority) and the preemption
                # count; False: the request was still queued
                active = self.scheduler.requeue(
                    rid, len(req.prompt_ids) + len(req.out_tokens),
                    remaining)
                if active or rid in folded:
                    stamp(rid, req)
                    carried += 1
            self.scheduler.resize(applied.slots)
            return carried
        # FIFO has no requeue: a new scheduler at the new slot count,
        # resubmitted in rid (arrival) order. Its capacity covers queued
        # AND formerly active requests (the active ones did not count
        # against the old queue's cap)
        unfinished = sum(1 for r in self._requests.values()
                         if not r.done.is_set())
        self.scheduler = make_scheduler(
            applied.slots, max(self._max_queue, unfinished),
            priority_classes=False, config=self._sched_cfg)
        for rid, req in sorted(self._requests.items()):
            if req.done.is_set() or req._disagg_pending:
                # waiting for its shipment: disagg_complete submits it
                # to this scheduler
                continue
            req._kv_restored = False
            remaining = req.max_new_tokens - len(req.out_tokens)
            if remaining <= 0:
                self._finish_recovered(req)
                continue
            if not self.scheduler.submit(
                    rid, len(req.prompt_ids) + len(req.out_tokens),
                    remaining):
                # capacity was sized above: cannot happen, but a dropped
                # stream must be loud
                self._drop_request(req, as_engine_error(
                    RuntimeError("reconfigure resubmit failed")))
                continue
            if rid in folded:
                stamp(rid, req)
                carried += 1
        return carried

    def _apply_exec_config(self, new) -> None:
        """Rebuild the config-dependent state under the new knobs: the
        flavor (the paged pool, or the dense cache for `kv_pages: null`),
        the allocator, the per-slot mirrors, the sampling state (the
        reset count folds into the seeds: the startup streams are not
        replayed), the host tier's page size, the step cost's constants
        and the flight recorder's impl. The old cache, the runners and
        their graphs' memory pool go BEFORE the new cache is allocated,
        so a switch needs one cache's memory, not two; the next steps
        capture their graphs anew. Engine thread only, after
        _prepare_fold (no slot holds device state)."""
        B = new.slots
        impl = (self._check_attn(resolve_paged_attn(new.paged_attn,
                                                    self.device))
                if new.paged else None)
        self._drop_device_state()
        self.max_slots = B
        self._decode_scan = max(1, new.decode_scan)
        self.paged = new.paged
        self._kv_dtype_name = new.kv_dtype
        self._quant_cache = QUANTIZED_CACHES.get(new.kv_dtype)
        self.kv_quant = self._quant_cache is not None
        self._pool_dtype = (resolve_kv_dtype(new.kv_dtype)
                            if self.paged and new.kv_dtype is not None
                            and not self.kv_quant
                            else self._base_cache_dtype)
        self._mixed = self.paged and (new.mixed_batch or "auto") != "off"
        self.paged_attn = impl
        self._pager = (PageAllocator(new.kv_pages, new.kv_page_size)
                       if self.paged else None)
        self._slot_pages = {}
        self._slot_prefix_pages = {}
        with self._rid_lock:
            # a staged shipment was cut for the old pool's geometry (a
            # later one from before the switch meets the epoch check)
            self._adopt_store.clear()
        self._pos = np.zeros(B, np.int64)
        self._last_tok = np.zeros(B, np.int64)
        self._steps = np.zeros(B, np.int64)
        self._temp = np.full(B, self.defaults.temperature or 0.0,
                             np.float32)
        self._top_p = np.ones(B, np.float32)
        self._penalty = np.full(B, self.defaults.repeat_penalty,
                                np.float32)
        self._slot_req = [None] * B
        self._reset_count += 1
        if not self.paged:
            self.cache = self._new_dense_cache(self.config)
            self._host_tier = None
        else:
            self.cache = self._new_cache(new.kv_pages, new.kv_page_size)
            tier = self._host_tier
            if self._kv_host_pages is not None:
                pb = page_bytes(self.config, new.kv_page_size,
                                new.kv_dtype if self.kv_quant
                                else self._pool_dtype)
                if tier is None or tier.page_bytes != pb:
                    # a new layout (_prepare_fold emptied the old tier);
                    # the same one keeps its tier and the victims it holds
                    tier = HostTier(self._kv_host_pages, page_bytes=pb,
                                    events=self.events,
                                    dtype_name=pool_dtype_name(self.cache))
                self._host_tier = tier
        self._fresh_sampling_state()
        self._cost_constants()
        self.flight.rebind(impl=self._flavor())
        if self.paged:
            log.info("paged KV: %d pages x %d tokens, %s attention, %s "
                     "storage (%.2f GiB pool), %d slots, decode_scan %d, "
                     "mixed %s", new.kv_pages, new.kv_page_size, impl,
                     self._storage_name(),
                     self.cache.memory_bytes() / 2**30, B,
                     self._decode_scan, "on" if self._mixed else "off")
        else:
            log.info("dense KV cache: %d slots x %d positions (%.2f GiB), "
                     "decode_scan %d", B, self.max_seq_len,
                     self.cache.memory_bytes() / 2**30, self._decode_scan)

    def autotune_state(self) -> dict:
        """GET /api/v1/autotune: mode, live config, switch and decision
        history, and (auto mode) the controller's window signals."""
        out = {
            "mode": self.autotune_mode,
            "epoch": self.config_epoch,
            "config": self.current_config().to_dict(),
            "switches": self.stats.config_switches,
            "rollbacks": self.stats.config_rollbacks,
            "switch_in_flight": self._switch_inflight,
            "switch_log": list(self._switch_log),
        }
        at = self._autotuner
        if at is not None:
            out["controller"] = at.state()
            out["policy"] = at.policy.to_dict()
        return out

    def _gather_autotune_signals(self, now: float):
        """One sliding-window sample from telemetry the engine already
        keeps (host numbers only): arrival and service deltas from
        EngineStats, MFU / HBM from the flight recorder, queue depth from
        the scheduler, pool occupancy from the allocator, TTFT from the
        tracer ring and the SLO accountant."""
        from cake_tpu_torch.autotune import AutotuneSignals
        st = self.stats
        submitted = self._next_rid - 1
        cur = (now, submitted, st.requests_completed, st.tokens_generated,
               st.shed)
        prev, self._autotune_prev = self._autotune_prev, cur
        if prev is None:
            prev = cur
        dt = max(1e-6, now - prev[0])
        util = self.flight.utilization(include_prefill=True)
        pages_frac = 0.0
        if self.paged:
            total = self._pager.n_pages
            pages_frac = (total - self._pager.free_pages) / total
        depths = getattr(self.scheduler, "class_depths", None)
        ttfts = self.tracer.recent_ttfts(32)
        p99 = None
        if ttfts:
            xs = sorted(ttfts)
            p99 = xs[min(len(xs) - 1, int(0.99 * len(xs)))]
        pressure = getattr(self.scheduler, "queue_pressure", None)
        return AutotuneSignals(
            t=now,
            offered_rps=(submitted - prev[1]) / dt,
            completed_rps=(st.requests_completed - prev[2]) / dt,
            service_tps=(st.tokens_generated - prev[3]) / dt,
            queue_depth=self.scheduler.queue_depth,
            queue_depth_by_class=depths() if depths else {},
            mfu=util["mfu"], hbm_util=util["hbm_util"],
            pages_in_use_frac=pages_frac,
            shed_rps=(st.shed - prev[4]) / dt,
            ttft_p99_s=p99,
            ttft_p99_by_class=self.slo.ttft_p99_by_class("1m"),
            attainment=self.slo.attainment_by_class("1m"),
            queue_pressure=pressure() if pressure is not None else 0.0)

    @engine_thread_only
    def _autotune_tick(self) -> None:
        """The auto-mode controller's drive, from the engine loop between
        iterations: a signal sample every interval, and the controller's
        switch or rollback applied inline (this IS the engine thread, so
        the switch lands at a step boundary)."""
        from cake_tpu_torch.autotune import ROLLBACKS
        at = self._autotuner
        if at is None:
            return
        now = time.monotonic()
        if now - self._autotune_last < at.config.interval_s:
            return
        self._autotune_last = now
        decision = at.decide(self._gather_autotune_signals(now))
        if decision is None:
            return
        target, reason = decision
        old = self.current_config()
        pre_rate = at.window_service_tps()
        try:
            if not self._reconfigure_sync(target, reason):
                # a target spelled differently but identical: adopt the
                # spelling as "current", so the no-op is not re-proposed
                at.on_switched(target, old, pre_rate, "noop")
                return
        except Exception as e:  # noqa: BLE001
            if reason == "rollback":
                # a REFUSED revert must not pin the known-good config:
                # stay put (the regressed one is already pinned)
                log.warning("rollback revert refused; staying on the "
                            "current config: %s", e)
            else:
                # an unswitchable policy target must not spin: pin it
                log.warning("autotune switch refused (%s); pinning: %s",
                            reason, e)
                at.pin(target, why=str(e))
            return
        at.on_switched(target, old, pre_rate, reason)
        if reason == "rollback":
            ROLLBACKS.inc()
            self.stats.config_rollbacks += 1

    # -- the checkpoint's seams -------------------------------------------------

    def shutdown_save(self, path: str) -> None:
        """The clean-shutdown checkpoint: save the live registry, unless
        this process wrote a pre-fail snapshot that still holds
        resumable records (that file is the failure-time state, and the
        emptied registry would clobber it). Under _ckpt_lock, like the
        pre-fail writer. With the journal, the save truncates it (the
        snapshot now owns every record)."""
        from cake_tpu_torch.serve import checkpoint
        with self._ckpt_lock:
            if self._prefail_written and checkpoint.has_resumable(path):
                log.info("keeping pre-fail snapshot at %s", path)
                return
            checkpoint.write(checkpoint.snapshot(self), path)
            if self._journal is not None:
                self._journal.truncate("checkpoint")

    def _snapshot_before_fail(self, requests=None) -> None:
        """The pre-fail checkpoint (a no-op unless `snapshot_path` is
        armed; the caller holds _ckpt_lock). Device-free: the
        fingerprint was warmed when the path was armed, so the snapshot
        is pure Python and one local write, safe with a poisoned CUDA
        context. requests: the records captured before the registry was
        emptied (the engine loop's failure path)."""
        path = self.snapshot_path
        if not path:
            return
        if requests is None and not self._requests:
            # the registry was emptied by an engine-loop failure: use
            # that failure's capture if it is fresh
            stash = self._fail_recs
            if stash is not None and time.monotonic() - stash[0] \
                    < self.fail_recs_ttl:
                requests = stash[1]
            else:
                return
        if getattr(self, "_ckpt_fingerprint", None) is None:
            log.warning("pre-fail snapshot skipped: the fingerprint was "
                        "not warmed when the path was armed (computing "
                        "it now would read the device)")
            return
        try:
            from cake_tpu_torch.serve import checkpoint
            snap = checkpoint.snapshot(self, requests=requests)
            if not any(checkpoint.is_resumable(r)
                       for r in snap["requests"]):
                return
            checkpoint.write(snap, path)
            self._prefail_written = True
            if self._journal is not None:
                self._journal.truncate("checkpoint")
            log.info("pre-fail snapshot saved to %s", path)
        except Exception:  # noqa: BLE001
            log.exception("pre-fail snapshot failed")
