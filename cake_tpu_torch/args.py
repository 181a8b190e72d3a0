"""Command-line arguments: the fields of `cake_tpu/args.py:Args` that the
port implements (same names and defaults), `ModelType`, and the image
model's `SDArgs` and `ImageGenerationArgs` (which doubles as the body of
POST /api/v1/image), as in the JAX package.

`build_parser` builds one flag per field of the three, as the JAX
package does (`--max-seq-len`, `--flash-attention/--no-flash-attention`,
`--sd-version`, `--sd-n-steps`, ...). `parse_all_args` returns
(Args, SDArgs, ImageGenerationArgs), what JAX's `parse_args` returns;
`parse_args` returns the validated Args alone (`Args.validate`, the JAX
package's rules for the fields the port has, `--quant none|int8|int4`
among them). The multi-process serving
flags (`--mode`, `--name`, `--address`, `--heartbeat-timeout`,
`--stall-timeout`, `--telemetry-export`, `--telemetry-interval`) and the
router's (`--router`, `--replicas`, `--router-announce`,
`--announce-interval`, `--router-watermark`, `--router-poll`,
`--router-policy`, `--router-anomaly-weighting`) have JAX's names,
defaults and checks. A flag of the JAX package that the
port does not implement yet, or that the JAX package parses and reads
nowhere (`--sd-flash-attention`, `--sd-sliced-attention-size`), is
rejected by argparse, never accepted and ignored.
"""

from __future__ import annotations

import argparse
from dataclasses import asdict, dataclass, fields
from enum import Enum
from typing import Optional, Tuple

from cake_tpu_torch.kv.quantized_pool import QUANTIZED_CACHES
from cake_tpu_torch.models.sd.config import SDVersion
from cake_tpu_torch.utils.devices import resolve_kv_dtype

INT8_KV_SPEC_ERROR = (
    "--kv-dtype int8/int4 is unavailable with --draft-model: the "
    "speculative generator's caches are dense, so there are no KV pages "
    "to quantize")


class ModelType(str, Enum):
    TEXT = "text"
    IMAGE = "image"


def parse_replicas(spec: str) -> list:
    """Validate and split a --replicas list: comma-separated host:port
    entries, no duplicates (Args.validate and cli._serve_router)."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        host, sep, port = entry.rpartition(":")
        if not sep or not host:
            raise ValueError(
                f"--replicas entry {entry!r} must be host:port")
        try:
            p = int(port)
        except ValueError:
            raise ValueError(
                f"--replicas entry {entry!r}: port {port!r} is not an "
                "integer")
        if not 0 < p < 65536:
            raise ValueError(
                f"--replicas entry {entry!r}: port {p} out of range")
        out.append(entry)
    if not out:
        raise ValueError(f"--replicas {spec!r} names no replicas")
    if len(set(out)) != len(out):
        raise ValueError(f"--replicas {spec!r} has duplicate entries")
    return out


@dataclass
class Args:
    model: str = ""                     # model directory ("" = tiny random)
    # --model-type text | image: a Llama-family (or Mixtral) text model,
    # or Stable Diffusion (SDArgs, ImageGenerationArgs)
    model_type: ModelType = ModelType.TEXT
    # master | worker: JAX's compatibility flag; every process runs the
    # same command and its role comes from the process group, so
    # `--mode worker` is explained and refused (cli.main, rc 2)
    mode: str = "master"
    name: str = ""                      # node name within the topology
    address: str = "127.0.0.1:10128"    # serving bind address
    api: Optional[str] = None           # REST bind address; None = one-shot
    prompt: str = "Why is the sky blue?"
    system_prompt: str = "You are a helpful AI assistant."
    seed: int = 299792458
    sample_len: int = 100               # tokens per generation / request
    temperature: float = 1.0
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    # None = "not set": resolves to the reference default 1.1
    repeat_penalty: Optional[float] = None
    repeat_last_n: int = 128
    dtype: str = "bf16"                 # f32 | bf16 | f16 (weights)
    # weight-only quantization: none | int8 (per-channel) | int4
    # (group-wise, nibble-packed; the int4 matmul kernel at decode shapes)
    quant: str = "none"
    # speculative decoding (models/llama/speculative.py): path to a small
    # draft model sharing the target's tokenizer; each target pass then
    # verifies spec_gamma drafted tokens at once. Batch-1 one-shot
    # generation, and behind --api the dense spec engine (batched rounds
    # over every slot, spec_round_batched)
    draft_model: Optional[str] = None
    spec_gamma: int = 4
    # paged speculative decoding (spec/): path to a small draft model
    # whose KV rides a second paged pool behind the engine's one page
    # allocator, spec rows a row kind of the --api engine. Requires
    # --kv-pages and f32/bf16/fp8 KV; shares --spec-gamma. Mutually
    # exclusive with --draft-model
    spec_draft: Optional[str] = None
    # batch-1 speculation: propose-verify rounds chained on the card per
    # host fetch (spec_scan); the engine ignores it
    spec_rounds: int = 4
    # KV cache/pool dtype; None = dtype. int8/int4 quantize the paged
    # pool (the generator's dense cache keeps the compute dtype);
    # f8_e4m3/f8_e5m2 store the pool and the dense cache in fp8, upcast
    # to the compute dtype on read
    kv_dtype: Optional[str] = None
    cpu: bool = False                   # run on the CPU (plain kernels)
    device_idx: int = 0                 # cuda:<device_idx> otherwise
    max_seq_len: int = 4096
    # rows of the one-shot generator (the prompt replicated over them,
    # row 0 streamed, as the JAX generator does)
    batch_size: int = 1
    max_slots: int = 8                  # continuous-batching decode slots
    # topology.yml: contiguous block ranges become pipeline stages of
    # the ("dp", "stage", "tp") mesh (parallel/plan.py)
    topology: Optional[str] = None
    tp: int = 1                         # tensor-parallel degree
    # data-parallel degree: the generator's batch rows split over dp
    # replicas; an image model's UNet batch over dp positions
    dp: int = 1
    # sequence-parallel degree: the prompt's context window split over
    # an "sp" mesh axis, prefilled by ring attention and decoded against
    # merged per-shard stats plus a replicated decode tail
    # (parallel/context_parallel.py)
    sp: int = 1
    microbatches: int = 1               # GPipe microbatches per step
    # prefill prompts in fixed windows of N tokens. Generator: None =
    # whole-prompt prefill; engine: None = 256, capped at max_seq_len.
    # Must divide max_seq_len
    prefill_chunk: Optional[int] = None
    # engine: when no request is queued and no prompt is mid-prefill,
    # decode N tokens per host round trip (N replays of the captured
    # decode step on the card); 1 = step by step
    decode_scan: int = 1
    # flash-attention kernels for prefill; None = on iff the device is CUDA
    flash_attention: Optional[bool] = None
    # --tracing DIR: a torch.profiler trace of the one-shot generation,
    # written to DIR as a Chrome / Perfetto trace file
    tracing: Optional[str] = None
    # --kv-pages N: paged KV for the --api engine, a pool of N pages of
    # kv_page_size tokens; admission is gated by free pages. None = the
    # dense engine (one [L, B, T] cache; a ring of W = window slots for a
    # sliding-window config shorter than max_seq_len), as in JAX
    kv_pages: Optional[int] = None
    kv_page_size: int = 128
    # --kv-host-pages N: host-RAM spill tier for the paged pool
    # (kv/host_tier.py), N pages of capacity: preemption victims', cold
    # shared prefixes' and parked decode-resident streams' pages spill
    # to pinned host memory and stream back bit for bit; None = off
    kv_host_pages: Optional[int] = None
    # attention over the pages: "kernel" = the CUDA kernels, "plain" =
    # their PyTorch folds, "auto" = kernel on CUDA tensors, plain on CPU
    paged_attn: str = "auto"
    # --mixed-batch: token-level continuous batching of the paged engine;
    # "auto"/"on" = admissions' prefill windows join the next mixed step
    # beside the decode rows, "off" = the phase-split loop (prefill each
    # admission alone, then decode)
    mixed_batch: str = "auto"
    # --auto-prefix: the API engine prefills each distinct system
    # prompt's rendered head once, rounded down to a page, into shared
    # pool pages mapped read-only (refcounted) at the head of every
    # matching slot's table row, so conversations sharing it prefill
    # only their own turns
    auto_prefix: bool = False
    # --trace-events PATH: append every request-lifecycle span as one
    # JSON line (obs/tracing.py), beside the ring at GET /api/v1/requests
    trace_events: Optional[str] = None
    # --trace-ring N: finished request traces kept for GET /api/v1/requests
    trace_ring: int = 256
    # --step-log PATH: append one JSON line per engine step (the flight
    # recorder, obs/steps.py), beside the ring at GET /api/v1/steps
    step_log: Optional[str] = None
    # --step-ring N: step records kept for GET /api/v1/steps
    step_ring: int = 512
    # --event-log PATH: append every serving event (obs/events.py) as one
    # JSON line, beside the ring at GET /api/v1/events
    event_log: Optional[str] = None
    # --event-ring N: events kept for GET /api/v1/events; 0 disables the
    # event bus
    event_ring: int = 1024
    # --slo-targets SPEC: per-class latency SLOs for attainment and
    # goodput accounting (obs/slo.py), "interactive=ttft:0.1,e2e:2;..."
    slo_targets: Optional[str] = None
    # --priority-classes: SLO-aware scheduling (sched/): requests carry a
    # class (interactive | standard | batch, the body's "priority" or the
    # x-cake-priority header) and are admitted by class with
    # anti-starvation aging instead of in arrival order
    priority_classes: bool = False
    # --preemption / --no-preemption: recompute-style preemption of the
    # youngest lowest-class slot when a higher class is slot- or
    # page-starved (needs --priority-classes); None = on with the classes
    preemption: Optional[bool] = None
    # --shed: per-class load shedding from the measured service rate and
    # queue depth; a refused request gets 429 with a computed Retry-After
    shed: bool = False
    # --checkpoint PATH: the engine's runtime checkpoint
    # (serve/checkpoint.py): in-flight requests restored at startup,
    # saved on SIGTERM and written before a fatal stop
    checkpoint: Optional[str] = None
    # --fault-plan SPEC: deterministic fault injection (faults/):
    # "seed=N;site:trigger:error[:opts];...", e.g.
    # "seed=7;engine.decode:nth=12:transient"; unset = no plane
    fault_plan: Optional[str] = None
    # --recovery / --no-recovery: on a step failure, reset and resubmit
    # the in-flight requests through the recompute fold instead of
    # failing them all; repeatedly implicated requests are quarantined
    # as poison and a reset storm trips a breaker (snapshot + clean
    # stop). None = on (the paged engine always has the fold)
    recovery: Optional[bool] = None
    # --journal PATH: the write-ahead request journal
    # (serve/journal.py), replayed at startup (over the --checkpoint
    # base when both are set), so a hard process death loses no stream
    journal: Optional[str] = None
    # --journal-fsync {never,batch,always}: "never" flushes per line,
    # "batch" fsyncs once per engine iteration, "always" every append
    journal_fsync: str = "batch"
    # --autotune {off,manual,auto}: live engine-config hot-switching
    # (autotune/). "manual" arms POST /api/v1/autotune (an operator
    # switches slots / decode-scan / kv-pages / kv-page-size / kv-dtype /
    # mixed-batch / paged-attn under load: in-flight streams fold their
    # generated tokens into their prompts and requeue with seniority and
    # class kept, token-identical at f32 KV); "auto" also runs the policy
    # controller over an offered-load regime -> config table
    # (--autotune-policy, fitted offline by
    # `python -m cake_tpu_torch.tools.autotune_fit`), with hysteresis,
    # cooldown and a one-shot rollback guard
    autotune: str = "off"
    # --autotune-policy PATH: the piecewise policy table for --autotune
    # auto (JSON {"version": 2, "regimes": [{"max_offered_rps": ...,
    # "config": {...}}, ...]}; autotune/search.py)
    autotune_policy: Optional[str] = None
    # --sentinel: the online regression sentinel (obs/sentinel.py):
    # rolling-window anomaly detectors over the engine's own rings
    # (per-kind step-time p95 against a self-calibrated baseline, graph
    # captures, kv spills, sheds, per-class SLO attainment), typed
    # `anomaly` events, cake_anomaly_* metrics and GET /api/v1/anomalies
    sentinel: bool = False
    # --sentinel-interval S: the detectors' tick, seconds
    sentinel_interval: float = 2.0
    # --sentinel-act: close the loop (obs/actions.py): capture-storm and
    # step-time anomalies hold new policy switches while active and pin
    # the post-switch rollback verdict, each action typed on the bus,
    # rate-bounded and counted in cake_anomaly_actions_total
    sentinel_act: bool = False
    # --profile-dir DIR: where POST /api/v1/profile writes its
    # torch.profiler capture; None = a fresh temporary directory each
    profile_dir: Optional[str] = None
    # --postmortem-dir DIR: black-box forensics: breaker and
    # failed-rebuild stops, poison quarantines and SIGTERM each dump one
    # JSON bundle (step records, events, traces, anomaly and action
    # history, stats, metrics, journal tail) here; tools/postmortem.py
    # renders a bundle into a wall-clock narrative
    postmortem_dir: Optional[str] = None
    # --disagg {prefill,decode}: disaggregated prefill/decode serving
    # (kv/transfer.py): this engine takes ONE phase of the pair.
    # "decode" is the front door: it forwards each admission's prompt
    # to the prefill peer, installs the shipped KV pages through the
    # refcounted allocator and streams from the first decoded token;
    # "prefill" admits forwarded prompts, prefills them into pool pages
    # and ships the pages and a handoff record. Needs --kv-pages and
    # the shared channel token in $CAKE_DISAGG_TOKEN on both engines.
    # Any channel failure degrades the decode engine to whole-prompt
    # local prefill, never a wedged stream
    disagg: Optional[str] = None
    # --disagg-peer host:port: the channel's address; the PREFILL
    # engine binds it (port 0 = ephemeral), the DECODE engine connects
    # to it (retrying with backoff, so start order is free)
    disagg_peer: Optional[str] = None
    # --disagg-timeout S: the decode engine's wait for a forwarded
    # prefill before that request degrades to local prefill
    disagg_timeout: float = 30.0
    # serving watchdog: fail (recoverably) when the engine makes no
    # progress for this many seconds with active requests; must exceed
    # the worst-case first-request capture time (parallel/health.py)
    stall_timeout: float = 600.0
    # multi-process serving: fail when a follower's heartbeat lapses
    # this many seconds (parallel/health.HeartbeatMonitor stale window):
    # the pre-fail snapshot and 503s instead of a hop that never returns
    heartbeat_timeout: float = 15.0
    # --telemetry-export / --no-telemetry-export: fleet telemetry
    # federation (obs/federation.py): every follower ships its metrics,
    # events, step summaries and applied control-op seq to the
    # coordinator's collector (/api/v1/fleet, ?host=, host-labelled
    # /metrics). None = auto (on when serving spans processes); True on
    # a single process is a one-shot warning
    telemetry_export: Optional[bool] = None
    # --telemetry-interval S: the exporter's frame cadence in seconds
    telemetry_interval: float = 2.0
    # --router: run this process as the front-door router (router/) over
    # independent engine replicas instead of loading a model; it binds
    # --api (or --address). With --model on a directory holding
    # tokenizer.json the affinity keys are page-aligned token
    # fingerprints; without one, system-prompt text fingerprints
    router: bool = False
    # --replicas host:port,...: the replicas the router fronts (each an
    # `--api` process); with --router-announce an optional static seed
    replicas: Optional[str] = None
    # --router-announce host:port: on the router, bind the token-gated
    # announce listener there (port 0: ephemeral); on a replica (--api),
    # announce to it. The token is $CAKE_ANNOUNCE_TOKEN on both sides
    router_announce: Optional[str] = None
    # --announce-interval S: the replica's announce-frame cadence (and
    # the router's warm-up Retry-After bound; x3 its staleness window)
    announce_interval: float = 2.0
    # --router-watermark N: the affinity target takes a request only
    # under this queue + active load; over it the request spills
    router_watermark: int = 8
    # --router-poll S: the lite-health poll cadence a replica
    router_poll: float = 0.25
    # --router-policy {affinity,round_robin}
    router_policy: str = "affinity"
    # --router-anomaly-weighting: the router's closed loop (needs
    # --sentinel): TTFT skew, shed storms and affinity collapse
    # de-weight the offending replica, never ejecting it
    router_anomaly_weighting: bool = False

    def validate(self) -> "Args":
        """The JAX package's `Args.validate` rules: --quant is none,
        int8 or int4; --tp, --dp, --sp, --microbatches, --batch-size,
        --max-slots, --decode-scan, --spec-gamma,
        --spec-rounds, --trace-ring and --step-ring are at least 1, --event-ring at least 0; --slo-targets parses;
        --mixed-batch is auto, on or off; --kv-dtype int8 and
        int4 need the paged pool, and int4 an even page size; any other
        name must be a dtype or an fp8 storage name; --draft-model
        refuses int8/int4 KV; --spec-draft excludes --draft-model and
        needs --kv-pages, float pages and the mixed loop; --kv-host-pages is
        at least 1; --fault-plan parses; --journal-fsync is never, batch
        or always; --autotune is off, manual or auto, and auto needs a
        --autotune-policy that loads; --sentinel-interval is above 0 and
        --sentinel-act needs --sentinel; --disagg is prefill or decode,
        needs --kv-pages, a host:port --disagg-peer and
        $CAKE_DISAGG_TOKEN, and excludes --spec-draft; --disagg-timeout
        is above 0; --telemetry-interval is above 0; --mode is master or
        worker; --router-policy is affinity or round_robin,
        --router-watermark at least 1, --router-poll and
        --announce-interval above 0, --router-anomaly-weighting needs
        --sentinel, --router-announce is host:port, and --router needs
        --replicas (a valid list) or --router-announce. Returns self."""
        if self.quant not in ("none", "int8", "int4"):
            raise ValueError(f"unsupported quant {self.quant!r}")
        if not self.telemetry_interval > 0:
            raise ValueError(
                f"--telemetry-interval {self.telemetry_interval} must "
                "be > 0 seconds")
        if self.mode not in ("master", "worker"):
            raise ValueError(f"unsupported mode '{self.mode}'")
        self._validate_router()
        for knob in ("tp", "dp", "sp", "microbatches", "batch_size",
                     "max_slots", "decode_scan", "spec_gamma",
                     "spec_rounds", "trace_ring", "step_ring"):
            if getattr(self, knob) < 1:
                raise ValueError(f"--{knob.replace('_', '-')} must be >= 1")
        if self.slo_targets:
            # a malformed spec is a startup error, not a serving run
            # silently accounting against the defaults
            from cake_tpu_torch.obs.slo import parse_slo_targets
            parse_slo_targets(self.slo_targets)
        if self.event_ring < 0:
            raise ValueError(
                f"--event-ring {self.event_ring} must be >= 0 "
                "(0 disables the event bus)")
        if self.mixed_batch not in ("auto", "on", "off"):
            raise ValueError(
                f"unsupported mixed_batch '{self.mixed_batch}' "
                "(choose auto, on or off)")
        if self.kv_dtype in QUANTIZED_CACHES:
            if not self.kv_pages:
                raise ValueError(
                    f"--kv-dtype {self.kv_dtype} requires --kv-pages: "
                    "quantized KV pages live in the paged pool "
                    "(cake_tpu/kv)")
            if self.kv_dtype == "int4" and self.kv_page_size % 2:
                # two int4 values nibble-pack into one byte along the
                # page's token axis, so a page must split evenly
                raise ValueError(
                    f"--kv-dtype int4 requires an even --kv-page-size "
                    f"(got {self.kv_page_size}): pages nibble-pack "
                    "token pairs (cake_tpu/kv/quantized_pool)")
            if self.draft_model is not None:
                raise ValueError(INT8_KV_SPEC_ERROR)
        elif self.kv_dtype is not None:
            resolve_kv_dtype(self.kv_dtype)
        if self.spec_draft is not None:
            # paged speculative decoding: the engine constructor's checks
            # at startup, before the model loads
            if self.draft_model is not None:
                raise ValueError(
                    "--spec-draft (paged spec rows) and --draft-model "
                    "(the dense spec engine) are mutually exclusive")
            if not self.kv_pages:
                raise ValueError(
                    "--spec-draft requires --kv-pages: paged "
                    "speculative decoding shares the page allocator")
            if self.kv_dtype in ("int8", "int4"):
                raise ValueError(
                    f"--spec-draft requires f32/bf16/fp8 KV pages, got "
                    f"--kv-dtype {self.kv_dtype}: the draft pool has "
                    "no quantized flavor")
            if self.disagg is not None:
                raise ValueError(
                    "--spec-draft is not supported with --disagg yet: "
                    "a shipped prefill carries no draft-pool KV (the "
                    "decode host would re-prefill every draft)")
            if self.mixed_batch == "off":
                raise ValueError(
                    "--spec-draft requires the mixed ragged step "
                    "(--mixed-batch auto/on): spec rows are a row "
                    "kind of that step")
        if self.kv_host_pages is not None and self.kv_host_pages < 1:
            raise ValueError(
                f"--kv-host-pages {self.kv_host_pages} must be >= 1")
        if self.fault_plan:
            # a malformed plan is a startup error, not a chaos run that
            # silently injects nothing
            from cake_tpu_torch.faults.plan import FaultPlan
            FaultPlan.parse(self.fault_plan)
        if self.journal_fsync not in ("never", "batch", "always"):
            raise ValueError(
                f"unsupported journal_fsync '{self.journal_fsync}' "
                "(choose never, batch or always)")
        if self.autotune not in ("off", "manual", "auto"):
            raise ValueError(
                f"unsupported autotune '{self.autotune}' "
                "(choose off, manual or auto)")
        if self.autotune == "auto":
            if not self.autotune_policy:
                raise ValueError(
                    "--autotune auto requires --autotune-policy "
                    "(fit one with python -m "
                    "cake_tpu_torch.tools.autotune_fit)")
            # parsed now: a malformed or missing policy is a startup
            # error, not a crash after the model loaded
            from cake_tpu_torch.autotune import PolicyTable
            PolicyTable.load(self.autotune_policy)
        if not self.sentinel_interval > 0:
            raise ValueError(
                f"--sentinel-interval {self.sentinel_interval} must "
                "be > 0 seconds")
        if self.sentinel_act and not self.sentinel:
            raise ValueError(
                "--sentinel-act requires --sentinel (nothing to act "
                "on without the anomaly sentinel)")
        if self.disagg is not None:
            if self.disagg not in ("prefill", "decode"):
                raise ValueError(
                    f"unsupported disagg '{self.disagg}' (choose "
                    "prefill or decode)")
            if not self.kv_pages:
                raise ValueError(
                    "--disagg requires --kv-pages: KV pool pages are "
                    "the transfer unit (cake_tpu/kv/transfer.py)")
            if not self.disagg_peer:
                raise ValueError(
                    "--disagg requires --disagg-peer host:port (the "
                    "prefill engine binds it; the decode engine "
                    "connects to it)")
            host, sep, port = self.disagg_peer.rpartition(":")
            if not sep or not host or not port.isdigit() \
                    or not 0 <= int(port) <= 65535:
                raise ValueError(
                    f"--disagg-peer {self.disagg_peer!r} must be "
                    "host:port (port 0 binds ephemeral on the prefill "
                    "role)")
            import os
            if not os.environ.get("CAKE_DISAGG_TOKEN"):
                # loud now, not a dead channel after the model loaded
                raise ValueError(
                    "--disagg needs the shared channel token in "
                    "$CAKE_DISAGG_TOKEN on both engines")
        if not self.disagg_timeout > 0:
            raise ValueError(
                f"--disagg-timeout {self.disagg_timeout} must be > 0 "
                "seconds")
        return self

    def _validate_router(self) -> None:
        """The router flags' checks, in JAX's words."""
        if self.router_policy not in ("affinity", "round_robin"):
            raise ValueError(
                f"unsupported router_policy '{self.router_policy}' "
                "(choose affinity or round_robin)")
        if self.router_watermark < 1:
            raise ValueError(
                f"--router-watermark {self.router_watermark} must be >= 1")
        if not self.router_poll > 0:
            raise ValueError(
                f"--router-poll {self.router_poll} must be > 0 seconds")
        if self.router_anomaly_weighting and not self.sentinel:
            raise ValueError(
                "--router-anomaly-weighting requires --sentinel (the "
                "router-side detectors drive the de-weighting)")
        if not self.announce_interval > 0:
            raise ValueError(
                f"--announce-interval {self.announce_interval} must "
                "be > 0 seconds")
        if self.router_announce is not None:
            host, sep, port = self.router_announce.rpartition(":")
            if not sep or not host or not port.isdigit():
                raise ValueError(
                    f"--router-announce {self.router_announce!r} must "
                    "be host:port (port 0 binds an ephemeral announce "
                    "listener on the router role)")
            if not 0 <= int(port) <= 65535:
                raise ValueError(
                    f"--router-announce port {port} out of range (0-65535)")
        if self.router:
            if not self.replicas and self.router_announce is None:
                raise ValueError(
                    "--router requires --replicas host:port,... (the "
                    "engine replicas the front door routes over) or "
                    "--router-announce host:port (fleet discovery: "
                    "replicas self-register)")
            if self.replicas:
                parse_replicas(self.replicas)


@dataclass
class SDArgs:
    """Stable Diffusion model options (JAX's `SDArgs`), without its
    sd_sliced_attention_size and sd_flash_attention, which JAX parses
    and reads nowhere."""

    sd_version: SDVersion = SDVersion.V1_5
    sd_tokenizer: Optional[str] = None
    sd_tokenizer_2: Optional[str] = None
    sd_use_f16: bool = True
    sd_width: Optional[int] = None
    sd_height: Optional[int] = None
    sd_clip: Optional[str] = None
    sd_clip2: Optional[str] = None
    sd_vae: Optional[str] = None
    sd_unet: Optional[str] = None


@dataclass
class ImageGenerationArgs:
    """Per-request image generation parameters (JAX's
    `ImageGenerationArgs`): command-line flags and the JSON body of
    POST /api/v1/image."""

    image_prompt: str = ("A very realistic photo of a rusty robot walking "
                         "on a sandy beach")
    image_uncond_prompt: str = ""
    sd_tracing: bool = False
    sd_img2img: Optional[str] = None
    sd_img2img_strength: float = 0.8
    sd_n_steps: Optional[int] = None
    sd_num_samples: int = 1
    sd_bsize: int = 1
    sd_intermediary_images: bool = False
    sd_guidance_scale: Optional[float] = None
    sd_seed: Optional[int] = None

    @classmethod
    def from_json(cls, body: dict) -> "ImageGenerationArgs":
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in body.items() if k in known})

    def to_json(self) -> dict:
        return asdict(self)


_PARSERS = {"str": str, "int": int, "float": float,
            "Optional[str]": str, "Optional[int]": int,
            "Optional[float]": float}


def _add_fields(parser: argparse.ArgumentParser, dc_type) -> None:
    for f in fields(dc_type):
        name = "--" + f.name.replace("_", "-")
        if isinstance(f.default, Enum):
            parser.add_argument(name, type=type(f.default),
                                choices=list(type(f.default)),
                                default=f.default)
        elif f.type in ("bool", "Optional[bool]"):
            parser.add_argument(name, action=argparse.BooleanOptionalAction,
                                default=f.default)
        else:
            parser.add_argument(name, type=_PARSERS[f.type],
                                default=f.default)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="cake_tpu_torch.cli",
        description="Llama / Mixtral text and Stable Diffusion image "
                    "generation and serving on PyTorch/CUDA")
    for dc_type in (Args, SDArgs, ImageGenerationArgs):
        _add_fields(parser, dc_type)
    return parser


def parse_all_args(argv=None
                   ) -> Tuple[Args, SDArgs, ImageGenerationArgs]:
    """Parse argv (sys.argv[1:] when None) into (validated Args, SDArgs,
    ImageGenerationArgs), as JAX's `parse_args`."""
    d = vars(build_parser().parse_args(argv))

    def pick(dc_type):
        return dc_type(**{f.name: d[f.name] for f in fields(dc_type)})

    return pick(Args).validate(), pick(SDArgs), pick(ImageGenerationArgs)


def parse_args(argv=None) -> Args:
    """Parse argv (sys.argv[1:] when None) into validated Args."""
    return parse_all_args(argv)[0]
