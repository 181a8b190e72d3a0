"""Command-line arguments (the fields of `cake_tpu/args.py:Args` that the
port implements; same names and defaults, except that the paged KV pool
is on by default, being the port's only serving engine).

`parse_args` builds one flag per field, as the JAX package does
(`--max-seq-len`, `--flash-attention/--no-flash-attention`, ...), and
validates the result (`Args.validate`, the JAX package's rules for the
fields the port has, `--quant none|int8|int4` among them); a flag of the
JAX package that the port does not implement yet (`--topology`, `--sp`,
the speculative-decoding flags, ...) is rejected by argparse, never
accepted and ignored.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, fields
from typing import Optional

from cake_tpu_torch.kv.quantized_pool import QUANTIZED_CACHES
from cake_tpu_torch.utils.devices import resolve_dtype


@dataclass
class Args:
    model: str = ""                     # model directory ("" = tiny random)
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
    # KV cache/pool dtype; None = dtype. int8/int4 quantize the paged
    # pool (the generator's dense cache keeps the compute dtype)
    kv_dtype: Optional[str] = None
    cpu: bool = False                   # run on the CPU (plain kernels)
    device_idx: int = 0                 # cuda:<device_idx> otherwise
    max_seq_len: int = 4096
    max_slots: int = 8                  # continuous-batching decode slots
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
    # paged KV pool of the --api engine: N pages of kv_page_size tokens;
    # admission is gated by free pages (the port's engine is paged only)
    kv_pages: Optional[int] = 512
    kv_page_size: int = 128
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

    def validate(self) -> "Args":
        """The JAX package's `Args.validate` rules: --quant is none,
        int8 or int4; --decode-scan, --trace-ring and --step-ring are at
        least 1, --event-ring at least 0; --slo-targets parses;
        --mixed-batch is auto, on or off; --kv-dtype int8 and
        int4 need the paged pool, and int4 an even page size; any other
        name must be a dtype. Returns self."""
        if self.quant not in ("none", "int8", "int4"):
            raise ValueError(f"unsupported quant {self.quant!r}")
        for knob in ("decode_scan", "trace_ring", "step_ring"):
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
        elif self.kv_dtype is not None:
            resolve_dtype(self.kv_dtype)
        return self


_PARSERS = {"str": str, "int": int, "float": float,
            "Optional[str]": str, "Optional[int]": int,
            "Optional[float]": float}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="cake_tpu_torch.cli",
        description="Llama text generation and serving on PyTorch/CUDA")
    for f in fields(Args):
        name = "--" + f.name.replace("_", "-")
        if f.type in ("bool", "Optional[bool]"):
            parser.add_argument(name, action=argparse.BooleanOptionalAction,
                                default=f.default)
        else:
            parser.add_argument(name, type=_PARSERS[f.type],
                                default=f.default)
    return parser


def parse_args(argv=None) -> Args:
    """Parse argv (sys.argv[1:] when None) into validated Args."""
    return Args(**vars(build_parser().parse_args(argv))).validate()
