"""Serving arguments (the fields of `cake_tpu/args.py:Args` that the
port's Master and engine read; same names and defaults, except that the
paged KV pool is on by default, being the port's only engine).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class Args:
    seed: int = 299792458
    sample_len: int = 100               # default max_tokens per request
    temperature: float = 1.0
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    # None = "not set": resolves to the reference default 1.1
    repeat_penalty: Optional[float] = None
    repeat_last_n: int = 128
    dtype: str = "bf16"                 # f32 | bf16 | f16 (weights)
    kv_dtype: Optional[str] = None      # KV pool dtype; None = dtype
    max_seq_len: int = 4096
    max_slots: int = 8                  # continuous-batching decode slots
    # admit prompts in fixed windows of N tokens (None = 256, capped at
    # max_seq_len); must divide max_seq_len
    prefill_chunk: Optional[int] = None
    # paged KV pool: N pages of kv_page_size tokens; admission is gated
    # by free pages (the port's engine is paged only)
    kv_pages: Optional[int] = 512
    kv_page_size: int = 128
    # attention over the pages: "kernel" = the CUDA kernels, "plain" =
    # their PyTorch folds, "auto" = kernel on CUDA tensors, plain on CPU
    paged_attn: str = "auto"
    # token-level continuous batching (the port has only "auto"/"on")
    mixed_batch: str = "auto"
