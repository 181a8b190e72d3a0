"""Llama-3 forward functions over the dense KV cache.

Counterpart of `cake_tpu/models/llama/model.py` (`RopeTables`,
`block_skeleton`, `block_forward`, `run_blocks`, `forward`,
`forward_logits_all`, `prefill`, `decode_step`, `prefill_chunk`; the
ring and ragged variants are not ported). Block semantics:
  x = x + attn(rms_norm(x))        # input_layernorm -> GQA+RoPE -> o_proj
  x = x + mlp(rms_norm(x))         # post_attention_layernorm -> SwiGLU
Every weight product goes through `ops/quant.qmatmul`: a plain tensor
stays torch.matmul (cuBLAS on the card), as the JAX package left it to
XLA outside its Pallas kernels; an int8 `QTensor` is the per-channel
product in plain PyTorch; an int4 one takes the int4 matmul kernel at
decode shapes and the dequantize route above them. The layer scan is a
Python loop; the cache is written in place and returned, where JAX
donated it. The paged steps (models/llama/paged.py) build on
`block_skeleton` too.

Attention route, as `block_forward` in JAX: with
`config.use_flash_attention`, a fresh whole-prompt prefill goes to
`flash_attention` over the window's own k/v, a chunked prefill whose
cache dtype matches q to `flash_attention_cached` over the cache; every
other case (decode, flash off, a KV dtype unlike q's) to the masked
`gqa_attention` over the cache.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from cake_tpu_torch.models.llama.cache import KVCache, update_layer_cache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.ops.attention import gqa_attention, uniform_forward_mask
from cake_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_cached,
)
from cake_tpu_torch.ops.norms import rms_norm
from cake_tpu_torch.ops.quant import QTensor, qmatmul
from cake_tpu_torch.ops.rope import apply_rope, precompute_rope, rope_rows


class RopeTables(NamedTuple):
    cos: torch.Tensor
    sin: torch.Tensor

    @classmethod
    def create(cls, config: LlamaConfig, max_seq_len: int,
               device="cpu") -> "RopeTables":
        cos, sin = precompute_rope(config.head_dim, max_seq_len,
                                   config.rope_theta, device=device)
        return cls(cos, sin)


def layer_params(blocks: dict, i: int) -> dict:
    """Layer i's leaves of the stacked block dict (views, no copy). A
    quantized leaf is sliced in q and in scale (indexing the NamedTuple
    itself would pick one of its fields)."""
    return {k: (v.layer(i) if isinstance(v, QTensor) else v[i])
            for k, v in blocks.items()}


def block_skeleton(lp, x, config: LlamaConfig, attn_fn):
    """Decoder-block math with a pluggable attention:
    rms -> qkv proj -> attn_fn(q, k, v) -> o_proj -> residual -> rms ->
    SwiGLU -> residual. attn_fn returns (attn [B,S,H,hd], extras).
    lp: one layer's params (leaves without the L axis); x: [B, S, D].
    """
    if "router" in lp:
        raise NotImplementedError(
            "mixture-of-experts blocks (a `router` leaf) are not ported "
            "to cake_tpu_torch yet (ROADMAP A12)")
    B, S, _ = x.shape
    hd = config.head_dim
    H = lp["wq"].shape[-1] // hd
    KV = lp["wk"].shape[-1] // hd

    h = rms_norm(x, lp["attn_norm"], config.rms_norm_eps)
    q = qmatmul(h, lp["wq"])
    k = qmatmul(h, lp["wk"])
    v = qmatmul(h, lp["wv"])
    if "bq" in lp:  # Qwen2-family QKV bias (config.attention_bias)
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    attn, extras = attn_fn(q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
                           v.reshape(B, S, KV, hd))
    x = x + qmatmul(attn.reshape(B, S, H * hd), lp["wo"])

    h = rms_norm(x, lp["mlp_norm"], config.rms_norm_eps)
    gate = F.silu(qmatmul(h, lp["w_gate"]))
    x = x + qmatmul(gate * qmatmul(h, lp["w_up"]), lp["w_down"])
    return x, extras


def block_forward(lp, x, k_cache, v_cache, pos, rope_c, rope_s, mask,
                  config: LlamaConfig, is_prefill: bool = False,
                  chunked: bool = False):
    """One decoder block with its KV-cache write.

    x: [B, S, D]; k_cache/v_cache: one layer's [B, T, KV, hd] (written in
    place at pos; an int or a 0-d device tensor); rope_c/rope_s: [S, hd/2]
    rows of positions pos..;
    mask: [S, T]. chunked: this prefill window continues the cache (pos
    may be > 0), so flash takes the cache-aware kernel; a fresh prefill
    (pos == 0) attends only its own S keys.
    Returns (x, k_cache, v_cache)."""

    def attn_fn(q, k, v):
        q = apply_rope(q, rope_c, rope_s)
        k = apply_rope(k, rope_c, rope_s)
        kc, vc = update_layer_cache(k_cache, v_cache, k, v, pos)
        use_flash = is_prefill and config.use_flash_attention
        if use_flash and not chunked:
            attn = flash_attention(q, k, v, causal=True,
                                   window=config.sliding_window)
        elif use_flash and chunked and kc.dtype == q.dtype:
            attn = flash_attention_cached(q, kc, vc, pos,
                                          window=config.sliding_window)
        else:
            attn = gqa_attention(q, kc, vc, mask=mask)
        return attn, (kc, vc)

    x, (k_cache, v_cache) = block_skeleton(lp, x, config, attn_fn)
    return x, k_cache, v_cache


def run_blocks(blocks, x, cache: KVCache, pos, rope_c, rope_s, mask,
               config: LlamaConfig, is_prefill: bool = False,
               chunked: bool = False):
    """Every block of the stacked [L, ...] params over the hidden state,
    layer i writing cache.k[i] / cache.v[i]. Returns (x, cache)."""
    for i in range(cache.k.shape[0]):
        x, _, _ = block_forward(layer_params(blocks, i), x, cache.k[i],
                                cache.v[i], pos, rope_c, rope_s, mask,
                                config, is_prefill=is_prefill,
                                chunked=chunked)
    return x, cache


def forward(params, tokens, cache: KVCache, pos, rope: RopeTables,
            config: LlamaConfig, last_idx: Optional[torch.Tensor] = None,
            return_hidden: bool = False, is_prefill: bool = False,
            chunked: bool = False):
    """tokens [B, S] at absolute position pos -> (logits [B, V] f32,
    cache). pos: an int (the eager prefills), or a 0-d / [1] tensor on
    the cache's device (the generator's captured decode step): the rope
    rows, the mask and the cache write then read it on the device, so
    one captured step replays at every position. last_idx: [B] index of
    each row's last real token in a right-padded window; defaults to
    S - 1."""
    B, S = tokens.shape
    pos = pos.reshape(()) if isinstance(pos, torch.Tensor) else int(pos)
    x = params["embed"][tokens.long()]
    rope_c, rope_s = rope_rows(rope.cos, rope.sin, pos, S)
    mask = uniform_forward_mask(pos, S, cache.max_seq_len,
                                config.sliding_window, device=x.device)
    x, cache = run_blocks(params["blocks"], x, cache, pos, rope_c, rope_s,
                          mask, config, is_prefill=is_prefill,
                          chunked=chunked)
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    if return_hidden:
        return x, cache
    if last_idx is None:
        last = x[:, -1]
    else:
        last = x[torch.arange(B, device=x.device), last_idx.long()]
    return qmatmul(last, params["lm_head"]).float(), cache


@torch.inference_mode()
def forward_logits_all(params, tokens, cache: KVCache, pos,
                       rope: RopeTables, config: LlamaConfig):
    """Logits at every position [B, S, V] f32 (the scoring path)."""
    x, cache = forward(params, tokens, cache, pos, rope, config,
                       return_hidden=True)
    return qmatmul(x, params["lm_head"]).float(), cache


@torch.inference_mode()
def prefill(params, tokens, prompt_len, cache: KVCache, rope: RopeTables,
            config: LlamaConfig):
    """A right-padded prompt window at position 0. tokens [B, S_padded];
    prompt_len [B]: logits are taken at prompt_len - 1. Padding writes
    KV past the prompt that decode overwrites before it attends it."""
    return forward(params, tokens, cache, 0, rope, config,
                   last_idx=prompt_len - 1, is_prefill=True)


@torch.inference_mode()
def decode_step(params, token, pos, cache: KVCache, rope: RopeTables,
                config: LlamaConfig):
    """One cached decode step: token [B, 1] at absolute pos -> logits."""
    return forward(params, token, cache, pos, rope, config)


@torch.inference_mode()
def prefill_chunk(params, tokens, pos, last_idx, cache: KVCache,
                  rope: RopeTables, config: LlamaConfig):
    """One fixed-size prefill window at absolute position pos (chunked
    prefill of a long prompt); with flash on, attention is the
    cache-aware kernel (ops/flash_attention.flash_attention_cached)."""
    return forward(params, tokens, cache, pos, rope, config,
                   last_idx=last_idx, is_prefill=True, chunked=True)
