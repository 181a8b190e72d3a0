"""Llama-3 forward functions over the dense KV cache.

Counterpart of `cake_tpu/models/llama/model.py`: `RopeTables`,
`block_skeleton`, `block_forward` (its ring branch included), `run_blocks`,
`forward`, `forward_logits_all`, `prefill`, `decode_step`,
`prefill_chunk`; the ragged entry points of the dense engine
(`run_blocks_ragged`, `ragged_decode`, `forward_ragged`,
`decode_step_ragged`, `forward_window_ragged`, `forward_ragged_ring`,
`decode_step_ragged_ring`); and its one-slot prefills (`slot_prefill`,
`prefill_slot`, `prefill_slot_chunk`, `prefill_slot_chunk_ring`,
`install_prefix_slot`, `prefill_slot_prefixed`). Block semantics:
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
`gqa_attention` over the cache. A ring (sliding-window) cache takes the
einsum always: its slots permute key positions, which the kernels'
sequential-position masks cannot express, and a prefill window attends
the PRE-write ring plus its own keys before it writes.

Tensor parallelism (parallel/pipeline.py): `block_skeleton`,
`block_forward`, `run_blocks` and `run_blocks_ragged` take lists with
one entry per tp rank of a pipeline stage (its layer params, its
attention, its cache), and `tp_reduce` sums the ranks' row-parallel wo
and FFN partials (JAX's psum over tp). Unsharded, each list holds the
one whole layer or cache, and the default `tp_sum` of one partial is
that partial itself.

The one-slot prefills splice the slot's lines per layer: `run_blocks`
with `slot` (a [1] int64 tensor on the device, read there, as JAX traces
it) gathers the slot's [1, T, KV, hd] lines of one layer, runs the
block over them and copies them back, so one captured program serves
every slot, and only one layer's lines are ever out of the cache (JAX
slices the whole slot out and writes it back, with the cache donated).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from cake_tpu_torch.models.llama.cache import (
    KVCache, update_layer_cache, update_layer_cache_per_row,
    update_layer_cache_per_row_ring, update_layer_cache_ring,
    update_layer_cache_window_per_row,
)
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.ops.attention import (
    decode_mask_per_row, gqa_attention, ring_decode_mask_per_row,
    uniform_forward_mask,
)
from cake_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_cached,
)
from cake_tpu_torch.ops.moe import moe_mlp
from cake_tpu_torch.ops.norms import rms_norm
from cake_tpu_torch.ops.quant import QTensor, qmatmul
from cake_tpu_torch.ops.rope import (
    apply_rope, precompute_rope, rope_rows, rope_rows_per_row,
)
from cake_tpu_torch.utils.devices import index_copy_rows, take_rows, to_storage


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


def tp_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    """The tp ranks' partials summed in rank order on rank 0's device
    (JAX's psum over tp); a single rank's partial is returned as it
    is."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(out.device)
    return out


def _qkv(lp, x, config: LlamaConfig):
    """rms -> qkv proj: the rank's q [B, S, H, hd] and k, v
    [B, S, KV, hd] (its heads under tp)."""
    B, S, _ = x.shape
    hd = config.head_dim
    H = lp["wq"].shape[-1] // hd      # the rank's heads under tp
    KV = lp["wk"].shape[-1] // hd

    h = rms_norm(x, lp["attn_norm"], config.rms_norm_eps)
    q = qmatmul(h, lp["wq"])
    k = qmatmul(h, lp["wk"])
    v = qmatmul(h, lp["wv"])
    if "bq" in lp:  # Qwen2-family QKV bias (config.attention_bias)
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
            v.reshape(B, S, KV, hd))


def _o_proj(lp, attn):
    """The rank's attention [B, S, H, hd] through its wo (a
    tensor-parallel rank's partial sum)."""
    B, S = attn.shape[:2]
    return qmatmul(attn.reshape(B, S, -1), lp["wo"])


def _attn_partial(lp, x, config: LlamaConfig, attn_fn):
    """rms -> qkv proj -> attn_fn(q, k, v) -> o_proj: the attention's
    output before the residual (a tensor-parallel rank's partial sum),
    and attn_fn's extras."""
    attn, extras = attn_fn(*_qkv(lp, x, config))
    return _o_proj(lp, attn), extras


def _ffn(lp, h, config: LlamaConfig):
    """SwiGLU, or with a `router` leaf the experts' `moe_mlp`, before the
    residual (a tensor-parallel rank's partial sum)."""
    if "router" in lp:
        if not config.is_moe:
            # MoE params paired with a dense config: a real mismatch
            # that must not default silently
            raise NotImplementedError(
                "a mixture-of-experts block (a `router` leaf) runs only "
                "under a MoEConfig: a dense LlamaConfig has no routing")
        return moe_mlp(lp, h, config.num_experts_per_tok)
    gate = F.silu(qmatmul(h, lp["w_gate"]))
    return qmatmul(gate * qmatmul(h, lp["w_up"]), lp["w_down"])


def _device_of(lp) -> torch.device:
    return lp["attn_norm"].device


def block_skeleton(ranks, x, config: LlamaConfig, attn_fns,
                   tp_reduce=tp_sum):
    """Decoder-block math with a pluggable attention:
    rms -> qkv proj -> attn_fn(q, k, v) -> o_proj -> residual -> rms ->
    SwiGLU (or, with a `router` leaf, the experts' `moe_mlp`) ->
    residual. x: [B, S, D].

    ranks: one layer's params (leaves without the L axis) for each tp
    rank of the stage, head-sharded, or the one whole layer unsharded;
    attn_fns: each rank's attention over its heads, returning
    (attn [B,S,H,hd], extras). Each rank runs on its own device, and
    tp_reduce(partials) sums the ranks' row-parallel outputs of wo and
    of the FFN (JAX's `tp_axis` psum; the residual stream stays whole).
    Head counts come from the weight shapes, so the same math runs on
    full or sharded weights. Returns (x, [each rank's extras])."""
    parts, extras = [], []
    for lp, attn_fn in zip(ranks, attn_fns):
        out, ex = _attn_partial(lp, x.to(_device_of(lp)), config, attn_fn)
        parts.append(out)
        extras.append(ex)
    x = x + tp_reduce(parts)
    return _ffn_residual(ranks, x, config, tp_reduce), extras


def _ffn_residual(ranks, x, config: LlamaConfig, tp_reduce):
    """rms -> each rank's FFN -> the partials summed -> residual."""
    parts = []
    for lp in ranks:
        h = rms_norm(x.to(_device_of(lp)), lp["mlp_norm"],
                     config.rms_norm_eps)
        parts.append(_ffn(lp, h, config))
    return x + tp_reduce(parts)


def block_qkv(ranks, x, config: LlamaConfig) -> list:
    """block_skeleton's first half, for an attention that needs every
    chunk's keys before any chunk's output (sequence parallelism's
    ring): each rank's (q, k, v) of its heads, on its device."""
    return [_qkv(lp, x.to(_device_of(lp)), config) for lp in ranks]


def block_finish(ranks, x, attns, config: LlamaConfig, tp_reduce=tp_sum):
    """block_skeleton's second half: each rank's attention [B, S, H, hd]
    through its wo, the partials summed (tp_reduce), the residual, then
    the FFN (or the experts') half. Returns x."""
    x = x + tp_reduce([_o_proj(lp, a) for lp, a in zip(ranks, attns)])
    return _ffn_residual(ranks, x, config, tp_reduce)


def _to(t, dev):
    return t.to(dev) if isinstance(t, torch.Tensor) else t


def _block_attn(k_cache, v_cache, pos, rope_c, rope_s, mask,
                config: LlamaConfig, is_prefill: bool, chunked: bool,
                ring: bool, write_len):
    """block_forward's attention with its cache write (see there)."""
    def attn_fn(q, k, v):
        q = apply_rope(q, rope_c, rope_s)
        k = apply_rope(k, rope_c, rope_s)
        if ring:
            # the keys as the ring will store them, concatenated after
            # the pre-write ring (JAX concatenates in the cache dtype;
            # gqa_attention reads both in q's)
            k_full = torch.cat([k_cache.to(q.dtype),
                                to_storage(k, k_cache.dtype).to(q.dtype)],
                               dim=1)
            v_full = torch.cat([v_cache.to(q.dtype),
                                to_storage(v, v_cache.dtype).to(q.dtype)],
                               dim=1)
            attn = gqa_attention(q, k_full, v_full, mask=mask)
            kc, vc = update_layer_cache_ring(k_cache, v_cache, k, v, pos,
                                             n_real=write_len)
            return attn, (kc, vc)
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
    return attn_fn


def block_forward(ranks, x, k_caches, v_caches, pos, rope_c, rope_s, mask,
                  config: LlamaConfig, is_prefill: bool = False,
                  chunked: bool = False, ring: bool = False,
                  write_len=None, tp_reduce=tp_sum):
    """One decoder block with its KV-cache write.

    x: [B, S, D]; ranks, k_caches, v_caches: each tp rank's layer params
    and its one layer's [B, T, KV, hd] lines (`block_skeleton`; one entry
    unsharded), written in place at pos (an int or a 0-d device tensor);
    rope_c/rope_s: [S, hd/2] rows of positions pos..;
    mask: [S, T] ([S, W + S] over a ring). Each rank's positions, rope
    rows and mask move to its device. chunked: this prefill window
    continues the cache (pos may be > 0), so flash takes the cache-aware
    kernel; a fresh prefill (pos == 0) attends only its own S keys.
    ring: k_cache/v_cache are W-slot rings: attend the pre-write ring
    plus the fresh window, then write slots (pos + i) % W, the first
    write_len entries only (the rest is a padded window's junk).
    Returns (x, k_caches, v_caches)."""
    fns = []
    for kc, vc in zip(k_caches, v_caches):
        dev = kc.device
        fns.append(_block_attn(kc, vc, _to(pos, dev), rope_c.to(dev),
                               rope_s.to(dev), _to(mask, dev), config,
                               is_prefill, chunked, ring,
                               _to(write_len, dev)))
    x, extras = block_skeleton(ranks, x, config, fns, tp_reduce=tp_reduce)
    return x, [e[0] for e in extras], [e[1] for e in extras]


def run_blocks(blocks, x, caches, pos, rope_c, rope_s, mask,
               config: LlamaConfig, is_prefill: bool = False,
               chunked: bool = False, ring: bool = False, write_len=None,
               slot=None, prefixes=None, tp_reduce=tp_sum):
    """Every block of the stacked [L, ...] params over the hidden state,
    layer i writing cache.k[i] / cache.v[i]. blocks, caches: each tp
    rank's stacked params and KVCache (`block_skeleton`; one entry
    unsharded). slot: a [1] int64 tensor on the device; layer i then
    runs over that batch slot's lines only, gathered out and copied back
    (the one-slot prefills' splice). prefixes: each rank's (k, v)
    [L, 1, P, KV, hd], written over the slot's positions 0..P-1 first
    (a prefix hit). Returns (x, caches)."""
    for i in range(caches[0].k.shape[0]):
        kcs, vcs = [], []
        for r, c in enumerate(caches):
            kc, vc = c.k[i], c.v[i]
            if slot is not None:
                s = slot.to(kc.device)
                kc, vc = take_rows(kc, s), take_rows(vc, s)
                if prefixes is not None:
                    pk, pv = prefixes[r]
                    P = pk.shape[2]
                    kc[:, :P] = pk[i]
                    vc[:, :P] = pv[i]
            kcs.append(kc)
            vcs.append(vc)
        x, _, _ = block_forward([layer_params(b, i) for b in blocks], x,
                                kcs, vcs, pos, rope_c, rope_s, mask, config,
                                is_prefill=is_prefill, chunked=chunked,
                                ring=ring, write_len=write_len,
                                tp_reduce=tp_reduce)
        if slot is not None:
            for c, kc, vc in zip(caches, kcs, vcs):
                s = slot.to(kc.device)
                index_copy_rows(c.k[i], 0, s, kc)
                index_copy_rows(c.v[i], 0, s, vc)
    return x, caches


def forward(params, tokens, cache: KVCache, pos, rope: RopeTables,
            config: LlamaConfig, last_idx: Optional[torch.Tensor] = None,
            return_hidden: bool = False, is_prefill: bool = False,
            chunked: bool = False, ring: bool = False, write_len=None,
            slot=None, prefix=None):
    """tokens [B, S] at absolute position pos -> (logits [B, V] f32,
    cache). pos: an int (the eager prefills), or a 0-d / [1] tensor on
    the cache's device (the captured steps): the rope rows, the mask and
    the cache write then read it on the device, so one captured step
    replays at every position. last_idx: [B] index of each row's last
    real token in a right-padded window; defaults to S - 1. ring,
    write_len: the ring cache's window (`block_forward`); slot, prefix:
    the one-slot splice (`run_blocks`)."""
    B, S = tokens.shape
    pos = pos.reshape(()) if isinstance(pos, torch.Tensor) else int(pos)
    x = params["embed"][tokens.long()]
    rope_c, rope_s = rope_rows(rope.cos, rope.sin, pos, S)
    mask = uniform_forward_mask(pos, S, cache.max_seq_len,
                                config.sliding_window, ring=ring,
                                n_real=write_len, device=x.device)
    x, _ = run_blocks([params["blocks"]], x, [cache], pos, rope_c, rope_s,
                      mask, config, is_prefill=is_prefill, chunked=chunked,
                      ring=ring, write_len=write_len, slot=slot,
                      prefixes=None if prefix is None else [prefix])
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


# -- ragged (per-row position) entry points for continuous batching ----------


def run_blocks_ragged(blocks, x, caches, pos, active, rope_c, rope_s,
                      mask, config: LlamaConfig, ring: bool = False,
                      cache_update=None, tp_reduce=tp_sum):
    """Every block for per-row-position ragged decode.

    x: [B, S, D]; pos/active: [B]; rope_c/rope_s: [B, S, hd/2] per-row
    rows; mask: [B, S, T]. S = 1 for single-token decode; the batched
    speculative verify passes S = gamma + 1 windows with its own
    cache_update. Inactive rows compute garbage and leave their cache
    lines untouched. blocks, caches: each tp rank's stacked params and
    KVCache (`block_skeleton`; one entry unsharded), each rank's rows
    moved to its device. cache_update(kc, vc, k, v) -> (kc, vc): the
    per-layer KV write (unsharded only); default the single-token
    per-row write (ring-modular with ring). Returns (x, caches)."""
    write = (update_layer_cache_per_row_ring if ring
             else update_layer_cache_per_row)
    for i in range(caches[0].k.shape[0]):
        fns = []
        for c in caches:
            dev = c.k.device
            update = cache_update or functools.partial(
                write, pos=pos.to(dev), active=active.to(dev))
            fns.append(_ragged_attn(c.k[i], c.v[i], rope_c.to(dev),
                                    rope_s.to(dev), mask.to(dev), update))
        x, _ = block_skeleton([layer_params(b, i) for b in blocks], x,
                              config, fns, tp_reduce=tp_reduce)
    return x, caches


def _ragged_attn(kc, vc, rope_c, rope_s, mask, cache_update):
    def attn_fn(q, k, v):
        q = apply_rope(q, rope_c, rope_s)
        k = apply_rope(k, rope_c, rope_s)
        kc2, vc2 = cache_update(kc, vc, k, v)
        return gqa_attention(q, kc2, vc2, mask=mask), (kc2, vc2)
    return attn_fn


def ragged_decode(params, tokens, pos, active, cache: KVCache,
                  rope: RopeTables, config: LlamaConfig, ring: bool = False):
    """Per-row-position single-token decode: embedding -> per-row rope
    rows and mask -> the blocks -> final norm -> logits [B, V] f32."""
    T = cache.max_seq_len
    x = params["embed"][tokens.long()]
    rope_c, rope_s = rope_rows_per_row(rope.cos, rope.sin, pos.long())
    if ring:
        mask = ring_decode_mask_per_row(pos, T)
    else:
        mask = decode_mask_per_row(pos, T, window=config.sliding_window)
    x, _ = run_blocks_ragged([params["blocks"]], x, [cache], pos, active,
                             rope_c, rope_s, mask, config, ring=ring)
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    return qmatmul(x[:, -1], params["lm_head"]).float(), cache


def forward_ragged(params, tokens, cache: KVCache, pos, active,
                   rope: RopeTables, config: LlamaConfig):
    """Single-token decode where every row sits at its own position.
    tokens [B, 1]; pos [B] absolute positions (device tensor); active [B]
    bool: inactive rows (free slots) compute garbage and keep their
    cache lines. Returns (logits [B, V] f32, cache)."""
    return ragged_decode(params, tokens, pos, active, cache, rope, config)


@torch.inference_mode()
def decode_step_ragged(params, tokens, pos, active, cache: KVCache,
                       rope: RopeTables, config: LlamaConfig):
    """The dense engine's ragged decode step."""
    return forward_ragged(params, tokens, cache, pos, active, rope, config)


def forward_window_ragged(params, tokens, cache: KVCache, pos0, active,
                          rope: RopeTables, config: LlamaConfig):
    """Score a W-token window per row, each row at its own start
    position (the batched speculative verify). tokens [B, W]; pos0 [B];
    active [B]. Row b's token j sits at pos0[b] + j, attends cache slots
    <= pos0[b] + j and writes its KV there. Returns (logits [B, W, V]
    f32, cache). Sliding-window configs are gated off speculation."""
    B, W = tokens.shape
    T = cache.max_seq_len
    dev = tokens.device
    x = params["embed"][tokens.long()]                    # [B, W, D]
    p = torch.clamp(pos0.long()[:, None] + torch.arange(W, device=dev)[None],
                    0, T - 1)                              # [B, W]
    rope_c, rope_s = rope.cos[p], rope.sin[p]              # [B, W, hd/2]
    kj = torch.arange(T, device=dev)[None, None, :]
    mask = kj <= p[:, :, None]                             # [B, W, T]

    def window_update(kc, vc, k, v):
        return update_layer_cache_window_per_row(kc, vc, k, v, pos0, active)

    x, _ = run_blocks_ragged([params["blocks"]], x, [cache], pos0, active,
                             rope_c, rope_s, mask, config,
                             cache_update=window_update)
    x = rms_norm(x, params["final_norm"], config.rms_norm_eps)
    return qmatmul(x, params["lm_head"]).float(), cache


def forward_ragged_ring(params, tokens, cache: KVCache, pos, active,
                        rope: RopeTables, config: LlamaConfig):
    """forward_ragged over a ring cache: position p writes slot p % W,
    and validity is ring-slot liveness (`ring_decode_mask_per_row`)."""
    return ragged_decode(params, tokens, pos, active, cache, rope, config,
                         ring=True)


@torch.inference_mode()
def decode_step_ragged_ring(params, tokens, pos, active, cache: KVCache,
                            rope: RopeTables, config: LlamaConfig):
    """The ring engine's ragged decode step (KV memory = the window, not
    max_seq)."""
    return forward_ragged_ring(params, tokens, cache, pos, active, rope,
                               config)


# -- one-slot prefills of the dense engine -------------------------------------


def _slot_index(slot, device) -> torch.Tensor:
    """The slot as a [1] int64 tensor on `device` (a captured prefill
    passes its device buffer; an int is uploaded)."""
    if isinstance(slot, torch.Tensor):
        return slot.reshape(1).long()
    return torch.tensor([int(slot)], dtype=torch.int64, device=device)


def slot_prefill(params, tokens, prompt_len, slot, cache: KVCache,
                 forward_fn, prefix=None, pos0=None):
    """Prefill ONE request into batch slot `slot` of the shared cache.

    tokens [1, S_padded]; prompt_len [1]; slot: an int or a device
    tensor. forward_fn(params, tokens, cache, pos0, last_idx, slot=,
    prefix=) runs the window over the slot's lines only (`run_blocks`'
    splice), so the other slots' state is untouched and requests are
    admitted while their neighbours decode. prefix: (k, v)
    [L, 1, P, KV, hd], a cached prompt head written at positions
    0..P-1 first, the window then starting at P. pos0: the window's
    start (chunked prefill); exclusive with prefix."""
    assert prefix is None or pos0 is None, "prefix implies its own pos0"
    if prefix is not None:
        pos0 = prefix[0].shape[2]
    elif pos0 is None:
        pos0 = 0
    last_idx = prompt_len - 1
    return forward_fn(params, tokens, cache, pos0, last_idx,
                      slot=_slot_index(slot, cache.k.device), prefix=prefix)


@torch.inference_mode()
def prefill_slot(params, tokens, prompt_len, slot, cache: KVCache,
                 rope: RopeTables, config: LlamaConfig):
    """Whole-prompt slot prefill (one program per bucket length in JAX):
    flash over the window's own keys when flash is on."""
    def fwd(p, t, c, pos, last_idx, **kw):
        return forward(p, t, c, pos, rope, config, last_idx=last_idx,
                       is_prefill=True, **kw)

    return slot_prefill(params, tokens, prompt_len, slot, cache, fwd)


@torch.inference_mode()
def prefill_slot_chunk(params, tokens, n_real, slot, pos0, cache: KVCache,
                       rope: RopeTables, config: LlamaConfig):
    """One fixed-size prefill window into batch slot `slot` at absolute
    position pos0 (engine-side chunked prefill: one program per window
    shape). tokens [1, C]; n_real [1] the real tokens in the window."""
    def fwd(p, t, c, pos, last_idx, **kw):
        return forward(p, t, c, pos, rope, config, last_idx=last_idx,
                       is_prefill=True, chunked=True, **kw)

    return slot_prefill(params, tokens, n_real, slot, cache, fwd, pos0=pos0)


@torch.inference_mode()
def prefill_slot_chunk_ring(params, tokens, n_real, slot, pos0,
                            cache: KVCache, rope: RopeTables,
                            config: LlamaConfig):
    """prefill_slot_chunk over a ring cache: the queries attend the
    pre-write ring plus the fresh window (`ring_concat_mask`), then the
    window writes ring slots (pos0 + i) % W, its padding masked. Every
    ring prompt walks through this (windows <= W keep the slots
    unique)."""
    n = n_real.reshape(()) if isinstance(n_real, torch.Tensor) else n_real

    def fwd(p, t, c, pos, last_idx, **kw):
        return forward(p, t, c, pos, rope, config, last_idx=last_idx,
                       is_prefill=True, chunked=True, ring=True,
                       write_len=n, **kw)

    return slot_prefill(params, tokens, n_real, slot, cache, fwd, pos0=pos0)


@torch.inference_mode()
def install_prefix_slot(cache: KVCache, prefix_k, prefix_v, slot):
    """Copy cached-prefix KV [L, 1, P, KV, hd] into slot `slot` at
    positions 0..P-1 (a prefix hit whose suffix prefills in windows: the
    install and the windows are separate programs)."""
    P = prefix_k.shape[2]
    s = _slot_index(slot, cache.k.device)
    index_copy_rows(cache.k[:, :, :P], 1, s, prefix_k)
    index_copy_rows(cache.v[:, :, :P], 1, s, prefix_v)
    return cache


@torch.inference_mode()
def prefill_slot_prefixed(params, tokens, suffix_len, slot, prefix_k,
                          prefix_v, cache: KVCache, rope: RopeTables,
                          config: LlamaConfig):
    """Slot prefill continuing a cached prefix: the prefix KV
    [L, 1, P, KV, hd] is written at the slot's positions 0..P-1, then
    the suffix window [1, S_padded] prefills at position P through the
    cache-aware (chunked) path. One program per (P, suffix bucket)."""
    def fwd(p, t, c, pos, last_idx, **kw):
        return forward(p, t, c, pos, rope, config, last_idx=last_idx,
                       is_prefill=True, chunked=True, **kw)

    return slot_prefill(params, tokens, suffix_len, slot, cache, fwd,
                        prefix=(prefix_k, prefix_v))
