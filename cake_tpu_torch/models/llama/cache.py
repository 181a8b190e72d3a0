"""Dense KV cache of the sequential generator.

Counterpart of `cake_tpu/models/llama/cache.py` (`KVCache`,
`update_layer_cache` and the ragged and ring writers
`update_layer_cache_per_row`, `_ring`, `_per_row_ring` and
`_window_per_row`): preallocated `[L, B, max_seq, KV, hd]` buffers (a
ring cache holds W = sliding window positions instead, position p in
slot p % W), written at an absolute position each step. The JAX writes
return new buffers; here they write IN PLACE (the model steps run under
torch.inference_mode) and return the same tensors, so the signatures
match. Every position a writer takes may be a tensor on the cache's
device, read there, so a captured step replays at any position; a row
or a window entry the writer must leave alone is written back with its
old line (`torch.where`), never skipped by a host branch.
"""

from __future__ import annotations

import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.utils.devices import (
    FP8_DTYPES, index_copy_rows, to_storage, zero_,
)


class KVCache:
    """Stacked per-layer KV buffers. k/v: [L, B, S_max, KV, hd]."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k = k
        self.v = v

    @classmethod
    def create(cls, config: LlamaConfig, batch_size: int, max_seq_len: int,
               dtype=torch.bfloat16, device="cuda") -> "KVCache":
        shape = (config.num_hidden_layers, batch_size, max_seq_len,
                 config.num_key_value_heads, config.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    def fresh(self) -> "KVCache":
        """A zeroed cache of the same spec (a new allocation)."""
        return KVCache(torch.zeros_like(self.k), torch.zeros_like(self.v))

    def zero_(self) -> "KVCache":
        """Zero both buffers in place (their storage, which a captured
        step holds, stays where it is). Returns the cache."""
        zero_(self.k)
        zero_(self.v)
        return self

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[2]

    @property
    def batch_size(self) -> int:
        return self.k.shape[1]

    def memory_bytes(self) -> int:
        """Bytes of both buffers."""
        return 2 * self.k.numel() * self.k.element_size()


def update_layer_cache(k_cache, v_cache, new_k, new_v, pos):
    """Write one layer's new k/v at absolute position `pos`, in place.

    k_cache/v_cache: [B, S_max, KV, hd]; new_k/new_v: [B, S, KV, hd].
    The start is read as `lax.dynamic_update_slice` reads it: a negative
    one counts from the end, then it is clamped into [0, S_max - S], so a
    window that would run past the cache is shifted back and written
    whole, never dropped. pos: an int, or a 0-d / [1] tensor on the
    cache's device, read there (an index_copy_, so a captured step
    replays at any position). The window is cast to the cache's storage
    as JAX casts it (`to_storage`: an fp8 cache gets XLA's bytes).
    Returns (k_cache, v_cache)."""
    S, T = new_k.shape[1], k_cache.shape[1]
    if S > T:
        raise ValueError(f"a window of {S} tokens does not fit a cache of "
                         f"{T}")
    if isinstance(pos, torch.Tensor):
        p = pos.reshape(()).long()
        start = torch.where(p < 0, p + T, p).clamp(0, T - S)
        idx = start + torch.arange(S, device=k_cache.device)
        index_copy_rows(k_cache, 1, idx, new_k)
        index_copy_rows(v_cache, 1, idx, new_v)
        return k_cache, v_cache
    start = int(pos)
    start = min(max(start + T if start < 0 else start, 0), T - S)
    k_cache[:, start:start + S] = to_storage(new_k, k_cache.dtype)
    v_cache[:, start:start + S] = to_storage(new_v, v_cache.dtype)
    return k_cache, v_cache


def _blend_rows(cache, idx, sel, new) -> None:
    """cache[idx] = where(sel, new, cache[idx]) in place, `new` cast to
    the cache's storage first (`to_storage`); an fp8 cache is indexed
    and selected as its bytes, which every device and torch version
    implements."""
    new = to_storage(new, cache.dtype)
    if cache.dtype in FP8_DTYPES:
        cache, new = cache.view(torch.uint8), new.view(torch.uint8)
    cache[idx] = torch.where(sel, new, cache[idx])


def update_layer_cache_per_row(k_cache, v_cache, new_k, new_v, pos, active):
    """Write one new k/v per row at that row's own position (ragged
    decode), in place.

    k_cache/v_cache: [B, S_max, KV, hd]; new_k/new_v: [B, 1, KV, hd];
    pos: [B] absolute positions; active: [B] bool. An inactive row keeps
    its line (its pos may be stale: a retired slot must not corrupt
    state a later prefill will not overwrite)."""
    b = torch.arange(k_cache.shape[0], device=k_cache.device)
    idx = (b, pos.long())
    sel = active[:, None, None]
    _blend_rows(k_cache, idx, sel, new_k[:, 0])
    _blend_rows(v_cache, idx, sel, new_v[:, 0])
    return k_cache, v_cache


def update_layer_cache_ring(k_cache, v_cache, new_k, new_v, pos,
                            n_real=None):
    """Write S <= W new k/v at ring slots (pos + i) % W, in place.

    k_cache/v_cache: [B, W, KV, hd] ring buffers; new_k/new_v:
    [B, S, KV, hd]; pos: the absolute start (an int or a 0-d tensor);
    n_real: the count of REAL tokens in the window (an int or a tensor):
    entries i >= n_real keep the slot's content, since a padded window's
    junk would otherwise overwrite ring slots of positions still inside
    later queries' windows."""
    W, S = k_cache.shape[1], new_k.shape[1]
    assert S <= W, f"ring write of {S} tokens exceeds ring capacity {W}"
    dev = k_cache.device
    i = torch.arange(S, device=dev)
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(()).long()
    slots = torch.remainder(pos + i, W)                      # [S] unique
    if n_real is None:
        real = torch.ones(S, dtype=torch.bool, device=dev)
    else:
        if isinstance(n_real, torch.Tensor):
            n_real = n_real.reshape(()).long()
        real = i < n_real
    idx = (slice(None), slots)
    sel = real[None, :, None, None]
    _blend_rows(k_cache, idx, sel, new_k)
    _blend_rows(v_cache, idx, sel, new_v)
    return k_cache, v_cache


def update_layer_cache_per_row_ring(k_cache, v_cache, new_k, new_v, pos,
                                    active):
    """Ragged single-token ring write: row b writes at slot pos[b] % W."""
    W = k_cache.shape[1]
    return update_layer_cache_per_row(k_cache, v_cache, new_k, new_v,
                                      torch.remainder(pos.long(), W), active)


def update_layer_cache_window_per_row(k_cache, v_cache, new_k, new_v,
                                      pos0, active):
    """Write a W-token window per row at that row's own start position
    (the batched speculative verify: row b's token j lands at absolute
    position pos0[b] + j), in place.

    k_cache/v_cache: [B, S_max, KV, hd]; new_k/new_v: [B, W, KV, hd];
    pos0: [B] absolute starts; active: [B] bool, an inactive row keeps
    its lines. Indices clamp at S_max - 1 (callers bound pos0 + W <=
    S_max; the clamp only guards inactive rows' stale pos0)."""
    B, W = new_k.shape[:2]
    dev = k_cache.device
    b = torch.arange(B, device=dev)[:, None]
    idx = torch.clamp(pos0.long()[:, None] + torch.arange(W, device=dev)[None],
                      0, k_cache.shape[1] - 1)
    sel = active[:, None, None, None]
    _blend_rows(k_cache, (b, idx), sel, new_k)
    _blend_rows(v_cache, (b, idx), sel, new_v)
    return k_cache, v_cache
