"""Dense KV cache of the sequential generator.

Counterpart of `cake_tpu/models/llama/cache.py` (`KVCache`,
`update_layer_cache`): preallocated `[L, B, max_seq, KV, hd]` buffers,
written at an absolute position each step. The JAX writes return new
buffers; here they write IN PLACE (the model steps run under
torch.inference_mode) and return the same tensors, so the signatures
match. The ring (sliding-window) writers are not ported.
"""

from __future__ import annotations

import torch

from cake_tpu_torch.models.llama.config import LlamaConfig


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

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[2]


def update_layer_cache(k_cache, v_cache, new_k, new_v, pos: int):
    """Write one layer's new k/v at absolute position `pos`, in place.

    k_cache/v_cache: [B, S_max, KV, hd]; new_k/new_v: [B, S, KV, hd].
    The start is read as `lax.dynamic_update_slice` reads it: a negative
    one counts from the end, then it is clamped into [0, S_max - S], so a
    window that would run past the cache is shifted back and written
    whole, never dropped. Returns (k_cache, v_cache)."""
    S, T = new_k.shape[1], k_cache.shape[1]
    if S > T:
        raise ValueError(f"a window of {S} tokens does not fit a cache of "
                         f"{T}")
    start = int(pos)
    start = min(max(start + T if start < 0 else start, 0), T - S)
    k_cache[:, start:start + S] = new_k.to(k_cache.dtype)
    v_cache[:, start:start + S] = new_v.to(v_cache.dtype)
    return k_cache, v_cache
