"""Rotary position embeddings, rotate-half (NeoX / HF-Llama) variant.

Counterpart of `cake_tpu/ops/rope.py`: cos/sin tables precomputed once
per process for every position, rows gathered per call.
"""

from __future__ import annotations

import torch


def precompute_rope(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                    device="cpu", dtype=torch.float32):
    """(cos, sin) tables of shape [max_seq_len, head_dim//2]."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)  # [S, hd/2]
    return freqs.cos().to(dtype), freqs.sin().to(dtype)


def rope_rows(cos, sin, pos, seq_len: int):
    """Rows [pos : pos+seq_len] of the tables, the start clamped into
    [0, T - seq_len] as `lax.dynamic_slice` clamps it. pos: an int, or a
    0-d / [1] tensor on the tables' device, read there (an index_select,
    so a captured step replays at any position)."""
    T = cos.shape[0]
    if not isinstance(pos, torch.Tensor):
        start = min(max(int(pos), 0), T - seq_len)
        return cos[start:start + seq_len], sin[start:start + seq_len]
    idx = (pos.reshape(()).long().clamp(0, T - seq_len)
           + torch.arange(seq_len, device=cos.device))
    return cos.index_select(0, idx), sin.index_select(0, idx)


def rope_rows_per_row(cos, sin, pos: torch.Tensor):
    """One table row per batch element (ragged decode).

    pos: [B] absolute positions -> (cos, sin) of shape [B, 1, head_dim//2],
    ready for `apply_rope` in per-row mode.
    """
    return cos[pos][:, None, :], sin[pos][:, None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE.

    x:        [batch, seq, heads, head_dim]
    cos/sin:  [seq, head_dim//2] shared across the batch, or
              [batch, seq, head_dim//2] per-row (ragged decode).
    """
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        c = cos[None, :, None, :].float()
        s = sin[None, :, None, :].float()
    else:
        c = cos[:, :, None, :].float()
        s = sin[:, :, None, :].float()
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
