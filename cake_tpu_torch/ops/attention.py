"""Attention: grouped-query attention with softmax in f32.

Counterpart of `cake_tpu/ops/attention.py` (`gqa_attention`,
`causal_mask`, and the dense-cache masks `decode_mask` and
`uniform_forward_mask`; the ring-cache masks are not ported) plus the
port's own copy of the online-softmax stats pair from
`cake_tpu/parallel/context_parallel.py`
(`partial_attention_stats`, `merge_attention_stats`), which the paged
folds use. GQA groups the query heads of each kv head instead of
materialising a repeated K/V.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _kv_as_q(q, k, v):
    """K/V in q's dtype, as the JAX code casts them before its dots
    (with bf16 activations an f32 pool is rounded to bf16 on read)."""
    if k.dtype != q.dtype:
        k = k.to(q.dtype)
        v = v.to(q.dtype)
    return k, v


def gqa_attention(q, k, v, *, mask=None, scale: float | None = None):
    """Grouped-query attention over an arbitrary KV window.

    q:    [B, S, H,  hd]   (H = num attention heads)
    k,v:  [B, T, KV, hd]   (KV divides H; T >= S)
    mask: boolean, broadcastable to [B, H, S, T]; True = attend.
    Returns [B, S, H, hd] in q.dtype.
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    k, v = _kv_as_q(q, k, v)
    qg = q.reshape(B, S, KV, G, hd).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    if mask is not None:
        m = mask
        if m.dim() == 4:      # [B, H, S, T] -> [B, KV, G, S, T]
            m = m.reshape(B, KV, G, S, T)
        elif m.dim() == 3:    # [B, S, T] per-row (ragged decode)
            m = m[:, None, None, :, :]
        elif m.dim() == 2:    # [S, T]
            m = m[None, None, None, :, :]
        scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def causal_mask(seq_len: int, device="cpu") -> torch.Tensor:
    """[S, S] lower-triangular causal mask."""
    i = torch.arange(seq_len, device=device)
    return i[None, :] <= i[:, None]


def decode_mask(pos: int, seq_len: int, max_seq_len: int, window=None,
                device="cpu") -> torch.Tensor:
    """[S, T] mask for cached attention: query i (at absolute pos + i)
    may attend cache slots j <= pos + i, and with a sliding window also
    j > pos + i - window (at most `window` most-recent positions)."""
    qi = torch.arange(seq_len, device=device)[:, None] + pos
    kj = torch.arange(max_seq_len, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > qi - window
    return m


def uniform_forward_mask(pos: int, seq_len: int, max_seq_len: int, window,
                         device="cpu") -> torch.Tensor:
    """The mask of a uniform-position forward over the dense cache:
    `decode_mask` over [S, T], windowed for sliding-window models."""
    return decode_mask(pos, seq_len, max_seq_len, window=window,
                       device=device)


def partial_attention_stats(q, k, v, valid, *, scale: float | None = None):
    """Partial attention of q against a KV window, returning
    unnormalised online-softmax stats for merging.

    q: [B, S, H, hd]; k, v: [B, T, KV, hd]; valid: bool [B, 1, 1, S, T]
    (or broadcastable) marking which slots may be attended.
    Returns (m, l, o): [B,KV,G,S,1], [B,KV,G,S,1], [B,KV,G,S,hd] f32.
    """
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    k, v = _kv_as_q(q, k, v)
    qg = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s <= NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    # p rounds to the value dtype before the value dot, as the JAX fold
    o = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(), v.float())
    return m, l, o


def merge_attention_stats(stats_list):
    """Merge (m, l, o) online-softmax stats and normalise; a query with
    no attended slot (l == 0) outputs zeros."""
    m_g = torch.stack([m for m, _, _ in stats_list]).amax(dim=0)
    l_g = 0.0
    o_g = 0.0
    for m, l, o in stats_list:
        w = torch.exp(m - m_g)
        l_g = l_g + w * l
        o_g = o_g + w * o
    l_g = torch.where(l_g == 0.0, torch.ones_like(l_g), l_g)
    return o_g / l_g
