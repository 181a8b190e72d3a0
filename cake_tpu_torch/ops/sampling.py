"""Token sampling: argmax / temperature / top-k / top-p + repeat penalty.

Counterpart of `cake_tpu/ops/sampling.py`. Token history is a fixed
[B, repeat_last_n] ring buffer (pad slots = -1). The sequential
generator draws from one `torch.Generator` a stream (`sample_tokens`).
The engine's rows draw from counter-based streams instead
(`sample_tokens_ragged`, `masked_sample`): row b's uniforms at a step
are a hash of (seed[b], counter[b], token id) in integer tensor ops, so
a row's draw depends only on its own state, the state is two device
tensors that advance only where the row is live (as the JAX engine
advances its keys), and the CUDA graph of the decode step holds it. The
streams differ from JAX's threefry keys, so tests hold sampled paths by
support and greedy paths by identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    repeat_penalty: float = 1.1
    repeat_last_n: int = 128

    @property
    def greedy(self) -> bool:
        return self.temperature is None or self.temperature <= 0.0


def _recent_hits(logits, recent_tokens):
    """[B, V] bool: token v appears in row b's ring (-1 = empty)."""
    V = logits.shape[1]
    valid = recent_tokens >= 0
    ids = recent_tokens.clamp(0, V - 1).long()
    hits = torch.zeros(logits.shape, dtype=torch.int32,
                       device=logits.device)
    hits.scatter_add_(1, ids, valid.to(torch.int32))
    return hits > 0


def apply_repeat_penalty(logits, recent_tokens, penalty: float):
    """Penalise recently-generated tokens: positive logits are divided
    by the penalty, negative ones multiplied.

    logits:        [B, V] f32
    recent_tokens: [B, N] int, -1 marks empty ring-buffer slots
    """
    if penalty == 1.0:
        return logits
    hit = _recent_hits(logits, recent_tokens)
    penalised = torch.where(logits >= 0.0, logits / penalty,
                            logits * penalty)
    return torch.where(hit, penalised, logits)


def _apply_repeat_penalty_per_row(logits, recent_tokens, penalty):
    """Like `apply_repeat_penalty` but penalty is a [B] tensor."""
    hit = _recent_hits(logits, recent_tokens)
    pen = penalty[:, None]
    penalised = torch.where(logits >= 0.0, logits / pen, logits * pen)
    return torch.where(hit, penalised, logits)


def _mask_top_k(logits, k: int):
    """Keep only the k largest logits per row."""
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, -torch.inf),
                       logits)


def _mask_top_p(logits, p):
    """Nucleus filtering: keep the smallest set of tokens whose
    cumulative probability exceeds p; the top token always survives.
    p: a float, or a [B] tensor of per-row thresholds."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    if isinstance(p, torch.Tensor):
        p = p.clamp(0.0, 1.0)[:, None]
    # keep entries where the cumulative mass *before* them is < p
    keep = (cum - probs) < p
    keep[..., 0] = True
    kth = torch.where(keep, sorted_logits,
                      torch.full_like(sorted_logits, torch.inf))
    kth = kth.amin(dim=-1, keepdim=True)
    return torch.where(logits < kth, torch.full_like(logits, -torch.inf),
                       logits)


def _exponential_race(probs, generator):
    """One index per row drawn with probability probs[row]: argmax of
    p / E with E ~ Exp(1) (the Gumbel-max trick)."""
    e = torch.empty_like(probs).exponential_(generator=generator)
    return torch.argmax(probs / e, dim=-1)


# -- the engine's counter-based streams -----------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant:
    c is split into 16-bit halves so that no product leaves int64 (the
    CPU and the card then give the same bits)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def hash32(x):
    """A 32-bit integer mixer (Wellons' lowbias32) over int64 tensors
    holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def random_bits(seeds, counters, n: int):
    """[B, n] int64 hash bits in [0, 2**32): row b's n draws at its
    counter, a function of (seeds[b], counters[b], column) alone."""
    key = hash32((hash32((seeds.long() & _M32) ^ 0x5BD1E995)
                  + counters.long()) & _M32)
    col = torch.arange(1, n + 1, device=seeds.device, dtype=torch.int64)
    h = hash32((key[:, None] + col[None, :] * 0x9E3779B9) & _M32)
    return hash32(h ^ key[:, None])


def exponentials(seeds, counters, n: int):
    """[B, n] f32 Exp(1) draws from the rows' streams: 24 bits of each
    hash as a uniform in (0, 1), then -log."""
    u = ((random_bits(seeds, counters, n) >> 8).float() + 0.5) * 2.0 ** -24
    return -torch.log(u)


def sample_tokens(generator: Optional[torch.Generator], logits,
                  recent_tokens, config: SamplingConfig):
    """Sample next token ids for one stream of rows: logits [B, V] ->
    [B] int64. Greedy configs take the argmax and leave `generator`
    untouched; otherwise temperature, top-k and top-p shape the
    distribution and `generator` (on logits' device) draws from it."""
    logits = apply_repeat_penalty(logits.float(), recent_tokens,
                                  config.repeat_penalty)
    if config.greedy:
        return logits.argmax(dim=-1)
    logits = logits / config.temperature
    if config.top_k is not None:
        logits = _mask_top_k(logits, config.top_k)
    if config.top_p is not None:
        logits = _mask_top_p(logits, config.top_p)
    return _exponential_race(torch.softmax(logits, dim=-1), generator)


def update_ring(recent_tokens, new_tokens, step: int):
    """Push new tokens into the [B, N] ring at slot step % N. Returns a
    new ring; the input is not modified."""
    out = recent_tokens.clone()
    out[:, step % out.shape[1]] = new_tokens.to(out.dtype)
    return out


def update_ring_per_row(recent_tokens, new_tokens, steps):
    """Per-row ring push: row b writes at slot steps[b] % N. Returns a
    new ring; the input is not modified."""
    B, N = recent_tokens.shape
    out = recent_tokens.clone()
    rows = torch.arange(B, device=recent_tokens.device)
    out[rows, steps.long() % N] = new_tokens.to(out.dtype)
    return out


def sample_tokens_ragged(seeds, counters, logits, recent_tokens,
                         temperature, top_p, repeat_penalty,
                         top_k: Optional[int] = None, n_top: int = 0):
    """Batched sampling with PER-ROW options (continuous batching: each
    slot carries its own request's temperature/top_p/repeat_penalty).
    Fixed shapes and no host sync: every row is computed, and a greedy
    row takes the argmax.

    seeds, counters: [B] int64 each row's random stream and its position
                     in it (`exponentials`); read, not advanced
    logits:          [B, V]
    recent_tokens:   [B, N] ring buffers (-1 = empty)
    temperature:     [B] f32; <= 0 means greedy for that row
    top_p:           [B] f32; >= 1 disables nucleus filtering for that row
    repeat_penalty:  [B] f32; 1.0 disables
    top_k:           engine-wide k
    n_top:           also return the n most probable alternatives per row
    Returns ([B] int64 ids, [B] f32 logprobs, [B, n_top] top ids,
    [B, n_top] f32 top logprobs). The logprob is the chosen token's under
    the post-penalty distribution (temperature/top-p are sampling
    transforms and do not change it).
    """
    logits = logits.float()
    logits = _apply_repeat_penalty_per_row(logits, recent_tokens,
                                           repeat_penalty)
    greedy = temperature <= 0.0
    argmax_ids = logits.argmax(dim=-1)
    safe_t = torch.where(greedy, torch.ones_like(temperature), temperature)
    scaled = logits / safe_t[:, None]
    if top_k is not None:
        scaled = _mask_top_k(scaled, top_k)
    probs = torch.softmax(_mask_top_p(scaled, top_p), dim=-1)
    e = exponentials(seeds, counters, logits.shape[1])
    ids = torch.where(greedy, argmax_ids, torch.argmax(probs / e, dim=-1))
    lp = torch.log_softmax(logits, dim=-1)
    chosen_lp = lp.gather(1, ids[:, None])[:, 0]
    B = logits.shape[0]
    if n_top > 0:
        top_lps, top_ids = torch.topk(lp, n_top, dim=-1)
    else:
        top_ids = torch.zeros((B, 0), dtype=torch.int64,
                              device=logits.device)
        top_lps = torch.zeros((B, 0), dtype=torch.float32,
                              device=logits.device)
    return ids, chosen_lp, top_ids, top_lps


def masked_sample(live, seeds, counters, logits, ring, steps, temperature,
                  top_p, repeat_penalty, *, top_k: Optional[int] = None,
                  n_top: int = 0):
    """ONE per-row sample with a masked state advance, the engine's
    sampling semantics (the JAX engine's `_masked_sample`): rows outside
    `live` keep their counter and ring. The eager steps and the captured
    decode step both go through it. Returns (next ids [B], counters,
    ring, logprobs [B], top ids [B, n_top], top logprobs [B, n_top]);
    the inputs are not modified."""
    nxt, lp, top_ids, top_lps = sample_tokens_ragged(
        seeds, counters, logits, ring, temperature, top_p, repeat_penalty,
        top_k=top_k, n_top=n_top)
    counters = torch.where(live, counters + 1, counters)
    ring = torch.where(live[:, None], update_ring_per_row(ring, nxt, steps),
                       ring)
    return nxt, counters, ring, lp, top_ids, top_lps
