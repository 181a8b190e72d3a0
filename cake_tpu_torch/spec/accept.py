"""The speculative accept/resample arithmetic, shared by every round.

Counterpart of `cake_tpu/spec/accept.py`: `greedy_accept`,
`rejection_accept` and `assemble_sampled` are the same branch-free
tensor arithmetic (Leviathan et al., 2023: accept a draft with
probability min(1, p_t / p_d), resample the first rejected position
from the leftover residual norm(max(0, p_t - p_d)), and take the bonus
token from the target's own distribution when every draft is accepted).

JAX's `advance_row_keys` (a threefry split per row and draw) becomes
the engine's counter-based streams (`ops/sampling.random_bits`): a
sampled row's draws in one round are fixed in number, gamma + 1 draft
draws, one block of gamma uniforms and one correction draw, at counters
c, c + 1, ..., c + gamma + 2, so a round advances the row's counter by
`round_draws(gamma)` = gamma + 3 whatever it accepts (JAX splits as many
times) and no draw has a data-dependent shape. Greedy and inactive rows
never advance.
"""

from __future__ import annotations

import torch

from cake_tpu_torch.ops.sampling import exponentials, random_bits

__all__ = [
    "greedy_accept", "rejection_accept", "assemble_sampled",
    "round_draws", "uniforms", "categorical", "advance_counters",
]


def round_draws(gamma: int) -> int:
    """Counter steps one speculative round takes from a sampled row's
    stream: gamma + 1 draft draws, the uniforms, the correction."""
    return gamma + 3


def uniforms(seeds, counters, n: int):
    """[B, n] f32 uniforms in (0, 1) from the rows' streams at their
    counters (24 bits of each hash)."""
    return ((random_bits(seeds, counters, n) >> 8).float() + 0.5) * 2.0 ** -24


def categorical(seeds, counters, probs):
    """One index per row drawn with probability probs[row] (unnormalized
    is fine; zeros are never drawn): the exponential race over the
    rows' streams at their counters."""
    e = exponentials(seeds, counters, probs.shape[-1])
    return torch.argmax(probs / e, dim=-1)


def advance_counters(counters, mask, gamma: int):
    """The rows' counters after one round: `round_draws(gamma)` further
    for the rows in `mask` (active sampled rows), unchanged elsewhere."""
    return torch.where(mask, counters + round_draws(gamma), counters)


def greedy_accept(drafts, targets):
    """Accepted-draft count per row under exact-match (greedy)
    acceptance: the longest prefix where draft == target argmax."""
    match = drafts == targets[:, : drafts.shape[1]]
    return torch.cumprod(match.to(torch.int64), dim=1).sum(dim=1)


def rejection_accept(drafts, d_probs, t_probs, u, gamma: int):
    """Leviathan accept/reject over a [B, gamma] draft burst, plus the
    leftover-residual distribution at the first rejected position r
    (norm(max(0, p_t - p_d)); at r == gamma the target's own
    distribution). Returns (n_acc [B], resid [B, V])."""
    B = drafts.shape[0]
    idx = drafts[..., None].long()                     # [B, gamma, 1]
    p_t = torch.gather(t_probs[:, :gamma], -1, idx)[..., 0]
    p_d = torch.gather(d_probs, -1, idx)[..., 0]
    accept = u < torch.clamp(p_t / torch.clamp(p_d, min=1e-20), max=1.0)
    n_acc = torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)
    r = torch.clamp(n_acc, max=gamma)
    row = torch.arange(B, device=drafts.device)
    p_t_r = t_probs[row, r]                            # [B, V]
    p_d_r = torch.where((r < gamma)[:, None],
                        d_probs[row, torch.clamp(r, max=gamma - 1)],
                        torch.zeros((), dtype=d_probs.dtype,
                                    device=d_probs.device))
    resid = torch.clamp(p_t_r - p_d_r, min=0.0)
    resid = resid / torch.clamp(resid.sum(-1, keepdim=True), min=1e-20)
    return n_acc, resid


def assemble_sampled(drafts, correction, n_acc, gamma: int):
    """Per-row output burst for the sampled path: accepted drafts, then
    the correction/bonus token at position n_acc, the tail padded with
    the last draft (masked off by the caller's n_emit mask)."""
    cols = torch.arange(gamma + 1, device=drafts.device)
    return torch.where(cols[None] == torch.clamp(n_acc, max=gamma)[:, None],
                       correction[:, None].to(drafts.dtype),
                       torch.cat([drafts, drafts[:, -1:]], dim=1))
