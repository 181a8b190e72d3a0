"""One batched propose-verify-accept round over paged KV.

Counterpart of `cake_tpu/spec/round.py` (`spec_round_paged`, one jitted
program per gamma there): the draft loop is gamma + 1 ragged paged
decode steps over the draft pool (`paged.forward_ragged_paged`, each
writing the draft token's KV through the draft table row), the verify is
ONE mixed-window pass over the target pool with logits at every position
(`paged.verify_window_paged`), and acceptance is the arithmetic of
spec/accept.py. Here it runs eagerly: the CPU engine calls it, and on
the card serve/graphs.SpecRunner captures it as one CUDA graph per
gamma.

Cache contract (JAX's): last_tok sits at absolute `pos` with its KV not
yet written in EITHER pool; the round writes positions pos..pos+gamma
in both; positions past the accepted frontier hold masked garbage that
the next round overwrites before attending (nothing rolls back). The
caller maps both table rows to cover pos+gamma before the round: a
write past the mapped pages lands on the sink page, which would lose an
accepted position's KV. Both pools share one PageAllocator id space, so
the round needs no allocator: alloc/extend/truncate stay on the host.

Sampled rows draw from the engine's counter-based streams at fixed
offsets (spec/accept.py: draft step k at counter c + k, the uniforms at
c + gamma + 1, the correction at c + gamma + 2), where JAX splits a
threefry key; greedy rows take the same tokens as JAX's.
"""

from __future__ import annotations

import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.paged import (
    PagedKVCache, forward_ragged_paged, verify_window_paged,
)
from cake_tpu_torch.spec.accept import (
    advance_counters, assemble_sampled, categorical, greedy_accept,
    rejection_accept, uniforms,
)

__all__ = ["spec_round_paged"]


@torch.inference_mode()
def spec_round_paged(t_params, d_params, t_cache: PagedKVCache,
                     d_cache: PagedKVCache, last_tok, pos, active, seeds,
                     counters, temp, t_rope, d_rope, t_cfg: LlamaConfig,
                     d_cfg: LlamaConfig, gamma: int, attn: str = "auto"):
    """One round for every spec row in `active` ([B] bool): last_tok
    [B, 1] at per-row absolute `pos` [B] int32 (KV unwritten in both
    pools); seeds/counters [B] int64 the rows' random streams (counters
    advanced by gamma + 3 for active sampled rows only); temp [B] (<= 0
    a greedy row: argmax drafts and exact-match acceptance; > 0
    leftover-residual rejection sampling). Both pools are written in
    place. Returns (out [B, gamma + 1] int64, the first n_emit[b] valid
    and the rest -1; n_emit [B] int64, 0 for inactive rows; counters)."""
    greedy = temp <= 0.0
    temp_eff = torch.where(greedy, torch.ones_like(temp), temp)[:, None]
    sampled = active & ~greedy
    step = active.to(pos.dtype)

    # gamma + 1 draft steps: step gamma writes the last draft's KV (an
    # all-accept round needs no patch-up pass); its proposal is unused
    tok, p = last_tok, pos
    drafts, d_probs = [], []
    for k in range(gamma + 1):
        logits, _ = forward_ragged_paged(d_params, tok, d_cache, p, active,
                                         d_rope, d_cfg, attn=attn)
        if k == gamma:
            break
        probs = torch.softmax(logits / temp_eff, dim=-1)
        nxt = torch.where(greedy, logits.argmax(dim=-1),
                          categorical(seeds, counters + k, probs))
        drafts.append(nxt)
        d_probs.append(probs)
        tok, p = nxt[:, None], p + step
    drafts = torch.stack(drafts, dim=1)                  # [B, gamma]
    d_probs = torch.stack(d_probs, dim=1)                # [B, gamma, V]

    # verify: ONE mixed-window pass scores [last_tok, d_0..d_{g-1}] per
    # row and writes the target's KV for positions pos..pos+gamma
    tokens_v = torch.cat([last_tok.to(drafts.dtype), drafts], dim=1)
    q_len = torch.where(active, gamma + 1, 0).to(torch.int32)
    t_logits, _ = verify_window_paged(t_params, tokens_v, pos, q_len,
                                      active, t_cache, t_rope, t_cfg,
                                      attn=attn)           # [B, g+1, V]

    # greedy rows: exact-match acceptance against the target argmax
    targets = t_logits.argmax(dim=-1)
    n_acc_g = greedy_accept(drafts, targets)

    # sampled rows: leftover-residual rejection sampling; greedy rows'
    # residual and correction are computed and unused
    t_probs = torch.softmax(t_logits / temp_eff[..., None], dim=-1)
    u = uniforms(seeds, counters + gamma + 1, gamma)
    n_acc_s, resid = rejection_accept(drafts, d_probs, t_probs, u, gamma)
    correction = categorical(seeds, counters + gamma + 2, resid)
    out_s = assemble_sampled(drafts, correction, n_acc_s, gamma)

    n_acc = torch.where(greedy, n_acc_g, n_acc_s)
    out = torch.where(greedy[:, None], targets, out_s)
    n_emit = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
    cols = torch.arange(gamma + 1, device=out.device)
    out = torch.where(cols[None] < n_emit[:, None], out,
                      torch.full_like(out, -1))
    return out, n_emit, advance_counters(counters, sampled, gamma)
