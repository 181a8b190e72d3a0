"""Sparse mixture-of-experts FFN (Mixtral-style) for decoder blocks.

Counterpart of `cake_tpu/ops/moe.py`, in its dense formulation:

  * Routing is the top k of the f32 router logits with a softmax over
    the k (Mixtral's renormalisation), as a dense [tokens, E] combine
    matrix. Equal logits pick the lower expert index first, as
    `lax.top_k` does: a stable descending sort, where `torch.topk`
    promises no order among ties.
  * Every expert runs on every token through `qeinsum`, and the combine
    matrix, cast to the experts' output dtype as JAX casts it, zeroes
    the ones not selected. The shapes are static, so the step captures
    into the engines' CUDA graphs unchanged; computing only the
    selected experts is a later change.

The JAX package reaches no Pallas kernel here: these are XLA einsums
there and PyTorch einsums (cuBLAS on the card) here.

Expert parallelism (`ep_axis`): JAX names the mesh axis its shard_map
body runs over and psums the shards' outputs; the port has one
controller, so with `ep_axis` the expert leaves are the list of that
axis's shards (each a contiguous slice of the experts on its device),
and `moe_mlp` runs each shard's experts against its slice of the
combine matrix and sums the slices in shard order. The pipeline puts
the experts' ffn dim over tp (a tp rank's partial, which
`block_skeleton` reduces as for the dense FFN) and, as JAX's
`make_pipeline_forward`, has no expert-axis option.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cake_tpu_torch.ops.quant import QTensor, qeinsum


def route_top_k(x: torch.Tensor, router_w, k: int) -> torch.Tensor:
    """Top-k routing combine matrix.

    x:        [N, D] tokens
    router_w: [D, E] router weights
    returns   [N, E] float32: the softmax weight of each selected
              expert, zero elsewhere; the softmax is over the top-k
              logits only. On equal logits the lower index wins."""
    logits = x.float() @ router_w.float()                        # [N, E]
    top_vals, top_idx = torch.sort(logits, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[:, :k], top_idx[:, :k]           # [N, k]
    weights = torch.softmax(top_vals, dim=-1)
    combine = torch.zeros_like(logits)
    return combine.scatter_(1, top_idx, weights)


def _experts(x, combine, we_gate, we_up, we_down) -> torch.Tensor:
    """Every expert of the leaves on every token, mixed by combine."""
    gate = qeinsum("nd,edf->nef", x, we_gate)
    up = qeinsum("nd,edf->nef", x, we_up)
    act = F.silu(gate) * up
    per_expert = qeinsum("nef,efd->ned", act, we_down)           # [N, E, D]
    return torch.einsum("ned,ne->nd", per_expert,
                        combine.to(per_expert.dtype))


def moe_mlp(lp: dict, h: torch.Tensor, num_experts_per_tok: int,
            ep_axis=None) -> torch.Tensor:
    """Sparse SwiGLU FFN over experts.

    lp leaves: router [D, E]; we_gate / we_up [E, D, F]; we_down
    [E, F, D] (tensors, or int8 QTensors for the expert leaves); with
    ep_axis each expert leaf is a list of shards [E_r, ...] in expert
    order. h: [B, S, D] -> [B, S, D] in h's dtype (on h's device)."""
    B, S, D = h.shape
    x = h.reshape(B * S, D)
    combine = route_top_k(x, lp["router"], num_experts_per_tok)   # [N, E]
    if ep_axis is None:
        out = _experts(x, combine, lp["we_gate"], lp["we_up"],
                       lp["we_down"])
        return out.reshape(B, S, D).to(h.dtype)
    out, off = None, 0
    for g, u, d in zip(lp["we_gate"], lp["we_up"], lp["we_down"]):
        e = g.shape[0]
        dev = (g.q if isinstance(g, QTensor) else g).device
        part = _experts(x.to(dev), combine[:, off:off + e].to(dev), g, u, d)
        out = part if out is None else out + part.to(out.device)
        off += e
    return out.reshape(B, S, D).to(h.dtype)
