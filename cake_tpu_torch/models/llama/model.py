"""Llama-3 decoder-block math (counterpart of
`cake_tpu/models/llama/model.py:block_skeleton` and `RopeTables`).

Block semantics:
  x = x + attn(rms_norm(x))        # input_layernorm -> GQA+RoPE -> o_proj
  x = x + mlp(rms_norm(x))         # post_attention_layernorm -> SwiGLU
Plain weight GEMMs stay torch.matmul (cuBLAS on the card), as the JAX
package left them to XLA outside its Pallas kernels. The dense cache,
forward and generator are a later slice; the paged steps
(models/llama/paged.py) build on this block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.ops.norms import rms_norm
from cake_tpu_torch.ops.rope import precompute_rope


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
    """Layer i's leaves of the stacked block dict (views, no copy)."""
    return {k: v[i] for k, v in blocks.items()}


def block_skeleton(lp, x, config: LlamaConfig, attn_fn):
    """Decoder-block math with a pluggable attention:
    rms -> qkv proj -> attn_fn(q, k, v) -> o_proj -> residual -> rms ->
    SwiGLU -> residual. attn_fn returns (attn [B,S,H,hd], extras).
    lp: one layer's params (leaves without the L axis); x: [B, S, D].
    """
    if "router" in lp:
        raise NotImplementedError(
            "mixture-of-experts blocks (a `router` leaf) are not ported "
            "to cake_tpu_torch yet (ROADMAP A14)")
    B, S, _ = x.shape
    hd = config.head_dim
    H = lp["wq"].shape[-1] // hd
    KV = lp["wk"].shape[-1] // hd

    h = rms_norm(x, lp["attn_norm"], config.rms_norm_eps)
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if "bq" in lp:  # Qwen2-family QKV bias (config.attention_bias)
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    attn, extras = attn_fn(q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd),
                           v.reshape(B, S, KV, hd))
    x = x + attn.reshape(B, S, H * hd) @ lp["wo"]

    h = rms_norm(x, lp["mlp_norm"], config.rms_norm_eps)
    gate = F.silu(h @ lp["w_gate"])
    x = x + (gate * (h @ lp["w_up"])) @ lp["w_down"]
    return x, extras
