"""CLIP text transformer.

Counterpart of `cake_tpu/models/sd/clip.py` (`quick_gelu`,
`init_clip_params`, `clip_encode`): transformers' CLIPTextModel
architecture, so HF checkpoints load directly: token and learned
position embeddings, pre-LN causal transformer layers (quick_gelu or
gelu MLP), a final LayerNorm, the pooled output at each sequence's EOT
position (the highest id's), and an optional text projection (SDXL's
second encoder).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cake_tpu_torch.models.sd.config import ClipConfig
from cake_tpu_torch.models.sd.layers import layer_norm, linear, mha
from cake_tpu_torch.ops.attention import causal_mask


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


_ACTS = {"quick_gelu": quick_gelu, "gelu": _gelu}


def _normal(gen, shape, dtype, device, scale=0.02):
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(dtype)


def init_clip_params(cfg: ClipConfig, generator: torch.Generator,
                     dtype=torch.float32, device="cpu"):
    """Random CLIP parameters (normal 0.02 weights, unit norms, zero
    biases) in JAX's tree, drawn from `generator` on `device`."""
    D, F_, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers

    def w(shape):
        return _normal(generator, shape, dtype, device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    def layer():
        return {
            "ln1": {"w": ones(D), "b": zeros(D)},
            "q": {"w": w((D, D)), "b": zeros(D)},
            "k": {"w": w((D, D)), "b": zeros(D)},
            "v": {"w": w((D, D)), "b": zeros(D)},
            "o": {"w": w((D, D)), "b": zeros(D)},
            "ln2": {"w": ones(D), "b": zeros(D)},
            "fc1": {"w": w((D, F_)), "b": zeros(F_)},
            "fc2": {"w": w((F_, D)), "b": zeros(D)},
        }

    params = {
        "token_embed": w((cfg.vocab_size, D)),
        "pos_embed": w((cfg.max_position_embeddings, D)),
        "layers": [layer() for _ in range(L)],
        "final_ln": {"w": ones(D), "b": zeros(D)},
    }
    if cfg.projection_dim:
        params["text_projection"] = w((D, cfg.projection_dim))
    return params


def clip_encode(params, cfg: ClipConfig, input_ids: torch.Tensor,
                output_hidden_state: int = -1):
    """input_ids [B, S] -> (hidden [B, S, D], pooled [B, D or proj]).

    output_hidden_state: -1 = after final_ln (v1.5); -2 = the
    penultimate layer's output (SD v2.x / XL clip skip, no final_ln)."""
    B, S = input_ids.shape
    x = params["token_embed"][input_ids]
    x = x + params["pos_embed"][None, :S]
    mask = causal_mask(S, device=x.device)
    heads = cfg.num_attention_heads
    act = _ACTS[cfg.hidden_act]

    hidden_states = []
    for lp in params["layers"]:
        h = layer_norm(x, lp["ln1"]["w"], lp["ln1"]["b"])
        q = linear(h, lp["q"]["w"], lp["q"]["b"])
        k = linear(h, lp["k"]["w"], lp["k"]["b"])
        v = linear(h, lp["v"]["w"], lp["v"]["b"])
        attn = mha(q, k, v, heads, mask=mask)
        x = x + linear(attn, lp["o"]["w"], lp["o"]["b"])
        h = layer_norm(x, lp["ln2"]["w"], lp["ln2"]["b"])
        x = x + linear(act(linear(h, lp["fc1"]["w"], lp["fc1"]["b"])),
                       lp["fc2"]["w"], lp["fc2"]["b"])
        hidden_states.append(x)

    final = layer_norm(x, params["final_ln"]["w"], params["final_ln"]["b"])
    out = final if output_hidden_state == -1 \
        else hidden_states[output_hidden_state]
    # pooled: the features at the EOT token (the highest id's position,
    # HF's argmax(input_ids)); argmax takes the first of equal maxima
    eot = torch.argmax(input_ids, dim=-1)
    pooled = final[torch.arange(B, device=final.device), eot]
    if "text_projection" in params:
        pooled = pooled @ params["text_projection"]
    return out, pooled
