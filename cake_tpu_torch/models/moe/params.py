"""MoE parameter dict: random init, HF (Mixtral) safetensors loading.

Counterpart of `cake_tpu/models/moe/params.py` (`init_params`,
`load_params_from_hf`, `MOE_ATTN_LAYOUT`, `MOE_EXPERT_LAYOUT`), with
the Llama family's stacked [L, ...] layout (models/llama/params.py);
expert leaves add an E axis: router [L, D, E], we_gate / we_up
[L, E, D, F], we_down [L, E, F, D]. On disk it is HF Mixtral
safetensors (model.layers.N.block_sparse_moe.gate.weight,
.experts.K.{w1,w2,w3}.weight, w1 = gate, w2 = down, w3 = up), so public
checkpoints load unchanged. `init_params_quantized` draws the int8 tree
on the card directly, as the Llama family's does. `param_specs` places
the experts over an expert axis and their ffn dim over tp;
`load_params_sharded` streams each shard's slice from the files.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from cake_tpu_torch.models.llama.params import random_qtensor
from cake_tpu_torch.models.moe.config import MoEConfig
from cake_tpu_torch.ops.quant import _BLOCK_CONTRACT
from cake_tpu_torch.utils.devices import resolve_device


def init_params(config: MoEConfig, generator: torch.Generator,
                device="cuda", dtype=torch.bfloat16) -> Dict:
    """Random-init MoE parameters: normal weights scaled by
    1/sqrt(fan_in), unit norms, drawn directly on `device` in `dtype`
    (`generator` lives on `device`)."""
    dev = resolve_device(device)
    c = config
    L, D, F = c.num_hidden_layers, c.hidden_size, c.intermediate_size
    E = c.num_local_experts
    H, KV, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim

    def w(shape, fan_in):
        t = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return t.mul_(1.0 / math.sqrt(fan_in))

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    with torch.no_grad():
        params = {
            "embed": w((c.vocab_size, D), D),
            "blocks": {
                "attn_norm": ones((L, D)),
                "wq": w((L, D, H * hd), D),
                "wk": w((L, D, KV * hd), D),
                "wv": w((L, D, KV * hd), D),
                "wo": w((L, H * hd, D), H * hd),
                "mlp_norm": ones((L, D)),
                "router": w((L, D, E), D),
                "we_gate": w((L, E, D, F), D),
                "we_up": w((L, E, D, F), D),
                "we_down": w((L, E, F, D), F),
            },
            "final_norm": ones((D,)),
            "lm_head": w((D, c.vocab_size), D),
        }
        if c.tie_word_embeddings:
            params["lm_head"] = params["embed"].T
    return params


def init_params_quantized(config: MoEConfig, generator: torch.Generator,
                          device="cuda", dtype=torch.bfloat16) -> Dict:
    """Random int8 params drawn directly on `device`, in the structure of
    `quantize_params(init_params(...), bits=8)` without the
    full-precision tree ever existing: per-channel int8 codes with the
    constant scale 1/(127 sqrt(fan_in)) for the attention and expert
    leaves (each expert leaf contracts its dim 2, `_BLOCK_CONTRACT`) and
    the lm_head; the router, norms and embedding stay in `dtype`, as
    quantize_params leaves them."""
    dev = resolve_device(device)
    c = config
    L, D, F = c.num_hidden_layers, c.hidden_size, c.intermediate_size
    E = c.num_local_experts
    H, KV, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim

    def qleaf(shape, contract_dims, fan_in):
        return random_qtensor(shape, contract_dims, fan_in, generator, dev)

    def w(shape, fan_in):
        t = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return t.mul_(1.0 / math.sqrt(fan_in))

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    B = _BLOCK_CONTRACT
    with torch.no_grad():
        blocks = {
            "attn_norm": ones((L, D)),
            "wq": qleaf((L, D, H * hd), B["wq"], D),
            "wk": qleaf((L, D, KV * hd), B["wk"], D),
            "wv": qleaf((L, D, KV * hd), B["wv"], D),
            "wo": qleaf((L, H * hd, D), B["wo"], H * hd),
            "mlp_norm": ones((L, D)),
            "router": w((L, D, E), D),
            "we_gate": qleaf((L, E, D, F), B["we_gate"], D),
            "we_up": qleaf((L, E, D, F), B["we_up"], D),
            "we_down": qleaf((L, E, F, D), B["we_down"], F),
        }
        return {
            "embed": w((c.vocab_size, D), D),
            "blocks": blocks,
            "final_norm": ones((D,)),
            "lm_head": qleaf((D, c.vocab_size), (0,), D),
        }


MOE_PREFIX = "block_sparse_moe"
# our leaf -> (HF per-layer suffix, transpose)
MOE_ATTN_LAYOUT = {
    "attn_norm": ("input_layernorm.weight", False),
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "router": (f"{MOE_PREFIX}.gate.weight", True),
}
# our expert leaf -> HF expert weight name (w1 = gate, w3 = up, w2 = down)
MOE_EXPERT_LAYOUT = (("we_gate", "w1"), ("we_up", "w3"),
                     ("we_down", "w2"))


def load_params_from_hf(model_dir: str, config: MoEConfig,
                        dtype=torch.bfloat16, device="cuda",
                        layer_range: Optional[range] = None) -> Dict:
    """Build the MoE parameter dict from HF Mixtral safetensors on
    `device`: each tensor crosses in its stored dtype and is cast there,
    a layer's experts stacked at a time."""
    from cake_tpu_torch.utils.loading import load_weights

    dev = resolve_device(device)
    c = config
    L, E = c.num_hidden_layers, c.num_local_experts
    layers = list(layer_range) if layer_range is not None else list(range(L))
    moe = MOE_PREFIX
    needed = {"model.embed_tokens.weight", "model.norm.weight"}
    if not c.tie_word_embeddings:
        needed.add("lm_head.weight")
    for i in layers:
        for suffix, _t in MOE_ATTN_LAYOUT.values():
            needed.add(f"model.layers.{i}.{suffix}")
        for e in range(E):
            for wn in ("w1", "w2", "w3"):
                needed.add(f"model.layers.{i}.{moe}.experts.{e}.{wn}.weight")
    host = load_weights(model_dir, filter_fn=lambda n: n in needed)
    missing = needed - set(host)
    if missing:
        raise KeyError(f"{model_dir}: missing tensors {sorted(missing)[:4]}"
                       f"{' ...' if len(missing) > 4 else ''}")

    def leaf(name, transpose):
        t = host[name].to_torch().to(device=dev, dtype=dtype)
        return t.T.contiguous() if transpose else t

    with torch.no_grad():
        blocks = {
            key: torch.stack([leaf(f"model.layers.{i}.{suffix}", tr)
                              for i in layers])
            for key, (suffix, tr) in MOE_ATTN_LAYOUT.items()
        }
        # HF w1 [F, D] = gate, w3 [F, D] = up (both -> [D, F]); w2
        # [D, F] = down (-> [F, D])
        for key, wn in MOE_EXPERT_LAYOUT:
            blocks[key] = torch.stack([
                torch.stack([
                    leaf(f"model.layers.{i}.{moe}.experts.{e}.{wn}.weight",
                         True) for e in range(E)])
                for i in layers])
        params: Dict = {
            "blocks": blocks,
            "embed": leaf("model.embed_tokens.weight", False),
            "final_norm": leaf("model.norm.weight", False),
        }
        params["lm_head"] = (params["embed"].T if c.tie_word_embeddings
                             else leaf("lm_head.weight", True))
    return params


def param_specs(tp_axis: Optional[str] = "tp", ep_axis: Optional[str] = "ep",
                stage_axis: Optional[str] = None) -> dict:
    """Specs of an MoE tree: experts over ep, their ffn dim over tp
    (Megatron), the router replicated, the embedding and the lm_head over
    the vocabulary."""
    from cake_tpu_torch.models.llama.params import (
        block_param_keys, block_specs,
    )
    return {
        "embed": (tp_axis, None),
        "blocks": block_specs(block_param_keys(moe=True),
                              stage_axis=stage_axis, tp_axis=tp_axis,
                              ep_axis=ep_axis),
        "final_norm": (None,),
        "lm_head": (None, tp_axis),
    }


def load_params_sharded(model_dir: str, config: MoEConfig, mesh, specs,
                        dtype=torch.bfloat16) -> Dict:
    """Stream HF Mixtral safetensors onto their shards, the MoE analog of
    models/llama/params.load_params_sharded: each shard reads only its
    slice of each layer's (and expert's) tensor from the mmap."""
    from cake_tpu_torch.parallel.sharding import stream_leaf
    from cake_tpu_torch.utils.loading import load_weights

    c = config
    L, E = c.num_hidden_layers, c.num_local_experts
    moe = MOE_PREFIX
    # prefetch=False: only shard slices are touched (the dense loader's
    # reason)
    host = load_weights(model_dir, prefetch=False)
    params: Dict = {"blocks": {}}
    top = {"embed": ("model.embed_tokens.weight", False),
           "final_norm": ("model.norm.weight", False),
           "lm_head": (("model.embed_tokens.weight", True)
                       if c.tie_word_embeddings else ("lm_head.weight", True))}
    for key, (name, tr) in top.items():
        params[key] = stream_leaf(lambda name=name: host[name], tr,
                                  specs[key], mesh, dtype)
    for key, (suffix, tr) in MOE_ATTN_LAYOUT.items():
        params["blocks"][key] = stream_leaf(
            lambda i, s=suffix: host[f"model.layers.{i}.{s}"], tr,
            specs["blocks"][key], mesh, dtype, lead=(L,))
    for key, wn in MOE_EXPERT_LAYOUT:
        params["blocks"][key] = stream_leaf(
            lambda i, e, wn=wn: host[
                f"model.layers.{i}.{moe}.experts.{e}.{wn}.weight"], True,
            specs["blocks"][key], mesh, dtype, lead=(L, E))
    return params
