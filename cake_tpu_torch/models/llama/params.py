"""Llama parameter dict: init, HF-safetensors loading, JAX carry-across.

Counterpart of `cake_tpu/models/llama/params.py`, with the same layout:
a dict mirroring the JAX pytree, decoder-block weights stacked along a
leading layer axis [L, ...], linear weights stored [in, out] (x @ w),
transposed from HF's [out, in] at load:

  {"embed": [V, D], "final_norm": [D], "lm_head": [D, V],
   "blocks": {"attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
              "w_gate", "w_up", "w_down"[, "bq", "bk", "bv"]}}

With weight quantization (ops/quant.py) the seven block matmul weights
and the lm_head are `QTensor` nodes (q, scale) instead of tensors.

The placement specs (`block_param_keys`, `block_specs`, `param_specs`,
`cache_specs`) say which dim of each leaf goes over the mesh's `stage`,
`tp` and expert axes (a spec is a tuple of axis names or None, JAX's
PartitionSpec); `load_params_sharded` streams each shard's slice from
the safetensors files onto its device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.ops.quant import _BLOCK_CONTRACT, QTensor, pick_group
from cake_tpu_torch.utils.devices import resolve_device


def init_params(config: LlamaConfig, generator: torch.Generator,
                device="cuda", dtype=torch.bfloat16) -> Dict:
    """Random-init parameters (tests, benches, the chip smoke): normal
    weights scaled by 1/sqrt(fan_in), unit norms. Drawn directly on
    `device` in `dtype` — an 8B bf16 tree never exists in f32 or on
    the host. `generator` must live on `device`."""
    dev = resolve_device(device)
    c = config
    L, D, F = c.num_hidden_layers, c.hidden_size, c.intermediate_size
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
                "w_gate": w((L, D, F), D),
                "w_up": w((L, D, F), D),
                "w_down": w((L, F, D), F),
            },
            "final_norm": ones((D,)),
            "lm_head": w((D, c.vocab_size), D),
        }
        if config.attention_bias:
            params["blocks"]["bq"] = w((L, H * hd), D)
            params["blocks"]["bk"] = w((L, KV * hd), D)
            params["blocks"]["bv"] = w((L, KV * hd), D)
        if config.tie_word_embeddings:
            params["lm_head"] = params["embed"].T
    return params


def random_qtensor(shape, contract_dims, fan_in, generator, device,
                   bits: int = 8) -> QTensor:
    """A random quantized leaf of `shape` on `device`: uniform int8 codes
    (bits=8, per-channel scales dropping `contract_dims`) or random
    packed bytes (bits=4: each nibble a uniform int4, group-wise scales
    over contract_dims[0]), and the constant scale 1/(qmax sqrt(fan_in)),
    which gives about init_params' spread."""
    qmax = 127 if bits == 8 else 7
    if bits == 4:
        cd = contract_dims[0]
        g = pick_group(shape[cd])
        q = torch.randint(
            0, 256, shape[:cd] + (shape[cd] // 2,) + shape[cd + 1:],
            generator=generator, device=device, dtype=torch.uint8)
        scale_shape = shape[:cd] + (shape[cd] // g,) + shape[cd + 1:]
    else:
        q = torch.randint(-qmax, qmax + 1, shape, generator=generator,
                          device=device, dtype=torch.int8)
        scale_shape = tuple(s for i, s in enumerate(shape)
                            if i not in contract_dims)
    scale = torch.full(scale_shape, 1.0 / (qmax * math.sqrt(fan_in)),
                       dtype=torch.float32, device=device)
    return QTensor(q=q, scale=scale)


def init_params_quantized(config: LlamaConfig, generator: torch.Generator,
                          device="cuda", dtype=torch.bfloat16,
                          bits: int = 8) -> Dict:
    """Random quantized params drawn directly on `device` (int8
    per-channel or int4 group-wise), in the structure of
    `quantize_params(init_params(...), bits=bits)` without the
    full-precision tree ever existing. Benchmarks and smoke runs do not
    depend on weight values, so random codes and constant scales serve:
    at bits=4 random bytes ARE the packed group-halves stream (each
    nibble a uniform int4), and the scale 1/(qmax*sqrt(fan_in)) gives the
    dequantized weights about init_params' spread. The lm_head is int8
    at both settings, as quantize_params leaves it."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    dev = resolve_device(device)
    c = config
    L, D, F = c.num_hidden_layers, c.hidden_size, c.intermediate_size
    H, KV, hd = c.num_attention_heads, c.num_key_value_heads, c.head_dim

    def qleaf(shape, contract_dims, fan_in, leaf_bits=bits):
        return random_qtensor(shape, contract_dims, fan_in, generator, dev,
                              leaf_bits)

    def w(shape, fan_in):
        t = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return t.mul_(1.0 / math.sqrt(fan_in))

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    with torch.no_grad():
        blocks = {
            "attn_norm": ones((L, D)),
            "wq": qleaf((L, D, H * hd), _BLOCK_CONTRACT["wq"], D),
            "wk": qleaf((L, D, KV * hd), _BLOCK_CONTRACT["wk"], D),
            "wv": qleaf((L, D, KV * hd), _BLOCK_CONTRACT["wv"], D),
            "wo": qleaf((L, H * hd, D), _BLOCK_CONTRACT["wo"], H * hd),
            "mlp_norm": ones((L, D)),
            "w_gate": qleaf((L, D, F), _BLOCK_CONTRACT["w_gate"], D),
            "w_up": qleaf((L, D, F), _BLOCK_CONTRACT["w_up"], D),
            "w_down": qleaf((L, F, D), _BLOCK_CONTRACT["w_down"], F),
        }
        if c.attention_bias:
            # full precision, as quantize_params leaves them
            blocks["bq"] = w((L, H * hd), D)
            blocks["bk"] = w((L, KV * hd), D)
            blocks["bv"] = w((L, KV * hd), D)
        return {
            "embed": w((c.vocab_size, D), D),
            "blocks": blocks,
            "final_norm": ones((D,)),
            "lm_head": qleaf((D, c.vocab_size), (0,), D, leaf_bits=8),
        }


def params_bytes(params) -> int:
    """Bytes of every tensor in a parameter dict (lists and QTensor nodes
    included)."""
    if isinstance(params, dict):
        return sum(params_bytes(v) for v in params.values())
    if isinstance(params, QTensor):
        return params_bytes(params.q) + params_bytes(params.scale)
    if isinstance(params, list):              # the SD trees' layer lists
        return sum(params_bytes(v) for v in params)
    return params.numel() * params.element_size()


def params_from_numpy(tree, device="cuda", dtype=torch.float32):
    """The port's params from a JAX param pytree converted to numpy
    (`jax.tree.map(np.asarray, params)`): the same nested dicts and
    lists, each leaf a tensor of `dtype` on `device`. Leaves in bfloat16 (an
    ml_dtypes numpy dtype torch cannot read) cross via their bits. A
    quantized node (any NamedTuple with fields q and scale, as the JAX
    package's QTensor arrives) becomes the port's QTensor: q keeps its
    int8/uint8 bytes and scale stays f32."""
    dev = resolve_device(device)

    def leaf(a, keep_dtype=False):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.array(a).view(np.int16))
            t = t.view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        return t.to(device=dev, dtype=None if keep_dtype else dtype)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):           # the SD trees' layer lists
            return [walk(v) for v in node]
        if getattr(node, "_fields", None) == ("q", "scale"):
            return QTensor(q=leaf(node.q, keep_dtype=True),
                           scale=leaf(node.scale, keep_dtype=True))
        return leaf(node)

    return walk(tree)


# -- HF name mapping ---------------------------------------------------------

def hf_param_layout(config: LlamaConfig):
    """Map our leaves -> (HF tensor name, transpose?): the top-level
    leaves, the per-layer suffixes, and the layer count."""
    L = config.num_hidden_layers
    layout = {
        ("embed",): ("model.embed_tokens.weight", False),
        ("final_norm",): ("model.norm.weight", False),
        ("lm_head",): ("lm_head.weight", True),
    }
    per_layer = {
        "attn_norm": ("input_layernorm.weight", False),
        "wq": ("self_attn.q_proj.weight", True),
        "wk": ("self_attn.k_proj.weight", True),
        "wv": ("self_attn.v_proj.weight", True),
        "wo": ("self_attn.o_proj.weight", True),
        "mlp_norm": ("post_attention_layernorm.weight", False),
        "w_gate": ("mlp.gate_proj.weight", True),
        "w_up": ("mlp.up_proj.weight", True),
        "w_down": ("mlp.down_proj.weight", True),
    }
    if config.attention_bias:
        per_layer.update({
            "bq": ("self_attn.q_proj.bias", False),
            "bk": ("self_attn.k_proj.bias", False),
            "bv": ("self_attn.v_proj.bias", False),
        })
    return layout, per_layer, L


def load_params_from_hf(model_dir: str, config: LlamaConfig,
                        dtype=torch.bfloat16, device="cuda",
                        layer_range: Optional[range] = None) -> Dict:
    """Build the parameter dict from HF safetensors on `device`.

    layer_range: only materialise these blocks (stage-local loading).
    Each tensor crosses to the device in its stored dtype and is cast
    there, one layer at a time, so the host holds one tensor at most.
    """
    from cake_tpu_torch.utils.loading import load_weights

    dev = resolve_device(device)
    layout, per_layer, L = hf_param_layout(config)
    layers = list(layer_range) if layer_range is not None else list(range(L))

    needed = {name for (name, _t) in layout.values()}
    for i in layers:
        for hf_suffix, _t in per_layer.values():
            needed.add(f"model.layers.{i}.{hf_suffix}")
    if config.tie_word_embeddings:
        needed.discard("lm_head.weight")
    host = load_weights(model_dir, filter_fn=lambda n: n in needed)
    missing = needed - set(host)
    if missing:
        raise KeyError(f"{model_dir}: missing tensors {sorted(missing)[:4]}"
                       f"{' ...' if len(missing) > 4 else ''}")

    def leaf(name, transpose):
        t = host[name].to_torch().to(device=dev, dtype=dtype)
        return t.T.contiguous() if transpose else t

    with torch.no_grad():
        params: Dict = {"blocks": {}}
        params["embed"] = leaf("model.embed_tokens.weight", False)
        params["final_norm"] = leaf("model.norm.weight", False)
        if config.tie_word_embeddings:
            params["lm_head"] = params["embed"].T
        else:
            params["lm_head"] = leaf("lm_head.weight", True)
        for key, (hf_suffix, transpose) in per_layer.items():
            params["blocks"][key] = torch.stack([
                leaf(f"model.layers.{i}.{hf_suffix}", transpose)
                for i in layers])
    return params


# -- sharding ---------------------------------------------------------------

def block_param_keys(config=None, *, moe: Optional[bool] = None) -> tuple:
    """Stacked-block leaf names for a config's family (dense vs MoE)."""
    if moe is None:
        moe = bool(config is not None and config.is_moe)
    keys = ["attn_norm", "wq", "wk", "wv", "wo", "mlp_norm"]
    if config is not None and getattr(config, "attention_bias", False):
        keys += ["bq", "bk", "bv"]
    keys += (["router", "we_gate", "we_up", "we_down"] if moe
             else ["w_gate", "w_up", "w_down"])
    return tuple(keys)


def block_specs(keys, stage_axis: Optional[str] = None,
                tp_axis: Optional[str] = None,
                ep_axis: Optional[str] = None) -> dict:
    """Specs of a set of stacked-block leaves, dense or MoE: the layer
    dim over stage; q/k/v, gate/up (output dim) and o, down (input dim)
    over tp (Megatron); the MoE experts over ep, their ffn dim over tp,
    the router replicated. An unknown leaf raises JAX's KeyError."""
    S, T, E = stage_axis, tp_axis, ep_axis
    table = {
        "attn_norm": (S, None),
        "wq": (S, None, T),
        "wk": (S, None, T),
        "wv": (S, None, T),
        # QKV bias (Qwen2): sharded like its weight's output dim
        "bq": (S, T),
        "bk": (S, T),
        "bv": (S, T),
        "wo": (S, T, None),
        "mlp_norm": (S, None),
        "w_gate": (S, None, T),
        "w_up": (S, None, T),
        "w_down": (S, T, None),
        "router": (S, None, None),
        "we_gate": (S, E, None, T),
        "we_up": (S, E, None, T),
        "we_down": (S, E, T, None),
    }
    unknown = set(keys) - set(table)
    if unknown:
        raise KeyError(f"no PartitionSpec rule for block leaves {unknown}")
    return {k: table[k] for k in keys}


def param_specs(tp_axis: Optional[str] = "tp",
                stage_axis: Optional[str] = None,
                config: Optional[LlamaConfig] = None) -> dict:
    """Megatron tensor-parallel specs of a dense tree: column-parallel
    q/k/v and gate/up, row-parallel o and down, the embedding and the
    lm_head over the vocabulary, norms replicated; stage_axis shards the
    layer dim too. config: family leaves such as Qwen2's biases."""
    return {
        "embed": (tp_axis, None),
        "blocks": block_specs(block_param_keys(config, moe=False),
                              stage_axis=stage_axis, tp_axis=tp_axis),
        "final_norm": (None,),
        "lm_head": (None, tp_axis),
    }


def cache_specs(tp_axis: Optional[str] = "tp",
                dp_axis: Optional[str] = "dp",
                stage_axis: Optional[str] = None):
    """KVCache specs, [L, B, S, KV, hd]: layers over stage, batch over
    dp, kv heads over tp."""
    from cake_tpu_torch.models.llama.cache import KVCache
    spec = (stage_axis, dp_axis, None, tp_axis, None)
    return KVCache(k=spec, v=spec)


def load_params_sharded(model_dir: str, config: LlamaConfig, mesh, specs,
                        dtype=torch.bfloat16) -> Dict:
    """Stream HF safetensors onto their shards: every leaf of `specs`
    (the pipeline's placement, parallel/pipeline.pipeline_param_specs)
    is read one shard slice at a time from the mmap'd file, cast and
    copied onto that shard's device; no full tensor of the model ever
    exists on a device or the host. The same tree `load_params_from_hf`
    + `place_for_pipeline` give."""
    from cake_tpu_torch.parallel.sharding import stream_leaf
    from cake_tpu_torch.utils.loading import load_weights

    layout, per_layer, L = hf_param_layout(config)
    needed = {name for (name, _t) in layout.values()}
    for i in range(L):
        for hf_suffix, _t in per_layer.values():
            needed.add(f"model.layers.{i}.{hf_suffix}")
    if config.tie_word_embeddings:
        needed.discard("lm_head.weight")
    # host tensors stay zero-copy mmap views; prefetch=False keeps the
    # native reader from madvise(WILLNEED)ing the whole checkpoint (only
    # shard slices are ever touched)
    host = load_weights(model_dir, filter_fn=lambda n: n in needed,
                        prefetch=False)
    missing = needed - set(host)
    if missing:
        raise KeyError(f"{model_dir}: missing tensors {sorted(missing)[:4]}"
                       f"{' ...' if len(missing) > 4 else ''}")
    params: Dict = {"blocks": {}}
    for (key,), (name, tr) in layout.items():
        if key == "lm_head" and config.tie_word_embeddings:
            name, tr = "model.embed_tokens.weight", True
        params[key] = stream_leaf(lambda name=name: host[name], tr,
                                  specs[key], mesh, dtype)
    for key, (hf_suffix, tr) in per_layer.items():
        params["blocks"][key] = stream_leaf(
            lambda i, s=hf_suffix: host[f"model.layers.{i}.{s}"], tr,
            specs["blocks"][key], mesh, dtype, lead=(L,))
    return params
