"""SD component weights: HF checkpoints in, diffusers checkpoints out.

Counterpart of `cake_tpu/models/sd/params.py`. CLIP loads from
transformers-format safetensors (text_model.* names); the UNet and the
VAE load from diffusers-format safetensors through a declarative name
table (`_unet_entries` / `_vae_entries`) that mirrors the init
functions' structure. The inverse (`export_sd_component`,
`save_sd_component`) writes the same format, byte for byte as the JAX
package's export of the same tree.

Layout conversions (torch/diffusers -> the NHWC functional layout):
  conv    [out, in, kh, kw]  -> [kh, kw, in, out]
  linear  [out, in]          -> [in, out]
  norm    direct
  proj_in/proj_out: SD1.5 stores 1x1 convs, v2.1/XL store linears
  (use_linear_projection), accepted by rank, exported as linear.
  VAE mid attention: new checkpoints use to_q/.../to_out.0 linears, old
  ones query/key/value/proj_attn 1x1 convs; both are accepted.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from cake_tpu_torch.models.sd.config import (
    ClipConfig, SDConfig, UNetConfig, VAEConfig,
)
from cake_tpu_torch.utils.devices import resolve_device
from cake_tpu_torch.utils.loading import load_weights


def _host_tensor(host: Dict, name: str) -> torch.Tensor:
    return host[name].to_torch()


def load_clip_params(model_dir: str, cfg: ClipConfig, dtype=torch.float32,
                     device="cpu"):
    """transformers CLIPTextModel safetensors -> the CLIP parameter dict
    on `device`."""
    host = load_weights(model_dir)
    dev = resolve_device(device)

    def t(name):  # [out, in] -> [in, out]
        return _host_tensor(host, name).T.contiguous().to(dev, dtype)

    def v(name):
        return _host_tensor(host, name).to(dev, dtype)

    pre = "text_model."
    layers = []
    for i in range(cfg.num_hidden_layers):
        lp = f"{pre}encoder.layers.{i}."
        layers.append({
            "ln1": {"w": v(lp + "layer_norm1.weight"),
                    "b": v(lp + "layer_norm1.bias")},
            "q": {"w": t(lp + "self_attn.q_proj.weight"),
                  "b": v(lp + "self_attn.q_proj.bias")},
            "k": {"w": t(lp + "self_attn.k_proj.weight"),
                  "b": v(lp + "self_attn.k_proj.bias")},
            "v": {"w": t(lp + "self_attn.v_proj.weight"),
                  "b": v(lp + "self_attn.v_proj.bias")},
            "o": {"w": t(lp + "self_attn.out_proj.weight"),
                  "b": v(lp + "self_attn.out_proj.bias")},
            "ln2": {"w": v(lp + "layer_norm2.weight"),
                    "b": v(lp + "layer_norm2.bias")},
            "fc1": {"w": t(lp + "mlp.fc1.weight"),
                    "b": v(lp + "mlp.fc1.bias")},
            "fc2": {"w": t(lp + "mlp.fc2.weight"),
                    "b": v(lp + "mlp.fc2.bias")},
        })
    params = {
        "token_embed": v(pre + "embeddings.token_embedding.weight"),
        "pos_embed": v(pre + "embeddings.position_embedding.weight"),
        "layers": layers,
        "final_ln": {"w": v(pre + "final_layer_norm.weight"),
                     "b": v(pre + "final_layer_norm.bias")},
    }
    if "text_projection.weight" in host:
        params["text_projection"] = t("text_projection.weight")
    return params


# -- diffusers name tables ----------------------------------------------------

Entry = Tuple[Tuple, str, str]  # (pytree path, hf name prefix, kind)


def _resnet_entries(path, pre, has_shortcut, with_time=True) -> Iterator[Entry]:
    yield (*path, "norm1"), f"{pre}.norm1", "norm"
    yield (*path, "conv1"), f"{pre}.conv1", "conv"
    if with_time:
        yield (*path, "time_emb"), f"{pre}.time_emb_proj", "linear"
    yield (*path, "norm2"), f"{pre}.norm2", "norm"
    yield (*path, "conv2"), f"{pre}.conv2", "conv"
    if has_shortcut:
        yield (*path, "shortcut"), f"{pre}.conv_shortcut", "conv"


def _xformer_entries(path, pre, n_layers) -> Iterator[Entry]:
    yield (*path, "norm"), f"{pre}.norm", "norm"
    yield (*path, "proj_in"), f"{pre}.proj_in", "proj"
    for k in range(n_layers):
        b, bp = f"{pre}.transformer_blocks.{k}", (*path, "blocks", k)
        yield (*bp, "ln1"), f"{b}.norm1", "norm"
        for qkv, hf in (("q", "to_q"), ("k", "to_k"), ("v", "to_v")):
            yield (*bp, "attn1", qkv), f"{b}.attn1.{hf}", "linear_nobias"
        yield (*bp, "attn1", "o"), f"{b}.attn1.to_out.0", "linear"
        yield (*bp, "ln2"), f"{b}.norm2", "norm"
        for qkv, hf in (("q", "to_q"), ("k", "to_k"), ("v", "to_v")):
            yield (*bp, "attn2", qkv), f"{b}.attn2.{hf}", "linear_nobias"
        yield (*bp, "attn2", "o"), f"{b}.attn2.to_out.0", "linear"
        yield (*bp, "ln3"), f"{b}.norm3", "norm"
        yield (*bp, "geglu"), f"{b}.ff.net.0.proj", "linear"
        yield (*bp, "ff_out"), f"{b}.ff.net.2", "linear"
    yield (*path, "proj_out"), f"{pre}.proj_out", "proj"


def _unet_entries(cfg: UNetConfig) -> List[Entry]:
    """Every UNet leaf's (pytree path, diffusers name, conversion kind);
    iteration order mirrors init_unet_params so presence of optional leaves
    (shortcut / downsample / attns) matches exactly."""
    ch = cfg.block_out_channels
    n_blocks = len(ch)
    out: List[Entry] = [
        (("conv_in",), "conv_in", "conv"),
        (("time_mlp1",), "time_embedding.linear_1", "linear"),
        (("time_mlp2",), "time_embedding.linear_2", "linear"),
    ]
    if cfg.addition_embed_dim:
        out += [(("add_mlp1",), "add_embedding.linear_1", "linear"),
                (("add_mlp2",), "add_embedding.linear_2", "linear")]

    skip_ch: List[int] = [ch[0]]
    for i in range(n_blocks):
        cin = ch[i - 1] if i > 0 else ch[0]
        cout = ch[i]
        for j in range(cfg.layers_per_block):
            rin = cin if j == 0 else cout
            out += _resnet_entries(("down", i, "resnets", j),
                                   f"down_blocks.{i}.resnets.{j}",
                                   rin != cout)
            if cfg.attn_blocks[i]:
                out += _xformer_entries(
                    ("down", i, "attns", j),
                    f"down_blocks.{i}.attentions.{j}",
                    cfg.transformer_layers_per_block[i])
            skip_ch.append(cout)
        if i < n_blocks - 1:
            out.append((("down", i, "downsample"),
                        f"down_blocks.{i}.downsamplers.0.conv", "conv"))
            skip_ch.append(cout)

    mid_layers = (cfg.transformer_layers_per_block[-1]
                  if cfg.attn_blocks[-1] else 1)
    out += _resnet_entries(("mid", "resnet1"), "mid_block.resnets.0", False)
    out += _xformer_entries(("mid", "attn"), "mid_block.attentions.0",
                            mid_layers)
    out += _resnet_entries(("mid", "resnet2"), "mid_block.resnets.1", False)

    rev = list(reversed(ch))
    prev = ch[-1]
    for i in range(n_blocks):
        cout = rev[i]
        src_block = n_blocks - 1 - i
        for j in range(cfg.layers_per_block + 1):
            skip = skip_ch.pop()
            out += _resnet_entries(("up", i, "resnets", j),
                                   f"up_blocks.{i}.resnets.{j}",
                                   prev + skip != cout)
            prev = cout
            if cfg.attn_blocks[src_block]:
                out += _xformer_entries(
                    ("up", i, "attns", j),
                    f"up_blocks.{i}.attentions.{j}",
                    cfg.transformer_layers_per_block[src_block])
        if i < n_blocks - 1:
            out.append((("up", i, "upsample"),
                        f"up_blocks.{i}.upsamplers.0.conv", "conv"))

    out += [(("norm_out",), "conv_norm_out", "norm"),
            (("conv_out",), "conv_out", "conv")]
    return out


def _vae_attn_entries(path, pre) -> Iterator[Entry]:
    yield (*path, "norm"), f"{pre}.group_norm", "norm"
    yield (*path, "q"), f"{pre}.to_q", "attn1x1"
    yield (*path, "k"), f"{pre}.to_k", "attn1x1"
    yield (*path, "v"), f"{pre}.to_v", "attn1x1"
    yield (*path, "o"), f"{pre}.to_out.0", "attn1x1"


def _vae_entries(cfg: VAEConfig) -> List[Entry]:
    ch = cfg.block_out_channels
    n = len(ch)
    out: List[Entry] = [(("encoder", "conv_in"), "encoder.conv_in", "conv")]
    for i in range(n):
        cin = ch[i - 1] if i > 0 else ch[0]
        for j in range(cfg.layers_per_block):
            rin = cin if j == 0 else ch[i]
            out += _resnet_entries(
                ("encoder", "down", i, "resnets", j),
                f"encoder.down_blocks.{i}.resnets.{j}",
                rin != ch[i], with_time=False)
        if i < n - 1:
            out.append((("encoder", "down", i, "downsample"),
                        f"encoder.down_blocks.{i}.downsamplers.0.conv",
                        "conv"))
    out += _resnet_entries(("encoder", "mid", "resnet1"),
                           "encoder.mid_block.resnets.0", False,
                           with_time=False)
    out += _vae_attn_entries(("encoder", "mid", "attn"),
                             "encoder.mid_block.attentions.0")
    out += _resnet_entries(("encoder", "mid", "resnet2"),
                           "encoder.mid_block.resnets.1", False,
                           with_time=False)
    out += [(("encoder", "norm_out"), "encoder.conv_norm_out", "norm"),
            (("encoder", "conv_out"), "encoder.conv_out", "conv"),
            (("encoder", "quant_conv"), "quant_conv", "conv"),
            (("decoder", "post_quant_conv"), "post_quant_conv", "conv"),
            (("decoder", "conv_in"), "decoder.conv_in", "conv")]
    out += _resnet_entries(("decoder", "mid", "resnet1"),
                           "decoder.mid_block.resnets.0", False,
                           with_time=False)
    out += _vae_attn_entries(("decoder", "mid", "attn"),
                             "decoder.mid_block.attentions.0")
    out += _resnet_entries(("decoder", "mid", "resnet2"),
                           "decoder.mid_block.resnets.1", False,
                           with_time=False)
    rev = list(reversed(ch))
    for i in range(n):
        cin = rev[i - 1] if i > 0 else rev[0]
        for j in range(cfg.layers_per_block + 1):
            rin = cin if j == 0 else rev[i]
            out += _resnet_entries(
                ("decoder", "up", i, "resnets", j),
                f"decoder.up_blocks.{i}.resnets.{j}",
                rin != rev[i], with_time=False)
        if i < n - 1:
            out.append((("decoder", "up", i, "upsample"),
                        f"decoder.up_blocks.{i}.upsamplers.0.conv", "conv"))
    out += [(("decoder", "norm_out"), "decoder.conv_norm_out", "norm"),
            (("decoder", "conv_out"), "decoder.conv_out", "conv")]
    return out


# -- conversions ----------------------------------------------------------------

# old-format VAE attention names (diffusers before its Attention refactor)
_VAE_ATTN_LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value",
                    "to_out.0": "proj_attn"}


def _hf_get(host: Dict, name: str, suffix: str) -> torch.Tensor:
    """host[name.suffix], falling back to the legacy VAE attention
    names."""
    full = f"{name}.{suffix}"
    if full in host:
        return _host_tensor(host, full)
    leaf = name.rsplit(".", 2)
    for new, old in _VAE_ATTN_LEGACY.items():
        if name.endswith(new):
            legacy = name[: -len(new)] + old + "." + suffix
            if legacy in host:
                return _host_tensor(host, legacy)
    raise KeyError(f"missing tensor '{full}' (legacy fallbacks exhausted; "
                   f"near {leaf})")


def _from_hf(host: Dict, name: str, kind: str, dtype, device) -> Dict:
    w = _hf_get(host, name, "weight")
    if kind == "conv":
        leaf = {"w": w.permute(2, 3, 1, 0), "b": _hf_get(host, name, "bias")}
    elif kind == "linear":
        leaf = {"w": w.T, "b": _hf_get(host, name, "bias")}
    elif kind == "linear_nobias":
        leaf = {"w": w.T, "b": torch.zeros((w.shape[0],), dtype=w.dtype)}
    elif kind == "norm":
        leaf = {"w": w, "b": _hf_get(host, name, "bias")}
    elif kind == "proj":  # 1x1 conv (SD1.5) or linear (use_linear_projection)
        w2 = w[:, :, 0, 0] if w.dim() == 4 else w
        leaf = {"w": w2.T, "b": _hf_get(host, name, "bias")}
    elif kind == "attn1x1":  # our 1x1-conv storage; hf linear or conv
        w2 = (w.permute(2, 3, 1, 0) if w.dim() == 4 else w.T[None, None])
        leaf = {"w": w2, "b": _hf_get(host, name, "bias")}
    else:
        raise ValueError(f"unknown conversion kind '{kind}'")
    return {k: v.contiguous().to(device, dtype) for k, v in leaf.items()}


def _np32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _to_hf(leaf: Dict, name: str, kind: str, out: Dict) -> None:
    w = _np32(leaf["w"])
    if kind == "conv":
        out[f"{name}.weight"] = w.transpose(3, 2, 0, 1)
        out[f"{name}.bias"] = _np32(leaf["b"])
    elif kind in ("linear", "proj"):
        out[f"{name}.weight"] = w.T
        out[f"{name}.bias"] = _np32(leaf["b"])
    elif kind == "linear_nobias":
        out[f"{name}.weight"] = w.T
    elif kind == "norm":
        out[f"{name}.weight"] = w
        out[f"{name}.bias"] = _np32(leaf["b"])
    elif kind == "attn1x1":
        out[f"{name}.weight"] = w[0, 0].T
        out[f"{name}.bias"] = _np32(leaf["b"])
    else:
        raise ValueError(f"unknown conversion kind '{kind}'")


def _walk(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def _assign(root, path, value) -> None:
    """Set tree[path] = value, growing dicts/lists along the way (int path
    entries create lists, str entries create dicts)."""
    node = root
    for p, nxt in zip(path, path[1:]):
        empty = [] if isinstance(nxt, int) else {}
        if isinstance(p, int):
            while len(node) <= p:
                node.append(None)
            if node[p] is None:
                node[p] = empty
        elif p not in node:
            node[p] = empty
        node = node[p]
    last = path[-1]
    if isinstance(last, int):
        while len(node) <= last:
            node.append(None)
        node[last] = value
    else:
        node[last] = value


def _component_entries(component: str, cfg: SDConfig) -> List[Entry]:
    if component == "unet":
        return _unet_entries(cfg.unet)
    if component == "vae":
        return _vae_entries(cfg.vae)
    raise ValueError(f"unknown SD component '{component}'")


def load_unet_params(model_dir: str, cfg: UNetConfig, dtype=torch.float32,
                     device="cpu"):
    return _load_tabular("unet", model_dir, SDConfig(unet=cfg), dtype,
                         device)


def load_vae_params(model_dir: str, cfg: VAEConfig, dtype=torch.float32,
                    device="cpu"):
    return _load_tabular("vae", model_dir, SDConfig(vae=cfg), dtype, device)


def tree_shapes(tree):
    """The tree's structure with each leaf replaced by its shape."""
    if isinstance(tree, dict):
        return {k: tree_shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_shapes(v) for v in tree]
    return tuple(tree.shape)


def _load_tabular(component: str, model_dir: str, cfg: SDConfig, dtype,
                  device):
    """Build the parameter dict straight from the entry table (no
    throwaway random init: a real SD1.5 UNet is ~860M parameters). The
    structure is checked against the init function run on the meta
    device (shapes only, nothing drawn), so table drift fails here
    instead of as a KeyError mid-forward."""
    host = load_weights(model_dir)
    dev = resolve_device(device)
    params: Dict = {}
    for path, name, kind in _component_entries(component, cfg):
        _assign(params, path, _from_hf(host, name, kind, dtype, dev))
    if component == "unet":
        # attention-free blocks still carry an empty attns list in the
        # init structure (unet_forward branches on `block["attns"]`)
        for side in ("down", "up"):
            for block in params[side]:
                block.setdefault("attns", [])
        from cake_tpu_torch.models.sd.unet import init_unet_params
        expect = init_unet_params(cfg.unet, None, dtype, device="meta")
    else:
        from cake_tpu_torch.models.sd.vae import init_vae_params
        expect = init_vae_params(cfg.vae, None, dtype, device="meta")
    if tree_shapes(params) != tree_shapes(expect):
        raise ValueError(
            f"{component} checkpoint mapping does not match the model "
            f"structure for this config (entry-table drift?)")
    return params


def export_sd_component(component: str, params, cfg: SDConfig
                        ) -> Dict[str, np.ndarray]:
    """The parameter dict -> {diffusers tensor name: np.ndarray} (f32):
    the inverse of the loader, for round trips and for checkpoints other
    SD stacks read."""
    out: Dict[str, np.ndarray] = {}
    for path, name, kind in _component_entries(component, cfg):
        _to_hf(_walk(params, path), name, kind, out)
    return out


def save_sd_component(component: str, params, cfg: SDConfig,
                      path: str) -> None:
    from cake_tpu_torch.utils.loading import save_safetensors
    save_safetensors(path, export_sd_component(component, params, cfg))


def load_sd_component(component: str, path: str, cfg: SDConfig, dtype,
                      device="cpu"):
    """Real weights of an SD component (clip, clip2, vae, unet) on
    `device`."""
    if component in ("clip", "clip2"):
        ccfg = cfg.clip if component == "clip" else cfg.clip2
        return load_clip_params(path, ccfg, dtype, device)
    if component == "unet":
        return load_unet_params(path, cfg.unet, dtype, device)
    if component == "vae":
        return load_vae_params(path, cfg.vae, dtype, device)
    raise ValueError(f"unknown SD component '{component}'")
