"""UNet2DCondition (NHWC).

Counterpart of `cake_tpu/models/sd/unet.py` (`init_unet_params`,
`unet_forward`): the diffusers UNet2DConditionModel graph (conv_in ->
time embedding -> down blocks (ResnetBlock2D + Transformer2D cross
attention) -> mid -> up blocks with skip connections -> GroupNorm / SiLU
/ conv_out), so SD v1.5 / v2.1 / SDXL checkpoints map onto it, SDXL's
added condition (text_embeds + time_ids -> add_embedding) included. The
parameter tree is JAX's, leaf for leaf.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from cake_tpu_torch.models.sd.config import UNetConfig
from cake_tpu_torch.models.sd.layers import (
    conv2d, group_norm, layer_norm, linear, mha, nearest_upsample_2x,
    timestep_embedding,
)


# -- init ----------------------------------------------------------------------


class _Init:
    """Draws JAX's leaves (normal 0.02 weights, zero biases, unit norms)
    from one generator on one device."""

    def __init__(self, generator: torch.Generator, dtype, device):
        self.gen, self.dtype, self.device = generator, dtype, device

    def w(self, shape, scale=0.02):
        return (torch.randn(shape, generator=self.gen, device=self.device)
                * scale).to(self.dtype)

    def zeros(self, n):
        return torch.zeros((n,), dtype=self.dtype, device=self.device)

    def conv(self, kh, kw, cin, cout):
        return {"w": self.w((kh, kw, cin, cout)), "b": self.zeros(cout)}

    def lin(self, cin, cout):
        return {"w": self.w((cin, cout)), "b": self.zeros(cout)}

    def norm(self, c):
        return {"w": torch.ones((c,), dtype=self.dtype, device=self.device),
                "b": self.zeros(c)}


def _resnet_p(ini: _Init, cin, cout, temb_dim):
    p = {
        "norm1": ini.norm(cin),
        "conv1": ini.conv(3, 3, cin, cout),
        "time_emb": ini.lin(temb_dim, cout),
        "norm2": ini.norm(cout),
        "conv2": ini.conv(3, 3, cout, cout),
    }
    if cin != cout:
        p["shortcut"] = ini.conv(1, 1, cin, cout)
    return p


def _xformer_p(ini: _Init, channels, n_layers, ctx_dim):
    inner = 4 * channels
    blocks = []
    for _ in range(n_layers):
        blocks.append({
            "ln1": ini.norm(channels),
            "attn1": {"q": ini.lin(channels, channels),
                      "k": ini.lin(channels, channels),
                      "v": ini.lin(channels, channels),
                      "o": ini.lin(channels, channels)},
            "ln2": ini.norm(channels),
            "attn2": {"q": ini.lin(channels, channels),
                      "k": ini.lin(ctx_dim, channels),
                      "v": ini.lin(ctx_dim, channels),
                      "o": ini.lin(channels, channels)},
            "ln3": ini.norm(channels),
            "geglu": ini.lin(channels, 2 * inner),
            "ff_out": ini.lin(inner, channels),
        })
    return {
        "norm": ini.norm(channels),
        "proj_in": ini.lin(channels, channels),
        "blocks": blocks,
        "proj_out": ini.lin(channels, channels),
    }


def init_unet_params(cfg: UNetConfig, generator: torch.Generator,
                     dtype=torch.float32, device="cpu"):
    """Random UNet parameters in JAX's tree, drawn on `device`."""
    ini = _Init(generator, dtype, device)
    ch = cfg.block_out_channels
    temb_dim = ch[0] * cfg.time_embed_dim_mult
    n_blocks = len(ch)

    params = {
        "conv_in": ini.conv(3, 3, cfg.in_channels, ch[0]),
        "time_mlp1": ini.lin(ch[0], temb_dim),
        "time_mlp2": ini.lin(temb_dim, temb_dim),
    }
    if cfg.addition_embed_dim:
        params["add_mlp1"] = ini.lin(cfg.addition_embed_dim, temb_dim)
        params["add_mlp2"] = ini.lin(temb_dim, temb_dim)

    skip_ch: List[int] = [ch[0]]
    down = []
    for i in range(n_blocks):
        cin = ch[i - 1] if i > 0 else ch[0]
        cout = ch[i]
        block = {"resnets": [], "attns": []}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(
                _resnet_p(ini, cin if j == 0 else cout, cout, temb_dim))
            if cfg.attn_blocks[i]:
                block["attns"].append(_xformer_p(
                    ini, cout, cfg.transformer_layers_per_block[i],
                    cfg.cross_attention_dim))
            skip_ch.append(cout)
        if i < n_blocks - 1:
            block["downsample"] = ini.conv(3, 3, cout, cout)
            skip_ch.append(cout)
        down.append(block)
    params["down"] = down

    c_mid = ch[-1]
    # the mid block always carries cross attention (one transformer layer
    # where the deepest down block has none; SDXL's deepest depth else)
    mid_layers = (cfg.transformer_layers_per_block[-1]
                  if cfg.attn_blocks[-1] else 1)
    params["mid"] = {
        "resnet1": _resnet_p(ini, c_mid, c_mid, temb_dim),
        "attn": _xformer_p(ini, c_mid, mid_layers, cfg.cross_attention_dim),
        "resnet2": _resnet_p(ini, c_mid, c_mid, temb_dim),
    }

    up = []
    rev = list(reversed(ch))
    prev = ch[-1]
    for i in range(n_blocks):
        cout = rev[i]
        block = {"resnets": [], "attns": []}
        src_block = n_blocks - 1 - i
        for j in range(cfg.layers_per_block + 1):
            skip = skip_ch.pop()
            block["resnets"].append(
                _resnet_p(ini, prev + skip, cout, temb_dim))
            prev = cout
            if cfg.attn_blocks[src_block]:
                block["attns"].append(_xformer_p(
                    ini, cout, cfg.transformer_layers_per_block[src_block],
                    cfg.cross_attention_dim))
        if i < n_blocks - 1:
            block["upsample"] = ini.conv(3, 3, cout, cout)
        up.append(block)
    params["up"] = up

    params["norm_out"] = ini.norm(ch[0])
    params["conv_out"] = ini.conv(3, 3, ch[0], cfg.out_channels)
    return params


# -- forward -------------------------------------------------------------------


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def _resnet(p, x, temb, groups):
    h = group_norm(x, p["norm1"]["w"], p["norm1"]["b"], groups)
    h = conv2d(F.silu(h), p["conv1"]["w"], p["conv1"]["b"])
    t = linear(F.silu(temb), p["time_emb"]["w"], p["time_emb"]["b"])
    h = h + t[:, None, None, :]
    h = group_norm(h, p["norm2"]["w"], p["norm2"]["b"], groups)
    h = conv2d(F.silu(h), p["conv2"]["w"], p["conv2"]["b"])
    if "shortcut" in p:
        x = conv2d(x, p["shortcut"]["w"], p["shortcut"]["b"], padding=0)
    return x + h


def _geglu(p, x):
    a, gate = linear(x, p["w"], p["b"]).chunk(2, dim=-1)
    return a * _gelu(gate)


def _transformer(p, x, context, heads, groups):
    """Transformer2DModel: spatial tokens attend to themselves and to the
    text context."""
    B, H, W, C = x.shape
    residual = x
    h = group_norm(x, p["norm"]["w"], p["norm"]["b"], groups)
    h = h.reshape(B, H * W, C)
    h = linear(h, p["proj_in"]["w"], p["proj_in"]["b"])
    for bp in p["blocks"]:
        n = layer_norm(h, bp["ln1"]["w"], bp["ln1"]["b"])
        h = h + linear(
            mha(linear(n, bp["attn1"]["q"]["w"]),
                linear(n, bp["attn1"]["k"]["w"]),
                linear(n, bp["attn1"]["v"]["w"]), heads),
            bp["attn1"]["o"]["w"], bp["attn1"]["o"]["b"])
        n = layer_norm(h, bp["ln2"]["w"], bp["ln2"]["b"])
        h = h + linear(
            mha(linear(n, bp["attn2"]["q"]["w"]),
                linear(context, bp["attn2"]["k"]["w"]),
                linear(context, bp["attn2"]["v"]["w"]), heads),
            bp["attn2"]["o"]["w"], bp["attn2"]["o"]["b"])
        n = layer_norm(h, bp["ln3"]["w"], bp["ln3"]["b"])
        h = h + linear(_geglu(bp["geglu"], n),
                       bp["ff_out"]["w"], bp["ff_out"]["b"])
    h = linear(h, p["proj_out"]["w"], p["proj_out"]["b"])
    return h.reshape(B, H, W, C) + residual


def unet_forward(params, cfg: UNetConfig, latents, timesteps, context,
                 added_cond: Optional[dict] = None):
    """latents [B, H, W, C_in] (NHWC), timesteps [B], context
    [B, S, ctx_dim] -> noise prediction [B, H, W, C_out]."""
    ch = cfg.block_out_channels
    groups = cfg.num_groups
    temb = timestep_embedding(timesteps, ch[0])
    temb = linear(F.silu(
        linear(temb.to(latents.dtype), params["time_mlp1"]["w"],
               params["time_mlp1"]["b"])),
        params["time_mlp2"]["w"], params["time_mlp2"]["b"])
    if cfg.addition_embed_dim and added_cond is not None:
        # SDXL: concat(pooled text_embeds, fourier(time_ids)) -> MLP -> add
        te = added_cond["text_embeds"]
        tids = added_cond["time_ids"]                     # [B, 6]
        tid_emb = timestep_embedding(
            tids.reshape(-1), 256).reshape(te.shape[0], -1)
        add = torch.cat([te, tid_emb.to(te.dtype)], dim=-1)
        add = linear(F.silu(
            linear(add, params["add_mlp1"]["w"], params["add_mlp1"]["b"])),
            params["add_mlp2"]["w"], params["add_mlp2"]["b"])
        temb = temb + add

    x = conv2d(latents, params["conv_in"]["w"], params["conv_in"]["b"])
    skips = [x]
    n_blocks = len(ch)

    for i, block in enumerate(params["down"]):
        heads = cfg.attention_head_dim[i]
        for j, rp in enumerate(block["resnets"]):
            x = _resnet(rp, x, temb, groups)
            if block["attns"]:
                x = _transformer(block["attns"][j], x, context, heads, groups)
            skips.append(x)
        if "downsample" in block:
            x = conv2d(x, block["downsample"]["w"], block["downsample"]["b"],
                       stride=2)
            skips.append(x)

    mid_heads = cfg.attention_head_dim[-1]
    x = _resnet(params["mid"]["resnet1"], x, temb, groups)
    x = _transformer(params["mid"]["attn"], x, context, mid_heads, groups)
    x = _resnet(params["mid"]["resnet2"], x, temb, groups)

    for i, block in enumerate(params["up"]):
        src_block = n_blocks - 1 - i
        heads = cfg.attention_head_dim[src_block]
        for j, rp in enumerate(block["resnets"]):
            skip = skips.pop()
            x = _resnet(rp, torch.cat([x, skip], dim=-1), temb, groups)
            if block["attns"]:
                x = _transformer(block["attns"][j], x, context, heads, groups)
        if "upsample" in block:
            x = nearest_upsample_2x(x)
            x = conv2d(x, block["upsample"]["w"], block["upsample"]["b"])

    x = group_norm(x, params["norm_out"]["w"], params["norm_out"]["b"],
                   groups)
    return conv2d(F.silu(x), params["conv_out"]["w"], params["conv_out"]["b"])
