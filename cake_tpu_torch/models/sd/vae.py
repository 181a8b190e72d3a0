"""AutoencoderKL (NHWC).

Counterpart of `cake_tpu/models/sd/vae.py` (`init_vae_params`,
`vae_encode`, `vae_decode`): the diffusers AutoencoderKL graph (the
encoder's downsampling ResnetBlocks and a mid block with one
self-attention; the decoder mirrors it), so SD checkpoints map on.
`vae_encode` samples the posterior (img2img's init latents) with noise
from an explicit `torch.Generator`, where JAX draws it from a threefry
key: the two packages' samples differ for one seed, and the tests feed
both the same noise through `noise=`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cake_tpu_torch.models.sd.config import VAEConfig
from cake_tpu_torch.models.sd.layers import (
    conv2d, group_norm, mha, nearest_upsample_2x,
)
from cake_tpu_torch.models.sd.unet import _Init


def _res_p(ini: _Init, cin, cout):
    p = {
        "norm1": ini.norm(cin),
        "conv1": ini.conv(3, 3, cin, cout),
        "norm2": ini.norm(cout),
        "conv2": ini.conv(3, 3, cout, cout),
    }
    if cin != cout:
        p["shortcut"] = ini.conv(1, 1, cin, cout)
    return p


def _attn_p(ini: _Init, c):
    return {"norm": ini.norm(c), "q": ini.conv(1, 1, c, c),
            "k": ini.conv(1, 1, c, c), "v": ini.conv(1, 1, c, c),
            "o": ini.conv(1, 1, c, c)}


def init_vae_params(cfg: VAEConfig, generator: torch.Generator,
                    dtype=torch.float32, device="cpu"):
    """Random VAE parameters in JAX's tree, drawn on `device`."""
    ini = _Init(generator, dtype, device)
    ch = cfg.block_out_channels
    n = len(ch)
    lat = cfg.latent_channels

    enc = {"conv_in": ini.conv(3, 3, cfg.in_channels, ch[0]), "down": []}
    for i in range(n):
        cin = ch[i - 1] if i > 0 else ch[0]
        block = {"resnets": [_res_p(ini, cin if j == 0 else ch[i], ch[i])
                             for j in range(cfg.layers_per_block)]}
        if i < n - 1:
            block["downsample"] = ini.conv(3, 3, ch[i], ch[i])
        enc["down"].append(block)
    enc["mid"] = {"resnet1": _res_p(ini, ch[-1], ch[-1]),
                  "attn": _attn_p(ini, ch[-1]),
                  "resnet2": _res_p(ini, ch[-1], ch[-1])}
    enc["norm_out"] = ini.norm(ch[-1])
    enc["conv_out"] = ini.conv(3, 3, ch[-1], 2 * lat)
    enc["quant_conv"] = ini.conv(1, 1, 2 * lat, 2 * lat)

    dec = {"post_quant_conv": ini.conv(1, 1, lat, lat),
           "conv_in": ini.conv(3, 3, lat, ch[-1])}
    dec["mid"] = {"resnet1": _res_p(ini, ch[-1], ch[-1]),
                  "attn": _attn_p(ini, ch[-1]),
                  "resnet2": _res_p(ini, ch[-1], ch[-1])}
    dec["up"] = []
    rev = list(reversed(ch))
    for i in range(n):
        cin = rev[i - 1] if i > 0 else rev[0]
        block = {"resnets": [_res_p(ini, cin if j == 0 else rev[i], rev[i])
                             for j in range(cfg.layers_per_block + 1)]}
        if i < n - 1:
            block["upsample"] = ini.conv(3, 3, rev[i], rev[i])
        dec["up"].append(block)
    dec["norm_out"] = ini.norm(ch[0])
    dec["conv_out"] = ini.conv(3, 3, ch[0], cfg.in_channels)
    return {"encoder": enc, "decoder": dec}


def _res(p, x, groups):
    h = group_norm(x, p["norm1"]["w"], p["norm1"]["b"], groups)
    h = conv2d(F.silu(h), p["conv1"]["w"], p["conv1"]["b"])
    h = group_norm(h, p["norm2"]["w"], p["norm2"]["b"], groups)
    h = conv2d(F.silu(h), p["conv2"]["w"], p["conv2"]["b"])
    if "shortcut" in p:
        x = conv2d(x, p["shortcut"]["w"], p["shortcut"]["b"], padding=0)
    return x + h


def _self_attn(p, x, groups):
    B, H, W, C = x.shape
    h = group_norm(x, p["norm"]["w"], p["norm"]["b"], groups)
    q = conv2d(h, p["q"]["w"], p["q"]["b"], padding=0).reshape(B, H * W, C)
    k = conv2d(h, p["k"]["w"], p["k"]["b"], padding=0).reshape(B, H * W, C)
    v = conv2d(h, p["v"]["w"], p["v"]["b"], padding=0).reshape(B, H * W, C)
    attn = mha(q, k, v, num_heads=1).reshape(B, H, W, C)
    return x + conv2d(attn, p["o"]["w"], p["o"]["b"], padding=0)


def vae_encode(params, cfg: VAEConfig, images,
               generator: Optional[torch.Generator] = None,
               sample: bool = True, noise: Optional[torch.Tensor] = None):
    """images [B, H, W, 3] in [-1, 1] -> latents [B, H/8, W/8, C_lat],
    scaled by scaling_factor. sample: add the posterior's noise, `noise`
    when given, else drawn from `generator`."""
    p = params["encoder"]
    g = cfg.num_groups
    x = conv2d(images, p["conv_in"]["w"], p["conv_in"]["b"])
    for block in p["down"]:
        for rp in block["resnets"]:
            x = _res(rp, x, g)
        if "downsample" in block:
            # diffusers pads (0, 1, 0, 1) before the stride-2 conv
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
            x = conv2d(x, block["downsample"]["w"], block["downsample"]["b"],
                       stride=2, padding=0)
    x = _res(p["mid"]["resnet1"], x, g)
    x = _self_attn(p["mid"]["attn"], x, g)
    x = _res(p["mid"]["resnet2"], x, g)
    x = group_norm(x, p["norm_out"]["w"], p["norm_out"]["b"], g)
    x = conv2d(F.silu(x), p["conv_out"]["w"], p["conv_out"]["b"])
    moments = conv2d(x, p["quant_conv"]["w"], p["quant_conv"]["b"],
                     padding=0)
    mean, logvar = moments.chunk(2, dim=-1)
    if sample:
        if noise is None:
            if generator is None:
                raise ValueError(
                    "sampling the VAE posterior needs a generator")
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device).to(mean.dtype)
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        mean = mean + std * noise
    return mean * cfg.scaling_factor


def vae_decode(params, cfg: VAEConfig, latents):
    """latents (scaled) -> images [B, H, W, 3] in [-1, 1]."""
    p = params["decoder"]
    g = cfg.num_groups
    x = latents / cfg.scaling_factor
    x = conv2d(x, p["post_quant_conv"]["w"], p["post_quant_conv"]["b"],
               padding=0)
    x = conv2d(x, p["conv_in"]["w"], p["conv_in"]["b"])
    x = _res(p["mid"]["resnet1"], x, g)
    x = _self_attn(p["mid"]["attn"], x, g)
    x = _res(p["mid"]["resnet2"], x, g)
    for block in p["up"]:
        for rp in block["resnets"]:
            x = _res(rp, x, g)
        if "upsample" in block:
            x = nearest_upsample_2x(x)
            x = conv2d(x, block["upsample"]["w"], block["upsample"]["b"])
    x = group_norm(x, p["norm_out"]["w"], p["norm_out"]["b"], g)
    return conv2d(F.silu(x), p["conv_out"]["w"], p["conv_out"]["b"])
