"""Shared neural-net layers of the diffusion stack.

Counterpart of `cake_tpu/models/sd/layers.py`, with the JAX package's
layouts so the two packages' parameter trees are the same: activations
NHWC [B, H, W, C], conv weights HWIO [kh, kw, C_in, C_out], linear
weights [in, out]. A convolution is `torch.nn.functional.conv2d` over
the NCHW view of the NHWC activations (a channels-last tensor, which
cuDNN reads without a copy) and the OIHW view of the weight; JAX leaves
convolutions to XLA, so neither is the port of a kernel. GroupNorm and
LayerNorm reduce in f32, as in JAX. `mha` runs the port's
`gqa_attention` with KV == H, as JAX's runs its own (an XLA einsum with
no Pallas body).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from cake_tpu_torch.ops.attention import gqa_attention


def conv2d(x, w, b=None, stride: int = 1, padding: int = 1):
    """x: [B, H, W, C_in]; w: [kh, kw, C_in, C_out] (HWIO); b: [C_out]
    -> [B, H', W', C_out] in x's dtype."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=stride, padding=padding)
    out = out.permute(0, 2, 3, 1)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def group_norm(x, weight, bias, num_groups: int = 32, eps: float = 1e-6):
    """GroupNorm over channel groups; x: [B, H, W, C] (reduced in f32)."""
    B, H, W, C = x.shape
    xf = x.float().reshape(B, H * W, num_groups, C // num_groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), correction=0, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    xf = xf.reshape(B, H, W, C)
    return (xf * weight.float() + bias.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=-1, correction=0, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def linear(x, w, b=None):
    """x @ w (+ b); w stored [in, out]."""
    out = x @ w
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def mha(q, k, v, num_heads: int, mask=None):
    """Multi-head attention on [B, S, D] tensors (f32 softmax): CLIP's
    causal self-attention and the UNet's self and cross attention."""
    B, S, D = q.shape
    T = k.shape[1]
    hd = D // num_heads
    out = gqa_attention(q.reshape(B, S, num_heads, hd),
                        k.reshape(B, T, num_heads, hd),
                        v.reshape(B, T, num_heads, hd), mask=mask)
    return out.reshape(B, S, D)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True, shift: float = 0.0):
    """Sinusoidal timestep embedding [B] -> [B, dim] f32 (diffusers: half
    sin, half cos; cos first for SD)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half)
    args = timesteps.float()[:, None] * freqs[None, :] + shift
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def nearest_upsample_2x(x):
    """[B, H, W, C] -> [B, 2H, 2W, C] nearest-neighbour."""
    B, H, W, C = x.shape
    x = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
    return x.reshape(B, 2 * H, 2 * W, C)
