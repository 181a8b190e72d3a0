"""Stable Diffusion in PyTorch: the CLIP text encoder, UNet2DCondition,
AutoencoderKL, the schedulers and the guidance / denoise loop.

Counterpart of `cake_tpu/models/sd/`, with diffusers-compatible weight
names, so the same safetensors checkpoints load, and the JAX package's
parameter layouts (NHWC activations, HWIO convs, [in, out] linears), so
the two packages' trees are the same.
"""

from cake_tpu_torch.models.sd.config import (  # noqa: F401
    SDConfig, SDVersion, get_sd_config,
)
