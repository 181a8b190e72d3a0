"""Stable Diffusion architecture configs per version.

Counterpart of `cake_tpu/models/sd/config.py`, copied: `ClipConfig`,
`UNetConfig`, `VAEConfig`, `SDConfig`, the presets of `get_sd_config`
(v1-5, v2-1, xl, turbo; the published diffusers architectures) and
`tiny_sd_config`. `SDVersion` is the port's own copy of the JAX
package's enum (cake_tpu/args.py), so the port imports nothing of it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional, Tuple


class SDVersion(str, Enum):
    V1_5 = "v1-5"
    V2_1 = "v2-1"
    XL = "xl"
    TURBO = "turbo"


@dataclass(frozen=True)
class ClipConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"      # v2/XL encoders use "gelu"
    projection_dim: Optional[int] = None  # XL text_encoder_2 projects pooled

    @classmethod
    def vit_l_14(cls):  # SD v1.5 / SDXL encoder 1
        return cls()

    @classmethod
    def vit_h_14(cls):  # SD v2.1
        return cls(hidden_size=1024, intermediate_size=4096,
                   num_hidden_layers=23, num_attention_heads=16,
                   hidden_act="gelu")

    @classmethod
    def vit_bigg_14(cls):  # SDXL encoder 2
        return cls(hidden_size=1280, intermediate_size=5120,
                   num_hidden_layers=32, num_attention_heads=20,
                   hidden_act="gelu", projection_dim=1280)


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    sample_size: int = 64
    cross_attention_dim: int = 768
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # per down-block: does it carry cross-attention transformer blocks?
    attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 0)
    attention_head_dim: Tuple[int, ...] = (8, 8, 8, 8)   # heads per block
    time_embed_dim_mult: int = 4
    # SDXL extras
    addition_embed_dim: Optional[int] = None  # text_embeds+time_ids path
    num_groups: int = 32


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    scaling_factor: float = 0.18215     # 0.13025 for SDXL
    num_groups: int = 32

    @property
    def downscale_factor(self) -> int:
        """Spatial ratio pixels/latents: one stride-2 conv per non-final
        block (8 for the standard 4-block VAE)."""
        return 2 ** (len(self.block_out_channels) - 1)


@dataclass(frozen=True)
class SDConfig:
    version: SDVersion = SDVersion.V1_5
    clip: ClipConfig = field(default_factory=ClipConfig.vit_l_14)
    clip2: Optional[ClipConfig] = None
    unet: UNetConfig = field(default_factory=UNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    height: int = 512
    width: int = 512
    default_steps: int = 30
    default_guidance: float = 7.5
    prediction_type: str = "epsilon"    # "v_prediction" for v2.1-768


def get_sd_config(version: SDVersion, height: Optional[int] = None,
                  width: Optional[int] = None) -> SDConfig:
    """Per-version presets; height and width override the preset's
    (multiples of 8)."""
    if version == SDVersion.V1_5:
        cfg = SDConfig()
    elif version == SDVersion.V2_1:
        cfg = SDConfig(
            version=version,
            clip=ClipConfig.vit_h_14(),
            unet=UNetConfig(cross_attention_dim=1024,
                            attention_head_dim=(5, 10, 20, 20)),
            height=768, width=768,
            default_guidance=7.5,
        )
    elif version in (SDVersion.XL, SDVersion.TURBO):
        cfg = SDConfig(
            version=version,
            clip=ClipConfig.vit_l_14(),
            clip2=ClipConfig.vit_bigg_14(),
            unet=UNetConfig(
                cross_attention_dim=2048,
                block_out_channels=(320, 640, 1280),
                attn_blocks=(False, True, True),
                transformer_layers_per_block=(0, 2, 10),
                attention_head_dim=(5, 10, 20),
                addition_embed_dim=2816,
            ),
            vae=VAEConfig(scaling_factor=0.13025),
            height=1024, width=1024,
            default_steps=1 if version == SDVersion.TURBO else 30,
            default_guidance=0.0 if version == SDVersion.TURBO else 7.5,
        )
    else:
        raise ValueError(f"unknown SD version {version}")
    if height is not None or width is not None:
        h = height or cfg.height
        w = width or cfg.width
        if h % 8 or w % 8:
            raise ValueError("height/width must be multiples of 8")
        object.__setattr__(cfg, "height", h)
        object.__setattr__(cfg, "width", w)
    return cfg


def tiny_sd_config() -> SDConfig:
    """Miniature config for tests: full architecture, tiny dims."""
    return SDConfig(
        clip=ClipConfig(vocab_size=1000, hidden_size=64,
                        intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, max_position_embeddings=77),
        unet=UNetConfig(
            cross_attention_dim=64,
            block_out_channels=(32, 64),
            layers_per_block=1,
            attn_blocks=(True, False),
            transformer_layers_per_block=(1, 0),
            attention_head_dim=(4, 4),
            num_groups=8,
        ),
        vae=VAEConfig(block_out_channels=(32, 64), layers_per_block=1,
                      num_groups=8),
        height=64, width=64, default_steps=3,
    )
