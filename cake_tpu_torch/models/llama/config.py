"""Llama model hyperparameters, deserialised from HF `config.json`.

Counterpart of `cake_tpu/models/llama/config.py`, copied with the one
kernel knob the port reads (`use_flash_attention`) and without the
JAX-side rest. The runtime context window is a separate knob
(`Args.max_seq_len`), not part of the model config.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple


def _read_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def load_config_dict(raw: dict) -> "LlamaConfig":
    """Dispatch a parsed config.json on `model_type`: "mixtral" ->
    MoEConfig (sparse experts), anything else -> LlamaConfig."""
    if raw.get("model_type") == "mixtral":
        from cake_tpu_torch.models.moe.config import MoEConfig
        return MoEConfig.from_hf_dict(raw)
    return LlamaConfig.from_hf_dict(raw)


def load_config(model_dir: str) -> "LlamaConfig":
    """Load `<model_dir>/config.json`."""
    return load_config_dict(_read_config(model_dir))


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 8192
    bos_token_id: int = 128000
    eos_token_ids: Tuple[int, ...] = (128001, 128009)
    tie_word_embeddings: bool = False
    # Sliding-window attention (Mistral-family, HF "sliding_window"):
    # each query attends at most this many most-recent positions. None =
    # full causal attention (Llama).
    sliding_window: Optional[int] = None
    # prompt template for the chat paths (models/chat.TEMPLATES)
    chat_template: str = "llama3"
    # QKV projection bias (Qwen2-family; HF "attention_bias" / implied by
    # model_type qwen2) — adds bq/bk/bv leaves to every block
    attention_bias: bool = False
    # Prefill attention through the flash kernels (ops/flash_attention.py)
    # instead of the masked einsum. Off by default; the Context turns it
    # on when the device is CUDA.
    use_flash_attention: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def is_moe(self) -> bool:
        """Family dispatch: MoEConfig carries num_local_experts, dense
        configs do not."""
        return bool(getattr(self, "num_local_experts", 0))

    @classmethod
    def from_path(cls, model_dir: str) -> "LlamaConfig":
        """Load `<model_dir>/config.json` with model_type dispatch; called
        on a subclass, that subclass is guaranteed."""
        raw = _read_config(model_dir)
        cfg = load_config_dict(raw)
        return cfg if isinstance(cfg, cls) else cls.from_hf_dict(raw)

    @classmethod
    def from_hf_dict(cls, raw: dict) -> "LlamaConfig":
        eos = raw.get("eos_token_id", 128001)
        if isinstance(eos, int):
            eos = (eos,)
        else:
            eos = tuple(eos)
        return cls(
            vocab_size=raw["vocab_size"],
            hidden_size=raw["hidden_size"],
            intermediate_size=raw["intermediate_size"],
            num_hidden_layers=raw["num_hidden_layers"],
            num_attention_heads=raw["num_attention_heads"],
            num_key_value_heads=raw.get(
                "num_key_value_heads", raw["num_attention_heads"]
            ),
            rms_norm_eps=raw.get("rms_norm_eps", 1e-5),
            rope_theta=raw.get("rope_theta", 10000.0),
            max_position_embeddings=raw.get("max_position_embeddings", 8192),
            bos_token_id=raw.get("bos_token_id", 128000),
            eos_token_ids=eos,
            tie_word_embeddings=raw.get("tie_word_embeddings", False),
            # Qwen2/2.5 checkpoints ship sliding_window alongside
            # use_sliding_window: false (full attention) — honor the gate
            sliding_window=(raw.get("sliding_window")
                            if raw.get("use_sliding_window", True)
                            else None),
            chat_template={"mistral": "mistral", "mixtral": "mistral",
                           "qwen2": "chatml"}.get(
                               raw.get("model_type", ""), "llama3"),
            attention_bias=raw.get("attention_bias",
                                   raw.get("model_type") == "qwen2"),
        )

    @classmethod
    def tiny(cls, **overrides) -> "LlamaConfig":
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0,
            max_position_embeddings=256, bos_token_id=1,
            eos_token_ids=(2,), tie_word_embeddings=False,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=500000.0,
            max_position_embeddings=8192,
        )

    @classmethod
    def mistral_7b(cls) -> "LlamaConfig":
        """Mistral-7B-v0.1: Llama architecture + 4096-token sliding
        window (HF mistralai/Mistral-7B-v0.1 config.json; the weight
        names are Llama's)."""
        return cls(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=10000.0,
            max_position_embeddings=32768, bos_token_id=1,
            eos_token_ids=(2,), sliding_window=4096,
            chat_template="mistral",
        )

    @classmethod
    def qwen2_7b(cls) -> "LlamaConfig":
        """Qwen2-7B-Instruct: Llama architecture + QKV bias + ChatML
        (HF Qwen/Qwen2-7B-Instruct config.json)."""
        return cls(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_hidden_layers=28, num_attention_heads=28,
            num_key_value_heads=4, rms_norm_eps=1e-6, rope_theta=1e6,
            max_position_embeddings=32768, bos_token_id=151643,
            eos_token_ids=(151645, 151643), attention_bias=True,
            chat_template="chatml",
        )

    @classmethod
    def llama3_70b(cls) -> "LlamaConfig":
        return cls(
            vocab_size=128256, hidden_size=8192, intermediate_size=28672,
            num_hidden_layers=80, num_attention_heads=64,
            num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=500000.0,
            max_position_embeddings=8192,
        )
