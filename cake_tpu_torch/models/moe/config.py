"""MoE model hyperparameters (HF Mixtral `config.json` layout).

Counterpart of `cake_tpu/models/moe/config.py`: a LlamaConfig with the
expert count and the experts a token routes to. Everything but the FFN
is the Llama-3 architecture (GQA attention, RoPE, RMSNorm), as in
Mixtral; `model_type: "mixtral"` in config.json selects this family
(models/llama/config.load_config_dict).
"""

from __future__ import annotations

from dataclasses import dataclass

from cake_tpu_torch.models.llama.config import LlamaConfig


@dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2

    @classmethod
    def from_hf_dict(cls, raw: dict) -> "MoEConfig":
        base = LlamaConfig.from_hf_dict(raw)
        return cls(
            **{f: getattr(base, f) for f in base.__dataclass_fields__},
            num_local_experts=raw.get("num_local_experts", 8),
            num_experts_per_tok=raw.get("num_experts_per_tok", 2),
        )

    @classmethod
    def tiny(cls, **overrides) -> "MoEConfig":
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0,
            max_position_embeddings=256, bos_token_id=1,
            eos_token_ids=(2,), tie_word_embeddings=False,
            num_local_experts=4, num_experts_per_tok=2,
        )
        base.update(overrides)
        return cls(**base)

    @classmethod
    def mixtral_8x7b(cls) -> "MoEConfig":
        return cls(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=1e6,
            max_position_embeddings=32768, bos_token_id=1,
            eos_token_ids=(2,), num_local_experts=8, num_experts_per_tok=2,
            chat_template="mistral",
        )
