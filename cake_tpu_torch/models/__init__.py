"""Model-level types and loading.

Counterpart of `cake_tpu/models/__init__.py`: the generated `Token` and
`load_text_params`, which picks HF safetensors or a random init.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Token:
    """One generated token."""

    id: int
    text: str
    is_end_of_stream: bool = False


def load_text_params(config, model_dir: Optional[str], dtype, device):
    """The dense Llama parameter dict: HF safetensors when model_dir holds
    them, else a random init from seed 0 (with a warning). Mixture-of-
    experts configs are not ported and raise."""
    from cake_tpu_torch.models.llama.params import (
        init_params, load_params_from_hf,
    )
    from cake_tpu_torch.utils.devices import resolve_device
    from cake_tpu_torch.utils.loading import has_weights

    if getattr(config, "num_local_experts", 0):
        raise NotImplementedError(
            "mixture-of-experts models are not ported to cake_tpu_torch "
            "yet (ROADMAP A14)")
    dev = resolve_device(device)
    if has_weights(model_dir):
        return load_params_from_hf(model_dir, config, dtype=dtype,
                                   device=dev)
    logging.getLogger(__name__).warning(
        "no weights at %r; using random init", model_dir)
    gen = torch.Generator(device=dev).manual_seed(0)
    return init_params(config, gen, device=dev, dtype=dtype)
