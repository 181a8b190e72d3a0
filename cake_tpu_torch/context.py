"""Context: process-wide state built once from Args.

Counterpart of `cake_tpu/context.py` (`_resolve_flash`,
`Context.from_args`, `load_text_model`, `_maybe_quantize`), for one
device: the dtype, the device (`cuda:<device_idx>`, or the CPU with
`--cpu`), the model config and the text generator, its weights
quantized with `--quant int8|int4`. Topologies, sequence parallelism
(`--sp`) and speculation are not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass
from typing import Optional

import torch

from cake_tpu_torch.args import Args
from cake_tpu_torch.kv.quantized_pool import QUANTIZED_CACHES
from cake_tpu_torch.models.llama.config import LlamaConfig, load_config
from cake_tpu_torch.utils.devices import resolve_device, resolve_dtype

log = logging.getLogger(__name__)


def _resolve_flash(args: Args, device: torch.device) -> bool:
    """--flash-attention / --no-flash-attention; default on iff the
    device is CUDA (on the CPU the wrappers would run their plain
    versions, which the einsum path already is)."""
    if args.flash_attention is not None:
        return args.flash_attention
    return device.type == "cuda"


@dataclass
class Context:
    args: Args
    dtype: torch.dtype
    device: torch.device
    llama_config: Optional[LlamaConfig] = None

    @classmethod
    def from_args(cls, args: Args) -> "Context":
        """Resolve dtype and device (a CUDA device without a card raises)
        and read `<model>/config.json` when there is one."""
        dtype = resolve_dtype(args.dtype)
        device = resolve_device(
            "cpu" if args.cpu else f"cuda:{args.device_idx}")
        llama_config = None
        if args.model and os.path.exists(
                os.path.join(args.model, "config.json")):
            llama_config = dataclasses.replace(
                load_config(args.model),
                use_flash_attention=_resolve_flash(args, device))
        log.info("context: device=%s dtype=%s", device, args.dtype)
        return cls(args=args, dtype=dtype, device=device,
                   llama_config=llama_config)

    def _maybe_quantize(self, params):
        """Apply --quant to a parameter dict without holding two trees:
        both settings quantize leaf by leaf, dropping each full-precision
        leaf as its quantized copy lands (eager PyTorch has no donation;
        the JAX context donates the int8 tree and goes leaf by leaf for
        int4, to the same bytes and scales)."""
        a = self.args
        if a.quant not in ("int8", "int4"):
            return params
        from cake_tpu_torch.ops.quant import quantize_params_leafwise

        params = quantize_params_leafwise(
            params, bits=8 if a.quant == "int8" else 4)
        log.info("weights quantized to %s (weight-only, %s)", a.quant,
                 "per-channel" if a.quant == "int8" else "group-wise")
        return params

    def load_text_model(self):
        """Build the LlamaGenerator: the model's config, weights and
        tokenizer, or without --model the tiny config with random
        weights and the byte tokenizer."""
        from cake_tpu_torch.models import load_text_params
        from cake_tpu_torch.models.llama.generator import (
            ByteTokenizer, LlamaGenerator, load_tokenizer,
        )
        from cake_tpu_torch.ops.sampling import SamplingConfig

        a = self.args
        cfg = self.llama_config or dataclasses.replace(
            LlamaConfig.tiny(),
            use_flash_attention=_resolve_flash(a, self.device))
        if a.model and os.path.exists(os.path.join(a.model,
                                                   "tokenizer.json")):
            tokenizer = load_tokenizer(a.model)
        else:
            tokenizer = ByteTokenizer(cfg.vocab_size)
        params = self._maybe_quantize(
            load_text_params(cfg, a.model, self.dtype, self.device))
        sampling = SamplingConfig(
            temperature=a.temperature, top_k=a.top_k, top_p=a.top_p,
            repeat_penalty=(1.1 if a.repeat_penalty is None
                            else a.repeat_penalty),
            repeat_last_n=a.repeat_last_n)
        if a.kv_dtype in QUANTIZED_CACHES:
            # int8/int4 KV is the paged engine's quantized pool
            # (master.make_engine passes --kv-dtype through): the
            # generator's dense cache keeps the compute dtype, having no
            # per-page scales. The JAX context does this for int8 only.
            kv_dtype = self.dtype
        else:
            kv_dtype = (resolve_dtype(a.kv_dtype) if a.kv_dtype
                        else self.dtype)
        return LlamaGenerator(
            cfg, params, tokenizer,
            max_seq_len=min(a.max_seq_len, cfg.max_position_embeddings),
            sampling=sampling, seed=a.seed, cache_dtype=kv_dtype,
            prefill_chunk=a.prefill_chunk, device=self.device)
