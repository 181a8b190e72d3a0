"""Context: process-wide state built once from Args.

Counterpart of `cake_tpu/context.py` (`_resolve_flash`,
`Context.from_args`, `load_text_model`, `_maybe_quantize`,
`load_image_model`), for one device: the dtype, the device
(`cuda:<device_idx>`, or the CPU with `--cpu`), the model config and the
text generator (`--batch-size` rows, or with `--draft-model` the batch-1
SpeculativeGenerator, `_load_speculative`), its weights quantized with
`--quant int8|int4`; or, with `--model-type image`, the Stable
Diffusion generator of the SDArgs. Topologies, sequence parallelism
(`--sp`) and the image mesh (`--dp`) are not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass
from typing import Optional

import torch

from cake_tpu_torch.args import Args, SDArgs
from cake_tpu_torch.kv.quantized_pool import QUANTIZED_CACHES
from cake_tpu_torch.models.llama.config import LlamaConfig, load_config
from cake_tpu_torch.utils.devices import (
    resolve_device, resolve_dtype, resolve_kv_dtype,
)

log = logging.getLogger(__name__)


def _resolve_flash(args: Args, device: torch.device) -> bool:
    """--flash-attention / --no-flash-attention; default on iff the
    device is CUDA (on the CPU the wrappers would run their plain
    versions, which the einsum path already is)."""
    if args.flash_attention is not None:
        return args.flash_attention
    return device.type == "cuda"


def draft_config(args: Args, device: torch.device,
                 d_dir: Optional[str]) -> LlamaConfig:
    """A draft model's config: `<d_dir>/config.json`, or the tiny config
    without one; flash as the target's."""
    if d_dir and os.path.exists(os.path.join(d_dir, "config.json")):
        d_cfg = load_config(d_dir)
    else:
        d_cfg = LlamaConfig.tiny()
    return dataclasses.replace(
        d_cfg, use_flash_attention=_resolve_flash(args, device))


@dataclass
class Context:
    args: Args
    dtype: torch.dtype
    device: torch.device
    llama_config: Optional[LlamaConfig] = None
    sd_args: Optional[SDArgs] = None

    @classmethod
    def from_args(cls, args: Args,
                  sd_args: Optional[SDArgs] = None) -> "Context":
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
                   llama_config=llama_config, sd_args=sd_args)

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
        # --repeat-penalty unset: the reference default 1.1, except under
        # --draft-model, where it is 1.0 (the parallel verify replays no
        # penalty ring); an explicit value is honoured. Under
        # --spec-draft it stays 1.1, as in JAX: the engine then serves a
        # request that does not ask for 1.0 on the plain path
        penalty = a.repeat_penalty
        if penalty is None:
            penalty = 1.0 if a.draft_model is not None else 1.1
        sampling = SamplingConfig(
            temperature=a.temperature, top_k=a.top_k, top_p=a.top_p,
            repeat_penalty=penalty, repeat_last_n=a.repeat_last_n)
        if a.kv_dtype in QUANTIZED_CACHES:
            # int8/int4 KV is the paged engine's quantized pool
            # (master.make_engine passes --kv-dtype through): the
            # generator's dense cache keeps the compute dtype, having no
            # per-page scales. The JAX context does this for int8 only.
            kv_dtype = self.dtype
        else:
            kv_dtype = (resolve_kv_dtype(a.kv_dtype) if a.kv_dtype
                        else self.dtype)
        max_seq = min(a.max_seq_len, cfg.max_position_embeddings)
        if a.draft_model is not None:
            if a.batch_size != 1:
                raise ValueError(
                    "--draft-model (speculative decoding) is batch-1 "
                    "single-device")
            if a.prefill_chunk is not None:
                raise ValueError(
                    "--prefill-chunk is not supported with --draft-model "
                    "(speculative prefill is whole-prompt)")
            return self._load_speculative(cfg, params, tokenizer, sampling,
                                          max_seq, kv_dtype)
        return LlamaGenerator(
            cfg, params, tokenizer,
            max_seq_len=max_seq,
            batch_size=a.batch_size,
            sampling=sampling, seed=a.seed, cache_dtype=kv_dtype,
            prefill_chunk=a.prefill_chunk, device=self.device)

    def load_image_model(self):
        """The Stable Diffusion generator of the SDArgs (models/sd/sd.py)
        on the context's device."""
        from cake_tpu_torch.models.sd.sd import SDGenerator
        return SDGenerator.load(self)

    def _load_speculative(self, cfg, params, tokenizer, sampling, max_seq,
                          kv_dtype):
        """The batch-1 SpeculativeGenerator over the --draft-model draft
        (quantized with --quant as the target)."""
        from cake_tpu_torch.models import load_text_params
        from cake_tpu_torch.models.llama.speculative import (
            SpeculativeGenerator,
        )

        a = self.args
        d_dir = a.draft_model
        d_cfg = draft_config(a, self.device, d_dir)
        if d_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab {d_cfg.vocab_size} != target vocab "
                f"{cfg.vocab_size}: speculation verifies draft token ids "
                "directly, so the models must share a tokenizer")
        d_params = self._maybe_quantize(
            load_text_params(d_cfg, d_dir, self.dtype, self.device))
        log.info("speculative generation: gamma=%d draft=%s", a.spec_gamma,
                 d_dir or "<random tiny>")
        return SpeculativeGenerator(
            cfg, params, d_cfg, d_params, tokenizer,
            gamma=a.spec_gamma, max_seq_len=max_seq, sampling=sampling,
            seed=a.seed, cache_dtype=kv_dtype, spec_rounds=a.spec_rounds,
            device=self.device)
