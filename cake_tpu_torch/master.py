"""Master: holds the loaded text model and builds the serving engine.

Counterpart of `cake_tpu/master.py` (`Master`, `make_engine`), text
serving only. The JAX Master drives a `LlamaGenerator`; the port has no
sequential generator yet, so the Master holds a `TextModel` (config,
params, tokenizer) and serves through the paged engine. Loading real
weights: `load_config`, `load_params_from_hf` and `load_tokenizer`
(models/llama/) build the TextModel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from cake_tpu_torch.args import Args
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.utils.devices import resolve_device, resolve_dtype


class TextModel(NamedTuple):
    config: LlamaConfig
    params: dict
    tokenizer: object


class Master:
    """Drives the text model: `make_engine` builds the continuous-batching
    engine the REST server serves through."""

    def __init__(self, args: Args, text_model: Optional[TextModel] = None,
                 device="cuda"):
        self.args = args
        self.device = resolve_device(device)
        self.llm = text_model

    def sampling(self) -> SamplingConfig:
        a = self.args
        return SamplingConfig(
            temperature=a.temperature, top_k=a.top_k, top_p=a.top_p,
            repeat_penalty=(1.1 if a.repeat_penalty is None
                            else a.repeat_penalty),
            repeat_last_n=a.repeat_last_n)

    def make_engine(self, max_slots: Optional[int] = None,
                    **engine_kwargs):
        """Build the paged continuous-batching engine over the loaded
        model's params (no weight copy; the engine allocates its own KV
        pool). engine_kwargs pass through to InferenceEngine."""
        if self.llm is None:
            raise RuntimeError("no text model loaded")
        from cake_tpu_torch.serve.engine import InferenceEngine
        a = self.args
        g = self.llm
        kw = dict(
            device=self.device,
            max_slots=max_slots or a.max_slots,
            max_seq_len=min(a.max_seq_len,
                            g.config.max_position_embeddings),
            sampling=self.sampling(),
            seed=a.seed,
            cache_dtype=resolve_dtype(a.kv_dtype or a.dtype),
            prefill_chunk=a.prefill_chunk,
            kv_pages=a.kv_pages,
            kv_page_size=a.kv_page_size,
            paged_attn=a.paged_attn,
            mixed_batch=a.mixed_batch,
        )
        kw.update(engine_kwargs)
        return InferenceEngine(g.config, g.params, g.tokenizer, **kw)
