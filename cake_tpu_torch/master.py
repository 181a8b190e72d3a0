"""Master: drives the text generator and builds the serving engine.

Counterpart of `cake_tpu/master.py` (`from_args`, `make_engine`,
`generate_text`, `run`, `reset`, `add_message`), text only.
`generate_text` streams each token through a callback and times the
tokens after the first, so the prefill does not skew tokens/s;
`make_engine` builds the paged continuous-batching engine over the
generator's config, params and tokenizer for the REST server.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

from cake_tpu_torch.args import Args
from cake_tpu_torch.models import Token
from cake_tpu_torch.models.chat import Message

log = logging.getLogger(__name__)


class Master:
    """Drives a text generator (`models/llama/generator.LlamaGenerator`)."""

    def __init__(self, args: Args, text_generator=None):
        self.args = args
        self.llm = text_generator
        self.tokens_per_s: float = 0.0

    @classmethod
    def from_args(cls, args: Args) -> "Master":
        from cake_tpu_torch.context import Context
        return cls(args, text_generator=Context.from_args(args)
                   .load_text_model())

    def make_engine(self, max_slots: Optional[int] = None,
                    **engine_kwargs):
        """Build the paged continuous-batching engine over the loaded
        generator's params (no weight copy; the engine allocates its own
        KV pool) on the generator's device. engine_kwargs pass through
        to InferenceEngine."""
        if self.llm is None:
            raise RuntimeError("no text generator loaded")
        from cake_tpu_torch.serve.engine import InferenceEngine
        a = self.args
        g = self.llm
        kw = dict(
            device=g.device,
            max_slots=max_slots or a.max_slots,
            max_seq_len=g.max_seq_len,
            sampling=g.sampling,
            seed=a.seed,
            # the generator's cache dtype (a float --kv-dtype); an
            # int8/int4 --kv-dtype quantizes the engine's pool instead
            cache_dtype=g.cache.k.dtype,
            kv_dtype=a.kv_dtype,
            prefill_chunk=a.prefill_chunk,
            kv_pages=a.kv_pages,
            kv_page_size=a.kv_page_size,
            paged_attn=a.paged_attn,
            mixed_batch=a.mixed_batch,
            decode_scan_steps=a.decode_scan,
            auto_prefix_system=a.auto_prefix,
            # the observability planes and the SLO scheduler
            trace_events=a.trace_events,
            trace_ring=a.trace_ring,
            step_log=a.step_log,
            step_ring=a.step_ring,
            event_log=a.event_log,
            event_ring=a.event_ring,
            slo_targets=a.slo_targets,
            priority_classes=a.priority_classes,
            preemption=a.preemption,
            shed=a.shed,
        )
        kw.update(engine_kwargs)
        return InferenceEngine(g.config, g.params, g.tokenizer, **kw)

    # -- text ----------------------------------------------------------------

    def reset(self) -> None:
        if self.llm is not None:
            self.llm.reset()

    def add_message(self, message: Message) -> None:
        self.llm.add_message(message)

    def generate_text(self, stream: Callable[[Token], None],
                      sample_len: Optional[int] = None) -> str:
        """Generate up to sample_len tokens, streaming each through
        `stream`. tokens_per_s counts from the first token on, so the
        prefill is not in it."""
        sample_len = sample_len or self.args.sample_len
        pieces = []
        start = time.perf_counter()
        generated = 0
        for index in range(sample_len):
            token = self.llm.next_token(index)
            if index == 0:
                start = time.perf_counter()
            else:
                generated += 1
            if token.is_end_of_stream:
                if token.text:
                    # EOS carries the flushed UTF-8 tail
                    pieces.append(token.text)
                    stream(token)
                break
            pieces.append(token.text)
            stream(token)
        dt = time.perf_counter() - start
        self.tokens_per_s = generated / dt if dt > 0 else 0.0
        log.info("%d tokens generated (%.2f token/s)",
                 generated + 1, self.tokens_per_s)
        return "".join(pieces)

    def run(self) -> None:
        """One-shot generation of the command line: the system prompt and
        the prompt, streamed to stdout."""
        self.add_message(Message.system(self.args.system_prompt))
        self.add_message(Message.user(self.args.prompt))
        print(f"[{self.args.system_prompt}] {self.args.prompt}\n")
        self.generate_text(lambda t: print(t.text, end="", flush=True))
        print()
