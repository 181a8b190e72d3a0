"""LlamaGenerator: stateful text generation over the dense model, and
the tokenization helpers the serving engine shares.

Counterpart of `cake_tpu/models/llama/generator.py`: the first
`next_token` renders the chat history and prefills it (whole prompt,
right-padded to a bucket length; or fixed windows with
`prefill_chunk`), every later one feeds the last token at its absolute
position; repeat penalty over a ring of recent tokens, sampling with a
`torch.Generator` seeded from `seed`, EOS detection over the config's
whole eos set, and `reset()` zeroing the whole cache. JAX's on-device
`generate_scan` is a host loop here. The `forward_fn`/`parallel` hooks
(pipeline and sequence-parallel forwards) are not ported.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from cake_tpu_torch.models import Token
from cake_tpu_torch.models.chat import History, Message
from cake_tpu_torch.models.llama.cache import KVCache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.model import (
    RopeTables, decode_step, forward, prefill, prefill_chunk,
)
from cake_tpu_torch.ops.sampling import (
    SamplingConfig, sample_tokens, update_ring,
)
from cake_tpu_torch.utils.devices import resolve_device

PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def bucket_length(n: int, max_seq_len: int) -> int:
    """Smallest bucket >= n (bounds the set of prefill shapes)."""
    for b in PREFILL_BUCKETS:
        if b >= n and b <= max_seq_len:
            return b
    return max_seq_len


def chunk_windows(ids: List[int], C: int):
    """Yield (padded_window, n_real, start) fixed-C windows over a prompt:
    the right-padded final window's last real token sits at n_real - 1."""
    for start in range(0, len(ids), C):
        w = ids[start:start + C]
        n = len(w)
        yield w + [0] * (C - n), n, start


class ByteTokenizer:
    """Fallback tokenizer (tests / no tokenizer.json): UTF-8 bytes + offset."""

    OFFSET = 3  # leave room for pad/bos/eos

    def __init__(self, vocab_size: int = 259):
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        return [b + self.OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: List[int]) -> str:
        data = bytes(max(0, i - self.OFFSET) for i in ids
                     if i >= self.OFFSET and i - self.OFFSET < 256)
        return data.decode("utf-8", errors="replace")


def load_tokenizer(model_dir: str):
    """HF tokenizer.json loader (imports `tokenizers` on first use)."""
    from tokenizers import Tokenizer
    return Tokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))


def encode_text(tokenizer, text: str) -> List[int]:
    """Tokenize, normalising HF `Encoding.ids` vs plain-list tokenizers."""
    enc = tokenizer.encode(text)
    return list(enc.ids if hasattr(enc, "ids") else enc)


def incremental_decode(tokenizer, ids: List[int],
                       pending: str, final: bool = False) -> Tuple[str, str]:
    """Streaming detokenization step: (new_text, updated_pending).

    Text is held back (empty delta) while the tail decodes to an
    incomplete UTF-8 sequence (the replacement char), so multi-token
    characters stream whole; final=True flushes such a tail."""
    full = tokenizer.decode(ids)
    new = full[len(pending):]
    if new.endswith("�") and not final:
        return "", pending
    return new, full


class LlamaGenerator:
    """TextGenerator over the dense model: add_message / next_token /
    reset, as the reference's Llama driver."""

    def __init__(
        self,
        config: LlamaConfig,
        params,
        tokenizer,
        *,
        max_seq_len: int = 4096,
        batch_size: int = 1,
        sampling: Optional[SamplingConfig] = None,
        seed: int = 299792458,
        cache_dtype=torch.bfloat16,
        prefill_chunk: Optional[int] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params live on {params['embed'].device}, the generator "
                f"on {self.device}")
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.batch_size = batch_size
        self.sampling = sampling or SamplingConfig()
        self.rope = RopeTables.create(config, max_seq_len, device=self.device)
        if prefill_chunk is not None and (
                prefill_chunk < 1 or max_seq_len % prefill_chunk != 0):
            # a padded final window [start, start + C) must stay inside
            # the cache: the write would clamp back over live entries
            raise ValueError(
                f"prefill_chunk {prefill_chunk} must be >= 1 and divide "
                f"max_seq_len {max_seq_len}")
        self.prefill_chunk = prefill_chunk
        self.cache = KVCache.create(config, batch_size, max_seq_len,
                                    dtype=cache_dtype, device=self.device)
        self.history = History(config.chat_template)
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        self._reset_session()

    # -- TextGenerator protocol ---------------------------------------------

    def add_message(self, message: Message) -> None:
        self.history.add_message(message)

    def reset(self) -> None:
        """Clear chat and decode state, the whole KV cache included."""
        self.history.clear()
        self.cache = self.cache.fresh()
        self._reset_session()

    def _reset_session(self) -> None:
        self.tokens: List[int] = []      # every generated token id
        self.index_pos = 0               # absolute position in the cache
        self._ring = torch.full((self.batch_size,
                                 self.sampling.repeat_last_n), -1,
                                dtype=torch.int32, device=self.device)
        self._pending_text = ""
        self._prompt_len = 0

    def set_sampling(self, **overrides) -> None:
        """Apply per-request sampling overrides (None values ignored)."""
        kw = {k: v for k, v in overrides.items() if v is not None}
        if kw:
            self.sampling = replace(self.sampling, **kw)

    def next_token(self, index: int) -> Token:
        """Generate one token; index == 0 prefills the prompt."""
        if index == 0:
            logits = self._prefill_prompt()
        else:
            if self.index_pos >= self.max_seq_len:
                raise ValueError(
                    f"the KV cache is full: {self.max_seq_len} positions "
                    "(raise max_seq_len or generate fewer tokens)")
            tok = torch.full((self.batch_size, 1), self.tokens[-1],
                             dtype=torch.int32, device=self.device)
            logits, self.cache = decode_step(
                self.params, tok, self.index_pos, self.cache, self.rope,
                self.config)
            self.index_pos += 1

        next_id = sample_tokens(self.rng, logits, self._ring, self.sampling)
        self._ring = update_ring(self._ring, next_id, len(self.tokens))
        tid = int(next_id[0])
        self.tokens.append(tid)

        if tid in self.config.eos_token_ids:
            # flush a held-back UTF-8 tail, so the streamed total equals
            # the buffered decode of the same ids
            tail, self._pending_text = incremental_decode(
                self.tokenizer, self.tokens[:-1], self._pending_text,
                final=True)
            return Token(id=tid, text=tail, is_end_of_stream=True)
        return Token(id=tid, text=self._decode_incremental(),
                     is_end_of_stream=False)

    # -- internals -----------------------------------------------------------

    def _encode_prompt(self) -> List[int]:
        ids = encode_text(self.tokenizer, self.history.render())
        limit = self.max_seq_len - 1     # decode needs one free slot
        if len(ids) > limit:
            raise ValueError(
                f"prompt length {len(ids)} exceeds limit {limit} "
                f"(max_seq_len {self.max_seq_len})")
        return ids

    def _tokens(self, ids: List[int]) -> torch.Tensor:
        return torch.tensor([ids] * self.batch_size, dtype=torch.int32,
                            device=self.device)

    def _prefill_prompt(self):
        ids = self._encode_prompt()
        self._prompt_len = len(ids)
        C = self.prefill_chunk
        if C and len(ids) > C:
            logits = self._prefill_chunked(ids, C)
        else:
            bucket = bucket_length(len(ids), self.max_seq_len)
            plen = torch.full((self.batch_size,), len(ids),
                              dtype=torch.int32, device=self.device)
            logits, self.cache = prefill(
                self.params, self._tokens(ids + [0] * (bucket - len(ids))),
                plen, self.cache, self.rope, self.config)
        self.index_pos = len(ids)
        return logits

    def _prefill_chunked(self, ids: List[int], C: int):
        """Walk the prompt in fixed windows of C tokens, each attending
        the growing cache (the cache-aware flash kernel on the card)."""
        logits = None
        for window, n_real, start in chunk_windows(ids, C):
            last_idx = torch.full((self.batch_size,), n_real - 1,
                                  dtype=torch.int32, device=self.device)
            logits, self.cache = prefill_chunk(
                self.params, self._tokens(window), start, last_idx,
                self.cache, self.rope, self.config)
        return logits

    def _decode_incremental(self) -> str:
        """Newly finalized text for the freshly appended token."""
        new, self._pending_text = incremental_decode(
            self.tokenizer, self.tokens, self._pending_text)
        return new

    # -- batch generation ------------------------------------------------------

    def generate_on_device(self, prompt_ids: np.ndarray,
                           prompt_len: np.ndarray,
                           num_tokens: int) -> np.ndarray:
        """Generate num_tokens for a [B, S] batch of right-padded prompts
        and return [B, num_tokens] int32, EOS not cut (see trim_at_eos).

        JAX runs this loop as one on-device scan; here it is a host loop
        over the same steps: a prefill forward at position 0 (the masked
        einsum, as in the scan), then one decode forward per token. Runs
        on a scratch cache: the session's cache and state are untouched.
        prompt_len must be uniform, as decode positions are shared."""
        plen_arr = np.asarray(prompt_len, dtype=np.int32)
        if not (plen_arr == plen_arr[0]).all():
            raise ValueError(
                "generate_on_device requires uniform prompt_len; "
                f"got {plen_arr.tolist()}")
        toks = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int32,
                               device=self.device)
        plen = torch.as_tensor(plen_arr, device=self.device)
        cache = self.cache.fresh()
        p, rope, cfg, smp = self.params, self.rope, self.config, self.sampling
        with torch.inference_mode():
            logits, cache = forward(p, toks, cache, 0, rope, cfg,
                                    last_idx=plen - 1)
            ring = torch.full((toks.shape[0], smp.repeat_last_n), -1,
                              dtype=torch.int32, device=self.device)
            tok = sample_tokens(self.rng, logits, ring, smp)
            ring = update_ring(ring, tok, 0)
            outs = [tok]
            pos = int(plen_arr.max())
            for step in range(1, num_tokens):
                logits, cache = forward(p, tok[:, None], cache, pos, rope,
                                        cfg)
                pos += 1
                tok = sample_tokens(self.rng, logits, ring, smp)
                ring = update_ring(ring, tok, step)
                outs.append(tok)
        return torch.stack(outs, dim=1).to(torch.int32).cpu().numpy()


def trim_at_eos(ids: np.ndarray, eos_ids: Tuple[int, ...]) -> List[List[int]]:
    """Cut each row at its first EOS token."""
    out = []
    for row in ids:
        cut = len(row)
        for j, t in enumerate(row):
            if int(t) in eos_ids:
                cut = j
                break
        out.append([int(t) for t in row[:cut]])
    return out
