"""LlamaGenerator: stateful text generation over the dense model, and
the tokenization helpers the serving engine shares.

Counterpart of `cake_tpu/models/llama/generator.py`: the first
`next_token` renders the chat history and prefills it (whole prompt,
right-padded to a bucket length; or fixed windows with
`prefill_chunk`), every later one feeds the last token at its absolute
position; repeat penalty over a ring of recent tokens, EOS detection
over the config's whole eos set, and `reset()` zeroing the whole cache
in place.

The decode step is JAX's jitted `decode_step` as a CUDA graph
(serve/graphs.GeneratorRunner): the dense forward reads its position
from a device buffer, and the sample draws from the engine's
counter-based streams (`ops/sampling.masked_sample`, one seed a row
from `seed`), where JAX splits a threefry key; greedy rows are JAX's
tokens. `generate_on_device`, one `lax.scan` in JAX, is one eager
prefill and num_tokens - 1 replays of the captured step over a scratch
cache, with one fetch at the end. The prefills stay eager.

`forward_fn=`, `cache=` and `parallel=` are JAX's hooks for a
topology-sharded model (parallel/pipeline.make_pipeline_forward over a
ShardedKVCache, the (plan, mesh) pair kept for `Master.make_engine`):
every prompt then prefills whole through forward_fn (flash on the
card, per stage and tp rank), the decode step captured over it, and
`generate_on_device` is JAX's host loop, one eager pipelined prefill
and a replay of the captured pipelined step a token over a scratch
copy of the sharded cache. A forward may bound the session
(parallel/context_parallel.SPGeneratorForward, `--sp`): `max_prompt_len`
caps the prompt, `max_decode_tokens` the generated tokens, and a forward
with a `new_cache` gives the session its cache (once: the captured step
holds it, and `reset` zeroes it in place).
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
    RopeTables, forward, prefill, prefill_chunk,
)
from cake_tpu_torch.models.llama.tokenizer import BpeTokenizer
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve.graphs import GeneratorRunner
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
    """`<model_dir>/tokenizer.json` through the port's own reader
    (models/llama/tokenizer.BpeTokenizer), where JAX loads it with the
    `tokenizers` package: the same ids and text for the byte-level BPE
    files of Llama-3 and Qwen2, and an error naming the feature for a
    file of another kind."""
    return BpeTokenizer.from_file(os.path.join(model_dir, "tokenizer.json"))


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
        forward_fn=None,
        cache=None,
        parallel=None,
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
        # forward_fn(params, tokens, cache, pos, rope, last_idx=None,
        # is_prefill=False) -> (logits, cache): the pipelined forward of
        # a sharded model, over `cache` (its placement); parallel: the
        # (plan, mesh) the engine builds its own sharded cache from
        self._forward_fn = forward_fn
        self.parallel = parallel
        if hasattr(forward_fn, "new_cache"):
            # the forward's own layout (the sp context and tail), in
            # place of the caller's placeholder
            cache = forward_fn.new_cache(batch_size, cache_dtype)
        self.cache = cache if cache is not None else KVCache.create(
            config, batch_size, max_seq_len, dtype=cache_dtype,
            device=self.device)
        self.history = History(config.chat_template)
        self.seed = seed
        self._ring: Optional[torch.Tensor] = None
        # the captured decode steps (built at first use) and the graph
        # memory they share on the card
        self._decode: Optional[GeneratorRunner] = None
        self._scan: Optional[GeneratorRunner] = None
        self._scratch: Optional[KVCache] = None
        self._scan_calls = 0
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        self._reset_session()

    # -- TextGenerator protocol ---------------------------------------------

    def add_message(self, message: Message) -> None:
        self.history.add_message(message)

    def reset(self) -> None:
        """Clear chat and decode state, the whole KV cache included
        (zeroed in place: the captured step holds its storage). The
        rows' random streams go on from where they are, as JAX's key
        does."""
        self.history.clear()
        self.cache.zero_()
        self._reset_session()

    def _reset_session(self) -> None:
        self.tokens: List[int] = []      # every generated token id
        self.index_pos = 0               # absolute position in the cache
        if self._ring is not None:
            self._ring.fill_(-1)
        self._pending_text = ""
        self._prompt_len = 0

    def _seeds(self, call: int, rows: int) -> List[int]:
        """Row b's stream seed: the session's (call 0), or that of the
        call-th `generate_on_device` (a stream of its own, so no call
        replays another's draws)."""
        base = self.seed * 1_000_003 + call * 65_537
        return [base + b for b in range(rows)]

    def _decode_runner(self) -> GeneratorRunner:
        """The session's captured step over the session's cache (a new
        one, carrying the session on, when set_sampling changed the
        ring's width), its options those of `self.sampling`."""
        n = self.sampling.repeat_last_n
        r = self._decode
        if r is None or self._ring.shape[1] != n:
            self._ring = torch.full((self.batch_size, n), -1,
                                    dtype=torch.int64, device=self.device)
            r = self._decode = GeneratorRunner(
                self.params, self.cache, self.rope, self.config,
                self._ring, cols=self.max_seq_len, pool=self._graph_pool,
                forward_fn=self._forward_fn)
            r.begin(self.index_pos, len(self.tokens),
                    tok=self.tokens[-1] if self.tokens else None,
                    seeds=self._seeds(0, self.batch_size))
        if r.options is not self.sampling:
            r.set_options(self.sampling)
        return r

    def set_sampling(self, **overrides) -> None:
        """Apply per-request sampling overrides (None values ignored)."""
        kw = {k: v for k, v in overrides.items() if v is not None}
        if kw:
            self.sampling = replace(self.sampling, **kw)

    def next_token(self, index: int) -> Token:
        """Generate one token; index == 0 prefills the prompt (eagerly)
        and samples its logits, a later index replays the captured step
        from the last token at `index_pos`."""
        limit = getattr(self._forward_fn, "max_decode_tokens", None)
        if limit is not None and index >= limit:
            # the sp forward's decode tail is full: a write past it would
            # clamp over live entries
            raise ValueError(
                f"decode budget exhausted: this serving mode holds at most "
                f"{limit} generated tokens per session")
        runner = self._decode_runner()
        top_k = self.sampling.top_k
        if index == 0:
            logits = self._prefill_prompt()
            runner.begin(self.index_pos, len(self.tokens))
            runner.sample(logits, top_k)
        else:
            if self.index_pos >= self.max_seq_len:
                raise ValueError(
                    f"the KV cache is full: {self.max_seq_len} positions "
                    "(raise max_seq_len or generate fewer tokens)")
            runner.replay(top_k)
            self.index_pos += 1
        tid = int(runner.tok[0])
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
        # a forward's own (inclusive) bound, the sp context window; the
        # dense decode needs one free slot past the prompt
        limit = getattr(self._forward_fn, "max_prompt_len", None)
        if limit is None:
            limit = self.max_seq_len - 1
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
        if self._forward_fn is not None:
            # the pipelined forward prefills the whole bucket, as JAX's
            # (its --prefill-chunk windows are the unsharded path's)
            bucket = bucket_length(len(ids), self.max_seq_len)
            plen = torch.full((self.batch_size,), len(ids),
                              dtype=torch.int32, device=self.device)
            with torch.inference_mode():
                logits, self.cache = self._forward_fn(
                    self.params, self._tokens(ids + [0] * (bucket - len(ids))),
                    self.cache, 0, self.rope, last_idx=plen - 1,
                    is_prefill=True)
        elif C and len(ids) > C:
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

    def _scan_runner(self, B: int) -> GeneratorRunner:
        """The captured step over the scratch cache of B rows, allocated
        once (again only when B or repeat_last_n changes, the old one
        dropped first) and zeroed in place for each call."""
        n = self.sampling.repeat_last_n
        r = self._scan
        if r is None or r.B != B or r.ring.shape[1] != n:
            self._scan = self._scratch = r = None
            if self._forward_fn is not None:
                # a scratch copy of the session's sharded placement
                if B != self.batch_size:
                    raise ValueError(
                        f"a sharded generator's batch is its cache's: "
                        f"{B} prompts for --batch-size {self.batch_size}")
                self._scratch = self.cache.fresh()
            else:
                self._scratch = KVCache.create(
                    self.config, B, self.max_seq_len,
                    dtype=self.cache.k.dtype, device=self.device)
            ring = torch.full((B, n), -1, dtype=torch.int64,
                              device=self.device)
            r = self._scan = GeneratorRunner(
                self.params, self._scratch, self.rope, self.config, ring,
                cols=self.max_seq_len, pool=self._graph_pool,
                forward_fn=self._forward_fn)
        else:
            self._scratch.zero_()
            r.ring.fill_(-1)
        return r

    def generate_on_device(self, prompt_ids: np.ndarray,
                           prompt_len: np.ndarray,
                           num_tokens: int) -> np.ndarray:
        """Generate num_tokens for a [B, S] batch of right-padded prompts
        and return [B, num_tokens] int32, EOS not cut (see trim_at_eos).

        JAX's one scan, as one eager prefill forward at position 0 (the
        masked einsum, as in the scan) and its sample, then num_tokens - 1
        replays of the captured decode step, each keeping token,
        position and ring on the card and writing its token into column
        `step` of a [B, max_seq_len] buffer: no host round trip between
        steps, one fetch at the end. Runs on a scratch cache kept by the
        generator (B x one session cache's bytes): the session's cache
        and state are untouched. prompt_len must be uniform, as decode
        positions are shared."""
        plen_arr = np.asarray(prompt_len, dtype=np.int32)
        if not (plen_arr == plen_arr[0]).all():
            raise ValueError(
                "generate_on_device requires uniform prompt_len; "
                f"got {plen_arr.tolist()}")
        if not 1 <= num_tokens <= self.max_seq_len:
            raise ValueError(
                f"num_tokens {num_tokens} must be in [1, max_seq_len "
                f"{self.max_seq_len}]")
        fwd = self._forward_fn
        plimit = getattr(fwd, "max_prompt_len", None)
        if plimit is not None and int(plen_arr[0]) > plimit:
            # the sp context window: a longer prompt would be cut
            raise ValueError(
                f"prompt length {int(plen_arr[0])} exceeds this serving "
                f"mode's prompt limit {plimit}")
        limit = getattr(fwd, "max_decode_tokens", None)
        if limit is not None and num_tokens > limit:
            raise ValueError(
                f"num_tokens {num_tokens} exceeds this serving mode's "
                f"decode budget of {limit} tokens per session")
        toks = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.int32,
                               device=self.device)
        plen = torch.as_tensor(plen_arr, device=self.device)
        B = toks.shape[0]
        top_k = self.sampling.top_k
        self._scan_calls += 1
        with torch.inference_mode():
            r = self._scan_runner(B)
            if self._forward_fn is not None:
                # JAX's host loop over the pipelined forward
                logits, _ = self._forward_fn(
                    self.params, toks, self._scratch, 0, self.rope,
                    last_idx=plen - 1, is_prefill=True)
            else:
                logits, _ = forward(self.params, toks, self._scratch, 0,
                                    self.rope, self.config,
                                    last_idx=plen - 1)
            if r.options is not self.sampling:
                r.set_options(self.sampling)
            r.begin(int(plen_arr.max()), 0,
                    seeds=self._seeds(self._scan_calls, B))
            r.sample(logits, top_k)
            for _ in range(1, num_tokens):
                r.replay(top_k)
            out = r.out[:, :num_tokens].to(torch.int32)
        return out.cpu().numpy()


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
