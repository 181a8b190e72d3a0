"""Speculative decoding with a draft model, batch 1 (`--draft-model`).

Counterpart of `cake_tpu/models/llama/speculative.py`: a small draft
model proposes gamma tokens autoregressively, the target scores all of
them in ONE forward (logits at every position,
model.forward_logits_all), and the accept/resample rule
(spec/accept.py) keeps the leading agreeing prefix plus one correction
token, so each target pass yields 1..gamma+1 tokens. With greedy
sampling the output is the target's own greedy stream; with temperature
sampling the accept/resample rule preserves the target distribution
(Leviathan et al., 2023).

JAX jits `spec_step` (one round) and `spec_scan` (R rounds in one
`lax.scan`). The port captures ONE round as a CUDA graph per (gamma,
greedy) (serve/graphs.SpecGeneratorRunner) whose carry, the last token
and its position, stays on the device: `spec_scan`'s R rounds are R
chained replays and one fetch of [R, gamma + 1] and [R], and
`spec_step` is one replay. Sampled rounds draw from the generator's
counter-based stream (gamma + 3 draws a round), where JAX splits a
threefry key; greedy rounds give JAX's tokens. The prefills of both
models stay eager (the flash kernel on the card).

Scope (JAX's): batch 1, one device, repeat_penalty == 1.0 (the verify
pass scores gamma + 1 positions at once, so a penalty ring cannot be
replayed), temperature only (no top-k / top-p).

`spec_round_batched` is the dense spec engine's round (`--draft-model`
behind `--api`): one round for every active slot, gamma + 1 batched
ragged draft steps and one `forward_window_ragged` verify, with the
rows' counter-based streams (serve/graphs.DenseSpecRunner captures it
once per gamma).
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional

import numpy as np
import torch

from cake_tpu_torch.models import Token
from cake_tpu_torch.models.chat import History, Message
from cake_tpu_torch.models.llama.cache import KVCache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import (
    bucket_length, encode_text, incremental_decode,
)
from cake_tpu_torch.models.llama.model import (
    RopeTables, forward_ragged, forward_window_ragged, prefill,
)
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve.graphs import SpecGeneratorRunner
from cake_tpu_torch.spec.accept import (
    advance_counters, assemble_sampled, categorical, greedy_accept,
    rejection_accept, uniforms,
)
from cake_tpu_torch.utils.devices import resolve_device


@torch.inference_mode()
def spec_round_batched(t_params, d_params, t_cache: KVCache,
                       d_cache: KVCache, last_tok, pos, active, seeds,
                       counters, temp, t_rope: RopeTables,
                       d_rope: RopeTables, t_cfg: LlamaConfig,
                       d_cfg: LlamaConfig, gamma: int):
    """One propose-verify-accept round for EVERY active slot of the
    dense spec engine: gamma + 1 batched ragged draft steps over the
    draft cache (`forward_ragged`) and one batched windowed verify over
    the target cache (`forward_window_ragged`), so the weights stream
    once a round.

    last_tok [B, 1] at per-row absolute `pos` [B] (its KV unwritten in
    both caches); active [B]; seeds/counters [B] int64, the rows' random
    streams (counters advanced by gamma + 3 for active sampled rows
    only: draft step k at c + k, the uniforms at c + gamma + 1, the
    correction at c + gamma + 2, where JAX splits a threefry key);
    temp [B] (<= 0 a greedy row: argmax drafts and exact-match
    acceptance, JAX's tokens; > 0 leftover-residual rejection sampling).
    Both caches are written in place. Returns (out [B, gamma + 1] int64,
    the first n_emit[b] valid and the rest -1; n_emit [B], 0 for
    inactive rows; counters; state = (last [B, 1], pos [B]): each active
    row's last emitted token at its advanced frontier, the next round's
    (last_tok, pos) for a chained round)."""
    greedy = temp <= 0.0
    temp_eff = torch.where(greedy, torch.ones_like(temp), temp)[:, None]
    sampled = active & ~greedy
    step = active.to(pos.dtype)

    # gamma + 1 draft steps: step gamma writes the last draft's KV (an
    # all-accept round needs no patch-up pass); its proposal is unused
    tok, p = last_tok, pos
    drafts, d_probs = [], []
    for k in range(gamma + 1):
        logits, _ = forward_ragged(d_params, tok, d_cache, p, active, d_rope,
                                   d_cfg)
        if k == gamma:
            break
        probs = torch.softmax(logits / temp_eff, dim=-1)
        nxt = torch.where(greedy, logits.argmax(dim=-1),
                          categorical(seeds, counters + k, probs))
        drafts.append(nxt)
        d_probs.append(probs)
        tok, p = nxt[:, None], p + step
    drafts = torch.stack(drafts, dim=1)                  # [B, gamma]
    d_probs = torch.stack(d_probs, dim=1)                # [B, gamma, V]

    tokens_v = torch.cat([last_tok.to(drafts.dtype), drafts], dim=1)
    t_logits, _ = forward_window_ragged(t_params, tokens_v, t_cache, pos,
                                        active, t_rope, t_cfg)

    # greedy rows: exact-match acceptance against the target argmax
    targets = t_logits.argmax(dim=-1)
    n_acc_g = greedy_accept(drafts, targets)
    # sampled rows: leftover-residual rejection sampling; greedy rows'
    # residual and correction are computed and unused
    t_probs = torch.softmax(t_logits / temp_eff[..., None], dim=-1)
    u = uniforms(seeds, counters + gamma + 1, gamma)
    n_acc_s, resid = rejection_accept(drafts, d_probs, t_probs, u, gamma)
    correction = categorical(seeds, counters + gamma + 2, resid)
    out_s = assemble_sampled(drafts, correction, n_acc_s, gamma)

    n_acc = torch.where(greedy, n_acc_g, n_acc_s)
    out = torch.where(greedy[:, None], targets, out_s)
    n_emit = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
    cols = torch.arange(gamma + 1, device=out.device)
    out = torch.where(cols[None] < n_emit[:, None], out,
                      torch.full_like(out, -1))
    last = out.gather(1, torch.clamp(n_emit - 1, min=0)[:, None])[:, 0]
    last_out = torch.where(active, last, last_tok[:, 0].to(last.dtype))
    state = (last_out[:, None], pos + n_emit.to(pos.dtype))
    return out, n_emit, advance_counters(counters, sampled, gamma), state


class SpeculativeGenerator:
    """TextGenerator with draft-model speculation (batch 1): the protocol
    of LlamaGenerator plus acceptance stats; `next_token` streams from
    an internal buffer of fetched rounds."""

    MODEL_NAME = "llama3-spec"

    def __init__(self, config: LlamaConfig, params,
                 draft_config: LlamaConfig, draft_params, tokenizer, *,
                 gamma: int = 4, max_seq_len: int = 4096,
                 sampling: Optional[SamplingConfig] = None,
                 seed: int = 299792458, cache_dtype=torch.bfloat16,
                 spec_rounds: int = 4, device="cuda"):
        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        if spec_rounds < 1:
            raise ValueError("spec_rounds must be >= 1")
        sampling = sampling or SamplingConfig()
        if sampling.repeat_penalty != 1.0:
            raise ValueError(
                "speculative decoding supports repeat_penalty=1.0 only "
                "(the verify pass scores the burst in parallel)")
        if sampling.top_k is not None or (sampling.top_p or 1.0) < 1.0:
            raise ValueError(
                "speculative decoding samples from the full temperature "
                "softmax; top_k/top_p are not supported (the accept/"
                "resample identity assumes the unfiltered distributions)")
        self.device = resolve_device(device)
        for name, p in (("params", params), ("draft params", draft_params)):
            if p["embed"].device != self.device:
                raise ValueError(f"{name} live on {p['embed'].device}, the "
                                 f"generator on {self.device}")
        self.config = config
        self.params = params
        self.draft_config = draft_config
        self.draft_params = draft_params
        self.tokenizer = tokenizer
        self.gamma = gamma
        self.max_seq_len = max_seq_len
        self.sampling = sampling
        self.seed = seed
        self.cache_dtype = cache_dtype
        self.rope = RopeTables.create(config, max_seq_len, device=self.device)
        self.d_rope = RopeTables.create(draft_config, max_seq_len,
                                        device=self.device)
        self.cache = KVCache.create(config, 1, max_seq_len, dtype=cache_dtype,
                                    device=self.device)
        self.d_cache = KVCache.create(draft_config, 1, max_seq_len,
                                      dtype=cache_dtype, device=self.device)
        self.history = History(config.chat_template)
        self.spec_rounds = spec_rounds
        self.proposed = 0        # drafts offered to the verifier
        self.accepted = 0        # drafts kept
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        self._runner = self._new_runner(self.cache, self.d_cache)
        self._runner.set_stream(self._seed_of(0))
        # generate_on_device's scratch caches and runner, made at first use
        self._scratch: Optional[SpecGeneratorRunner] = None
        self._calls = 0
        self._reset_session()

    def _seed_of(self, call: int) -> int:
        """The session's stream seed (call 0), or that of the call-th
        `generate_on_device` (a stream of its own)."""
        return self.seed * 1_000_003 + call * 65_537

    def _new_runner(self, cache, d_cache) -> SpecGeneratorRunner:
        return SpecGeneratorRunner(
            self.params, self.draft_params, cache, d_cache, self.rope,
            self.d_rope, self.config, self.draft_config,
            rounds=self.spec_rounds, max_gamma=self.gamma,
            pool=self._graph_pool)

    # -- TextGenerator protocol ----------------------------------------------

    def add_message(self, message: Message) -> None:
        self.history.add_message(message)

    def reset(self) -> None:
        """Clear chat and decode state, both caches zeroed in place (the
        captured round holds them); the random stream goes on."""
        self.history.clear()
        self.cache.zero_()
        self.d_cache.zero_()
        self._reset_session()

    def _reset_session(self) -> None:
        self.tokens: List[int] = []
        self.index_pos = 0
        self._buffer: List[int] = []
        self._pending_text = ""

    def generated_tokens(self) -> int:
        return len(self.tokens)

    def set_sampling(self, temperature=None, top_p=None, **overrides):
        """Per-request sampling overrides: temperature only (top-p/top-k
        would break the accept/resample identity), a clean error
        otherwise."""
        if top_p is not None and top_p < 1.0:
            raise ValueError(
                "--draft-model serving supports temperature only "
                "(top_p/top_k would break speculative accept/resample)")
        if overrides.get("top_k") is not None:
            raise ValueError(
                "--draft-model serving supports temperature only")
        if temperature is not None:
            self.sampling = replace(self.sampling, temperature=temperature)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def _greedy(self) -> bool:
        t = self.sampling.temperature
        return t is None or t <= 0.0

    @property
    def _temp(self) -> float:
        return float(self.sampling.temperature or 1.0)

    def next_token(self, index: int) -> Token:
        if index == 0:
            self._prefill_prompt()
        if not self._buffer:
            self._fill_buffer()
        tid = self._buffer.pop(0)
        self.tokens.append(tid)
        if tid in self.config.eos_token_ids:
            tail, self._pending_text = incremental_decode(
                self.tokenizer, self.tokens[:-1], self._pending_text,
                final=True)
            return Token(id=tid, text=tail, is_end_of_stream=True)
        new, self._pending_text = incremental_decode(
            self.tokenizer, self.tokens, self._pending_text)
        return Token(id=tid, text=new, is_end_of_stream=False)

    # -- internals ------------------------------------------------------------

    def _prefill_both(self, runner, ids: List[int]) -> int:
        """Both models' eager prefills of a prompt into `runner`'s caches,
        and its first token (greedy, or one draw of the runner's
        stream)."""
        bucket = bucket_length(len(ids), self.max_seq_len)
        toks = torch.tensor([ids + [0] * (bucket - len(ids))],
                            dtype=torch.int32, device=self.device)
        plen = torch.tensor([len(ids)], dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            logits, _ = prefill(self.params, toks, plen, runner.t_cache,
                                self.rope, self.config)
            prefill(self.draft_params, toks, plen, runner.d_cache,
                    self.d_rope, self.draft_config)
            if self._greedy:
                first = logits.argmax(dim=-1)
            else:
                first = categorical(
                    runner.seeds, runner.counters,
                    torch.softmax(logits / self._temp, dim=-1))
                runner.counters.add_(1)
            return int(first[0])

    def _prefill_prompt(self) -> None:
        ids = encode_text(self.tokenizer, self.history.render())
        if len(ids) > self.max_seq_len - self.gamma - 2:
            raise ValueError(
                f"prompt length {len(ids)} leaves no speculation window "
                f"(max_seq_len {self.max_seq_len}, gamma {self.gamma})")
        self._buffer = [self._prefill_both(self._runner, ids)]
        self.index_pos = len(ids)

    def _rounds(self, runner, last: int, pos: int, rounds: int):
        """`rounds` chained rounds from (last, pos) on the card, one
        fetch: (outs [rounds, gamma + 1], ns [rounds])."""
        runner.begin(last, pos, self._temp)
        return runner.run((self.gamma, self._greedy), rounds)

    def _fill_buffer(self) -> None:
        if self.index_pos + self.gamma + 1 >= self.max_seq_len:
            raise ValueError(
                f"speculation window exceeds max_seq_len {self.max_seq_len}"
                f" at position {self.index_pos}")
        if not self.tokens:
            raise RuntimeError(
                "next_token(index>0) called before the index==0 prefill")
        R = self.spec_rounds
        # R rounds a fetch (spec_scan) while they fit the window; near
        # its end single rounds (spec_step)
        if not (R > 1 and self.index_pos + R * (self.gamma + 1)
                <= self.max_seq_len):
            R = 1
        outs, ns = self._rounds(self._runner, self.tokens[-1],
                                self.index_pos, R)
        eos = set(self.config.eos_token_ids)
        for k in range(R):
            n = int(ns[k])
            toks = [int(t) for t in outs[k, :n]]
            self._buffer.extend(toks)
            self.proposed += self.gamma
            self.accepted += n - 1
            self.index_pos += n
            if any(t in eos for t in toks):
                # rounds past EOS ran on the card (overshoot by design)
                # but condition on post-EOS tokens: they pollute neither
                # the stream nor the acceptance stats
                break

    # -- batch generation ----------------------------------------------------

    def generate_on_device(self, prompt_ids: np.ndarray,
                           prompt_len: np.ndarray,
                           num_tokens: int) -> np.ndarray:
        """Greedy or sampled speculative generation for a [1, S] prompt;
        returns [1, num_tokens] int32. Runs over scratch caches kept by
        the generator (the session's are untouched), R chained rounds a
        fetch while they fit the window, single rounds near its end."""
        if prompt_ids.shape[0] != 1:
            raise ValueError("speculative decoding is batch-1")
        if self._scratch is None:
            self._scratch = self._new_runner(
                KVCache.create(self.config, 1, self.max_seq_len,
                               dtype=self.cache_dtype, device=self.device),
                KVCache.create(self.draft_config, 1, self.max_seq_len,
                               dtype=self.cache_dtype, device=self.device))
        r = self._scratch
        r.t_cache.zero_()
        r.d_cache.zero_()
        self._calls += 1
        r.set_stream(self._seed_of(self._calls))
        plen = int(np.asarray(prompt_len)[0])
        ids = [int(t) for t in np.asarray(prompt_ids)[0, :plen]]
        out = [self._prefill_both(r, ids)]
        pos, R = plen, self.spec_rounds
        while len(out) < num_tokens:
            if pos + self.gamma + 1 >= self.max_seq_len:
                raise ValueError("speculation window exceeds max_seq_len")
            n_r = R if (R > 1 and pos + R * (self.gamma + 1)
                        <= self.max_seq_len) else 1
            outs, ns = self._rounds(r, out[-1], pos, n_r)
            for k in range(n_r):
                n = int(ns[k])
                self.proposed += self.gamma
                self.accepted += n - 1
                out.extend(int(t) for t in outs[k, :n])
                pos += n
        return np.asarray([out[:num_tokens]], np.int32)
