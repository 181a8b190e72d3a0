"""`RequestHandle.ttft` and `tokens_per_s` on the port's CPU engine, with
the JAX package's formulas (`cake_tpu/serve/engine.py` RequestHandle):
ttft is first token minus submit, queueing included, 0.0 before the
first token; tokens_per_s is (n - 1) over the seconds from the first
token to the finish (or now), 0.0 below two tokens.
"""

import time

import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import ByteTokenizer
from cake_tpu_torch.models.llama.params import init_params
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve.engine import InferenceEngine


def _engine():
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                    dtype=torch.float32)
    return InferenceEngine(cfg, p, ByteTokenizer(cfg.vocab_size),
                           device="cpu", max_slots=2, max_seq_len=64,
                           sampling=SamplingConfig(temperature=0.0,
                                                   repeat_penalty=1.0),
                           cache_dtype=torch.float32, kv_pages=16,
                           kv_page_size=16)


def _jax_tokens_per_s(r, now):
    """JAX's property body, evaluated over the same timestamps."""
    n = len(r.out_tokens)
    dt = (r.finish_t or now) - (r.first_token_t or 0)
    return (n - 1) / dt if n > 1 and dt > 0 else 0.0


def test_ttft_is_zero_before_the_first_token_then_positive():
    eng = _engine()
    h = eng.submit([3, 4, 5], max_new_tokens=6)
    # queued, engine not started: no token yet
    assert h.ttft == 0.0 and h.tokens_per_s == 0.0
    time.sleep(0.01)
    with eng:
        assert h.wait(120)
    r = h._req
    assert h.ttft > 0.01                  # the queueing counts
    assert h.ttft == r.first_token_t - r.submit_t


def test_tokens_per_s_is_jaxs_formula():
    eng = _engine()
    with eng:
        h = eng.submit([3, 4, 5], max_new_tokens=8, temperature=0.0)
        assert h.wait(120)
    r = h._req
    assert len(r.out_tokens) > 1 and r.finish_t > r.first_token_t
    assert h.tokens_per_s == _jax_tokens_per_s(r, None) > 0
    # a stream still running reads the clock now
    r.finish_t = 0.0
    before = time.perf_counter()
    got = h.tokens_per_s
    after = time.perf_counter()
    assert _jax_tokens_per_s(r, after) <= got <= _jax_tokens_per_s(r, before)
    # one token: no rate
    r.out_tokens = r.out_tokens[:1]
    assert h.tokens_per_s == 0.0
