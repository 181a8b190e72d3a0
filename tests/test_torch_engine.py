"""The port's paged continuous-batching engine and HTTP front door.

Greedy streams at f32 params and f32 KV are token-identical to the JAX
`InferenceEngine(kv_pages=24, kv_page_size=16, paged_attn="fold",
prefill_chunk=8, mixed_batch="on")` on tests/test_mixed_batch.py's
prompts, every page returns to the pool after retirement, and the
`start(...)` server answers buffered, SSE and health requests.
"""

import json
import time
from functools import partial
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cake_tpu.models.llama.config import LlamaConfig as JConfig
from cake_tpu.models.llama.generator import ByteTokenizer as JByteTok
from cake_tpu.models.llama.params import init_params as j_init
from cake_tpu.ops.quant import quantize_params as j_quantize_params
from cake_tpu.ops.sampling import SamplingConfig as JSampling
from cake_tpu.serve.engine import InferenceEngine as JEngine
from cake_tpu_torch.api.server import start
from cake_tpu_torch.args import Args
from cake_tpu_torch.master import Master
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import (
    ByteTokenizer, LlamaGenerator,
)
from cake_tpu_torch.models.llama.params import params_from_numpy
from cake_tpu_torch.ops import int4_matmul as i4
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve.engine import InferenceEngine

T = 64
PAGE = 16
PROMPTS = [[5] * 9, [11] * 14, [3, 7, 9]]


@pytest.fixture(scope="module")
def models():
    jc = JConfig.tiny(num_hidden_layers=2)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, LlamaConfig.tiny(num_hidden_layers=2), tp


def _run_tokens(eng, penalty, max_new=8):
    with eng:
        hs = [eng.submit(p, max_new_tokens=max_new, temperature=0.0,
                         repeat_penalty=penalty) for p in PROMPTS]
        assert all(h.wait(timeout=300) for h in hs)
        return [list(h._req.out_tokens) for h in hs]


@pytest.mark.parametrize("penalty", [1.0, 1.1])
def test_greedy_streams_token_identical_to_jax_engine(models, penalty):
    """Three slots, the 14-token prompt walking two mixed windows, with
    and without the repeat-penalty ring."""
    jc, jp, tc, tp = models
    jeng = JEngine(jc, jp, JByteTok(jc.vocab_size), max_slots=3,
                   max_seq_len=T,
                   sampling=JSampling(temperature=0.0,
                                      repeat_penalty=penalty),
                   cache_dtype=jnp.float32, kv_pages=24, kv_page_size=PAGE,
                   paged_attn="fold", prefill_chunk=8, mixed_batch="on")
    want = _run_tokens(jeng, penalty)
    teng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu", max_slots=3,
        max_seq_len=T,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=penalty),
        cache_dtype=torch.float32, kv_pages=24, kv_page_size=PAGE,
        paged_attn="auto", prefill_chunk=8, mixed_batch="on")
    got = _run_tokens(teng, penalty)
    assert got == want
    assert teng._pager.free_pages == 24
    assert teng._pager.live_pages == 0
    assert (teng.cache.table == -1).all()     # retired rows read no pages
    assert teng._mixed_pending == {}
    assert teng.stats.requests_completed == len(PROMPTS)


def test_page_starved_admission_waits_then_completes(models):
    """A pool too small for every request at once: admissions requeue
    until pages free up, and every stream still completes."""
    _, _, tc, tp = models
    eng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu", max_slots=3,
        max_seq_len=T, sampling=SamplingConfig(temperature=0.0),
        cache_dtype=torch.float32, kv_pages=3, kv_page_size=PAGE,
        prefill_chunk=8)
    with eng:
        # 20 + 6 tokens = 2 pages each: one resident stream at a time
        hs = [eng.submit([4] * 20, max_new_tokens=6) for _ in range(3)]
        assert all(h.wait(timeout=300) for h in hs)
    for h in hs:
        toks = h._req.out_tokens
        assert h._req.error is None
        assert len(toks) == 6 or toks[-1] in tc.eos_token_ids
    assert eng._pager.free_pages == 3


def test_concurrent_submitters_and_cancel_conserve_pages(models):
    """Many handler threads submit at once (switch interval shortened to
    provoke interleavings) while one stream is cancelled mid-flight:
    every request ends, the cancelled one early, and every page returns."""
    import sys
    import threading

    _, _, tc, tp = models
    eng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu", max_slots=3,
        max_seq_len=T, sampling=SamplingConfig(temperature=0.0),
        cache_dtype=torch.float32, kv_pages=12, kv_page_size=PAGE,
        prefill_chunk=8)
    handles, lock = [], threading.Lock()

    def client(i):
        h = eng.submit([3 + i] * (5 + i), max_new_tokens=4)
        with lock:
            handles.append(h)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with eng:
            victim = eng.submit([9] * 12, max_new_tokens=40)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(12)]
            for t in threads:
                t.start()
            deadline = time.monotonic() + 60
            while not victim._req.out_tokens and time.monotonic() < deadline:
                time.sleep(0.001)
            eng.cancel(victim)           # mid-stream, while others submit
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert victim.wait(timeout=120)
            assert all(h.wait(timeout=300) for h in handles)
    finally:
        sys.setswitchinterval(old)
    assert len(handles) == 12
    assert len(victim._req.out_tokens) < 40
    assert all(h._req.error is None for h in handles)
    assert eng._pager.free_pages == 12 and eng._pager.live_pages == 0
    assert (eng.cache.table == -1).all()
    assert eng._mixed_pending == {} and eng.active == 0


def test_engine_validates_its_configuration(models):
    _, _, tc, tp = models
    kw = dict(device="cpu", max_seq_len=T, kv_page_size=PAGE)
    tok = ByteTokenizer(tc.vocab_size)
    # without kv_pages the dense engine, as in JAX; the mixed step it
    # has not
    dense = InferenceEngine(tc, tp, tok, **kw)
    assert not dense.paged and not dense._mixed
    assert dense.flight.impl == "dense"
    with pytest.raises(ValueError, match="--mixed-batch on requires"):
        InferenceEngine(tc, tp, tok, mixed_batch="on", **kw)
    with pytest.raises(ValueError, match="--mixed-batch must be"):
        InferenceEngine(tc, tp, tok, kv_pages=4, mixed_batch="no", **kw)
    # the phase-split loop is ported: "off" builds it
    assert not InferenceEngine(tc, tp, tok, kv_pages=4, mixed_batch="off",
                               **kw)._mixed
    with pytest.raises(ValueError, match="paged-attn"):
        InferenceEngine(tc, tp, tok, kv_pages=4, paged_attn="fold", **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        InferenceEngine(tc, tp, tok, kv_pages=4, paged_attn="kernel", **kw)
    eng = InferenceEngine(tc, tp, tok, kv_pages=2, **kw)
    with pytest.raises(ValueError, match="kv pages"):
        eng.submit([1] * 20, max_new_tokens=40)


def test_entry_points_without_device_refuse_the_cpu(models):
    """No CUDA here: the default device="cuda" raises instead of
    silently running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, _, tc, tp = models
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(tc, tp, ByteTokenizer(tc.vocab_size), kv_pages=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaGenerator(tc, tp, ByteTokenizer(tc.vocab_size))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Master.from_args(Args())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def test_http_round_trip_buffered_sse_and_health(models):
    _, _, tc, tp = models
    args = Args(max_slots=2, max_seq_len=256, kv_pages=16,
                kv_page_size=PAGE, prefill_chunk=32, temperature=0.0,
                sample_len=6)
    gen = LlamaGenerator(tc, tp, ByteTokenizer(tc.vocab_size),
                         max_seq_len=256,
                         sampling=SamplingConfig(temperature=0.0),
                         cache_dtype=torch.bfloat16, device="cpu")
    master = Master(args, text_generator=gen)
    engine = master.make_engine()
    httpd = start(master, "127.0.0.1:0", block=False, engine=engine)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    msgs = [{"role": "user", "content": "hi"}]
    try:
        with _post(base + "/api/v1/chat/completions",
                   {"messages": msgs, "max_tokens": 5, "logprobs": True,
                    "top_logprobs": 2}) as r:
            doc = json.loads(r.read())
        assert doc["object"] == "chat.completion"
        choice = doc["choices"][0]
        assert choice["finish_reason"] == "stop"
        lp = choice["logprobs"]["content"]
        assert 1 <= len(lp) <= 5 and len(lp[0]["top_logprobs"]) == 2
        buffered_text = choice["message"]["content"]

        with _post(base + "/v1/chat/completions",
                   {"messages": msgs, "max_tokens": 5,
                    "stream": True}) as r:
            assert r.headers["Content-Type"] == "text/event-stream"
            lines = [ln for ln in r.read().decode().split("\n") if ln]
        assert lines[-1] == "data: [DONE]"
        chunks = [json.loads(ln[6:]) for ln in lines[:-1]]
        assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
        streamed = "".join(c["choices"][0]["delta"].get("content", "")
                           for c in chunks)
        assert streamed == buffered_text       # greedy: the same stream

        # the engine sends a request's final chunk before it releases the
        # request's pages and counts it completed (the JAX engine's
        # order), so wait until both are retired before reading health
        deadline = time.monotonic() + 10.0
        while (engine.stats.requests_completed < 2
               and time.monotonic() < deadline):
            time.sleep(0.01)
        with urllib.request.urlopen(base + "/api/v1/health") as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert health["requests_completed"] == 2
        assert health["pages_free"] == health["pages_total"] == 16
        with urllib.request.urlopen(base + "/v1/models") as r:
            assert json.loads(r.read())["data"][0]["id"] == "cake-tpu"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base + "/api/v1/chat/completions",
                  {"messages": [{"role": "user", "content": "x" * 300}]})
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.stop()


# -- int8 / int4 KV pages -------------------------------------------------------

QPROMPTS = [[5] * 20, [9] * 20, [11] * 14]


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_greedy_streams_token_identical_to_jax_engine(models,
                                                                kv_dtype):
    """The same engine over int8 / int4 pages: greedy streams identical
    to the JAX engine at the same --kv-dtype (fold), on repetitive
    prompts where the tiny random model's argmax is decisive (as
    tests/test_kv_tier.py chooses them), and every page returns."""
    jc, jp, tc, tp = models
    common = dict(max_slots=3, max_seq_len=T, kv_pages=24,
                  kv_page_size=PAGE, prefill_chunk=8, mixed_batch="on",
                  kv_dtype=kv_dtype)
    jeng = JEngine(jc, jp, JByteTok(jc.vocab_size),
                   sampling=JSampling(temperature=0.0, repeat_penalty=1.0),
                   cache_dtype=jnp.float32, paged_attn="fold", **common)
    teng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu",
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, paged_attn="auto", **common)
    runs = []
    for eng in (jeng, teng):
        with eng:
            hs = [eng.submit(p, max_new_tokens=8) for p in QPROMPTS]
            assert all(h.wait(timeout=300) for h in hs)
        runs.append([list(h._req.out_tokens) for h in hs])
    assert runs[1] == runs[0]
    want = torch.uint8 if kv_dtype == "int4" else torch.int8
    assert teng.cache.k.q.dtype == want and teng.kv_quant
    assert teng._pager.free_pages == 24 and teng._pager.live_pages == 0


@pytest.mark.parametrize("quant,kv_dtype", [("int4", None), ("int8", None),
                                            ("int4", "int4")])
def test_quantized_weights_greedy_streams_token_identical_to_jax_engine(
        quant, kv_dtype):
    """int4 / int8 weights quantized by the JAX package and carried over
    (hidden 128, intermediate 256: the JAX engine's 3 x 8 mixed steps and
    3-row decode steps reach its Pallas kernel, interpreted), over f32
    pages, and int4 weights over int4 pages: greedy streams identical to
    the JAX engine's, every page returned, and the port's int4 products
    all decode-shaped (int4_matmul's plain version on the CPU)."""
    cfg = dict(num_hidden_layers=2, hidden_size=128, intermediate_size=256)
    jc, tc = JConfig.tiny(**cfg), LlamaConfig.tiny(**cfg)
    jp = jax.jit(partial(j_quantize_params, bits=int(quant[3:])))(
        j_init(jc, jax.random.PRNGKey(4), dtype=jnp.float32))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    common = dict(max_slots=3, max_seq_len=T, kv_pages=24,
                  kv_page_size=PAGE, prefill_chunk=8, mixed_batch="on",
                  kv_dtype=kv_dtype)
    jeng = JEngine(jc, jp, JByteTok(jc.vocab_size),
                   sampling=JSampling(temperature=0.0, repeat_penalty=1.0),
                   cache_dtype=jnp.float32, paged_attn="fold", **common)
    teng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu",
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, paged_attn="auto", **common)
    runs = []
    i4.reset_launch_counts()
    for eng in (jeng, teng):
        with eng:
            hs = [eng.submit(p, max_new_tokens=8) for p in QPROMPTS]
            assert all(h.wait(timeout=300) for h in hs)
        runs.append([list(h._req.out_tokens) for h in hs])
    assert runs[1] == runs[0]
    assert teng._pager.free_pages == 24 and teng._pager.live_pages == 0
    n = i4.LAUNCHES["int4_matmul_plain"]
    if quant == "int4":
        assert n == 14 * teng.stats.steps and n > 0
    else:
        assert n == 0
    assert i4.LAUNCHES["int4_matmul"] == 0


def test_quantized_pool_is_rebuilt_quantized_after_a_failed_step(
        models, monkeypatch):
    """A step that raises fails its requests with a retryable error and,
    when the in-place reset raises too, rebuilds the pool with the same
    int4 storage; the next request is served from it and every page
    returns."""
    from cake_tpu_torch.kv.quantized_pool import Int4PagedKVCache
    from cake_tpu_torch.serve import engine as engine_mod
    from cake_tpu_torch.serve.errors import EngineRequestError

    _, _, tc, tp = models
    eng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu", max_slots=2,
        max_seq_len=T, sampling=SamplingConfig(temperature=0.0),
        cache_dtype=torch.float32, kv_pages=8, kv_page_size=PAGE,
        prefill_chunk=8, kv_dtype="int4")
    real_step = engine_mod.mixed_step_paged
    calls = []

    def failing_once(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected step failure")
        return real_step(*a, **kw)

    monkeypatch.setattr(engine_mod, "mixed_step_paged", failing_once)

    def in_place_fails():
        raise RuntimeError("in-place reset failed (test)")

    # the rebuild is the fallback when the in-place reset raises
    monkeypatch.setattr(eng, "_reset_in_place", in_place_fails)
    first_cache = eng.cache
    with eng:
        h = eng.submit([4] * 10, max_new_tokens=3)
        assert h.wait(timeout=300)
        assert isinstance(h._req.error, EngineRequestError)
        h2 = eng.submit([4] * 10, max_new_tokens=3)
        assert h2.wait(timeout=300)
    assert h2._req.error is None and len(h2._req.out_tokens) == 3
    assert eng.cache is not first_cache
    assert isinstance(eng.cache, Int4PagedKVCache)
    assert eng.cache.k.q.dtype == torch.uint8
    assert eng._pager.free_pages == 8
