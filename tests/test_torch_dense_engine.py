"""The port's dense and ring engines (`InferenceEngine` without
`kv_pages`) against the JAX package's.

The engines run the tiny config (2 layers, f32 params and cache,
greedy), every request submitted before the engine starts:

  * the dense engine's streams equal the JAX dense engine's with
    whole-prompt and chunked (--prefill-chunk) prefills and prefix hits
    (one suffix prefilled by `prefill_slot_prefixed`, one by an install
    and suffix windows), at `decode_scan` 1 and 4, with the same prefix
    hits;
  * the ring engine (a sliding window shorter than max_seq_len) keeps a
    W-slot cache and gives JAX's streams for prompts longer than W and
    streams that decode past the wrap; it refuses prefixes and switches
    with JAX's reasons;
  * under a fault plan the dense engine recovers as JAX's does (the same
    recoveries, the streams of a run without the plan), and its prefix
    registry, which lives outside the cache, survives the reset; a reset
    of the dense, ring and spec flavors keeps every buffer and runner in
    place (no graph captured anew);
  * a preempted dense stream is JAX's;
  * an engine switched paged -> dense -> paged under load finishes with
    the streams an uninterrupted JAX engine gives;
  * the flavor's refusals are JAX's; `Master.make_engine` builds the
    dense engine without --kv-pages and the ring engine for a
    sliding-window config;
  * `--api` without --kv-pages serves the dense engine over HTTP, and a
    stopped server's engine is freed by its refcount with the cyclic
    collector off.

The `cuda` cases (each dense runner's replay against its eager call;
the card's dense and ring engines against the CPU engines, with the
flash launches of the replayed prefills and no capture in a warm wave;
a faulted wave recovering with no capture anew; a wave whose dispatches
run under `torch.cuda.set_sync_debug_mode("error")`) skip without a
card. The JAX package is imported inside the
cases that use it:

    python -m pytest --noconftest -m cuda tests/test_torch_dense_engine.py
"""

import dataclasses
import gc
import json
import threading
import time
import urllib.request
import weakref
from collections import Counter

import numpy as np
import pytest

import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.serve.errors import RecoveryConfig

T = 64
W = 16
GEN = 10
PREFIX = [(5 * j) % 40 + 3 for j in range(12)]
PROMPTS = (PREFIX + [5, 3, 9], [2, 9, 4, 7, 3],
           PREFIX + [(7 * j) % 30 + 4 for j in range(11)],
           [(3 * j) % 50 + 3 for j in range(20)])
RING_PROMPTS = ([5] * 9, [(7 * j) % 60 + 3 for j in range(20)],
                [(11 * j) % 90 + 3 for j in range(37)])
FAST = dict(backoff_base_s=0.0, backoff_cap_s=0.0)
PLAN = ("seed=15;engine.prefill:nth=2:transient;engine.decode:nth=6:oom;"
        "engine.step:step=9:transient")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the captured steps replay only "
                    "on CUDA")


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX params, port config, port params) of the 2-layer
    tiny model; the ring flavor's configs are the same with a window."""
    import jax
    import jax.numpy as jnp
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params as j_init
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jc = JConfig.tiny(num_hidden_layers=2)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, LlamaConfig.tiny(num_hidden_layers=2), tp


def _windowed(models, window=W):
    jc, jp, tc, tp = models
    return (dataclasses.replace(jc, sliding_window=window), jp,
            dataclasses.replace(tc, sliding_window=window), tp)


def _jax_engine(models, sched=None, **kw):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.sched import SchedConfig as JSched
    from cake_tpu.serve.engine import InferenceEngine as JEngine
    from cake_tpu.serve.errors import RecoveryConfig as JRecovery

    jc, jp, _, _ = models
    kw.setdefault("max_slots", 2)
    if sched is not None:
        kw["sched_config"] = JSched(**sched)
    if kw.get("kv_pages") is not None:
        kw.setdefault("paged_attn", "fold")
    return JEngine(jc, jp, JTok(jc.vocab_size), max_seq_len=T,
                   sampling=JSampling(temperature=0.0, repeat_penalty=1.0),
                   cache_dtype=jnp.float32,
                   recovery_config=JRecovery(**FAST), **kw)


def _engine(models, device="cpu", params=None, sched=None, **kw):
    from cake_tpu_torch import sched as tsched
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    _, _, tc, tp = models
    kw.setdefault("max_slots", 2)
    if sched is not None:
        kw["sched_config"] = tsched.SchedConfig(**sched)
    return InferenceEngine(
        tc, params if params is not None else tp,
        ByteTokenizer(tc.vocab_size), device=device, max_seq_len=T,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, recovery_config=RecoveryConfig(**FAST),
        **kw)


def _drive(eng, prompts=PROMPTS, gen=GEN, prefix=None):
    """Every prompt submitted before the engine starts (a prefix
    registered first): the streams, the errors' classes, and the prefix
    hits and recovery counts."""
    if prefix is not None:
        eng.register_prefix(list(prefix))
    hs = [eng.submit(list(p), max_new_tokens=gen) for p in prompts]
    with eng:
        for h in hs:
            assert h.wait(timeout=300)
    return ([list(h._req.out_tokens) for h in hs],
            [type(h._req.error).__name__ if h._req.error else None
             for h in hs],
            (eng.stats.prefix_hits, eng.stats.recoveries,
             eng.stats.requests_recovered))


_JAX_RUNS: dict = {}


def _jax_once(key, fn):
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = fn()
    return _JAX_RUNS[key]


CHUNKS = {"whole": None, "chunked": 8}


@pytest.mark.parametrize("scan", [1, 4])
@pytest.mark.parametrize("prefill", sorted(CHUNKS))
def test_dense_streams_match_jax(models, prefill, scan):
    kw = dict(prefill_chunk=CHUNKS[prefill], decode_scan_steps=scan)
    want = _jax_once(("dense", prefill, scan), lambda: _drive(
        _jax_engine(models, **kw), prefix=PREFIX))
    eng = _engine(models, **kw)
    assert not eng.paged and not eng.ring and eng.flight.impl == "dense"
    assert eng.cache.k.shape == (2, 2, T, 2, 16)
    got = _drive(eng, prefix=PREFIX)
    assert got == want
    assert got[2][0] == 2            # both prefix prompts hit
    kinds = Counter(r.kind for r in eng.flight.records())
    assert kinds["prefill"] >= 1 and (kinds["decode"]
                                      + kinds["decode_scan"]) >= 1
    # the one-slot steps this wave used, by JAX compile key
    variants = set(eng._prefill_runner._bufs)
    if prefill == "whole":
        assert variants == {("slot", 32), ("prefixed", 12, 32)}
    else:
        assert variants == {("slot", 32), ("chunk", 8), ("install", 12),
                            ("prefixed", 12, 32)}


@pytest.mark.parametrize("scan", [1, 4])
def test_ring_streams_match_jax_across_a_wrap(models, scan):
    ring = _windowed(models)
    gen = 30                           # every stream decodes past W
    want = _jax_once(("ring", scan), lambda: _drive(
        _jax_engine(ring, decode_scan_steps=scan), RING_PROMPTS, gen))
    eng = _engine(ring, decode_scan_steps=scan)
    assert eng.ring and eng.flight.impl == "ring"
    assert eng.cache.k.shape[2] == W and eng.prefill_chunk == W
    assert eng.cache.memory_bytes() * (T // W) == _engine(
        models).cache.memory_bytes()
    got = _drive(eng, RING_PROMPTS, gen)
    assert got == want
    assert set(eng._prefill_runner._bufs) == {("ring", W)}


def test_ring_refuses_prefixes_and_switches_with_jax_reasons(models):
    ring = _windowed(models)
    jeng, eng = _jax_engine(ring), _engine(ring)
    for e in (jeng, eng):
        with pytest.raises(ValueError) as err:
            e.register_prefix(PREFIX)
        assert "ring sliding-window caches own their layout" in str(
            err.value)
        with pytest.raises(ValueError) as err:
            e.reconfigure({"slots": 4})
        assert "ring (sliding-window) caches own their layout" in str(
            err.value)
    assert eng._reconfig_refusal() == jeng._reconfig_refusal()
    # every ring prefill is a window dividing max_seq_len
    with pytest.raises(ValueError, match="ring/sliding-window"):
        _engine(_windowed(models, 24))


@pytest.mark.parametrize("scan", [1, 4])
def test_dense_recovery_matches_jax(models, scan):
    kw = dict(decode_scan_steps=scan, fault_plan=PLAN, recovery=True)
    want = _jax_once(("recovery", scan), lambda: _drive(
        _jax_engine(models, **kw), prefix=PREFIX))
    eng = _engine(models, event_ring=256, **kw)
    got = _drive(eng, prefix=PREFIX)
    assert got == want
    assert got[2][1] >= 2 and got[1] == [None] * len(PROMPTS)
    clean = _drive(_engine(models, decode_scan_steps=scan), prefix=PREFIX)
    assert got[0] == clean[0]
    # the dense registry lives outside the cache: the resets keep it
    assert len(eng._prefixes) == 1
    assert len(eng.events.dump(type="recovered")) == got[2][2]


@pytest.mark.parametrize("flavor", ["dense", "ring", "spec"])
def test_a_reset_keeps_every_buffer_and_runner(models, flavor):
    """A recovery resets the dense flavors in place: the caches (the
    draft's too), the rings, the seeds and the counters keep their
    storage and every runner survives, so no graph is captured anew;
    right after it the caches are zero, and the dense prefix registry
    (outside the cache) is kept."""
    m = _windowed(models) if flavor == "ring" else models
    kw = dict(prefill_chunk=8, decode_scan_steps=4)
    if flavor == "spec":
        kw = dict(draft_params=models[3], draft_config=models[2])
    eng = _engine(m, recovery=True, **kw)
    prefix = PREFIX if flavor == "dense" else None
    _drive(eng, prompts=PROMPTS[1:], prefix=prefix)
    caches = [c for c in (eng.cache, eng.d_cache) if c is not None]
    ptrs = [t.data_ptr() for c in caches for t in (c.k, c.v)] + [
        t.data_ptr() for t in (eng._ring, eng._seeds, eng._counters)]
    runners = [eng._runner, eng._prefill_runner, eng._spec_runner,
               eng._draft_prefill_runner]
    assert any(r is not None for r in runners)
    with torch.inference_mode():     # as on the engine thread
        eng._reset_after_error()
    assert [t.data_ptr() for c in caches for t in (c.k, c.v)] + [
        t.data_ptr() for t in (eng._ring, eng._seeds, eng._counters)] == ptrs
    assert [eng._runner, eng._prefill_runner, eng._spec_runner,
            eng._draft_prefill_runner] == runners
    assert all(not c.k.any() and not c.v.any() for c in caches)
    assert len(eng._prefixes) == (1 if flavor == "dense" else 0)


def test_dense_preemption_matches_jax(models):
    """One slot: an interactive arrival preempts the decoding batch
    stream, which re-prefills its fold and finishes with JAX's tokens."""
    def drive(eng):
        kw = dict(temperature=0.0, repeat_penalty=1.1)
        with eng:
            hs = [eng.submit([5] * 9, max_new_tokens=24, priority="batch",
                             **kw)]
            t0 = time.perf_counter()
            while (len(hs[0]._req.out_tokens) < 4
                   and time.perf_counter() - t0 < 120):
                time.sleep(0.001)
            hs.append(eng.submit([2, 9, 4, 7, 3], max_new_tokens=4,
                                 priority="interactive", **kw))
            assert all(h.wait(timeout=300) for h in hs)
        return ([list(h._req.out_tokens) for h in hs],
                eng.stats.preemptions)

    kw = dict(max_slots=1, priority_classes=True, preemption=True,
              sched=dict(preempt_budget=8))
    want = _jax_once(("preempt",), lambda: drive(_jax_engine(models, **kw)))
    got = drive(_engine(models, **kw))
    assert got == want and got[1] == 1


def test_paged_dense_paged_switch_matches_jax(models):
    """Streams carried across paged -> dense -> paged finish with the
    tokens of an uninterrupted JAX engine; the pool is conserved."""
    prompts = PROMPTS[1:2] + PROMPTS[3:]
    want = _jax_once(("switch",), lambda: _drive(_jax_engine(models),
                                                 prompts, 24))
    eng = _engine(models, kv_pages=16, kv_page_size=16)
    # a few ms a decode dispatch, so the switches land mid-stream
    dispatch = eng._dispatch_scan

    def slowed(*a, **k):
        time.sleep(0.005)
        return dispatch(*a, **k)

    eng._dispatch_scan = slowed
    hs = [eng.submit(list(p), max_new_tokens=24) for p in prompts]
    with eng:
        for cfg in (dict(slots=2),
                    dict(slots=2, kv_pages=16, kv_page_size=16)):
            t0 = time.perf_counter()
            while (min(len(h._req.out_tokens) for h in hs) < 3
                   and time.perf_counter() - t0 < 120):
                time.sleep(0.001)
            assert eng.reconfigure(cfg) is True
        assert all(h.wait(timeout=300) for h in hs)
    assert [list(h._req.out_tokens) for h in hs] == want[0]
    assert eng.config_epoch == 2 and eng.paged
    assert eng._pager.free_pages == eng._pager.n_pages


def test_dense_flavor_refusals_match_jax(models):
    """Configurations both engines refuse."""
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params as j_init
    import jax
    import jax.numpy as jnp
    bad = [dict(mixed_batch="on"), dict(kv_dtype="int8"),
           dict(kv_pages=16, kv_page_size=16, flavor="ring"),
           dict(prefill_chunk=12, flavor="ring")]
    for kw in bad:
        m = _windowed(models) if kw.pop("flavor", None) else models
        with pytest.raises(ValueError):
            _jax_engine(m, **kw)
        with pytest.raises(ValueError):
            _engine(m, **kw)
    # a draft over a ring config: JAX's message
    jd = j_init(JConfig.tiny(num_hidden_layers=1), jax.random.PRNGKey(1),
                dtype=jnp.float32)
    ring = _windowed(models)
    with pytest.raises(ValueError, match="speculative engine requires"):
        _engine(ring, draft_params=ring[3], draft_config=ring[2])
    with pytest.raises(ValueError, match="speculative engine requires"):
        _jax_engine(ring, draft_params=jd, draft_config=JConfig.tiny(
            num_hidden_layers=1))
    # the host tier needs pages: ignored with JAX's warning
    assert _engine(models, kv_host_pages=4)._host_tier is None


def test_master_builds_the_dense_flavors(tmp_path):
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master

    a = Args(cpu=True, max_seq_len=128, dtype="f32").validate()
    assert a.kv_pages is None
    eng = Master.from_args(a).make_engine(max_slots=2)
    assert not eng.paged and not eng.ring and eng._recover
    (tmp_path / "config.json").write_text(json.dumps(dict(
        vocab_size=300, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, sliding_window=32)))
    ring = Master.from_args(Args(cpu=True, model=str(tmp_path), dtype="f32",
                                 max_seq_len=128)).make_engine(max_slots=2)
    assert ring.ring and ring.cache.k.shape[2] == 32
    assert ring.prefill_chunk == 32
    paged = Master.from_args(Args(cpu=True, max_seq_len=128, kv_pages=8,
                                  kv_page_size=16)).make_engine(max_slots=2)
    assert paged.paged


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_api_serves_the_dense_engine_and_frees_it_by_refcount():
    """`--api` without --kv-pages: chats through the dense engine over
    HTTP; once the server has stopped, the handler class (a reference
    cycle the HTTP server keeps) holds the ApiServer weakly, so dropping
    the last references frees the engine with the collector off."""
    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master

    master = Master.from_args(Args(cpu=True, max_seq_len=128, dtype="f32",
                                   temperature=0.0))
    eng = master.make_engine(max_slots=2)
    assert not eng.paged
    httpd = start(master, "127.0.0.1:0", block=False, engine=eng)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        out = _post(url + "/api/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 4})
        assert out["object"] == "chat.completion"
        assert out["choices"][0]["finish_reason"] in ("stop", "length")
        assert eng.stats.requests_completed == 1
        with urllib.request.urlopen(url + "/api/v1/health",
                                    timeout=60) as r:
            health = json.loads(r.read())
        assert "pages_free" not in health
        assert health["engine_config"]["kv_pages"] is None
    finally:
        httpd.shutdown()
        httpd.server_close()
    t0 = time.perf_counter()
    while (any(t.name == "cake-http" for t in threading.enumerate())
           and time.perf_counter() - t0 < 60):
        time.sleep(0.01)
    assert eng.stopped
    gc.collect()
    gc.disable()
    try:
        ref = weakref.ref(eng)
        del eng, httpd
        assert ref() is None, "a stopped server's engine outlived its " \
            "last reference (a reference cycle)"
    finally:
        gc.enable()


# -- on the card ---------------------------------------------------------------


def _captures(eng) -> list:
    """Every graph capture of the engine from here on, by its JAX
    function's name."""
    seen = []
    real = eng.flight.count_capture

    def count(fn, seconds):
        seen.append(fn)
        real(fn, seconds)
    eng.flight.count_capture = count
    return seen


def _card_models(device, **cfg_kw):
    """The 2-layer tiny model with the port's own init (no jax on the
    card), f32: (models for `_engine`, the params on `device`)."""
    from cake_tpu_torch.models.llama.params import init_params
    tc = LlamaConfig.tiny(num_hidden_layers=2, **cfg_kw)
    tp = init_params(tc, torch.Generator().manual_seed(0), device="cpu",
                     dtype=torch.float32)
    on = {k: ({n: t.to(device) for n, t in v.items()}
              if isinstance(v, dict) else v.to(device))
          for k, v in tp.items()}
    return (None, None, tc, tp), on


def _waves(eng, waves, gen, prefix=None):
    """Several waves through one started engine (a stopped engine does
    not start again): each wave's streams and the captures so far."""
    out = []
    caps = _captures(eng)
    with eng:
        if prefix is not None:
            eng.register_prefix(list(prefix))
        for prompts in waves:
            hs = [eng.submit(list(p), max_new_tokens=gen) for p in prompts]
            assert all(h.wait(timeout=300) for h in hs)
            assert all(h._req.error is None for h in hs)
            out.append(([list(h._req.out_tokens) for h in hs],
                        len(caps)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("flavor", ["dense", "ring"])
def test_cuda_dense_runners_replay_their_eager_calls(flavor):
    """Each dense one-slot step and the decode step, replayed from its
    graph on the card, writes the bytes and gives the logits of the same
    step run eagerly on a copy of the cache, at two slots; the flash
    launches are counted once per replay."""
    _cuda_or_skip()
    from cake_tpu_torch.models.llama import model as tm
    from cake_tpu_torch.models.llama.cache import KVCache
    from cake_tpu_torch.ops import flash_attention as fa
    from cake_tpu_torch.serve.graphs import DecodeRunner, DensePrefillRunner

    cfg = LlamaConfig.tiny(num_hidden_layers=2, use_flash_attention=True,
                           sliding_window=W if flavor == "ring" else None)
    _, p = _card_models("cuda")
    length = W if flavor == "ring" else T
    g = torch.Generator(device="cuda").manual_seed(0)
    cache = KVCache.create(cfg, 3, length, dtype=torch.float32,
                           device="cuda")
    cache.k.copy_(torch.randn(cache.k.shape, generator=g, device="cuda"))
    cache.v.copy_(torch.randn(cache.v.shape, generator=g, device="cuda"))
    eager = KVCache(cache.k.clone(), cache.v.clone())
    rope = tm.RopeTables.create(cfg, T, device="cuda")
    runner = DensePrefillRunner(p, cache, rope, cfg)
    ids = [(5 * j) % 90 + 3 for j in range(13)]
    fa.reset_launch_counts()
    for slot, pos0 in ((1, 0), (2, 8)):
        if flavor == "ring":
            win = ids[:8] + [0] * 8
            got = runner.run(("ring", W), win, 8, slot, pos0).clone()
            want, _ = tm.prefill_slot_chunk_ring(
                p, torch.tensor([win], device="cuda"),
                torch.tensor([8], device="cuda"), slot,
                torch.tensor([pos0], device="cuda"), eager, rope, cfg)
        else:
            win = ids + [0] * 3
            got = runner.run(("chunk", 16), win, 13, slot, pos0).clone()
            want, _ = tm.prefill_slot_chunk(
                p, torch.tensor([win], device="cuda"),
                torch.tensor([13], device="cuda"), slot,
                torch.tensor([pos0], device="cuda"), eager, rope, cfg)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(cache.k, eager.k, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(cache.v, eager.v, atol=1e-5, rtol=1e-5)
    if flavor == "dense":
        # a launch a layer: the capture's warm-up, two replays, two
        # eager calls
        assert fa.LAUNCHES["flash_attn_cached"] == 2 * (1 + 2 + 2)
        got = runner.run(("slot", 16), ids + [0] * 3, 13, 0).clone()
        want, _ = tm.prefill_slot(p, torch.tensor([ids + [0] * 3],
                                                  device="cuda"),
                                  torch.tensor([13], device="cuda"), 0,
                                  eager, rope, cfg)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        assert fa.LAUNCHES["flash_attn"] == 2 * (1 + 1 + 1)
        assert runner.captures == 2
    torch.testing.assert_close(cache.k, eager.k, atol=1e-5, rtol=1e-5)
    # the ragged decode step, replayed twice against eager steps
    B = 3
    ring_t = torch.full((B, 8), -1, dtype=torch.int64, device="cuda")
    seeds = torch.arange(B, device="cuda")
    dec = DecodeRunner(p, cache, rope, cfg, ring=ring_t, seeds=seeds,
                       counters=torch.zeros_like(seeds), max_steps=1,
                       n_top_cap=0, top_k=None,
                       forward_fn=(tm.forward_ragged_ring if flavor == "ring"
                                   else tm.forward_ragged))
    tok = np.array([5, 9, 11])
    pos = np.array([13, 20, 30])
    live = np.array([True, False, True])
    fwd = tm.forward_ragged_ring if flavor == "ring" else tm.forward_ragged
    for _ in range(2):
        dec.load(0, tok, pos, live, np.zeros(B), np.zeros(B, np.float32),
                 np.ones(B, np.float32), np.ones(B, np.float32))
        handle = dec.run(1, np.ones(B, np.int64), 0)
        want, _ = fwd(p, torch.as_tensor(tok, device="cuda")[:, None], eager,
                      torch.as_tensor(pos, device="cuda"),
                      torch.as_tensor(live, device="cuda"), rope, cfg)
        torch.testing.assert_close(dec.logits, want, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(cache.k, eager.k, atol=1e-5, rtol=1e-5)
        toks = DecodeRunner.fetch(handle)[0][:, 0]
        tok, pos = toks, pos + live
    assert dec.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("flavor", ["dense", "ring"])
def test_cuda_engine_matches_the_cpu_engine(flavor):
    """The card engine (captured steps, flash prefills) gives the CPU
    engine's greedy streams at f32 over two waves, prefix hits included
    on the dense flavor; the second wave captures nothing."""
    _cuda_or_skip()
    from cake_tpu_torch.ops import flash_attention as fa
    kw = dict(sliding_window=W) if flavor == "ring" else {}
    cpu_m, card = _card_models("cuda", use_flash_attention=True, **kw)
    prompts = RING_PROMPTS if flavor == "ring" else PROMPTS
    prefix = None if flavor == "ring" else PREFIX
    gen = 30 if flavor == "ring" else GEN
    streams = {}
    for device in ("cpu", "cuda"):
        eng = _engine(cpu_m, device=device,
                      params=card if device == "cuda" else None,
                      prefill_chunk=None if flavor == "ring" else 8,
                      decode_scan_steps=4)
        fa.reset_launch_counts()
        waves = _waves(eng, [prompts, prompts], gen, prefix=prefix)
        streams[device] = [w[0] for w in waves]
        if device == "cuda":
            if flavor == "dense":
                assert fa.LAUNCHES["flash_attn_cached"] > 0
                assert fa.LAUNCHES["flash_attn_cached_plain"] == 0
            assert waves[1][1] == waves[0][1] > 0
    assert streams["cuda"] == streams["cpu"]


@pytest.mark.cuda
def test_cuda_dense_recovery_captures_nothing_anew():
    """The card's dense engine recovers in place under a fault plan: the
    faulted wave's streams are the warm wave's, and no graph is captured
    anew (every runner kept)."""
    _cuda_or_skip()
    from cake_tpu_torch.faults import build_injector
    cpu_m, card = _card_models("cuda", use_flash_attention=True)
    eng = _engine(cpu_m, device="cuda", params=card, prefill_chunk=8,
                  decode_scan_steps=4, recovery=True)
    caps = _captures(eng)
    with eng:
        eng.register_prefix(list(PREFIX))
        waves = []
        for wave in range(2):
            if wave:
                n0 = len(caps)
                eng._faults = build_injector(PLAN)
            hs = [eng.submit(list(p), max_new_tokens=GEN) for p in PROMPTS]
            assert all(h.wait(timeout=300) for h in hs)
            assert all(h._req.error is None for h in hs)
            waves.append([list(h._req.out_tokens) for h in hs])
    assert eng.stats.recoveries >= 2
    assert waves[1] == waves[0] and len(caps) == n0


@pytest.mark.cuda
def test_cuda_dense_wave_never_waits_for_the_stream():
    """A wave whose prefills (the dense one-slot graphs and their
    samples) and decode dispatches run under
    `torch.cuda.set_sync_debug_mode("error")`: nothing in them waits for
    the stream (the fetches are outside them); every variant was
    captured by a first wave."""
    _cuda_or_skip()
    cpu_m, card = _card_models("cuda", use_flash_attention=True)
    eng = _engine(cpu_m, device="cuda", params=card, prefill_chunk=8)
    guarded = []

    def guard(fn):
        def wrapped(*a, **k):
            if len(caps) >= armed[0]:
                torch.cuda.set_sync_debug_mode("error")
                guarded.append(fn.__name__)
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        wrapped.__name__ = fn.__name__
        return wrapped

    armed = [10 ** 9]
    caps = _captures(eng)
    eng._do_prefill = guard(eng._do_prefill)
    eng._dispatch_scan = guard(eng._dispatch_scan)
    with eng:
        for wave in range(2):
            if wave == 1:
                armed[0] = len(caps)
            hs = [eng.submit(list(p), max_new_tokens=6) for p in PROMPTS]
            assert all(h.wait(timeout=300) for h in hs)
            assert all(h._req.error is None for h in hs)
    assert set(guarded) == {"_do_prefill", "_dispatch_scan"}
