"""The `--mixed-batch off` one-slot prefills as replayed graphs
(serve/graphs.PrefillRunner) against the eager prefills and the JAX
engine, and `flash_attention_cached` reading `pos` on the device.

On the CPU the runner's replay runs the captured prefill's code eagerly
over its static buffers (slot, real tokens and pos0 as device tensors,
fixed-shape write targets with the sink page):

  * each kind (`prefill_slot_paged` by bucket, `_prefixed` after a
    shared page, `_chunk` at an unaligned pos0) gives the eager call's
    logits and real pages bit for bit, over f32, int8 and int4 pools;
  * the phase-split engine's greedy streams are the JAX engine's
    (`mixed_batch="off"`) over f32, int8 and int4 KV, whole-prompt and in
    16-token windows, with prefix hits, and every admission went
    through the runner;
  * a capture is counted as a compile of its JAX function;
  * `flash_attention_cached`'s plain version with a one-element tensor
    `pos` equals the one with an int `pos`.

The `cuda` cases (captured against eager, bf16 and int8 pools;
`flash_attn_cached` with a device `pos` against its plain version, an
unaligned `pos` and a replayed graph at two positions; the card
engine's one capture per variant) skip without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_prefill_graph.py
"""

import numpy as np
import pytest

import torch

from cake_tpu_torch.kv.quantized_pool import QUANTIZED_CACHES
from cake_tpu_torch.models.llama import paged as tpg
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import ByteTokenizer
from cake_tpu_torch.models.llama.model import RopeTables
from cake_tpu_torch.models.llama.params import init_params
from cake_tpu_torch.ops import flash_attention as fa
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve.engine import InferenceEngine
from cake_tpu_torch.serve.graphs import PrefillRunner

PAGE = 16
T = 64
ROW = [6, 3, 5, 2]                    # slot 1's pages; page 6 the prefix
PREFIX = [5] * 20 + [9] * 12          # 32 tokens = 2 pages
PROMPTS = [PREFIX + [3, 7, 9, 11, 2], [5] * 40, PREFIX + [8] * 20,
           [11] * 14, [3, 7, 9], [9] * 20]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _setup(kv, device="cpu", dtype=torch.float32):
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = _to(init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", dtype=dtype), device)
    rope = RopeTables.create(cfg, T, device=device)
    g = torch.Generator().manual_seed(1)
    if kv in QUANTIZED_CACHES:
        cache = QUANTIZED_CACHES[kv].create(cfg, 2, 8, PAGE, T,
                                            device=device)
        for st in (cache.k_store, cache.v_store):
            st.q.copy_(torch.randint(0, 120, st.q.shape, generator=g,
                                     dtype=torch.int32).to(st.q.dtype))
            st.scale.copy_(torch.rand(st.scale.shape, generator=g) * 0.01)
    else:
        cache = tpg.PagedKVCache.create(cfg, 2, 8, PAGE, T, dtype=dtype,
                                        device=device)
        for st in (cache.k_store, cache.v_store):
            st.copy_(torch.randn(st.shape, generator=g).to(dtype))
    tpg.table_set_slot(cache.table, 1, ROW)
    return cfg, params, rope, cache


def _host_row():
    row = torch.full((T // PAGE,), -1, dtype=torch.int32)
    row[:len(ROW)] = torch.tensor(ROW, dtype=torch.int32)
    return row


def _real_pages(cache):
    out = []
    for st in (cache.k, cache.v):
        out += list(st) if isinstance(st, tuple) else [st]
    return out


# (kind, variant, tokens, n, pos0)
CASES = {
    "slot": (("slot", 32), 23, 0),
    "prefixed": (("prefixed", PAGE, 32), 19, 0),
    "chunk": (("chunk", 16), 9, 21),
}


def _eager(kind, params, cache, rope, cfg, toks, n, pos0, attn):
    t = torch.tensor([toks], dtype=torch.int32, device=cache.table.device)
    if kind == "slot":
        return tpg.prefill_slot_paged(params, t, n, 1, cache, rope, cfg,
                                      attn=attn, row=ROW)[0]
    if kind == "prefixed":
        return tpg.prefill_slot_paged_prefixed(
            params, t, n, 1, cache, rope, cfg, n_prefix=PAGE, attn=attn,
            row=ROW)[0]
    return tpg.prefill_slot_paged_chunk(params, t, n, 1, pos0, cache, rope,
                                        cfg, attn=attn, row=ROW)[0]


def _targets(kind, variant, cache, n, pos0):
    row, P, sink = _host_row(), cache.page_size, cache.n_pages
    if kind == "slot":
        return tpg.fixed_prompt_targets(row, variant[-1], P, sink)
    if kind == "prefixed":
        return tpg.fixed_prompt_targets(row[variant[1] // P:], variant[-1],
                                        P, sink)
    return tpg.chunk_write_targets(cache, pos0, variant[-1], n, row)


def _runner_vs_eager(kind, kv, device="cpu", dtype=torch.float32,
                     attn="plain"):
    cfg, params, rope, cache = _setup(kv, device, dtype)
    variant, n, pos0 = CASES[kind]
    toks = [(7 * i + 3) % 250 for i in range(variant[-1])]
    eager_cache = cache.clone()
    want = _eager(kind, params, eager_cache, rope, cfg, toks, n, pos0, attn)
    r = PrefillRunner(params, cache, rope, cfg, attn=attn)
    got = r.run(variant, toks, n, 1, pos0,
                _targets(kind, variant, cache, n, pos0))
    return want, got.clone(), _real_pages(eager_cache), _real_pages(cache), r


@pytest.mark.parametrize("kv", ["f32", "int8", "int4"])
@pytest.mark.parametrize("kind", list(CASES))
def test_runner_prefill_equals_the_eager_call(kind, kv):
    want, got, pages_e, pages_r, r = _runner_vs_eager(kind, kv)
    assert torch.equal(got, want)
    for a, b in zip(pages_e, pages_r):
        assert torch.equal(a, b)
    assert list(r._bufs) == [CASES[kind][0]]


def _wave(eng, max_new=6):
    eng.register_prefix(PREFIX)
    hs = [eng.submit(p, max_new_tokens=max_new, temperature=0.0,
                     repeat_penalty=1.0) for p in PROMPTS]
    with eng:
        assert all(h.wait(timeout=300) for h in hs)
    assert all(h._req.error is None for h in hs)
    return [list(h._req.out_tokens) for h in hs]


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
@pytest.mark.parametrize("chunk", [None, 16])
def test_off_streams_through_the_runner_match_jax(kv_dtype, chunk):
    import jax
    import jax.numpy as jnp
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.generator import ByteTokenizer as JByteTok
    from cake_tpu.models.llama.params import init_params as j_init
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.serve.engine import InferenceEngine as JEngine
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jc = JConfig.tiny(num_hidden_layers=2)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tc = LlamaConfig.tiny(num_hidden_layers=2)
    common = dict(max_slots=6, max_seq_len=T, kv_pages=16,
                  kv_page_size=PAGE, prefill_chunk=chunk,
                  mixed_batch="off", kv_dtype=kv_dtype)
    want = _wave(JEngine(jc, jp, JByteTok(jc.vocab_size),
                         sampling=JSampling(temperature=0.0,
                                            repeat_penalty=1.0),
                         cache_dtype=jnp.float32, paged_attn="fold",
                         **common))
    eng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu",
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, paged_attn="auto", **common)
    runs = []
    real = PrefillRunner.run

    def run(self, variant, *a):
        runs.append(variant[0])
        return real(self, variant, *a)

    PrefillRunner.run = run
    try:
        got = _wave(eng)
    finally:
        PrefillRunner.run = real
    assert got == want
    assert eng.stats.prefix_hits == 2
    # windows for the prompts longer than the chunk
    kinds = {"prefixed", "slot"} | (set() if chunk is None else {"chunk"})
    assert set(runs) == kinds
    assert len(runs) >= len(PROMPTS)


@pytest.mark.parametrize("kind", list(CASES))
def test_a_capture_counts_as_its_jax_function(kind):
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    eng = InferenceEngine(cfg, params, ByteTokenizer(cfg.vocab_size),
                          device="cpu", max_slots=2, max_seq_len=T,
                          kv_pages=8, kv_page_size=PAGE, mixed_batch="off",
                          cache_dtype=torch.float32)
    r = eng._prefill_step_runner()
    r._on_capture(CASES[kind][0], 0.25)
    ev, = eng.events.dump(type="recompile")
    assert ev["fn"] == {"slot": "prefill_slot_paged",
                        "prefixed": "prefill_slot_paged_prefixed",
                        "chunk": "prefill_slot_paged_chunk"}[kind]
    assert eng._took_capture()


@pytest.mark.parametrize("pos,window", [(16, None), (21, None), (37, 8)])
def test_flash_cached_plain_reads_a_tensor_pos(pos, window):
    g = torch.Generator().manual_seed(pos)
    S, Tc, H, KV, hd = 9, 64, 4, 2, 16
    q = torch.randn(2, S, H, hd, generator=g)
    k = torch.randn(2, Tc, KV, hd, generator=g)
    v = torch.randn(2, Tc, KV, hd, generator=g)
    want = fa.flash_attention_cached(q, k, v, pos, window=window)
    got = fa.flash_attention_cached(
        q, k, v, torch.tensor([pos], dtype=torch.int32), window=window)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="runs past the cache"):
        fa.flash_attention_cached(q, k, v, Tc - S + 1)


# -- on the card ------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the flash kernels run only on "
                    "CUDA")


@pytest.mark.cuda
@pytest.mark.parametrize("kv,dtype", [("bf16", torch.bfloat16),
                                      ("int8", torch.bfloat16),
                                      ("f32", torch.float32)])
@pytest.mark.parametrize("kind", list(CASES))
def test_cuda_captured_prefill_matches_the_eager_call(kind, kv, dtype):
    """Each kind captured (the flash kernels inside the graph) against
    its eager call from identical pools: the same logits and
    byte-identical real pages, one capture."""
    _cuda_or_skip()
    kvname = "f32" if kv == "bf16" else kv
    want, got, pages_e, pages_r, r = _runner_vs_eager(
        kind, kvname, "cuda", dtype, attn="kernel")
    assert torch.equal(got, want)
    for a, b in zip(pages_e, pages_r):
        assert torch.equal(a.view(torch.uint8) if a.element_size() == 1
                           else a, b.view(torch.uint8)
                           if b.element_size() == 1 else b)
    assert r.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_cached_reads_pos_on_the_card(dtype):
    """flash_attn_cached with a device pos against its plain version (an
    aligned and an unaligned pos, a window), and one captured launch
    replayed at two positions written into its pos buffer."""
    _cuda_or_skip()
    g = torch.Generator().manual_seed(0)
    S, Tc, H, KV, hd = 32, 256, 8, 2, 128
    tol = dict(atol=2e-2, rtol=2e-2) if dtype != torch.float32 else \
        dict(atol=1e-4, rtol=0.0)
    q = torch.randn(1, S, H, hd, generator=g).to(dtype).cuda()
    k = torch.randn(1, Tc, KV, hd, generator=g).to(dtype).cuda()
    v = torch.randn(1, Tc, KV, hd, generator=g).to(dtype).cuda()
    for pos, window in ((64, None), (101, None), (150, 40)):
        dev = torch.tensor([pos], dtype=torch.int32, device="cuda")
        got = fa.flash_attention_cached(q, k, v, dev, window=window)
        want = fa.flash_attention_cached_plain(q, k, v, pos, window=window)
        torch.testing.assert_close(got, want, **tol)
        assert torch.equal(got, fa.flash_attention_cached(
            q, k, v, pos, window=window))
    buf = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = torch.empty_like(q)
    fa.flash_attention_cached(q, k, v, buf)         # builds, warms up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(fa.flash_attention_cached(q, k, v, buf))
    for pos in (7, 190):
        buf.fill_(pos)
        graph.replay()
        torch.testing.assert_close(
            out, fa.flash_attention_cached_plain(q, k, v, pos), **tol)


@pytest.mark.cuda
def test_cuda_off_engine_captures_each_prefill_variant_once():
    """At --mixed-batch off on the card, a wave with prefix hits, whole
    prompts and then 16-token windows: each prefill variant is captured
    once, counted as a compile of its JAX function, and the streams are
    the CPU engine's."""
    _cuda_or_skip()
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    runs, fns = [], []
    for device in ("cpu", "cuda"):
        params = _to(init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu", dtype=torch.float32), device)
        streams = []
        for chunk in (None, 16):
            eng = InferenceEngine(
                cfg, params, ByteTokenizer(cfg.vocab_size), device=device,
                max_slots=6, max_seq_len=T, kv_pages=16, kv_page_size=PAGE,
                prefill_chunk=chunk, mixed_batch="off",
                sampling=SamplingConfig(temperature=0.0,
                                        repeat_penalty=1.0),
                cache_dtype=torch.float32)
            streams.append(_wave(eng))
            if device == "cuda":
                got = [e["fn"] for e in eng.events.dump(type="recompile")
                       if e["fn"].startswith("prefill_slot_paged")]
                r = eng._prefill_runner
                assert len(got) == r.captures == len(r._bufs) >= 1
                fns += got
        runs.append(streams)
    assert sorted(set(fns)) == ["prefill_slot_paged",
                                "prefill_slot_paged_chunk",
                                "prefill_slot_paged_prefixed"]
    assert runs[1] == runs[0]
