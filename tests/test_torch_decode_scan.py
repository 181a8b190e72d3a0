"""The port's decode step with sampling (`serve/graphs.DecodeRunner`),
its `--decode-scan` bursts, the fixed-shape decode writers and the
masked sampler, against the JAX package.

Greedy engine streams at f32 params are token-identical to the JAX
`InferenceEngine` at the same `decode_scan_steps` (1 and 4) over f32,
int8 and int4 pools, with rows at repeat penalty 1.0 and 1.1, a row
whose budget (3 tokens) is under K, and a row that samples the tiny
config's EOS id (set to 235, a token greedy decoding emits) in the
middle of a burst. Pages come back after a cancel mid-burst. The decode
writers give JAX's pool bytes and scales (the port's sink page left
out). The sampler's greedy rows are JAX's; its sampled rows stay inside
their top-k/top-p support and depend on their own row alone; a frozen
row's counter and ring do not move; a pinned vector of hash bits holds
the counter-based streams to the same integers on the CPU and the card.

The JAX package is imported inside the cases that use it, so on the
card (which has no jax) the file collects and its `cuda` cases run:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_scan.py
"""

import functools

import numpy as np
import pytest

import torch

from cake_tpu_torch.kv import quantized_pool as tq
from cake_tpu_torch.models.llama import paged as tpg
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import ByteTokenizer
from cake_tpu_torch.models.llama.model import RopeTables
from cake_tpu_torch.models.llama.params import init_params
from cake_tpu_torch.ops import ragged_paged_attention as rpa
from cake_tpu_torch.ops import sampling as ts
from cake_tpu_torch.serve.engine import InferenceEngine
from cake_tpu_torch.serve.graphs import DecodeRunner

EOS = 235       # emitted by greedy decoding of the last prompt, mid-burst
T = 64
PAGE = 16
# (prompt, max_new_tokens, repeat_penalty)
REQUESTS = [([5] * 20, 10, 1.0), ([9] * 20, 3, 1.1), ([11] * 14, 10, 1.1),
            ([3, 7, 9], 10, 1.0)]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the captured step replays only "
                    "on CUDA")


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params as j_init
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jc = JConfig.tiny(num_hidden_layers=2, eos_token_ids=(EOS,))
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tc = LlamaConfig.tiny(num_hidden_layers=2, eos_token_ids=(EOS,))
    return jc, jp, tc, tp


def _streams(eng):
    with eng:
        hs = [eng.submit(p, max_new_tokens=m, temperature=0.0,
                         repeat_penalty=r) for p, m, r in REQUESTS]
        assert all(h.wait(timeout=300) for h in hs)
    return [list(h._req.out_tokens) for h in hs]


# -- the engine against the JAX engine ------------------------------------------


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
@pytest.mark.parametrize("scan", [1, 4])
def test_decode_scan_streams_token_identical_to_jax(models, kv_dtype, scan):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JByteTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.serve.engine import InferenceEngine as JEngine

    jc, jp, tc, tp = models
    common = dict(max_slots=4, max_seq_len=T, kv_pages=24,
                  kv_page_size=PAGE, prefill_chunk=8, mixed_batch="on",
                  kv_dtype=kv_dtype, decode_scan_steps=scan)
    want = _streams(JEngine(
        jc, jp, JByteTok(jc.vocab_size),
        sampling=JSampling(temperature=0.0), cache_dtype=jnp.float32,
        paged_attn="fold", **common))
    teng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu",
        sampling=ts.SamplingConfig(temperature=0.0),
        cache_dtype=torch.float32, paged_attn="auto", **common)
    got = _streams(teng)
    assert got == want
    # the budget-3 row stops under K; the last row stops on EOS at its
    # fifth token, the second of its first burst at K = 4
    assert len(got[1]) == 3
    assert got[3][-1] == EOS and len(got[3]) == 5
    assert teng._pager.free_pages == 24 and teng._pager.live_pages == 0
    assert (teng.cache.table == -1).all()
    assert teng.stats.requests_completed == len(REQUESTS)


def test_cancel_mid_burst_conserves_pages(models):
    """A long stream cancelled while bursts run beside another: both
    end, the cancelled one early, and every page returns."""
    import time

    _, _, tc, tp = models
    eng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu", max_slots=2,
        max_seq_len=T, sampling=ts.SamplingConfig(temperature=0.0,
                                                  repeat_penalty=1.0),
        cache_dtype=torch.float32, kv_pages=8, kv_page_size=PAGE,
        prefill_chunk=8, decode_scan_steps=4)
    with eng:
        victim = eng.submit([9] * 6, max_new_tokens=50)
        other = eng.submit([4] * 6, max_new_tokens=20)
        deadline = time.monotonic() + 60
        while len(victim._req.out_tokens) < 6 and time.monotonic() < deadline:
            time.sleep(0.001)
        eng.cancel(victim)
        assert victim.wait(timeout=120) and other.wait(timeout=120)
    assert 6 <= len(victim._req.out_tokens) < 50
    assert other._req.error is None
    assert eng._pager.free_pages == 8 and eng._pager.live_pages == 0
    assert (eng.cache.table == -1).all()


def test_burst_decode_time_is_counted_before_its_tokens(models):
    """One request decoding in bursts: when it retires, the engine's
    decode time already holds the bursts that produced its tokens (its
    first token comes from the mixed step, which counts as prefill)."""
    _, _, tc, tp = models
    eng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu", max_slots=2,
        max_seq_len=T, sampling=ts.SamplingConfig(temperature=0.0,
                                                  repeat_penalty=1.0),
        cache_dtype=torch.float32, kv_pages=8, kv_page_size=PAGE,
        prefill_chunk=8, decode_scan_steps=4)
    seen = []

    def stream(delta, final):
        # called on the engine thread as the last token is emitted
        if final:
            seen.append(eng.stats.decode_time_s)

    with eng:
        h = eng.submit([4] * 6, max_new_tokens=12, stream=stream)
        assert h.wait(timeout=120)
    assert len(h._req.out_tokens) == 12
    assert len(seen) == 1 and seen[0] > 0.0


def test_decode_scan_flag_is_validated(models):
    from cake_tpu_torch.args import Args, parse_args

    _, _, tc, tp = models
    assert parse_args(["--decode-scan", "4"]).decode_scan == 4
    with pytest.raises(ValueError, match="decode-scan"):
        Args(decode_scan=0).validate()
    with pytest.raises(ValueError, match="decode-scan"):
        InferenceEngine(tc, tp, ByteTokenizer(tc.vocab_size), device="cpu",
                        max_seq_len=T, kv_pages=4, kv_page_size=PAGE,
                        decode_scan_steps=0)


# -- the fixed-shape decode writers -----------------------------------------------


@pytest.mark.parametrize("fmt", ["float32", "int8", "int4"])
def test_fixed_shape_decode_writers_match_jax(fmt):
    """Inactive rows, a row on an unmapped page and a position past the
    table (JAX's gather clamps it onto the last column) beside two
    mapped rows: one target per row, and the real pages' bytes and
    scales equal JAX's."""
    import jax
    import jax.numpy as jnp
    from cake_tpu.kv import quantized_pool as jq
    from cake_tpu.models.llama import paged as jpg

    rng = np.random.default_rng(0)
    N, KV, hd = 8, 2, 4
    table = np.array([[0, 1, -1], [2, 3, 4], [5, -1, 6], [7, -1, -1],
                      [-1, -1, -1]], np.int32)
    pos = np.array([PAGE + 3, 3 * PAGE + 2, PAGE + 1, 5, 0], np.int32)
    active = np.array([True, True, True, False, False])
    B = len(pos)
    tg = tq.decode_targets(torch.from_numpy(pos), torch.from_numpy(active),
                           torch.from_numpy(table), PAGE, N)
    assert all(t.shape == (B,) for t in tg)
    assert tg[2].tolist() == [1, 4, N, N, N]   # past the table: column 2
    k = rng.normal(size=(B, 1, KV, hd)).astype(np.float32)
    v = 3.0 * rng.normal(size=(B, 1, KV, hd)).astype(np.float32)
    args = (pos, active, table)
    if fmt == "float32":
        pk = rng.normal(size=(N, PAGE, KV, hd)).astype(np.float32)
        pv = 2.0 * pk
        jk, jv = jpg.update_pool_per_row(*(jnp.asarray(x) for x in (
            pk, pv, k, v) + args))
        tk, tv = (torch.from_numpy(np.concatenate([x, x[:1] * 0]))
                  for x in (pk, pv))
        tpg.update_pool_per_row(tk, tv, *(torch.from_numpy(x) for x in (
            k, v) + args))
        np.testing.assert_array_equal(tk[:N].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv[:N].numpy(), np.asarray(jv))
        return
    jcls, tcls = ((jq.Int4Pool, tq.Int4Pool) if fmt == "int4"
                  else (jq.QuantPool, tq.QuantPool))
    rows = PAGE // 2 if fmt == "int4" else PAGE
    for vals in (k, v):
        jpool = jcls(q=jnp.zeros((N, rows, KV, hd),
                                 jnp.uint8 if fmt == "int4" else jnp.int8),
                     scale=jnp.zeros((N, KV), jnp.float32))
        fill = rng.normal(size=(1, N * PAGE, KV, hd)).astype(np.float32)
        # jitted, as the JAX engine runs them (and as the port's f32
        # arithmetic follows them: see kv/quantized_pool.py)
        jpool = jax.jit(jq.qwrite_prompt_pages)(
            jpool, jnp.asarray(fill), jnp.arange(N, dtype=jnp.int32))
        jout = jax.jit(jq.qupdate_pool_per_row)(
            jpool, *(jnp.asarray(x) for x in (vals,) + args))
        tpool = tcls(*(torch.from_numpy(np.concatenate(
            [np.array(x), np.zeros_like(np.array(x)[:1])])) for x in jpool))
        tq.qupdate_pool_per_row(tpool, *(torch.from_numpy(x) for x in (
            vals,) + args))
        np.testing.assert_array_equal(tpool.q[:N].numpy(), np.asarray(jout.q))
        np.testing.assert_array_equal(tpool.scale[:N].numpy(),
                                      np.asarray(jout.scale))


# -- the masked sampler -----------------------------------------------------------


def _sampler_inputs(B=4, V=64, seed=5):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * 4).astype(np.float32)
    ring = rng.integers(-1, V, size=(B, 8)).astype(np.int64)
    return logits, ring


def test_masked_sampler_greedy_rows_identical_to_jax():
    import jax
    import jax.numpy as jnp
    from cake_tpu.ops import sampling as js

    logits, ring = _sampler_inputs()
    temp = np.zeros(4, np.float32)
    top_p = np.array([1.0, 0.5, 1.0, 0.3], np.float32)
    pen = np.array([1.0, 1.1, 1.3, 1.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    j_ids, j_lp, j_ti, j_tl = js.sample_tokens_ragged(
        keys, jnp.asarray(logits), jnp.asarray(ring), jnp.asarray(temp),
        jnp.asarray(top_p), jnp.asarray(pen), n_top=3)
    live = torch.tensor([True, True, False, True])
    nxt, counters, new_ring, lp, ti, tl = ts.masked_sample(
        live, torch.arange(4), torch.zeros(4, dtype=torch.int64),
        torch.from_numpy(logits), torch.from_numpy(ring),
        torch.tensor([0, 3, 5, 9]), torch.from_numpy(temp),
        torch.from_numpy(top_p), torch.from_numpy(pen), n_top=3)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_lp), atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(j_ti))
    np.testing.assert_allclose(tl.numpy(), np.asarray(j_tl), atol=1e-6)
    assert counters.tolist() == [1, 1, 0, 1]
    want_ring = np.array(js.update_ring_per_row(
        jnp.asarray(ring), j_ids, jnp.asarray([0, 3, 5, 9])))
    want_ring[2] = ring[2]                   # the frozen row keeps its ring
    np.testing.assert_array_equal(new_ring.numpy(), want_ring)


def test_masked_sampler_stays_in_support_and_rows_are_independent():
    """200 draws a row: every sampled id inside the row's top-k (k = 5)
    and top-p set; changing row 2's logits changes no other row's draw."""
    import jax.numpy as jnp
    from cake_tpu.ops import sampling as js

    logits, ring = _sampler_inputs(seed=7)
    ring[:] = -1
    temp = torch.tensor([0.8, 1.0, 0.7, 1.3])
    top_p = torch.tensor([0.3, 1.0, 0.9, 0.6])
    pen = torch.ones(4)
    scaled = logits / temp.numpy()[:, None]
    allowed = np.asarray(js._mask_top_p(js._mask_top_k(jnp.asarray(scaled),
                                                       5),
                                        jnp.asarray(top_p.numpy())[:, None]))
    allowed = allowed > -np.inf
    seeds = torch.tensor([11, 12, 13, 14])
    other = logits.copy()
    other[2] = np.roll(other[2], 7)
    seen = [set() for _ in range(4)]
    for c in range(200):
        counters = torch.full((4,), c, dtype=torch.int64)
        ids = ts.sample_tokens_ragged(
            seeds, counters, torch.from_numpy(logits), torch.from_numpy(ring),
            temp, top_p, pen, top_k=5)[0]
        moved = ts.sample_tokens_ragged(
            seeds, counters, torch.from_numpy(other), torch.from_numpy(ring),
            temp, top_p, pen, top_k=5)[0]
        for b in range(4):
            assert allowed[b, int(ids[b])], (b, c)
            seen[b].add(int(ids[b]))
        assert ids[[0, 1, 3]].tolist() == moved[[0, 1, 3]].tolist()
    # the draws are random, not stuck: a row with more than one token in
    # its support visits more than one
    for b in range(4):
        assert len(seen[b]) > 1 or allowed[b].sum() == 1


def _hash32(x: int) -> int:
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    x = (x * 0x846CA68B) & m
    return x ^ (x >> 16)


def _bits(seed: int, counter: int, n: int) -> list:
    """`ops/sampling.random_bits` for one row, in Python integers."""
    m = 0xFFFFFFFF
    key = _hash32((_hash32((seed & m) ^ 0x5BD1E995) + counter) & m)
    return [_hash32(_hash32((key + (c + 1) * 0x9E3779B9) & m) ^ key)
            for c in range(n)]


# seeds (the engine's slot seeds at its default seed are 299792458 *
# 1_000_003 + b), counters, and the bits they give
PIN_SEEDS = [0, 1, 299792458 * 1_000_003 + 7, 2**40 + 5]
PIN_COUNTERS = [0, 3, 1_000_000, 2**31 + 1]
PIN_BITS = [[_bits(s, c, 3) for s, c in zip(PIN_SEEDS, PIN_COUNTERS)]]


def _check_pinned(device):
    got = ts.random_bits(torch.tensor(PIN_SEEDS, device=device),
                         torch.tensor(PIN_COUNTERS, device=device), 3)
    assert got.cpu().tolist() == PIN_BITS[0]
    assert got.cpu().tolist() == [
        [2125937077, 404211138, 3706869650],
        [2742067029, 171537493, 1282844173],
        [34171410, 2995245507, 249724425],
        [3341528954, 2820528488, 3550443671]]


def test_hash_bits_are_pinned_on_the_cpu():
    """The integer streams equal a Python-integer rendering of the same
    hash and a pinned table (the `cuda` case checks the card against
    the same table)."""
    _check_pinned("cpu")
    u = ts.exponentials(torch.arange(4), torch.zeros(4, dtype=torch.int64),
                        20_000)
    assert torch.isfinite(u).all() and (u > 0).all()
    assert abs(u.mean().item() - 1.0) < 0.03


@pytest.mark.cuda
def test_cuda_hash_bits_are_pinned():
    _cuda_or_skip()
    _check_pinned("cuda")


# -- the runner: frozen rows, and replays on the card ---------------------------


def _runner(device, layers=2, slots=3, K=4, kv_dtype=None, attn="auto"):
    """A DecodeRunner over a tiny random model whose EOS id lies outside
    its vocabulary (no row stops early), three slots of three pages."""
    cfg = LlamaConfig.tiny(num_hidden_layers=layers, eos_token_ids=(999,))
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device, dtype=torch.float32)
    if kv_dtype:
        cache = tq.QUANTIZED_CACHES[kv_dtype].create(cfg, slots, 12, PAGE, T,
                                                     device=device)
    else:
        cache = tpg.PagedKVCache.create(cfg, slots, 12, PAGE, T,
                                        dtype=torch.float32, device=device)
    for b in range(slots):
        tpg.table_set_slot(cache.table, b, [4 * b, 4 * b + 1, 4 * b + 2])
    ring = torch.full((slots, 8), -1, dtype=torch.int64, device=device)
    runner = DecodeRunner(
        params, cache, RopeTables.create(cfg, T, device=device), cfg,
        forward_fn=functools.partial(tpg.forward_ragged_paged, attn=attn),
        ring=ring, seeds=torch.arange(slots, device=device),
        counters=torch.zeros(slots, dtype=torch.int64, device=device),
        max_steps=K, n_top_cap=2, top_k=None)
    return runner


def _load(runner, live, temp=0.0):
    B = runner.B
    runner.load(0, np.arange(B) + 20, np.array([17, 5, 30])[:B],
                np.asarray(live), np.zeros(B, np.int64),
                np.full(B, temp, np.float32), np.ones(B, np.float32),
                np.full(B, 1.1, np.float32))


@torch.inference_mode()
def test_frozen_rows_keep_their_stream_ring_and_pages():
    """A burst of K = 4 with row 1 inactive and row 2 on a budget of 2:
    row 1's counter, ring, carry and pages do not move; row 2 advances
    by exactly 2 and writes 2 tokens; row 0 by 4."""
    runner = _runner("cpu")
    _load(runner, [True, False, True], temp=0.9)
    ring0 = runner.ring.clone()
    k0 = runner.cache.k.clone()
    h = runner.run(4, np.array([4, 4, 2]), 0)
    toks, lps, ti, tl = DecodeRunner.fetch(h)
    assert toks.shape == (3, 4) and ti.shape == (3, 4, 0)
    assert runner.counters.tolist() == [4, 0, 2]
    assert runner.steps.tolist() == [4, 0, 2]
    assert runner.pos.tolist() == [21, 5, 32]
    assert torch.equal(runner.ring[1], ring0[1])
    assert (runner.ring[2] >= 0).sum() == 2 and (runner.ring[0] >= 0).sum() == 4
    changed = (runner.cache.k != k0).flatten(2).any(-1)      # [L, N]
    assert not changed[:, 4:8].any()                         # row 1's pages
    # row 2 wrote positions 30, 31 (page 8 = its table column 1)
    assert changed[:, 9].any() and not changed[:, 10].any()
    # a chained burst from the same carry: row 2's budget is spent
    runner.run(4, np.array([4, 4, 0]), 0)
    assert runner.counters.tolist() == [8, 0, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,attn", [(None, "auto"), ("int8", "auto"),
                                           ("int4", "auto"), (None, "plain")])
def test_cuda_replays_count_launches_and_match_the_eager_step(kv_dtype,
                                                              attn):
    """A 2-layer step captured and replayed n = 3 times counts 3 x 2
    decode-kernel launches (the capture itself none), and gives the
    tokens and pages of the same step run eagerly from identical state;
    --paged-attn plain (the folds) captures too."""
    _cuda_or_skip()
    name = rpa.kernel_name("rpa_decode", None if kv_dtype is None else 1,
                           kv_dtype == "int4")
    name += "_plain" if attn == "plain" else ""
    budget = np.array([3, 3, 3])
    with torch.inference_mode():
        runs = []
        for graph in (True, False):
            runner = _runner("cuda", kv_dtype=kv_dtype, attn=attn)
            _load(runner, [True, False, True])
            rpa.reset_launch_counts()
            if graph:
                toks = DecodeRunner.fetch(runner.run(3, budget, 0))[0]
            else:
                runner.begin(budget)
                for _ in range(3):
                    runner.step(0)
                toks = runner.out[0][:, :3].cpu().numpy()
            assert rpa.LAUNCHES[name] == 3 * 2, (graph, rpa.LAUNCHES)
            store = runner.cache.k_store
            runs.append((toks, (store if kv_dtype is None else store.q)
                         .clone()))
        (tg, kg), (te, ke) = runs
    np.testing.assert_array_equal(tg, te)
    n = kg.shape[1] - 1                  # the sink holds unordered writes
    assert torch.equal(kg[:, :n], ke[:, :n])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
def test_cuda_engine_streams_match_across_decode_scan_and_the_cpu():
    """The engine on the card (the captured step, the f32 decode kernel)
    at decode_scan 1 and 4 gives the CPU engine's greedy streams, one
    request asking for top logprobs (the n_top variant of the graph),
    and every page returns."""
    _cuda_or_skip()
    cfg = LlamaConfig.tiny(num_hidden_layers=2, eos_token_ids=(EOS,))
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    runs = []
    for device, scan in (("cpu", 1), ("cuda", 1), ("cuda", 4)):
        eng = InferenceEngine(
            cfg, _to(params, device), ByteTokenizer(cfg.vocab_size),
            device=device, max_slots=4, max_seq_len=T, kv_pages=24,
            kv_page_size=PAGE, prefill_chunk=8,
            sampling=ts.SamplingConfig(temperature=0.0),
            cache_dtype=torch.float32, decode_scan_steps=scan)
        with eng:
            hs = [eng.submit(p, max_new_tokens=m, temperature=0.0,
                             repeat_penalty=r, want_top_logprobs=i == 0)
                  for i, (p, m, r) in enumerate(REQUESTS)]
            assert all(h.wait(timeout=300) for h in hs)
        assert all(h._req.error is None for h in hs)
        assert len(hs[0]._req.out_top[-1]) == eng.n_top
        assert eng._pager.free_pages == 24
        runs.append([list(h._req.out_tokens) for h in hs])
    assert runs[1] == runs[2] == runs[0]


def test_a_capture_holds_the_collector_and_the_other_captures():
    """`graphs._capturing`: the cyclic collector is paused inside it and
    restored after, and a second thread's capture waits for the first
    (engines in one process, a disaggregated pair, capture at once)."""
    import gc
    import threading

    from cake_tpu_torch.serve import graphs

    assert gc.isenabled()
    order = []
    inside = threading.Event()
    release = threading.Event()

    def first():
        with graphs._capturing():
            order.append(("first", gc.isenabled()))
            inside.set()
            release.wait(30)
        order.append(("first out", None))

    def second():
        with graphs._capturing():
            order.append(("second", gc.isenabled()))

    t1 = threading.Thread(target=first)
    t1.start()
    assert inside.wait(30)
    t2 = threading.Thread(target=second)
    t2.start()
    t2.join(0.2)
    assert t2.is_alive(), "the second capture did not wait"
    release.set()
    t1.join(30)
    t2.join(30)
    assert order[0] == ("first", False) and ("second", False) in order
    assert gc.isenabled()
    gc.disable()
    try:
        with graphs._capturing():
            assert not gc.isenabled()
        assert not gc.isenabled(), "a paused collector stays paused"
    finally:
        gc.enable()


@pytest.mark.cuda
def test_cuda_a_collection_cannot_land_inside_a_capture():
    """A dropped CUDA graph that becomes cyclic garbage while the decode
    step is being captured: with the collector running on every
    allocation, a collection inside the capture would destroy that
    graph there (forbidden while the stream captures) and invalidate
    the capture; the capture pauses the collector, and the engine
    serves. A second engine's captures, once it is dropped and
    collected, leave no device memory behind (the warm-ups share one
    stream: cuBLAS keeps a workspace for every stream it ran on)."""
    import gc

    _cuda_or_skip()
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = _to(init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", dtype=torch.float32), "cuda")

    def engine():
        return InferenceEngine(
            cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
            max_slots=2, max_seq_len=T, kv_pages=16, kv_page_size=PAGE,
            sampling=ts.SamplingConfig(temperature=0.0),
            cache_dtype=torch.float32)

    def collected():
        gc.collect()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated()

    first = engine()
    with first:
        assert first.submit([4] * 9, max_new_tokens=4).wait(timeout=120)
    del first
    held = collected()
    eng = engine()
    x = torch.zeros(4, device="cuda")
    old = torch.cuda.CUDAGraph()
    with torch.cuda.graph(old):
        x.add_(1.0)
    box = [old]
    del old
    runner = eng._decode_runner()
    real = runner.step
    seen = []

    def step(variant):
        if box and torch.cuda.is_current_stream_capturing():
            cycle = [box.pop()]
            cycle.append(cycle)        # the old graph: cyclic garbage now
            del cycle
            seen.append(len([[i] for i in range(20000)]))
        real(variant)

    runner.step = step
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        with eng:
            h = eng.submit([5] * 9, max_new_tokens=4, temperature=0.0)
            assert h.wait(timeout=120)
    finally:
        gc.set_threshold(*threshold)
    assert h._req.error is None and len(h._req.out_tokens) == 4
    assert seen == [20000]
    del eng, runner, real, h, x
    assert collected() <= held + (1 << 20)
