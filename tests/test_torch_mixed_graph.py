"""The engine's mixed step as a CUDA graph (`serve/graphs.MixedRunner`)
and its fixed-shape window writers, against the JAX package.

  * the window writers, through a step's targets (`step_write_targets`:
    fixed shapes, the dropped positions on the cache's sink page), give
    JAX's `write_windows_pages` pool bytes and scales on the real pages
    over f32, bf16, int8 and int4 pools: a decode row, chunks straddling
    a page edge or over an unmapped hole, an inactive row, a q_len = 0
    row, a window running past the table, padding columns holding x100
    garbage, and two rows whose head pages are shared (never read back
    or stored) with a mapped page after their window that no position
    touches (left alone);
  * `MixedRunner` on the CPU (the step run eagerly) gives JAX's
    `mixed_step_paged` logits and f32 pools, samples the emitting rows
    only (their counters and rings advance, the others' do not), and a
    step in which no row emits returns no handle and samples nothing;
  * greedy engine streams at f32 are token-identical to the JAX engine's
    over f32, int8 and int4 KV, with and without `auto_prefix_system`,
    at `decode_scan_steps` 1 and 4, on prompts long enough that whole
    admission waves run chunk-only steps (no row emits, no fetch).

Tiny 2-layer config. The JAX package is imported inside the cases that
use it, so on the card (which has no jax) the file collects and its
`cuda` cases run:

    python -m pytest --noconftest -m cuda tests/test_torch_mixed_graph.py
"""

import numpy as np
import pytest

import torch

from cake_tpu_torch.kv import quantized_pool as tq
from cake_tpu_torch.models.chat import Message
from cake_tpu_torch.models.llama import paged as tpg
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import ByteTokenizer
from cake_tpu_torch.models.llama.model import RopeTables
from cake_tpu_torch.models.llama.params import init_params
from cake_tpu_torch.ops import ragged_paged_attention as rpa
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve.engine import InferenceEngine
from cake_tpu_torch.serve.graphs import MixedRunner

LOGITS = dict(atol=1e-4, rtol=1e-4)
POOL = dict(atol=1e-5, rtol=1e-5)
FORMATS = ("float32", "bfloat16", "int8", "int4")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the captured mixed step replays "
                    "only on CUDA")


# -- the fixed-shape window writers against JAX's -------------------------------

P, C, KV, HD = 8, 6, 2, 4
N = 16                               # real pages; the port's sink is page N
ZERO_PAGE = 15                       # a fresh page: zero bytes, zero scale
SHARED = [10, 11]                    # two rows' shared head pages
# rows: a decode row; a chunk straddling a page edge; a chunk over an
# unmapped hole; an inactive row; an active row with q_len 0; a window
# running past the 4-column table; two rows sharing their head pages,
# whose window (at the first page after them) leaves a mapped page
# untouched (the zero page for row 7)
TABLE = np.array([[0, 1, -1, -1], [2, 3, -1, -1], [4, -1, 5, -1],
                  [6, 7, -1, -1], [8, -1, -1, -1], [9, 12, 13, 14],
                  SHARED + [1, -1], SHARED + [5, ZERO_PAGE]], np.int32)
POS = np.array([P + 3, P - 2, P - 4, 0, 2, 4 * P - 2, 2 * P, 2 * P + 1],
               np.int32)
QLEN = np.array([1, 6, 6, 3, 0, 6, 3, 2], np.int32)
ACTIVE = np.array([True, True, True, False, True, True, True, True])


def _j_leaf(fmt, rng):
    """A JAX pool leaf of N pages holding random values (through the JAX
    prompt writer for the quantized formats, so each page carries its own
    scale), with ZERO_PAGE fresh."""
    import jax
    import jax.numpy as jnp
    from cake_tpu.kv import quantized_pool as jq

    vals = rng.normal(size=(N, P, KV, HD)).astype(np.float32)
    vals[ZERO_PAGE] = 0.0
    if fmt in ("float32", "bfloat16"):
        return jnp.asarray(vals, dtype=getattr(jnp, fmt))
    if fmt == "int8":
        pool = jq.QuantPool(q=jnp.zeros((N, P, KV, HD), jnp.int8),
                            scale=jnp.zeros((N, KV), jnp.float32))
    else:
        pool = jq.Int4Pool(q=jnp.zeros((N, P // 2, KV, HD), jnp.uint8),
                           scale=jnp.zeros((N, KV), jnp.float32))
    pages = jnp.asarray(np.where(np.arange(N) == ZERO_PAGE, -1,
                                 np.arange(N)), jnp.int32)
    return jax.jit(jq.qwrite_prompt_pages)(
        pool, jnp.asarray(vals.reshape(1, N * P, KV, HD)), pages)


def _stacked(jleaf):
    """The JAX leaf as the port stores it: one layer, plus the sink page
    (filled with a marker)."""
    def grow(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        return torch.cat([t, torch.full_like(t[:1], 7)])[None]
    if isinstance(jleaf, tuple):
        cls = tq.Int4Pool if jleaf.q.dtype == np.uint8 else tq.QuantPool
        return cls(*(grow(a) for a in jleaf))
    return grow(jleaf)


def _cache(fmt, k_store, v_store):
    table = torch.from_numpy(TABLE)
    if fmt in ("float32", "bfloat16"):
        return tpg.PagedKVCache(k_store, v_store, table)
    cls = tq.QUANTIZED_CACHES[fmt]
    return cls(k_store, v_store, table)


def _bits(t):
    """A leaf's bytes, comparable across the two packages."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _j_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("fmt", FORMATS)
def test_fixed_shape_window_writers_match_jax(fmt):
    """Bit-identical real pages and scales; the shared head pages are
    neither gathered nor stored; every target has a fixed shape; what
    JAX drops lands on the sink and nowhere else."""
    import jax
    import jax.numpy as jnp
    from cake_tpu.models.llama import paged as jpg

    rng = np.random.default_rng(0)
    jk, jv = _j_leaf(fmt, rng), _j_leaf(fmt, rng)
    cache = _cache(fmt, _stacked(jk), _stacked(jv))
    B = len(POS)
    k = rng.normal(size=(B, C, KV, HD)).astype(np.float32) * 3.0
    v = rng.normal(size=(B, C, KV, HD)).astype(np.float32) * 3.0
    for b, n in enumerate(QLEN):
        k[b, n:] *= 100.0
        v[b, n:] *= 100.0
    jk, jv = jax.jit(jpg.write_windows_pages)(
        jk, jv, *(jnp.asarray(x) for x in (k, v, POS, QLEN, ACTIVE,
                                           TABLE)))
    pos, q_len, active = (torch.from_numpy(x) for x in (POS, QLEN, ACTIVE))
    tg = tpg.step_write_targets(cache, pos, active, q_len, C)
    if fmt in ("int8", "int4"):
        W = -(-C // P) + 1
        assert (tg.pages.shape, tg.slots.shape, tg.mask.shape) == \
            ((B, W), (B * C,), (B, W, P))
        used = set(tg.pages.flatten().tolist())
        assert not used & set(SHARED), "a shared page is read back"
        assert ZERO_PAGE not in used, "an untouched page is read back"
    else:
        rows, cols, pages, offs = tg
        assert pages.shape == offs.shape == (B, C)
        used = set(pages.flatten().tolist())
    assert N in used                   # the dropped positions' sink
    pk, pv = cache.layer(0)
    tpg.write_windows_pages(pk, pv, torch.from_numpy(k),
                            torch.from_numpy(v), pos, q_len, active,
                            cache.table, tg)
    for t, j in ((cache.k, jk), (cache.v, jv)):
        ts = t if isinstance(t, tuple) else (t,)
        js = j if isinstance(j, tuple) else (j,)
        for tt, jj in zip(ts, js):
            np.testing.assert_array_equal(_bits(tt[0]), _j_bits(jj))


@pytest.mark.parametrize("fmt", FORMATS)
def test_window_targets_shape_does_not_depend_on_the_rows(fmt):
    """Every row idle, or every row writing: the same target shapes
    (what lets a mixed step capture into a CUDA graph)."""
    rng = np.random.default_rng(1)
    leaf = _stacked(_j_leaf(fmt, rng))
    cache = _cache(fmt, leaf, leaf)
    pos = torch.from_numpy(POS)
    shapes = []
    for q_len, active in ((np.zeros_like(QLEN), np.zeros_like(ACTIVE)),
                          (np.full_like(QLEN, C), np.ones_like(ACTIVE))):
        tg = tpg.step_write_targets(cache, pos, torch.from_numpy(active),
                                    torch.from_numpy(q_len), C)
        shapes.append([tuple(t.shape) for t in tg])
        if not active.any():
            pages = tg.pages if fmt in ("int8", "int4") else tg[2]
            assert (pages == N).all()
    assert shapes[0] == shapes[1]


# -- the runner on the CPU against JAX's mixed step --------------------------------

T = 64
PAGE = 16


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params as j_init
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jc = JConfig.tiny(num_hidden_layers=2)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, LlamaConfig.tiny(num_hidden_layers=2), tp


# a decode row at 20; a chunk at an in-page offset straddling a page edge
# (its third window runs onto an unmapped page); a chunk after two shared
# head pages; an idle row; a decode row on an unmapped page after the
# same shared pages
STEP_TABLE = np.array([[0, 1, 2, -1], [3, 4, -1, -1], [5, 6, 7, 8],
                       [9, -1, -1, -1], [5, 6, 10, -1]], np.int32)
STEP_POS = np.array([20, 13, 32, 0, 50], np.int32)
STEP_QLEN = np.array([1, 8, 8, 0, 1], np.int32)


def _step_caches(jc, tc, fmt, rng, n_pages=12):
    """JAX and port caches with identical pools (random f32 values, or
    quantized pools left fresh) and the table above."""
    import jax.numpy as jnp
    from cake_tpu.kv import quantized_pool as jq
    from cake_tpu.models.llama import paged as jpg

    B = len(STEP_POS)
    if fmt is None:
        jcache = jpg.PagedKVCache.create(jc, B, n_pages, PAGE, T,
                                         dtype=jnp.float32)
        k = rng.normal(size=jcache.k.shape).astype(np.float32)
        v = rng.normal(size=jcache.v.shape).astype(np.float32)
        jcache = jcache._replace(k=jnp.asarray(k), v=jnp.asarray(v))
        tcache = tpg.PagedKVCache.create(tc, B, n_pages, PAGE, T,
                                         dtype=torch.float32, device="cpu")
        tcache.k.copy_(torch.from_numpy(k))
        tcache.v.copy_(torch.from_numpy(v))
    else:
        jcls = {"int8": jq.QuantizedPagedKVCache,
                "int4": jq.Int4PagedKVCache}[fmt]
        jcache = jcls.create(jc, B, n_pages, PAGE, T)
        tcache = tq.QUANTIZED_CACHES[fmt].create(tc, B, n_pages, PAGE, T,
                                                 device="cpu")
    jcache = jcache._replace(table=jnp.asarray(STEP_TABLE))
    tcache.table.copy_(torch.from_numpy(STEP_TABLE))
    return jcache, tcache


def _runner(params, cache, cfg, device, attn="auto", n_top_cap=3):
    B = cache.table.shape[0]
    return MixedRunner(
        params, cache, RopeTables.create(cfg, T, device=device), cfg,
        attn=attn, ring=torch.full((B, 8), -1, dtype=torch.int64,
                                   device=device),
        seeds=torch.arange(B, device=device),
        counters=torch.zeros(B, dtype=torch.int64, device=device),
        chunk=8, n_top_cap=n_top_cap, top_k=None)


def _rows(step, rng, vocab=256):
    """Step `step`'s descriptors: the decode rows one position on, the
    chunk rows one window on; the decode and the second chunk row emit."""
    B = len(STEP_POS)
    tokens = rng.integers(0, vocab, size=(B, 8)).astype(np.int32)
    qlen = STEP_QLEN.copy()
    pos = STEP_POS + step * np.where(qlen == 8, 8, qlen)
    active = qlen > 0
    emit = np.array([True, False, step > 0, False, True])
    return tokens, pos.astype(np.int32), qlen, active, emit


def _sampling(B):
    return (np.zeros(B, np.int64), np.zeros(B, np.float32),
            np.ones(B, np.float32), np.ones(B, np.float32))


@pytest.mark.parametrize("fmt", [None, "int8", "int4"])
def test_mixed_runner_matches_the_jax_mixed_step(models, fmt):
    """Two steps of the runner (run eagerly on the CPU) against JAX's
    `mixed_step_paged`: the logits of the active rows (and the f32
    pools), greedy tokens that are the JAX logits' argmax, counters and
    rings advanced for the emitting rows only; then a step in which no
    row emits: no handle, no counter or ring moves."""
    import jax.numpy as jnp
    from cake_tpu.models.llama import paged as jpg
    from cake_tpu.models.llama.model import RopeTables as JRope

    jc, jp, tc, tp = models
    rng = np.random.default_rng(2)
    jcache, tcache = _step_caches(jc, tc, fmt, rng)
    jrope = JRope.create(jc, T)
    runner = _runner(tp, tcache, tc, "cpu")
    B = len(STEP_POS)
    counters = np.zeros(B, np.int64)
    for step in range(2):
        tokens, pos, qlen, active, emit = _rows(step, rng)
        jl, jcache = jpg.mixed_step_paged(
            jp, *(jnp.asarray(x) for x in (tokens, pos, qlen, active)),
            jcache, jrope, jc, attn="fold")
        ring0 = runner.ring.clone()
        rpa.reset_launch_counts()
        handle = runner.run(2, tokens, pos, qlen, active, emit,
                            *_sampling(B))
        name = rpa.kernel_name("rpa_mixed", None if fmt is None else 1,
                               fmt == "int4") + "_plain"
        assert rpa.LAUNCHES[name] == tc.num_hidden_layers
        nxt, lp, ti, tl = MixedRunner.fetch(handle)
        assert nxt.shape == (B, 1) and ti.shape == (B, 1, 2)
        rows = np.flatnonzero(active)
        np.testing.assert_allclose(runner.logits.numpy()[rows],
                                   np.asarray(jl)[rows], **LOGITS)
        out = np.flatnonzero(emit)
        np.testing.assert_array_equal(nxt[out, 0],
                                      np.asarray(jl)[out].argmax(-1))
        counters += emit
        np.testing.assert_array_equal(runner.counters.numpy(), counters)
        moved = (runner.ring != ring0).any(-1).numpy()
        np.testing.assert_array_equal(moved, emit)
    if fmt is None:
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                                   **POOL)
        np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                                   **POOL)
    ring0 = runner.ring.clone()
    tokens, pos, qlen, active, _ = _rows(2, rng)
    assert runner.run(None, tokens, pos, qlen, active, np.zeros(B, bool),
                      *_sampling(B)) is None
    np.testing.assert_array_equal(runner.counters.numpy(), counters)
    assert torch.equal(runner.ring, ring0)


# -- the engine against the JAX engine ----------------------------------------------

SYSTEM = "Be terse."
USERS = ("Hello.", "Why is the sky blue today?", "Name three colours.",
         "Count to five, slowly please.")


def _engines(models, kv_dtype, scan, auto_prefix):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JByteTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.serve.engine import InferenceEngine as JEngine

    jc, jp, tc, tp = models
    common = dict(max_slots=4, max_seq_len=256, kv_pages=64,
                  kv_page_size=PAGE, prefill_chunk=16, kv_dtype=kv_dtype,
                  decode_scan_steps=scan, auto_prefix_system=auto_prefix)
    jeng = JEngine(jc, jp, JByteTok(jc.vocab_size),
                   sampling=JSampling(temperature=0.0, repeat_penalty=1.0),
                   cache_dtype=jnp.float32, paged_attn="fold", **common)
    teng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu",
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, paged_attn="auto", **common)
    return jeng, teng


def _chats(eng, messages, max_new=6):
    """A warm-up chat (which registers the system head with
    auto_prefix_system), then three chats at once. messages: the
    engine's package's `Message`."""
    def chat(user):
        return eng.chat([messages.system(SYSTEM), messages.user(user)],
                        max_new_tokens=max_new, temperature=0.0)

    with eng:
        first = chat(USERS[0])
        assert first.wait(timeout=300)
        hs = [first] + [chat(u) for u in USERS[1:]]
        assert all(h.wait(timeout=300) for h in hs)
    return [list(h._req.out_tokens) for h in hs]


@pytest.mark.parametrize("auto_prefix", [False, True])
@pytest.mark.parametrize("scan", [1, 4])
@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_engine_streams_token_identical_to_jax(models, kv_dtype, scan,
                                               auto_prefix):
    """Chats of ~130 tokens in 16-token windows (chunk-only steps while
    a wave admits; with auto_prefix_system, the suffixes after the
    shared head): the JAX engine's greedy streams; every mixed step's
    wall counted once; every page returns."""
    from cake_tpu.models.chat import Message as JMessage

    jeng, teng = _engines(models, kv_dtype, scan, auto_prefix)
    want = _chats(jeng, JMessage)
    got = _chats(teng, Message)
    assert got == want
    assert teng.stats.prefix_hits == jeng.stats.prefix_hits
    assert teng.stats.prefix_hits == (4 if auto_prefix else 0)
    assert teng._mixed_open is None
    assert teng.stats.prefill_time_s > 0 and teng.stats.decode_time_s > 0
    live = sum(len(p) for _, p in teng._prefixes.values())
    assert teng._pager.live_pages == live
    assert teng._pager.free_pages == 64 - live


def test_chunk_only_steps_fetch_nothing(models, monkeypatch):
    """A 130-token prompt alone walks 9 windows of 16: 8 steps in which
    no row emits run the variant without sampling and fetch nothing; the
    ninth samples the first token; the stats count each step once."""
    _, _, tc, tp = models
    variants = []
    real_run = MixedRunner.run

    def run(self, n_top, *rows):
        variants.append(n_top)
        return real_run(self, n_top, *rows)

    monkeypatch.setattr(MixedRunner, "run", run)
    eng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu", max_slots=2,
        max_seq_len=256, kv_pages=16, kv_page_size=PAGE, prefill_chunk=16,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32)
    with eng:
        h = eng.submit([4] * 130, max_new_tokens=1)
        assert h.wait(timeout=120)
    assert h._req.error is None and len(h._req.out_tokens) == 1
    assert variants == [None] * 8 + [0]
    assert eng.stats.steps == 9 and eng._mixed_open is None
    assert eng.stats.prefill_time_s > 0 and eng.stats.decode_time_s == 0


# -- on the card -----------------------------------------------------------------


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _card_cache(cfg, kv_dtype, device):
    if kv_dtype in ("int8", "int4"):
        cache = tq.QUANTIZED_CACHES[kv_dtype].create(
            cfg, len(STEP_POS), 12, PAGE, T, device=device)
    else:
        cache = tpg.PagedKVCache.create(
            cfg, len(STEP_POS), 12, PAGE, T, dtype=torch.bfloat16,
            device=device)
        gen = torch.Generator(device=device).manual_seed(1)
        cache.k.normal_(generator=gen)
        cache.v.normal_(generator=gen)
    cache.table.copy_(torch.from_numpy(STEP_TABLE))
    return cache


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype,attn", [(None, "auto"), ("int8", "auto"),
                                           ("int4", "auto"), (None, "plain")])
def test_cuda_mixed_replays_count_launches_and_match_the_eager_step(
        kv_dtype, attn):
    """Three replays of the captured 2-layer mixed step (bf16, int8 and
    int4 pools; --paged-attn plain captures the folds) count 3 x 2
    mixed-attention launches (the capture none) and give the tokens,
    logits and real pages of the same three steps run eagerly from
    identical state; the shared head pages stay unchanged."""
    _cuda_or_skip()
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = _to(init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", dtype=torch.float32), "cuda")
    name = rpa.kernel_name("rpa_mixed", None if kv_dtype is None else 1,
                           kv_dtype == "int4")
    name += "_plain" if attn == "plain" else ""
    B = len(STEP_POS)
    runs = []
    with torch.inference_mode():
        base = _card_cache(cfg, kv_dtype, "cuda")
        for graph in (True, False):
            cache = base.clone()
            runner = _runner(params, cache, cfg, "cuda", attn=attn)
            runner.captured(0)
            rng = np.random.default_rng(3)
            rpa.reset_launch_counts()
            toks, logits = [], []
            for step in range(3):
                rows = _rows(step, rng)
                if graph:
                    out = MixedRunner.fetch(runner.run(0, *rows,
                                                       *_sampling(B)))[0]
                else:
                    runner.load(0, *rows, *_sampling(B))
                    runner.step(0)
                    out = runner.out[0].cpu().numpy()
                toks.append(out)
                logits.append(runner.logits.clone())
            assert rpa.LAUNCHES[name] == 3 * 2, (graph, rpa.LAUNCHES)
            store = cache.k_store if kv_dtype is None else cache.k_store.q
            runs.append((toks, logits, store.clone()))
        (tg, lg, kg), (te, le, ke) = runs
        base_store = base.k_store if kv_dtype is None else base.k_store.q
    np.testing.assert_array_equal(np.stack(tg), np.stack(te))
    active = np.flatnonzero(STEP_QLEN > 0)
    for a, b in zip(lg, le):
        assert torch.equal(a[active], b[active])
    n = kg.shape[1] - 1                  # the sink holds unordered writes
    assert torch.equal(kg[:, :n], ke[:, :n])
    assert torch.equal(kg[:, [5, 6]], base_store[:, [5, 6]])


def _card_engine(device, params, cfg, **kw):
    return InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), device=device,
        max_slots=4, max_seq_len=256, kv_pages=64, kv_page_size=PAGE,
        prefill_chunk=16,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, **kw)


def _submit_wave(eng, prompts, want_top=False):
    hs = [eng.submit(p, max_new_tokens=6, temperature=0.0,
                     want_top_logprobs=want_top and i == 0)
          for i, p in enumerate(prompts)]
    assert all(h.wait(timeout=300) for h in hs)
    assert all(h._req.error is None for h in hs)
    return [list(h._req.out_tokens) for h in hs]


def _wave(eng, prompts, want_top=False):
    with eng:
        return _submit_wave(eng, prompts, want_top)


WAVE = [[5] * 70, [9] * 50, [11] * 41, [3, 7] * 20]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cuda_chunk_only_steps_dispatch_without_a_sync(kv_dtype):
    """After a first wave has captured the mixed step's variants, every
    step of a second wave through the same engine in which no row emits
    (the wave's first windows) runs under
    `torch.cuda.set_sync_debug_mode("error")`: its rows go up, the graph
    replays and nothing waits for the stream. The streams equal the
    first wave's."""
    _cuda_or_skip()
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = _to(init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", dtype=torch.float32), "cuda")
    eng = _card_engine("cuda", params, cfg, kv_dtype=kv_dtype)
    dispatch = eng._mixed_dispatch
    guarded = []

    def no_sync(decode_plan):
        C = eng._mixed_chunk
        emits = (any(s not in eng._mixed_pending for _, s in decode_plan)
                 or any(p["off"] + C >= len(p["ids"])
                        for p in eng._mixed_pending.values()))
        if emits:
            return dispatch(decode_plan)
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch(decode_plan)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        guarded.append(len(eng._mixed_pending))

    with eng:
        want = _submit_wave(eng, WAVE)
        eng._mixed_dispatch = no_sync
        assert _submit_wave(eng, WAVE) == want
    assert len(guarded) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_cuda_engine_mixed_graph_matches_the_cpu_engine(kv_dtype):
    """The engine on the card (mixed and decode steps captured) gives the
    CPU engine's greedy streams over a wave of long prompts, at
    decode_scan 1 and 4, one request asking for top logprobs (the n_top
    variant), and every page returns."""
    _cuda_or_skip()
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    runs = []
    for device, scan in (("cpu", 1), ("cuda", 1), ("cuda", 4)):
        eng = _card_engine(device, _to(params, device), cfg,
                           kv_dtype=kv_dtype, decode_scan_steps=scan)
        runs.append(_wave(eng, WAVE, want_top=True))
        assert eng._pager.free_pages == 64
    assert runs[1] == runs[2] == runs[0]
