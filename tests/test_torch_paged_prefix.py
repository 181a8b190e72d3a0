"""The port's shared-prefix pages and one-slot prefills against the JAX
package (`cake_tpu/models/llama/paged.py`, `cake_tpu/serve/engine.py`).

  * `write_prompt_pages` and `write_window_pages` give JAX's pool bytes
    (and, over int8 and int4 pools, its q bytes and scales) on unmapped
    pages, a window straddling a page, positions past the table and
    bucket padding past n_real, and write nothing to the sink page;
  * `prefill_prefix_pages`, `prefill_slot_paged_prefixed`,
    `prefill_slot_paged_chunk` and `prefill_slot_paged` give JAX's logits
    (JAX's "fold" and "pallas", the port's plain route on the CPU) and
    its pools, over f32, int8 and int4 pools: logits within 1e-4
    (1.7e-6 apart at most when written), f32 pools within 1e-5 (1.9e-6:
    the blocks' K/V differ by ulps across the frameworks' rope tables
    and products), quantized pools within one quantization step;
  * the engine with a registered prefix on the mixed path gives the JAX
    engine's greedy streams at `decode_scan` 1 and 4 over f32 and int8
    pools, counts a hit a prompt, never writes the shared pages (nor
    their int8 scales), holds strictly fewer pages than unshared
    serving, and conserves pages under cancel and unregister;
  * `chat()` with `auto_prefix_system` registers one head per system
    prompt, negative-caches a head shorter than a page, evicts the oldest
    past `max_auto_prefixes` and registers again after a reset;
  * `register_prefix` refuses with the JAX engine's messages; the command
    line takes `--auto-prefix` and `--mixed-batch off`.

Tiny 2-layer config, f32 params and f32 KV (bf16 storage flips greedy
near-ties), weights carried across with `params_from_numpy`.
"""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cake_tpu.kv import quantized_pool as jq
from cake_tpu.models.llama import paged as jpg
from cake_tpu.models.llama.config import LlamaConfig as JConfig
from cake_tpu.models.llama.generator import ByteTokenizer as JByteTok
from cake_tpu.models.llama.model import RopeTables as JRope
from cake_tpu.models.llama.params import init_params as j_init
from cake_tpu.ops.sampling import SamplingConfig as JSampling
from cake_tpu.serve.engine import InferenceEngine as JEngine
from cake_tpu_torch import cli
from cake_tpu_torch.kv import quantized_pool as tq
from cake_tpu_torch.models.chat import Message
from cake_tpu_torch.models.llama import paged as tpg
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import ByteTokenizer
from cake_tpu_torch.models.llama.model import RopeTables
from cake_tpu_torch.models.llama.params import params_from_numpy
from cake_tpu_torch.ops import flash_attention as fa
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve.engine import InferenceEngine

PAGE = 16
T = 64
PREFIX = [5] * 20 + [9] * 12          # 32 tokens = 2 pages
SUFFIXES = [[3, 7, 9, 11, 2], [13, 4, 6], [8] * 20]
FORMATS = (None, "int8", "int4")
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)
POOL_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    jc = JConfig.tiny(num_hidden_layers=2)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, LlamaConfig.tiny(num_hidden_layers=2), tp


# -- the one-slot pool writers ---------------------------------------------------

N, KV, HD = 6, 2, 4
ROW = [2, -1, 4, 0]                  # 4 table columns: T = 64 at PAGE = 16


def _j_pool(fmt, rng):
    """A pool of N pages holding random values (through the JAX prompt
    writer for the quantized formats, so each page has its own scale)."""
    vals = rng.normal(size=(N, PAGE, KV, HD)).astype(np.float32)
    if fmt is None:
        return jnp.asarray(vals)
    if fmt == "int8":
        pool = jq.QuantPool(q=jnp.zeros((N, PAGE, KV, HD), jnp.int8),
                            scale=jnp.zeros((N, KV), jnp.float32))
    else:
        pool = jq.Int4Pool(q=jnp.zeros((N, PAGE // 2, KV, HD), jnp.uint8),
                           scale=jnp.zeros((N, KV), jnp.float32))
    return jax.jit(jq.qwrite_prompt_pages)(
        pool, jnp.asarray(vals.reshape(1, N * PAGE, KV, HD)),
        jnp.arange(N, dtype=jnp.int32))


def _t_pool(jpool):
    """The port's copy of a JAX pool leaf, with the sink page past the
    real ones filled with a marker the writers must leave alone."""
    def grow(a):
        t = torch.from_numpy(np.array(a))
        return torch.cat([t, torch.full_like(t[:1], 7)])
    if isinstance(jpool, jq.QuantPool):
        return tq.QuantPool(*(grow(a) for a in jpool))
    if isinstance(jpool, jq.Int4Pool):
        return tq.Int4Pool(*(grow(a) for a in jpool))
    return grow(jpool)


def _same_pool(tpool, jpool):
    ts = tpool if isinstance(tpool, tuple) else (tpool,)
    js = jpool if isinstance(jpool, tuple) else (jpool,)
    for t, j in zip(ts, js):
        np.testing.assert_array_equal(t[:-1].numpy(), np.asarray(j))
        assert (t[-1] == 7).all(), "the sink page was written"


@pytest.mark.parametrize("fmt", FORMATS)
def test_one_slot_writers_match_jax(fmt):
    """Bit-identical pools: a 40-token prompt (three windows, the middle
    one unmapped, 8 padding positions, n_real 37) and three windows: one
    straddling pages 0 and 1 (page 1 unmapped), one running past the
    table, one of 5 real tokens of 16."""
    rng = np.random.default_rng(3)
    j_prompt = jax.jit(jpg.write_prompt_pages)
    j_window = jax.jit(jpg.write_window_pages)
    jk, jv = _j_pool(fmt, rng), _j_pool(fmt, rng)
    tk, tv = _t_pool(jk), _t_pool(jv)
    row = np.asarray(ROW, np.int32)
    k = rng.normal(size=(1, 40, KV, HD)).astype(np.float32) * 3.0
    v = rng.normal(size=(1, 40, KV, HD)).astype(np.float32) * 3.0
    jk, jv = j_prompt(jk, jv, jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(row), jnp.int32(37))
    tpg.write_prompt_pages(tk, tv, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(row), 37)
    _same_pool(tk, jk)
    _same_pool(tv, jv)
    for pos0, n_real in ((10, 16), (56, 16), (33, 5)):
        k = rng.normal(size=(1, 16, KV, HD)).astype(np.float32) * 5.0
        v = rng.normal(size=(1, 16, KV, HD)).astype(np.float32) * 5.0
        jk, jv = j_window(jk, jv, jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(row), jnp.int32(pos0),
                          jnp.int32(n_real))
        tpg.write_window_pages(tk, tv, torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(row),
                               pos0, n_real)
        _same_pool(tk, jk)
        _same_pool(tv, jv)


# -- the four prefills against JAX ------------------------------------------------


def _caches(jc, tc, fmt, slots=3, n_pages=12):
    if fmt is None:
        jcache = jpg.PagedKVCache.create(jc, slots, n_pages, PAGE, T,
                                         dtype=jnp.float32)
        tcache = tpg.PagedKVCache.create(tc, slots, n_pages, PAGE, T,
                                         dtype=torch.float32, device="cpu")
    else:
        jcls = {"int8": jq.QuantizedPagedKVCache,
                "int4": jq.Int4PagedKVCache}[fmt]
        jcache = jcls.create(jc, slots, n_pages, PAGE, T)
        tcache = tq.QUANTIZED_CACHES[fmt].create(tc, slots, n_pages, PAGE,
                                                 T, device="cpu")
    return jcache, tcache


def _dequant(pool):
    """A stacked quantized pool [L, N, ...] dequantized, and its
    quantization step, both [L, N, P, KV, hd] f32."""
    q = pool.q
    if isinstance(pool, tq.Int4Pool):
        q = tq.unpack_page_nibbles(q)
    step = pool.scale[:, :, None, :, None].expand(q.shape)
    return q.float() * step, step


def _assert_cache(tcache, jcache, fmt):
    """f32 pools within POOL_TOL (the K/V are the blocks' outputs, a few
    ulps apart across the two frameworks' rope tables and products, as
    in tests/test_torch_paged.py; the writers above are bit-identical);
    quantized pools within one quantization step, value by value."""
    for t, j in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        if fmt is None:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **POOL_TOL)
            continue
        jt = type(t)(*(torch.from_numpy(np.array(a)) for a in j))
        dt, st = _dequant(t)
        dj, sj = _dequant(jt)
        assert ((dt - dj).abs() <= torch.maximum(st, sj) * 1.0001).all()
        np.testing.assert_allclose(t.scale.numpy(), jt.scale.numpy(),
                                   rtol=1e-4, atol=0)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("jattn", ["fold", "pallas"])
def test_prefills_match_jax(models, fmt, jattn):
    """One cache through: the prefix into its own pages; a 5-token
    suffix after it (slot 0, one window at n_prefix); a 20-token suffix
    in 16-token windows at pos0 32 and 48 (slot 1, the prefix mapped at
    its head), then one more window at pos0 40 straddling two pages; a
    whole 37-token prompt (slot 2, bucket 64) whose last page is
    unmapped. Logits and pools after every call."""
    jc, jp, tc, tp = models
    jrope, trope = JRope.create(jc, T), RopeTables.create(tc, T)
    jcache, tcache = _caches(jc, tc, fmt)
    ppages = [7, 2]
    table = np.full((3, T // PAGE), -1, np.int32)
    table[0] = ppages + [4, 9]
    table[1] = ppages + [3, 5]
    table[2, :3] = [6, 8, 0]
    prow = np.full(T // PAGE, -1, np.int32)
    prow[:2] = ppages

    def both(jfn, tfn, j_args, t_args, jkw=None, tkw=None):
        nonlocal jcache
        out = jfn(*j_args(jcache), **(jkw or {}))
        tout = tfn(*t_args(tcache), **(tkw or {}))
        if not hasattr(out, "table"):           # (logits, cache)
            jlog, jcache = out
            np.testing.assert_allclose(tout[0].numpy(), np.asarray(jlog),
                                       **LOGITS_TOL)
        else:
            jcache = out
        _assert_cache(tcache, jcache, fmt)

    ji = lambda a: jnp.asarray([a], jnp.int32)          # noqa: E731
    ti = lambda a: torch.tensor([a], dtype=torch.int32)  # noqa: E731
    both(jpg.prefill_prefix_pages, tpg.prefill_prefix_pages,
         lambda c: (jp, ji(PREFIX), jnp.asarray(prow), c, jrope, jc),
         lambda c: (tp, ti(PREFIX), torch.from_numpy(prow), c, trope, tc),
         dict(attn=jattn), dict(attn="plain"))
    jcache = jcache._replace(table=jnp.asarray(table))
    tcache.table.copy_(torch.from_numpy(table))
    suffix = SUFFIXES[0] + [0] * 27                       # bucket 32
    both(jpg.prefill_slot_paged_prefixed, tpg.prefill_slot_paged_prefixed,
         lambda c: (jp, ji(suffix), jnp.asarray([5], jnp.int32),
                    jnp.int32(0), c, jrope, jc),
         lambda c: (tp, ti(suffix), 5, 0, c, trope, tc),
         dict(n_prefix=32, attn=jattn), dict(n_prefix=32, attn="plain"))
    sfx = SUFFIXES[2]
    for pos0, win, n in ((32, sfx[:16], 16), (48, sfx[16:] + [0] * 12, 4),
                         (40, sfx[8:] + [0] * 4, 12)):
        both(jpg.prefill_slot_paged_chunk, tpg.prefill_slot_paged_chunk,
             lambda c: (jp, ji(win), jnp.asarray([n], jnp.int32),
                        jnp.int32(1), jnp.int32(pos0), c, jrope, jc),
             lambda c: (tp, ti(win), n, 1, pos0, c, trope, tc),
             dict(attn=jattn), dict(attn="plain"))
    prompt = PREFIX + SUFFIXES[0]
    padded = prompt + [0] * (64 - len(prompt))
    both(jpg.prefill_slot_paged, tpg.prefill_slot_paged,
         lambda c: (jp, ji(padded), jnp.asarray([len(prompt)], jnp.int32),
                    jnp.int32(2), c, jrope, jc),
         lambda c: (tp, ti(padded), len(prompt), 2, c, trope, tc),
         dict(attn=jattn), dict(attn="plain"))


def test_prefill_attention_routes(models):
    """On the CPU "auto" and "plain" take the masked einsum (no flash
    counter moves) and "kernel" raises; the same logits both ways."""
    _, _, tc, tp = models
    rope = RopeTables.create(tc, T)
    cache = tpg.PagedKVCache.create(tc, 1, 4, PAGE, T, dtype=torch.float32,
                                    device="cpu")
    cache.table[0, :3] = torch.tensor([1, 2, 3])
    toks = torch.tensor([PREFIX + [0] * 32], dtype=torch.int32)
    fa.reset_launch_counts()
    got = [tpg.prefill_slot_paged(tp, toks, 32, 0, cache.clone(), rope, tc,
                                  attn=a)[0] for a in ("auto", "plain")]
    assert torch.equal(got[0], got[1])
    assert all(n == 0 for n in fa.LAUNCHES.values())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tpg.prefill_slot_paged(tp, toks, 32, 0, cache, rope, tc,
                               attn="kernel")


# -- the engine with a registered prefix (mixed path) ----------------------------


def _engines(models, **kw):
    jc, jp, tc, tp = models
    common = dict(max_slots=4, max_seq_len=T, kv_pages=16,
                  kv_page_size=PAGE)
    common.update(kw)
    jeng = JEngine(jc, jp, JByteTok(jc.vocab_size),
                   sampling=JSampling(temperature=0.0, repeat_penalty=1.0),
                   cache_dtype=jnp.float32, paged_attn="fold", **common)
    teng = InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu",
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, paged_attn="auto", **common)
    return jeng, teng


def _serve(eng, prompts, register=True, max_new=6):
    with eng:
        pid = eng.register_prefix(PREFIX) if register else None
        hs = [eng.submit(p, max_new_tokens=max_new, temperature=0.0,
                         repeat_penalty=1.0) for p in prompts]
        assert all(h.wait(timeout=300) for h in hs)
    return [list(h._req.out_tokens) for h in hs], pid


def _shared_bytes(eng, pid):
    pages = torch.tensor(eng._prefixes[pid][1])
    leaves = []
    for pool in (eng.cache.k, eng.cache.v):
        for t in (pool if isinstance(pool, tuple) else (pool,)):
            leaves.append(t[:, pages].clone())
    return leaves


@pytest.mark.parametrize("kv_dtype,scan", [(None, 1), (None, 4),
                                           ("int8", 1), ("int8", 4)])
def test_prefix_streams_token_identical_to_jax(models, kv_dtype, scan):
    """Three prompts sharing the 32-token prefix (one suffix of 20 walks
    two 16-token mixed windows): JAX's greedy streams, and the port's
    own unshared streams; a hit each; the shared pages' bytes (and int8
    scales) unchanged by the mixed steps, the decode steps (run eagerly,
    the captured step's CPU twin) and the other slots' admissions."""
    prompts = [PREFIX + s for s in SUFFIXES]
    jeng, teng = _engines(models, prefill_chunk=16, kv_dtype=kv_dtype,
                          decode_scan_steps=scan)
    want, _ = _serve(jeng, prompts)
    assert jeng.stats.prefix_hits == len(prompts)
    with teng:
        pid = teng.register_prefix(PREFIX)
        before = _shared_bytes(teng, pid)
        hs = [teng.submit(p, max_new_tokens=6, temperature=0.0,
                          repeat_penalty=1.0) for p in prompts]
        assert all(h.wait(timeout=300) for h in hs)
        got = [list(h._req.out_tokens) for h in hs]
        after = _shared_bytes(teng, pid)
    assert got == want
    assert teng.stats.prefix_hits == len(prompts)
    for b, a in zip(before, after):
        assert torch.equal(b, a), "a shared prefix page was written"
    # retired: only the registry's 2 pages stay live
    assert teng._pager.live_pages == 2 and teng._pager.free_pages == 14
    assert teng._prefix_pages_shared == 0
    _, plain = _engines(models, prefill_chunk=16, kv_dtype=kv_dtype,
                        decode_scan_steps=scan)
    assert _serve(plain, prompts, register=False)[0] == got


def test_shared_prefix_holds_strictly_fewer_pages(models):
    """Two requests mid-decode hold fewer pool pages with the prefix
    shared than unshared: 2 + 2 x ceil(30/16) = 6 against
    2 x ceil(62/16) = 8."""
    prompts = [PREFIX + s for s in SUFFIXES[:2]]

    def pages_in_use(register):
        _, eng = _engines(models)
        with eng:
            if register:
                eng.register_prefix(PREFIX)
            hs = [eng.submit(p, max_new_tokens=25, temperature=0.0,
                             repeat_penalty=1.0) for p in prompts]
            deadline = time.monotonic() + 120
            while (any(not h._req.out_tokens for h in hs)
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            used = eng.cache.n_pages - eng._pager.free_pages
            shared = eng._prefix_pages_shared
            for h in hs:
                eng.cancel(h)
            assert all(h.wait(timeout=120) for h in hs)
        assert eng._pager.free_pages + eng._pager.live_pages == 16
        return used, shared

    used_unshared, shared0 = pages_in_use(False)
    used_shared, shared1 = pages_in_use(True)
    assert (shared0, shared1) == (0, 2 * 2)
    assert used_shared < used_unshared
    assert (used_shared, used_unshared) == (6, 8)


def test_unregister_and_cancel_conserve_pages(models):
    """unregister_prefix drops the registry's pages once no slot holds
    them; a cancel mid-decode returns the slot's own pages and its
    references to the shared ones."""
    _, eng = _engines(models, max_seq_len=256)
    with eng:
        pid = eng.register_prefix(PREFIX)
        assert eng._pager.free_pages == 14
        h = eng.submit(PREFIX + [3, 7], max_new_tokens=3, temperature=0.0,
                       repeat_penalty=1.0)
        assert h.wait(timeout=300)
        # 2 suffix + 200 budget: 13 pages of its own
        victim = eng.submit(PREFIX + [4] * 2, max_new_tokens=200)
        deadline = time.monotonic() + 60
        while not victim._req.out_tokens and time.monotonic() < deadline:
            time.sleep(0.002)
        assert eng._pager.refcount(eng._prefixes[pid][1][0]) == 2
        eng.cancel(victim)
        assert victim.wait(timeout=60)
        time.sleep(0.05)
        assert eng._pager.live_pages == 2
        assert eng._pager.free_pages + eng._pager.live_pages == 16
        eng.unregister_prefix(pid)
        assert eng._pager.free_pages == 16 and eng._pager.live_pages == 0
    assert eng.stats.prefix_hits == 2


def test_register_refusals_carry_the_jax_messages(models):
    jeng, teng = _engines(models)
    for ids in ([], [5] * (PAGE - 1), [5] * (T - 1)):
        with pytest.raises(ValueError) as want:
            jeng.register_prefix(ids)
        with pytest.raises(ValueError) as got:
            teng.register_prefix(ids)
        assert str(got.value) == str(want.value)
    assert teng._pager.free_pages == 16
    # a 40-token prefix rounds down to its 2 whole pages
    pid = teng.register_prefix(PREFIX + [1] * 8)
    assert teng._prefixes[pid][0] == PREFIX
    assert teng._pager.live_pages == 2


# -- chat() with auto_prefix_system ------------------------------------------------


def _auto_engine(models, **kw):
    _, _, tc, tp = models
    kw.setdefault("kv_page_size", PAGE)
    return InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu", max_slots=4,
        max_seq_len=256,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, kv_pages=40, auto_prefix_system=True,
        **kw)


def test_auto_prefix_registers_one_head_per_system_prompt(models):
    """Chats sharing a system prompt register its head once and hit it;
    a second system prompt registers a second head; past
    max_auto_prefixes the oldest is evicted (its pages freed); a head
    shorter than a page is negative-cached as -1."""
    eng = _auto_engine(models, max_auto_prefixes=2)
    a, b, c = (Message.system(x * 40) for x in "abc")
    with eng:
        hs = [eng.chat([a, Message.user(u)], max_new_tokens=2)
              for u in ("hi", "yo", "hey")]
        assert all(h.wait(timeout=120) for h in hs)
        assert len(eng._prefixes) == 1 and eng.stats.prefix_hits == 3
        (pid_a,) = eng._prefixes
        n_pages = len(eng._prefixes[pid_a][1])
        assert eng._pager.live_pages == n_pages
        eng.chat([b, Message.user("hi")], max_new_tokens=2).wait(120)
        assert len(eng._prefixes) == 2 and eng.stats.prefix_hits == 4
        eng.chat([c, Message.user("hi")], max_new_tokens=2).wait(120)
        assert pid_a not in eng._prefixes and len(eng._prefixes) == 2
        assert eng._pager.live_pages == 2 * n_pages
    # an empty system message renders a head of 71 tokens: under one
    # 128-token page, nothing to share
    short = _auto_engine(models, kv_page_size=128)
    with short:
        h = short.chat([Message.system(""), Message.user("hi")],
                       max_new_tokens=2)
        assert h.wait(timeout=120)
    assert list(short._auto_pids.values()) == [-1]
    assert not short._prefixes and short.stats.prefix_hits == 0


def test_auto_prefix_registers_again_after_a_reset(models):
    """_reset_after_error clears the registry; a head -> pid entry that
    lands after the clear is stale, and the next chat registers anew."""
    eng = _auto_engine(models)
    sysmsg = Message.system("x" * 40)
    with eng:
        eng._auto_register_system(sysmsg)
        (head, pid), = eng._auto_pids.items()
        assert pid in eng._prefixes
        eng._reset_after_error()
        assert not eng._prefixes and not eng._auto_pids
        eng._auto_pids[head] = pid       # a handler thread's late write
        h = eng.chat([sysmsg, Message.user("hi")], max_new_tokens=2)
        assert h.wait(timeout=120)
        new_pid = eng._auto_pids[head]
        assert new_pid is not None and new_pid != pid
        assert new_pid in eng._prefixes
        assert eng.stats.prefix_hits == 1


def test_cli_takes_auto_prefix_and_mixed_batch_off(monkeypatch):
    import cake_tpu_torch.api.server as server

    calls = []
    monkeypatch.setattr(server, "start",
                        lambda master, address: calls.append(master))
    assert cli.main(["--cpu", "--api", "127.0.0.1:0", "--auto-prefix",
                     "--mixed-batch", "off"]) == 0
    (master,) = calls
    eng = master.make_engine()
    assert eng._auto_prefix is True and eng._mixed is False
    assert eng.device.type == "cpu"
    with pytest.raises(ValueError, match="mixed_batch"):
        cli.main(["--cpu", "--api", "127.0.0.1:0", "--mixed-batch", "no"])


def test_http_chats_share_the_system_prompt(models):
    """`--cpu --api ... --auto-prefix --mixed-batch off` end to end: three
    chats with one system message over HTTP, the first registers its
    head, all three hit it, and every page but the registry's returns."""
    import json
    import urllib.request

    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.llama.generator import LlamaGenerator

    _, _, tc, tp = models
    args = Args(max_slots=3, max_seq_len=256, kv_pages=40,
                kv_page_size=PAGE, temperature=0.0, sample_len=4,
                auto_prefix=True, mixed_batch="off")
    gen = LlamaGenerator(tc, tp, ByteTokenizer(tc.vocab_size),
                         max_seq_len=256,
                         sampling=SamplingConfig(temperature=0.0),
                         cache_dtype=torch.float32, device="cpu")
    master = Master(args, text_generator=gen)
    engine = master.make_engine()
    httpd = start(master, "127.0.0.1:0", block=False, engine=engine)
    url = (f"http://127.0.0.1:{httpd.server_address[1]}"
           "/api/v1/chat/completions")
    try:
        for user in ("hi", "yo", "hey"):
            body = {"messages": [{"role": "system", "content": "s" * 40},
                                 {"role": "user", "content": user}],
                    "max_tokens": 4, "temperature": 0.0}
            req = urllib.request.Request(
                url, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
                json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert engine.stats.prefix_hits == 3 and len(engine._prefixes) == 1
    (pages,) = [e[1] for e in engine._prefixes.values()]
    assert engine._pager.live_pages == len(pages)
