"""The port's host-RAM KV tier (`cake_tpu_torch/kv/host_tier.py`,
--kv-host-pages) and the engine's spills against the JAX package.

  * `HostTier`: seeded sequences of put / peek / pop / drop / clear /
    can_hold give exactly the JAX tier's results, LRU order, evictions
    and page counts; its five metric families render the JAX tier's text
    byte for byte after the same operations.
  * `fetch_pages` / `install_pages`: a round trip into other page ids of
    a fresh pool is bit-identical over f32, bf16, fp8 (e4m3, e5m2), int8
    and int4 pools (values and scales), the sink page untouched, and the
    fetched arrays are JAX's arrays (order, shapes, bytes).
  * The engine (tiny config, f32 params and KV, greedy), each case
    against the JAX paged engine: a preempted stream spilled and
    restored is token-identical, with the same spill / restore counts
    and events; a cold prefix spills under page pressure and comes back
    on its next hit; a prefix whose host entry is gone degrades to a
    whole-prompt prefill (mixed on and off); an oversubscribed pool
    parks decode-resident streams in resident_quantum turns, with
    identical streams, and spill_resident=False turns that off. Every
    page and host page comes back.

The JAX package is imported inside the cases that use it, so on the card
(which has no jax) the file collects and its `cuda` case runs:

    python -m pytest --noconftest -m cuda tests/test_torch_kv_tier.py
"""

import random
import time
from collections import Counter

import numpy as np
import pytest

import torch

from cake_tpu_torch import sched as tsched
from cake_tpu_torch.args import Args
from cake_tpu_torch.kv import host_tier as ttier
from cake_tpu_torch.kv.host_tier import HostTier, SpilledPages
from cake_tpu_torch.kv.quantized_pool import (
    QUANTIZED_CACHES, Int4PagedKVCache,
)
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.paged import PagedKVCache

T = 64
PAGE = 16
GEN = 24
BATCH_PROMPT = [5] * 9
INTER_PROMPT = [2, 9, 4, 7, 3]
PREFIX = list(range(3, 35))                     # two pages


# -- the tier, op for op ------------------------------------------------------


def _entries(n_pages, seed):
    """(JAX entry, port entry) of n_pages."""
    from cake_tpu.kv.host_tier import SpilledPages as JEntry
    a = np.random.default_rng(seed).integers(
        -127, 127, size=(2, n_pages, 4), dtype=np.int8)
    return (JEntry(n_pages=n_pages, arrays=(a,), kind="victim"),
            SpilledPages(n_pages=n_pages, arrays=(torch.from_numpy(a),),
                         kind="victim"))


def _drive_tiers(seed, j, t, n_ops=300):
    """The same seeded operations on the JAX tier `j` and the port's
    `t`; yields (op, JAX result, port result)."""
    rng = random.Random(seed)
    keys = [("victim", i) for i in range(5)] + [("prefix", i)
                                                 for i in range(3)]
    for k in range(n_ops):
        op = rng.choice(["put", "put", "peek", "pop", "drop", "can_hold",
                         "keys", "state", "clear" if k % 97 == 96 else
                         "peek"])
        key = rng.choice(keys)
        if op == "put":
            je, te = _entries(rng.randint(1, j.capacity + 1), k)
            yield op, j.put(key, je), t.put(key, te)
        elif op == "peek":
            a, b = j.peek(key), t.peek(key)
            yield op, a and a.n_pages, b and b.n_pages
        elif op == "pop":
            restored = rng.random() < 0.7
            a, b = j.pop(key, restored), t.pop(key, restored)
            yield op, a and a.n_pages, b and b.n_pages
        elif op == "drop":
            yield op, j.drop(key), t.drop(key)
        elif op == "can_hold":
            n = rng.randint(0, j.capacity + 2)
            yield op, j.can_hold(n), t.can_hold(n)
        elif op == "keys":
            yield op, j.keys(), t.keys()
        elif op == "clear":
            yield op, j.clear(), t.clear()
        else:
            yield op, (j.used_pages, j.free_pages, j.spills, j.restores,
                       j.evictions, j.used_bytes), \
                (t.used_pages, t.free_pages, t.spills, t.restores,
                 t.evictions, t.used_bytes)


@pytest.mark.parametrize("seed", range(4))
def test_host_tier_matches_jax_op_for_op(seed):
    from cake_tpu.kv.host_tier import HostTier as JTier
    cap = [2, 3, 4, 9][seed]
    j, t = JTier(cap, page_bytes=128), HostTier(cap, page_bytes=128)
    n = 0
    for op, want, got in _drive_tiers(seed, j, t):
        assert got == want, (seed, n, op)
        n += 1
    assert t.evictions > 0 and t.restores > 0
    for tier in (j, t):
        with pytest.raises(ValueError, match="must be >= 1"):
            type(tier)(0)
    with pytest.raises(ValueError, match="must be >= 1"):
        Args(kv_host_pages=0).validate()
    Args(kv_host_pages=4, kv_dtype="int8", kv_pages=512).validate()


def test_tier_metric_families_render_jax_text(monkeypatch):
    """The five cake_kv_* families (names, types, help, labels, buckets)
    are JAX's, and after the same operations (puts with evictions, pops,
    a resident-spill count, a scrape-time refresh against pools of the
    same bytes) fresh registries render the same text."""
    import jax.numpy as jnp
    from cake_tpu.kv import host_tier as jtier
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.paged import PagedKVCache as JCache
    from cake_tpu.obs import metrics as jmetrics
    from cake_tpu_torch.obs import metrics as tmetrics

    names = ("_HOST_PAGES", "_SPILLS", "_RESIDENT_SPILLS", "_SPILL_SECONDS",
             "_POOL_BYTES")
    regs = []
    for mod, m in ((jtier, jmetrics), (ttier, tmetrics)):
        reg = m.Registry()
        for attr in names:
            fam = getattr(mod, attr)
            kw = dict(registry=reg)
            if fam.typ == "histogram":
                kw["buckets"] = fam.buckets
            make = getattr(m, {"counter": "counter", "gauge": "gauge",
                               "histogram": "histogram"}[fam.typ])
            monkeypatch.setattr(mod, attr, make(fam.name, fam.help,
                                                fam.labelnames, **kw))
        regs.append(reg)
    for attr in names:
        a, b = getattr(jtier, attr), getattr(ttier, attr)
        assert (a.name, a.typ, a.help, tuple(a.labelnames)) == \
            (b.name, b.typ, b.help, tuple(b.labelnames))
    j, t = jtier.HostTier(4, page_bytes=64), HostTier(4, page_bytes=64)
    for op in list(_drive_tiers(11, j, t, n_ops=80)):
        assert op[1] == op[2]
    jtier.note_resident_spill()
    ttier.note_resident_spill()
    jc = JCache.create(JConfig.tiny(num_hidden_layers=2), 2, 7, PAGE, T,
                       dtype=jnp.float32)
    tc = PagedKVCache.create(LlamaConfig.tiny(num_hidden_layers=2), 2, 6,
                             PAGE, T, dtype=torch.float32, device="cpu")
    assert jc.memory_bytes() == tc.memory_bytes()
    jtier.refresh_gauges(jc, j)
    ttier.refresh_gauges(tc, t)
    assert regs[1].render() == regs[0].render()
    assert "cake_kv_host_pages" in regs[1].render()


# -- fetch / install, bit for bit ---------------------------------------------


POOLS = ("float32", "bfloat16", "f8_e4m3", "f8_e5m2", "int8", "int4")


def _raw(t):
    """A tensor's bytes (NaN bits compare equal)."""
    return t.contiguous().view(torch.uint8)


def _filled(fmt, cfg, n_pages, seed, bits=True):
    """A port cache of `fmt` whose every byte (the sink page's included)
    is random: with `bits` values of any bit pattern (NaNs too), else
    normal draws in the float leaves (XLA keeps no NaN payload)."""
    from cake_tpu_torch.utils.devices import resolve_kv_dtype, to_storage
    g = torch.Generator().manual_seed(seed)
    if fmt in QUANTIZED_CACHES:
        cache = QUANTIZED_CACHES[fmt].create(cfg, 2, n_pages, PAGE, T,
                                             device="cpu")
        leaves = (cache.k_store.q, cache.k_store.scale, cache.v_store.q,
                  cache.v_store.scale)
    else:
        cache = PagedKVCache.create(cfg, 2, n_pages, PAGE, T,
                                    dtype=resolve_kv_dtype(fmt),
                                    device="cpu")
        leaves = (cache.k_store, cache.v_store)
    for leaf in leaves:
        if leaf.dtype == torch.float32:
            leaf.copy_(torch.rand(leaf.shape, generator=g))
        elif bits or not leaf.is_floating_point():
            b = leaf.view(torch.uint8)
            b.copy_(torch.randint(0, 256, b.shape, generator=g,
                                  dtype=torch.uint8))
        else:
            leaf.copy_(to_storage(torch.randn(leaf.shape, generator=g),
                                  leaf.dtype))
    return cache, leaves


@pytest.mark.parametrize("fmt", POOLS)
def test_fetch_install_round_trip_bit_identical(fmt):
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    src, src_leaves = _filled(fmt, cfg, 8, 1)
    before = [x.clone() for x in src_leaves]
    dst, dst_leaves = _filled(fmt, cfg, 8, 2)
    sink = [x[:, -1].clone() for x in dst_leaves]
    untouched = [x.clone() for x in dst_leaves]
    arrays = HostTier.fetch_pages(src, [5, 1, 6])
    assert len(arrays) == (4 if fmt in QUANTIZED_CACHES else 2)
    HostTier.install_pages(dst, [2, 7, 0], arrays)
    for a, b, s, u in zip(src_leaves, dst_leaves, sink, untouched):
        for i, j in ((5, 2), (1, 7), (6, 0)):
            assert torch.equal(_raw(a[:, i]), _raw(b[:, j]))
        assert torch.equal(_raw(b[:, -1]), _raw(s))       # the sink
        for j in (1, 3, 4, 5, 6):            # pages not installed into
            assert torch.equal(_raw(b[:, j]), _raw(u[:, j]))
    for a, b in zip(src_leaves, before):     # the spill read only
        assert torch.equal(_raw(a), _raw(b))
    with pytest.raises(ValueError, match="real pages"):
        HostTier.fetch_pages(src, [8])       # the sink is never moved
    with pytest.raises(ValueError, match="does not fit"):
        HostTier.install_pages(dst, [1, 2], arrays)


@pytest.mark.parametrize("fmt", POOLS)
def test_fetched_arrays_are_jax_arrays(fmt):
    """The same pool bytes in both packages (JAX's pool is the port's
    real pages): fetch_pages gives JAX's arrays, in its order, of its
    shapes and bytes."""
    import jax.numpy as jnp
    from cake_tpu.kv.host_tier import HostTier as JTier
    from cake_tpu.kv.quantized_pool import QuantPool as JQPool
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.paged import PagedKVCache as JCache
    from cake_tpu.kv import quantized_pool as jq

    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    cache, leaves = _filled(fmt, cfg, 8, 3, bits=False)
    real = [x[:, :-1].contiguous() for x in leaves]
    jcfg = JConfig.tiny(num_hidden_layers=2)

    def jarr(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(
                jnp.bfloat16)
        if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            jd = (jnp.float8_e4m3fn if t.dtype == torch.float8_e4m3fn
                  else jnp.float8_e5m2)
            return jnp.asarray(t.view(torch.uint8).numpy()).view(jd)
        return jnp.asarray(t.numpy())

    if fmt in QUANTIZED_CACHES:
        jcls = (jq.Int4PagedKVCache if fmt == "int4"
                else jq.QuantizedPagedKVCache)
        jc = jcls.create(jcfg, 2, 8, PAGE, T)
        jc = jc._replace(k=JQPool(jarr(real[0]), jarr(real[1])),
                         v=JQPool(jarr(real[2]), jarr(real[3])))
    else:
        jc = JCache.create(jcfg, 2, 8, PAGE, T)
        jc = jc._replace(k=jarr(real[0]), v=jarr(real[1]))
    want = JTier.fetch_pages(jc, [6, 0, 3])
    got = HostTier.fetch_pages(cache, [6, 0, 3])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).rsplit(".", 1)[-1] == np.dtype(b.dtype).name
        np.testing.assert_array_equal(
            a.contiguous().view(torch.uint8).numpy().reshape(-1),
            np.ascontiguousarray(b).view(np.uint8).reshape(-1))
    assert isinstance(cache, Int4PagedKVCache) == (fmt == "int4")


# -- the engine against the JAX engine ----------------------------------------


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


def _jax_engine(models, sched=None, **kw):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.sched import SchedConfig as JCfg
    from cake_tpu.serve.engine import InferenceEngine as JEngine

    jc, jp, _, _ = models
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq_len", T)
    kw.setdefault("kv_pages", 8)
    if sched is not None:
        kw["sched_config"] = JCfg(**sched)
    return JEngine(jc, jp, JTok(jc.vocab_size),
                   sampling=JSampling(temperature=0.0, repeat_penalty=1.0),
                   cache_dtype=jnp.float32, kv_page_size=PAGE,
                   paged_attn="fold", kv_dtype="f32", **kw)


def _engine(models, sched=None, device="cpu", params=None, **kw):
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    _, _, tc, tp = models
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq_len", T)
    kw.setdefault("kv_pages", 8)
    if sched is not None:
        kw["sched_config"] = tsched.SchedConfig(**sched)
    return InferenceEngine(
        tc, params if params is not None else tp,
        ByteTokenizer(tc.vocab_size), device=device,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, kv_page_size=PAGE, kv_dtype="f32", **kw)


def _wait_tokens(handle, n, timeout=120.0):
    t0 = time.perf_counter()
    while (len(handle._req.out_tokens) < n
           and time.perf_counter() - t0 < timeout):
        time.sleep(0.001)
    assert len(handle._req.out_tokens) >= n, "victim never got going"


def _events(eng):
    """The tier's and the preemption's events, stripped of their clocks
    and sequence numbers, and of the tokens a victim had generated when
    the arrival preempted it (which depends on the host's timing)."""
    keep = ("kv_spill", "kv_restore", "preempted", "resident_spilled")
    return Counter(
        (e["type"],) + tuple(sorted(
            (k, v) for k, v in e.items()
            if k not in ("ts", "seq", "type", "generated")))
        for e in eng.events.dump() if e["type"] in keep)


def _preempt_drive(eng):
    """A batch stream preempted by an interactive arrival on one slot:
    the streams, the engine's tier counts and its events."""
    with eng:
        hb = eng.submit(BATCH_PROMPT, max_new_tokens=GEN, priority="batch")
        _wait_tokens(hb, 4)
        hi = eng.submit(INTER_PROMPT, max_new_tokens=4,
                        priority="interactive")
        assert hi.wait(timeout=300) and hb.wait(timeout=300)
        out = ([list(hb._req.out_tokens), list(hi._req.out_tokens)],
               (eng.stats.preemptions, eng.stats.kv_spills,
                eng.stats.kv_restores), _events(eng))
        assert eng._pager.free_pages == eng.cache.n_pages
        assert eng._host_tier.used_pages == 0
    return out


_JAX_RUNS: dict = {}


def _jax_once(key, fn):
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = fn()
    return _JAX_RUNS[key]


PREEMPT_KW = dict(max_slots=1, priority_classes=True, preemption=True,
                  kv_host_pages=8)


@pytest.mark.parametrize("scan", [1, 4])
@pytest.mark.parametrize("mixed", ["auto", "off"])
def test_preempt_spill_restore_token_identical_to_jax(models, mixed, scan,
                                                      tmp_path):
    """A batch stream preempted by an interactive arrival, its pages
    spilled to the host tier and restored at its re-admission: the
    streams are the JAX engine's (and an unpreempted run's), with one
    spill and one restore of the same pages, the same events, and the
    victim's trace holding `preempted` (spilled) and `kv_restored` but a
    single prefill."""
    want = _jax_once(("preempt", mixed), lambda: _preempt_drive(
        _jax_engine(models, sched=dict(preempt_budget=8),
                    mixed_batch=mixed, **PREEMPT_KW)))
    log = tmp_path / "trace.jsonl"
    eng = _engine(models, sched=dict(preempt_budget=8), mixed_batch=mixed,
                  decode_scan_steps=scan, trace_events=str(log),
                  **PREEMPT_KW)
    got = _preempt_drive(eng)
    assert got[0] == want[0]
    assert got[1] == want[1] == (1, 1, 1)
    assert got[2] == want[2]
    base = _engine(models, max_slots=1, mixed_batch=mixed)
    with base:
        h = base.submit(BATCH_PROMPT, max_new_tokens=GEN)
        assert h.wait(timeout=300)
    assert list(h._req.out_tokens) == got[0][0]
    victim = eng.events.dump(type="preempted")[0]
    assert victim["spilled"] is True
    names = [sp["name"] for sp in
             eng.tracer.dump(rid=victim["rid"])[0]["spans"]]
    assert "kv_restored" in names and names.count("prefill") == 2
    from cake_tpu_torch.obs.jsonl import read_jsonl
    lines = [x for x in read_jsonl(str(log)) if x["rid"] == victim["rid"]]
    assert any(x["event"] == "preempted" and x["spilled"] is True
               for x in lines)
    assert any(x["event"] == "kv_restored" and x["pages"] > 0
               for x in lines)


def test_spill_preempt_off_takes_the_fold(models):
    """SchedConfig(spill_preempt=False): the tier is there but the victim
    re-prefills its fold; the stream is the same."""
    eng = _engine(models, sched=dict(preempt_budget=8,
                                     spill_preempt=False), **PREEMPT_KW)
    got = _preempt_drive(eng)
    want = _jax_once(("preempt", "auto"), lambda: _preempt_drive(
        _jax_engine(models, sched=dict(preempt_budget=8),
                    mixed_batch="auto", **PREEMPT_KW)))
    assert got[0] == want[0]
    assert got[1] == (1, 0, 0)


def test_failed_spill_is_logged_counted_and_takes_the_fold(models,
                                                           monkeypatch,
                                                           caplog):
    eng = _engine(models, sched=dict(preempt_budget=8), **PREEMPT_KW)

    def broken(cache, pages):
        raise RuntimeError("copy failed")

    monkeypatch.setattr(HostTier, "fetch_pages", staticmethod(broken))
    with caplog.at_level("ERROR"):
        got = _preempt_drive(eng)
    assert got[1] == (1, 0, 0)
    assert eng.stats.kv_spill_failures == 1
    assert "victim spill failed" in caplog.text
    want = _jax_once(("preempt", "auto"), lambda: _preempt_drive(
        _jax_engine(models, sched=dict(preempt_budget=8),
                    mixed_batch="auto", **PREEMPT_KW)))
    assert got[0] == want[0]


def _cold_prefix_drive(eng, evict=False):
    """A registered 2-page prefix, two 4-page requests oversubscribing the
    6-page pool (the prefix must spill), then a prompt that starts with
    the prefix (its pages stream back, or with `evict` its host entry is
    gone first and the prompt prefills whole)."""
    with eng:
        pid = eng.register_prefix(PREFIX)
        assert eng._pager.free_pages == 4
        h1 = eng.submit([9] * 24, max_new_tokens=40)
        h2 = eng.submit([8] * 24, max_new_tokens=40)
        assert h1.wait(timeout=300) and h2.wait(timeout=300)
        assert eng.stats.kv_spills >= 1
        with eng._rid_lock:
            assert eng._prefixes[pid][1] is None          # spilled
        if evict:
            eng._host_tier.drop(("prefix", pid))          # "LRU-evicted"
        hits = eng.stats.prefix_hits
        h3 = eng.submit(PREFIX + [7] * 5, max_new_tokens=4)
        assert h3.wait(timeout=300)
        out = dict(streams=[list(h._req.out_tokens) for h in (h1, h2, h3)],
                   hit=eng.stats.prefix_hits - hits,
                   restores=eng.stats.kv_restores)
        with eng._rid_lock:
            out["registered"] = pid in eng._prefixes
            out["mapped"] = (out["registered"]
                             and eng._prefixes[pid][1] is not None)
        if out["mapped"]:
            eng.unregister_prefix(pid)
        assert eng._pager.free_pages == eng.cache.n_pages
    return out


COLD_KW = dict(max_seq_len=128, kv_pages=6, kv_host_pages=4)


@pytest.mark.parametrize("mixed", ["auto", "off"])
def test_cold_prefix_spills_and_restores_like_jax(models, mixed):
    want = _jax_once(("cold", mixed), lambda: _cold_prefix_drive(
        _jax_engine(models, mixed_batch=mixed, **COLD_KW)))
    got = _cold_prefix_drive(_engine(models, mixed_batch=mixed, **COLD_KW))
    assert got == want
    assert got["hit"] == 1 and got["restores"] >= 1 and got["mapped"]


@pytest.mark.parametrize("mixed", ["auto", "off"])
def test_evicted_prefix_degrades_to_whole_prompt_prefill(models, mixed):
    """A spilled prefix whose host entry is gone: the admission drops the
    stale hit before dispatch and prefills the whole prompt (the stream
    an engine without the prefix gives), and the registration goes."""
    want = _jax_once(("evict", mixed), lambda: _cold_prefix_drive(
        _jax_engine(models, mixed_batch=mixed, **COLD_KW), evict=True))
    got = _cold_prefix_drive(_engine(models, mixed_batch=mixed, **COLD_KW),
                             evict=True)
    assert got == want
    assert got["hit"] == 0 and not got["registered"]
    ref = _engine(models, max_seq_len=128, mixed_batch=mixed)
    with ref:
        h = ref.submit(PREFIX + [7] * 5, max_new_tokens=4)
        assert h.wait(timeout=300)
    assert got["streams"][2] == list(h._req.out_tokens)


RESIDENT_PROMPTS = [[5] * 9, [3, 7, 9, 11, 2]]
RESIDENT_MODES = {"fifo": dict(mixed_batch="off"),
                  "mixed": dict(mixed_batch="on"),
                  "slo": dict(priority_classes=True)}


def _resident_drive(eng):
    with eng:
        hs = [eng.submit(p, max_new_tokens=20) for p in RESIDENT_PROMPTS]
        assert all(h.wait(timeout=300) for h in hs)
        assert all(h._req.error is None for h in hs)
        assert eng._pager.free_pages == eng.cache.n_pages
        if eng._host_tier is not None:
            assert eng._host_tier.used_pages == 0
        return ([list(h._req.out_tokens) for h in hs],
                eng.stats.kv_resident_spills, eng.stats.kv_restores)


@pytest.mark.parametrize("scan", [1, 4])
@pytest.mark.parametrize("mode", sorted(RESIDENT_MODES))
def test_resident_spill_token_identical_to_jax(models, mode, scan):
    """A 2-page pool serving two 2-page streams: the least recently
    admitted decoding stream parks in the host tier so the other admits,
    they time-slice the pool in resident_quantum turns, and both streams
    are the JAX engine's and a non-oversubscribed run's."""
    kw = RESIDENT_MODES[mode]
    want = _jax_once(("resident", mode), lambda: _resident_drive(
        _jax_engine(models, kv_pages=2, kv_host_pages=8, **kw)))
    base = _resident_drive(_engine(models, decode_scan_steps=scan, **kw))
    assert base[1] == 0
    got = _resident_drive(_engine(models, kv_pages=2, kv_host_pages=8,
                                  decode_scan_steps=scan, **kw))
    assert got[1] >= 1, "no stream was ever parked"
    assert got[2] >= 1, "parked pages never streamed back"
    assert [len(t) for t in got[0]] == [20, 20]
    assert got[0] == want[0] == base[0]


@pytest.mark.parametrize("quantum", [2, 8])
def test_resident_quantum_and_disable(models, quantum):
    """A larger quantum parks less often (the turns are longer), as in
    JAX; spill_resident=False parks nothing (the pool serves the two
    streams one after the other)."""
    want = _jax_once(("quantum", quantum), lambda: _resident_drive(
        _jax_engine(models, kv_pages=2, kv_host_pages=8,
                    mixed_batch="off",
                    sched=dict(resident_quantum=quantum))))
    got = _resident_drive(_engine(models, kv_pages=2, kv_host_pages=8,
                                  mixed_batch="off",
                                  sched=dict(resident_quantum=quantum)))
    assert got == want
    off = _resident_drive(_engine(models, kv_pages=2, kv_host_pages=8,
                                  sched=dict(spill_resident=False)))
    assert off[1] == 0 and off[0] == got[0]


def test_cancel_and_failure_drop_the_victims_entry(models):
    """A parked victim's entry goes with its cancellation, and _fail_all
    clears the tier (the engine not started: its queue only)."""
    eng = _engine(models, kv_host_pages=8)
    ent = SpilledPages(n_pages=1, arrays=(torch.zeros(1),), kind="victim")
    hs = [eng.submit([5] * 4, max_new_tokens=2) for _ in range(2)]
    for h in hs:
        eng._host_tier.put(("victim", h._req.rid), ent)
    eng.cancel(hs[0])
    eng._drain_cancellations()
    assert eng._host_tier.keys() == [("victim", hs[1]._req.rid)]
    eng._fail_all(RuntimeError("boom"))
    assert eng._host_tier.used_pages == 0 and hs[1]._req.error is not None


# -- on the card --------------------------------------------------------------


def _card_params(device):
    from cake_tpu_torch.models.llama.params import init_params
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    return {k: ({n: t.to(device) for n, t in v.items()}
                if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


@pytest.mark.cuda
def test_cuda_spills_restores_and_parks_add_no_sync(models):
    """A wave of preempt-spills, restores and resident parks on the card
    whose every `_maybe_preempt`, `_alloc_slot_pages` and `_mixed_admit`
    runs under `torch.cuda.set_sync_debug_mode("error")`: no spill,
    install or park waits for the stream. Streams equal the CPU
    engine's; the spills, restores and parks happened, and every device
    and host page comes back."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    guarded = Counter()
    runs = []
    for device in ("cpu", "cuda"):
        eng = _engine(models, device=device, params=_card_params(device),
                      max_slots=3, max_seq_len=128, kv_pages=7,
                      prefill_chunk=8, kv_host_pages=16,
                      priority_classes=True, preemption=True,
                      sched=dict(preempt_budget=8, resident_quantum=4))

        def guard(name, fn):
            def wrapped(*a):
                if device != "cuda":
                    return fn(*a)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(*a)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    guarded[name] += 1
            return wrapped

        for name in ("_maybe_preempt", "_alloc_slot_pages", "_mixed_admit"):
            setattr(eng, name, guard(name, getattr(eng, name)))
        with eng:
            eng.submit([4] * 20, max_new_tokens=4).wait(300)   # warm-up
            hs = [eng.submit([5 + i] * 20, max_new_tokens=40,
                             priority="batch") for i in range(2)]
            for h in hs:
                _wait_tokens(h, 9)
            hs.append(eng.submit([6] * 30, max_new_tokens=30,
                                 priority="interactive"))
            _wait_tokens(hs[-1], 2)
            hs.append(eng.submit([7] * 30, max_new_tokens=30,
                                 priority="standard"))
            assert all(h.wait(timeout=300) for h in hs)
            runs.append(([list(h._req.out_tokens) for h in hs],
                         eng.stats.kv_spills, eng.stats.kv_restores))
            assert eng._pager.free_pages == 7
            assert eng._host_tier.used_pages == 0
    assert runs[1] == runs[0]
    assert runs[1][1] >= 1 and runs[1][2] >= 1
    assert guarded["_maybe_preempt"] > 0 and guarded["_mixed_admit"] >= 4
    assert guarded["_alloc_slot_pages"] >= 4
    # cake_kv_spill_seconds took every movement's device time, once the
    # stream had passed its events
    torch.cuda.synchronize()
    ttier.observe_spill_times()
    assert not ttier._PENDING
    assert ttier._SPILL_SECONDS.child_samples()[()]["count"] >= \
        runs[1][1] + runs[1][2]
