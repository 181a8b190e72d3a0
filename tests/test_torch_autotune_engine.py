"""The port engine's live reconfiguration (`InferenceEngine.reconfigure`,
the autotune seam) against the JAX paged engine's, the cases of
tests/test_autotune_engine.py that apply to the paged engine.

The engines run the tiny config (2 layers, f32 params and KV, greedy,
16-token pages):

  * greedy streams served ACROSS a live switch (slots, decode_scan, pool
    pages, page size, mixed batching) emit the tokens an uninterrupted
    run emits and the JAX engine's across the same switch, shared-prefix
    slots included; the pool is conserved;
  * the precision-widening directions are refused with JAX's reason,
    the narrowing ones land;
  * a matching switch keeps the host tier's victim entries, a storage
    change clears them;
  * a pool an in-flight stream does not fit refuses the switch, and
    nothing moves; a no-op switch is False; a spec engine is refused and
    a dense target lands; a switch during a switch is SwitchInFlightError;
  * a rebuild whose new pool raises restores the previous config and
    carries every stream; the FIFO's queue plus its active slots are
    carried; a manual switch syncs the auto controller;
  * random submits, cancels and switches leave no error and a conserved
    pool;
  * the /api/v1/autotune contract, over HTTP;
  * the journal's admit records carry the live epoch, and the snapshot
    the engine config and epoch, as JAX's do.

The `cuda` cases (the card engine across switches against the CPU
engine, one capture per new variant, and a switch's memory peak) skip
without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_autotune_engine.py
"""

import json
import random
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.serve.errors import SwitchInFlightError

T = 64
PAGE = 16
PROMPT = [5, 9, 2, 7, 5, 3, 11, 4, 6]


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


def _engine(models, device="cpu", params=None, **kw):
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    _, _, tc, tp = models
    kw.setdefault("max_slots", 2)
    kw.setdefault("kv_pages", 16)
    kw.setdefault("kv_page_size", PAGE)
    return InferenceEngine(
        tc, params if params is not None else tp,
        ByteTokenizer(tc.vocab_size), device=device, max_seq_len=T,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, **kw)


def _jax_engine(models, **kw):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.serve.engine import InferenceEngine as JEngine

    jc, jp, _, _ = models
    kw.setdefault("max_slots", 2)
    kw.setdefault("kv_pages", 16)
    kw.setdefault("kv_page_size", PAGE)
    return JEngine(jc, jp, JTok(jc.vocab_size), max_seq_len=T,
                   sampling=JSampling(temperature=0.0, repeat_penalty=1.0),
                   cache_dtype=jnp.float32, paged_attn="fold", **kw)


def _wait_tokens(handle, n, timeout=120.0):
    t0 = time.perf_counter()
    while (len(handle._req.out_tokens) < n
           and time.perf_counter() - t0 < timeout):
        time.sleep(0.001)
    assert len(handle._req.out_tokens) >= n, "stream never got going"


def _jax_cfg(cfg: dict) -> dict:
    return {**cfg, "paged_attn": "fold"}


PREFIX = [7] * PAGE
PROMPTS = [PREFIX + [5, 3, 9], PREFIX + [4, 8, 2, 6], [2, 9, 4, 7, 3]]
# one switch a case, each after the streams have tokens; the last moves
# everything at once
SWITCHES = {
    "slots_scan": [dict(slots=4, decode_scan=3, kv_pages=16,
                        kv_page_size=PAGE)],
    "pages_page_size": [dict(slots=2, kv_pages=40, kv_page_size=8)],
    "mixed_off_on": [dict(slots=2, kv_pages=16, kv_page_size=PAGE,
                          mixed_batch="off"),
                     dict(slots=3, kv_pages=16, kv_page_size=PAGE,
                          mixed_batch="auto")],
    "shrink_all": [dict(slots=1, decode_scan=4, kv_pages=12,
                        kv_page_size=8)],
}


def _run(eng, switches, n_new=16, at=4, prefix=True, then=None):
    """Streams of PROMPTS (a registered shared prefix), each switch once
    the first stream has `at` more tokens; the tokens and the engine's
    page accounting after every stream retired. then(eng) runs before
    the engine stops."""
    with eng:
        if prefix:
            eng.register_prefix(PREFIX)
        hs = [eng.submit(p, max_new_tokens=n_new) for p in PROMPTS]
        for i, cfg in enumerate(switches):
            _wait_tokens(hs[0], at * (i + 1))
            assert eng.reconfigure(cfg) is True
        assert all(h.wait(120) for h in hs)
        assert [h._req.error for h in hs] == [None] * len(hs)
        pages = (eng._pager.free_pages, eng._pager.n_pages)
        if then is not None:
            then(eng)
    return [list(h._req.out_tokens) for h in hs], pages


@pytest.fixture(scope="module")
def uninterrupted(models):
    toks, _ = _run(_engine(models), [])
    return toks


@pytest.mark.parametrize("case", sorted(SWITCHES))
def test_streams_across_a_switch_are_the_uninterrupted_ones(
        models, uninterrupted, case):
    eng = _engine(models)
    toks, (free, total) = _run(eng, SWITCHES[case])
    assert toks == uninterrupted
    # the registry was cleared by the switch: every page came back
    assert free == total == SWITCHES[case][-1]["kv_pages"]
    assert eng.config_epoch == len(SWITCHES[case])
    assert eng.stats.config_switches == len(SWITCHES[case])
    got = eng.current_config()
    want = SWITCHES[case][-1]
    assert (got.slots, got.kv_pages, got.kv_page_size) == (
        want["slots"], want["kv_pages"], want["kv_page_size"])
    assert got.mixed_batch == ("off" if want.get("mixed_batch") == "off"
                               else "on")
    # a carried stream's trace holds its admission epoch and the switch
    rec = eng.tracer.get(eng.retired[0].rid)
    assert rec["config_epoch"] == 0
    assert any(s["name"] == "reconfigured" for s in rec["spans"])


def test_streams_match_the_jax_engine_across_the_same_switch(
        models, uninterrupted):
    cfg = SWITCHES["shrink_all"][0]
    jeng = _jax_engine(models)
    with jeng:
        jeng.register_prefix(PREFIX)
        hs = [jeng.submit(p, max_new_tokens=16) for p in PROMPTS]
        _wait_tokens(hs[0], 4)
        assert jeng.reconfigure(_jax_cfg(cfg)) is True
        assert all(h.wait(120) for h in hs)
        theirs = [list(h._req.out_tokens) for h in hs]
    ours, _ = _run(_engine(models), [cfg])
    assert ours == theirs == uninterrupted


def test_widening_directions_are_refused_narrowing_lands(models):
    eng = _engine(models, kv_pages=8, kv_page_size=32, kv_dtype="int8")
    base = dict(slots=2, kv_pages=8, kv_page_size=32)
    with pytest.raises(ValueError, match="int8-pool -> float-pool"):
        eng.reconfigure(base)
    assert eng.reconfigure(dict(base, slots=4, kv_dtype="int8")) is True
    assert eng.reconfigure(dict(base, kv_dtype="int4")) is True
    assert eng.cache.k_store.q.dtype == torch.uint8   # the packed pool
    with pytest.raises(ValueError, match="int4-pool -> int8-pool"):
        eng.reconfigure(dict(base, kv_dtype="int8"))
    with pytest.raises(ValueError, match="int4-pool -> float-pool"):
        eng.reconfigure(dict(base, kv_dtype="f8_e4m3"))
    assert eng.config_epoch == 2
    # float -> fp8 narrows nothing a guard cares about: allowed
    f = _engine(models)
    assert f.reconfigure(dict(slots=2, kv_pages=16, kv_page_size=PAGE,
                              kv_dtype="f8_e4m3")) is True
    assert f.cache.k_store.dtype == torch.float8_e4m3fn


def test_switch_keeps_matching_host_tier_victims(models):
    from cake_tpu_torch.kv.host_tier import HostTier, SpilledPages

    eng = _engine(models, kv_pages=8, kv_dtype="int8", kv_host_pages=8)
    arrays = HostTier.fetch_pages(eng.cache, [0, 1])
    tier = eng._host_tier
    assert tier.put(("victim", 7), SpilledPages(2, arrays, "victim"))
    assert tier.put(("prefix", 3), SpilledPages(2, arrays, "prefix"))
    # same page size and storage, page count and slots move: the victim
    # entry survives (the tier itself is kept), the prefix entry dies
    assert eng.reconfigure(dict(slots=4, kv_pages=12, kv_page_size=PAGE,
                                kv_dtype="int8")) is True
    assert eng._host_tier is tier
    assert eng._host_tier.peek(("victim", 7)) is not None
    assert eng._host_tier.peek(("prefix", 3)) is None
    # int8 -> int4: every entry is old-pool bytes now; the new tier's
    # page bytes follow the new storage
    assert eng.reconfigure(dict(slots=4, kv_pages=12, kv_page_size=PAGE,
                                kv_dtype="int4")) is True
    assert eng._host_tier.used_pages == 0
    assert eng._host_tier.page_bytes < tier.page_bytes


def test_switch_refused_when_a_stream_cannot_fit(models):
    with _engine(models) as eng:
        h = eng.submit(PROMPT, max_new_tokens=30)       # 3 pages
        _wait_tokens(h, 2)
        with pytest.raises(ValueError, match="no stream may be dropped"):
            eng.reconfigure(dict(slots=2, kv_pages=2, kv_page_size=PAGE))
        assert eng.cache.n_pages == 16 and eng.config_epoch == 0
        assert h.wait(120) and h._req.error is None


def test_noop_unknown_knob_dense_target_and_spec_refusal(models):
    eng = _engine(models)
    assert eng.reconfigure(eng.current_config()) is False
    # the same config spelled with auto knobs and the base dtype
    assert eng.reconfigure(dict(slots=2, kv_pages=16, kv_page_size=PAGE,
                                kv_dtype="f32", paged_attn="auto",
                                mixed_batch="on")) is False
    assert eng.config_epoch == 0
    with pytest.raises(ValueError, match="unknown engine config"):
        eng.reconfigure({"slotz": 4})
    # a dense point lands (the dense engine, as in JAX), and the same
    # point again is a no-op
    assert eng.reconfigure({"slots": 4}) is True
    assert not eng.paged and eng._pager is None
    assert eng.current_config().kv_pages is None and eng.config_epoch == 1
    assert eng.reconfigure({"slots": 4, "kv_page_size": 64}) is False
    with pytest.raises(ValueError, match="'plain'"):
        eng.reconfigure(dict(slots=2, kv_pages=16, paged_attn="fold"))
    with pytest.raises(ValueError, match="CUDA device"):
        eng.reconfigure(dict(slots=2, kv_pages=16, paged_attn="kernel"))
    _, _, tc, tp = models
    spec = _engine(models, spec_draft_params=tp, spec_draft_config=tc,
                   autotune="manual")
    assert spec.autotune_mode == "off"      # disabled with a warning
    with pytest.raises(ValueError, match="speculative"):
        spec.reconfigure(dict(slots=4, kv_pages=16))


def test_switch_in_flight_is_exclusive(models):
    with _engine(models) as eng:
        h = eng.submit(PROMPT, max_new_tokens=8)
        eng._switch_inflight = True
        try:
            with pytest.raises(SwitchInFlightError):
                eng.reconfigure(dict(slots=4, kv_pages=16))
        finally:
            eng._switch_inflight = False
        assert h.wait(120)


def test_failed_rebuild_restores_the_previous_config(models,
                                                     uninterrupted):
    with _engine(models) as eng:
        eng.register_prefix(PREFIX)
        hs = [eng.submit(p, max_new_tokens=16) for p in PROMPTS]
        _wait_tokens(hs[0], 4)
        real, calls = eng._new_cache, []

        def once(n_pages, page_size):
            calls.append((n_pages, page_size))
            if len(calls) == 1:
                raise torch.OutOfMemoryError("synthetic pool OOM")
            return real(n_pages, page_size)

        eng._new_cache = once
        with pytest.raises(ValueError, match="previous config restored"):
            eng.reconfigure(dict(slots=4, kv_pages=64, kv_page_size=8))
        assert calls == [(64, 8), (16, PAGE)]
        assert (eng.max_slots, eng.cache.n_pages, eng._pager.page_size) \
            == (2, 16, PAGE)
        assert eng.config_epoch == 0 and eng.stats.config_switches == 0
        assert all(h.wait(120) for h in hs)
        assert [list(h._req.out_tokens) for h in hs] == uninterrupted


def test_fifo_switch_carries_a_full_queue_plus_active_slots(models):
    with _engine(models, max_queue=2) as eng:
        hs = [eng.submit([5 + i] * 6, max_new_tokens=10) for i in range(2)]
        _wait_tokens(hs[0], 2)
        _wait_tokens(hs[1], 1)
        hs += [eng.submit([9 + i] * 6, max_new_tokens=10)
               for i in range(2)]
        assert eng.reconfigure(dict(slots=3, kv_pages=16,
                                    kv_page_size=PAGE)) is True
        assert all(h.wait(120) for h in hs)
        assert [h._req.error for h in hs] == [None] * 4


def test_manual_switch_syncs_the_auto_controller(models):
    from cake_tpu_torch.autotune import config_key

    policy = {"version": 1, "regimes": [
        {"max_offered_rps": None,
         "config": {"slots": 2, "kv_pages": 16, "kv_page_size": PAGE}}]}
    eng = _engine(models, autotune="auto", autotune_policy=policy)
    assert eng.reconfigure(dict(slots=4, kv_pages=16, kv_page_size=PAGE),
                           reason="manual") is True
    assert (config_key(eng._autotuner._current)
            == config_key(eng.current_config()))
    assert eng._autotuner._guard is None


def test_random_submits_cancels_and_switches(models):
    configs = [dict(slots=2, kv_pages=16, kv_page_size=PAGE),
               dict(slots=3, kv_pages=24, kv_page_size=8, decode_scan=2)]
    rng = random.Random(11)
    eng = _engine(models, priority_classes=True)
    live, done = [], []
    with eng:
        for _ in range(60):
            op = rng.random()
            if op < 0.55:
                live.append(eng.submit(
                    [rng.randrange(3, 60)
                     for _ in range(rng.randrange(3, 12))],
                    max_new_tokens=rng.randrange(2, 8),
                    priority=rng.choice(["interactive", "batch"])))
            elif op < 0.75 and live:
                eng.cancel(live.pop(rng.randrange(len(live))))
            elif op < 0.85:
                eng.reconfigure(configs[eng.cache.n_pages == 16])
            live = [h for h in live
                    if not (h._req.done.is_set() and done.append(h))]
        assert all(h.wait(180) for h in live)
        done.extend(live)
        assert [h for h in done if h._req.error is not None] == []
        deadline = time.perf_counter() + 30
        while (eng._pager.free_pages != eng.cache.n_pages
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        assert eng._pager.free_pages == eng.cache.n_pages
        assert eng.stats.config_switches > 0


def _http(url, body=None):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _Master:
    args = None


def test_api_autotune_contract(models):
    from cake_tpu_torch.api.server import start

    eng = _engine(models, autotune="manual")
    httpd = start(_Master(), "127.0.0.1:0", block=False, engine=eng)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/api/v1"
    try:
        code, h = _http(url + "/health")
        assert code == 200 and h["config_epoch"] == 0
        assert h["autotune"] == "manual" and h["switch_in_flight"] is False
        assert h["engine_config"]["slots"] == 2
        code, st = _http(url + "/autotune")
        assert code == 200 and st["mode"] == "manual"
        assert st["switches"] == 0
        code, out = _http(url + "/autotune", {"config": dict(
            slots=4, kv_pages=16, kv_page_size=PAGE)})
        assert code == 200 and out["switched"] and out["epoch"] == 1
        assert _http(url + "/health")[1]["engine_config"]["slots"] == 4
        assert _http(url + "/autotune")[1]["switch_log"][-1][
            "reason"] == "manual"
        for body in ({}, {"config": {"slots": 4, "mixed_batch": "on"}},
                     {"config": {"slots": 2, "kv_pages": 16,
                                 "kv_dtype": "int8"}}):
            assert _http(url + "/autotune", body)[0] == 400
        code, _ = _http(url + "/autotune", {"config": dict(
            slots=2, kv_pages=16, kv_page_size=PAGE, kv_dtype="int8")})
        assert code == 200
        code, err = _http(url + "/autotune", {"config": dict(
            slots=2, kv_pages=16, kv_page_size=PAGE)})
        assert code == 400 and "int8-pool -> float-pool" in err["error"]
        eng._switch_inflight = True
        code, err = _http(url + "/autotune", {"config": dict(
            slots=2, kv_pages=20, kv_page_size=PAGE, kv_dtype="int8")})
        eng._switch_inflight = False
        assert code == 409 and "in flight" in err["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
    off = _engine(models)
    httpd = start(_Master(), "127.0.0.1:0", block=False, engine=off)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/api/v1"
    try:
        assert _http(url + "/health")[1]["autotune"] == "off"
        code, err = _http(url + "/autotune", {"config": dict(
            slots=4, kv_pages=16)})
        assert code == 400 and "autotune is off" in err["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def _epochs(path):
    with open(path) as f:
        return [(r["rid"], r["epoch"]) for r in map(json.loads, f)
                if r.get("rec") == "admit"]


def test_journal_epoch_and_snapshot_config_match_jax(models, tmp_path):
    from cake_tpu.serve import checkpoint as jckpt
    from cake_tpu_torch.serve import checkpoint as ckpt

    cfg = dict(slots=3, kv_pages=24, kv_page_size=8)
    got = []
    for name, make, switch, mod in (
            ("theirs", lambda **kw: _jax_engine(models, **kw),
             _jax_cfg(cfg), jckpt),
            ("ours", lambda **kw: _engine(models, **kw), cfg, ckpt)):
        path = str(tmp_path / f"{name}.jsonl")
        eng = make(journal=path)
        with eng:
            a = eng.submit(PROMPT, max_new_tokens=6)
            assert a.wait(120)
            assert eng.reconfigure(switch) is True
            b = eng.submit(PROMPT[:5], max_new_tokens=6)
            assert b.wait(120)
        snap = mod.snapshot(eng)
        conf = dict(snap["engine_config"])
        conf["paged_attn"] = None        # fold / plain: the impl names
        got.append((_epochs(path), conf, snap["config_epoch"]))
    assert got[0] == got[1]
    assert got[1][0] == [(1, 0), (2, 1)] and got[1][2] == 1


# -- the card ---------------------------------------------------------------


def _card_params(device):
    from cake_tpu_torch.models.llama.params import init_params
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    return {k: ({n: t.to(device) for n, t in v.items()}
                if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


def _card_models():
    return (None, None, LlamaConfig.tiny(num_hidden_layers=2), None)


@pytest.mark.cuda
def test_cuda_engine_across_switches_matches_the_cpu_engine():
    """The card engine across every switch kind against the CPU engine
    with the same switches: the same streams; after each switch each new
    variant is captured once (counted under its JAX function), and a
    second wave at the last config captures nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    switches = [dict(slots=4, decode_scan=3, kv_pages=16,
                     kv_page_size=PAGE),
                dict(slots=2, kv_pages=40, kv_page_size=8,
                     mixed_batch="off"),
                dict(slots=3, kv_pages=24, kv_page_size=8)]
    def warm(eng):
        caps = len(eng.events.dump(type="recompile"))
        hs = [eng.submit(p, max_new_tokens=8) for p in PROMPTS]
        assert all(h.wait(300) for h in hs)
        warm.captures = (caps,
                         len(eng.events.dump(type="recompile")) - caps)

    runs = []
    for device in ("cpu", "cuda"):
        eng = _engine(_card_models(), device=device,
                      params=_card_params(device))
        toks, _ = _run(eng, switches, prefix=False, then=warm)
        runs.append(toks)
    assert eng.paged_attn == "kernel"
    assert warm.captures[0] > 0 and warm.captures[1] == 0
    assert runs[1] == runs[0]


@pytest.mark.cuda
def test_cuda_switch_frees_the_old_pool_before_the_new_one():
    """A switch's torch.cuda.max_memory_allocated stays at most a tenth
    of the larger pool above max(held before, held after): the old pool
    and its graphs go before the new pool is allocated."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    eng = _engine(_card_models(), device="cuda",
                  params=_card_params("cuda"), kv_pages=2048)
    with eng:
        assert eng.submit(PROMPT, max_new_tokens=8).wait(300)
        for cfg in (dict(slots=4, kv_pages=4096, kv_page_size=PAGE),
                    dict(slots=2, kv_pages=1024, kv_page_size=PAGE)):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            old = eng.cache.memory_bytes()
            torch.cuda.reset_peak_memory_stats()
            assert eng.reconfigure(cfg) is True
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            after = torch.cuda.memory_allocated()
            pool = max(old, eng.cache.memory_bytes())
            assert peak <= max(before, after) + 0.1 * pool, (
                before, peak, after, pool)
            assert eng.submit(PROMPT, max_new_tokens=8).wait(300)
