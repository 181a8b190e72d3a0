"""The port engine's crash recovery against the JAX engine's
(`cake_tpu/serve/engine.py` `_attempt_recovery` and its seams).

The engines run the tiny config (2 layers, f32 params and KV, greedy,
16-token pages) under the same `--fault-plan`s, with every request
submitted before the engine starts, so both plan the same iterations:

  * recoveries, requests recovered and poison counts equal JAX's, and
    every stream is JAX's and the one a run without the plan gives, at
    `--mixed-batch` auto and off and `decode_scan` 1 and 4;
  * a fault while the host tier holds a spilled preemption victim: the
    reset clears the tier, the victim comes back by the recompute fold,
    its stream unchanged;
  * a request implicated in implication_budget consecutive failures is
    quarantined with PoisonRequestError (not retryable), the others
    complete;
  * a reset storm trips the breaker: the engine stops with a snapshot
    holding every in-flight request, and a fresh engine restores it to
    the uninterrupted streams;
  * a rebuild that itself fails stops the engine with a snapshot, no
    thread dies, and `/api/v1/health` reports it; the snapshot path
    calls nothing on the device;
  * when the in-place reset raises, the old pool is unreferenced (a
    weakref) when the fallback rebuild allocates the new one, after an
    injected fault and after a runner that raises;
  * one failed step implicates a request once (the JAX engine counts a
    mid-prefill slot twice and quarantines it: a pinned divergence);
  * `recovery=False` (--no-recovery) fails everything with retryable
    errors, as before, and serves on.

The `cuda` cases (the card engine recovering across a burst and a mixed
replay against the CPU engine, capturing no graph anew; a silent plan
under
`torch.cuda.set_sync_debug_mode("error")`) skip without a card. The JAX
package is imported inside the cases that use it:

    python -m pytest --noconftest -m cuda tests/test_torch_recovery.py
"""

import json
import threading
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest

import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.serve.errors import (
    EngineResetError, PoisonRequestError, RecoveryConfig,
)

T = 64
PAGE = 16
PROMPTS = ([5] * 9, [2, 9, 4, 7, 3], [7, 7, 1, 2])
GEN = 12
# no backoff between consecutive resets (the policy is tested apart)
FAST = dict(backoff_base_s=0.0, backoff_cap_s=0.0)
PLAN = ("seed=15;engine.mixed:nth=3:transient;engine.decode:nth=5:oom;"
        "engine.step:step=9:transient")


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


def _jax_engine(models, rcfg=None, sched=None, **kw):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.sched import SchedConfig as JSched
    from cake_tpu.serve.engine import InferenceEngine as JEngine
    from cake_tpu.serve.errors import RecoveryConfig as JRecovery

    jc, jp, _, _ = models
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq_len", T)
    kw.setdefault("kv_pages", 8)
    if sched is not None:
        kw["sched_config"] = JSched(**sched)
    return JEngine(jc, jp, JTok(jc.vocab_size),
                   sampling=JSampling(temperature=0.0, repeat_penalty=1.0),
                   cache_dtype=jnp.float32, kv_page_size=PAGE,
                   paged_attn="fold", kv_dtype="f32",
                   recovery_config=JRecovery(**(rcfg or FAST)), **kw)


def _engine(models, rcfg=None, sched=None, device="cpu", params=None,
            recovery=True, **kw):
    from cake_tpu_torch import sched as tsched
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
        cache_dtype=torch.float32, kv_page_size=PAGE, kv_dtype="f32",
        recovery=recovery, recovery_config=RecoveryConfig(**(rcfg or FAST)),
        **kw)


def _drive(eng, prompts=PROMPTS, gen=GEN):
    """Every prompt submitted before the engine starts; the streams, the
    errors' classes and the recovery counts."""
    hs = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    with eng:
        for h in hs:
            assert h.wait(timeout=300)
        assert eng._pager.free_pages == eng._pager.n_pages
    return ([list(h._req.out_tokens) for h in hs],
            [type(h._req.error).__name__ if h._req.error else None
             for h in hs],
            (eng.stats.recoveries, eng.stats.requests_recovered,
             eng.stats.poisoned))


_JAX_RUNS: dict = {}


def _jax_once(key, fn):
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = fn()
    return _JAX_RUNS[key]


@pytest.mark.parametrize("scan", [1, 4])
@pytest.mark.parametrize("mixed", ["auto", "off"])
def test_recovery_matches_jax(models, mixed, scan):
    want = _jax_once(("plan", mixed, scan), lambda: _drive(_jax_engine(
        models, fault_plan=PLAN, mixed_batch=mixed,
        decode_scan_steps=scan)))
    eng = _engine(models, fault_plan=PLAN, mixed_batch=mixed,
                  decode_scan_steps=scan, event_ring=256)
    got = _drive(eng)
    assert got == want
    assert got[2][0] >= 2 and got[1] == [None] * len(PROMPTS)
    clean = _drive(_engine(models, mixed_batch=mixed,
                           decode_scan_steps=scan))
    assert got[0] == clean[0]
    # the events and the trace spans of the resubmits
    recovered = eng.events.dump(type="recovered")
    assert len(recovered) == got[2][1]
    fired = eng.events.dump(type="fault_injected")
    assert len(fired) == got[2][0]
    rid = recovered[0]["rid"]
    names = [sp["name"] for sp in eng.tracer.dump(rid=rid)[0]["spans"]]
    assert "crash_recovered" in names
    assert eng.recovery_seconds and len(eng.recovery_seconds) == got[2][0]
    st = eng.recovery_state()
    assert st["recoveries"] == got[2][0] and not st["breaker"]["tripped"]
    assert st["fault_plan"]["injections_total"] == got[2][0]


def _spill_drive(eng, clear_log):
    """One slot; a batch stream decodes, an interactive arrival preempts
    it (its pages spill to the host tier), and the arrival's own prefill
    is the faulted dispatch: the reset must find the victim in the tier."""
    from cake_tpu_torch.kv.host_tier import HostTier as TTier
    import time
    with eng:
        hb = eng.submit([5] * 9, max_new_tokens=24, priority="batch")
        t0 = time.perf_counter()
        while len(hb._req.out_tokens) < 4 and time.perf_counter() - t0 < 120:
            time.sleep(0.001)
        hi = eng.submit([2, 9, 4, 7, 3], max_new_tokens=4,
                        priority="interactive")
        assert hi.wait(timeout=300) and hb.wait(timeout=300)
        out = ([list(hb._req.out_tokens), list(hi._req.out_tokens)],
               (eng.stats.preemptions, eng.stats.kv_spills,
                eng.stats.kv_restores, eng.stats.recoveries,
                eng.stats.requests_recovered))
        assert eng._pager.free_pages == eng._pager.n_pages
        if isinstance(eng._host_tier, TTier):
            assert eng._host_tier.used_pages == 0
    return out


SPILL_KW = dict(max_slots=1, priority_classes=True, preemption=True,
                kv_host_pages=8, sched=dict(preempt_budget=8),
                fault_plan="seed=2;engine.prefill:match_len=5:nth=1:"
                           "transient")


@pytest.mark.parametrize("mixed", ["auto", "off"])
def test_recovery_clears_the_host_tier(models, mixed, monkeypatch):
    from cake_tpu_torch.kv.host_tier import HostTier

    held = []
    real_clear = HostTier.clear

    def clear(self):
        held.append(self.used_pages)
        return real_clear(self)

    monkeypatch.setattr(HostTier, "clear", clear)
    want = _jax_once(("spill", mixed), lambda: _spill_drive(
        _jax_engine(models, mixed_batch=mixed, **SPILL_KW), None))
    got = _spill_drive(_engine(models, mixed_batch=mixed, **SPILL_KW),
                       held)
    assert got == want
    # one preemption spilled the victim; the reset cleared it (no
    # restore: the victim came back by the fold)
    assert got[1] == (1, 1, 0, 1, 2)
    assert held and held[0] > 0
    base = _engine(models, max_slots=1, mixed_batch=mixed)
    with base:
        h = base.submit([5] * 9, max_new_tokens=24)
        assert h.wait(timeout=300)
    assert got[0][0] == list(h._req.out_tokens)


POISON = "seed=1;engine.prefill:match_len=5:always:transient:times=9"


@pytest.mark.parametrize("mixed", ["auto", "off"])
def test_poison_request_is_quarantined(models, mixed):
    want = _jax_once(("poison", mixed), lambda: _drive(_jax_engine(
        models, fault_plan=POISON, mixed_batch=mixed)))
    eng = _engine(models, fault_plan=POISON, mixed_batch=mixed)
    hs = [eng.submit(p, max_new_tokens=GEN) for p in PROMPTS]
    with eng:
        assert all(h.wait(timeout=300) for h in hs)
    got = ([list(h._req.out_tokens) for h in hs],
           [type(h._req.error).__name__ if h._req.error else None
            for h in hs],
           (eng.stats.recoveries, eng.stats.requests_recovered,
            eng.stats.poisoned))
    assert got == want
    assert got[1] == [None, "PoisonRequestError", None]
    err = hs[1]._req.error
    assert isinstance(err, PoisonRequestError) and not err.retryable
    assert err.crashes == 2 and got[2][2] == 1
    with pytest.raises(PoisonRequestError):
        hs[1].text()
    clean = _drive(_engine(models, mixed_batch=mixed))
    assert got[0][0] == clean[0][0] and got[0][2] == clean[0][2]


def test_storm_breaker_stops_with_a_snapshot_that_restores(models,
                                                           tmp_path):
    """engine.step:always trips the breaker after storm_resets resets:
    the engine stops, the snapshot holds every in-flight request, their
    clients get a retryable error, and a fresh engine restores the
    snapshot to the streams an uninterrupted run gives."""
    from cake_tpu_torch.serve import checkpoint

    path = str(tmp_path / "ckpt.json")
    plan = "seed=5;engine.step:step=6:transient:times=50"
    rcfg = dict(FAST, storm_resets=3)
    eng = _engine(models, rcfg=rcfg, fault_plan=plan)
    eng.snapshot_path = path
    checkpoint.warm_fingerprint(eng)
    hs = [eng.submit(p, max_new_tokens=GEN) for p in PROMPTS]
    with eng:
        assert all(h.wait(timeout=300) for h in hs)
        eng._thread.join(timeout=60)
        assert not eng._thread.is_alive()
    assert eng.stopped and eng._breaker_tripped
    assert eng.stats.recoveries == 2
    for h in hs:
        assert isinstance(h._req.error, EngineResetError)
        assert h._req.error.retryable
    snap = checkpoint.load(path)
    recs = snap["requests"]
    assert [r["prompt_ids"] for r in recs] == [list(p) for p in PROMPTS]
    assert all(checkpoint.is_resumable(r) for r in recs)
    with pytest.raises(EngineResetError):
        eng.submit([1, 2, 3], max_new_tokens=2)
    fresh = _engine(models)
    with fresh:
        handles, finished = checkpoint.restore(fresh, path)
        assert len(handles) == len(PROMPTS) and not finished
        assert all(h.wait(timeout=300) for h in handles)
    clean = _drive(_engine(models))
    joined = [list(r["out_tokens"]) + list(h._req.out_tokens)
              for r, h in zip(recs, handles)]
    assert joined == clean[0]

    # the JAX engine under the same plan snapshots the same records
    from cake_tpu.serve import checkpoint as jckpt
    jpath = str(tmp_path / "jax.json")
    jeng = _jax_engine(models, rcfg=rcfg, fault_plan=plan)
    jeng.snapshot_path = jpath
    jckpt.warm_fingerprint(jeng)
    jhs = [jeng.submit(p, max_new_tokens=GEN) for p in PROMPTS]
    with jeng:
        assert all(h.wait(timeout=300) for h in jhs)
    assert jckpt.load(jpath)["requests"] == recs
    assert jeng.stats.recoveries == eng.stats.recoveries


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_failed_rebuild_stops_the_engine_with_a_snapshot(models, tmp_path,
                                                         monkeypatch):
    """An in-place reset that raises, then a rebuild that raises (here
    `_new_cache`), take the reset_failed stop: the in-flight clients get a retryable 503, the snapshot holds
    them, no thread dies, /api/v1/health says "stopped", and the
    snapshot path read nothing from the device (the digest and every
    tensor host copy raise once the fingerprint is warm)."""
    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.serve import checkpoint

    path = str(tmp_path / "ckpt.json")
    eng = _engine(models, fault_plan="seed=1;engine.decode:nth=3:oom")
    died = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: died.append(args))
    master = Master(Args(sample_len=8, temperature=0.0), text_generator=None)
    httpd = start(master, "127.0.0.1:0", block=False, engine=eng,
                  checkpoint_path=path)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def broken(*a, **kw):
        raise torch.cuda.OutOfMemoryError("rebuild failed (test)")

    read = []

    def no_device(*a, **k):
        read.append(a)
        raise AssertionError("the device was read on the fail path")

    real_snap = eng._snapshot_before_fail

    def snapshot_without_the_device(requests=None):
        # the digest and every tensor copy to the host raise here
        with monkeypatch.context() as m:
            m.setattr(checkpoint, "_params_digest", no_device)
            for name in ("cpu", "numpy", "item", "tolist", "cuda"):
                m.setattr(torch.Tensor, name, no_device)
            real_snap(requests=requests)

    monkeypatch.setattr(eng, "_reset_in_place", _in_place_fails)
    monkeypatch.setattr(eng, "_new_cache", broken)
    monkeypatch.setattr(eng, "_snapshot_before_fail",
                        snapshot_without_the_device)
    hs = [eng.submit(p, max_new_tokens=GEN) for p in PROMPTS]
    assert all(h.wait(timeout=120) for h in hs)
    eng._thread.join(timeout=60)
    try:
        assert not died and not read
        assert eng.stopped and eng.stats.last_error == "reset failed"
        assert all(isinstance(h._req.error, EngineResetError)
                   and h._req.error.retryable for h in hs)
        code, health = _get(url + "/api/v1/health")
        assert code == 200 and health["status"] == "stopped"
        assert health["reason"] == "reset failed"
        assert health["recovery"]["recoveries"] == 0
        code, body = _post(url + "/api/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 2})
        assert code == 503 and body["retryable"] is True
        recs = checkpoint.load(path)["requests"]
        assert [r["rid"] for r in recs] == [h._req.rid for h in hs]
        assert all(checkpoint.is_resumable(r) for r in recs)
        from cake_tpu_torch.obs import metrics
        text = metrics.REGISTRY.render()
        assert 'cake_engine_recoveries_total{outcome="reset_failed"}' in text
    finally:
        httpd.shutdown()
        httpd.server_close()


def _in_place_fails():
    raise RuntimeError("in-place reset failed (test)")


@pytest.mark.parametrize("mixed", ["auto", "off"])
def test_old_pool_is_released_before_the_new_one(models, mixed):
    """When the in-place reset raises, at the fallback rebuild's
    allocation the old pool and both runners are unreferenced (weakrefs
    dead without a collection), so a rebuild needs one pool's memory,
    not two."""
    import gc
    eng = _engine(models, mixed_batch=mixed, decode_scan_steps=4,
                  fault_plan="seed=1;engine.decode:nth=3:transient")
    eng._reset_in_place = _in_place_fails
    real = eng._new_cache
    seen = []

    def new_cache(*a, **kw):
        seen.append([r() is None for r in refs])
        return real(*a, **kw)

    refs = []

    def arm():
        refs[:] = [weakref.ref(eng.cache)]
        for r in (eng._runner, eng._mixed_runner):
            if r is not None:
                refs.append(weakref.ref(r))

    eng._new_cache = new_cache
    hs = [eng.submit(p, max_new_tokens=GEN) for p in PROMPTS]
    real_reset = eng._reset_after_error

    def reset():
        arm()
        real_reset()

    eng._reset_after_error = reset
    gc.disable()
    try:
        with eng:
            assert all(h.wait(timeout=300) for h in hs)
    finally:
        gc.enable()
    assert eng.stats.recoveries == 1
    assert seen == [[True] * len(refs)] and len(refs) >= 2


@pytest.mark.parametrize("where", ["mixed", "decode"])
def test_old_pool_is_released_when_a_runner_raises(models, where,
                                                   monkeypatch):
    """A real step error raised inside a runner (its frame holds the
    runner, and the log record keeps the traceback), then an in-place
    reset that raises: the failed frames are cleared, so the pool is
    still unreferenced at the fallback rebuild."""
    from cake_tpu_torch.serve import graphs
    cls = graphs.MixedRunner if where == "mixed" else graphs.DecodeRunner
    real_run = cls.run
    calls = []

    def run_then_raise(self, *a):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError(f"{where} replay failed (test)")
        return real_run(self, *a)

    monkeypatch.setattr(cls, "run", run_then_raise)
    eng = _engine(models, prefill_chunk=8)
    refs, seen = [], []
    real_new, real_reset = eng._new_cache, eng._reset_after_error

    def reset():
        refs[:] = [weakref.ref(eng.cache)] + [
            weakref.ref(r) for r in (eng._runner, eng._mixed_runner)
            if r is not None]
        real_reset()

    def new_cache(*a, **kw):
        seen.append([r() is None for r in refs])
        return real_new(*a, **kw)

    eng._reset_after_error, eng._new_cache = reset, new_cache
    eng._reset_in_place = _in_place_fails
    hs = [eng.submit(p, max_new_tokens=GEN) for p in PROMPTS]
    import gc
    gc.disable()
    try:
        with eng:
            assert all(h.wait(timeout=300) for h in hs)
    finally:
        gc.enable()
    assert eng.stats.recoveries == 1
    assert all(h._req.error is None for h in hs)
    assert seen == [[True] * len(refs)] and len(refs) >= 2


def test_one_failed_step_implicates_a_request_once(models):
    """A pinned divergence: a slot mid-prefill rides a mixed step as a
    chunk row and sits in its decode plan too. One failure of that step
    quarantines it in the JAX engine (counted twice: its budget of 2
    consecutive failed steps is spent by one); the port counts it once
    and recovers it, with the stream an unfaulted run gives."""
    plan = "seed=1;engine.mixed:nth=2:transient"
    prompt = [[3 + (i % 7) for i in range(20)]]
    want = _drive(_jax_engine(models, fault_plan=plan, prefill_chunk=8),
                  prompt)
    got = _drive(_engine(models, fault_plan=plan, prefill_chunk=8), prompt)
    assert want[1] == ["PoisonRequestError"] and want[2] == (1, 0, 1)
    assert got[1] == [None] and got[2] == (1, 1, 0)
    assert got[0] == _drive(_engine(models, prefill_chunk=8), prompt)[0]


def test_recovery_metric_families_are_jax():
    """The recovery families and the checkpoint's and journal's keep the
    JAX package's names, types, help and labels."""
    from cake_tpu.serve import checkpoint as jckpt
    from cake_tpu.serve import engine as jengine
    from cake_tpu.serve import journal as jjournal
    from cake_tpu_torch.obs import metrics as tmetrics
    from cake_tpu_torch.serve import engine as tengine
    from cake_tpu_torch.serve import journal as tjournal

    pairs = [(getattr(jengine, n), getattr(tengine, n)) for n in (
        "_RESET_FAILURES", "_RECOVERIES", "_RECOVERED_REQUESTS",
        "_POISON_REQUESTS", "_RECOVERY_SECONDS")]
    pairs += [(getattr(jjournal, n), getattr(tjournal, n)) for n in (
        "_APPENDS", "_BYTES", "_FSYNC_SECONDS", "_REPLAYED", "_DROPPED",
        "_REPLAY_SECONDS", "_COMPACTIONS")]
    for a, b in pairs:
        assert (a.name, a.typ, a.help, tuple(a.labelnames)) == \
            (b.name, b.typ, b.help, tuple(b.labelnames)), b.name
        if a.typ == "histogram":
            assert tuple(a.buckets) == tuple(b.buckets), b.name
    # JAX registers the checkpoint's two counters inside resume()
    import inspect
    from cake_tpu_torch.serve import checkpoint as tckpt
    src = inspect.getsource(jckpt.resume)
    for fam in (tckpt._RESUMED, tckpt._DROPPED):
        assert f'"{fam.name}"' in src and f'"{fam.help}"' in src
        assert fam.name in tmetrics.REGISTRY.render()


def test_no_recovery_fails_everything_then_serves(models):
    plan = "seed=1;engine.decode:nth=2:transient"
    want = _jax_once(("norecovery",), lambda: _drive(_jax_engine(
        models, recovery=False, fault_plan=plan)))
    eng = _engine(models, recovery=False, fault_plan=plan)
    hs = [eng.submit(p, max_new_tokens=GEN) for p in PROMPTS]
    with eng:
        assert all(h.wait(timeout=300) for h in hs)
        got = ([list(h._req.out_tokens) for h in hs],
               [type(h._req.error).__name__ if h._req.error else None
                for h in hs],
               (eng.stats.recoveries, eng.stats.requests_recovered,
                eng.stats.poisoned))
        assert got == want
        assert got[1] == ["EngineResetError"] * len(PROMPTS)
        assert all(h._req.error.retryable for h in hs)
        assert got[2] == (0, 0, 0)
        # the rebuilt engine serves on (the clients are released before
        # the rebuild, which counts the error)
        h = eng.submit([1, 2, 3], max_new_tokens=3)
        assert h.wait(timeout=120) and h._req.error is None
        assert len(h._req.out_tokens) == 3 and eng.stats.errors == 1


def test_backoff_between_consecutive_resets(models):
    """Consecutive resets back off base * 2^(k-2) (the first is
    immediate); a clean iteration ends the episode."""
    import time
    eng = _engine(models, rcfg=dict(backoff_base_s=0.2, backoff_cap_s=0.3),
                  fault_plan="seed=1;engine.step:step=2:transient:"
                             "times=3")
    t0 = time.perf_counter()
    got = _drive(eng)
    assert got[1] == [None] * len(PROMPTS) and got[2][0] == 3
    assert time.perf_counter() - t0 >= 0.2 + 0.3
    assert eng._consec_resets == 0


# -- on the card ----------------------------------------------------------------


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
@pytest.mark.parametrize("scan", [1, 4])
def test_cuda_engine_recovers_like_the_cpu_engine(scan):
    """The card engine under a plan whose faults land on a mixed replay,
    inside a decode burst chain and at the top of an iteration: the same
    recoveries and streams as the CPU engine's, and no graph is captured
    anew after a reset (each variant's one capture is the only one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    plan = ("seed=15;engine.mixed:nth=3:transient;engine.decode:nth=5:oom;"
            "engine.step:step=9:transient")
    runs = []
    for device in ("cpu", "cuda"):
        eng = _engine(_card_models(), device=device,
                      params=_card_params(device), fault_plan=plan,
                      decode_scan_steps=scan, prefill_chunk=8)
        got = _drive(eng)
        runs.append(got)
        if device == "cuda":
            captures = len(eng.events.dump(type="recompile"))
            assert eng.stats.recoveries >= 2
            runners = (eng._runner, eng._mixed_runner)
            assert all(r is not None for r in runners)
            assert captures == sum(r.captures for r in runners)
    assert runs[1] == runs[0]


@pytest.mark.cuda
def test_cuda_silent_plan_adds_no_sync():
    """A plan whose rules never fire arms every site; the mixed and
    decode dispatches under `torch.cuda.set_sync_debug_mode("error")`
    still make no synchronizing call (a chunk-only mixed step and a
    chained burst dispatch wait for nothing)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    plan = ("seed=1;engine.mixed:nth=100000:transient;"
            "engine.decode:nth=100000:oom;engine.step:step=100000:transient;"
            "pager.alloc:nth=100000:oom;engine.prefill:match_len=99999:"
            "always:transient")
    from collections import Counter
    guarded = Counter()
    eng = _engine(_card_models(), device="cuda",
                  params=_card_params("cuda"), fault_plan=plan,
                  max_slots=3, max_seq_len=128, kv_pages=16,
                  prefill_chunk=8, decode_scan_steps=4)

    def guard(name, fn):
        def wrapped(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                guarded[name] += 1
        return wrapped

    from cake_tpu_torch.serve.graphs import MixedRunner
    real_run = MixedRunner.run

    def mixed_run(self, *a):
        return guard("mixed replay", lambda *b: real_run(self, *b))(*a)

    with eng:
        eng.submit([4] * 20, max_new_tokens=6).wait(300)     # captures
        for name in ("_mixed_admit", "_alloc_slot_pages", "_dispatch_scan"):
            setattr(eng, name, guard(name, getattr(eng, name)))
        eng._faults.check = guard("check", eng._faults.check)
        MixedRunner.run = mixed_run
        try:
            hs = [eng.submit([5 + i] * 30, max_new_tokens=12)
                  for i in range(3)]
            assert all(h.wait(timeout=300) for h in hs)
        finally:
            MixedRunner.run = real_run
    assert eng.stats.recoveries == 0
    assert eng._faults.describe()["injections_total"] == 0
    assert guarded["_mixed_admit"] >= 3 and guarded["_alloc_slot_pages"] >= 3
    assert guarded["check"] > 10 and guarded["mixed replay"] >= 3
    assert guarded["_dispatch_scan"] >= 1
