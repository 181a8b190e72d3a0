"""The port's runtime checkpoint (`cake_tpu_torch/serve/checkpoint.py`)
against the JAX package's, the engine's checkpoint seams and the drain
route.

  * For the same engine state (requests queued with classes, keys,
    penalties and resume primes; and the state a storm-breaker stop
    leaves mid-stream), `snapshot_requests` gives JAX's records.
  * save / load / resume / restore round-trip; greedy streams with
    repeat_penalty != 1 are the uninterrupted run's across a resume (the
    penalty ring is primed with the generated history).
  * A JAX snapshot is refused with an explicit framework error, never as
    a weights mismatch; a doctored digest is a fingerprint mismatch; a
    corrupt file loads as no checkpoint; a wrong version raises.
  * `shutdown_save` keeps a pre-fail snapshot that still holds
    resumable requests, and otherwise saves (truncating the journal).
  * POST /api/v1/drain: new submits get 429 with the drain's
    Retry-After, the in-flight stream completes, the server then stops.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.serve import checkpoint
from cake_tpu_torch.serve.errors import RecoveryConfig

T = 64
PAGE = 16
GEN = 12
PROMPTS = ([5] * 9, [2, 9, 4, 7, 3], [7, 7, 1, 2])


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


def _jax_engine(models, penalty=1.0, **kw):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.serve.engine import InferenceEngine as JEngine
    from cake_tpu.serve.errors import RecoveryConfig as JRecovery

    jc, jp, _, _ = models
    return JEngine(jc, jp, JTok(jc.vocab_size),
                   sampling=JSampling(temperature=0.0,
                                      repeat_penalty=penalty),
                   cache_dtype=jnp.float32, kv_page_size=PAGE,
                   paged_attn="fold", kv_dtype="f32", max_slots=2,
                   max_seq_len=T, kv_pages=8,
                   recovery_config=JRecovery(backoff_base_s=0.0,
                                             storm_resets=1), **kw)


def _engine(models, penalty=1.0, **kw):
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    _, _, tc, tp = models
    kw.setdefault("max_seq_len", T)
    kw.setdefault("kv_pages", 8)
    return InferenceEngine(
        tc, tp, ByteTokenizer(tc.vocab_size), device="cpu",
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=penalty),
        cache_dtype=torch.float32, kv_page_size=PAGE, kv_dtype="f32",
        max_slots=2, recovery=True,
        recovery_config=RecoveryConfig(backoff_base_s=0.0, storm_resets=1),
        **kw)


def _queue(eng):
    eng.submit(PROMPTS[0], max_new_tokens=GEN, priority="batch",
               idempotency_key="a")
    eng.submit(PROMPTS[1], max_new_tokens=5, temperature=0.7, top_p=0.9,
               repeat_penalty=1.3, prime_penalty_tokens=[3, 3])
    eng.submit(PROMPTS[2] + [8, 8], max_new_tokens=GEN,
               replay_tokens=[8, 8], prime_penalty_tokens=[8, 8],
               priority="interactive", idempotency_key="c")


def test_snapshot_records_equal_jax_queued(models):
    from cake_tpu.serve import checkpoint as jckpt
    j, t = _jax_engine(models), _engine(models)
    _queue(j)
    _queue(t)
    assert checkpoint.snapshot_requests(t) == jckpt.snapshot_requests(j)
    snap = checkpoint.snapshot(t)
    assert snap["version"] == jckpt.SNAPSHOT_VERSION == 3
    assert len(snap["requests"]) == 3


BREAK = "seed=1;engine.step:step=7:transient"


def _breaker_snapshot(eng, ckpt_mod, path):
    """The storm breaker (storm_resets=1) trips at engine step 7: the
    pre-fail snapshot holds the mid-stream state."""
    eng.snapshot_path = path
    ckpt_mod.warm_fingerprint(eng)
    hs = [eng.submit(p, max_new_tokens=GEN) for p in PROMPTS]
    with eng:
        assert all(h.wait(timeout=300) for h in hs)
    return ckpt_mod.load(path)["requests"]


def test_snapshot_records_equal_jax_mid_stream(models, tmp_path):
    from cake_tpu.serve import checkpoint as jckpt
    want = _breaker_snapshot(_jax_engine(models, fault_plan=BREAK), jckpt,
                             str(tmp_path / "j.json"))
    got = _breaker_snapshot(_engine(models, fault_plan=BREAK), checkpoint,
                            str(tmp_path / "t.json"))
    assert got == want
    assert any(r["out_tokens"] for r in got)
    assert all(checkpoint.is_resumable(r) for r in got)


@pytest.mark.parametrize("penalty", [1.0, 1.3])
def test_resume_is_the_uninterrupted_run(models, tmp_path, penalty):
    """A snapshot taken mid-stream (the breaker's), restored into a fresh
    engine: the joined greedy streams are an uninterrupted run's, with a
    repeat penalty too (the ring is primed with penalty_context)."""
    path = str(tmp_path / "ckpt.json")
    recs = _breaker_snapshot(_engine(models, penalty, fault_plan=BREAK),
                             checkpoint, path)
    assert any(r["out_tokens"] for r in recs)
    fresh = _engine(models, penalty)
    with fresh:
        handles, finished = checkpoint.restore(fresh, path)
        assert len(handles) == len(PROMPTS) and not finished
        assert all(h.wait(timeout=300) for h in handles)
        for r, h in zip(recs, handles):
            assert h._req.replayed_tokens == r["out_tokens"]
            assert h._req.prime_tokens == r["penalty_context"]
    clean = _engine(models, penalty)
    with clean:
        cs = [clean.submit(p, max_new_tokens=GEN) for p in PROMPTS]
        assert all(h.wait(timeout=300) for h in cs)
    for r, h, c in zip(recs, handles, cs):
        assert (list(r["out_tokens"]) + list(h._req.out_tokens)
                == list(c._req.out_tokens))
    if penalty != 1.0:
        # the prime matters: without it the resumed streams differ
        snap = checkpoint.load(path)
        for r in snap["requests"]:
            r["penalty_context"] = []
        blind = _engine(models, penalty)
        with blind:
            hb, _ = checkpoint.resume(blind, snap)
            assert all(h.wait(timeout=300) for h in hb)
        assert [list(h._req.out_tokens) for h in hb] != \
            [list(h._req.out_tokens) for h in handles]


def test_save_load_round_trip_and_guards(models, tmp_path, caplog):
    eng = _engine(models)
    _queue(eng)
    path = str(tmp_path / "s.json")
    snap = checkpoint.save(eng, path)
    assert checkpoint.load(path) == json.loads(json.dumps(snap))
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    assert checkpoint.has_resumable(path)
    # a corrupt file is no checkpoint; a wrong version raises
    bad = tmp_path / "bad.json"
    bad.write_text('{"version": 3, "requests": [')
    with caplog.at_level("WARNING"):
        assert checkpoint.load(str(bad)) is None
    assert checkpoint.restore(eng, str(bad)) == ([], [])
    bad.write_text(json.dumps(dict(snap, version=2)))
    with pytest.raises(ValueError, match="version"):
        checkpoint.load(str(bad))
    # the fingerprint is warmed once and copied out
    fp = checkpoint._fingerprint(eng)
    fp["params"] = "x"
    assert checkpoint._fingerprint(eng)["params"] != "x"


def test_jax_snapshot_is_refused_explicitly(models, tmp_path):
    """A JAX snapshot (no framework mark, a digest of other bytes) is
    refused with a framework error, strict or not; a port snapshot with
    a doctored digest is a fingerprint mismatch; through start() the
    refused file is moved to *.invalid and the engine starts empty."""
    from cake_tpu.serve import checkpoint as jckpt
    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master

    j = _jax_engine(models)
    _queue(j)
    jpath = str(tmp_path / "jax.json")
    jckpt.save(j, jpath)
    eng = _engine(models)
    for strict in (True, False):
        with pytest.raises(ValueError, match="framework") as e:
            checkpoint.restore(eng, jpath, strict=strict)
        assert "fingerprint" not in str(e.value)
    assert not eng._requests
    tpath = str(tmp_path / "port.json")
    snap = checkpoint.save(_engine(models), tpath)
    snap["engine"]["params"] = "0" * 16
    with pytest.raises(ValueError, match="fingerprint"):
        checkpoint.resume(eng, snap)
    httpd = start(Master(Args(sample_len=4), text_generator=None),
                  "127.0.0.1:0", block=False, engine=eng,
                  checkpoint_path=jpath)
    try:
        assert os.path.exists(jpath + ".invalid")
        assert not eng._requests
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_shutdown_save_keeps_or_saves(models, tmp_path):
    path = str(tmp_path / "c.json")
    # a pre-fail snapshot with resumable records is kept
    recs = _breaker_snapshot(_engine(models, fault_plan=BREAK), checkpoint,
                             path)
    eng = _engine(models, fault_plan=BREAK)
    eng._prefail_written = True
    before = open(path).read()
    eng.shutdown_save(path)
    assert open(path).read() == before and recs
    # otherwise the live registry is saved, and the journal truncated
    jpath = str(tmp_path / "j.jsonl")
    live = _engine(models, journal=jpath)
    live.submit(PROMPTS[0], max_new_tokens=GEN)
    live._journal.flush()
    assert os.path.getsize(jpath) > 0
    live.shutdown_save(path)
    assert [r["prompt_ids"] for r in checkpoint.load(path)["requests"]] \
        == [PROMPTS[0]]
    assert os.path.getsize(jpath) == 0
    # and an emptied registry saves an empty snapshot
    _engine(models).shutdown_save(path)
    assert checkpoint.load(path)["requests"] == []


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_drain_route_429_with_eta_then_stop(models, tmp_path):
    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master

    eng = _engine(models, max_seq_len=256, kv_pages=16)
    path = str(tmp_path / "drain.json")
    httpd = start(Master(Args(sample_len=4), text_generator=None),
                  "127.0.0.1:0", block=False, engine=eng,
                  checkpoint_path=path)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    h = eng.submit([5] * 9, max_new_tokens=200)
    t0 = time.perf_counter()
    while not h._req.out_tokens and time.perf_counter() - t0 < 60:
        time.sleep(0.002)
    code, _, st = _post(url + "/api/v1/drain", {"timeout_s": 120})
    assert code == 200 and st["draining"] is True
    assert st["pending_requests"] == 1 and st["eta_s"] >= 1.0
    code, headers, body = _post(url + "/api/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 2})
    assert code == 429 and "draining" in body["error"]
    assert int(headers["Retry-After"]) >= 1
    assert body["retry_after_s"] == int(headers["Retry-After"])
    with urllib.request.urlopen(url + "/api/v1/drain", timeout=60) as r:
        assert json.loads(r.read())["draining"] is True
    code, _, bad = _post(url + "/api/v1/drain", {"timeout_s": -1})
    assert code == 400
    assert h.wait(timeout=300) and h._req.error is None
    assert len(h._req.out_tokens) > 0
    t0 = time.perf_counter()
    while not eng.stopped and time.perf_counter() - t0 < 60:
        time.sleep(0.01)
    assert eng.stopped
    # then the shutdown saved the (empty) registry
    while (not os.path.exists(path)
           and time.perf_counter() - t0 < 60):
        time.sleep(0.01)
    assert checkpoint.load(path)["requests"] == []
    httpd.server_close()
