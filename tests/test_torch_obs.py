"""The port's observability core (`cake_tpu_torch/obs`) and its routes,
against the JAX package.

  * `obs.metrics`: the same registry operations render byte-identical
    Prometheus text in both packages; `obs.jsonl`, `obs.events`,
    `obs.tracing` and `obs.slo` give the JAX modules' records, cursors,
    verdicts and errors for the same calls (timestamps left out).
  * `obs.steps`: the flight recorder's records, summary and utilization
    equal JAX's for the same inputs; `step_cost` equals a count by hand
    from the parameter shapes for a decode, a mixed and a prefill step,
    and JAX's `lower_cost` (XLA's `cost_analysis`) for the same one-layer
    step within STEP_COST_TOL; the engine's (kind, rows, tokens) record
    sequence for a greedy drive is the JAX engine's.
  * The routes `/metrics`, `/api/v1/steps`, `/api/v1/requests` and
    `/api/v1/events`, priority in the body or the header, and the 429s,
    on the JAX server's contracts (tests/test_obs_steps.py,
    tests/test_api_sched.py, tests/test_obs_api.py).
"""

import json
import os
import random
import re
import time
import urllib.error
import urllib.request

import pytest

import torch

from cake_tpu_torch.api.server import start
from cake_tpu_torch.args import Args
from cake_tpu_torch.master import Master
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import (
    ByteTokenizer, LlamaGenerator,
)
from cake_tpu_torch.obs import events as tevents
from cake_tpu_torch.obs import jsonl as tjsonl
from cake_tpu_torch.obs import metrics as tmetrics
from cake_tpu_torch.obs import slo as tslo
from cake_tpu_torch.obs import steps as tsteps
from cake_tpu_torch.obs import tracing as ttracing
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.serve.engine import InferenceEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 64
PAGE = 16
# XLA's count of a one-layer step over step_cost's: XLA also counts the
# elementwise ops (norms, rope, softmax, SiLU) and the masked half of a
# causal prefill's attention, which step_cost leaves out (observed at
# the config below: decode +0.64%, prefill +2.85%). At more than one
# layer XLA counts the blocks' lax.scan body once, so the comparison
# is at one layer.
STEP_COST_TOL = 0.05
WIDE = dict(num_hidden_layers=1, hidden_size=256, intermediate_size=768,
            num_attention_heads=8, num_key_value_heads=2, vocab_size=512)


# -- the host-only modules, call for call ------------------------------------------


def _registry_ops(m, seed):
    """A seeded sequence of registry operations on metrics module `m`;
    returns the rendered text."""
    rng = random.Random(seed)
    reg = m.Registry()
    c = m.counter("cake_test_total", 'help with "quotes" and \\ slash',
                  ("kind",), registry=reg)
    g = m.gauge("cake_test_gauge", "a gauge", registry=reg)
    h = m.histogram("cake_test_seconds", "a histogram", ("path",),
                    buckets=(0.001, 0.1, 1.0, 10.0), registry=reg)
    plain = m.counter("cake_plain_total", "", registry=reg)
    assert m.counter("cake_test_total", "again", ("kind",),
                     registry=reg) is c
    for _ in range(200):
        op = rng.random()
        if op < 0.3:
            c.labels(kind=rng.choice(["a", 'q"x', "new\nline"])).inc(
                rng.choice([1, 2.5, 0]))
        elif op < 0.5:
            g.set(rng.uniform(-1e3, 1e3))
        elif op < 0.8:
            h.labels(rng.choice(["p", "d"])).observe(
                rng.choice([0.0005, 0.05, 0.5, 5.0, 50.0, 1e20]))
        else:
            plain.set_total(rng.randint(0, 1000))
    return reg.render()


@pytest.mark.parametrize("seed", range(3))
def test_metrics_render_byte_identical_to_jax(seed):
    from cake_tpu.obs import metrics as jmetrics
    assert _registry_ops(tmetrics, seed) == _registry_ops(jmetrics, seed)


def test_metric_names_and_errors_match_jax():
    from cake_tpu.obs import metrics as jmetrics
    for m in (tmetrics, jmetrics):
        reg = m.Registry()
        m.counter("cake_x_total", "x", registry=reg)
        for bad in (lambda: m.gauge("cake_x_total", registry=reg),
                    lambda: m.counter("cake_x_total", "x", ("a",),
                                      registry=reg),
                    lambda: m.counter("bad name", registry=reg)):
            with pytest.raises(ValueError):
                bad()


def test_jsonl_round_trip_matches_jax(tmp_path):
    from cake_tpu.obs import jsonl as jjsonl
    out = []
    for mod, name in ((tjsonl, "t.jsonl"), (jjsonl, "j.jsonl")):
        path = str(tmp_path / name)
        w = mod.JsonlAppender(path)
        sizes = [w.append({"i": i, "s": "x" * i}) for i in range(5)]
        sizes.append(w.append({"bad": object()}))    # unserializable: 0
        w.close()
        with open(path, "a") as f:
            f.write('{"torn": ')                      # a killed writer
        out.append((sizes, mod.read_jsonl(path), mod.read_jsonl(path, 2)))
    assert out[0] == out[1]


def _no_ts(d):
    return {k: v for k, v in d.items() if k != "ts"}


def test_event_bus_matches_jax():
    from cake_tpu.obs import events as jevents
    assert tevents.EVENT_TYPES == jevents.EVENT_TYPES
    out = []
    for mod in (tevents, jevents):
        bus = mod.EventBus(capacity=4, observe_metrics=False)
        for i in range(7):
            bus.publish(("preempted", "shed", "prefix_hit")[i % 3],
                        rid=i if i % 2 else None, reason="pages",
                        note=None)
        with pytest.raises(ValueError) as e:
            bus.publish("no_such_type")
        res = [str(e.value), bus.cursor]
        for kw in (dict(), dict(type="shed"), dict(rid=5), dict(since=4),
                   dict(limit=2), dict(since=3, limit=1),
                   dict(limit=0)):
            evs, cur = bus.snapshot(**kw)
            res.append(([_no_ts(e) for e in evs], cur))
        out.append(res)
    assert out[0] == out[1]


def _strip_times(rec):
    rec = {k: v for k, v in rec.items()
           if not k.endswith("_s") and k != "submitted_at"}
    rec["spans"] = [s["name"] for s in rec["spans"]]
    rec["inter_token"] = rec["inter_token"]["count"]
    return rec


def test_tracer_records_and_log_match_jax(tmp_path):
    from cake_tpu.obs import slo as jslo
    from cake_tpu.obs import tracing as jtracing
    out = []
    for mod, slo_mod, name in ((ttracing, tslo, "t"),
                               (jtracing, jslo, "j")):
        path = str(tmp_path / f"{name}.jsonl")
        acct = slo_mod.SLOAccountant(observe_metrics=False)
        tr = mod.RequestTracer(capacity=3, events_path=path,
                               observe_metrics=False, slo=acct)
        for rid in range(1, 6):
            tr.admit(rid, 10 + rid, 20, priority=("batch", "interactive")
                     [rid % 2])
            tr.prefill_start(rid)
            if rid != 2:
                tr.first_token(rid)
                tr.token(rid)
            if rid == 3:
                tr.span(rid, "preempted", reason="slots", generated=2)
                tr.span(rid, "requeued")
                tr.prefill_start(rid)
            status = {2: "error", 4: "cancelled"}.get(rid, "retired")
            if rid != 5:
                tr.finish(rid, status, error="boom" if rid == 2 else None,
                          output_tokens=2)
        tr.drop(5)
        tr.close()
        lines = [{k: v for k, v in d.items() if k not in ("ts", "ttft_s",
                                                           "e2e_s",
                                                           "queue_wait_s")}
                 for d in tjsonl.read_jsonl(path)]
        out.append(([_strip_times(r) for r in tr.dump()],
                    [_strip_times(r) for r in tr.dump(cls="interactive")],
                    [_strip_times(r) for r in tr.dump(since=2, limit=1)],
                    tr.active_count, lines, acct.requests, acct.misses))
    assert out[0] == out[1]


@pytest.mark.parametrize("spec", [
    None, "interactive=ttft:0.1,e2e:2", "batch=e2e:9;standard=ttft:1",
    "vip=ttft:1", "interactive=ttft", "interactive=lat:1",
    "interactive=ttft:x", "interactive=ttft:-1",
    "interactive=ttft:1,ttft:2", "interactive"])
def test_slo_targets_parse_like_jax(spec):
    from cake_tpu.obs import slo as jslo

    def parse(mod):
        try:
            return {c: (t.ttft_s, t.e2e_s)
                    for c, t in mod.parse_slo_targets(spec).items()}
        except ValueError as e:
            return str(e)
    assert parse(tslo) == parse(jslo)


def test_slo_accountant_matches_jax():
    from cake_tpu.obs import slo as jslo
    out = []
    for mod in (tslo, jslo):
        clock = [0.0]
        a = mod.SLOAccountant(mod.parse_slo_targets(
            "interactive=ttft:0.5,e2e:3"), clock=lambda: clock[0],
            observe_metrics=False)
        rng = random.Random(3)
        met = []
        for _ in range(60):
            clock[0] += rng.choice([1.0, 10.0, 100.0])
            met.append(a.observe(
                rng.choice(("interactive", "standard", "batch")),
                rng.choice([None, 0.1, 0.9, 8.0]),
                rng.choice([None, 1.0, 5.0, 700.0]),
                rng.randint(0, 9), failed=rng.random() < 0.1))
        out.append((met, a.snapshot(), a.attainment_by_class("10m")))
    assert out[0] == out[1]


# -- obs/steps: the recorder and the step cost --------------------------------------


def test_flight_recorder_matches_jax():
    from cake_tpu.obs import steps as jsteps
    out = []
    for mod in (tsteps, jsteps):
        fl = mod.StepTelemetry(impl="paged-fold", capacity=5,
                               peak_flops=1e12, hbm_bps=1e11)
        rng = random.Random(5)
        for i in range(8):
            kind = rng.choice(["mixed", "decode", "decode_scan",
                               "prefill"])
            split = (dict(rows_decode=2, rows_prefill=1, rows_idle=1)
                     if kind == "mixed" else {})
            fl.record(kind, rows=3, tokens=rng.randint(1, 8),
                      dispatch_s=0.001 * (i + 1), device_s=0.002 * i,
                      wall_s=0.004,
                      cost=mod.CostInfo(rng.choice([0, 2e9, 9e12]),
                                        rng.choice([0, 1e8, 5e9])),
                      compiled=i == 2, pages_free=4, pages_total=8,
                      rids=[i, i + 1], **split)
        out.append(([_no_ts(r) for r in fl.dump()],
                    [_no_ts(r) for r in fl.dump(limit=2)],
                    fl.summary(), fl.utilization(),
                    mod.peak_flops_for("cpu"), mod.hbm_bps_for("")))
    assert out[0] == out[1]


def test_mfu_is_clamped_and_the_raw_ratio_kept():
    fl = tsteps.StepTelemetry(capacity=4, peak_flops=1e12, hbm_bps=1e11)
    r = fl.record("decode", rows=1, tokens=1, device_s=0.5,
                  cost=tsteps.CostInfo(flops=2e11, bytes_accessed=7.5e10))
    assert (r.mfu, r.mfu_raw) == (0.4, 0.4)
    assert (r.hbm_util, r.hbm_raw) == (1.0, 1.5)
    assert tsteps.peak_flops_for("NVIDIA H100 80GB HBM3") == 989e12
    assert tsteps.hbm_bps_for("NVIDIA H100 80GB HBM3") == 3.35e12
    assert tsteps.peak_flops_for("cpu") == 1e12


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params as j_init
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jc = JConfig.tiny(num_hidden_layers=2)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, LlamaConfig.tiny(num_hidden_layers=2), tp


def test_step_cost_equals_a_count_by_hand(models):
    """The engine's step cost for a decode, a mixed and a prefill step,
    against sums written out from the parameter shapes: 2 flops a
    multiply-add of every block weight a token, 4 H hd a (query, key)
    pair and layer, 2 D V a sampled row; bytes the weights but the
    embedding once a pass, one embedding row a token and the pool's
    bytes a token over each run's history and new tokens."""
    _, _, cfg, params = models
    eng = InferenceEngine(cfg, params, ByteTokenizer(cfg.vocab_size),
                          device="cpu", max_seq_len=T, kv_pages=8,
                          kv_page_size=PAGE, cache_dtype=torch.float32)
    b = params["blocks"]
    L = cfg.num_hidden_layers
    macs = sum(b[k].numel() for k in ("wq", "wk", "wv", "wo", "w_gate",
                                      "w_up", "w_down")) // L * L
    H, hd, D, V = (cfg.num_attention_heads, cfg.head_dim,
                   cfg.hidden_size, cfg.vocab_size)
    w_bytes = 4 * (sum(t.numel() for t in b.values())
                   + params["final_norm"].numel()
                   + params["lm_head"].numel())
    row = 4 * D
    # a pool token: k and v, L layers, KV heads of hd f32s
    kv_tok = 2 * L * cfg.num_key_value_heads * hd * 4
    assert eng._kv_bytes_per_token == kv_tok

    # decode: rows at positions 3 and 10 (4 and 11 keys)
    got = eng._cost("decode", 2, 2, [(3, 1), (10, 1)], 2)
    assert got.flops == 2 * macs * 2 + 4 * H * hd * L * (4 + 11) \
        + 2 * D * V * 2
    assert got.bytes_accessed == w_bytes + 2 * row + kv_tok * (4 + 11)
    # mixed: a decode row at 5, chunks of 8 at 0 and at 16; two emit
    got = eng._cost("mixed", 3, 2, [(5, 1), (0, 8), (16, 8)], 2)
    pairs = 6 + sum(range(1, 9)) + sum(range(17, 25))
    assert got.flops == 2 * macs * 17 + 4 * H * hd * L * pairs \
        + 2 * D * V * 2
    assert got.bytes_accessed == w_bytes + 17 * row \
        + kv_tok * (6 + 8 + 24)
    # prefill: two admissions, one in two windows (two passes) and one
    # whole (one)
    got = eng._cost("prefill", 2, 2, [(0, 8), (8, 5), (0, 20)], 2,
                    passes=3)
    pairs = sum(range(1, 14)) + sum(range(1, 21))
    assert got.flops == 2 * macs * 33 + 4 * H * hd * L * pairs \
        + 2 * D * V * 2
    assert got.bytes_accessed == 3 * w_bytes + 33 * row \
        + kv_tok * (8 + 13 + 20)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_step_cost_flops_near_xla_cost_analysis(kind):
    import jax
    import jax.numpy as jnp
    from cake_tpu.models.llama import model as jm
    from cake_tpu.models.llama.cache import KVCache
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params as j_init
    from cake_tpu.obs.steps import lower_cost

    jc, tc = JConfig.tiny(**WIDE), LlamaConfig.tiny(**WIDE)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    rope = jm.RopeTables.create(jc, T)
    cache = KVCache.create(jc, 1, T, dtype=jnp.float32)
    if kind == "decode":      # the last position: every cache slot live
        xla = lower_cost(jm.decode_step, (jp, jnp.ones((1, 1), jnp.int32),
                                          jnp.int32(T - 1), cache, rope, jc))
        runs = [(T - 1, 1)]
    else:                     # a whole window, no padding
        xla = lower_cost(jm.prefill, (jp, jnp.ones((1, T), jnp.int32),
                                      jnp.asarray([T]), cache, rope, jc))
        runs = [(0, T)]
    mine = tsteps.step_cost(tc, kind, 1, 1, runs, emit_rows=1)
    assert 0 <= xla.flops / mine.flops - 1 <= STEP_COST_TOL


def _records(flight):
    return [(r["kind"], r["rows"], r["tokens"])
            for r in reversed(flight.dump())]


@pytest.mark.parametrize("mixed,scan", [("auto", 1), ("auto", 4),
                                        ("off", 4)])
def test_flight_records_follow_the_jax_engine(models, mixed, scan):
    """Requests queued before either engine starts, then one greedy
    drive: the (kind, rows, tokens) of every flight record, in order,
    are the JAX engine's; every record has a cost and an MFU."""
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.serve.engine import InferenceEngine as JEngine

    jc, jp, tc, tp = models
    common = dict(max_slots=4, max_seq_len=T, kv_pages=16,
                  kv_page_size=PAGE, prefill_chunk=8, mixed_batch=mixed,
                  decode_scan_steps=scan)
    prompts = [([5] * 20, 9), ([9] * 7, 5), ([3, 7, 9] * 4, 12)]
    seqs = []
    for eng in (JEngine(jc, jp, JTok(jc.vocab_size),
                        sampling=JSampling(temperature=0.0),
                        cache_dtype=jnp.float32, paged_attn="fold",
                        **common),
                InferenceEngine(tc, tp, ByteTokenizer(tc.vocab_size),
                                device="cpu",
                                sampling=SamplingConfig(temperature=0.0),
                                cache_dtype=torch.float32, **common)):
        hs = [eng.submit(p, max_new_tokens=m, temperature=0.0)
              for p, m in prompts]
        with eng:
            assert all(h.wait(timeout=300) for h in hs)
        seqs.append(_records(eng.flight))
    assert seqs[1] == seqs[0]
    recs = eng.flight.records()
    assert all(r.mfu is not None and r.hbm_util is not None
               for r in recs)
    assert sum(r.tokens for r in recs) == sum(m for _, m in prompts)


# -- the routes -----------------------------------------------------------------


@pytest.fixture(scope="module")
def served(models):
    _, _, tc, tp = models
    args = Args(max_slots=2, max_seq_len=256, kv_pages=16,
                kv_page_size=PAGE, prefill_chunk=32, temperature=0.0,
                sample_len=3, priority_classes=True, shed=True)
    gen = LlamaGenerator(tc, tp, ByteTokenizer(tc.vocab_size),
                         max_seq_len=256,
                         sampling=SamplingConfig(temperature=0.0),
                         cache_dtype=torch.float32, device="cpu")
    master = Master(args, text_generator=gen)
    engine = master.make_engine()
    httpd = start(master, "127.0.0.1:0", block=False, engine=engine)
    yield f"http://127.0.0.1:{httpd.server_address[1]}", engine
    httpd.shutdown()
    httpd.server_close()
    engine.stop()


BODY = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3}


def _post(url, body, headers=None):
    req = urllib.request.Request(
        url + "/api/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=120)


def _get(url, path):
    return json.loads(urllib.request.urlopen(url + path, timeout=30).read())


def _settle(engine, n):
    deadline = time.monotonic() + 30
    while (engine.stats.requests_completed < n
           and time.monotonic() < deadline):
        time.sleep(0.01)


def test_priority_in_body_or_header_body_wins(served):
    url, engine = served
    n0 = engine.stats.requests_completed
    for body, hdr, want in (({**BODY, "priority": "interactive"}, None,
                             "interactive"),
                            (BODY, "batch", "batch"),
                            ({**BODY, "priority": "standard"}, "batch",
                             "standard"),
                            ({**BODY, "priority": None}, "interactive",
                             "interactive")):
        with _post(url, body, {"x-cake-priority": hdr} if hdr else None) \
                as r:
            assert json.loads(r.read())["object"] == "chat.completion"
        _settle(engine, n0 + 1)
        n0 += 1
        assert engine.tracer.dump(limit=1)[0]["priority"] == want


@pytest.mark.parametrize("how", ["body", "header"])
def test_unknown_priority_is_400(served, how):
    url, _ = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        if how == "body":
            _post(url, {**BODY, "priority": "vip"})
        else:
            _post(url, BODY, {"x-cake-priority": "vip"})
    assert ei.value.code == 400
    assert "priority" in json.loads(ei.value.read())["error"]


def test_queue_full_and_shed_are_429_with_retry_after(served):
    from cake_tpu_torch.sched.shed import ShedDecision
    url, engine = served
    old = engine.scheduler.max_queue
    engine.scheduler.max_queue = 0
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, BODY)
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 1
        assert json.loads(ei.value.read())["error"] == "queue full"
    finally:
        engine.scheduler.max_queue = old

    class _AlwaysShed:
        def decide(self, cls, depth, now=None):
            return ShedDecision(False, 7.0, 0.0, 9.0)

        def observe_retire(self, now=None):
            pass

        def estimate_retry_after(self, cls, depth, now=None):
            return 7.0

    old_shed, engine._shed = engine._shed, _AlwaysShed()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, {**BODY, "priority": "batch"})
        assert ei.value.code == 429
        assert ei.value.headers["Retry-After"] == "7"
        doc = json.loads(ei.value.read())
        assert "shed" in doc["error"] and doc["retry_after_s"] == 7
    finally:
        engine._shed = old_shed
    evs = _get(url, "/api/v1/events?type=shed")
    assert evs["events"][-1]["priority"] == "batch"
    assert evs["events"][-1]["retry_after_s"] == 7.0
    again = _get(url, f"/api/v1/events?since={evs['cursor']}")
    assert again["events"] == [] and again["cursor"] == evs["cursor"]


def test_steps_route_contract(served):
    url, engine = served
    with _post(url, BODY) as r:
        r.read()
    obj = _get(url, "/api/v1/steps")
    rec = obj["steps"][0]
    for key in ("step", "kind", "impl", "rows", "tokens", "dispatch_s",
                "device_s", "wall_s", "mfu", "hbm_util", "compiled",
                "pages_free", "pages_total", "rids"):
        assert key in rec, rec
    assert 0 < rec["mfu"] <= 1 and 0 < rec["hbm_util"] <= 1
    assert obj["summary"]["recorded_steps"] >= len(obj["steps"])
    assert "mfu" in obj["summary"] and "kinds" in obj["summary"]
    assert len(_get(url, "/api/v1/steps?limit=1")["steps"]) == 1
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(url, "/api/v1/steps?limit=x")
    assert ei.value.code == 400


def test_requests_route_contract(served):
    url, engine = served
    for p in ("interactive", "batch"):
        with _post(url, {**BODY, "priority": p}) as r:
            r.read()
    _settle(engine, engine.stats.requests_completed)
    recs = _get(url, "/api/v1/requests")["requests"]
    assert [r["rid"] for r in recs] == sorted(
        (r["rid"] for r in recs), reverse=True)
    newest = recs[0]["rid"]
    one = _get(url, f"/api/v1/requests?rid={newest}")
    assert [r["rid"] for r in one["requests"]] == [newest]
    assert one["cursor"] == newest
    assert {r["priority"] for r in _get(
        url, "/api/v1/requests?class=interactive")["requests"]} == {
        "interactive"}
    page = _get(url, f"/api/v1/requests?since={newest - 1}&limit=5")
    assert [r["rid"] for r in page["requests"]] == [newest]
    spans = [s["name"] for s in one["requests"][0]["spans"]]
    assert spans[:3] == ["admitted", "queued", "prefill"]
    assert spans[-1] == "retired"
    for bad in ("class=vip", "rid=abc", "since=1.5"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(url, f"/api/v1/requests?{bad}")
        assert ei.value.code == 400


def test_events_route_rejects_unknown_types(served):
    url, _ = served
    for bad in ("type=nope", "rid=x", "limit=y"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(url, f"/api/v1/events?{bad}")
        assert ei.value.code == 400
    assert "cursor" in _get(url, "/api/v1/events?limit=1")


def test_health_reports_class_depths(served):
    url, _ = served
    obj = _get(url, "/api/v1/health")
    assert set(obj["queue_depth_by_class"]) == {
        "interactive", "standard", "batch"}
    assert "preemptions" in obj and "requests_shed" in obj
    assert "attainment_1m" in obj["slo"]


def test_metrics_route_names_match_jax(served):
    """/metrics and /api/v1/metrics render the same exposition; it passes
    the JAX package's lint tool, and every family it renders is named,
    with the same type, in the JAX package's sources."""
    import importlib.util
    url, _ = served
    with _post(url, BODY) as r:
        r.read()
    text = urllib.request.urlopen(url + "/metrics",
                                  timeout=30).read().decode()
    assert urllib.request.urlopen(url + "/api/v1/metrics",
                                  timeout=30).status == 200
    spec = importlib.util.spec_from_file_location(
        "lint_metrics", os.path.join(ROOT, "tools", "lint_metrics.py"))
    lm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lm)
    assert lm.lint(text) == []
    families = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    for name in ("cake_steps_total", "cake_step_mfu", "cake_step_hbm_util",
                 "cake_jit_compiles_total", "cake_preemptions_total",
                 "cake_shed_requests_total", "cake_queue_depth",
                 "cake_sched_ttft_seconds", "cake_paged_attn_step_seconds",
                 "cake_prefix_pages_shared", "cake_prefix_paged_hits_total",
                 "cake_prefix_tokens_saved_total",
                 "cake_request_ttft_seconds", "cake_events_total",
                 "cake_engine_kv_pages_free", "cake_http_requests_total",
                 "cake_slo_requests_total"):
        assert name in families, name
    import cake_tpu.api.server  # noqa: F401 — registers its families
    import cake_tpu.serve.engine  # noqa: F401
    from cake_tpu.obs.metrics import REGISTRY as JREG
    jax_src = ""
    for d, _, files in os.walk(os.path.join(ROOT, "cake_tpu")):
        for f in files:
            if f.endswith(".py"):
                jax_src += open(os.path.join(d, f)).read()
    for name, typ in families.items():
        # every family is a JAX family: registered at import with the
        # same type, or (the scrape-time engine gauges and counters)
        # named in the JAX server's sources
        fam = JREG.get(name)
        if fam is not None:
            assert fam.typ == typ, (name, typ, fam.typ)
        else:
            assert f'"{name}"' in jax_src, name
