"""The replica's half of the router contract in the port's server
(`cake_tpu_torch/api/server.py`), held against the JAX package's server
over the same engine configuration and the same requests:

  * `GET /api/v1/health?lite=1` has JAX's key set, each key a subtree of
    the full document, with the replica's name and wall clock, and the
    same queue depths by class, page size, epoch, attainment and
    breaker; any other ?lite value is the full document;
  * the headers: a stream carries x-cake-replica, x-cake-rid and the
    request's x-cake-trace before the first token; a drain's 429 and a
    failed engine's 503 carry x-cake-replica; every error echoes the
    request's x-cake-trace; a buffered 200 carries none of them;
  * `submit(trace_id=)` threads the trace into the request's trace
    record and the events published for it;
  * `start` names the replica by its bind address, CAKE_REPLICA_ID or
    the host name otherwise, as JAX's.
"""

import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

PAGE = 8
HEADS = ("x-cake-replica", "x-cake-rid", "x-cake-trace", "Retry-After")


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp
    import torch

    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jc = JConfig.tiny(num_hidden_layers=1)
    jp = init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                           dtype=torch.float32)
    return jc, jp, LlamaConfig.tiny(num_hidden_layers=1), tp


def _replica(pkg, models, **kw):
    kw = dict(max_slots=2, max_seq_len=128, kv_pages=64, kv_page_size=PAGE,
              priority_classes=True, **kw)
    if pkg == "jax":
        import jax.numpy as jnp

        from cake_tpu.api.server import ApiServer, make_handler
        from cake_tpu.args import Args
        from cake_tpu.master import Master
        from cake_tpu.models.llama.generator import ByteTokenizer
        from cake_tpu.ops.sampling import SamplingConfig
        from cake_tpu.serve.engine import InferenceEngine
        cfg, params, _, _ = models
        eng = InferenceEngine(
            cfg, params, ByteTokenizer(cfg.vocab_size), paged_attn="fold",
            cache_dtype=jnp.float32,
            sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
            **kw)
        master = Master(Args(sample_len=4), text_generator=None)
        master.llm = object()
    else:
        import torch

        from cake_tpu_torch.api.server import ApiServer, make_handler
        from cake_tpu_torch.args import Args
        from cake_tpu_torch.master import Master
        from cake_tpu_torch.models.llama.generator import ByteTokenizer
        from cake_tpu_torch.ops.sampling import SamplingConfig
        from cake_tpu_torch.serve.engine import InferenceEngine
        _, _, cfg, params = models
        eng = InferenceEngine(
            cfg, params, ByteTokenizer(cfg.vocab_size), device="cpu",
            cache_dtype=torch.float32,
            sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
            **kw)
        master = Master(Args(sample_len=4, cpu=True), text_generator=None)
    api = ApiServer(master, engine=eng, replica_id="r")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(api))
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    addr = f"127.0.0.1:{httpd.server_address[1]}"
    api.replica_id = addr
    return eng, api, httpd, addr


def _close(rep):
    rep[2].shutdown()
    rep[2].server_close()
    rep[0].stop()


def _subtree(lite, full, path=""):
    for k, v in lite.items():
        assert k in full, f"lite key {path}/{k} missing from the full doc"
        if isinstance(v, dict):
            _subtree(v, full[k], f"{path}/{k}")


def _shape(doc):
    """A document's keys, nested, with the values' types."""
    if isinstance(doc, dict):
        return {k: _shape(v) for k, v in doc.items()}
    return type(doc).__name__


def _get(addr, path):
    return json.loads(urllib.request.urlopen(f"http://{addr}{path}",
                                             timeout=30).read())


def _lite_docs(pkg, models):
    rep = _replica(pkg, models)
    try:
        lite = rep[1].health(lite=True)
        full = rep[1].health()
        _subtree(lite, full)
        via_http = _get(rep[3], "/api/v1/health?lite=1")
        assert set(via_http) == set(lite)
        assert "engine_config" in _get(rep[3], "/api/v1/health?lite=0")
        assert via_http["replica"] == rep[3] == full["replica"]
        assert abs(via_http["now"] - full["now"]) < 60
        for doc in (lite, via_http):
            doc.pop("now")
            doc.pop("replica")
        return lite, via_http
    finally:
        _close(rep)


@pytest.mark.parametrize("via", ["method", "http"])
def test_lite_health_keys_and_values_are_jaxs(models, via):
    port = _lite_docs("port", models)[via == "http"]
    jax_ = _lite_docs("jax", models)[via == "http"]
    assert _shape(port) == _shape(jax_)
    assert port == jax_
    assert port["page_size"] == PAGE
    assert port["recovery"] == {"breaker": {"tripped": False}}
    for heavy in ("engine_config", "requests_completed", "model"):
        assert heavy not in port


def _post(addr, body, headers):
    req = urllib.request.Request(
        f"http://{addr}/api/v1/chat/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **headers})
    try:
        resp = urllib.request.urlopen(req, timeout=120)
        resp.read()
        return resp.status, resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.headers


def _headers_of(pkg, models):
    """Each request's status and router headers, with the replica's own
    address written as <self>."""
    from cake_tpu.serve.errors import EngineResetError as JReset
    from cake_tpu_torch.serve.errors import EngineResetError as TReset
    rep = _replica(pkg, models)
    eng, api, _, addr = rep
    msgs = [{"role": "user", "content": "hi"}]
    out = []

    def note(what, status, heads):
        out.append((what, status, {
            h: ("<self>" if heads.get(h) == addr else heads.get(h))
            for h in HEADS if heads.get(h) is not None}))

    try:
        note("buffered", *_post(addr, {"messages": msgs, "max_tokens": 2},
                                {"x-cake-trace": "tr-1"}))
        note("stream", *_post(addr, {"messages": msgs, "max_tokens": 2,
                                     "stream": True},
                              {"x-cake-trace": "tr-2"}))
        note("stream-untraced", *_post(addr, {"messages": msgs,
                                              "max_tokens": 2,
                                              "stream": True}, {}))
        note("bad-class", *_post(addr, {"messages": msgs,
                                        "priority": "nope"},
                                 {"x-cake-trace": "tr-3"}))
        eng.begin_drain()
        note("draining", *_post(addr, {"messages": msgs, "max_tokens": 2},
                                {"x-cake-trace": "tr-5"}))
        # a stopped engine: the typed retryable error's 503
        eng._fail_all((JReset if pkg == "jax" else TReset)("wedged"))
        eng.stop()
        note("stopped", *_post(addr, {"messages": msgs, "max_tokens": 2},
                               {"x-cake-trace": "tr-4"}))
        return out
    finally:
        _close(rep)


def test_router_headers_on_the_same_requests_are_jaxs(models):
    port = _headers_of("port", models)
    jax_ = _headers_of("jax", models)
    for p, j in zip(port, jax_):
        # the stream's rid is each engine's own counter
        assert p[0] == j[0]
        assert p[1] == j[1], (p, j)
        assert set(p[2]) == set(j[2]), (p, j)
        for h in p[2]:
            if h != "x-cake-rid":
                assert p[2][h] == j[2][h], (h, p, j)
    table = {w: (s, h) for w, s, h in port}
    assert table["buffered"] == (200, {})
    assert table["stream"][1] == {"x-cake-replica": "<self>",
                                  "x-cake-rid": table["stream"][1][
                                      "x-cake-rid"],
                                  "x-cake-trace": "tr-2"}
    assert table["bad-class"] == (400, {"x-cake-trace": "tr-3"})
    assert table["draining"][0] == 429
    assert table["draining"][1]["x-cake-replica"] == "<self>"
    assert table["stopped"][0] == 503
    assert table["stopped"][1]["x-cake-replica"] == "<self>"
    assert table["stopped"][1]["x-cake-trace"] == "tr-4"


def test_submit_threads_the_trace_into_records_and_events(models):
    rep = _replica("port", models, event_ring=64)
    eng = rep[0]
    try:
        h = eng.submit([5, 6, 7, 8, 9], max_new_tokens=2, trace_id="tr-9")
        assert h.wait(timeout=60)
        rid = h._req.rid
        assert eng.tracer.trace_for(rid) == "tr-9"
        assert eng.tracer.get(rid)["trace"] == "tr-9"
        eng.events.publish("prefix_hit", rid=rid, pages=1)
        evs, _ = eng.events.snapshot(rid=rid)
        assert evs[-1]["trace"] == "tr-9"
    finally:
        _close(rep)


@pytest.mark.parametrize("env", [None, "named-by-env"])
def test_the_replica_is_named_as_jaxs(models, monkeypatch, env):
    import socket
    import types

    from cake_tpu.api.server import ApiServer as JApi
    from cake_tpu_torch.api.server import ApiServer as TApi
    if env is None:
        monkeypatch.delenv("CAKE_REPLICA_ID", raising=False)
    else:
        monkeypatch.setenv("CAKE_REPLICA_ID", env)
    rep = _replica("port", models)
    try:
        master, eng = rep[1].master, rep[0]
        for rid in ("10.0.0.1:8000", None):
            t = TApi(master, engine=eng, replica_id=rid).replica_id
            j = JApi(types.SimpleNamespace(), engine=None,
                     replica_id=rid).replica_id
            assert t == j == (rid or env or socket.gethostname())
    finally:
        _close(rep)
