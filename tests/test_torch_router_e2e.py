"""Two tiny f32 port replicas (the paged engine over the CPU, each behind
the port's `ApiServer`) behind the port's router, over localhost HTTP:

  * greedy streams through the router are token-identical to the same
    requests sent straight to one replica, and every chat of a tenant's
    system prompt lands on one replica, whose prefix hits advance;
  * the wire contract across packages: JAX's router over the port's
    replicas and the port's router over JAX's replicas serve the same
    text as the port's router over the port's replicas;
  * a drained replica gets no new admission while its stream finishes
    (the router's state is awaited, never a fixed sleep);
  * a replica killed mid keyed SSE stream: the reconnect with the same
    idempotency key and Last-Event-ID finishes on the survivor, its text
    the reference's, and the router's federated timeline names both;
  * discovery: a replica named in --replicas and one that announces
    itself serve together, and the announced one's shutdown departs.
"""

import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

GEN = 10
PAGE = 8


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp
    import torch

    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jc = JConfig.tiny(num_hidden_layers=2)
    jp = init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                           dtype=torch.float32)
    return jc, jp, LlamaConfig.tiny(num_hidden_layers=2), tp


def _port_replica(models, **kw):
    import torch

    from cake_tpu_torch.api.server import ApiServer, make_handler
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    _, _, cfg, params = models
    eng = InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), max_slots=2,
        max_seq_len=256, kv_pages=96, kv_page_size=PAGE,
        auto_prefix_system=True, device="cpu", cache_dtype=torch.float32,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0), **kw)
    master = Master(Args(sample_len=GEN, cpu=True), text_generator=None)
    api = ApiServer(master, engine=eng)
    return _serve(eng, api, make_handler(api))


def _jax_replica(models):
    import jax.numpy as jnp

    from cake_tpu.api.server import ApiServer, make_handler
    from cake_tpu.args import Args
    from cake_tpu.master import Master
    from cake_tpu.models.llama.generator import ByteTokenizer
    from cake_tpu.ops.sampling import SamplingConfig
    from cake_tpu.serve.engine import InferenceEngine

    cfg, params, _, _ = models
    eng = InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), max_slots=2,
        max_seq_len=256, kv_pages=96, kv_page_size=PAGE, paged_attn="fold",
        auto_prefix_system=True, cache_dtype=jnp.float32,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0))
    master = Master(Args(sample_len=GEN), text_generator=None)
    master.llm = object()
    api = ApiServer(master, engine=eng)
    return _serve(eng, api, make_handler(api))


def _serve(eng, api, handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    addr = f"127.0.0.1:{httpd.server_address[1]}"
    api.replica_id = addr
    return eng, api, httpd, addr


def _router(pkg, replicas, vocab, **kw):
    if pkg == "jax":
        from cake_tpu.models.llama.generator import ByteTokenizer
        from cake_tpu.router import start_router
    else:
        from cake_tpu_torch.models.llama.generator import ByteTokenizer
        from cake_tpu_torch.router import start_router
    kw.setdefault("poll_interval_s", 0.05)
    kw.setdefault("stale_after_s", 1.0)
    httpd, router = start_router(replicas, address="127.0.0.1:0",
                                 block=False, tokenizer=ByteTokenizer(vocab),
                                 **kw)
    router.tracker.poll_once()
    return httpd, router, f"127.0.0.1:{httpd.server_address[1]}"


def _close(router_parts, *replicas):
    rhttpd, router, _ = router_parts
    rhttpd.shutdown()
    router.close()
    for eng, _, httpd, _ in replicas:
        try:
            httpd.shutdown()
        except Exception:  # noqa: BLE001
            pass
        eng.stop()


def _messages(tenant, turn):
    return [{"role": "system",
             "content": f"You are {tenant}, a terse test assistant."},
            {"role": "user", "content": turn}]


def _post(addr, body, headers=None):
    req = urllib.request.Request(
        f"http://{addr}/api/v1/chat/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=600)


def _text(addr, tenant, turn, headers=None):
    out = json.loads(_post(addr, {"messages": _messages(tenant, turn),
                                  "max_tokens": GEN}, headers).read())
    return out["choices"][0]["message"]["content"]


def _read_sse(resp):
    events, cur = [], None
    for raw in resp:
        line = raw.decode()
        if line.startswith("id: "):
            cur = int(line[4:])
        elif line.startswith("data: "):
            if line.strip() == "data: [DONE]":
                break
            events.append((cur, json.loads(line[6:])))
    return events


def _text_of(events):
    return "".join(e["choices"][0]["delta"].get("content") or ""
                   for _, e in events if "choices" in e)


def _until(pred, what, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    assert pred(), f"timed out waiting for {what}"


TURNS = [("tenant-a", "hello"), ("tenant-a", "tell me more"),
         ("tenant-b", "what is 2+2"), ("tenant-b", "and 3+3"),
         ("tenant-c", "a story please")]


@pytest.fixture(scope="module")
def reference(models):
    """Each turn's greedy text straight from one port replica."""
    rep = _port_replica(models)
    try:
        return [_text(rep[3], t, q) for t, q in TURNS]
    finally:
        rep[2].shutdown()
        rep[0].stop()


def test_router_streams_equal_one_replicas_and_tenants_stick(models,
                                                             reference):
    A, B = _port_replica(models), _port_replica(models)
    parts = _router("port", [A[3], B[3]], models[2].vocab_size)
    raddr = parts[2]
    try:
        homes = {}
        for (tenant, turn), ref in zip(TURNS, reference):
            resp = _post(raddr, {"messages": _messages(tenant, turn),
                                 "max_tokens": GEN, "stream": True})
            rep = resp.headers["x-cake-replica"]
            assert resp.headers["x-cake-rid"] is not None
            assert resp.headers["x-cake-trace"]
            assert _text_of(_read_sse(resp)) == ref
            homes.setdefault(tenant, set()).add(rep)
        assert all(len(h) == 1 for h in homes.values()), homes
        # every turn after a tenant's first hit its home's prefix pages
        hits = A[0].stats.prefix_hits + B[0].stats.prefix_hits
        assert hits >= len(TURNS) - len(homes)
        metrics = urllib.request.urlopen(f"http://{raddr}/metrics",
                                         timeout=10).read().decode()
        assert "cake_router_requests_total" in metrics
    finally:
        _close(parts, A, B)


@pytest.mark.parametrize("router_pkg,replica_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_the_wire_contract_across_packages(models, reference, router_pkg,
                                           replica_pkg):
    make = _port_replica if replica_pkg == "port" else _jax_replica
    A, B = make(models), make(models)
    parts = _router(router_pkg, [A[3], B[3]], models[2].vocab_size)
    try:
        for (tenant, turn), ref in zip(TURNS[:3], reference):
            assert _text(parts[2], tenant, turn) == ref
        # the router reads the replicas' lite health: their page size
        assert parts[1]._page_size() == PAGE
        assert all(st.admitting for st in parts[1].tracker.states())
    finally:
        _close(parts, A, B)


def test_a_drained_replica_gets_no_new_admission(models):
    A, B = _port_replica(models), _port_replica(models)
    parts = _router("port", [A[3], B[3]], models[2].vocab_size)
    _, router, raddr = parts
    by_addr = {A[3]: A, B[3]: B}
    try:
        resp = _post(raddr, {"messages": _messages("tenant-d", "long"),
                             "stream": True, "max_tokens": 24})
        home = by_addr[resp.headers["x-cake-replica"]]
        cold = B if home is A else A
        first = resp.readline()               # the stream is in flight
        assert first.startswith(b"data: ")
        st = json.loads(urllib.request.urlopen(urllib.request.Request(
            f"http://{home[3]}/api/v1/drain",
            data=json.dumps({"timeout_s": 60}).encode(),
            headers={"Content-Type": "application/json"}),
            timeout=30).read())
        assert st["draining"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(home[3], {"messages": _messages("t", "x")})
        assert ei.value.code == 429
        assert ei.value.headers["x-cake-replica"] == home[3]

        def seen_draining():
            router.tracker.poll_once()
            return not router.tracker.get(home[3]).admitting

        _until(seen_draining, "the router to see the drain")
        base = home[0].stats.requests_completed
        cold_base = cold[0].stats.requests_completed
        for i in range(3):
            assert _text(raddr, "tenant-d", f"post-drain {i}")
        assert cold[0].stats.requests_completed == cold_base + 3
        assert _text_of(_read_sse(resp))      # the stream finished
        assert home[0].stats.requests_completed <= base + 1
    finally:
        _close(parts, A, B)


def test_a_killed_replicas_keyed_stream_resumes_on_the_survivor(models):
    from cake_tpu_torch.serve.errors import EngineResetError
    A, B = _port_replica(models), _port_replica(models)
    parts = _router("port", [A[3], B[3]], models[2].vocab_size)
    _, router, raddr = parts
    by_addr = {A[3]: A, B[3]: B}
    body = {"messages": _messages("tenant-k", "tell me a story"),
            "stream": True, "max_tokens": 24}
    hdrs = {"Content-Type": "application/json",
            "x-cake-idempotency-key": "kill-drill"}
    try:
        ref = _text_of(_read_sse(_post(
            A[3], dict(body, max_tokens=24))))
        conn = http.client.HTTPConnection(raddr, timeout=600)
        conn.request("POST", "/api/v1/chat/completions",
                     body=json.dumps(body).encode(), headers=hdrs)
        resp = conn.getresponse()
        tid = resp.getheader("x-cake-trace")
        home = by_addr[resp.getheader("x-cake-replica")]
        rid_home = int(resp.getheader("x-cake-rid"))
        pre, cur = [], None
        while len(pre) < 3:
            line = resp.readline().decode()
            if line.startswith("id: "):
                cur = int(line[4:])
            elif line.startswith("data: ") and '"content"' in line:
                doc = json.loads(line[6:])
                if doc["choices"][0]["delta"].get("content"):
                    pre.append((cur, doc))
        last_seen = max(i for i, _ in pre)
        survivor = B if home is A else A
        home[0]._fail_all(EngineResetError("replica killed"))
        home[0].stop()
        try:
            resp.read()
        except (OSError, http.client.HTTPException):
            pass
        conn.close()

        conn = http.client.HTTPConnection(raddr, timeout=600)
        conn.request("POST", "/api/v1/chat/completions",
                     body=json.dumps(body).encode(),
                     headers={**hdrs, "Last-Event-ID": str(last_seen)})
        resp2 = conn.getresponse()
        assert resp2.status == 200
        assert resp2.getheader("x-cake-trace") == tid
        assert resp2.getheader("x-cake-replica") == survivor[3]
        rid_surv = int(resp2.getheader("x-cake-rid"))
        post = _read_sse(resp2)
        conn.close()
        assert all(i is None or i > last_seen for i, _ in post)
        assert _text_of(pre) + _text_of(post) == ref
        tl = json.loads(urllib.request.urlopen(
            f"http://{raddr}/api/v1/requests/{rid_surv}/timeline",
            timeout=30).read())
        assert tl["trace"] == tid
        rows = {r["replica"]: r["rid"] for r in tl["replicas"]}
        assert rows == {home[3]: rid_home, survivor[3]: rid_surv}
        ev = {(e.get("source"), e.get("event"), e.get("replica"))
              for e in tl["timeline"]}
        assert ("trace", "admitted", home[3]) in ev
        assert ("trace", "retired", survivor[3]) in ev
        assert tl["summary"]["causes"].get("failover_resume", 0) >= 1
    finally:
        _close(parts, A, B)


def test_a_named_and_an_announced_replica_serve_and_depart(models,
                                                           reference):
    import torch

    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    A = _port_replica(models)
    parts = _router("port", [A[3]], models[2].vocab_size,
                    announce="127.0.0.1:0", announce_interval_s=0.1,
                    forget_grace_s=0.5)
    _, router, raddr = parts
    _, _, cfg, params = models
    eng = InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), max_slots=2,
        max_seq_len=256, kv_pages=96, kv_page_size=PAGE,
        auto_prefix_system=True, device="cpu", cache_dtype=torch.float32,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0))
    master = Master(Args(sample_len=GEN, cpu=True), text_generator=None)
    httpd = start(master, address="127.0.0.1:0", block=False, engine=eng,
                  announce=f"127.0.0.1:{router.discovery.port}",
                  announce_interval_s=0.1)
    name = f"127.0.0.1:{httpd.server_address[1]}"
    try:
        _until(lambda: (st := router.tracker.get(name)) is not None
               and st.admitting, "the announced replica")
        fleet = json.loads(urllib.request.urlopen(
            f"http://{raddr}/api/v1/fleet", timeout=10).read())
        assert fleet["replicas"][name]["source"] == "announced"
        assert A[3] in fleet["replicas"]
        served = set()
        for (tenant, turn), ref in zip(TURNS, reference):
            resp = _post(raddr, {"messages": _messages(tenant, turn),
                                 "max_tokens": GEN, "stream": True})
            served.add(resp.headers["x-cake-replica"])
            assert _text_of(_read_sse(resp)) == ref
        assert served <= {A[3], name}
        httpd.shutdown()        # the shutdown sends the departure first
        _until(lambda: router.tracker.get(name) is None
               or router.tracker.get(name).departing, "the departure")
        for i in range(2):
            resp = _post(raddr, {"messages": _messages("tenant-z", str(i)),
                                 "max_tokens": 2, "stream": True})
            assert resp.headers["x-cake-replica"] == A[3]
            _read_sse(resp)
    finally:
        httpd.shutdown()
        eng.stop()
        _close(parts, A)
