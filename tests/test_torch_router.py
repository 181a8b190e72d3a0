"""The port's front-door router units (`cake_tpu_torch/router/`), held
against the JAX package's router, which is host code and runs on the
CPU as it is:

  * the affinity fingerprints and the consistent-hash ring's placements
    equal JAX's, the 3 -> 4 -> 3 replica restore included;
  * `RoutingPolicy` makes JAX's picks on the same `ReplicaState`s
    (affinity hit, bounded-load spill, least-loaded fallback, sticky
    keys through a drain and an ejection, breaker, round robin, the
    no-replica refusal's Retry-After), and the tracker's jittered
    re-probe backoff is JAX's, seeded from the replica's name;
  * the SSE proxy's bytes through the port's router equal the bytes
    through JAX's over the same scripted replica: a whole stream, a
    replica dying mid-stream (the typed terminal error), a shed 429
    relayed with its Retry-After and x-cake-replica;
  * a replica's 400 relayed keeps its hop record (a deliberate
    divergence: JAX's router raises in its handler there);
  * `--replicas` and the router flags parse and refuse as JAX's.
"""

import http.client
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from cake_tpu.router import affinity as j_aff
from cake_tpu.router.policy import NoReplicaError as JNoReplica
from cake_tpu.router.policy import RoutingPolicy as JPolicy
from cake_tpu.router.replicas import ReplicaTracker as JTracker
from cake_tpu_torch.router import affinity as t_aff
from cake_tpu_torch.router.policy import NoReplicaError as TNoReplica
from cake_tpu_torch.router.policy import RoutingPolicy as TPolicy
from cake_tpu_torch.router.replicas import ReplicaTracker as TTracker
from cake_tpu_torch.router.tracing import HOP_TERMINAL

PACKAGES = {"jax": (JTracker, JPolicy, JNoReplica),
            "port": (TTracker, TPolicy, TNoReplica)}


# -- fingerprints and the ring ------------------------------------------------

@pytest.mark.parametrize("page", [1, 8, 16, 128])
def test_fingerprints_equal_jaxs(page):
    heads = [list(range(100, 100 + n)) for n in (0, 1, 7, 16, 33, 300)]
    heads += [[i % 7 for i in range(64)] + [9, 9]]
    for ids in heads:
        assert t_aff.prefix_fingerprint(ids, page) \
            == j_aff.prefix_fingerprint(ids, page)
    for text in ("", "sys prompt", "You are x.", "été " * 40):
        assert t_aff.text_fingerprint(text) == j_aff.text_fingerprint(text)
    for mod in (t_aff, j_aff):
        with pytest.raises(ValueError):
            mod.prefix_fingerprint([1], 0)


def _keys(n=1000):
    return [j_aff.prefix_fingerprint([i & 0xFF, (i >> 8) & 0xFF]
                                     + list(range(30)), 16)
            for i in range(n)]


def test_ring_placements_and_the_3_4_3_restore_equal_jaxs():
    keys = _keys()
    rings = {"jax": j_aff.HashRing(["r0:1", "r1:1", "r2:1"]),
             "port": t_aff.HashRing(["r0:1", "r1:1", "r2:1"])}
    maps = {}
    for name, ring in rings.items():
        m3 = {k: ring.node_for(k) for k in keys}
        ring.add("r3:1")
        m4 = {k: ring.node_for(k) for k in keys}
        spill = {k: list(ring.nodes_for(k)) for k in keys[:50]}
        ring.remove("r3:1")
        m3b = {k: ring.node_for(k) for k in keys}
        assert m3b == m3     # the restore is exact
        maps[name] = (m3, m4, spill)
    assert maps["port"] == maps["jax"]
    m3, m4, _ = maps["port"]
    moved = [k for k in keys if m3[k] != m4[k]]
    assert 0.10 * len(keys) < len(moved) < 0.45 * len(keys)
    assert all(m4[k] == "r3:1" for k in moved)


# -- the policy over the same replica states ----------------------------------

def _doc(depth=0, active=0, **kw):
    return {"status": "ok", "queue_depth": depth,
            "active_requests": active, **kw}


def _scenario(pkg):
    """One walk through every branch of the pick; returns the trail of
    (replica, outcome) decisions and refusals."""
    Tracker, Policy, NoReplica = PACKAGES[pkg]
    trail = []
    docs = {"a:1": _doc(), "b:1": _doc(), "c:1": _doc()}
    t = Tracker(list(docs), fetch=lambda n: dict(docs[n]))
    t.poll_once()
    p = Policy(t, load_watermark=4)
    for key in ("tenant-key", "other", None):
        d = p.route(key=key)
        trail.append((d.replica, d.outcome))
    target = p.ring.node_for("tenant-key")
    docs[target]["queue_depth"] = 10       # over the watermark: spill
    t.poll_once()
    d = p.route(key="tenant-key")
    trail.append((d.replica, d.outcome))
    for n in docs:                          # all over: least loaded
        docs[n]["queue_depth"] = 20
    docs[list(p.ring.nodes_for("tenant-key"))[2]]["queue_depth"] = 19
    t.poll_once()
    d = p.route(key="tenant-key")
    trail.append((d.replica, d.outcome))
    for n in docs:
        docs[n]["queue_depth"] = 0
    # sticky: a drained home still takes its key's retries, an ejected
    # one does not, and the re-admission re-homes the key
    t.poll_once()
    d = p.route(key="k", idem_key="idem-1")
    p.note_admitted("idem-1", d.replica)
    home = d.replica
    docs[home].update(draining=True, queue_depth=3)
    t.poll_once()
    d = p.route(key="k", idem_key="idem-1")
    trail.append((d.replica, d.outcome))
    t.note_failure(home, hard=True)
    d = p.route(key="k", idem_key="idem-1")
    trail.append((d.replica, d.outcome))
    p.note_admitted("idem-1", d.replica)
    docs[home].update(draining=False, queue_depth=0)
    t.poll_once(now=t.get(home).next_probe + 1e-3)
    d = p.route(key="k", idem_key="idem-1")
    trail.append((d.replica, d.outcome))
    # a tripped breaker takes nothing
    docs["a:1"]["recovery"] = {"breaker": {"tripped": True}}
    t.poll_once()
    trail += [(p.route(key=f"x{i}").replica, "breaker") for i in range(6)]
    # round robin rotates over the admitting replicas
    rr = Policy(t, mode="round_robin")
    trail += [(rr.route(key="same").replica, "rr") for _ in range(4)]
    # nobody admits: the refusal carries the replicas' smallest ETA
    for n, eta in (("a:1", 7.5), ("b:1", 3.0), ("c:1", 5.0)):
        docs[n].update(draining=True, drain={"eta_s": eta})
    t.poll_once()
    with pytest.raises(NoReplica) as ei:
        p.route(key="k2")
    trail.append(("refused", ei.value.retry_after_s))
    # the backoff of a failing replica, seeded from its name
    for name in ("a:1", "b:1"):
        st = t.get(name)
        st.failures = 3
        trail.append((name, t._backoff_s(st)))
    return trail


def test_policy_picks_equal_jaxs():
    port, jax_ = _scenario("port"), _scenario("jax")
    assert port == jax_
    outcomes = {o for _, o in port}
    assert {"hit", "spill", "sticky"} <= outcomes


# -- the proxy's bytes --------------------------------------------------------

class _Scripted:
    """A scripted replica: lite health and one chat behavior, no engine."""

    def __init__(self, behavior="ok", events=3):
        scripted = self
        self.behavior = behavior

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                data = json.dumps({"status": "ok", "queue_depth": 0,
                                   "active_requests": 0,
                                   "replica": "scripted"}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if scripted.behavior == "bad400":
                    data = b'{"error": "unknown priority class"}'
                    self.send_response(400)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if scripted.behavior == "shed429":
                    data = b'{"error": "request shed", "retry_after_s": 7}'
                    self.send_response(429)
                    self.send_header("Retry-After", "7")
                    self.send_header("x-cake-replica", "scripted")
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("x-cake-replica", "scripted")
                self.send_header("x-cake-rid", "41")
                self.end_headers()

                def chunk(payload: bytes):
                    self.wfile.write(hex(len(payload))[2:].encode()
                                     + b"\r\n" + payload + b"\r\n")
                    self.wfile.flush()

                for i in range(events):
                    chunk(b"id: %d\ndata: {\"tok\": %d}\n\n" % (i + 1, i))
                if scripted.behavior == "die":
                    import socket
                    self.connection.shutdown(socket.SHUT_RDWR)
                    self.close_connection = True
                    return
                chunk(b"data: [DONE]\n\n")
                chunk(b"")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self.addr = f"127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _through(pkg, addr):
    """(status, headers of interest, body bytes) of one streamed chat
    through `pkg`'s router over the replica at addr; the minted trace id
    is masked (a uuid a request)."""
    if pkg == "jax":
        from cake_tpu.router import start_router
    else:
        from cake_tpu_torch.router import start_router
    httpd, router = start_router([addr], address="127.0.0.1:0",
                                 block=False, poll_interval_s=0.05)
    router.tracker.poll_once()
    try:
        conn = http.client.HTTPConnection(
            f"127.0.0.1:{httpd.server_address[1]}", timeout=30)
        conn.request("POST", "/api/v1/chat/completions",
                     body=json.dumps({"messages": [
                         {"role": "user", "content": "hi"}],
                         "stream": True}),
                     headers={"Content-Type": "application/json",
                              "x-cake-idempotency-key": "key-1"})
        resp = conn.getresponse()
        body = resp.read()
        conn.close()
        trace = resp.getheader("x-cake-trace") or ""
        heads = {k: resp.getheader(k) for k in (
            "Content-Type", "Retry-After", "x-cake-replica", "x-cake-rid")}
        heads["trace-minted"] = bool(re.fullmatch(r"[0-9a-f]{32}", trace))
        return resp.status, heads, body.replace(trace.encode(), b"<trace>")
    finally:
        httpd.shutdown()
        router.close()


@pytest.mark.parametrize("behavior", ["ok", "die", "shed429"])
def test_sse_bytes_through_the_router_equal_jaxs(behavior):
    replica = _Scripted(behavior)
    try:
        port = _through("port", replica.addr)
        jax_ = _through("jax", replica.addr)
    finally:
        replica.close()
    assert port == jax_
    status, heads, body = port
    if behavior == "ok":
        assert status == 200 and b"id: 3\n" in body
        assert body.rstrip().endswith(b"data: [DONE]")
        assert heads["x-cake-rid"] == "41" and heads["trace-minted"]
    elif behavior == "die":
        err = [ln for ln in body.decode().splitlines()
               if ln.startswith('data: {"error"')]
        assert json.loads(err[0][6:])["error"]["type"] == "ReplicaDownError"
    else:
        assert status == 429 and heads["Retry-After"] == "7"
        assert heads["x-cake-replica"] == "scripted"


def test_a_relayed_refusal_keeps_its_hop_record():
    """A replica's 400 is relayed as it is and the hop record finishes
    "relayed" with the code as `http_status`. JAX's router passes the
    code as `status=`, which collides with HopTracer.finish's own
    argument: its handler thread raises and the client's connection
    drops with no response (a deliberate divergence)."""
    from cake_tpu_torch.router import start_router
    replica = _Scripted("bad400")
    httpd, router = start_router([replica.addr], address="127.0.0.1:0",
                                 block=False, poll_interval_s=0.05)
    router.tracker.poll_once()
    try:
        conn = http.client.HTTPConnection(
            f"127.0.0.1:{httpd.server_address[1]}", timeout=30)
        conn.request("POST", "/api/v1/chat/completions",
                     body=json.dumps({"messages": [
                         {"role": "user", "content": "hi"}]}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 400
        assert json.loads(resp.read()) == {
            "error": "unknown priority class"}
        trace = resp.getheader("x-cake-trace")
        conn.close()
        # the refusal reaches the client before the handler finishes
        # the record: wait on the record's state, not on a sleep
        deadline = time.monotonic() + 30.0
        rec = router.hops.get(trace)
        while rec["status"] not in HOP_TERMINAL and \
                time.monotonic() < deadline:
            time.sleep(0.01)
            rec = router.hops.get(trace)
        assert rec["status"] == "relayed"
        assert rec["spans"][-1]["http_status"] == 400
    finally:
        httpd.shutdown()
        router.close()
        replica.close()


# -- the flags ----------------------------------------------------------------

@pytest.mark.parametrize("spec", ["h:1,g:2", "nohost", "h:port", "h:1,h:1",
                                  "h:0", ",", " a:1 , b:2 "])
def test_parse_replicas_equals_jaxs(spec):
    from cake_tpu.args import parse_replicas as jp
    from cake_tpu_torch.args import parse_replicas as tp

    def run(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return f"ValueError: {e}"

    assert run(tp) == run(jp)


@pytest.mark.parametrize("kw", [
    dict(router=True, replicas="h:1,g:2"), dict(router=True),
    dict(router=True, router_announce="127.0.0.1:0"),
    dict(router_policy="wat"), dict(router_watermark=0),
    dict(router_poll=0.0), dict(announce_interval=0.0),
    dict(router_announce="nope"), dict(router_announce="h:70000"),
    dict(router_anomaly_weighting=True),
    dict(router_anomaly_weighting=True, sentinel=True),
])
def test_router_flags_validate_as_jaxs(kw):
    from cake_tpu.args import Args as JArgs
    from cake_tpu_torch.args import Args as TArgs

    def run(cls):
        try:
            cls(**kw).validate()
            return "ok"
        except ValueError as e:
            return str(e)

    assert run(TArgs) == run(JArgs)


def test_router_flag_defaults_are_jaxs():
    from cake_tpu.args import Args as JArgs
    from cake_tpu_torch.args import parse_args
    a, j = parse_args([]), JArgs()
    for name in ("router", "replicas", "router_announce",
                 "announce_interval", "router_watermark", "router_poll",
                 "router_policy", "router_anomaly_weighting"):
        assert getattr(a, name) == getattr(j, name), name
    b = parse_args(["--router", "--replicas", "a:1", "--router-poll", "0.5",
                    "--router-policy", "round_robin", "--router-watermark",
                    "3", "--announce-interval", "1.5",
                    "--router-announce", "127.0.0.1:0"])
    assert (b.router, b.replicas, b.router_poll, b.router_policy,
            b.router_watermark, b.announce_interval, b.router_announce) \
        == (True, "a:1", 0.5, "round_robin", 3, 1.5, "127.0.0.1:0")
