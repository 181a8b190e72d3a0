"""Fleet discovery in the port's router (`cake_tpu_torch/router/
discovery.py`), held against the JAX package's:

  * an announcer's bytes on the wire (the hello, a frame, the departure
    notice) are byte-identical to JAX's announcer's for the same replica,
    token, health and clocks;
  * a JAX announcer joins the port's router and a port announcer joins
    JAX's router, each registered as "announced" with a clock offset;
  * a departure stops new admissions at once, and the replica is
    forgotten (tracker, ring, weight factors) once its load is zero, in
    both routers alike;
  * a port replica started with `announce=` registers itself with the
    router and sends its departure first when it shuts down.
Waits poll a condition under a deadline.
"""

import json
import socket
import struct
import threading
import time
import urllib.request

import pytest


def _wait(pred, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _pkg(name):
    if name == "jax":
        from cake_tpu.obs import metrics as m
        from cake_tpu.router import discovery, server
    else:
        from cake_tpu_torch.obs import metrics as m
        from cake_tpu_torch.router import discovery, server
    return m, discovery, server


def _doc(load=0, **over):
    d = {"status": "ok", "queue_depth": int(load), "active_requests": 0,
         "now": 1700000000.25}
    d.update(over)
    return d


def _wire_bytes(pkg):
    """The messages one announcer sends: hello, a frame, the departure."""
    m, discovery, _ = _pkg(pkg)
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    got = []

    def accept():
        conn, _ = lst.accept()
        with conn:
            buf = b""
            while True:
                data = conn.recv(1 << 16)
                if not data:
                    return
                buf += data
                # length-prefixed messages (utils/wire.py)
                while len(buf) >= 4:
                    n = struct.unpack(">I", buf[:4])[0]
                    if len(buf) < 4 + n:
                        break
                    got.append(buf[4:4 + n])
                    buf = buf[4 + n:]

    t = threading.Thread(target=accept, daemon=True)
    t.start()
    ann = discovery.ReplicaAnnouncer(
        f"127.0.0.1:{lst.getsockname()[1]}", "127.0.0.1:19000",
        token="s3cret", interval_s=60.0, health=lambda: _doc(load=2),
        registry=m.Registry(), connect_timeout_s=5.0, start=False)
    ex = ann._exporter
    ex._clock = lambda: 1700000000.5
    ex._mono = lambda: 1234.5
    try:
        assert ann.flush(5.0)
        assert ann.depart(timeout_s=5.0)
        assert _wait(lambda: len(got) >= 3)
    finally:
        ann.close(depart=False)
        t.join(timeout=10)
        lst.close()
    return got


def test_announce_bytes_are_jaxs():
    port, jax_ = _wire_bytes("port"), _wire_bytes("jax")
    assert len(port) >= 3
    assert port[:3] == jax_[:3]
    frame = json.loads(port[1])
    assert frame["host"] == "127.0.0.1:19000"
    assert frame["health"]["queue_depth"] == 2
    assert json.loads(port[2])["health"]["departing"] is True


def _router(pkg, **kw):
    _, _, server = _pkg(pkg)
    kw.setdefault("announce", "127.0.0.1:0")
    kw.setdefault("announce_interval_s", 0.1)
    kw.setdefault("forget_grace_s", 2.0)
    return server.RouterServer([], **kw)


@pytest.mark.parametrize("router_pkg,announcer_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_an_announcer_of_either_package_joins_the_others_router(
        router_pkg, announcer_pkg):
    _, discovery, _ = _pkg(announcer_pkg)
    router = _router(router_pkg, announce_token="s3cret")
    name = "127.0.0.1:19002"
    ann = None
    try:
        ann = discovery.ReplicaAnnouncer(
            f"127.0.0.1:{router.discovery.port}", name, token="s3cret",
            interval_s=0.1, health=lambda: _doc(now=time.time()),
            connect_timeout_s=5.0)
        assert _wait(lambda: router.tracker.get(name) is not None)
        st = router.tracker.get(name)
        assert st.admitting and st.source == "announced"
        assert st.clock_offset is not None
        assert router.fleet()["replicas"][name][
            "last_announce_age_s"] is not None
        assert ann.depart(timeout_s=5.0) is True
        assert _wait(lambda: router.tracker.get(name) is None
                     or router.tracker.get(name).departing)
        router.discovery.maintain()
        assert router.tracker.get(name) is None
    finally:
        if ann is not None:
            ann.close(depart=False)
        router.close()


def _depart_then_forget(pkg):
    router = _router(pkg)
    disc = router.discovery
    a, b = "10.0.0.1:9000", "10.0.0.2:9000"
    trail = []
    try:
        disc.on_frame(a, _doc(now=time.time()), None)
        disc.on_frame(b, _doc(now=time.time()), None)
        disc.on_frame(b, _doc(load=3, departing=True, now=time.time()),
                      None)
        st = router.tracker.get(b)
        trail.append((st.departing, st.admitting))
        disc.maintain()
        trail.append(router.tracker.get(b) is not None)
        trail += [router.policy.route(key=f"k{i}").replica
                  for i in range(8)]
        evs, _ = router.events.snapshot(type="replica_departed")
        trail.append([e["replica"] for e in evs])
        disc.on_frame(b, _doc(load=0, departing=True, now=time.time()),
                      None)
        disc.maintain()
        trail += [router.tracker.get(b) is None, b in router.ring.nodes(),
                  router.policy.weight_provenance(b)["factors"]]
    finally:
        router.close()
    return trail


def test_depart_then_forget_is_jaxs():
    port = _depart_then_forget("port")
    assert port == _depart_then_forget("jax")
    assert port[0] == (True, False) and port[1] is True
    assert set(port[2:10]) == {"10.0.0.1:9000"}
    assert port[-3:] == [True, False, {}]


def _tiny_master():
    import torch

    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    eng = InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), max_slots=2,
        max_seq_len=128, kv_pages=24, kv_page_size=8, device="cpu",
        cache_dtype=torch.float32,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0))
    master = Master(Args(sample_len=4, cpu=True), text_generator=None)
    return master, eng


def test_a_port_replica_announces_itself_and_departs_on_shutdown():
    from cake_tpu_torch.api.server import start
    router = _router("port", announce_token="tok")
    master, eng = _tiny_master()
    httpd = start(master, address="127.0.0.1:0", block=False, engine=eng,
                  announce=f"127.0.0.1:{router.discovery.port}",
                  announce_interval_s=0.1, announce_token="tok")
    name = f"127.0.0.1:{httpd.server_address[1]}"
    try:
        assert _wait(lambda: router.tracker.get(name) is not None)
        st = router.tracker.get(name)
        assert st.source == "announced" and st.admitting
        # the pushed frames are the replica's lite health and more
        h = router.discovery.listener.fleet()["hosts"][name]["health"]
        lite = json.loads(urllib.request.urlopen(
            f"http://{name}/api/v1/health?lite=1", timeout=10).read())
        assert set(lite) <= set(h)
        assert h["pool"]["pages_total"] == 24
        httpd.shutdown()     # the serving thread's exit runs the shutdown
        assert _wait(lambda: router.tracker.get(name) is None
                     or router.tracker.get(name).departing)
        assert eng.stopped
    finally:
        httpd.shutdown()
        eng.stop()
        router.close()
