"""The port's fleet telemetry federation (`cake_tpu_torch/obs/
federation.py`) and its server surfaces against the JAX package.

  * Two exporters give per-host views (metrics, events, applied seq),
    host-tagged event reads and one TYPE block a federated family.
  * A skewed exporter clock is corrected by the min-offset, and a wall
    clock step resets it.
  * A wrong or missing token registers nothing; the `max_hosts` cap
    refuses a third host, deterministically (each hello is awaited: the
    third until the collector has closed its socket).
  * An exporter in a child process reaches the collector.
  * The served engine: `GET /api/v1/fleet` (without a collector, JAX's
    single-host answer and note), `?host=` events (local, remote,
    unknown: JAX's messages), host-labelled families on `/metrics`, and
    a request's timeline merged with the remote host's events.
  * `dump_registry` equals JAX's for the same families; a port
    exporter's frames ingested by JAX's collector, and a JAX exporter's
    by the port's, give the same hosts and `render_federated` text.

Waits poll a condition under a deadline; nothing sleeps a fixed time.
"""

import json
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from cake_tpu_torch.obs import metrics as m
from cake_tpu_torch.obs.events import EventBus
from cake_tpu_torch.obs.federation import (
    TelemetryCollector, TelemetryExporter, dump_registry,
)
from cake_tpu_torch.utils.wire import LEN

TOKEN = "fed-test-token"
ROOT = Path(__file__).resolve().parents[1]


def _until(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    assert cond(), f"timed out waiting for {what}"


def _exporter(col, host, **kw):
    kw.setdefault("registry", m.Registry())
    return TelemetryExporter(f"127.0.0.1:{col.port}", host=host,
                             token=kw.pop("token", TOKEN), interval_s=30.0,
                             start=False, **kw)


def test_two_exporters_give_per_host_views():
    col = TelemetryCollector(host="127.0.0.1", token=TOKEN,
                             local_host="proc0")
    exps = []
    try:
        for i, applied in ((1, 7), (2, 9)):
            reg = m.Registry()
            m.Counter("fed_demo_total", "demo", labelnames=("k",),
                      registry=reg).labels(k=f"host{i}").inc(i)
            bus = EventBus(capacity=64, observe_metrics=False)
            bus.publish("kv_spill", rid=100 + i, pages=i)
            exp = _exporter(col, f"proc{i}", registry=reg, events=bus,
                            applied_seq=lambda a=applied: a)
            assert exp.flush()
            exps.append(exp)
        _until(lambda: all(col.fleet()["hosts"].get(h, {}).get("frames")
                           for h in ("proc1", "proc2")), "both frames")
        fleet = col.fleet()
        assert fleet["hosts"]["proc1"]["applied_seq"] == 7
        assert fleet["hosts"]["proc2"]["applied_seq"] == 9
        assert fleet["published_seq"] is None      # no control server
        assert fleet["hosts"]["proc1"]["lag_ops"] is None
        assert all(fleet["hosts"][h]["live"] for h in ("proc1", "proc2"))
        evs1 = col.events_for(host="proc1")
        assert [e["rid"] for e in evs1] == [101]
        assert evs1[0]["host"] == "proc1"
        assert {e["host"] for e in col.events_for(type="kv_spill")} == {
            "proc1", "proc2"}
        assert col.events_for(host="nosuch") == []
        text = col.render_federated(set())
        assert text.count("# TYPE fed_demo_total counter") == 1
        assert 'fed_demo_total{k="host1",host="proc1"} 1' in text
        assert 'fed_demo_total{k="host2",host="proc2"} 2' in text
    finally:
        for exp in exps:
            exp.close(flush=False)
        col.close()


class _SkewBus:
    """An event source stamping with the same (skewed) clock the
    exporter samples, as the exporter's contract asks."""

    def __init__(self, clock):
        self.clock = clock
        self.evs = []

    def publish(self, type_, rid, **fields):
        self.evs.append({"seq": len(self.evs) + 1, "ts": self.clock(),
                         "type": type_, "rid": rid, **fields})

    def snapshot(self, since=None):
        evs = [e for e in self.evs if since is None or e["seq"] > since]
        return list(evs), (evs[-1]["seq"] if evs else (since or 0))


@pytest.mark.parametrize("case", ["skew", "step"])
def test_clock_offset_and_wall_clock_step(case):
    """A host 120 s ahead: its offset recovers the skew and its events
    merge at their true time beside an honest host's (publish order
    kept; each publish waits for the clock to move). A host whose wall
    clock steps back 50 s after the offset converged: the mono sample
    detects the step and the offset re-converges."""
    col = TelemetryCollector(host="127.0.0.1", token=TOKEN,
                             local_host="proc0")
    try:
        if case == "step":
            step = {"wall": 0.0}
            exp = _exporter(col, "stepper",
                            clock=lambda: time.time() + step["wall"])
            assert exp.flush()
            _until(lambda: col.fleet()["hosts"].get("stepper", {}).get(
                "frames", 0) >= 1, "first frame")
            assert abs(col.fleet()["hosts"]["stepper"]["clock_offset_s"]) \
                < 1.0
            step["wall"] = -50.0
            assert exp.flush()
            _until(lambda: col.fleet()["hosts"]["stepper"]["frames"] >= 2,
                   "post-step frame")
            off = col.fleet()["hosts"]["stepper"]["clock_offset_s"]
            assert abs(off - 50.0) < 1.0, off
            exp.close(flush=False)
            return
        skew_clock = lambda: time.time() + 120.0  # noqa: E731
        skew_bus, true_bus = _SkewBus(skew_clock), _SkewBus(time.time)
        skewed = _exporter(col, "skewed", events=skew_bus, clock=skew_clock)
        honest = _exporter(col, "honest", events=true_bus)
        t_first = time.time()
        for order, bus, t in ((1, skew_bus, "kv_spill"),
                              (2, true_bus, "kv_restore"),
                              (3, skew_bus, "prefix_hit")):
            t0 = time.time()
            while time.time() - t0 < 0.02:
                pass
            bus.publish(t, rid=1, order=order)
        assert skewed.flush() and honest.flush()
        _until(lambda: len(col.events_for(rid=1)) == 3, "three events")
        fleet = col.fleet()
        assert abs(fleet["hosts"]["skewed"]["clock_offset_s"] + 120.0) < 1.0
        assert abs(fleet["hosts"]["honest"]["clock_offset_s"]) < 1.0
        merged = col.events_for(rid=1)
        assert [e["order"] for e in merged] == [1, 2, 3]
        assert abs(merged[0]["ts"] - t_first) < 1.0
        skewed.close(flush=False)
        honest.close(flush=False)
    finally:
        col.close()


def _closed_by_peer(raw) -> bool:
    raw.settimeout(10)
    try:
        return raw.recv(1) == b""
    except OSError:
        return True


@pytest.mark.parametrize("hello", ["wrong_token", "no_token"])
def test_unauthenticated_exporter_is_refused(hello):
    col = TelemetryCollector(host="127.0.0.1", token=TOKEN,
                             local_host="proc0")
    try:
        raw = socket.create_connection(("127.0.0.1", col.port), timeout=5)
        body = (json.dumps({"v": 1, "host": "evil", "token": "wrong"})
                .encode() if hello == "wrong_token" else b"{}")
        raw.sendall(LEN.pack(len(body)) + body)
        assert _closed_by_peer(raw), "the collector must close the socket"
        raw.close()
        assert col.hosts() == []
    finally:
        col.close()


def test_max_hosts_cap_refuses_a_third_host():
    """Each host's hello is awaited before the next connects, and the
    third is held until the collector closed its socket: no timing
    decides which two hosts register."""
    col = TelemetryCollector(host="127.0.0.1", token=TOKEN,
                             local_host="proc0", max_hosts=2)
    exps = []
    try:
        for name in ("a", "b"):
            exp = _exporter(col, name)
            assert exp.flush()
            exps.append(exp)
            _until(lambda n=name: n in col.hosts(), f"host {name}")
        raw = socket.create_connection(("127.0.0.1", col.port), timeout=5)
        body = json.dumps({"v": 1, "host": "c", "token": TOKEN}).encode()
        raw.sendall(LEN.pack(len(body)) + body)
        assert _closed_by_peer(raw)
        raw.close()
        assert col.hosts() == ["a", "b"]
    finally:
        for exp in exps:
            exp.close(flush=False)
        col.close()


CHILD = """
import sys
from cake_tpu_torch.obs import metrics as m
from cake_tpu_torch.obs.events import EventBus
from cake_tpu_torch.obs.federation import TelemetryExporter
reg = m.Registry()
m.Gauge("fed_child_demo", "child", registry=reg).set(3)
bus = EventBus(capacity=8, observe_metrics=False)
bus.publish("kv_adopted", rid=5, pages=2, dtype="float32")
exp = TelemetryExporter(sys.argv[1], host="child", token=sys.argv[2],
                        interval_s=30.0, registry=reg, events=bus,
                        start=False)
assert exp.flush()
exp.close(flush=False)
"""


def test_an_exporter_in_a_child_process():
    col = TelemetryCollector(host="127.0.0.1", token=TOKEN,
                             local_host="proc0")
    try:
        out = subprocess.run(
            [sys.executable, "-c", CHILD, f"127.0.0.1:{col.port}", TOKEN],
            cwd=ROOT, capture_output=True, text=True, timeout=120,
            env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
        assert out.returncode == 0, out.stderr[-2000:]
        _until(lambda: col.events_for(host="child"), "the child's event")
        assert col.events_for(host="child")[0]["type"] == "kv_adopted"
        assert 'fed_child_demo{host="child"} 3' in col.render_federated(
            set())
    finally:
        col.close()


# -- the served engine ---------------------------------------------------------


def _http(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            body = r.read()
            return r.status, (json.loads(body) if r.headers.get(
                "Content-Type", "").startswith("application/json")
                else body.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _engine():
    import torch

    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    return InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), device="cpu",
        max_slots=2, max_seq_len=64, kv_pages=16, kv_page_size=16,
        cache_dtype=torch.float32,
        sampling=SamplingConfig(temperature=0.0))


class _Master:
    def __init__(self):
        from cake_tpu_torch.args import Args
        self.args = Args()


def _jax_api(collector=None):
    from cake_tpu.api.server import ApiServer as JApi
    return JApi(None, collector=collector)


def test_fleet_routes_without_a_collector():
    """The single-host answer and JAX's note; ?host= names only this
    host, anything else is a 400 with JAX's message."""
    from cake_tpu_torch.api.server import start

    eng = _engine()
    httpd = start(_Master(), "127.0.0.1:0", block=False, engine=eng)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/api/v1"
    try:
        code, fleet = _http(url + "/fleet")
        want = _jax_api().fleet()
        assert code == 200
        assert fleet["note"] == want["note"]
        assert fleet["local_host"] == want["local_host"] == "coordinator"
        local = fleet["hosts"]["coordinator"]
        assert (local["role"], local["live"]) == ("coordinator", True)
        assert set(local) >= set(want["hosts"]["coordinator"])
        code, evs = _http(url + "/events?host=local")
        assert code == 200 and evs["host"] == "local"
        code, err = _http(url + "/events?host=proc9")
        assert code == 400
        with pytest.raises(ValueError) as theirs:
            _jax_api().events(host="proc9")
        assert err["error"] == str(theirs.value)
    finally:
        httpd.shutdown()
        eng.stop()


def test_fleet_server_with_a_collector():
    """A remote host's exporter feeds the served engine's collector:
    /api/v1/fleet lists both hosts, ?host= serves the remote stream
    (an unknown host is JAX's 400), /metrics carries the remote families
    with a host label, and a request's timeline merges the remote host's
    events for its rid."""
    from cake_tpu_torch.api.server import start

    eng = _engine()
    col = TelemetryCollector(host="127.0.0.1", token=TOKEN,
                             local_host="proc0")
    reg = m.Registry()
    m.Gauge("fed_remote_demo", "remote-only federated family",
            registry=reg).set(1)
    bus = EventBus(capacity=64, observe_metrics=False)
    exp = _exporter(col, "proc1", registry=reg, events=bus)
    httpd = start(_Master(), "127.0.0.1:0", block=False, engine=eng,
                  collector=col)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert eng.telemetry is col
        h = eng.submit([5] * 9, max_new_tokens=4)
        assert h.wait(60)
        rid = h._req.rid
        bus.publish("kv_shipped", pages=1, bytes=64, dtype="float32",
                    wall_s=0.001)
        bus.publish("kv_ship_degraded", rid=rid)
        assert exp.flush()
        _until(lambda: len(col.events_for(host="proc1")) == 2,
               "the remote events")
        code, fleet = _http(url + "/api/v1/fleet")
        assert code == 200 and fleet["local_host"] == "proc0"
        assert set(fleet["hosts"]) == {"proc0", "proc1"}
        assert fleet["hosts"]["proc1"]["frames"] == 1
        assert "note" not in fleet
        code, evs = _http(url + "/api/v1/events?host=proc1")
        assert code == 200 and evs["host"] == "proc1"
        assert [e["type"] for e in evs["events"]] == [
            "kv_shipped", "kv_ship_degraded"]
        assert evs["cursor"] == 2
        code, page = _http(url + "/api/v1/events?host=proc1&limit=1")
        assert [e["type"] for e in page["events"]] == ["kv_shipped"]
        assert page["cursor"] == 1
        code, err = _http(url + "/api/v1/events?host=proc7")
        with pytest.raises(ValueError) as theirs:
            _jax_api(col).events(host="proc7")
        assert code == 400 and err["error"] == str(theirs.value)
        code, text = _http(url + "/metrics")
        assert code == 200
        assert 'fed_remote_demo{host="proc1"} 1' in text
        assert text.count("# TYPE fed_remote_demo gauge") == 1
        assert 'cake_fleet_host_up{host="proc1"} 1' in text
        code, tl = _http(url + f"/api/v1/requests/{rid}/timeline")
        assert code == 200
        remote = [e for e in tl["timeline"] if e.get("host") == "proc1"]
        assert [e["event"] for e in remote] == ["kv_ship_degraded"]
    finally:
        httpd.shutdown()
        eng.stop()
        exp.close(flush=False)
        col.close()


# -- the two packages ----------------------------------------------------------


def _families(mod):
    """The same families and operations in one package's registry."""
    reg = mod.Registry()
    c = mod.Counter("fed_x_total", "a counter", labelnames=("k",),
                    registry=reg)
    c.labels(k="a").inc(2)
    c.labels(k="b\"q").inc(1)
    mod.Gauge("fed_g", "a gauge", registry=reg).set(1.5)
    hst = mod.Histogram("fed_h_seconds", "a histogram",
                        labelnames=("path",), registry=reg,
                        buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        hst.labels(path="p").observe(v)
    return reg


def test_dump_registry_equals_jax():
    from cake_tpu.obs import federation as jfed
    from cake_tpu.obs import metrics as jm

    assert dump_registry(_families(m)) == jfed.dump_registry(
        _families(jm))
    assert dump_registry(_families(m), prefixes=("fed_h",)) == \
        jfed.dump_registry(_families(jm), prefixes=("fed_h",))


def test_each_package_collects_the_others_frames():
    """A port exporter into JAX's collector and a JAX exporter into the
    port's, each beside an exporter of the collector's own package: the
    same hosts, frames and federated text."""
    from cake_tpu.obs import federation as jfed
    from cake_tpu.obs import metrics as jm
    from cake_tpu.obs.events import EventBus as JBus

    texts, hosts = [], []
    for col_mod, exp_mods in (
            (jfed, ((m, EventBus, TelemetryExporter), (jm, JBus,
                                                       jfed.TelemetryExporter))),
            (None, ((jm, JBus, jfed.TelemetryExporter), (m, EventBus,
                                                         TelemetryExporter)))):
        col = (col_mod.TelemetryCollector if col_mod else
               TelemetryCollector)(host="127.0.0.1", token=TOKEN,
                                   local_host="proc0")
        exps = []
        try:
            for i, (mod, bus_cls, exp_cls) in enumerate(exp_mods, 1):
                bus = bus_cls(capacity=8, observe_metrics=False)
                bus.publish("kv_adopted", rid=i, pages=i, dtype="int8")
                exp = exp_cls(f"127.0.0.1:{col.port}", host=f"proc{i}",
                              token=TOKEN, interval_s=30.0,
                              registry=_families(mod), events=bus,
                              applied_seq=lambda i=i: 10 * i, start=False)
                assert exp.flush()
                exps.append(exp)
            _until(lambda: len(col.events_for()) == 2, "both frames")
            fleet = col.fleet()
            hosts.append({h: (e["frames"], e["applied_seq"],
                              e["events_held"])
                          for h, e in fleet["hosts"].items()})
            texts.append(col.render_federated(set()))
        finally:
            for exp in exps:
                exp.close(flush=False)
            col.close()
    assert hosts[0] == hosts[1] == {"proc1": (1, 10, 1),
                                    "proc2": (1, 20, 1)}
    # the JAX collector's proc1 is the port's exporter and the port
    # collector's proc2 is: swapping the two packages' exporters gives
    # the same text
    assert texts[0] == texts[1]
    assert 'fed_x_total{k="a",host="proc1"} 2' in texts[0]
