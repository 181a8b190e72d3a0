"""The port's serving health plane (`cake_tpu_torch/parallel/health.py`)
and its wiring into `api/server.start`, the counterparts of
tests/test_checkpoint_health.py's detection cases:

  * the device probe answers on the CPU;
  * a heartbeat monitor reports a lost worker, and a worker registered
    as expected that never beats;
  * the watchdog fires before the first token, fires on a stall and
    re-arms after progress or an idle interval;
  * a lapsed heartbeat fails serving: the in-flight request is failed
    (not left hanging), a new chat gets a 503 with the reason,
    /api/v1/health reads "failed" with JAX's reason, `cake_serving_
    healthy` is 0 and the fleet's local host is not live;
  * single-process `start` always arms a ServingHealth over its engine
    (the watchdog of --stall-timeout), which a wedged engine fails.

The failure reasons and the wire format are JAX's, checked against the
JAX package where a string is shared. Waits poll a condition under a
deadline.
"""

import json
import time
import urllib.error
import urllib.request

import pytest

from cake_tpu_torch.parallel.health import (
    HeartbeatMonitor, HeartbeatSender, ServingHealth, Watchdog,
    probe_devices,
)

PROMPT = [5, 6, 7, 8, 9]


def _until(cond, what, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    assert cond(), f"timed out waiting for {what}"


def _engine(**kw):
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    import torch
    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    return InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), max_slots=2,
        max_seq_len=128, device="cpu",
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0), **kw)


def _jax_reason(kind: str, stall_after_s: float = 3600.0) -> str:
    """The reason JAX's ServingHealth gives for a lost worker w1
    ("heartbeat") or a stall ("stall"), over a stand-in engine."""
    import types

    from cake_tpu.parallel.health import ServingHealth as JHealth

    failed = []
    eng = types.SimpleNamespace(
        stats=types.SimpleNamespace(tokens_generated=0),
        active=1 if kind == "stall" else 0, paged=False,
        _fail_all=lambda err, snapshot=False: failed.append(err))
    h = JHealth(eng, stall_after_s=stall_after_s)
    try:
        if kind == "heartbeat":
            h.expect_workers(["w1"], stale_after_s=0.2)
        _until(lambda: h.reason is not None, "JAX's reason", timeout=15)
        assert failed
        return h.reason
    finally:
        h.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _chat(base):
    req = urllib.request.Request(
        base + "/api/v1/chat/completions",
        data=json.dumps({"messages": [
            {"role": "user", "content": "x"}], "max_tokens": 2}).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=30)


def test_probe_devices_ok_on_cpu():
    reports = probe_devices(timeout_s=30.0, devices=["cpu"])
    assert reports and all(r.ok for r in reports)
    assert reports[0].device == "cpu" and reports[0].latency_s >= 0


def test_heartbeat_detects_lost_worker():
    lost = []
    mon = HeartbeatMonitor(on_failure=lost.append, stale_after_s=0.6,
                           sweep_interval_s=0.1)
    try:
        a = HeartbeatSender(mon.address, "worker-a", interval_s=0.1)
        b = HeartbeatSender(mon.address, "worker-b", interval_s=0.1)
        _until(lambda: len(mon.last_seen) == 2, "two workers")
        assert set(mon.last_seen) == {"worker-a", "worker-b"}
        assert mon.stale() == []
        # the monitor acks each beat: the sender's liveness reads it
        _until(lambda: a.alive_within(1.0), "an acked beat")

        b.close()  # worker-b dies
        _until(lambda: "worker-b" in lost, "worker-b's failure")
        assert lost == ["worker-b"]
        assert mon.stale() == ["worker-b"]
        a.close()
    finally:
        mon.close()


def test_heartbeat_detects_never_started_worker():
    failures = []
    mon = HeartbeatMonitor(on_failure=failures.append,
                           stale_after_s=0.4, sweep_interval_s=0.1,
                           expected=["alive", "neverstarted"])
    try:
        s = HeartbeatSender(mon.address, "alive", interval_s=0.1)
        _until(lambda: "neverstarted" in failures, "the roster gap")
        assert "alive" not in failures
        s.close()
    finally:
        mon.close()


def test_watchdog_fires_on_stall_and_rearms():
    value, active, stalls = [0], [False], []
    wd = Watchdog(lambda: value[0], stall_after_s=0.3,
                  on_stall=lambda: stalls.append(time.monotonic()),
                  active=lambda: active[0], poll_interval_s=0.05)
    try:
        time.sleep(0.6)      # idle, counter never advanced: no stall
        assert stalls == []
        active[0] = True
        for _ in range(5):   # progress: no stall
            value[0] += 1
            time.sleep(0.05)
        assert stalls == []
        _until(lambda: len(stalls) == 1, "the first stall")
        time.sleep(0.4)      # one episode fires once
        assert len(stalls) == 1
        value[0] += 1        # progress resumes, then stalls again
        _until(lambda: len(stalls) == 2, "the re-armed stall")
    finally:
        wd.close()


def test_watchdog_fires_before_first_token():
    value, active, stalls = [0], [False], []
    wd = Watchdog(lambda: value[0], stall_after_s=0.3,
                  on_stall=lambda: stalls.append(time.monotonic()),
                  active=lambda: active[0], poll_interval_s=0.05)
    try:
        time.sleep(0.5)      # idle: the deadline keeps refreshing
        assert stalls == []
        active[0] = True     # admitted; the first token never comes
        _until(lambda: len(stalls) == 1, "a pre-first-token stall")
        # an idle interval ends the episode: a second request that also
        # wedges before its first token fires again
        active[0] = False
        time.sleep(0.3)
        active[0] = True
        _until(lambda: len(stalls) == 2, "the second request's stall")
    finally:
        wd.close()


def test_serving_health_fails_engine_on_heartbeat_loss():
    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master

    eng = _engine()
    health = ServingHealth(eng, stall_after_s=3600)  # watchdog idle here
    hb = health.expect_workers(["w1"], stale_after_s=0.6)
    sender = HeartbeatSender(hb, "w1", interval_s=0.1)
    master = Master(Args(sample_len=4, cpu=True), text_generator=None)
    httpd = start(master, address="127.0.0.1:0", block=False, engine=eng,
                  health=health)
    base = "http://127.0.0.1:%d" % httpd.server_address[1]
    try:
        h = json.loads(_get(base + "/api/v1/health"))
        assert h["status"] == "ok"
        assert "cake_serving_healthy 1" in _get(base + "/metrics").decode()
        # an in-flight request held open by a slow stream consumer
        slow = eng.submit(PROMPT, max_new_tokens=64,
                          stream=lambda d, f: time.sleep(0.25))

        sender.close()              # the worker dies
        _until(lambda: json.loads(_get(base + "/api/v1/health"))[
            "status"] == "failed", "serving to fail", timeout=15)
        h = json.loads(_get(base + "/api/v1/health"))
        # JAX's reason, word for word
        assert h["reason"] == _jax_reason("heartbeat")

        # the in-flight request was drained with an error
        assert slow.wait(timeout=10)
        with pytest.raises(RuntimeError, match="heartbeat lost"):
            slow.text()
        # new work: a 503 with the reason
        with pytest.raises(urllib.error.HTTPError) as e:
            _chat(base)
        assert e.value.code == 503
        assert b"serving failed: worker w1 heartbeat lost" in e.value.read()
        assert "cake_serving_healthy 0" in _get(base + "/metrics").decode()
        fleet = json.loads(_get(base + "/api/v1/fleet"))
        local = fleet["hosts"][fleet["local_host"]]
        assert local["live"] is False
        assert local["health"] == {"status": "failed",
                                   "reason": "worker w1 heartbeat lost"}
        # a drain still answers on a failed server
        req = urllib.request.Request(
            base + "/api/v1/drain", data=b"{}",
            headers={"Content-Type": "application/json"})
        assert urllib.request.urlopen(req, timeout=30).status == 200
    finally:
        httpd.shutdown()
        eng.stop()
        health.close()


def test_single_host_start_always_arms_the_watchdog():
    """start() with no health= arms a ServingHealth over the engine with
    --stall-timeout; an engine that stops making progress with a request
    active then fails serving (recoverably: no snapshot) with JAX's
    stall reason, and the 503 gate and the gauge follow it."""
    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master

    eng = _engine()
    master = Master(Args(sample_len=4, cpu=True, stall_timeout=0.5),
                    text_generator=None)
    real = eng._do_phases
    wedged = []

    def wedge(*a, **kw):      # the device never answers
        wedged.append(1)
        while not eng._stop.is_set():
            time.sleep(0.02)
        return real(*a, **kw)

    eng._do_phases = wedge
    httpd = start(master, address="127.0.0.1:0", block=False, engine=eng)
    base = "http://127.0.0.1:%d" % httpd.server_address[1]
    try:
        h = eng.submit(PROMPT, max_new_tokens=4)
        _until(lambda: wedged, "the wedged step")
        _until(lambda: json.loads(_get(base + "/api/v1/health"))[
            "status"] == "failed", "the watchdog", timeout=15)
        h2 = json.loads(_get(base + "/api/v1/health"))
        assert h2["reason"] == _jax_reason("stall", 0.5)
        assert h.wait(timeout=10)
        with pytest.raises(RuntimeError, match="no progress"):
            h.text()
        with pytest.raises(urllib.error.HTTPError) as e:
            _chat(base)
        assert e.value.code == 503
        assert "cake_serving_healthy 0" in _get(base + "/metrics").decode()
    finally:
        httpd.shutdown()
        eng.stop()
