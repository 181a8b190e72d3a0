"""The per-request timeline and the profile route of the port.

  * `build_timeline` (`cake_tpu_torch/obs/timeline.py`) equals JAX's
    (`cake_tpu/obs/timeline.py`) on the same trace, events and step
    records: those of a port engine's request folded by a live switch,
    and a synthetic one with remote-host events;
  * `GET /api/v1/requests/{rid}/timeline` answers a served request's
    merged view (its `reconfigured` entry and its step records) and 404
    for an unknown rid;
  * `POST /api/v1/profile` captures a torch.profiler trace of the live
    server into --profile-dir, starting and stopping the profiler on the
    engine thread, answers 409 while a capture runs and 400 for a bad
    `seconds`;
  * a CPU capture through `utils/profiling.capture_trace` writes a
    Chrome trace file, after `warm_profiler`.
"""

import json
import os
import time
import urllib.error
import urllib.request

import torch

from cake_tpu_torch.obs import steps as obs_steps
from cake_tpu_torch.obs.timeline import build_timeline


def _jax_build(*a, **kw):
    from cake_tpu.obs.timeline import build_timeline as theirs
    return theirs(*a, **kw)


def _engine(**kw):
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.serve.engine import InferenceEngine

    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    return InferenceEngine(cfg, params, ByteTokenizer(cfg.vocab_size),
                           device="cpu", max_slots=2, max_seq_len=64,
                           kv_pages=8, kv_page_size=16,
                           cache_dtype=torch.float32, **kw)


def _folded_request(eng):
    """A request folded by a live switch mid-stream; its rid."""
    h = eng.submit([5, 9, 2, 7, 5, 3], max_new_tokens=12)
    while len(h._req.out_tokens) < 3:
        time.sleep(0.001)
    assert eng.reconfigure(dict(slots=3, kv_pages=8, kv_page_size=16,
                                decode_scan=2)) is True
    assert h.wait(60)
    return h._req.rid


def test_build_timeline_equals_jax():
    eng = _engine()
    with eng:
        rid = _folded_request(eng)
        other = eng.submit([4] * 5, max_new_tokens=3)
        assert other.wait(60)
    trace = eng.tracer.get(rid)
    events = eng.events.dump(rid=rid)
    steps = eng.flight.records_for(rid)
    ours = build_timeline(trace, events, steps)
    assert ours == _jax_build(trace, events, steps)
    assert ours["summary"]["causes"]["reconfigured"] == 1
    assert any(e["event"] == "reconfigured" and e["source"] == "trace"
               for e in ours["timeline"])
    assert any(e["source"] == "steps" for e in ours["timeline"])
    assert steps and all(rid in rec["rids"] for rec in steps)
    # remote-origin events name their hosts in both packages alike
    remote = events + [{"ts": events[0]["ts"] + 1e-3, "type": "kv_restore",
                        "rid": rid, "host": "b:1", "pages": 2},
                       {"ts": 0.5, "type": "preempted", "rid": rid,
                        "host": "a:1"}]
    for host in (None, "local:0", "a:1"):
        assert (build_timeline(trace, remote, steps, local_host=host)
                == _jax_build(trace, remote, steps, local_host=host))


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
    def __init__(self, profile_dir):
        from cake_tpu_torch.args import Args
        self.args = Args(profile_dir=profile_dir)


def test_timeline_and_profile_routes(tmp_path):
    from cake_tpu_torch.api.server import start

    eng = _engine(autotune="manual")
    pdir = str(tmp_path / "prof")
    httpd = start(_Master(pdir), "127.0.0.1:0", block=False, engine=eng)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/api/v1"
    try:
        rid = _folded_request(eng)
        code, tl = _http(f"{url}/requests/{rid}/timeline")
        assert code == 200 and tl["rid"] == rid
        assert tl["status"] == "retired" and tl["config_epoch"] == 0
        assert [e for e in tl["timeline"] if e["event"] == "reconfigured"]
        assert [e for e in tl["timeline"] if e["source"] == "steps"]
        assert _http(f"{url}/requests/99999/timeline")[0] == 404
        # a capture of the live server lands in --profile-dir; the
        # profiler starts and stops on the engine thread
        threads = []
        real = eng._run_on_engine_thread

        def on_engine(fn, **kw):
            threads.append(getattr(fn, "__name__", "?"))
            return real(fn, **kw)

        eng._run_on_engine_thread = on_engine
        code, out = _http(url + "/profile", {"seconds": 0.2})
        eng._run_on_engine_thread = real
        assert code == 200 and out["dir"] == pdir
        assert os.path.getsize(out["trace"]) > 0
        assert threads == ["start", "stop"]
        # single flight: while one capture runs, another is a 409
        assert obs_steps.PROFILER._lock.acquire(blocking=False)
        try:
            code, err = _http(url + "/profile", {"seconds": 0.2})
        finally:
            obs_steps.PROFILER._lock.release()
        assert code == 409 and "in progress" in err["error"]
        for body in ({"seconds": "x"}, {"seconds": 0},
                     {"seconds": 1000}, {"seconds": True}):
            assert _http(url + "/profile", body)[0] == 400
        # the route counter keys every timeline under one template
        text = urllib.request.urlopen(
            url.replace("/api/v1", "/metrics"), timeout=60).read().decode()
        assert ('route="/api/v1/requests/{rid}/timeline",status="404"'
                in text)
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_cpu_capture_writes_a_trace(tmp_path):
    from cake_tpu_torch.utils.profiling import capture_trace, warm_profiler

    assert warm_profiler() >= 0.0
    out = capture_trace(0.05, str(tmp_path / "p"))
    assert out["dir"] == str(tmp_path / "p")
    with open(out["trace"]) as f:
        assert "traceEvents" in json.load(f)
    assert out["seconds"] >= 0.05
