"""A follower of a two-process --api pair on the CPU (the setup of
tests/test_torch_multihost.py: gloo, a 2-stage x tp 2 topology split by
process, f32, greedy) is killed (SIGKILL) in the middle of a stream at
--decode-scan 1:

  * within --heartbeat-timeout and a sweep, /api/v1/health reads
    "failed" with a reason naming proc1, and a new chat gets a 503;
  * the in-flight request was snapshotted before it failed: the pre-fail
    checkpoint holds it unfinished, token-exact so far against JAX's
    single-process engine, and the coordinator's SIGTERM keeps it;
  * a restarted pair restores it from the checkpoint and decodes on:
    its whole transcript is a prefix of JAX's uninterrupted one.
"""

import json
import signal
import subprocess
import time
import urllib.error
import urllib.request

import pytest

from test_torch_multihost import (
    MESSAGES, _http_json, _kill_all, _launch, _stream, _until, jax_world,
)

N_LONG = 128


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's engine's uninterrupted long transcript of MESSAGES."""
    return jax_world(tmp_path_factory.mktemp("failover"),
                     [(512, N_LONG, MESSAGES)])


def test_killed_follower_fails_serving_and_a_restart_resumes(world):
    text, want_prompt, want_out = world["chats"][0]
    extra = ["--decode-scan", "1", "--max-seq-len", "512"]
    procs, base, ckpt, tail = _launch(
        world, "failover", ["--heartbeat-timeout", "3"] + extra)
    try:
        killed = []

        def kill(n):
            if n == 2 and not killed:
                procs[1].kill()     # the follower dies mid-stream
                killed.append(time.monotonic())

        body = {"messages": MESSAGES, "max_tokens": N_LONG,
                "temperature": 0.0, "top_p": 1.0}
        try:
            _stream(base, body, on_chunk=kill)
        except OSError:
            pass          # the stream torn down by the failure
        assert killed, "the stream finished before the follower was killed"

        def failed():
            return _http_json("GET", base + "/api/v1/health")[
                "status"] == "failed"
        _until(failed, "serving to fail", timeout=3 + 10)
        assert time.monotonic() - killed[0] < 3 + 10
        health = _http_json("GET", base + "/api/v1/health")
        assert "proc1" in health["reason"], health
        with pytest.raises(urllib.error.HTTPError) as e:
            _http_json("POST", base + "/api/v1/chat/completions",
                       {**body, "max_tokens": 2})
        assert e.value.code == 503
        with open(ckpt) as f:
            snap = json.load(f)
        live = [r for r in snap["requests"]
                if not r["finished"] and not r["error"]]
        assert len(live) == 1, (snap["requests"], tail(0))
        leg1 = live[0]
        assert 1 <= len(leg1["out_tokens"]) < N_LONG
        assert leg1["prompt_ids"] == want_prompt
        assert leg1["out_tokens"] == want_out[:len(leg1["out_tokens"])]
        procs[0].send_signal(signal.SIGTERM)
        try:
            procs[0].wait(60)
        except subprocess.TimeoutExpired:
            pass
    finally:
        _kill_all(procs)
    with open(ckpt) as f:
        kept = json.load(f)
    assert [r for r in kept["requests"]
            if not r["finished"] and not r["error"]], \
        "the SIGTERM shutdown clobbered the pre-fail snapshot"

    # a restarted pair resumes the request from the checkpoint
    procs, base, _, tail = _launch(world, "resume",
                                   ["--heartbeat-timeout", "60"] + extra,
                                   ckpt=ckpt)
    try:
        def progressed():
            m = urllib.request.urlopen(base + "/metrics",
                                       timeout=10).read().decode()
            return next(float(ln.rsplit(" ", 1)[1])
                        for ln in m.splitlines()
                        if ln.startswith("cake_engine_tokens_generated"))\
                >= 5
        _until(progressed, "the resumed request to decode")
        procs[0].send_signal(signal.SIGTERM)
        for p in procs:
            p.wait(60)
    finally:
        _kill_all(procs)
    with open(ckpt) as f:
        final = json.load(f)
    recs = [r for r in final["requests"] if not r["error"]]
    assert len(recs) == 1, (final["requests"], tail(0))
    rec = recs[0]
    assert rec["prompt_ids"] == want_prompt + leg1["out_tokens"]
    got = rec["prompt_ids"] + rec["out_tokens"]
    assert len(rec["out_tokens"]) >= 1
    assert got == (want_prompt + want_out)[:len(got)]
