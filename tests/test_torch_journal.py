"""The port's write-ahead request journal (`cake_tpu_torch/serve/journal.py`)
against the JAX package's, and the engine's and the HTTP server's
durable-serving seams.

  * For one scripted sequence of admits, emits, flushes, retires, a
    size-triggered compaction and a checkpoint truncate, the port writes
    JAX's records, line for line (clocks stripped; the header's
    fingerprint is compared apart: the port's carries its framework).
  * `replay_state` of a journal the JAX package wrote equals JAX's own,
    and the reverse; `read_records` reads torn tails and mid-file
    corruption as JAX does.
  * The three fsync modes fsync as often as JAX's; the `journal.append`,
    `journal.fsync` and `journal.replay` sites fire where JAX's do.
  * The engine (tiny config, f32, greedy): a journaled engine abandoned
    mid-stream (the state a kill -9 leaves), then `recover` into a fresh
    engine: the joined streams are an uninterrupted run's; a retried
    submit with the same idempotency key attaches instead of admitting.
  * Through the HTTP server: a keyed SSE stream's client reconnects with
    Last-Event-ID after a restart and receives exactly the missing
    suffix; a plain retry attaches to the finished transcript.
"""

import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.serve import journal as tjournal

GEN = 12
P1 = [5] * 9
P2 = [2, 9, 4, 7, 3]


def _req(rid, ids, key=None, replayed=(), prime=(), out=()):
    return types.SimpleNamespace(
        rid=rid, prompt_ids=list(ids), max_new_tokens=GEN, temperature=0.0,
        top_p=1.0, repeat_penalty=1.1, prime_tokens=list(prime),
        priority="batch" if rid % 2 else "standard", idempotency_key=key,
        replayed_tokens=list(replayed), out_tokens=list(out),
        done=threading.Event())


def _script(mod, path, fsync="batch"):
    """The same operations on a journal of package `mod`."""
    j = mod.RequestJournal(path, fsync=fsync, compact_bytes=10**9)
    a, b = _req(1, P1, key="k1"), _req(2, P2 + [8, 8], replayed=[8, 8],
                                       prime=[8, 8])
    c = _req(3, [4, 4, 4])
    j.note_admit(a)
    j.note_admit(b, 3)
    for i, t in enumerate([7, 1, 7]):
        j.note_emit(1, t, i + 1)
        j.note_emit(2, 9, 3 + i)
    j.flush()
    j.note_admit(c)
    j.note_emit(3, 6, 1)
    j.note_retire(3, "error", error="boom")
    j.note_emit(1, 2, 4)
    j.note_retire(1, "retired")
    j.flush()
    # the size-triggered compaction: the live request b, with its
    # generated tokens
    b.out_tokens = [9, 9, 9]
    eng = types.SimpleNamespace(_requests={2: b}, config_epoch=0)
    j.compact_bytes = 1
    j.maybe_compact(eng)
    j.note_emit(2, 5, 6)
    j.flush()
    j.close()
    with open(path) as f:
        compacted = [json.loads(x) for x in f if x.strip()]
    j = mod.RequestJournal(path, fsync=fsync)
    j.truncate("checkpoint")
    j.note_admit(_req(4, [1, 2]))
    j.close()
    with open(path) as f:
        after = [json.loads(x) for x in f if x.strip()]
    return compacted, after, j.state()


def _strip(recs):
    return [{k: v for k, v in r.items() if k not in ("t", "fp")}
            for r in recs]


def test_port_writes_jax_records(tmp_path):
    from cake_tpu.serve import journal as jjournal
    want = _script(jjournal, str(tmp_path / "j.jsonl"))
    got = _script(tjournal, str(tmp_path / "t.jsonl"))
    assert _strip(got[0]) == _strip(want[0])
    assert _strip(got[1]) == _strip(want[1])
    assert [r["rec"] for r in got[0]] == ["start", "admit", "emit", "emit"]
    # no owner attached: neither header carries a fingerprint
    assert got[0][0]["fp"] is None and want[0][0]["fp"] is None
    # (bytes_written follows the clocks' digits)
    for k in ("fsync", "appends", "compactions", "failed"):
        assert got[2][k] == want[2][k], k


def test_header_fingerprint_is_the_ports(tmp_path):
    """With an owner engine the header carries the port's fingerprint:
    JAX's keys plus the framework mark."""
    from cake_tpu_torch.serve import checkpoint
    eng = _engine(max_slots=1)
    j = tjournal.RequestJournal(str(tmp_path / "t.jsonl"))
    j.owner = eng
    j.note_admit(_req(1, P1))
    j.close()
    head = tjournal.read_records(j.path)[0][0]
    assert head["rec"] == "start" and head["v"] == 1
    assert head["fp"] == checkpoint._fingerprint(eng)
    assert head["fp"]["framework"] == "torch"
    assert set(head["fp"]) == {"framework", "config", "max_seq_len",
                               "repeat_last_n", "params"}


def _journal_text(mod, path):
    """A journal with every record kind and a replayed request, written
    by package `mod`; returns its records."""
    j = mod.RequestJournal(path)
    j.note_admit(_req(1, P1, key="k1"))
    j.note_admit(_req(2, P2 + [8, 8], replayed=[8, 8], prime=[8, 8]))
    j.note_admit(_req(3, [4, 4, 4], key="k3"))
    for i in range(5):
        j.note_emit(1, 10 + i, i + 1)
        j.note_emit(2, 20 + i, 3 + i)
        if i < 2:
            j.note_emit(3, 30 + i, i + 1)
        j.flush()
    j.note_retire(3, "retired")
    j.note_retire(2, "cancelled")
    j.close()
    return mod.read_records(path)[0]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_replays_the_others_journal(tmp_path, writer):
    from cake_tpu.serve import journal as jjournal
    mod = jjournal if writer == "jax" else tjournal
    recs = _journal_text(mod, str(tmp_path / "w.jsonl"))
    base = [{"rid": 9, "prompt_ids": [1], "out_tokens": [2, 3],
             "penalty_context": [2, 3], "remaining": 4,
             "priority": "standard", "temperature": 0.0, "top_p": 1.0,
             "repeat_penalty": 1.0, "finished": False, "error": None,
             "idempotency_key": None, "replayed": []}]
    for b in (None, base):
        want = jjournal.replay_state(recs, base=b)
        got = tjournal.replay_state(recs, base=b)
        assert got[0] == want[0] and got[1] == want[1]
        assert (got[2] or {}).get("v") == (want[2] or {}).get("v") == 1
    states = {r["rid"]: r for r in got[0]}
    assert states[1]["out_tokens"] == [10, 11, 12, 13, 14]
    assert states[2]["replayed"] == [] and states[2]["status"] == "cancelled"


def test_read_records_torn_tail_and_corruption(tmp_path):
    from cake_tpu.serve import journal as jjournal
    cases = {
        "torn": '{"rec": "start", "v": 1}\n{"rec": "admit", "rid": 1}\n'
                '{"rec": "emit", "ri',
        "mid": '{"rec": "start"}\nnot json\n{"rec": "retire", "rid": 1}\n',
        "blank": '{"rec": "start"}\n{bad\n\n{"rec": "emit", "rid": 2}\n',
        "list": '[1, 2]\n{"rec": "start"}\n',
        "empty": "",
    }
    for name, text in cases.items():
        p = tmp_path / f"{name}.jsonl"
        p.write_text(text)
        got = tjournal.read_records(str(p))
        assert got == jjournal.read_records(str(p)), name
    assert tjournal.read_records(str(tmp_path / "torn.jsonl"))[1:] == (0, True)
    assert tjournal.read_records(str(tmp_path / "mid.jsonl"))[1:] == (1, False)
    assert tjournal.read_records(str(tmp_path / "missing")) == ([], 0, False)


@pytest.mark.parametrize("mode", ["never", "batch", "always"])
def test_fsync_modes_match_jax(tmp_path, monkeypatch, mode):
    from cake_tpu.serve import journal as jjournal
    counts = []
    real = os.fsync
    for mod, tag in ((jjournal, "j"), (tjournal, "t")):
        n = [0]

        def counted(fd):
            n[0] += 1
            return real(fd)

        monkeypatch.setattr(os, "fsync", counted)
        _script(mod, str(tmp_path / f"{tag}.jsonl"), fsync=mode)
        monkeypatch.setattr(os, "fsync", real)
        counts.append(n[0])
    assert counts[1] == counts[0]
    assert counts[1] > 0
    with pytest.raises(ValueError, match="journal-fsync"):
        tjournal.RequestJournal(str(tmp_path / "x"), fsync="sometimes")


def test_journal_fault_sites_fire_like_jax(tmp_path):
    from cake_tpu import faults as jfaults
    from cake_tpu.serve import journal as jjournal
    from cake_tpu_torch import faults as tfaults
    plan = ("seed=2;journal.append:nth=3:transient;"
            "journal.fsync:nth=2:oom;journal.replay:nth=1:transient")
    outs = []
    for mod, fmod, tag in ((jjournal, jfaults, "j"), (tjournal, tfaults,
                                                      "t")):
        j = mod.RequestJournal(str(tmp_path / f"{tag}.jsonl"),
                               fsync="always")
        j.faults = fmod.build_injector(plan)
        fired = []
        for i in range(6):
            try:
                j.note_admit(_req(i + 1, [1, 2, 3]))
            except fmod.InjectedFault as e:
                fired.append((i, type(e).__name__))
        eng = types.SimpleNamespace(_journal=j)
        with pytest.raises(fmod.InjectedTransient, match="journal.replay"):
            mod.recover(eng)
        j.close()
        outs.append((fired, j.faults.describe()["injections_by_site"]))
    assert outs[1] == outs[0]
    assert len(outs[1][0]) == 2


# -- the engine -----------------------------------------------------------------


def _engine(**kw):
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    kw.setdefault("max_slots", 2)
    return InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), device="cpu",
        max_seq_len=64, kv_pages=8, kv_page_size=16,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, recovery=True, **kw)


@pytest.fixture(scope="module")
def clean():
    eng = _engine()
    with eng:
        hs = [eng.submit(list(p), max_new_tokens=GEN) for p in (P1, P2)]
        assert all(h.wait(timeout=300) for h in hs)
    return [list(h._req.out_tokens) for h in hs]


def _abandon(engine):
    """A hard death, in process: the loop stops with no retire or
    teardown path running, and the journal keeps what it flushed (the
    state a kill -9 leaves, less the current iteration's batch)."""
    engine._stop.set()
    engine._wake.set()
    if engine._thread is not None:
        engine._thread.join(10)
    engine._journal.close()


def _wait_tokens(handles, n):
    t0 = time.perf_counter()
    while (min(len(h._req.out_tokens) for h in handles) < n
           and time.perf_counter() - t0 < 120):
        time.sleep(0.002)


def test_recover_resubmits_and_streams_match(tmp_path, clean):
    jpath = str(tmp_path / "engine.journal")
    a = _engine(journal=jpath)
    a.start()
    hs = [a.submit(list(P1), max_new_tokens=GEN, idempotency_key="key-1"),
          a.submit(list(P2), max_new_tokens=GEN)]
    _wait_tokens(hs, 4)
    _abandon(a)
    assert os.path.getsize(jpath) > 0

    b = _engine(journal=jpath)
    with b:
        handles, finished = tjournal.recover(b)
        assert len(handles) == 2 and not finished
        assert all(h.wait(timeout=300) for h in handles)
        full = [list(h._req.replayed_tokens) + list(h._req.out_tokens)
                for h in handles]
        assert full == clean
        assert all(h._req.replayed_tokens for h in handles)
        # the key survived the restart: a retry attaches to the finished
        # stream, no third admission
        before = b.stats.requests_completed
        h2 = b.submit([1, 2, 3], max_new_tokens=4, idempotency_key="key-1")
        assert h2.attached and h2._req is handles[0]._req
        assert b.stats.requests_completed == before
        st = b._journal.state()
        assert st["last_replay"]["replayed"] == 2
        assert st["last_replay"]["dropped"] == 0
    assert not os.path.exists(jpath + ".replaying")


def test_idempotent_submit_attaches_instead_of_admitting(tmp_path):
    eng = _engine(journal=str(tmp_path / "idem.journal"))
    found = []

    class Registry(dict):
        """At the moment a finished keyed request leaves the registry,
        a retry with its key must still attach (the done ring has it)."""

        def pop(self, rid, *default):
            req = super().pop(rid, *default)
            if (req is not None and req.idempotency_key
                    and len(req.out_tokens) == req.max_new_tokens):
                found.append(eng._attach_idempotent(req.idempotency_key)
                             is not None)
            return req

    eng._requests = Registry()
    with eng:
        h1 = eng.submit(list(P1), max_new_tokens=GEN, idempotency_key="k")
        h2 = eng.submit([9, 9], max_new_tokens=2, idempotency_key="k")
        assert not h1.attached and h2.attached and h2._req is h1._req
        assert h1.wait(timeout=300)
        h3 = eng.submit([9, 9], max_new_tokens=2, idempotency_key="k")
        assert h3.attached and h3._req is h1._req
        other = eng.submit([9, 9], max_new_tokens=2, idempotency_key="k2")
        assert other.wait(timeout=300) and not other.attached
    assert found == [True, True]
    recs = tjournal.read_records(eng._journal.path)[0]
    admits = [r for r in recs if r["rec"] == "admit"]
    assert [r["key"] for r in admits] == ["k", "k2"]
    # a cancelled keyed request frees its key
    eng2 = _engine()
    h = eng2.submit(list(P1), max_new_tokens=GEN, idempotency_key="c")
    eng2.cancel(h)
    with eng2:
        assert h.wait(timeout=60)
        h4 = eng2.submit(list(P2), max_new_tokens=2, idempotency_key="c")
        assert not h4.attached and h4.wait(timeout=120)


def _sse(url, headers, body):
    req = urllib.request.Request(
        url + "/api/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **headers})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read().decode()


def test_last_event_id_gets_exactly_the_suffix(tmp_path, clean):
    """A client that saw N tokens of a keyed stream before the process
    died reconnects to the restarted server (same key, Last-Event-ID: N)
    and gets exactly the missing suffix, then [DONE]; a plain retry with
    the key attaches to the finished transcript."""
    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.llama.generator import ByteTokenizer

    jpath = str(tmp_path / "sse.journal")
    seen = []

    def client(delta, final, n_done=0):
        seen.append(n_done)

    client.wants_count = True
    a = _engine(journal=jpath)
    a.start()
    a.submit(list(P1), max_new_tokens=GEN, stream=client,
             idempotency_key="sse-key")
    t0 = time.perf_counter()
    while len(seen) < 4 and time.perf_counter() - t0 < 120:
        time.sleep(0.002)
    _abandon(a)
    last_seen = max(seen)
    assert 0 < last_seen < GEN

    b = _engine(journal=jpath)
    master = Master(Args(sample_len=GEN), text_generator=None)
    httpd = start(master, "127.0.0.1:0", block=False, engine=b)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        assert b._journal.state()["last_replay"]["replayed"] == 1
        # the reconnect after the replayed request finished (a
        # mid-stream one: test_reconnect_mid_stream_gets_exactly_the_rest)
        t0 = time.perf_counter()
        while (b.stats.requests_completed < 1
               and time.perf_counter() - t0 < 60):
            time.sleep(0.002)
        body = _sse(url, {"x-cake-idempotency-key": "sse-key",
                          "Last-Event-ID": str(last_seen)},
                    {"messages": [{"role": "user", "content": "x"}],
                     "stream": True})
        events, cur = [], None
        for line in body.splitlines():
            if line.startswith("id: "):
                cur = int(line[4:])
            elif line.startswith("data: ") and line != "data: [DONE]":
                events.append((cur, json.loads(line[6:])))
                cur = None
        assert "data: [DONE]" in body
        texts = [(i, e["choices"][0]["delta"].get("content"))
                 for i, e in events if "choices" in e]
        tok = ByteTokenizer(256)
        eos = LlamaConfig.tiny().eos_token_ids
        want = tok.decode([t for t in clean[0][last_seen:]
                           if t not in eos])
        got = "".join(t or "" for _, t in texts)
        assert got == want
        assert all(i is None or i > last_seen for i, _ in texts)
        assert texts[-1][0] == len(clean[0])
        before = b.stats.requests_completed
        assert before == 1
        out = json.loads(_post_plain(url, "sse-key"))
        assert out["choices"][0]["message"]["content"] == tok.decode(
            [t for t in clean[0] if t not in eos])
        assert b.stats.requests_completed == before
        # health carries the journal block
        with urllib.request.urlopen(url + "/api/v1/health") as r:
            health = json.loads(r.read())
        assert health["journal"]["last_replay"]["replayed"] == 1
        # Last-Event-ID without a key is a 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _sse(url, {"Last-Event-ID": "3"},
                 {"messages": [{"role": "user", "content": "x"}],
                  "stream": True})
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_reconnect_mid_stream_gets_exactly_the_rest(monkeypatch):
    """A keyed request with no client attached (as a journal replay
    resubmits one) keeps decoding; a client reconnects with
    Last-Event-ID while it still runs and receives the text of exactly
    the tokens after that position, then [DONE]: the server decodes an
    attached stream from the token positions, not from the engine's
    deltas (which a request without a client never advanced)."""
    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.llama.generator import incremental_decode
    from cake_tpu_torch.serve.engine import InferenceEngine

    eng = _engine(max_slots=1)
    real_emit = InferenceEngine._emit

    def slow_emit(self, *a, **kw):      # keeps the stream mid-flight
        time.sleep(0.02)
        return real_emit(self, *a, **kw)

    monkeypatch.setattr(InferenceEngine, "_emit", slow_emit)
    httpd = start(Master(Args(sample_len=GEN), text_generator=None),
                  "127.0.0.1:0", block=False, engine=eng)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        h = eng.submit(list(P1), max_new_tokens=48, idempotency_key="mid")
        _wait_tokens([h], 5)
        last = 5
        body = _sse(url, {"x-cake-idempotency-key": "mid",
                          "Last-Event-ID": str(last)},
                    {"messages": [{"role": "user", "content": "x"}],
                     "stream": True})
        assert h.wait(timeout=120) and h._req.error is None
        ids, texts = [], []
        for line in body.splitlines():
            if line.startswith("id: "):
                ids.append(int(line[4:]))
            elif line.startswith("data: {"):
                ev = json.loads(line[6:])
                texts.append(ev["choices"][0]["delta"].get("content") or "")
        assert "data: [DONE]" in body and ids[-1] == 48
        assert all(i > last for i in ids)
        assert ids[0] < 48           # the reconnect came mid-stream
        eos = LlamaConfig.tiny().eos_token_ids
        rest = [t for t in h._req.out_tokens[last:] if t not in eos]
        assert "".join(texts) == incremental_decode(
            eng.tokenizer, rest, "", final=True)[0]
    finally:
        httpd.shutdown()
        httpd.server_close()


def _post_plain(url, key):
    req = urllib.request.Request(
        url + "/api/v1/chat/completions",
        data=json.dumps({"messages": [{"role": "user",
                                       "content": "x"}]}).encode(),
        headers={"Content-Type": "application/json",
                 "x-cake-idempotency-key": key})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read()
