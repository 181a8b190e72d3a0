"""A recovery resets the port engine's device state in place, as the JAX
engine's reset keeps its compiled steps (`cake_tpu/serve/engine.py`
`_reset_after_error`): the pool's leaves (values and int8/int4 scales),
the table, the rings, the seeds and the counters keep their storage,
and the decode, mixed and prefill runners survive, so every captured
graph stays valid and nothing is captured anew.

On the CPU, over f32, int8 and int4 pools at `--mixed-batch` auto and
off: every buffer's `data_ptr` and every runner object is the same
after each reset; right after it the pool is zero, every table row
unmapped, the rings empty, the counters 0 and the seeds the reset
count's; and the streams equal those of the same plan through the
fallback rebuild (at f32, a run's without the plan).

The `cuda` cases: the card engine's resets capture nothing anew, and a
real device fault (a device-side assert inside a step, in a child
process) makes the in-place reset and the fallback rebuild both raise,
so the engine stops with `reset_failed`: health reads `stopped`, every
client gets its error, the snapshot is written without a device read,
and a fresh process resumes from it with exact f32 streams. They skip
without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_inplace_reset.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch

from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.serve.errors import RecoveryConfig

T = 64
PAGE = 16
PROMPTS = ([5] * 9, [2, 9, 4, 7, 3], [7, 7, 1, 2])
GEN = 12
FAST = dict(backoff_base_s=0.0, backoff_cap_s=0.0)
PLAN = ("seed=15;engine.mixed:nth=3:transient;engine.decode:nth=5:oom;"
        "engine.step:step=9:transient")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(device):
    from cake_tpu_torch.models.llama.params import init_params
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    return cfg, {k: ({n: t.to(device) for n, t in v.items()}
                     if isinstance(v, dict) else v.to(device))
                 for k, v in params.items()}


def _engine(device="cpu", kv_dtype="f32", fault_plan=None, **kw):
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    cfg, params = _params(device)
    kw.setdefault("max_slots", 2)
    kw.setdefault("kv_pages", 8)
    return InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), device=device,
        max_seq_len=T, sampling=SamplingConfig(temperature=0.0,
                                               repeat_penalty=1.0),
        cache_dtype=torch.float32, kv_page_size=PAGE, kv_dtype=kv_dtype,
        fault_plan=fault_plan, recovery=True,
        recovery_config=RecoveryConfig(**FAST), **kw)


def _drive(eng):
    hs = [eng.submit(p, max_new_tokens=GEN) for p in PROMPTS]
    with eng:
        assert all(h.wait(timeout=300) for h in hs)
    assert all(h._req.error is None for h in hs)
    return [list(h._req.out_tokens) for h in hs]


def _leaves(cache):
    return [t for st in (cache.k_store, cache.v_store)
            for t in (st if isinstance(st, tuple) else (st,))]


def _state(eng):
    """The storage every graph holds, and the runner objects."""
    ptrs = [t.data_ptr() for t in _leaves(eng.cache)] + [
        t.data_ptr() for t in (eng.cache.table, eng._ring, eng._seeds,
                               eng._counters)]
    return ptrs, (eng.cache, eng._runner, eng._mixed_runner,
                  eng._prefill_runner)


def _watch(eng):
    """Wrap the reset: the state before and after each, and what the
    device state holds right after it."""
    seen = []
    real = eng._reset_after_error

    def reset():
        before = _state(eng)
        real()
        after = _state(eng)
        base = eng._seed * 1_000_003 + eng._reset_count * 65_537
        seen.append(dict(
            before=before, after=after,
            zero=all(not t.view(torch.uint8).any()
                     for t in _leaves(eng.cache)),
            unmapped=bool((eng.cache.table == -1).all()),
            ring=bool((eng._ring == -1).all()),
            counters=bool((eng._counters == 0).all()),
            seeds=eng._seeds.tolist() == [base + b
                                          for b in range(eng.max_slots)]))
    eng._reset_after_error = reset
    return seen


@pytest.mark.parametrize("mixed", ["auto", "off"])
@pytest.mark.parametrize("kv_dtype", ["f32", "int8", "int4"])
def test_recovery_keeps_every_buffer_and_runner(kv_dtype, mixed):
    """The streams equal those of the same plan through the fallback
    rebuild (a quantized pool's recompute fold requantizes, so they may
    leave an unfaulted run's; at f32 they do not)."""
    rebuilt = _engine(kv_dtype=kv_dtype, mixed_batch=mixed,
                      decode_scan_steps=4, fault_plan=PLAN)

    def in_place_fails():
        raise RuntimeError("in-place reset failed (test)")

    rebuilt._reset_in_place = in_place_fails
    want = _drive(rebuilt)
    if kv_dtype == "f32":
        assert want == _drive(_engine(mixed_batch=mixed,
                                      decode_scan_steps=4))
    eng = _engine(kv_dtype=kv_dtype, mixed_batch=mixed, decode_scan_steps=4,
                  fault_plan=PLAN)
    seen = _watch(eng)
    got = _drive(eng)
    assert got == want
    assert eng.stats.recoveries == rebuilt.stats.recoveries
    assert eng.stats.recoveries == len(seen) >= 2
    for s in seen:
        assert s["after"][0] == s["before"][0]
        assert all(a is b for a, b in zip(s["after"][1], s["before"][1]))
        assert s["zero"] and s["unmapped"] and s["ring"]
        assert s["counters"] and s["seeds"]
    # the runners that ran before the first reset still serve after it
    runners = seen[0]["before"][1][1:]
    assert any(r is not None for r in runners)
    assert all(r is None or r is cur for r, cur in zip(
        runners, (eng._runner, eng._mixed_runner, eng._prefill_runner)))


def test_reset_count_folds_into_the_seeds_in_place():
    """Sampled rows never replay consumed draws: each reset writes new
    seeds (the reset count folds in) into the same tensor."""
    eng = _engine(fault_plan="seed=1;engine.step:step=3:transient")
    ptr = eng._seeds.data_ptr()
    first = eng._seeds.tolist()
    _drive(eng)
    assert eng.stats.recoveries == 1 and eng._reset_count == 1
    assert eng._seeds.data_ptr() == ptr
    assert eng._seeds.tolist() != first
    assert len(set(eng._seeds.tolist()) & set(first)) == 0


# -- on the card ------------------------------------------------------------------


def _runners(eng):
    return [r for r in (eng._runner, eng._mixed_runner, eng._prefill_runner)
            if r is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("mixed", ["auto", "off"])
def test_cuda_resets_capture_nothing_anew(mixed):
    """The card engine's resets keep every graph: each variant is
    captured once (`cake_jit_compiles_total` counts no recovery), the
    graph objects are the ones captured before the first reset, and
    the streams are the CPU engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    want = _drive(_engine(mixed_batch=mixed, decode_scan_steps=4,
                          fault_plan=PLAN))
    eng = _engine("cuda", mixed_batch=mixed, decode_scan_steps=4,
                  fault_plan=PLAN)
    graphs = []
    real = eng._reset_after_error

    def reset():
        graphs.append({(id(r), v): g[0] for r in _runners(eng)
                       for v, g in r._graphs.items()})
        real()
    eng._reset_after_error = reset
    assert _drive(eng) == want
    assert eng.stats.recoveries == len(graphs) >= 2
    captures = len(eng.events.dump(type="recompile"))
    assert captures == sum(r.captures for r in _runners(eng))
    now = {(id(r), v): g[0] for r in _runners(eng)
           for v, g in r._graphs.items()}
    for before in graphs:
        assert all(now[k] is g for k, g in before.items())


_FAULT_CHILD = r"""
import json, os, sys, threading, urllib.request
import torch
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tests"]
from test_torch_inplace_reset import _engine, PROMPTS, GEN
from cake_tpu_torch.api.server import start
from cake_tpu_torch.args import Args
from cake_tpu_torch.master import Master
from cake_tpu_torch.serve import checkpoint

path, out = sys.argv[2], sys.argv[3]
eng = _engine("cuda", decode_scan_steps=1)
raised = []
for name in ("_reset_in_place", "_rebuild_after_error"):
    def wrap(fn=getattr(eng, name), name=name):
        def w():
            try:
                return fn()
            except Exception as e:
                raised.append((name, type(e).__name__, str(e)[:200]))
                raise
        return w
    setattr(eng, name, wrap())
calls = []
real = eng._dispatch_scan

def faulting(*a, **kw):
    # the third decode dispatch indexes out of range on the card: a
    # device-side assert, a sticky error of the context
    calls.append(1)
    if len(calls) == 3:
        x = torch.zeros(4, device="cuda")
        x[torch.tensor([1 << 20], device="cuda")] += 1
    return real(*a, **kw)

eng._dispatch_scan = faulting
died = []
threading.excepthook = lambda args: died.append(repr(args.exc_value))
master = Master(Args(sample_len=8, temperature=0.0), text_generator=None)
httpd = start(master, "127.0.0.1:0", block=False, engine=eng,
              checkpoint_path=path)
url = "http://127.0.0.1:%d" % httpd.server_address[1]
hs = [eng.submit(p, max_new_tokens=GEN) for p in PROMPTS]
ok = all(h.wait(timeout=120) for h in hs)
eng._thread.join(timeout=60)
with urllib.request.urlopen(url + "/api/v1/health", timeout=60) as r:
    health = json.loads(r.read())
with open(out, "w") as f:
    json.dump(dict(ok=ok, died=died, raised=raised, stopped=eng.stopped,
                   last_error=eng.stats.last_error, health=health["status"],
                   reason=health.get("reason"),
                   errors=[type(h._req.error).__name__ for h in hs],
                   retryable=[bool(getattr(h._req.error, "retryable", False))
                              for h in hs]), f)
httpd.shutdown()
os._exit(0)          # the context is dead: leave without its teardown
"""

_RESUME_CHILD = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tests"]
from test_torch_inplace_reset import _engine
from cake_tpu_torch.serve import checkpoint

path, out = sys.argv[2], sys.argv[3]
recs = checkpoint.load(path)["requests"]
eng = _engine("cuda", decode_scan_steps=1)
with eng:
    handles, finished = checkpoint.restore(eng, path)
    assert all(h.wait(timeout=300) for h in handles)
json.dump(dict(finished=len(finished),
               joined=[list(r["out_tokens"]) + list(h._req.out_tokens)
                       for r, h in zip(recs, handles)]), open(out, "w"))
"""


def _child(code, *args, timeout=300):
    r = subprocess.run([sys.executable, "-c", code, ROOT, *args], cwd=ROOT,
                       capture_output=True, text=True, timeout=timeout)
    return r


@pytest.mark.cuda
def test_cuda_device_assert_stops_with_reset_failed_and_resumes(tmp_path):
    """A device-side assert inside a step (a child process, whose CUDA
    context it poisons): the in-place reset raises, the fallback rebuild
    raises, the engine stops with reset_failed (no thread dies), health
    reads "stopped", every client gets its retryable error, and the
    snapshot, written without a device read, resumes in a fresh process
    to the streams an uninterrupted run gives, exactly (f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    path, out = str(tmp_path / "ckpt.json"), str(tmp_path / "fault.json")
    r = _child(_FAULT_CHILD, path, out)
    assert os.path.exists(out), r.stderr[-3000:]
    got = json.load(open(out))
    assert got["ok"] and not got["died"]
    assert [n for n, _, _ in got["raised"]] == ["_reset_in_place",
                                                "_rebuild_after_error"]
    assert got["stopped"] and got["last_error"] == "reset failed"
    assert got["health"] == "stopped" and got["reason"] == "reset failed"
    assert got["errors"] == ["EngineResetError"] * len(PROMPTS)
    assert all(got["retryable"])
    from cake_tpu_torch.serve import checkpoint
    recs = checkpoint.load(path)["requests"]
    assert len(recs) == len(PROMPTS)
    assert all(checkpoint.is_resumable(r) for r in recs)
    assert any(r["out_tokens"] for r in recs)    # it failed mid-stream
    out2 = str(tmp_path / "resume.json")
    r2 = _child(_RESUME_CHILD, path, out2)
    assert os.path.exists(out2), r2.stderr[-3000:]
    resumed = json.load(open(out2))
    clean = _drive(_engine("cuda", decode_scan_steps=1))
    assert resumed["finished"] == 0 and resumed["joined"] == clean
    assert np.array_equal(np.array(clean, dtype=object),
                          np.array(_drive(_engine(decode_scan_steps=1)),
                                   dtype=object))
