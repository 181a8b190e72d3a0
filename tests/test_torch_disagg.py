"""Disaggregated prefill/decode in the port (`cake_tpu_torch/kv/
transfer.py` and the engine's seams) against the JAX package.

Two engines over loopback: the decode engine is the front door, the
prefill peer runs the prompt and ships its pool pages and the first
token. The contract is TOKEN identity at f32 (tiny config, greedy):

  * the port pair, the port colocated engine and the JAX colocated
    engine give the same streams, over f32, int8 and int4 pages and with
    a prefix registered on the front door; both allocators conserve
    their pages after retirement;
  * the pages cross packages: a JAX prefill engine ships to a port
    decode engine and a port prefill engine to a JAX decode engine, with
    the same streams (each package reads the other's frames);
  * failure is first-class and never wedges a stream: a `kv.ship` fault
    on the prefill engine, a `kv.adopt` fault on the decode engine and a
    peer that is down each degrade to whole-prompt local prefill with
    the same streams; a reconfigure of the decode engine while the
    shipments fly refuses them with outcome "epoch";
  * the adoption store is cleared on cancel, reset, reconfigure and
    fail-all;
  * on the card (`cuda`): the card pair against the CPU pair, and a wave
    whose `_capture_shipment` and `_adopt_install` run under
    `torch.cuda.set_sync_debug_mode("error")`.

Waits poll a condition under a deadline; nothing sleeps a fixed time.
The JAX package is imported inside the cases that use it, so on the card
(which has no jax) the file collects and its `cuda` cases run:

    python -m pytest --noconftest -m cuda tests/test_torch_disagg.py
"""

import contextlib
import gc
import socket
import time
import weakref

import numpy as np
import pytest

import torch

from cake_tpu_torch.models.llama.config import LlamaConfig

T = 64
PAGE = 16
GEN = 10
TOK = "test-disagg-token"

P1 = [5] * 9
P2 = [2, 9, 4, 7, 3]
P3 = list(range(1, 40))        # three pages
PROMPTS = (P1, P2, P3)


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params as j_init
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jc = JConfig.tiny(num_hidden_layers=2)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, LlamaConfig.tiny(num_hidden_layers=2), tp


def _kv(kv_dtype):
    return kv_dtype or "f32"


def _port(models, kv_dtype=None, device="cpu", params=None, **kw):
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    tc, tp = models[2], models[3]
    kw.setdefault("max_slots", 2)
    kw.setdefault("kv_pages", 16)
    return InferenceEngine(
        tc, params if params is not None else tp,
        ByteTokenizer(tc.vocab_size), device=device, max_seq_len=T,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        cache_dtype=torch.float32, kv_page_size=PAGE,
        kv_dtype=_kv(kv_dtype), **kw)


def _jax(models, kv_dtype=None, **kw):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.serve.engine import InferenceEngine as JEngine

    jc, jp = models[0], models[1]
    kw.setdefault("max_slots", 2)
    kw.setdefault("kv_pages", 16)
    return JEngine(jc, jp, JTok(jc.vocab_size), max_seq_len=T,
                   sampling=JSampling(temperature=0.0, repeat_penalty=1.0),
                   cache_dtype=jnp.float32, kv_page_size=PAGE,
                   paged_attn="fold", kv_dtype=_kv(kv_dtype), **kw)


MAKERS = {"port": _port, "jax": _jax}


@contextlib.contextmanager
def _pair(models, kv_dtype=None, pre="port", dec="port", pre_kw=None,
          dec_kw=None):
    """A started prefill + decode pair wired over loopback (the prefill
    listener binds port 0), the decode plane connected."""
    p = MAKERS[pre](models, kv_dtype, disagg="prefill",
                    disagg_peer="127.0.0.1:0", disagg_token=TOK,
                    **(pre_kw or {}))
    p.start()
    try:
        d = MAKERS[dec](models, kv_dtype, disagg="decode",
                        disagg_peer=f"127.0.0.1:{p._disagg.port}",
                        disagg_token=TOK, disagg_timeout_s=300.0,
                        **(dec_kw or {}))
        d.start()
        try:
            # request_prefill declines until the channel is up: without
            # this wait every request would quietly prefill locally
            assert d._disagg._connected.wait(30), \
                "transfer channel never connected"
            yield p, d
        finally:
            d.stop()
    finally:
        p.stop()


def _submit(eng, prompts=PROMPTS, gen=GEN):
    return [eng.submit(list(x), max_new_tokens=gen, temperature=0.0,
                       repeat_penalty=1.0) for x in prompts]


def _finish(hs):
    assert all(h.wait(timeout=300) for h in hs), "wave timed out"
    assert [h._req.error for h in hs] == [None] * len(hs)
    return [list(h._req.out_tokens) for h in hs]


def _wave(eng, prompts=PROMPTS, gen=GEN):
    return _finish(_submit(eng, prompts, gen))


def _until(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return cond()


def _conserved(eng, floor=0):
    """The refcounted pool drains back to fully free (less `floor`
    pages a registered prefix pins)."""
    return _until(lambda: eng._pager.free_pages == eng._pager.n_pages
                  - floor, timeout=10.0)


_COLOCATED = {}


def _colocated(models, kind, kv_dtype=None, prefix=None):
    """The colocated engine's streams (cached per case)."""
    key = (kind, kv_dtype, prefix is not None)
    if key not in _COLOCATED:
        eng = MAKERS[kind](models, kv_dtype)
        with eng:
            if prefix is not None:
                eng.register_prefix(prefix)
            _COLOCATED[key] = _wave(eng, _prompts(prefix))
            assert _conserved(eng, floor=1 if prefix else 0)
    return _COLOCATED[key]


def _prompts(prefix):
    return PROMPTS if prefix is None else (prefix + [3, 1, 4], P1, P3)


PREFIX = [7] * PAGE


# -- the handoff contract ------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
def test_port_pair_matches_colocated_and_jax(models, kv_dtype):
    """Every request rides the wire (prefilled remotely, shipped, adopted
    at the shipped frontier, no degradation), and the streams equal the
    port's and the JAX package's colocated engines'."""
    want = _colocated(models, "port", kv_dtype)
    assert want == _colocated(models, "jax", kv_dtype)
    with _pair(models, kv_dtype) as (pre, dec):
        assert _wave(dec) == want
        n = len(PROMPTS)
        assert pre._disagg.stats["shipments"] == n == pre.stats.kv_ships
        assert dec.stats.kv_adopts == n
        assert dec._disagg.stats["degraded"] == 0
        assert dec._disagg.stats["bytes"] == pre._disagg.stats["bytes"] > 0
        # ceil(n/16) pages a prompt: 1 + 1 + 3
        assert pre._disagg.stats["pages"] == 5
        assert _conserved(pre) and _conserved(dec)


def test_shared_prefix_pair(models):
    """The front door holds a registered prefix; an adopted shipment
    covers the WHOLE prompt, so adoption bypasses the prefix hit, and
    the streams equal the colocated engines' with the prefix."""
    want = _colocated(models, "port", prefix=PREFIX)
    assert want == _colocated(models, "jax", prefix=PREFIX)
    with _pair(models) as (pre, dec):
        dec.register_prefix(PREFIX)
        assert _wave(dec, _prompts(PREFIX)) == want
        assert dec.stats.kv_adopts == 3
        assert dec._disagg.stats["degraded"] == 0
        assert _conserved(pre) and _conserved(dec, floor=1)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int4"])
@pytest.mark.parametrize("pre,dec", [("jax", "port"), ("port", "jax")])
def test_cross_package_pairs(models, pre, dec, kv_dtype):
    """A JAX prefill engine ships to a port decode engine and a port
    prefill engine to a JAX decode engine: each package adopts the
    other's frames, with the colocated streams."""
    want = _colocated(models, "port", kv_dtype)
    with _pair(models, kv_dtype, pre=pre, dec=dec) as (p, d):
        assert _wave(d) == want
        assert d.stats.kv_adopts == len(PROMPTS)
        assert p._disagg.stats["shipments"] == len(PROMPTS)
        assert d._disagg.stats["degraded"] == 0
        assert _conserved(p) and _conserved(d)


# -- failure is first-class ----------------------------------------------------


def _peer_down(models):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return _port(models, disagg="decode", disagg_peer=f"127.0.0.1:{port}",
                 disagg_token=TOK)


@pytest.mark.parametrize("case", ["ship_fault", "adopt_fault", "peer_down"])
def test_degradations_keep_the_streams(models, case):
    """A kv.ship fault drops the first shipment (ship_fail: that request
    prefills on the decode engine); a kv.adopt fault refuses the first
    installed one (its row prefills locally, no recovery); a peer that is
    down serves every request locally. Streams and pools as colocated."""
    from cake_tpu_torch.obs import metrics as m

    want = _colocated(models, "port")
    if case == "peer_down":
        dec = _peer_down(models)
        with dec:
            assert _wave(dec) == want
            assert dec.stats.kv_adopts == 0
            assert _conserved(dec)
        return
    plan = "seed=5;%s:nth=1:transient" % ("kv.ship" if case == "ship_fault"
                                          else "kv.adopt")
    kw = {"pre_kw" if case == "ship_fault" else "dec_kw":
          dict(fault_plan=plan)}
    fam = m.counter("cake_kv_adopt_total", "", labelnames=("outcome",))
    before = {o: fam.labels(outcome=o).value
              for o in ("degraded", "fault", "adopted")}
    with _pair(models, **kw) as (pre, dec):
        assert _wave(dec) == want
        faulted = pre if case == "ship_fault" else dec
        assert faulted._faults.total == 1, "the planned fault never fired"
        assert dec.stats.kv_adopts == len(PROMPTS) - 1
        assert dec.stats.recoveries == 0
        if case == "ship_fault":
            assert pre._disagg.stats["failures"] == 1
            assert dec._disagg.stats["degraded"] == 1
            outcome = "degraded"
        else:
            assert pre._disagg.stats["shipments"] == len(PROMPTS)
            outcome = "fault"
        assert fam.labels(outcome=outcome).value == before[outcome] + 1
        assert fam.labels(outcome="adopted").value == \
            before["adopted"] + len(PROMPTS) - 1
        assert _conserved(pre) and _conserved(dec)


def test_reconfigure_in_flight_is_refused_by_epoch(models):
    """The decode engine switches config while its shipments are held on
    the prefill side: each one then carries the old epoch, is refused
    with outcome "epoch", and the row prefills locally, with the
    colocated streams."""
    from cake_tpu_torch.obs import metrics as m

    want = _colocated(models, "port")
    fam = m.counter("cake_kv_adopt_total", "", labelnames=("outcome",))
    before = fam.labels(outcome="epoch").value
    with _pair(models) as (pre, dec):
        # the prefill engine's writer holds its first send until the
        # decode engine has switched: every shipment is captured and
        # queued, none has left (a writer that saw retired requests
        # without their shipments would send ship_fail instead)
        import threading
        plane = pre._disagg
        gate, real = threading.Event(), plane._send_item

        def held_send(stream, item):
            gate.wait(60)
            real(stream, item)
        plane._send_item = held_send
        hs = _submit(dec)
        assert _until(lambda: pre.stats.kv_ships == len(PROMPTS))
        cur = dec.current_config().to_dict()
        assert dec.reconfigure(dict(cur, decode_scan=2)) is True
        assert dec.config_epoch == 1
        plane._send_item = real
        gate.set()
        assert _finish(hs) == want
        assert dec.stats.kv_adopts == 0
        assert fam.labels(outcome="epoch").value == before + len(PROMPTS)
        assert _conserved(pre) and _conserved(dec)


@pytest.mark.parametrize("how", ["cancel", "reset", "reconfigure",
                                 "fail_all"])
def test_the_adoption_store_is_cleared(models, how):
    """A staged shipment does not outlive its admission: a cancel drops
    its entry, a reset, a reconfigure and a fail-all drop every entry
    (the engine not started: its queue only)."""
    eng = _port(models)
    hs = _submit(eng, (P1, P2), 2)
    for h in hs:
        eng._adopt_store[h._req.rid] = object()
    if how == "cancel":
        eng.cancel(hs[0])
        eng._drain_cancellations()
        assert list(eng._adopt_store) == [hs[1]._req.rid]
        return
    if how == "reset":
        eng._reset_after_error()
    elif how == "reconfigure":
        cur = eng.current_config().to_dict()
        assert eng.reconfigure(dict(cur, decode_scan=2)) is True
    else:
        eng._fail_all(RuntimeError("boom"))
        assert all(h._req.error is not None for h in hs)
    assert eng._adopt_store == {}


def test_constructor_refusals_match_jax(models, monkeypatch):
    """--disagg without a peer or a token, or with an unknown role,
    raises JAX's messages."""
    monkeypatch.delenv("CAKE_DISAGG_TOKEN", raising=False)
    cases = [dict(disagg="decode"),
             dict(disagg="decode", disagg_peer="127.0.0.1:1",
                  disagg_token=""),
             dict(disagg="middle", disagg_peer="127.0.0.1:1",
                  disagg_token=TOK),
             dict(disagg="decode", disagg_peer="nohost", disagg_token=TOK)]
    for kw in cases:
        with pytest.raises(ValueError) as ours:
            _port(models, **kw)
        with pytest.raises(ValueError) as theirs:
            _jax(models, **kw)
        assert str(ours.value) == str(theirs.value)


# -- on the card -----------------------------------------------------------------


def _card_models():
    from cake_tpu_torch.models.llama.params import init_params
    cfg = LlamaConfig.tiny(num_hidden_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    return (None, None, cfg, params)


def _on(params, device):
    return {k: ({n: t.to(device) for n, t in v.items()}
                if isinstance(v, dict) else v.to(device))
            for k, v in params.items()}


@contextlib.contextmanager
def _card_pair(models, device, kv_dtype=None):
    params = _on(models[3], device)
    p = _port(models, kv_dtype, device=device, params=params,
              disagg="prefill", disagg_peer="127.0.0.1:0",
              disagg_token=TOK)
    p.start()
    try:
        d = _port(models, kv_dtype, device=device, params=params,
                  disagg="decode",
                  disagg_peer=f"127.0.0.1:{p._disagg.port}",
                  disagg_token=TOK, disagg_timeout_s=300.0)
        d.start()
        try:
            assert d._disagg._connected.wait(30)
            yield p, d
        finally:
            d.stop()
    finally:
        p.stop()


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("paired", [False, True],
                         ids=["colocated", "pair"])
def test_a_stopped_engine_is_freed_by_its_refcount(device, paired):
    """A stopped engine is in no reference cycle: its disagg plane and
    its runners' capture hooks hold it weakly, so the last reference
    going frees it (its pool and, on the card, its graphs) with the
    cyclic collector off."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    models = _card_models()
    gc.collect()
    gc.disable()
    try:
        if paired:
            with _card_pair(models, device) as (pre, dec):
                _wave(dec)
                assert dec.stats.kv_adopts == len(PROMPTS)
            refs = [weakref.ref(pre), weakref.ref(dec)]
            del pre, dec
        else:
            eng = _port(models, device=device,
                        params=_on(models[3], device))
            with eng:
                _wave(eng)
            refs = [weakref.ref(eng)]
            del eng
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cuda_pair_matches_the_cpu_pair(kv_dtype):
    """The card pair (the kernels, the captured steps, pinned shipments)
    gives the CPU pair's streams; every request adopted, pools
    conserved."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    models = _card_models()
    streams = {}
    for device in ("cpu", "cuda"):
        with _card_pair(models, device, kv_dtype) as (pre, dec):
            streams[device] = _wave(dec)
            assert dec.stats.kv_adopts == len(PROMPTS)
            assert _conserved(pre) and _conserved(dec)
    assert streams["cuda"] == streams["cpu"]


@pytest.mark.cuda
def test_cuda_capture_and_adopt_add_no_sync():
    """A wave whose every `_capture_shipment` (prefill engine) and
    `_adopt_install` (decode engine) runs under
    `torch.cuda.set_sync_debug_mode("error")`: neither waits for the
    stream (the writer thread waits on the shipment's event, the install
    is an asynchronous upload from pinned memory). The debug mode is
    process-wide, so the chats go one at a time: while one engine runs a
    guarded call, the other has nothing to do."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    models = _card_models()
    guarded = []
    with _card_pair(models, "cuda") as (pre, dec):
        _wave(dec, (P2,), 2)     # warm-up: the captures happen here

        def guard(eng, name):
            fn = getattr(eng, name)

            def wrapped(*a):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return fn(*a)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    guarded.append(name)
            setattr(eng, name, wrapped)

        guard(pre, "_capture_shipment")
        guard(dec, "_adopt_install")
        for x in PROMPTS:
            _wave(dec, (x,))
        assert dec.stats.kv_adopts == len(PROMPTS) + 1
        assert dec._disagg.stats["degraded"] == 0
    assert sorted(set(guarded)) == ["_adopt_install", "_capture_shipment"]
    assert len(guarded) == 2 * len(PROMPTS)
