"""The continuous-batching engine over the port's sp meshes
(cake_tpu_torch/parallel/context_parallel.make_sp_engine_step_fns,
parallel/sp_pipeline.make_sp_stage_engine_step_fns) against the JAX
package's on the CPU: the cases of tests/test_sp_engine.py and the sp
serving cases of tests/test_serving_topology.py.

The load-bearing property is JAX's: a request's greedy stream through
the sp engine (a ring prefill per slot, merged-stats ragged decode over
the sequence shards) is token-identical to the unsharded dense engine's
for any prompt length, since the engine's layout is
position-contiguous. The weights are JAX's random init carried across
(`params_from_numpy`), so the port's sp and sp x tp engines are held to
JAX's sp engines' streams too, at f32; dp x sp and stage x sp(x tp),
their K-step scans and slot reuse to the port's dense engine. Through
Args -> Context -> Master the engine gets JAX's windowed limits, warns
for the flags it ignores, serves the HTTP API, counts its dispatches
in the `cake_sp_*` families, recovers in place, and a checkpoint resume
refuses a transcript past the window and warns of a truncated budget
with JAX's messages. `cuda` cases (skipped without a card) hold the
captured sp steps against their eager calls on a co-located mesh of the
card, run a wave through a recovery that keeps every graph, and hold
the int4 products at the sp x tp shard shapes against their plain
version.
"""

import logging

import numpy as np
import pytest

import torch

from cake_tpu_torch.args import Args
from cake_tpu_torch.context import Context
from cake_tpu_torch.master import Master
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.generator import ByteTokenizer
from cake_tpu_torch.models.llama.params import params_from_numpy
from cake_tpu_torch.ops.sampling import SamplingConfig
from cake_tpu_torch.parallel.context_parallel import (
    create_sp_engine_cache, make_sp_engine_step_fns, place_sp_params,
)
from cake_tpu_torch.parallel.mesh import make_sp_mesh
from cake_tpu_torch.parallel.sp_pipeline import (
    create_sp_stage_engine_cache, make_sp_stage_engine_step_fns,
    place_sp_stage_params,
)
from cake_tpu_torch.serve.engine import InferenceEngine

CTX, TAIL = 64, 32
GREEDY = SamplingConfig(temperature=0.0, repeat_penalty=1.0)
CFG = LlamaConfig.tiny(num_hidden_layers=2)
PROMPTS = [list(range(3, 20)), [7] * 40, list(range(5, 10))]
# the meshes the port's engines run, by name: make_sp_mesh's arguments
MESHES = {
    "sp4": dict(sp=4), "sp2_tp2": dict(sp=2, tp=2),
    "dp2_sp4": dict(sp=4, dp=2), "stage2_sp4": dict(sp=4, stage=2),
    "stage2_sp2_tp2": dict(sp=2, stage=2, tp=2),
}


def _jax_engine(jp, sp, tp=1, slots=3, **kw):
    """JAX's sp engine over its virtual devices (tests/test_sp_engine.py's
    make_sp_engine)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.parallel.context_parallel import (
        create_sp_engine_cache as j_cache,
        make_sp_engine_step_fns as j_fns, place_sp_params as j_place,
    )
    from cake_tpu.serve.engine import InferenceEngine as JEngine

    jc = JConfig.tiny(num_hidden_layers=2)
    devs = np.array(jax.devices()[:sp * tp])
    mesh = (Mesh(devs.reshape(sp, tp), ("sp", "tp")) if tp > 1
            else Mesh(devs, ("sp",)))
    placed = j_place(mesh, jc, jp, tp=tp > 1)
    fns = j_fns(mesh, jc, CTX, TAIL, kv_dtype=jnp.float32, tp=tp > 1,
                params=placed)
    cache = j_cache(mesh, jc, slots, CTX, TAIL, kv_dtype=jnp.float32,
                    tp=tp > 1)
    return JEngine(jc, placed, JTok(jc.vocab_size), max_slots=slots,
                   max_seq_len=CTX + TAIL,
                   sampling=JSampling(temperature=0.0, repeat_penalty=1.0),
                   cache_dtype=jnp.float32, step_fns=fns, cache=cache,
                   prompt_limit=CTX, decode_budget=TAIL, **kw)


@pytest.fixture(scope="module")
def setup():
    """JAX's tiny 2-layer weights (PRNGKey(0)) on both sides, and JAX's
    sp 4 and sp 2 x tp 2 engines' greedy streams of PROMPTS."""
    import jax
    import jax.numpy as jnp

    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params

    jp = init_params(JConfig.tiny(num_hidden_layers=2),
                     jax.random.PRNGKey(0), dtype=jnp.float32)
    streams = {}
    for name, sp, tp in (("sp4", 4, 1), ("sp2_tp2", 2, 2)):
        with _jax_engine(jp, sp, tp) as eng:
            hs = [eng.submit(p, max_new_tokens=10) for p in PROMPTS]
            assert all(h.wait(300) for h in hs)
        streams[name] = [h.token_ids for h in hs]
    return dict(jp=jp, params=params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu"), jax=streams)


def _sp_engine(setup, name, slots=3, **kw):
    """The port's engine over the named CPU mesh."""
    mk = MESHES[name]
    mesh = make_sp_mesh(device_type="cpu", **mk)
    if mk.get("stage", 1) > 1:
        params = place_sp_stage_params(mesh, CFG, setup["params"])
        fns = make_sp_stage_engine_step_fns(mesh, CFG, CTX, TAIL,
                                            kv_dtype=torch.float32)
        cache = create_sp_stage_engine_cache(mesh, CFG, slots, CTX, TAIL,
                                             kv_dtype=torch.float32)
    else:
        params = place_sp_params(mesh, CFG, setup["params"])
        fns = make_sp_engine_step_fns(mesh, CFG, CTX, TAIL,
                                      kv_dtype=torch.float32)
        cache = create_sp_engine_cache(mesh, CFG, slots, CTX, TAIL,
                                       kv_dtype=torch.float32)
    return InferenceEngine(
        CFG, params, ByteTokenizer(CFG.vocab_size), device="cpu",
        max_slots=slots, max_seq_len=CTX + TAIL, sampling=GREEDY,
        cache_dtype=torch.float32, step_fns=fns, cache=cache,
        prompt_limit=CTX, decode_budget=TAIL, **kw)


def _dense_ids(setup, prompt, n):
    with InferenceEngine(CFG, setup["params"], ByteTokenizer(CFG.vocab_size),
                         device="cpu", max_slots=2, max_seq_len=CTX + TAIL,
                         sampling=GREEDY,
                         cache_dtype=torch.float32) as eng:
        h = eng.submit(prompt, max_new_tokens=n)
        assert h.wait(120)
    return h.token_ids


def _serve(eng, prompts, n):
    with eng:
        hs = [eng.submit(p, max_new_tokens=n) for p in prompts]
        assert all(h.wait(120) for h in hs)
    return [h.token_ids for h in hs]


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("name", ["sp4", "sp2_tp2"])
def test_sp_engine_matches_jax_and_dense(setup, name, K):
    """Concurrent requests of different prompt lengths over the sp mesh,
    at --decode-scan 1 and 4: JAX's sp engine's greedy streams, and the
    dense engine's."""
    got = _serve(_sp_engine(setup, name, decode_scan_steps=K), PROMPTS, 10)
    assert got == setup["jax"][name]
    assert got == [_dense_ids(setup, p, 10) for p in PROMPTS]


@pytest.mark.parametrize("name", ["dp2_sp4", "stage2_sp4",
                                  "stage2_sp2_tp2"])
def test_dp_and_stage_sp_engines_match_dense(setup, name):
    """dp x sp (the slots over dp, requests on both groups' slots) and
    stage x sp(x tp): the dense engine's streams."""
    slots = 4 if name.startswith("dp") else 3
    got = _serve(_sp_engine(setup, name, slots=slots), PROMPTS, 10)
    assert got == [_dense_ids(setup, p, 10) for p in PROMPTS]


@pytest.mark.parametrize("name", ["sp4", "dp2_sp4", "stage2_sp4"])
def test_sp_engine_scan_path_matches(setup, name):
    """K = 4 decode bursts (four replays of the ragged step a host round
    trip) equal the single steps."""
    slots = 4 if name.startswith("dp") else 3
    eng = _sp_engine(setup, name, slots=slots, decode_scan_steps=4)
    assert eng._decode_scan == 4
    assert _serve(eng, PROMPTS[:1], 12) == [_dense_ids(setup, PROMPTS[0],
                                                       12)]


def test_sp_engine_slot_reuse(setup):
    """More requests than slots: a retired slot re-prefills cleanly (its
    old context and tail are invisible to the next request)."""
    with _sp_engine(setup, "sp4", slots=2) as eng:
        first = [eng.submit(p, max_new_tokens=8) for p in PROMPTS[:2]]
        assert all(h.wait(120) for h in first)
        h = eng.submit(PROMPTS[2], max_new_tokens=8)
        assert h.wait(120)
    assert h.token_ids == _dense_ids(setup, PROMPTS[2], 8)


def test_sp_engine_limits(setup):
    """The prompt window refuses a longer prompt with JAX's message; the
    budget clamps to the tail."""
    want = _jax_engine(setup["jp"], 4)
    with pytest.raises(ValueError) as j_err:
        want.submit(list(range(3, 3 + CTX + 1)), max_new_tokens=4)
    with _sp_engine(setup, "sp4") as eng:
        with pytest.raises(ValueError) as err:
            eng.submit(list(range(3, 3 + CTX + 1)), max_new_tokens=4)
        assert str(err.value) == str(j_err.value)
        assert "prompt window" in str(err.value)
        h = eng.submit([5] * 8, max_new_tokens=10 * TAIL)
        assert h._req.max_new_tokens == TAIL
        assert h.wait(120)
        assert len(h.token_ids) <= TAIL
    assert not eng._preemption


def test_sp_engine_counts_its_dispatches(setup):
    """cake_sp_dispatch_total counts each prefill and each decode step's
    dispatch under its mode; the window gauges hold ctx_len and
    tail_len."""
    from cake_tpu_torch.obs import metrics as obs_metrics
    fam = obs_metrics.counter("cake_sp_dispatch_total", "",
                              ("op", "mode"))
    before = dict(fam.samples())
    eng = _sp_engine(setup, "sp2_tp2")
    _serve(eng, PROMPTS, 4)
    after = fam.samples()
    grew = {k: after[k] - before.get(k, 0.0) for k in after}
    assert grew[("prefill", "sp_tp")] == len(PROMPTS)
    assert grew[("decode_scan", "sp_tp")] >= 3
    assert "cake_sp_dispatch_seconds_count" in obs_metrics.REGISTRY.render()
    for name, want in (("cake_sp_ctx_window_tokens", CTX),
                       ("cake_sp_tail_window_tokens", TAIL)):
        g = obs_metrics.gauge(name, "", ("mode",))
        assert g.samples()[("sp_tp",)] == want


def _mk_args(**kw):
    base = dict(model="", max_seq_len=96, batch_size=1, sample_len=8,
                temperature=0.0, repeat_penalty=1.0, flash_attention=False,
                cpu=True, dtype="f32")
    base.update(kw)
    return Args(**base).validate()


def _master(args):
    return Master(args, text_generator=Context.from_args(
        args).load_text_model())


@pytest.mark.parametrize("kw", [dict(sp=4, decode_scan=4),
                                dict(sp=2, dp=2, batch_size=2, max_slots=4),
                                dict(sp=2, topology="TOPO")])
def test_sp_engine_via_context_and_master(tmp_path, kw):
    """--sp through Args -> Context -> Master.make_engine builds the sp
    engine (sp, dp x sp, stage x sp) with prompt_limit = ctx_len and
    decode_budget = tail_len, and its streams are the unsharded
    engine's."""
    if kw.get("topology") == "TOPO":
        topo = tmp_path / "topology.yml"
        topo.write_text("a:\n  layers:\n    - model.layers.0-1\n"
                        "b:\n  layers:\n    - model.layers.2-3\n")
        kw = dict(kw, topology=str(topo))
    master = _master(_mk_args(**kw))
    fwd = master.llm._forward_fn
    engine = master.make_engine(max_slots=kw.get("max_slots", 3))
    assert engine._custom_steps and engine.prompt_limit == fwd.ctx_len
    assert engine.decode_budget == fwd.tail_len
    assert engine.max_seq_len == fwd.ctx_len + fwd.tail_len
    prompts = [[7, 11, 13, 17], [5] * 9]
    dense = _master(_mk_args()).make_engine(max_slots=3)
    assert _serve(engine, prompts, 8) == _serve(dense, prompts, 8)


def test_master_warns_for_the_flags_the_sp_engine_ignores(caplog):
    """JAX's warnings: --kv-pages, int8 KV, --auto-prefix, --autotune
    name what they apply to; --prefill-chunk passes through and the
    engine warns it has no sp variant."""
    caplog.set_level(logging.WARNING)
    master = _master(_mk_args(sp=2))
    master.args = _mk_args(sp=2, kv_pages=64, kv_dtype="int8",
                           auto_prefix=True, autotune="manual",
                           prefill_chunk=32)
    engine = master.make_engine(max_slots=2)
    text = caplog.text
    for flag in ("--kv-pages ignored", "--kv-host-pages ignored",
                 "--auto-prefix ignored", "--autotune ignored",
                 "prefill_chunk ignored"):
        assert flag in text, flag
    assert engine.prefill_chunk is None and not engine.paged
    master.args = _mk_args(sp=2, dp=2, batch_size=2)
    master.llm = Context.from_args(master.args).load_text_model()
    with pytest.raises(ValueError, match="--max-slots 3 must be divisible "
                                         "by --dp 2"):
        master.make_engine(max_slots=3)


def test_sp_and_dp_sp_serve_through_the_api():
    """Behind --api every sp composition serves through the batching
    engine: a chat completion over sp and over dp x sp."""
    import json
    import urllib.request

    from cake_tpu_torch.api.server import start

    for kw in (dict(sp=4), dict(sp=2, dp=2, batch_size=2, max_slots=4)):
        master = _master(_mk_args(max_seq_len=256, **kw))
        eng = master.make_engine()
        assert eng.prompt_limit == master.llm._forward_fn.ctx_len
        httpd = start(master, address="127.0.0.1:0", block=False,
                      engine=eng)
        base = "http://%s:%d" % httpd.server_address[:2]
        try:
            req = urllib.request.Request(
                base + "/api/v1/chat/completions",
                data=json.dumps({
                    "messages": [{"role": "user", "content": "hi"}],
                    "max_tokens": 4}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                obj = json.loads(r.read())
            assert obj["choices"][0]["message"]["role"] == "assistant"
        finally:
            httpd.shutdown()
            httpd.server_close()
            eng.stop()


def test_windowed_checkpoint_resume_is_jaxs(setup, caplog):
    """A resumed transcript past the prompt window is refused, and a
    remaining budget past the tail warns that the generation will be
    truncated, with JAX's messages."""
    from cake_tpu.serve import checkpoint as j_ckpt
    from cake_tpu_torch.serve import checkpoint as ckpt

    def records():
        base = dict(temperature=0.0, top_p=1.0, repeat_penalty=1.0,
                    priority="standard", out_tokens=[5, 6])
        return [dict(base, rid=1, prompt_ids=list(range(3, 3 + CTX)),
                     remaining=4),
                dict(base, rid=2, prompt_ids=[7] * 8, remaining=TAIL + 5)]

    caplog.set_level(logging.WARNING)
    got = {}
    for name, mod, eng in (("jax", j_ckpt, _jax_engine(setup["jp"], 4)),
                           ("port", ckpt, _sp_engine(setup, "sp4"))):
        snap = mod.snapshot(eng)
        snap["requests"] = records()
        caplog.clear()
        handles, finished = mod.resume(eng, snap)
        warned = [r.getMessage() for r in caplog.records
                  if "decode budget" in r.getMessage()]
        got[name] = ([f["error"] for f in finished], warned,
                     [h._req.max_new_tokens for h in handles])
        eng.stop()
    assert got["port"] == got["jax"]
    errors, warned, budgets = got["port"]
    assert errors == [f"resume failed: resumed context {CTX + 2} exceeds "
                      f"this serving mode's prompt window {CTX}"]
    assert len(warned) == 1 and budgets == [TAIL]


def test_sp_engine_recovers_in_place(setup):
    """A decode fault mid-wave: the engine resets its SPEngineCache in
    place (the same shard tensors), resubmits through the fold, and the
    streams are the fault-free ones."""
    want = _serve(_sp_engine(setup, "sp4"), PROMPTS, 8)
    eng = _sp_engine(setup, "sp4", fault_plan="seed=1;engine.decode:nth=3:"
                                               "oom", recovery=True)
    before = [id(t) for t in eng.cache.ctx_k.distinct()] + [id(
        eng.cache.plen)]
    assert _serve(eng, PROMPTS, 8) == want
    assert eng.stats.recoveries >= 1
    assert [id(t) for t in eng.cache.ctx_k.distinct()] + [id(
        eng.cache.plen)] == before


def test_sp_engine_cache_rebuild_allocates_its_placement(setup):
    """The rebuild path after a failed in-place reset allocates a zeroed
    cache of the same placement (shapes, dtypes, specs) from the kept
    allocator, which holds no tensor of the old one."""
    eng = _sp_engine(setup, "dp2_sp4", slots=4)
    old = eng.cache
    new = eng._new_dense_cache(CFG)
    for a, b in zip(old[:4], new[:4]):
        assert (a.shape, a.dtype, a.spec) == (b.shape, b.dtype, b.spec)
        assert all(int(t.abs().sum()) == 0 for t in b.distinct())
    assert new.plen.shape == old.plen.shape and new.max_seq_len == CTX + TAIL


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the sp steps replay as CUDA "
                    "graphs there")


@pytest.mark.cuda
def test_cuda_captured_sp_steps_replay_their_eager_calls():
    """The sp engine's slot prefill and ragged decode over sp 2 x tp 2 on
    four positions of the card, as CUDA graphs (DensePrefillRunner, one
    capture for the window; DecodeRunner): every replay equals the same
    step run eagerly from a copy of the cache."""
    _cuda_or_skip()
    from cake_tpu_torch.models.llama.model import RopeTables
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.serve.graphs import DensePrefillRunner
    dev = torch.device("cuda", 0)
    params = init_params(CFG, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.float32)
    mesh = make_sp_mesh(sp=2, tp=2, devices=[dev] * 4)
    placed = place_sp_params(mesh, CFG, params)
    fns = make_sp_engine_step_fns(mesh, CFG, CTX, TAIL,
                                  kv_dtype=torch.float32)
    cache = create_sp_engine_cache(mesh, CFG, 4, CTX, TAIL,
                                   kv_dtype=torch.float32)
    rope = RopeTables.create(CFG, CTX + TAIL, device=dev)
    runner = DensePrefillRunner(placed, cache, rope, CFG,
                                fns={"slot": fns[0]}, device=dev)

    def copy_of(c):
        out = c.fresh()
        for a, b in zip(out[:4], c[:4]):
            for x, y in zip(a.distinct(), b.distinct()):
                x.copy_(y)
        out.plen.copy_(c.plen)
        return out

    for slot, n in ((0, 20), (2, 9), (3, 64)):
        ids = [(7 * slot + j) % 100 + 3 for j in range(n)]
        eager = copy_of(cache)
        want, _ = fns[0](placed, torch.tensor([ids + [0] * (CTX - n)],
                                              dtype=torch.int32, device=dev),
                         torch.tensor([n], dtype=torch.int32, device=dev),
                         slot, eager, rope, CFG)
        got = runner.run(("slot", CTX), ids + [0] * (CTX - n), n, slot)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        torch.testing.assert_close(cache.ctx_k.gather(), eager.ctx_k.gather(),
                                   rtol=0, atol=1e-5)
        assert torch.equal(cache.plen, eager.plen)
    assert runner.captures == 1
    tok = torch.tensor([[5], [6], [7], [8]], device=dev)
    pos = cache.plen.clone() + torch.tensor([0, 0, 0, 0], device=dev,
                                             dtype=torch.int32)
    active = torch.tensor([True, False, True, True], device=dev)
    from cake_tpu_torch.serve.graphs import _Graphs

    class Step(_Graphs):
        def step(self, _v):
            self.out, _ = fns[2](placed, tok, cache, pos, active, rope, CFG)

        def _idle(self, _v):
            return None
    eager = copy_of(cache)
    want, _ = fns[2](placed, tok, eager, pos, active, rope, CFG)
    step = Step(dev)
    step.replay(0)           # the capture's warm-up writes the same tail
    torch.testing.assert_close(step.out, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(cache.tail_k.gather(), eager.tail_k.gather(),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_sp_engine_recovers_keeping_its_graphs():
    """The sp engine on a co-located mesh of the card (sp 2 x tp 2)
    through Master: three waves give the unsharded engine's f32
    streams, no wave after the first capturing anything, one of them
    through a decode fault recovered in place."""
    _cuda_or_skip()
    dev = torch.device("cuda", 0)
    base = dict(cpu=False, max_seq_len=256, decode_scan=4)
    dense = Master.from_args(_mk_args(**base)).make_engine(max_slots=2)
    prompts = [[7, 11, 13], [5, 3, 2, 6]]
    want = _serve(dense, prompts, 6)
    args = _mk_args(sp=2, tp=2, **base)
    master = Master.from_args(args, mesh_devices=[dev] * 4)
    engine = master.make_engine(
        max_slots=2, fault_plan="seed=1;engine.decode:nth=3:oom",
        recovery=True)
    caps = []
    real = engine.flight.count_capture
    engine.flight.count_capture = lambda fn, s: (caps.append(fn),
                                                 real(fn, s))[1]
    with engine:
        for wave in range(3):
            n0 = len(caps)
            hs = [engine.submit(p, max_new_tokens=6) for p in prompts]
            assert all(h.wait(timeout=180) for h in hs)
            assert [h.token_ids for h in hs] == want
            if wave:
                assert len(caps) == n0, caps[n0:]
    assert engine.stats.recoveries >= 1


@pytest.mark.cuda
def test_cuda_sp_tp_int4_products_match_their_plain_version():
    """The int4 matmul at sp 2 x tp 2's decode shard shapes of
    Llama-3-8B (M = 4 slots; wq/wk/wv/w_gate/w_up halves, wo and w_down
    contract halves of 16 and 56 groups) against its plain version, one
    launch counted a product."""
    _cuda_or_skip()
    from cake_tpu_torch.ops import int4_matmul as i4
    from cake_tpu_torch.ops.quant import quantize_group
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    shapes = ((4096, 2048), (4096, 512), (2048, 4096), (4096, 7168),
              (7168, 4096))
    i4.reset_launch_counts()
    for In, Out in shapes:
        w = quantize_group(torch.randn(In, Out, generator=g, device=dev), 0)
        x = torch.randn(4, In, generator=g, device=dev).bfloat16()
        got = i4.int4_matmul(x, w.q, w.scale, g=128)
        want = i4.int4_matmul_plain(x, w.q, w.scale, g=128)
        assert ((got.float() - want.float()).abs().max()
                <= 2e-2 * want.float().abs().max())
    assert i4.LAUNCHES["int4_matmul"] == len(shapes)
