"""Topology-sharded serving through the port's entry points, against the
JAX package's on the CPU (the non-sp cases of
tests/test_serving_topology.py and tests/test_moe.py's engine over a
topology).

A two-way layer split runs end to end through Args -> Context ->
LlamaGenerator / InferenceEngine / the CLI, on a mesh whose positions
are all the CPU, at f32 with flash off. The weights are JAX's own
random init (the JAX context's, carried across), so the port's
generator and engine over the topology are held greedy-identical to the
JAX engine over the same topology, and to the port's unsharded paths;
int8 and int4 place their scales with the pipeline's specs; K-step
decode and chunked prefill equal the step-by-step and whole-prompt
paths; a sliding-window config serves through the ring step fns; a
registered prefix's hit serves the prefix-free streams; and the plan's
refusals carry JAX's messages (the tp-divides-KV check outside --sp is
the port's own). A `cuda` case (skipped without a card) runs the
pipelined engine on a co-located mesh of the card through a recovery
that keeps every graph.
"""

import numpy as np
import pytest

import torch

from cake_tpu_torch.args import Args
from cake_tpu_torch.context import Context
from cake_tpu_torch.master import Master
from cake_tpu_torch.models.chat import Message

TOPOLOGY_2WAY = """\
worker0:
  host: 10.0.0.1:10128
  description: first half
  layers:
    - model.layers.0-1
worker1:
  host: 10.0.0.2:10128
  description: second half
  layers:
    - model.layers.2-3
"""
PROMPTS = [[7, 11, 13], [5, 3, 2, 6]]


@pytest.fixture(scope="module")
def topo_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("topo") / "topology.yml"
    p.write_text(TOPOLOGY_2WAY)
    return str(p)


@pytest.fixture(scope="module")
def jax_run(topo_path):
    """JAX's tiny random model (its context's PRNGKey(0) init) and its
    engine over the topology: the weights as numpy, the streams."""
    import jax

    from cake_tpu.args import Args as JArgs
    from cake_tpu.context import Context as JContext
    from cake_tpu.master import Master as JMaster

    args = JArgs(model="", max_seq_len=256, batch_size=1, sample_len=8,
                 temperature=0.0, repeat_penalty=1.0, flash_attention=False,
                 topology=topo_path).validate()
    gen = JContext.from_args(args).load_text_model()
    eng = JMaster(args, text_generator=gen).make_engine(max_slots=4)
    with eng:
        hs = [eng.submit(p, max_new_tokens=6, temperature=0.0,
                         repeat_penalty=1.0) for p in PROMPTS]
        assert all(h.wait(timeout=180) for h in hs)
    return dict(params=jax.tree.map(np.asarray, gen.params),
                streams=[list(h._req.out_tokens) for h in hs])


@pytest.fixture
def jax_weights(jax_run, monkeypatch):
    """The port's contexts load JAX's weights (load_text_params
    replaced: the tiny config, no checkpoint)."""
    import cake_tpu_torch.models as tmodels
    from cake_tpu_torch.models.llama.params import params_from_numpy

    def load(config, model_dir, dtype, device):
        return params_from_numpy(jax_run["params"], device=device,
                                 dtype=dtype)

    monkeypatch.setattr(tmodels, "load_text_params", load)


def _mk_args(**kw):
    base = dict(model="", max_seq_len=256, batch_size=1, sample_len=8,
                temperature=0.0, repeat_penalty=1.0, flash_attention=False,
                cpu=True, dtype="f32")
    base.update(kw)
    return Args(**base).validate()


def _gen(args):
    return Context.from_args(args).load_text_model()


def _serve(args, prompts=PROMPTS, n=6, **engine_kw):
    gen = _gen(args)
    engine = Master(args, text_generator=gen).make_engine(**engine_kw)
    with engine:
        hs = [engine.submit(p, max_new_tokens=n, temperature=0.0,
                            repeat_penalty=1.0) for p in prompts]
        assert all(h.wait(timeout=180) for h in hs)
    return engine, [list(h._req.out_tokens) for h in hs]


def test_load_text_model_consults_topology(topo_path):
    gen = _gen(_mk_args(topology=topo_path))
    assert gen.parallel is not None, "topology given but no plan attached"
    plan, mesh = gen.parallel
    assert plan.stages == 2
    assert "stage" in mesh.axis_names
    assert gen._forward_fn is not None
    # the stacked layer axis is split over the stages
    wq = gen.params["blocks"]["wq"]
    assert wq.spec[0] == "stage" and wq.shard(0, 1, 0).shape[0] == 2


def test_pipeline_serving_matches_single_device(topo_path, jax_weights):
    """Same prompt, greedy: the sharded and unsharded generators give one
    token stream, on JAX's weights."""
    outs = {}
    for name, args in (("single", _mk_args()),
                       ("pipeline", _mk_args(topology=topo_path)),
                       ("tp", _mk_args(topology=topo_path, tp=2))):
        gen = _gen(args)
        for m in (Message.system("sys"), Message.user("hello there")):
            gen.add_message(m)
        outs[name] = [gen.next_token(i).id for i in range(6)]
    assert outs["single"] == outs["pipeline"] == outs["tp"]


def test_generate_on_device_hostloop_matches_scan(topo_path):
    gen_s = _gen(_mk_args())
    gen_p = _gen(_mk_args(topology=topo_path))
    prompt = np.full((1, 9), 5, np.int32)
    plen = np.full((1,), 9, np.int32)
    np.testing.assert_array_equal(gen_s.generate_on_device(prompt, plen, 6),
                                  gen_p.generate_on_device(prompt, plen, 6))


@pytest.mark.parametrize("kw", [
    dict(), dict(tp=2), dict(decode_scan=4), dict(prefill_chunk=32),
    dict(tp=2, microbatches=2, batch_size=2),
])
def test_engine_over_topology_is_jaxs(topo_path, jax_weights, jax_run, kw):
    """The engine over the topology (tp 2, K = 4, chunked prefill,
    microbatches) gives the JAX engine's streams over the same topology
    and weights."""
    engine, got = _serve(_mk_args(topology=topo_path, **kw), max_slots=4)
    assert engine._custom_steps
    assert engine._decode_scan == kw.get("decode_scan", 1)
    if "prefill_chunk" in kw:
        assert engine.prefill_chunk == 32
    assert got == jax_run["streams"]


def test_engine_over_topology_chunked_prefill_matches_whole(topo_path):
    long_prompt = list(range(3, 3 + 70))   # > chunk of 32
    outs = {}
    for name, chunk in (("whole", None), ("chunked", 32)):
        _, outs[name] = _serve(
            _mk_args(topology=topo_path, prefill_chunk=chunk),
            prompts=[long_prompt], max_slots=4)
    assert outs["whole"] == outs["chunked"]


def _jax_quant_stream(topo_path, quant):
    """JAX's generator over the topology with --quant on its random
    weights (those jax_weights gives the port): six greedy tokens."""
    from cake_tpu.args import Args as JArgs
    from cake_tpu.context import Context as JContext
    from cake_tpu.models.chat import Message as JMessage
    args = JArgs(model="", max_seq_len=256, batch_size=1, sample_len=8,
                 temperature=0.0, repeat_penalty=1.0, flash_attention=False,
                 topology=topo_path, quant=quant).validate()
    gen = JContext.from_args(args).load_text_model()
    gen.add_message(JMessage.user("hi"))
    return [gen.next_token(i).id for i in range(6)]


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_generator_over_topology_is_jaxs(topo_path, jax_weights,
                                                   quant):
    """--quant int8 / int4 over two stages: the QTensor q and scale both
    over the stage axis (the int4 scale keeps the contract dim as its
    group dim), and JAX's greedy tokens over the same topology."""
    from cake_tpu_torch.ops.quant import QTensor, is_groupwise
    gen = _gen(_mk_args(topology=topo_path, quant=quant))
    wq = gen.params["blocks"]["wq"]
    assert isinstance(wq, QTensor)
    assert wq.q.spec[0] == "stage" and wq.scale.spec[0] == "stage"
    local = QTensor(wq.q.shard(0, 1, 0), wq.scale.shard(0, 1, 0))
    assert is_groupwise(local) == (quant == "int4")
    gen.add_message(Message.user("hi"))
    got = [gen.next_token(i).id for i in range(6)]
    assert got == _jax_quant_stream(topo_path, quant)


def test_engine_int4_over_topology(topo_path):
    """The pipelined engine over int4 weights serves the unsharded int4
    generator's tokens."""
    args = _mk_args(topology=topo_path, quant="int4")
    single = _gen(_mk_args(quant="int4"))
    want = single.generate_on_device(np.asarray([PROMPTS[1]], np.int32),
                                     np.asarray([4], np.int32), 6)[0]
    _, got = _serve(args, prompts=[PROMPTS[1]], max_slots=2)
    assert got[0] == want.tolist()[:len(got[0])] and got[0]


def test_int8_place_for_pipeline_specs(topo_path):
    """QTensor scale specs drop contracted dims: the scale's first entry
    is the stage axis, one dim fewer than q."""
    gen = _gen(_mk_args(topology=topo_path, quant="int8", tp=1))
    wq = gen.params["blocks"]["wq"]
    assert wq.q.spec[0] == "stage" and wq.scale.spec[0] == "stage"
    assert wq.scale.ndim == wq.q.ndim - 1


def test_cli_one_shot_with_topology(topo_path, capsys):
    from cake_tpu_torch.cli import main
    rc = main(["--cpu", "--topology", topo_path, "--tp", "2",
               "--max-seq-len", "256", "--sample-len", "4",
               "--temperature", "0.0", "--no-flash-attention",
               "--prompt", "hi"])
    assert rc == 0
    assert "hi" in capsys.readouterr().out


def test_ring_engine_over_topology_matches_the_unsharded_ring(tmp_path):
    """A sliding-window config over a topology: the ring step fns over a
    W-long sharded cache give the unsharded ring engine's streams, prompts
    past the window included."""
    from cake_tpu_torch.models.llama.config import LlamaConfig
    topo = tmp_path / "t.yml"
    topo.write_text(TOPOLOGY_2WAY)
    cfg = LlamaConfig.tiny(sliding_window=16)
    prompts = [list(range(3, 43)), [9, 8, 7]]
    outs = {}
    for name, kw in (("single", {}), ("ring", dict(topology=str(topo),
                                                   tp=2))):
        args = _mk_args(max_seq_len=64, prefill_chunk=16, **kw)
        ctx = Context.from_args(args)
        ctx.llama_config = cfg
        gen = ctx.load_text_model()
        engine = Master(args, text_generator=gen).make_engine(max_slots=2)
        assert engine.ring and engine._custom_steps == bool(kw)
        with engine:
            hs = [engine.submit(p, max_new_tokens=20, temperature=0.0,
                                repeat_penalty=1.0) for p in prompts]
            assert all(h.wait(timeout=180) for h in hs)
        outs[name] = [list(h._req.out_tokens) for h in hs]
    assert outs["single"] == outs["ring"]


def test_prefix_hit_over_topology_serves_the_plain_streams(topo_path):
    """A registered prefix on the pipelined engine: its lines installed
    shard by shard, the suffix windowed at pos0 = P through the chunk
    step; the streams are those without the prefix."""
    head = list(range(20, 60))
    prompts = [head + [5, 6, 7], head + list(range(70, 90))]
    args = _mk_args(topology=topo_path, tp=2)
    _, want = _serve(args, prompts=prompts, max_slots=2)
    gen = _gen(args)
    engine = Master(args, text_generator=gen).make_engine(max_slots=2)
    engine.register_prefix(head)
    with engine:
        hs = [engine.submit(p, max_new_tokens=6, temperature=0.0,
                            repeat_penalty=1.0) for p in prompts]
        assert all(h.wait(timeout=180) for h in hs)
    assert engine.stats.prefix_hits == 2
    assert [list(h._req.out_tokens) for h in hs] == want


def test_engine_serves_moe_over_topology(tmp_path):
    """Mixtral-style blocks through the pipelined engine over one block
    a stage (and tp 2 over the experts' ffn dim): the unsharded
    generator's greedy tokens."""
    from cake_tpu_torch.models.moe import MoEConfig
    topo = tmp_path / "topology.yml"
    topo.write_text("s0:\n  layers:\n    - model.layers.0\n"
                    "s1:\n  layers:\n    - model.layers.1\n")
    cfg = MoEConfig.tiny()
    prompt = [5, 9, 4, 7]
    want = None
    for kw in ({}, dict(topology=str(topo)), dict(topology=str(topo), tp=2)):
        args = _mk_args(max_seq_len=64, **kw)
        ctx = Context.from_args(args)
        ctx.llama_config = cfg
        gen = ctx.load_text_model()
        if not kw:
            want = gen.generate_on_device(np.asarray([prompt], np.int32),
                                          np.asarray([4], np.int32), 4)
            continue
        engine = Master(args, text_generator=gen).make_engine(max_slots=2)
        with engine:
            h = engine.submit(prompt, max_new_tokens=4, temperature=0.0,
                              repeat_penalty=1.0)
            assert h.wait(timeout=180)
        got = list(h._req.out_tokens)
        eos_at = next((i for i, t in enumerate(want[0])
                       if t in cfg.eos_token_ids), 4)
        assert got == want[0].tolist()[:eos_at + 1][:len(got)]
        assert len(got) >= min(eos_at + 1, 4)


# -- refusals ---------------------------------------------------------------------


def test_plan_refusals_carry_jaxs_messages(topo_path):
    with pytest.raises(ValueError, match="--batch-size 3 must be divisible "
                                         "by --dp 2"):
        _gen(_mk_args(topology=topo_path, dp=2, batch_size=3))
    with pytest.raises(ValueError, match="per-replica batch 1 must be "
                                         "divisible by --microbatches 2"):
        _gen(_mk_args(topology=topo_path, microbatches=2))
    with pytest.raises(ValueError, match="does not compose with "
                                         "--sp/--tp/--dp/topology stages"):
        _gen(_mk_args(topology=topo_path, draft_model=""))
    gen = _gen(_mk_args(topology=topo_path, microbatches=1))
    with pytest.raises(ValueError, match="--kv-pages requires the built-in "
                                         "dense single-device path"):
        Master(_mk_args(topology=topo_path, kv_pages=64),
               text_generator=gen).make_engine()
    with pytest.raises(ValueError, match="--max-slots 3 must be divisible "
                                         "by --microbatches 2"):
        Master(_mk_args(topology=topo_path, microbatches=2, batch_size=2),
               text_generator=_gen(_mk_args(topology=topo_path,
                                            microbatches=2, batch_size=2))
               ).make_engine(max_slots=3)


def test_tp_must_divide_kv_heads_and_int4_shards_hold_whole_groups(
        topo_path):
    """The port checks --tp against the KV heads on every plan (JAX only
    on its --sp branch), and refuses int4 tp shards that would split a
    quantization group, naming the leaf."""
    from cake_tpu_torch.models.llama.config import LlamaConfig
    with pytest.raises(ValueError, match="--tp 4 must divide kv heads 2"):
        _gen(_mk_args(topology=topo_path, tp=4))
    args = _mk_args(topology=topo_path, tp=2, quant="int4")
    ctx = Context.from_args(args)
    ctx.llama_config = LlamaConfig.tiny(intermediate_size=192)
    with pytest.raises(ValueError, match="wo's contract dim 64 has 1 groups "
                                         "of 64, not divisible over tp"):
        ctx.load_text_model()


def test_sp_and_the_multi_host_flags_are_refused_by_argparse(capsys):
    """--sp is parsed, and refused below 1 with JAX's message. The
    multi-host flags (ported with A13(2)) parse with JAX's names and
    defaults, and --mode takes JAX's two values only."""
    import dataclasses

    from cake_tpu.args import Args as JArgs

    from cake_tpu_torch.args import parse_args
    assert parse_args(["--sp", "2"]).sp == 2
    with pytest.raises(ValueError, match="--sp must be >= 1"):
        parse_args(["--sp", "0"])
    theirs = {f.name: f.default for f in dataclasses.fields(JArgs)}
    for flag, val, want in (("--mode", "worker", "worker"),
                            ("--name", "n", "n"),
                            ("--address", "1.2.3.4:5", "1.2.3.4:5"),
                            ("--heartbeat-timeout", "3", 3.0),
                            ("--stall-timeout", "3", 3.0)):
        name = flag[2:].replace("-", "_")
        assert getattr(Args(), name) == theirs[name], name
        assert getattr(parse_args([flag, val]), name) == want
    assert capsys.readouterr().err == ""
    with pytest.raises(ValueError) as ours:
        parse_args(["--mode", "peer"])
    with pytest.raises(ValueError) as jax_err:
        JArgs(mode="peer").validate()
    assert str(ours.value) == str(jax_err.value)
    a = parse_args(["--topology", "t.yml", "--tp", "2", "--dp", "2",
                    "--microbatches", "2"])
    assert (a.topology, a.tp, a.dp, a.microbatches) == ("t.yml", 2, 2, 2)
    with pytest.raises(ValueError, match="--microbatches must be >= 1"):
        parse_args(["--microbatches", "0"])


def test_a_live_switch_over_a_pipelined_engine_is_refused(topo_path):
    from cake_tpu_torch.autotune.space import EngineConfig
    args = _mk_args(topology=topo_path)
    engine = Master(args, text_generator=_gen(args)).make_engine(
        max_slots=2)
    assert not engine._reconfig_supported()
    assert engine._reconfig_refusal() == (
        "custom step fns own their cache contract; only the built-in "
        "dense/paged engines can hot-switch")
    with pytest.raises(ValueError, match="custom step fns own their cache "
                                         "contract"):
        engine.reconfigure(EngineConfig(slots=4))


# -- on the card ------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_pipelined_engine_recovers_keeping_its_graphs(topo_path):
    """The pipelined engine on a co-located mesh of the card (stage 2 x
    tp 2, four positions): two waves give the unsharded engine's f32
    streams, the second capturing nothing; a faulted wave recovers in
    place, capturing nothing anew, and serves the same streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the pipelined steps replay as "
                    "CUDA graphs there")
    dev = torch.device("cuda", 0)
    base = dict(cpu=False, flash_attention=True, decode_scan=4)
    _, want = _serve(_mk_args(**base), max_slots=2)
    args = _mk_args(topology=topo_path, tp=2, **base)
    ctx = Context.from_args(args, mesh_devices=[dev] * 4)
    gen = ctx.load_text_model()
    engine = Master(args, text_generator=gen).make_engine(
        max_slots=2, fault_plan="seed=1;engine.decode:nth=3:oom",
        recovery=True)
    caps = []
    real = engine.flight.count_capture
    engine.flight.count_capture = lambda fn, s: (caps.append(fn),
                                                 real(fn, s))[1]
    with engine:
        for wave in range(3):
            n0 = len(caps)
            hs = [engine.submit(p, max_new_tokens=6, temperature=0.0,
                                repeat_penalty=1.0) for p in PROMPTS]
            assert all(h.wait(timeout=180) for h in hs)
            assert [list(h._req.out_tokens) for h in hs] == want
            if wave:
                assert len(caps) == n0, caps[n0:]
    assert engine.stats.recoveries >= 1


def test_checkpoint_over_topology_streams_its_shards(topo_path, tmp_path,
                                                     monkeypatch):
    """A model directory with weights over a topology: Context streams
    each shard from the safetensors file (no whole load), then
    quantizes shard by shard; greedy tokens equal the unsharded context
    on the same directory, at f32 and int8."""
    import json

    import cake_tpu_torch.models as tmodels
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.utils.loading import save_safetensors

    cfg = LlamaConfig.tiny()
    p = init_params(cfg, torch.Generator().manual_seed(4), device="cpu",
                    dtype=torch.float32)
    hf = {"attn_norm": "input_layernorm", "wq": "self_attn.q_proj",
          "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
          "wo": "self_attn.o_proj", "mlp_norm": "post_attention_layernorm",
          "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
          "w_down": "mlp.down_proj"}
    names = {"model.embed_tokens.weight": p["embed"],
             "model.norm.weight": p["final_norm"],
             "lm_head.weight": p["lm_head"].T.contiguous()}
    for k, v in p["blocks"].items():
        for i in range(cfg.num_hidden_layers):
            names[f"model.layers.{i}.{hf[k]}.weight"] = (
                v[i] if v.ndim == 2 else v[i].T).contiguous()
    save_safetensors(str(tmp_path / "model.safetensors"),
                     {k: v.numpy() for k, v in names.items()})
    (tmp_path / "config.json").write_text(json.dumps(dict(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.num_key_value_heads, bos_token_id=1,
        eos_token_id=2, max_position_embeddings=256)))
    whole = []
    real = tmodels.load_text_params
    monkeypatch.setattr(tmodels, "load_text_params", lambda *a, **k: (
        whole.append(1), real(*a, **k))[1])
    for quant in ("none", "int8"):
        outs = {}
        for name, kw in (("single", {}), ("sharded", dict(
                topology=topo_path, tp=2))):
            del whole[:]
            gen = _gen(_mk_args(model=str(tmp_path), quant=quant, **kw))
            assert bool(whole) == (name == "single")
            gen.add_message(Message.user("hello"))
            outs[name] = [gen.next_token(i).id for i in range(6)]
        assert outs["single"] == outs["sharded"], quant


def test_two_step_fns_ignore_scan_and_chunk_with_jaxs_warnings(
        topo_path, caplog):
    """JAX's seam with two functions (prefill_slot_fn, decode_ragged_fn):
    --decode-scan and --prefill-chunk are ignored with JAX's warnings,
    no prefix is served, and the streams are the four-function
    engine's."""
    from cake_tpu_torch.serve.engine import InferenceEngine
    args = _mk_args(topology=topo_path)
    gen = _gen(args)
    full = Master(args, text_generator=gen)._parallel_kwargs(2)
    with caplog.at_level("WARNING"):
        engine = InferenceEngine(
            gen.config, gen.params, gen.tokenizer, device="cpu",
            max_slots=2, max_seq_len=gen.max_seq_len, decode_scan_steps=4,
            prefill_chunk=32, cache_dtype=torch.float32,
            step_fns=full["step_fns"][:2], cache=full["cache"])
    assert engine._decode_scan == 1 and engine.prefill_chunk is None
    assert "provide no scan variant" in caplog.text
    assert "provide no chunked-prefill variant" in caplog.text
    with pytest.raises(ValueError, match="no chunked-prefill variant to "
                                         "window the suffix"):
        engine.register_prefix(list(range(20, 40)))
    with engine:
        hs = [engine.submit(p, max_new_tokens=6, temperature=0.0,
                            repeat_penalty=1.0) for p in PROMPTS]
        assert all(h.wait(timeout=180) for h in hs)
    _, want = _serve(args, max_slots=2)
    assert [list(h._req.out_tokens) for h in hs] == want
