"""The port's topology-sharded execution (cake_tpu_torch/parallel/)
against the JAX package's on the CPU, at f32 and the tiny config: the
cases of tests/test_parallel.py and the expert-parallel ones of
tests/test_moe.py, with the same numpy-seeded weights on both sides.

A port mesh on the CPU has the CPU at every position, as JAX's tests
run on 8 virtual CPU devices. Each sharded forward is held against
JAX's unsharded logits and, where JAX's test shards, JAX's sharded
logits, within LOGIT_TOL (the tp reduce sums in another order than the
unsharded matmul); greedy tokens are identical. The placement's
invariants are checked too: a shard is a copy of its slice only, a
replicated leaf is held once a device, the sharded cache is allocated
shard by shard, the streamed load and the shard-wise quantization give
the whole tree's placement. `cuda` cases (skipped without a card) hold
the captured pipelined steps against their eager calls on a co-located
mesh of the card, a recovery keeping every graph, and the kernels at
the shard shapes against their plain versions.
"""

import dataclasses

import numpy as np
import pytest

import torch

from cake_tpu_torch.models.llama.cache import KVCache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.model import RopeTables
from cake_tpu_torch.models.llama.params import params_from_numpy
from cake_tpu_torch.parallel.mesh import make_mesh
from cake_tpu_torch.parallel.pipeline import (
    make_pipeline_forward, place_for_pipeline,
)
from cake_tpu_torch.parallel.plan import ParallelPlan
from cake_tpu_torch.topology import Topology

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CFG = LlamaConfig.tiny(num_hidden_layers=4, vocab_size=128)


def _jax():
    """The JAX package's pieces (imported here: the card's `cuda` cases
    run where there is no JAX)."""
    import types

    import jax
    import jax.numpy as jnp

    from cake_tpu.models.llama.cache import KVCache
    from cake_tpu.models.llama.config import LlamaConfig
    from cake_tpu.models.llama.model import RopeTables, decode_step, forward
    from cake_tpu.models.llama.params import init_params
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, Cache=KVCache, Config=LlamaConfig,
        Rope=RopeTables, decode=decode_step, forward=forward,
        init=init_params,
        cfg=LlamaConfig.tiny(num_hidden_layers=4, vocab_size=128))
B, S, T = 8, 8, 64


def _cpu_cache(cfg=CFG, b=B, t=T):
    return KVCache.create(cfg, b, t, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def setup():
    """The same weights and tokens on both sides, JAX's unsharded
    logits and cache, and its 2-stage pipeline's and GSPMD tp's logits."""
    j = _jax()
    jax, jnp, JCache, JCFG, JRope = j.jax, j.jnp, j.Cache, j.cfg, j.Rope
    j_forward = j.forward
    from jax.sharding import Mesh

    from cake_tpu.parallel.pipeline import make_pipeline_forward as jpf
    from cake_tpu.parallel.pipeline import place_for_pipeline as jplace
    from cake_tpu.parallel.sharding import shard_cache, shard_params

    jp = j.init(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                           JCFG.vocab_size, dtype=jnp.int32))
    jrope = JRope.create(JCFG, T)
    ref, ref_cache = j_forward(jp, jnp.asarray(tokens),
                               JCache.create(JCFG, B, T, dtype=jnp.float32),
                               jnp.int32(0), jrope, JCFG)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2, 1),
                ("dp", "stage", "tp"))
    p2, c2 = jplace(jp, JCache.create(JCFG, B, T, dtype=jnp.float32), mesh)
    j_pipe, _ = jpf(mesh, JCFG)(p2, jnp.asarray(tokens), c2, jnp.int32(0),
                                jrope)
    tmesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 1, 2),
                 ("dp", "stage", "tp"))
    j_tp, _ = j_forward(shard_params(jp, tmesh), jnp.asarray(tokens),
                        shard_cache(JCache.create(JCFG, B, T,
                                                  dtype=jnp.float32), tmesh),
                        jnp.int32(0), jrope, JCFG)
    return dict(
        jp=jp, params=params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu"),
        tokens=torch.from_numpy(tokens.copy()), rope=RopeTables.create(CFG, T),
        ref=np.asarray(ref), ref_k=np.asarray(ref_cache.k),
        j_pipe=np.asarray(j_pipe), j_tp=np.asarray(j_tp))


def _run(setup, dp, stage, tp, M):
    mesh = make_mesh(dp, stage, tp, device_type="cpu")
    pf = make_pipeline_forward(mesh, CFG, num_microbatches=M, tp=tp > 1,
                               dp=dp > 1)
    p, c = place_for_pipeline(setup["params"], _cpu_cache(), mesh,
                              tp=tp > 1, dp=dp > 1)
    logits, c = pf(p, setup["tokens"], c, 0, setup["rope"])
    return logits.numpy(), c


def _close(got, want):
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_cpu_mesh_has_every_position_and_cuda_needs_cards():
    """JAX's eight virtual devices: a CPU mesh holds the CPU at every
    position; a CUDA mesh that needs more cards than it has raises JAX's
    message (a CUDA device list needs no card to build)."""
    mesh = make_mesh(2, 2, 2, device_type="cpu")
    assert mesh.shape == {"dp": 2, "stage": 2, "tp": 2} and mesh.size == 8
    assert {str(d) for d in mesh.devices.flat} == {"cpu"}
    with pytest.raises(ValueError, match="= 4 devices, but only 1 available"):
        make_mesh(1, 2, 2, devices=[torch.device("cuda", 0)])
    # a card repeated: the co-located mesh
    co = make_mesh(1, 2, 2, devices=[torch.device("cuda", 0)] * 4)
    assert co.distinct_devices() == [torch.device("cuda", 0)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(1, 2, 1)


def test_plan_from_topology():
    topo = Topology.from_dict({
        "a": {"layers": ["model.layers.0-1"]},
        "b": {"layers": ["model.layers.2-3"]},
    })
    plan = ParallelPlan.from_topology(CFG, topo)
    assert plan.stages == 2
    mesh = plan.build_mesh(device_type="cpu")
    assert mesh.shape == {"dp": 1, "stage": 2, "tp": 1}
    assert plan.describe().splitlines()[0] == "mesh: dp=1 x stage=2 x tp=1"


def test_plan_rejects_uneven_stages_and_too_few_cards():
    from cake_tpu.parallel.plan import ParallelPlan as JPlan
    from cake_tpu.topology import Topology as JTopo
    raw = {"a": {"layers": ["model.layers.0-2"]},
           "b": {"layers": ["model.layers.3"]}}
    with pytest.raises(ValueError, match="equal-size") as got:
        ParallelPlan.from_topology(CFG, Topology.from_dict(raw))
    JCFG = _jax().cfg
    with pytest.raises(ValueError) as want:
        JPlan.from_topology(JCFG, JTopo.from_dict(raw))
    assert str(got.value) == str(want.value)
    even = Topology.from_dict({"a": {"layers": ["model.layers.0-1"]},
                               "b": {"layers": ["model.layers.2-3"]}})
    args = dataclasses.make_dataclass("A", [("dp", int), ("tp", int)])(1, 2)
    with pytest.raises(ValueError) as got:
        ParallelPlan.from_topology(CFG, even, args=args, num_devices=2)
    with pytest.raises(ValueError) as want:
        JPlan.from_topology(JCFG, JTopo.from_dict(
            {"a": {"layers": ["model.layers.0-1"]},
             "b": {"layers": ["model.layers.2-3"]}}), args=args,
            num_devices=2)
    assert str(got.value) == str(want.value)


def test_tp_sharded_matches_single(setup):
    """tp 2 on one stage: JAX's GSPMD tp and unsharded logits."""
    got, _ = _run(setup, 1, 1, 2, 1)
    _close(got, setup["ref"])
    _close(got, setup["j_tp"])


def test_pipeline_matches_single_2stage(setup):
    got, c = _run(setup, 1, 2, 1, 1)
    _close(got, setup["ref"])
    _close(got, setup["j_pipe"])
    np.testing.assert_allclose(c.gather().k.numpy(), setup["ref_k"],
                               atol=1e-5)


def test_pipeline_microbatched_matches(setup):
    got, _ = _run(setup, 1, 4, 1, 4)
    _close(got, setup["ref"])


def test_pipeline_with_tp_and_dp(setup):
    """dp 2 x stage 2 x tp 2 on 8 positions, two microbatches."""
    got, c = _run(setup, 2, 2, 2, 2)
    _close(got, setup["ref"])
    np.testing.assert_allclose(c.gather().k.numpy(), setup["ref_k"],
                               atol=1e-5)


def test_pipeline_decode_consistency(setup):
    """Pipelined prefill + decode step == JAX's unsharded prefill +
    decode step."""
    j = _jax()
    jnp, JCache, JCFG = j.jnp, j.Cache, j.cfg
    j_forward, j_decode = j.forward, j.decode
    jp, jrope = setup["jp"], j.Rope.create(JCFG, T)
    ref_l, ref_c = j_forward(jp, jnp.asarray(setup["tokens"].numpy()),
                             JCache.create(JCFG, B, T, dtype=jnp.float32),
                             jnp.int32(0), jrope, JCFG)
    nxt = np.asarray(jnp.argmax(ref_l, -1)).astype(np.int32)[:, None]
    ref_l2, _ = j_decode(jp, jnp.asarray(nxt), jnp.int32(S), ref_c, jrope,
                         JCFG)
    mesh = make_mesh(1, 2, 1, device_type="cpu")
    pf = make_pipeline_forward(mesh, CFG, num_microbatches=2)
    p, c = place_for_pipeline(setup["params"], _cpu_cache(), mesh)
    _, c = pf(p, setup["tokens"], c, 0, setup["rope"])
    l2, _ = pf(p, torch.from_numpy(nxt), c, S, setup["rope"])
    _close(l2.numpy(), np.asarray(ref_l2))


def test_placement_memory_70b_fits_the_h100():
    """Llama-3-70B over stage 8 x tp 2 fits the card's memory and over
    one device does not, counted from the pipeline's specs: the same
    bytes JAX counts for the same plan."""
    from cake_tpu.parallel.plan import placement_memory as j_pm
    from cake_tpu_torch.parallel.plan import HBM_BUDGET, placement_memory

    cfg = LlamaConfig.llama3_70b()
    rep = placement_memory(cfg, stages=8, tp=2, batch_size=8,
                           max_seq_len=4096)
    assert rep == j_pm(_jax().Config.llama3_70b(), stages=8, tp=2, batch_size=8,
                       max_seq_len=4096)
    assert rep["devices"] == 16
    assert 6 * 2**30 < rep["params_bytes_per_device"] < 16 * 2**30
    assert rep["total_bytes_per_device"] < HBM_BUDGET["h100"]
    rep1 = placement_memory(cfg, stages=1, tp=1, batch_size=8,
                            max_seq_len=4096)
    assert rep1["total_bytes_per_device"] > HBM_BUDGET["h100"]


@pytest.mark.parametrize("quant", [True, "int4"])
def test_placement_memory_quant_halves_block_bytes(quant):
    from cake_tpu.parallel.plan import placement_memory as j_pm
    from cake_tpu_torch.parallel.plan import placement_memory

    cfg = LlamaConfig.llama3_8b()
    bf16 = placement_memory(cfg, stages=2, batch_size=1, max_seq_len=1024)
    q = placement_memory(cfg, stages=2, tp=2, batch_size=1,
                         max_seq_len=1024, quant=quant)
    assert q == j_pm(_jax().Config.llama3_8b(), stages=2, tp=2, batch_size=1,
                     max_seq_len=1024, quant=quant)
    one = placement_memory(cfg, stages=2, batch_size=1, max_seq_len=1024,
                           quant=quant)
    assert one["params_bytes_per_device"] < 0.62 * \
        bf16["params_bytes_per_device"]


def test_block_specs_refuse_an_unknown_leaf():
    from cake_tpu.models.llama.params import block_specs as j_specs
    from cake_tpu_torch.models.llama.params import block_specs
    with pytest.raises(KeyError) as got:
        block_specs(["wq", "w_mystery"], stage_axis="stage")
    with pytest.raises(KeyError) as want:
        j_specs(["wq", "w_mystery"], stage_axis="stage")
    assert str(got.value) == str(want.value)


def test_expand_specs_for_quant_are_jaxs():
    """Per-channel scales drop the contracted dims, group-wise ones keep
    the whole spec: the port's tuples are JAX's PartitionSpecs."""
    from cake_tpu.ops.quant import expand_spec as j_expand
    from cake_tpu_torch.ops.quant import contract_dims_for_path, expand_spec
    for spec, dims, nd, gw in ((("stage", "tp", None), (1,), 3, False),
                               (("stage", None, "tp"), (1,), 3, True),
                               ((None, "tp"), (0,), 2, False),
                               (("stage", "ep", None, "tp"), (2,), 4, False)):
        got = expand_spec(spec, dims, nd, groupwise=gw)
        from jax.sharding import PartitionSpec
        want = j_expand(PartitionSpec(*spec), dims, nd,
                        groupwise=gw)
        assert got.q == tuple(want.q) and got.scale == tuple(want.scale)
    assert contract_dims_for_path(("blocks", "we_down")) == (2,)
    with pytest.raises(KeyError, match="no contract-dim rule"):
        contract_dims_for_path(("blocks", "router"))


def test_a_shard_is_its_slice_and_a_replica_is_held_once():
    """A shard owns a copy of its slice only (not a view keeping the
    whole tensor alive); a replicated leaf is one tensor for every
    position of a device, the whole tensor itself on its own device;
    the sharded cache is zeros of each shard's own shape."""
    from cake_tpu_torch.parallel.sharding import create_sharded_cache, place
    mesh = make_mesh(1, 2, 2, device_type="cpu")
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    sh = place(x, mesh, ("stage", None, "tp"))
    for s in range(2):
        for t in range(2):
            part = sh.shard(0, s, t)
            assert part.shape == (2, 6, 4)
            assert part.untyped_storage().nbytes() == part.numel() * 4
            assert torch.equal(part, x[2 * s:2 * s + 2, :, 4 * t:4 * t + 4])
    assert torch.equal(sh.gather(), x)
    rep = place(x, mesh, ())
    assert len(rep.distinct()) == 1 and rep.shard(0, 1, 1) is x
    c = create_sharded_cache(CFG, 4, 16, mesh, tp_axis="tp", dtype=torch.float32)
    assert c.local(0, 1, 1).k.shape == (2, 4, 16, 1, 16)
    assert c.memory_bytes() == 2 * 4 * 4 * 16 * 2 * 16 * 4


def test_streamed_load_and_shardwise_quant_equal_the_whole_tree(tmp_path):
    """load_params_sharded reads each shard's slice from the files and
    gives what the whole load placed gives; --quant int8 and int4 shard
    by shard give the whole tree's quantization placed (an int8
    channel's scale over a tp-split contract dim maxed over its
    shards)."""
    from cake_tpu_torch.models.llama.params import (
        block_param_keys, init_params, load_params_from_hf,
        load_params_sharded,
    )
    from cake_tpu_torch.ops.quant import quantize_params
    from cake_tpu_torch.parallel.pipeline import (
        pipeline_param_specs, place_params,
    )
    from cake_tpu_torch.parallel.sharding import (
        gather_tree, quantize_sharded,
    )
    from cake_tpu_torch.utils.loading import save_safetensors

    cfg = LlamaConfig.tiny(num_hidden_layers=4, hidden_size=256,
                           intermediate_size=512, num_attention_heads=8,
                           num_key_value_heads=2, vocab_size=128)
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                    dtype=torch.float32)
    names = {"model.embed_tokens.weight": p["embed"],
             "model.norm.weight": p["final_norm"],
             "lm_head.weight": p["lm_head"].T}
    hf = {"attn_norm": "input_layernorm", "wq": "self_attn.q_proj",
          "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
          "wo": "self_attn.o_proj", "mlp_norm": "post_attention_layernorm",
          "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
          "w_down": "mlp.down_proj"}
    for k, v in p["blocks"].items():
        for i in range(cfg.num_hidden_layers):
            w = v[i] if v.ndim == 2 else v[i].T
            names[f"model.layers.{i}.{hf[k]}.weight"] = w.contiguous()
    save_safetensors(str(tmp_path / "model.safetensors"),
                     {k: v.numpy() for k, v in names.items()})
    mesh = make_mesh(1, 2, 2, device_type="cpu")
    specs = pipeline_param_specs(block_param_keys(cfg), "tp")
    streamed = load_params_sharded(str(tmp_path), cfg, mesh, specs,
                                   dtype=torch.float32)
    whole = load_params_from_hf(str(tmp_path), cfg, dtype=torch.float32,
                                device="cpu")
    placed = place_params(whole, mesh, tp=True)
    for k in ("embed", "lm_head"):
        assert torch.equal(streamed[k].gather(), placed[k].gather())
    for k, v in placed["blocks"].items():
        assert torch.equal(streamed["blocks"][k].shard(0, 1, 1), v.shard(0, 1, 1))
    for bits in (8, 4):
        got = gather_tree(quantize_sharded(streamed, bits=bits))
        want = quantize_params(whole, bits=bits)
        for k in ("wo", "w_down", "wq"):
            assert torch.equal(got["blocks"][k].q, want["blocks"][k].q), k
            assert torch.equal(got["blocks"][k].scale,
                               want["blocks"][k].scale), k
        assert torch.equal(got["lm_head"].q, want["lm_head"].q)


# -- mixture of experts: the pipeline and the expert axis -----------------------


@pytest.fixture(scope="module")
def moe():
    from cake_tpu.models.moe import MoEConfig as JMoE
    from cake_tpu.models.moe import init_params as j_moe_init
    from cake_tpu_torch.models.moe import MoEConfig
    jax, jnp = _jax().jax, _jax().jnp
    jcfg = JMoE.tiny(num_hidden_layers=4, num_local_experts=4)
    jp = j_moe_init(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return (jcfg, jp, MoEConfig.tiny(num_hidden_layers=4,
                                     num_local_experts=4),
            params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))


def _moe_ref(jcfg, jp, tokens, t=32):
    j = _jax()
    jnp, JCache, JRope, j_forward = j.jnp, j.Cache, j.Rope, j.forward
    ref, _ = j_forward(jp, jnp.asarray(tokens),
                       JCache.create(jcfg, tokens.shape[0], t,
                                     dtype=jnp.float32),
                       jnp.int32(0), JRope.create(jcfg, t), jcfg)
    return np.asarray(ref)


@pytest.mark.parametrize("stage, tp, M", [
    (2, 1, 2),      # MoE blocks through the pipeline
    (2, 2, 1),      # experts' ffn dim over tp
    (2, 2, 2),      # over tp, with two microbatches
])
def test_pipeline_with_moe_blocks_matches_single(moe, stage, tp, M):
    jcfg, jp, cfg, params = moe
    tokens = (np.arange(32, dtype=np.int32).reshape(4, 8)
              % cfg.vocab_size)
    want = _moe_ref(jcfg, jp, tokens)
    mesh = make_mesh(1, stage, tp, device_type="cpu")
    pf = make_pipeline_forward(mesh, cfg, num_microbatches=M, tp=tp > 1)
    p, c = place_for_pipeline(params, _cpu_cache(cfg, 4, 32), mesh,
                              tp=tp > 1)
    if tp > 1:
        assert p["blocks"]["we_gate"].shard(0, 0, 1).shape[-1] == \
            cfg.intermediate_size // tp
    got, _ = pf(p, torch.from_numpy(tokens), c, 0,
                RopeTables.create(cfg, 32))
    _close(got.numpy(), want)


def test_ep_shard_map_matches_unsharded(moe):
    """moe_mlp with ep_axis over the experts' four contiguous shards ==
    JAX's unsharded moe_mlp (and its manual shard_map EP)."""
    from cake_tpu.ops.moe import moe_mlp as j_moe
    from cake_tpu_torch.ops.moe import moe_mlp
    jax, jnp = _jax().jax, _jax().jnp
    jcfg, jp, cfg, params = moe
    lp_j = jax.tree.map(lambda x: x[0], jp["blocks"])
    rng = np.random.default_rng(2)
    h = rng.normal(size=(1, 4, cfg.hidden_size)).astype(np.float32)
    want = np.asarray(j_moe(lp_j, jnp.asarray(h), jcfg.num_experts_per_tok))
    lp = {k: v[0] for k, v in params["blocks"].items()}
    for k in ("we_gate", "we_up", "we_down"):
        lp[k] = list(lp[k].split(1, dim=0))
    got = moe_mlp(lp, torch.from_numpy(h), cfg.num_experts_per_tok,
                  ep_axis="ep")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_shard_params_places_moe_pytree(moe):
    """shard_params derives specs from the block leaves (dense or MoE):
    the experts over ep, their ffn dim over tp, and back whole."""
    from cake_tpu_torch.models.moe.params import param_specs
    from cake_tpu_torch.parallel.sharding import gather_tree, shard_params
    _, _, cfg, params = moe
    mesh = make_mesh(1, 1, 2, device_type="cpu")
    placed = shard_params(params, mesh)
    assert placed["blocks"]["we_gate"].shape == \
        params["blocks"]["we_gate"].shape
    assert placed["blocks"]["we_gate"].shard(0, 0, 1).shape[-1] == \
        cfg.intermediate_size // 2
    back = gather_tree(placed)
    assert torch.equal(back["blocks"]["we_down"],
                       params["blocks"]["we_down"])
    assert param_specs()["blocks"]["we_gate"] == (None, "ep", None, "tp")


# -- on the card: a co-located mesh -------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the captured pipelined steps "
                    "and the kernels at shard shapes run on CUDA")


@pytest.mark.cuda
def test_cuda_captured_pipelined_steps_replay_their_eager_calls():
    """The engine's pipelined steps over stage 2 x tp 2 with two
    microbatches on four positions of one card, as CUDA graphs
    (DecodeRunner, DensePrefillRunner): every replay of a wave of
    different rows equals the same step run eagerly from a copy of the
    cache (logits and every shard), and the flash kernels launch."""
    _cuda_or_skip()
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.ops import flash_attention as fa
    from cake_tpu_torch.parallel.pipeline import (
        make_engine_step_fns, place_params,
    )
    from cake_tpu_torch.parallel.sharding import create_sharded_cache
    from cake_tpu_torch.serve.graphs import DensePrefillRunner
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(CFG, use_flash_attention=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.float32)
    mesh = make_mesh(1, 2, 2, devices=[dev] * 4)
    sp = place_params(params, mesh, tp=True)
    fns = make_engine_step_fns(mesh, cfg, num_microbatches=2, tp=True)
    cache = create_sharded_cache(cfg, 4, T, mesh, tp_axis="tp",
                                 dtype=torch.float32)
    rope = RopeTables.create(cfg, T, device=dev)
    runner = DensePrefillRunner(sp, cache, rope, cfg,
                                fns={"slot": fns[0], "chunk": fns[3]})
    fa.reset_launch_counts()
    for slot, n in ((0, 20), (2, 9), (3, 30)):
        ids = [(7 * slot + j) % 100 + 3 for j in range(n)]
        eager = cache.fresh()
        for a, b in ((eager.k, cache.k), (eager.v, cache.v)):
            for x, y in zip(a.distinct(), b.distinct()):
                x.copy_(y)
        want, _ = fns[0](sp, torch.tensor([ids + [0] * (32 - n)],
                                          dtype=torch.int32, device=dev),
                         torch.tensor([n], dtype=torch.int32, device=dev),
                         slot, eager, rope, cfg)
        got = runner.run(("slot", 32), ids + [0] * (32 - n), n, slot)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        torch.testing.assert_close(cache.gather().k, eager.gather().k,
                                   rtol=0, atol=1e-5)
    assert runner.captures == 1 and fa.LAUNCHES["flash_attn"] > 0


@pytest.mark.cuda
def test_cuda_shard_shape_kernels_match_their_plain_versions():
    """flash_attn and flash_attn_cached at a tp rank's heads (16 query,
    4 kv of Llama-3-8B over tp 2) and int4_matmul at tp 2's shard shapes
    (16 and 56 groups) against their plain versions."""
    _cuda_or_skip()
    from cake_tpu_torch.ops import flash_attention as fa
    from cake_tpu_torch.ops import int4_matmul as i4
    from cake_tpu_torch.ops.quant import quantize_group
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev, dtype=dtype)

    q, k, v = rnd(1, 256, 16, 128), rnd(1, 256, 4, 128), rnd(1, 256, 4, 128)
    torch.testing.assert_close(fa.flash_attention(q, k, v),
                               fa.flash_attention_plain(q, k, v),
                               atol=2e-2, rtol=2e-2)
    kc, vc = rnd(1, 512, 4, 128), rnd(1, 512, 4, 128)
    pos = torch.tensor([128], dtype=torch.int32, device=dev)
    torch.testing.assert_close(fa.flash_attention_cached(q, kc, vc, pos),
                               fa.flash_attention_cached_plain(q, kc, vc,
                                                               pos),
                               atol=2e-2, rtol=2e-2)
    for In, Out in ((4096, 2048), (2048, 4096), (7168, 4096)):
        w = quantize_group(rnd(In, Out, dtype=torch.float32), 0)
        x = rnd(1, In)
        got = i4.int4_matmul(x, w.q, w.scale, g=128)
        want = i4.int4_matmul_plain(x, w.q, w.scale, g=128)
        assert ((got.float() - want.float()).abs().max()
                <= 2e-2 * want.float().abs().max())


def test_moe_streamed_load_equals_the_whole_load_placed(tmp_path):
    """MoE's load_params_sharded over stage 2 x tp 2 (experts' ffn dim
    split): each shard read from the Mixtral layout's files equals the
    whole load placed."""
    from cake_tpu_torch.models.llama.params import block_param_keys
    from cake_tpu_torch.models.moe import MoEConfig
    from cake_tpu_torch.models.moe.params import (
        load_params_from_hf, load_params_sharded,
    )
    from cake_tpu_torch.parallel.pipeline import (
        pipeline_param_specs, place_params,
    )
    from cake_tpu_torch.utils.loading import save_safetensors

    c = MoEConfig.tiny(num_hidden_layers=2, num_local_experts=3)
    rng = np.random.default_rng(3)
    D, F, E = c.hidden_size, c.intermediate_size, c.num_local_experts
    hd, H, KV = c.head_dim, c.num_attention_heads, c.num_key_value_heads

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)

    tensors = {"model.embed_tokens.weight": r(c.vocab_size, D),
               "model.norm.weight": r(D),
               "lm_head.weight": r(c.vocab_size, D)}
    for i in range(2):
        pre = f"model.layers.{i}"
        tensors.update({
            f"{pre}.input_layernorm.weight": r(D),
            f"{pre}.post_attention_layernorm.weight": r(D),
            f"{pre}.self_attn.q_proj.weight": r(H * hd, D),
            f"{pre}.self_attn.k_proj.weight": r(KV * hd, D),
            f"{pre}.self_attn.v_proj.weight": r(KV * hd, D),
            f"{pre}.self_attn.o_proj.weight": r(D, H * hd),
            f"{pre}.block_sparse_moe.gate.weight": r(E, D),
        })
        for e in range(E):
            base = f"{pre}.block_sparse_moe.experts.{e}"
            tensors[f"{base}.w1.weight"] = r(F, D)
            tensors[f"{base}.w2.weight"] = r(D, F)
            tensors[f"{base}.w3.weight"] = r(F, D)
    save_safetensors(str(tmp_path / "model.safetensors"), tensors)
    mesh = make_mesh(1, 2, 2, device_type="cpu")
    specs = pipeline_param_specs(block_param_keys(c), "tp")
    streamed = load_params_sharded(str(tmp_path), c, mesh, specs,
                                   dtype=torch.float32)
    placed = place_params(load_params_from_hf(str(tmp_path), c,
                                              dtype=torch.float32,
                                              device="cpu"), mesh, tp=True)
    for k, v in placed["blocks"].items():
        for pos in ((0, 0, 0), (0, 1, 1)):
            assert torch.equal(streamed["blocks"][k].shard(*pos),
                               v.shard(*pos)), k
    assert torch.equal(streamed["lm_head"].gather(), placed["lm_head"].gather())


def test_ring_step_fns_refuse_a_whole_bucket_prefill():
    from cake_tpu_torch.parallel.pipeline import make_engine_step_fns
    mesh = make_mesh(1, 2, 1, device_type="cpu")
    fns = make_engine_step_fns(mesh, CFG, ring=True)
    with pytest.raises(RuntimeError, match="whole-bucket prefill is not "
                                           "available on the ring"):
        fns[0](None, None, None, 0, None, None, CFG)
