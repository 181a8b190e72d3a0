"""Sequence parallelism composed with pipeline stages
(cake_tpu_torch/parallel/sp_pipeline.py) and with dp and quantized
trees, against the JAX package on the CPU: the cases of
tests/test_sp_pipeline.py.

The ("stage", "sp"[, "tp"]) forwards chain each stage's block range
through the ring prefill and the merged-stats decode; with JAX's random
weights carried across (`params_from_numpy`), their prefill and three
greedy decode steps agree with JAX's stage x sp logits within
LOGIT_TOL, and so do int8 trees over stage x sp x tp and group-aligned
int4 trees over sp x tp and stage x sp x tp (a tp shard holding whole
groups: the QTensor's q and scale both over "tp"). The generator's
K decode replays equal its stepwise decode; Args -> Context builds the
stage x sp generator, streams its weights stage-locally from a
checkpoint, and generates the unsharded generator's tokens on a full
window; dp x sp rows equal the unsharded forward's; and the refusals
(int4 splitting a group over tp, stages with dp) are JAX's.
"""

import numpy as np
import pytest

import torch

from cake_tpu_torch.args import Args
from cake_tpu_torch.context import Context
from cake_tpu_torch.models.llama.cache import KVCache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.model import (
    RopeTables, decode_step, prefill,
)
from cake_tpu_torch.models.llama.params import params_from_numpy
from cake_tpu_torch.parallel.context_parallel import (
    make_sp_forward, place_sp_params,
)
from cake_tpu_torch.parallel.mesh import make_sp_mesh
from cake_tpu_torch.parallel.sp_pipeline import (
    make_sp_stage_forward, place_sp_stage_params,
)

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CTX, TAIL = 64, 16
# JAX's (shape, axes) and the port's make_sp_mesh arguments
STAGE_MESHES = {
    "stage2_sp4": ((2, 4), ("stage", "sp"), dict(stage=2, sp=4)),
    "stage4_sp2": ((4, 2), ("stage", "sp"), dict(stage=4, sp=2)),
    "stage2_sp2_tp2": ((2, 2, 2), ("stage", "sp", "tp"),
                       dict(stage=2, sp=2, tp=2)),
}
TOPOLOGY_2WAY = """\
worker0:
  host: 10.0.0.1:10128
  layers:
    - model.layers.0-1
worker1:
  host: 10.0.0.2:10128
  layers:
    - model.layers.2-3
"""


def _jmesh(shape, axes):
    import jax
    from jax.sharding import Mesh
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _inputs():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, (2, CTX)).astype(np.int32)
    return tokens, np.array([CTX, CTX - 11], np.int32)


def _jax_rollout(jc, jp, mesh, tp, tokens, plen, stage=True, steps=3):
    """JAX's stage x sp (or sp) prefill and greedy decode logits."""
    import jax.numpy as jnp

    from cake_tpu.models.llama.model import RopeTables as JRope
    from cake_tpu.parallel.context_parallel import (
        make_sp_forward as j_forward, place_sp_params as j_place,
    )
    from cake_tpu.parallel.sp_pipeline import (
        make_sp_stage_forward as j_stage, place_sp_stage_params as j_splace,
    )
    rope = JRope.create(jc, CTX + TAIL)
    if stage:
        placed = j_splace(mesh, jc, jp, tp=tp)
        pf, dc = j_stage(mesh, jc, CTX, TAIL, tp=tp, params=placed)
    else:
        placed = j_place(mesh, jc, jp, tp=tp)
        pf, dc = j_forward(mesh, jc, CTX, TAIL, tp=tp, params=placed)
    logits, cache = pf(placed, jnp.asarray(tokens), jnp.asarray(plen), rope)
    out = [np.asarray(logits)]
    for step in range(steps):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        logits, cache = dc(placed, tok, jnp.int32(CTX + step),
                           jnp.asarray(plen), cache, rope)
        out.append(np.asarray(logits))
    return out


def _port_rollout(cfg, params, mk, tokens, plen, steps=3):
    mesh = make_sp_mesh(device_type="cpu", **mk)
    if mk.get("stage", 1) > 1:
        placed = place_sp_stage_params(mesh, cfg, params)
        pf, dc = make_sp_stage_forward(mesh, cfg, CTX, TAIL)
    else:
        placed = place_sp_params(mesh, cfg, params)
        pf, dc = make_sp_forward(mesh, cfg, CTX, TAIL)
    rope = RopeTables.create(cfg, CTX + TAIL)
    plen = torch.from_numpy(plen)
    logits, cache = pf(placed, torch.from_numpy(tokens), plen, rope)
    out = [logits.numpy()]
    for step in range(steps):
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        logits, cache = dc(placed, tok, CTX + step, plen, cache, rope)
        out.append(logits.numpy())
    return out, placed


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **LOGIT_TOL)
        assert (g.argmax(-1) == w.argmax(-1)).all()


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny f32 weights, int8 tree and inputs, and JAX's stage x
    sp rollouts over each mesh of STAGE_MESHES (full precision) and
    stage 2 x sp 2 x tp 2 (int8)."""
    import jax
    import jax.numpy as jnp

    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params
    from cake_tpu.ops.quant import quantize_params

    jc = JConfig.tiny()
    jp = init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    jq = quantize_params(jp, bits=8)
    tokens, plen = _inputs()
    ref = {name: _jax_rollout(jc, jp, _jmesh(shape, axes), "tp" in axes,
                              tokens, plen)
           for name, (shape, axes, _) in STAGE_MESHES.items()}
    shape, axes, _ = STAGE_MESHES["stage2_sp2_tp2"]
    ref["int8"] = _jax_rollout(jc, jq, _jmesh(shape, axes), True, tokens,
                               plen)
    return dict(params=params_from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu"),
                int8=params_from_numpy(jax.tree.map(np.asarray, jq),
                                       device="cpu"),
                tokens=tokens, plen=plen, ref=ref)


@pytest.mark.parametrize("name", list(STAGE_MESHES))
def test_sp_stage_matches_jax(tiny, name):
    """Layer ranges over stages, the ring within each stage's sp group
    (heads over tp): JAX's stage x sp logits and greedy tokens, both
    rows (a full and a short prompt)."""
    got, placed = _port_rollout(LlamaConfig.tiny(), tiny["params"],
                                STAGE_MESHES[name][2], tiny["tokens"],
                                tiny["plen"])
    _close(got, tiny["ref"][name])
    wq = placed["blocks"]["wq"]
    assert wq.spec[0] == "stage"
    assert wq.shard(stage=1).shape[0] == 4 // STAGE_MESHES[name][2]["stage"]


def test_sp_stage_int8_quantized_is_jaxs(tiny):
    """JAX's int8 tree over stage 2 x sp 2 x tp 2: its logits, the q and
    scale leaves placed by the pipeline's expanded specs."""
    from cake_tpu_torch.ops.quant import QTensor
    got, placed = _port_rollout(LlamaConfig.tiny(), tiny["int8"],
                                STAGE_MESHES["stage2_sp2_tp2"][2],
                                tiny["tokens"], tiny["plen"])
    _close(got, tiny["ref"]["int8"])
    wo = placed["blocks"]["wo"]
    assert isinstance(wo, QTensor) and wo.q.spec[:2] == ("stage", "tp")
    # int8 against full precision: the round trip's error only
    full = np.asarray(tiny["ref"]["stage2_sp2_tp2"][0])[0]
    assert np.corrcoef(full, got[0][0])[0, 1] > 0.99


def _aligned_cfg(cls):
    """A config whose contract dims split over tp=2 on whole int4
    groups: wo's H * hd = 256 and w_down's intermediate = 256, two groups
    of 128 each."""
    return cls.tiny(hidden_size=256, num_attention_heads=16,
                    num_key_value_heads=4, intermediate_size=256)


@pytest.mark.parametrize("mk", [dict(sp=4, tp=2), dict(stage=2, sp=2, tp=2)])
def test_sp_tp_int4_grouped_aligned_is_jaxs(mk):
    """int4 group-wise weights under sp x tp and stage x sp x tp, for
    group-aligned dims: the contract-sharded wo holds whole groups on
    each tp shard (q and scale both over "tp"), and the prefill and a
    decode step give JAX's logits, the prefill the unsharded int4
    prefill's."""
    import jax
    import jax.numpy as jnp

    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params
    from cake_tpu.ops.quant import quantize_params
    from cake_tpu_torch.ops.quant import QTensor, is_groupwise

    jc = _aligned_cfg(JConfig)
    jq = quantize_params(init_params(jc, jax.random.PRNGKey(0),
                                     dtype=jnp.float32), bits=4)
    tokens, _ = _inputs()
    plen = np.full((2,), CTX, np.int32)
    stage = "stage" in mk
    axes = (("stage",) if stage else ()) + ("sp", "tp")
    shape = tuple(mk[a] for a in axes)
    want = _jax_rollout(jc, jq, _jmesh(shape, axes), True, tokens, plen,
                        stage=stage, steps=1)
    cfg = _aligned_cfg(LlamaConfig)
    params = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    got, placed = _port_rollout(cfg, params, mk, tokens, plen, steps=1)
    _close(got, want)
    wo = placed["blocks"]["wo"]
    assert isinstance(wo, QTensor) and is_groupwise(params["blocks"]["wo"])
    assert wo.q.spec[1] == "tp" and wo.scale.spec[1] == "tp"
    dense, _ = prefill(params, torch.from_numpy(tokens),
                       torch.from_numpy(plen),
                       KVCache.create(cfg, 2, CTX + TAIL,
                                      dtype=torch.float32, device="cpu"),
                       RopeTables.create(cfg, CTX + TAIL), cfg)
    np.testing.assert_allclose(got[0], dense.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("mk", [dict(dp=2, sp=4), dict(dp=2, sp=2, tp=2)])
def test_sp_dp_matches_dense(tiny, mk):
    """dp x sp(x tp): the batch over dp groups, each its own ring; with
    both rows full-length every row's logits equal the unsharded
    prefill's and decode steps'."""
    cfg = LlamaConfig.tiny()
    plen = np.full((2,), CTX, np.int32)
    got, _ = _port_rollout(cfg, tiny["params"], mk, tiny["tokens"], plen)
    rope = RopeTables.create(cfg, CTX + TAIL)
    logits, cache = prefill(tiny["params"], torch.from_numpy(tiny["tokens"]),
                            torch.from_numpy(plen),
                            KVCache.create(cfg, 2, CTX + TAIL,
                                           dtype=torch.float32, device="cpu"),
                            rope, cfg)
    want = [logits.numpy()]
    for step in range(3):
        tok = logits.argmax(-1)[:, None]
        logits, cache = decode_step(tiny["params"], tok, CTX + step, cache,
                                    rope, cfg)
        want.append(logits.numpy())
    _close(got, want)


def _mk_args(**kw):
    base = dict(model="", max_seq_len=64, batch_size=1, sample_len=8,
                temperature=0.0, repeat_penalty=1.0, flash_attention=False,
                cpu=True, dtype="f32")
    base.update(kw)
    return Args(**base).validate()


@pytest.fixture(scope="module")
def topo(tmp_path_factory):
    p = tmp_path_factory.mktemp("topo") / "topology.yml"
    p.write_text(TOPOLOGY_2WAY)
    return str(p)


def _gen(args):
    return Context.from_args(args).load_text_model()


def test_sp_stage_decode_scan_matches_stepwise(topo):
    """generate_on_device (K replays of the generator's captured step,
    the sp decode and the sampling on the device) over stage x sp gives the
    tokens of the stepwise decode called greedily."""
    gen = _gen(_mk_args(sp=2, topology=topo))
    fwd = gen._forward_fn
    ctx_len = fwd.ctx_len
    prompt = np.random.default_rng(5).integers(3, 200, (1, ctx_len)).astype(
        np.int32)
    plen = np.full((1,), ctx_len, np.int32)
    got = gen.generate_on_device(prompt, plen, 5)[0].tolist()
    cache = fwd.new_cache(1, torch.float32)
    pl = torch.from_numpy(plen)
    logits, cache = fwd(gen.params, torch.from_numpy(prompt), cache, 0,
                        gen.rope, last_idx=pl - 1, is_prefill=True)
    want = [int(logits.argmax(-1))]
    for k in range(4):
        logits, cache = fwd(gen.params, torch.tensor([[want[-1]]]), cache,
                            ctx_len + k, gen.rope)
        want.append(int(logits.argmax(-1)))
    assert got == want


def test_context_builds_sp_stage_generator(topo):
    """--sp with a two-stage topology builds the composed generator (the
    blocks' layers over "stage") and, with a full-window prompt,
    generates the unsharded generator's tokens."""
    gen_sp = _gen(_mk_args(sp=2, topology=topo))
    assert gen_sp._forward_fn._mesh.shape["stage"] == 2
    assert gen_sp._forward_fn._prefill.core.n_stage == 2
    assert gen_sp.params["blocks"]["wq"].spec[0] == "stage"
    ctx_len = gen_sp._forward_fn.ctx_len
    prompt = np.full((1, ctx_len), 7, np.int32)
    plen = np.full((1,), ctx_len, np.int32)
    np.testing.assert_array_equal(
        _gen(_mk_args()).generate_on_device(prompt, plen, 6),
        gen_sp.generate_on_device(prompt, plen, 6))


def test_context_sp_stage_streams_weights(topo, tmp_path, monkeypatch):
    """With weights on disk the stage x sp path loads stage-locally
    (streamed shard by shard, never whole) and generates the tokens of
    the unsharded context on the same checkpoint."""
    import cake_tpu_torch.models as tmodels
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.utils.loading import save_safetensors

    cfg = LlamaConfig.tiny()
    p = init_params(cfg, torch.Generator().manual_seed(4), device="cpu",
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
    (tmp_path / "config.json").write_text(
        '{"vocab_size": 256, "hidden_size": 64, "intermediate_size": 128, '
        '"num_hidden_layers": 4, "num_attention_heads": 4, '
        '"num_key_value_heads": 2, "rms_norm_eps": 1e-05, '
        '"rope_theta": 10000.0, "max_position_embeddings": 256, '
        '"bos_token_id": 1, "eos_token_id": 2, '
        '"tie_word_embeddings": false}')

    def whole_load(*a, **kw):
        raise AssertionError("the stage x sp path loaded the whole tree")

    gen_dense = _gen(_mk_args(model=str(tmp_path)))
    monkeypatch.setattr(tmodels, "load_text_params", whole_load)
    gen_sp = _gen(_mk_args(model=str(tmp_path), sp=2, topology=topo))
    wq = gen_sp.params["blocks"]["wq"]
    assert wq.spec[0] == "stage" and wq.shard(stage=1).shape[0] == 2
    ctx_len = gen_sp._forward_fn.ctx_len
    prompt = np.full((1, ctx_len), 7, np.int32)
    plen = np.full((1,), ctx_len, np.int32)
    np.testing.assert_array_equal(gen_dense.generate_on_device(prompt, plen,
                                                               6),
                                  gen_sp.generate_on_device(prompt, plen, 6))


def _jax_error(**kw):
    from cake_tpu.args import Args as JArgs
    from cake_tpu.context import Context as JContext
    base = dict(model="", max_seq_len=64, batch_size=1, sample_len=8,
                temperature=0.0, repeat_penalty=1.0, flash_attention=False)
    base.update(kw)
    with pytest.raises(ValueError) as e:
        JContext.from_args(JArgs(**base).validate()).load_text_model()
    return str(e.value)


def test_context_sp_tp_int4_misaligned_rejected():
    """The tiny config's contract dims are one int4 group each, which tp
    would split: JAX's message, naming the leaf."""
    want = _jax_error(sp=2, tp=2, quant="int4")
    with pytest.raises(ValueError, match="group") as got:
        _gen(_mk_args(sp=2, tp=2, quant="int4"))
    assert str(got.value) == want


def test_context_sp_stage_rejects_dp(topo):
    want = _jax_error(sp=2, dp=2, batch_size=2, topology=topo)
    with pytest.raises(ValueError, match="--dp") as got:
        _gen(_mk_args(sp=2, dp=2, batch_size=2, topology=topo))
    assert str(got.value) == want
