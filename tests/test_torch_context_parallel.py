"""The port's sequence parallelism (cake_tpu_torch/parallel/
context_parallel.py) against the JAX package's on the CPU: the cases of
tests/test_context_parallel.py, the sp generator cases of
tests/test_serving_topology.py and the MoE ring of tests/test_moe.py.

A port mesh on the CPU has the CPU at every position, as JAX's tests
run on 8 virtual CPU devices. Ring attention and the merged decode
attention take the same numpy-seeded inputs on both sides and agree
within 2e-5; the sp forwards (sp, sp x tp, dp x sp, dp x sp x tp, MoE
blocks) carry JAX's random weights across (`params_from_numpy`) and
agree with JAX's sp logits within LOGIT_TOL, their greedy tokens
identical; the generator through Args -> Context gives JAX's sp
generator's stream, the positional gap of a short prompt included, and
the unsharded generator's on a full window; the refusals of JAX's sp
branch raise its error type with its message. A `cuda` case (skipped
without a card) holds the generator's captured sp decode step against
its eager call on a co-located mesh of the card.
"""

import numpy as np
import pytest

import torch

from cake_tpu_torch.args import Args
from cake_tpu_torch.context import Context
from cake_tpu_torch.models.chat import Message
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.model import RopeTables
from cake_tpu_torch.models.llama.params import params_from_numpy
from cake_tpu_torch.parallel.context_parallel import (
    make_sp_forward, place_sp_params, ring_attention, sp_merged_attention,
)
from cake_tpu_torch.parallel.mesh import make_sp_mesh

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CTX, TAIL = 64, 16
# JAX's mesh shape and axes, and the port's make_sp_mesh arguments
MESHES = {
    "sp8": ((8,), ("sp",), dict(sp=8)),
    "sp4_tp2": ((4, 2), ("sp", "tp"), dict(sp=4, tp=2)),
    "dp2_sp4": ((2, 4), ("dp", "sp"), dict(sp=4, dp=2)),
    "dp2_sp2_tp2": ((2, 2, 2), ("dp", "sp", "tp"), dict(sp=2, dp=2, tp=2)),
}


def _jmesh(shape, axes):
    import jax
    from jax.sharding import Mesh
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _rollout(prefill, decode, params, tokens, plen, rope, steps, argmax,
             to_np):
    """Prefill logits and `steps` greedy decode steps' logits."""
    logits, cache = prefill(params, tokens, plen, rope)
    out = [to_np(logits)]
    for step in range(steps):
        tok = argmax(logits)
        logits, cache = decode(params, tok, CTX + step, plen, cache, rope)
        out.append(to_np(logits))
    return out


@pytest.fixture(scope="module")
def forwards():
    """The tiny model's JAX weights and inputs, and JAX's sp rollouts
    (prefill + 3 greedy decode steps) over each mesh of MESHES."""
    import jax
    import jax.numpy as jnp

    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.model import RopeTables as JRope
    from cake_tpu.models.llama.params import init_params
    from cake_tpu.parallel.context_parallel import (
        make_sp_forward as j_forward, place_sp_params as j_place,
    )

    jc = JConfig.tiny()
    jp = init_params(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jc.vocab_size, (2, CTX)).astype(np.int32)
    plen = np.array([CTX, CTX - 11], np.int32)
    rope = JRope.create(jc, CTX + TAIL)
    ref = {}
    for name, (shape, axes, kw) in MESHES.items():
        mesh = _jmesh(shape, axes)
        tp, dp = "tp" in axes, "dp" in axes
        placed = j_place(mesh, jc, jp, tp=tp)
        pf, dc = j_forward(mesh, jc, CTX, TAIL, tp=tp, params=placed, dp=dp)

        def decode(p, tok, pos, pl, cache, r, dc=dc):
            return dc(p, tok, jnp.int32(pos), pl, cache, r)

        ref[name] = _rollout(
            pf, decode, placed, jnp.asarray(tokens), jnp.asarray(plen),
            rope, 3,
            lambda lg: jnp.argmax(lg, -1).astype(jnp.int32)[:, None],
            np.asarray)
    return dict(
        params=params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"),
        tokens=torch.from_numpy(tokens), plen=torch.from_numpy(plen),
        rope=RopeTables.create(LlamaConfig.tiny(), CTX + TAIL), ref=ref)


# -- the attention math -------------------------------------------------------


def _chunks(x, sp):
    return list(torch.chunk(torch.from_numpy(x), sp, dim=1))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(causal):
    """Eight positions' ring over the same chunks as JAX's shard_map
    ring, causal and not; both equal full attention."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cake_tpu.parallel.context_parallel import (
        ring_attention as j_ring,
    )
    from cake_tpu_torch.ops.attention import causal_mask, gqa_attention

    B, S, H, KV, hd = 2, 64, 4, 2, 16
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, S, n, hd)).astype(np.float32)
               for n in (H, KV, KV))
    seq = P(None, "sp", None, None)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda q, k, v: j_ring(q, k, v, "sp", causal=causal),
        mesh=_jmesh((8,), ("sp",)), in_specs=(seq, seq, seq),
        out_specs=seq, check_vma=False))(q, k, v))
    got = torch.cat(ring_attention(_chunks(q, 8), _chunks(k, 8),
                                   _chunks(v, 8), causal=causal), dim=1)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    full = gqa_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                         mask=causal_mask(S) if causal else None)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **ATTN_TOL)


def test_sp_merged_attention_matches_jax():
    """The sharded-context + replicated-tail decode attention (eight
    shards, a short row, three tail tokens written) against JAX's
    pmax/psum merge."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cake_tpu.parallel.context_parallel import (
        sp_merged_attention as j_merged,
    )
    from cake_tpu_torch.parallel.context_parallel import sp_decode_masks

    B, H, KV, hd, ctx, tail, sp = 2, 4, 2, 16, 64, 8, 8
    Sl = ctx // sp
    plen = np.array([64, 50], np.int32)
    t_slot = 3
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, ctx, KV, hd)).astype(np.float32)
              for _ in range(2))
    tk, tv = (rng.standard_normal((B, tail, KV, hd)).astype(np.float32)
              for _ in range(2))

    def body(q, ck, cv, tk, tv):
        idx = jax.lax.axis_index("sp")
        slot_g = idx * Sl + jnp.arange(Sl)
        c_valid = (slot_g[None] < plen[:, None])[:, None, None, None, :]
        t_valid = jnp.broadcast_to(jnp.arange(tail)[None] <= t_slot,
                                   (B, tail))[:, None, None, None, :]
        return j_merged(q, ck, cv, tk, tv, c_valid, t_valid, "sp")

    seq = P(None, "sp", None, None)
    want = np.asarray(jax.jit(jax.shard_map(
        body, mesh=_jmesh((8,), ("sp",)),
        in_specs=(P(), seq, seq, P(), P()), out_specs=P(),
        check_vma=False))(q, ck, cv, tk, tv))
    c_valid, t_valid = sp_decode_masks(Sl, sp, torch.from_numpy(plen),
                                       tail, t_slot, B)
    got = sp_merged_attention(torch.from_numpy(q), _chunks(ck, sp),
                              _chunks(cv, sp), torch.from_numpy(tk),
                              torch.from_numpy(tv), c_valid, t_valid)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


def test_fp8_storage_is_read_upcast():
    """An fp8 shard attends as its values upcast: the stats equal those
    of the same bytes read as f32."""
    from cake_tpu_torch.parallel.context_parallel import (
        partial_attention_stats,
    )
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 1, 4, 16)).astype(
        np.float32))
    k8, v8 = (torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(
        np.float32)).to(torch.float8_e4m3fn) for _ in range(2))
    valid = torch.ones(1, 1, 1, 1, 8, dtype=torch.bool)
    for a, b in zip(partial_attention_stats(q, k8, v8, valid),
                    partial_attention_stats(q, k8.float(), v8.float(),
                                            valid)):
        assert torch.equal(a, b)


# -- the forwards -----------------------------------------------------------


@pytest.mark.parametrize("name", list(MESHES))
def test_sp_forward_matches_jax(forwards, name):
    """Prefill and three greedy decode steps over each sp mesh (a
    full-length and a short row): JAX's sp logits within LOGIT_TOL and
    its greedy tokens; the unsharded port prefill's logits for the
    full row."""
    from cake_tpu_torch.models.llama.cache import KVCache
    from cake_tpu_torch.models.llama.model import prefill

    cfg = LlamaConfig.tiny()
    shape, axes, kw = MESHES[name]
    mesh = make_sp_mesh(device_type="cpu", **kw)
    assert mesh.axis_names == axes and tuple(mesh.devices.shape) == shape
    placed = place_sp_params(mesh, cfg, forwards["params"])
    pf, dc = make_sp_forward(mesh, cfg, CTX, TAIL)
    got = _rollout(pf, dc, placed, forwards["tokens"], forwards["plen"],
                   forwards["rope"], 3,
                   lambda lg: lg.argmax(-1).to(torch.int32)[:, None],
                   lambda lg: lg.numpy())
    for g, w in zip(got, forwards["ref"][name]):
        np.testing.assert_allclose(g, w, **LOGIT_TOL)
        assert (g.argmax(-1) == w.argmax(-1)).all()
    dense, _ = prefill(forwards["params"], forwards["tokens"],
                       forwards["plen"],
                       KVCache.create(cfg, 2, CTX + TAIL,
                                      dtype=torch.float32, device="cpu"),
                       forwards["rope"], cfg)
    np.testing.assert_allclose(got[0][0], dense[0].numpy(), **LOGIT_TOL)


def test_sp_cache_is_placed_over_the_mesh(forwards):
    """The context's sequence dim over sp, the tail replicated over sp
    (one tensor on a co-located mesh), kv heads over tp."""
    cfg = LlamaConfig.tiny()
    mesh = make_sp_mesh(sp=4, tp=2, device_type="cpu")
    pf, _ = make_sp_forward(mesh, cfg, CTX, TAIL)
    _, cache = pf(place_sp_params(mesh, cfg, forwards["params"]),
                  forwards["tokens"], forwards["plen"], forwards["rope"])
    assert cache.ctx_k.spec == (None, None, "sp", "tp", None)
    assert cache.ctx_k.shard(tp=1, sp=3).shape == (4, 2, CTX // 4, 1, 16)
    assert cache.tail_k.shard(tp=1, sp=0) is cache.tail_k.shard(tp=1, sp=3)
    assert cache.tail_k.shape == (4, 2, TAIL, 2, 16)


def test_sp_forward_with_moe_blocks_matches_jax():
    """MoE blocks (a router leaf) through the ring: JAX's sp logits over
    eight positions."""
    import jax
    import jax.numpy as jnp

    from cake_tpu.models.moe import MoEConfig as JMoE
    from cake_tpu.models.moe import init_params as j_init
    from cake_tpu.models.llama.model import RopeTables as JRope
    from cake_tpu.parallel.context_parallel import (
        make_sp_forward as j_forward,
    )
    from cake_tpu_torch.models.moe import MoEConfig

    ctx, tail = 32, 8
    jc = JMoE.tiny()
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tokens = np.random.default_rng(3).integers(
        0, jc.vocab_size, (2, ctx)).astype(np.int32)
    plen = np.full((2,), ctx, np.int32)
    pf, _ = j_forward(_jmesh((8,), ("sp",)), jc, ctx, tail)
    want, _ = pf(jp, jnp.asarray(tokens), jnp.asarray(plen),
                 JRope.create(jc, ctx + tail))

    cfg = MoEConfig.tiny()
    mesh = make_sp_mesh(sp=8, device_type="cpu")
    params = place_sp_params(
        mesh, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                     device="cpu"))
    pf, _ = make_sp_forward(mesh, cfg, ctx, tail)
    got, _ = pf(params, torch.from_numpy(tokens), torch.from_numpy(plen),
                RopeTables.create(cfg, ctx + tail))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


# -- the generator through Args -> Context ------------------------------------


@pytest.fixture(scope="module")
def jax_gen():
    """JAX's tiny random model (its context's PRNGKey(0) init) as numpy,
    and its sp generator's stream for a short prompt (the window gap)."""
    import jax

    from cake_tpu.args import Args as JArgs
    from cake_tpu.context import Context as JContext
    from cake_tpu.models.chat import Message as JMessage

    args = JArgs(model="", max_seq_len=256, batch_size=1, sample_len=8,
                 temperature=0.0, repeat_penalty=1.0, flash_attention=False,
                 sp=4).validate()
    gen = JContext.from_args(args).load_text_model()
    gen.add_message(JMessage.user("hello"))
    stream = [gen.next_token(i).id for i in range(6)]
    return dict(params=jax.tree.map(np.asarray, gen.params), stream=stream,
                ctx_len=gen._forward_fn.ctx_len)


@pytest.fixture
def jax_weights(jax_gen, monkeypatch):
    """The port's contexts load JAX's weights (load_text_params
    replaced: the tiny config, no checkpoint)."""
    import cake_tpu_torch.models as tmodels

    def load(config, model_dir, dtype, device):
        return params_from_numpy(jax_gen["params"], device=device,
                                 dtype=dtype)

    monkeypatch.setattr(tmodels, "load_text_params", load)


def _mk_args(**kw):
    base = dict(model="", max_seq_len=256, batch_size=1, sample_len=8,
                temperature=0.0, repeat_penalty=1.0, flash_attention=False,
                cpu=True, dtype="f32")
    base.update(kw)
    return Args(**base).validate()


def _gen(args, **kw):
    return Context.from_args(args, **kw).load_text_model()


def test_sp_generator_stream_is_jaxs(jax_gen, jax_weights):
    """Args(sp=4) -> Context builds the sp adapter over JAX's window
    split, and a short prompt's greedy stream (generated at positions
    ctx_len + k, after the gap) is JAX's sp generator's."""
    from cake_tpu_torch.parallel.context_parallel import (
        SPGeneratorForward, SPSessionCache,
    )
    gen = _gen(_mk_args(sp=4))
    fwd = gen._forward_fn
    assert isinstance(fwd, SPGeneratorForward) and gen.parallel is None
    assert fwd.ctx_len == jax_gen["ctx_len"] == ((256 - 16) // 4) * 4
    assert fwd.max_decode_tokens == 256 - fwd.ctx_len
    assert isinstance(gen.cache, SPSessionCache)
    gen.add_message(Message.user("hello"))
    assert [gen.next_token(i).id for i in range(6)] == jax_gen["stream"]


@pytest.mark.parametrize("kw", [dict(sp=4), dict(sp=4, tp=2),
                                dict(sp=2, dp=2, batch_size=2)])
def test_sp_serving_matches_dense_full_window(jax_weights, kw):
    """A full context-window prompt: the sp generator's tokens (the
    replays of its captured decode step) equal the
    unsharded generator's, row for row (sp, sp x tp, dp x sp)."""
    gen_sp = _gen(_mk_args(max_seq_len=64, **kw))
    ctx_len = gen_sp._forward_fn.ctx_len
    assert ctx_len % kw["sp"] == 0 and ctx_len < 64
    if kw.get("tp"):
        assert gen_sp.params["blocks"]["wq"].spec[-1] == "tp"
    B = kw.get("batch_size", 1)
    gen_dense = _gen(_mk_args(max_seq_len=64, batch_size=B))
    prompt = np.stack([np.full((ctx_len,), 7 + 4 * b, np.int32)
                       for b in range(B)])
    plen = np.full((B,), ctx_len, np.int32)
    np.testing.assert_array_equal(
        gen_dense.generate_on_device(prompt, plen, 6),
        gen_sp.generate_on_device(prompt, plen, 6))


def test_sp_serving_interactive_session_and_reset():
    """next_token / reset over the sp forward: a short prompt generates,
    and after reset the same session generates the same tokens."""
    gen = _gen(_mk_args(sp=4))
    gen.add_message(Message.user("hello"))
    toks = [gen.next_token(i).id for i in range(5)]
    gen.reset()
    assert int(gen.cache.plen.abs().sum()) == 0
    gen.add_message(Message.user("hello"))
    assert [gen.next_token(i).id for i in range(5)] == toks


def test_sp_rejects_overlong_prompt():
    gen = _gen(_mk_args(sp=4, max_seq_len=64, sample_len=4))
    limit = gen._forward_fn.max_prompt_len
    gen.add_message(Message.user("x" * (limit + 50)))
    with pytest.raises(ValueError, match=f"exceeds limit {limit}"):
        gen.next_token(0)
    prompt = np.full((1, limit + 1), 3, np.int32)
    with pytest.raises(ValueError, match="exceeds this serving mode's "
                                         f"prompt limit {limit}"):
        gen.generate_on_device(prompt, np.array([limit + 1], np.int32), 2)


def test_sp_scratch_generation_does_not_clobber_session():
    """generate_on_device runs on a scratch copy of the session cache,
    its own plen inside it: the live session goes on as if it had not
    run."""
    gen = _gen(_mk_args(sp=4))
    gen.add_message(Message.user("hello"))
    first = [gen.next_token(i).id for i in range(2)]
    ctx_len = gen._forward_fn.ctx_len
    gen.generate_on_device(np.full((1, ctx_len), 9, np.int32),
                           np.full((1,), ctx_len, np.int32), 3)
    rest = [gen.next_token(i).id for i in range(2, 5)]
    gen2 = _gen(_mk_args(sp=4))
    gen2.add_message(Message.user("hello"))
    assert first + rest == [gen2.next_token(i).id for i in range(5)]


def test_sp_decode_budget_enforced():
    gen = _gen(_mk_args(sp=4, sample_len=4))
    fwd = gen._forward_fn
    tail = fwd.max_decode_tokens
    prompt = np.full((1, fwd.ctx_len), 3, np.int32)
    plen = np.full((1,), fwd.ctx_len, np.int32)
    with pytest.raises(ValueError, match="decode budget"):
        gen.generate_on_device(prompt, plen, tail + 1)
    gen.add_message(Message.user("hi"))
    for i in range(tail):
        gen.next_token(i)
    with pytest.raises(ValueError, match="decode budget exhausted"):
        gen.next_token(tail)


def test_sp_honors_kv_dtype():
    """--kv-dtype f8_e4m3: the sp cache (context and tail) stores fp8,
    half of bf16's bytes, and generates."""
    gen = _gen(_mk_args(sp=4, kv_dtype="f8_e4m3"))
    gen.add_message(Message.user("hello"))
    assert len([gen.next_token(i).id for i in range(3)]) == 3
    cache = gen.cache.sp
    assert cache.ctx_k.dtype == cache.tail_k.dtype == torch.float8_e4m3fn
    bf16 = _gen(_mk_args(sp=4, kv_dtype="bf16")).cache.sp
    assert cache.memory_bytes() * 2 == bf16.memory_bytes()


def _jax_error(**kw):
    from cake_tpu.args import Args as JArgs
    from cake_tpu.context import Context as JContext
    base = dict(model="", max_seq_len=256, batch_size=1, sample_len=8,
                temperature=0.0, repeat_penalty=1.0, flash_attention=False)
    base.update(kw)
    with pytest.raises(Exception) as e:
        JContext.from_args(JArgs(**base).validate()).load_text_model()
    return e.value


@pytest.mark.parametrize("kw", [
    dict(sp=2, dp=2, batch_size=2, topology="TOPO"),
    dict(sp=2, dp=2, batch_size=3),
    dict(sp=2, tp=2, quant="int4"),
    dict(sp=2, tp=4),
    dict(sp=2, max_seq_len=16, sample_len=16),
    dict(sp=2, draft_model=""),
])
def test_sp_refusals_are_jaxs(tmp_path, kw):
    """Each refusal of JAX's sp branch raises its error type with its
    message (the dp-and-stages, batch-over-dp, int4-group, tp-over-KV
    and empty-window ones; a draft model does not compose)."""
    if kw.get("topology") == "TOPO":
        topo = tmp_path / "topology.yml"
        topo.write_text("a:\n  layers:\n    - model.layers.0-1\n"
                        "b:\n  layers:\n    - model.layers.2-3\n")
        kw = dict(kw, topology=str(topo))
    want = _jax_error(**kw)
    with pytest.raises(type(want)) as got:
        _gen(_mk_args(**kw))
    assert str(got.value) == str(want)


def test_sp_refusals_without_a_jax_counterpart_here():
    """The sliding-window refusal (JAX's words), too few devices for the
    mesh (JAX's message; the CPU mesh is bounded by mesh_devices here,
    as JAX's by its eight devices) and stages that do not divide the
    layers."""
    from cake_tpu_torch.parallel.context_parallel import SPForward
    args = _mk_args(sp=4)
    ctx = Context.from_args(args)
    ctx.llama_config = LlamaConfig.tiny(sliding_window=32)
    with pytest.raises(ValueError, match="does not implement sliding-window "
                                         "attention"):
        ctx.load_text_model()
    with pytest.raises(ValueError, match=r"stages 1 x --dp 1 x --sp 4 x "
                                         r"--tp 2 needs 8 devices, have 4"):
        _gen(_mk_args(sp=4, tp=2), mesh_devices=["cpu"] * 4)
    mesh = make_sp_mesh(sp=2, stage=3, device_type="cpu")
    with pytest.raises(ValueError, match="topology stages 3 must divide "
                                         "layer count 4"):
        SPForward(mesh, LlamaConfig.tiny(), CTX, TAIL)
    with pytest.raises(ValueError, match="must divide over sp=3"):
        SPForward(make_sp_mesh(sp=3, device_type="cpu"), LlamaConfig.tiny(),
                  CTX, TAIL)


@pytest.mark.parametrize("kw", [
    dict(sp=4), dict(sp=2, tp=2), dict(sp=2, dp=2, batch_size=2),
    dict(sp=2, topology="TOPO"), dict(sp=2, tp=2, topology="TOPO"),
])
def test_sp_meshes_are_jaxs(tmp_path, kw):
    """Context builds JAX's sp mesh for each composition: the same axis
    names in the same order and the same shape, and the same window
    split."""
    from cake_tpu.args import Args as JArgs
    from cake_tpu.context import Context as JContext
    if kw.get("topology") == "TOPO":
        topo = tmp_path / "topology.yml"
        topo.write_text("a:\n  layers:\n    - model.layers.0-1\n"
                        "b:\n  layers:\n    - model.layers.2-3\n")
        kw = dict(kw, topology=str(topo))
    base = dict(model="", max_seq_len=256, batch_size=1, sample_len=8,
                temperature=0.0, repeat_penalty=1.0, flash_attention=False)
    want = JContext.from_args(JArgs(**{**base, **kw}).validate()
                              ).load_text_model()._forward_fn
    got = _gen(_mk_args(**kw))._forward_fn
    assert got._mesh.axis_names == tuple(want._mesh.axis_names)
    assert tuple(got._mesh.devices.shape) == tuple(want._mesh.devices.shape)
    assert (got.ctx_len, got.tail_len) == (want.ctx_len, want.tail_len)


def test_mesh_coordinates_are_named():
    """A position is addressed by named coordinates: on a pipeline mesh
    the (dp, stage, tp) index, on an sp mesh its own axes; a nonzero
    coordinate of an axis the mesh lacks raises."""
    from cake_tpu_torch.parallel.mesh import make_mesh
    pipe = make_mesh(2, 2, 2, device_type="cpu")
    assert pipe.index(dp=1, stage=0, tp=1) == (1, 0, 1)
    sp = make_sp_mesh(sp=4, tp=2, device_type="cpu")
    assert sp.index(sp=3, tp=1) == (3, 1) and sp.size_of("dp") == 1
    with pytest.raises(ValueError, match="has no 'stage' axis"):
        sp.index(stage=1)
    with pytest.raises(ValueError, match="an sp mesh takes dp or stages"):
        make_sp_mesh(sp=2, dp=2, stage=2, device_type="cpu")


def test_cli_sp_generates_on_the_cpu(capsys):
    """`--cpu --sp 2` through the CLI: one-shot generation through the sp
    adapter."""
    from cake_tpu_torch import cli
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.parallel.context_parallel import SPGeneratorForward
    argv = ["--cpu", "--sp", "2", "--max-seq-len", "512", "--sample-len",
            "4", "--prompt", "hi", "--temperature", "0"]
    assert cli.main(argv) == 0
    assert capsys.readouterr().out.startswith(
        "[You are a helpful AI assistant.] hi\n")
    from cake_tpu_torch.args import parse_args
    gen = Master.from_args(parse_args(argv)).llm
    assert isinstance(gen._forward_fn, SPGeneratorForward)


@pytest.mark.cuda
def test_cuda_sp_generator_step_replays_its_eager_call():
    """The generator's captured sp decode step over sp 2 x tp 2 on four
    positions of the card: generate_on_device's replays give the tokens
    of the same steps run eagerly (the decode called directly, greedy),
    and the session's next_token replays match too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the captured sp decode runs on "
                    "CUDA")
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.parallel.context_parallel import SPGeneratorForward
    dev = torch.device("cuda", 0)
    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev, dtype=torch.float32)
    mesh = make_sp_mesh(sp=2, tp=2, devices=[dev] * 4)
    placed = place_sp_params(mesh, cfg, params)
    fwd = SPGeneratorForward(mesh, cfg, CTX, TAIL, kv_dtype=torch.float32)
    gen = LlamaGenerator(cfg, placed, ByteTokenizer(cfg.vocab_size),
                         max_seq_len=CTX + TAIL, device=dev,
                         sampling=SamplingConfig(temperature=0.0,
                                                 repeat_penalty=1.0),
                         forward_fn=fwd, cache_dtype=torch.float32)
    prompt = np.random.default_rng(0).integers(3, 200, (1, CTX)).astype(
        np.int32)
    plen = np.full((1,), CTX, np.int32)
    got = gen.generate_on_device(prompt, plen, 8)[0].tolist()
    assert gen._scan.captures == 1
    rope = RopeTables.create(cfg, CTX + TAIL, device=dev)
    cache = fwd.new_cache(1, torch.float32)
    toks = torch.from_numpy(prompt).to(dev)
    pl = torch.from_numpy(plen).to(dev)
    logits, cache = fwd(placed, toks, cache, 0, rope, last_idx=pl - 1,
                        is_prefill=True)
    want = [int(logits.argmax(-1))]
    for k in range(7):
        logits, cache = fwd(placed, torch.tensor([[want[-1]]], device=dev),
                            cache, CTX + k, rope)
        want.append(int(logits.argmax(-1)))
    assert got == want
