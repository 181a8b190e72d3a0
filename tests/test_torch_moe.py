"""The port's mixture-of-experts family (Mixtral) against the JAX package.

Single-device cases of tests/test_moe.py, held against JAX on the CPU at
f32 with numpy-seeded inputs:

  * `route_top_k` picks JAX's experts with JAX's weights (1e-6), on
    random logits and on exact ties (the lower index first, as
    `lax.top_k`); `moe_mlp` equals JAX's and a per-token numpy loop
    (2e-4);
  * prefill and decode logits equal JAX's (1e-4); the generator's greedy
    stream is JAX's generator's;
  * a `model_type: "mixtral"` config loads as MoEConfig, and an HF
    Mixtral `block_sparse_moe` checkpoint loads into JAX's tree;
  * greedy streams are token-identical to JAX's generator through the
    paged engine (`--mixed-batch` auto and off, `--decode-scan` 1 and
    4), the dense engine, the ring engine (a window shorter than
    max_seq_len), the paged spec engine and the dense spec engine;
  * int8 expert trees are bytes-equal to JAX's `quantize_params` under
    jit, and int4 on MoE raises JAX's error;
  * the step cost's FLOPs sit within 5% above XLA's cost analysis of
    JAX's MoE prefill and decode.

The `cuda` cases (the card's engines against the CPU engines; a wave
under `torch.cuda.set_sync_debug_mode("error")`) skip without a card:

    python -m pytest --noconftest -m cuda tests/test_torch_moe.py
"""

import dataclasses
import json

import numpy as np
import pytest

import torch

from cake_tpu_torch.models.llama.generator import ByteTokenizer
from cake_tpu_torch.models.moe import MoEConfig
from cake_tpu_torch.ops.sampling import SamplingConfig

T = 64
W = 16
GEN = 10
PROMPTS = ([(5 * j) % 40 + 3 for j in range(20)],
           [(7 * j) % 60 + 3 for j in range(20)],
           [(11 * j) % 90 + 3 for j in range(20)])
GREEDY = dict(temperature=0.0, repeat_penalty=1.0)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _jax():
    import jax
    import jax.numpy as jnp
    return jax, jnp


@pytest.fixture(scope="module")
def models():
    """(JAX config, JAX params, port config, port params) of the tiny MoE
    (2 layers, 4 experts, top 2) at f32."""
    jax, jnp = _jax()
    from cake_tpu.models.moe import MoEConfig as JMoE
    from cake_tpu.models.moe import init_params as j_init
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jc = JMoE.tiny()
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, MoEConfig.tiny(), tp


def _jax_streams(jc, jp, prompts, n):
    """JAX's generator, greedy, over equal-length prompts at once."""
    jax, jnp = _jax()
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.models.llama.generator import LlamaGenerator as JGen
    from cake_tpu.ops.sampling import SamplingConfig as JSampling

    gen = JGen(jc, jp, JTok(jc.vocab_size), max_seq_len=T,
               batch_size=len(prompts), sampling=JSampling(**GREEDY),
               cache_dtype=jnp.float32)
    ids = np.asarray(prompts, np.int32)
    out = gen.generate_on_device(
        ids, np.full(len(prompts), ids.shape[1], np.int32), n)
    return [row.tolist() for row in np.asarray(out)]


@pytest.fixture(scope="module")
def want(models):
    jc, jp, _, _ = models
    return _jax_streams(jc, jp, PROMPTS, GEN)


@pytest.fixture(scope="module")
def want_ring(models):
    jc, jp, _, _ = models
    return _jax_streams(dataclasses.replace(jc, sliding_window=W), jp,
                        PROMPTS, GEN)


def _upto_eos(stream, eos):
    """The stream up to and including its first EOS (the engine retires
    there; the generator runs on)."""
    for i, t in enumerate(stream):
        if t in eos:
            return stream[:i + 1]
    return stream


def _engine(cfg, params, device="cpu", **kw):
    from cake_tpu_torch.serve.engine import InferenceEngine
    kw.setdefault("max_slots", 3)
    return InferenceEngine(cfg, params, ByteTokenizer(cfg.vocab_size),
                           device=device, max_seq_len=T,
                           sampling=SamplingConfig(**GREEDY),
                           cache_dtype=torch.float32, **kw)


def _streams(eng, prompts=PROMPTS, n=GEN):
    with eng:
        hs = [eng.submit(p, max_new_tokens=n, **GREEDY) for p in prompts]
        assert all(h.wait(timeout=300) for h in hs)
    return [list(h._req.out_tokens) for h in hs]


def _same(got, want, eos):
    for g, w in zip(got, want):
        w = _upto_eos(w, eos)
        assert g == w, (g, w)


# -- routing and the expert FFN ------------------------------------------------


def test_route_top_k_matches_jax():
    jax, jnp = _jax()
    from cake_tpu.ops.moe import route_top_k as j_route
    from cake_tpu_torch.ops.moe import route_top_k

    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 8)).astype(np.float32)
    w = rng.normal(size=(8, 6)).astype(np.float32)
    want = np.asarray(j_route(jnp.asarray(x), jnp.asarray(w), k=2))
    got = route_top_k(torch.from_numpy(x), torch.from_numpy(w), 2).numpy()
    assert ((got != 0) == (want != 0)).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_top_k_breaks_exact_ties_as_jax(k):
    """Router columns made equal so every logit of a token ties with
    others: JAX's `lax.top_k` takes the lower index first, and so does
    the port (a stable descending sort)."""
    jax, jnp = _jax()
    from cake_tpu.ops.moe import route_top_k as j_route
    from cake_tpu_torch.ops.moe import route_top_k

    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 8)).astype(np.float32)
    col = rng.normal(size=(8, 1)).astype(np.float32)
    other = rng.normal(size=(8, 1)).astype(np.float32)
    # experts 1, 2, 4 and 5 tie exactly; 0 and 3 tie with each other
    w = np.concatenate([other, col, col, other, col, col], axis=1)
    want = np.asarray(j_route(jnp.asarray(x), jnp.asarray(w), k=k))
    got = route_top_k(torch.from_numpy(x), torch.from_numpy(w), k).numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # zero tokens: every logit equal, the first k experts win
    zero = route_top_k(torch.zeros(2, 8), torch.from_numpy(w), k).numpy()
    assert (np.flatnonzero(zero[0]) == np.arange(k)).all()


def test_moe_mlp_matches_jax_and_a_per_token_loop(models):
    jax, jnp = _jax()
    from cake_tpu.ops.moe import moe_mlp as j_moe
    from cake_tpu_torch.models.llama.model import layer_params
    from cake_tpu_torch.ops.moe import moe_mlp

    jc, jp, tc, tp = models
    jlp = jax.tree.map(lambda a: a[0], jp["blocks"])
    lp = layer_params(tp["blocks"], 0)
    rng = np.random.default_rng(1)
    h = rng.normal(size=(2, 3, tc.hidden_size)).astype(np.float32)
    want = np.asarray(j_moe(jlp, jnp.asarray(h), jc.num_experts_per_tok))
    got = moe_mlp(lp, torch.from_numpy(h), tc.num_experts_per_tok).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    router = lp["router"].numpy()
    wg, wu, wd = (lp[k].numpy() for k in ("we_gate", "we_up", "we_down"))
    x = h.reshape(-1, tc.hidden_size)
    expect = np.zeros_like(x)
    for n, tok in enumerate(x):
        logits = tok @ router
        top = np.argsort(logits)[-tc.num_experts_per_tok:]
        wt = np.exp(logits[top] - logits[top].max())
        wt /= wt.sum()
        for wi, e in zip(wt, top):
            g = tok @ wg[e]
            expect[n] += wi * ((g / (1 + np.exp(-g)) * (tok @ wu[e])) @ wd[e])
    np.testing.assert_allclose(got.reshape(-1, tc.hidden_size), expect,
                               rtol=2e-4, atol=2e-4)


def test_bf16_combine_is_cast_to_the_experts_dtype(models):
    """JAX casts the f32 combine to the experts' output dtype before the
    sum: at bf16 the routing weights round. So does the port."""
    from cake_tpu_torch.models.llama.model import layer_params
    from cake_tpu_torch.ops.moe import moe_mlp, route_top_k

    _, _, tc, tp = models
    lp = {k: v.to(torch.bfloat16)
          for k, v in layer_params(tp["blocks"], 0).items()}
    h = torch.randn(1, 4, tc.hidden_size,
                    generator=torch.Generator().manual_seed(3)).bfloat16()
    x = h.reshape(-1, tc.hidden_size)
    combine = route_top_k(x, lp["router"], 2).to(torch.bfloat16)
    g = torch.einsum("nd,edf->nef", x, lp["we_gate"])
    u = torch.einsum("nd,edf->nef", x, lp["we_up"])
    per = torch.einsum("nef,efd->ned", torch.nn.functional.silu(g) * u,
                       lp["we_down"])
    want = torch.einsum("ned,ne->nd", per, combine).reshape(h.shape)
    assert torch.equal(moe_mlp(lp, h, 2), want)


# -- the model ------------------------------------------------------------------


def test_prefill_and_decode_match_jax(models):
    jax, jnp = _jax()
    from cake_tpu.models.llama import model as jm
    from cake_tpu.models.llama.cache import KVCache as JCache
    from cake_tpu_torch.models.llama import model as tm
    from cake_tpu_torch.models.llama.cache import KVCache

    jc, jp, tc, tp = models
    toks = np.asarray([PROMPTS[0][:8]], np.int32)
    jcache = JCache.create(jc, 1, 32, dtype=jnp.float32)
    jrope = jm.RopeTables.create(jc, 32)
    jl, jcache = jm.prefill(jp, jnp.asarray(toks), jnp.array([8]), jcache,
                            jrope, jc)
    jl2, _ = jm.decode_step(jp, jnp.ones((1, 1), jnp.int32), jnp.int32(8),
                            jcache, jrope, jc)
    cache = KVCache.create(tc, 1, 32, dtype=torch.float32, device="cpu")
    rope = tm.RopeTables.create(tc, 32)
    tl, cache = tm.prefill(tp, torch.from_numpy(toks), torch.tensor([8]),
                           cache, rope, tc)
    tl2, _ = tm.decode_step(tp, torch.ones((1, 1), dtype=torch.int32), 8,
                            cache, rope, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-4,
                               rtol=0)


def test_generator_stream_is_jaxs(models, want):
    from cake_tpu_torch.models.llama.generator import LlamaGenerator

    _, _, tc, tp = models
    gen = LlamaGenerator(tc, tp, ByteTokenizer(tc.vocab_size),
                         max_seq_len=T, batch_size=len(PROMPTS),
                         sampling=SamplingConfig(**GREEDY),
                         cache_dtype=torch.float32, device="cpu")
    ids = np.asarray(PROMPTS, np.int32)
    got = gen.generate_on_device(ids, np.full(3, ids.shape[1]), GEN)
    assert [r.tolist() for r in np.asarray(got)] == want


def test_mixtral_config_and_text_params_dispatch(tmp_path):
    from cake_tpu.models.llama.config import load_config_dict as j_load
    from cake_tpu_torch.models import load_text_params
    from cake_tpu_torch.models.llama.config import (
        LlamaConfig, load_config_dict,
    )

    raw = dict(model_type="mixtral", vocab_size=256, hidden_size=64,
               intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               num_local_experts=4, num_experts_per_tok=2,
               eos_token_id=2, bos_token_id=1)
    cfg = load_config_dict(raw)
    assert isinstance(cfg, MoEConfig) and cfg.is_moe
    assert dataclasses.asdict(cfg) == {
        k: v for k, v in dataclasses.asdict(j_load(raw)).items()
        if k in dataclasses.asdict(cfg)}
    assert cfg.chat_template == "mistral"
    assert not LlamaConfig.tiny().is_moe
    (tmp_path / "config.json").write_text(json.dumps(raw))
    assert isinstance(LlamaConfig.from_path(str(tmp_path)), MoEConfig)
    p = load_text_params(cfg, None, torch.float32, "cpu")
    assert tuple(p["blocks"]["we_gate"].shape) == (2, 4, 64, 128)
    assert tuple(p["blocks"]["router"].shape) == (2, 64, 4)


def test_hf_mixtral_layout_loads_jaxs_tree(tmp_path):
    jax, jnp = _jax()
    from cake_tpu.models.moe import MoEConfig as JMoE
    from cake_tpu.models.moe.params import load_params_from_hf as j_load
    from cake_tpu_torch.models.moe.params import load_params_from_hf
    from cake_tpu_torch.utils.loading import save_safetensors

    jc = JMoE.tiny(num_hidden_layers=2, num_local_experts=3)
    c = MoEConfig.tiny(num_hidden_layers=2, num_local_experts=3)
    rng = np.random.default_rng(3)
    D, F, E = c.hidden_size, c.intermediate_size, c.num_local_experts
    hd, H, KV = c.head_dim, c.num_attention_heads, c.num_key_value_heads
    tensors = {
        "model.embed_tokens.weight": rng.normal(size=(c.vocab_size, D)),
        "model.norm.weight": rng.normal(size=(D,)),
        "lm_head.weight": rng.normal(size=(c.vocab_size, D)),
    }
    for i in range(2):
        pre = f"model.layers.{i}"
        tensors.update({
            f"{pre}.input_layernorm.weight": rng.normal(size=(D,)),
            f"{pre}.post_attention_layernorm.weight": rng.normal(size=(D,)),
            f"{pre}.self_attn.q_proj.weight": rng.normal(size=(H * hd, D)),
            f"{pre}.self_attn.k_proj.weight": rng.normal(size=(KV * hd, D)),
            f"{pre}.self_attn.v_proj.weight": rng.normal(size=(KV * hd, D)),
            f"{pre}.self_attn.o_proj.weight": rng.normal(size=(D, H * hd)),
            f"{pre}.block_sparse_moe.gate.weight": rng.normal(size=(E, D)),
        })
        for e in range(E):
            base = f"{pre}.block_sparse_moe.experts.{e}"
            tensors[f"{base}.w1.weight"] = rng.normal(size=(F, D))
            tensors[f"{base}.w2.weight"] = rng.normal(size=(D, F))
            tensors[f"{base}.w3.weight"] = rng.normal(size=(F, D))
    tensors = {k: v.astype(np.float32) for k, v in tensors.items()}
    save_safetensors(str(tmp_path / "model.safetensors"), tensors)

    want = j_load(str(tmp_path), jc, dtype=jnp.float32)
    got = load_params_from_hf(str(tmp_path), c, dtype=torch.float32,
                              device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == sum(1 for _ in _leaves(got))
    for path, leaf in flat_w:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    np.testing.assert_array_equal(
        got["blocks"]["we_down"][1, 2].numpy(),
        tensors["model.layers.1.block_sparse_moe.experts.2.w2.weight"].T)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# -- the engines ----------------------------------------------------------------


@pytest.mark.parametrize("mixed,scan", [("auto", 1), ("auto", 4),
                                        ("off", 1), ("off", 4)])
def test_paged_engine_streams_are_jaxs(models, want, mixed, scan):
    _, _, tc, tp = models
    got = _streams(_engine(tc, tp, kv_pages=24, kv_page_size=16,
                           prefill_chunk=8, mixed_batch=mixed,
                           decode_scan_steps=scan))
    _same(got, want, tc.eos_token_ids)


@pytest.mark.parametrize("chunk", [None, 8])
def test_dense_engine_streams_are_jaxs(models, want, chunk):
    _, _, tc, tp = models
    got = _streams(_engine(tc, tp, prefill_chunk=chunk))
    _same(got, want, tc.eos_token_ids)


def test_ring_engine_streams_are_jaxs(models, want_ring):
    _, _, tc, tp = models
    rc = dataclasses.replace(tc, sliding_window=W)
    eng = _engine(rc, tp)
    assert eng.ring
    _same(_streams(eng), want_ring, tc.eos_token_ids)


def test_spec_engines_streams_are_jaxs(models, want):
    """Self-drafted greedy speculation gives the target's greedy stream,
    through paged spec rows and through the dense spec engine."""
    _, _, tc, tp = models
    paged = _streams(_engine(tc, tp, kv_pages=24, kv_page_size=16,
                             prefill_chunk=8, spec_draft_params=tp,
                             spec_draft_config=tc, spec_gamma=3))
    _same(paged, want, tc.eos_token_ids)
    dense = _streams(_engine(tc, tp, draft_params=tp, draft_config=tc,
                             spec_gamma=3))
    _same(dense, want, tc.eos_token_ids)


def test_engine_matches_the_generator(models):
    """tests/test_moe.py's engine-against-generator case, in the port."""
    from cake_tpu_torch.models.llama.generator import LlamaGenerator

    _, _, tc, tp = models
    prompt = [5, 9, 4, 7]
    got = _streams(_engine(tc, tp, kv_pages=24, kv_page_size=16),
                   [prompt], 6)[0]
    gen = LlamaGenerator(tc, tp, ByteTokenizer(tc.vocab_size),
                         max_seq_len=T, sampling=SamplingConfig(**GREEDY),
                         cache_dtype=torch.float32, device="cpu")
    ref = gen.generate_on_device(np.asarray([prompt], np.int32),
                                 np.asarray([4]), 6)[0].tolist()
    assert got == _upto_eos(ref, tc.eos_token_ids)


# -- quantization and cost ------------------------------------------------------


def test_int8_expert_tree_is_jaxs_and_int4_is_refused(models):
    jax, jnp = _jax()
    from functools import partial

    from cake_tpu.ops import quant as jq
    from cake_tpu_torch.context import Context
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.models.moe.params import init_params_quantized
    from cake_tpu_torch.ops import quant as tq

    jc, jp, tc, tp = models
    want = jax.jit(partial(jq.quantize_params, bits=8))(jp)
    got = tq.quantize_params(tp, bits=8)
    for k in ("we_gate", "we_up", "we_down", "wq", "wo"):
        w, g = want["blocks"][k], got["blocks"][k]
        assert g.q.dtype == torch.int8
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
    assert torch.equal(got["blocks"]["router"], tp["blocks"]["router"])
    direct = init_params_quantized(tc, torch.Generator().manual_seed(0),
                                   device="cpu", dtype=torch.float32)
    for k, v in got["blocks"].items():
        d = direct["blocks"][k]
        if isinstance(v, tq.QTensor):
            assert d.q.shape == v.q.shape and d.scale.shape == v.scale.shape
        else:
            assert d.shape == v.shape
    with pytest.raises(NotImplementedError, match="int4"):
        jq.quantize_params(jp, bits=4)
    with pytest.raises(NotImplementedError, match="int4"):
        tq.quantize_params(tp, bits=4)
    ctx = Context(args=Args(quant="int4"), dtype=torch.float32,
                  device=torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="--quant int8"):
        ctx._maybe_quantize(dict(tp, blocks=dict(tp["blocks"])))


def test_int8_expert_streams_are_jaxs_engine(models):
    """The paged engine over the int8 tree quantized by the JAX package:
    JAX's paged engine's greedy streams."""
    jax, jnp = _jax()
    from functools import partial

    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.ops import quant as jq
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.serve.engine import InferenceEngine as JEngine
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jc, jp, tc, _ = models
    q8 = jax.jit(partial(jq.quantize_params, bits=8))(jp)
    kw = dict(max_slots=3, max_seq_len=T, kv_pages=24, kv_page_size=16,
              prefill_chunk=8, mixed_batch="on")
    jeng = JEngine(jc, q8, JTok(jc.vocab_size), sampling=JSampling(**GREEDY),
                   cache_dtype=jnp.float32, paged_attn="fold", **kw)
    ref = _streams(jeng)
    tq8 = params_from_numpy(jax.tree.map(np.asarray, q8), device="cpu")
    got = _streams(_engine(tc, tq8, **{k: v for k, v in kw.items()
                                       if k != "max_seq_len"}))
    assert got == ref


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_step_cost_flops_near_xla_cost_analysis(kind):
    jax, jnp = _jax()
    from cake_tpu.models.llama import model as jm
    from cake_tpu.models.llama.cache import KVCache
    from cake_tpu.models.moe import MoEConfig as JMoE
    from cake_tpu.models.moe import init_params as j_init
    from cake_tpu.obs.steps import lower_cost
    from cake_tpu_torch.obs import steps as tsteps

    wide = dict(num_hidden_layers=1, hidden_size=256, intermediate_size=512,
                num_attention_heads=4, num_key_value_heads=2,
                num_local_experts=4)
    jc, tc = JMoE.tiny(**wide), MoEConfig.tiny(**wide)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    rope = jm.RopeTables.create(jc, T)
    cache = KVCache.create(jc, 1, T, dtype=jnp.float32)
    if kind == "decode":
        xla = lower_cost(jm.decode_step, (jp, jnp.ones((1, 1), jnp.int32),
                                          jnp.int32(T - 1), cache, rope, jc))
        runs = [(T - 1, 1)]
    else:
        xla = lower_cost(jm.prefill, (jp, jnp.ones((1, T), jnp.int32),
                                      jnp.asarray([T]), cache, rope, jc))
        runs = [(0, T)]
    mine = tsteps.step_cost(tc, kind, 1, 1, runs, emit_rows=1)
    assert 0 <= xla.flops / mine.flops - 1 <= 0.05
    dense = tsteps.matmul_weights_per_token(
        dataclasses.replace(tc, num_local_experts=0))
    E, D, F = 4, 256, 512
    assert tsteps.matmul_weights_per_token(tc) - dense == \
        (E - 1) * 3 * D * F + D * E


# -- the card -------------------------------------------------------------------


def _card_models():
    """The tiny MoE with the port's own init (no jax on the card), f32:
    (config, params on the CPU, params on the card)."""
    from cake_tpu_torch.models.moe.params import init_params
    tc = MoEConfig.tiny()
    tp = init_params(tc, torch.Generator().manual_seed(0), device="cpu",
                     dtype=torch.float32)
    dev = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict)
               else v.cuda()) for k, v in tp.items()}
    return tc, tp, dev


def _captures(eng) -> list:
    """Every graph capture of the engine from here on, by its JAX
    function's name."""
    seen = []
    real = eng.flight.count_capture

    def count(fn, seconds):
        seen.append(fn)
        real(fn, seconds)
    eng.flight.count_capture = count
    return seen


def _card_flavor(flavor, cfg, p, device):
    kw = {}
    if flavor.startswith("paged"):
        _, mixed, scan = flavor.split("-")
        kw = dict(kv_pages=24, kv_page_size=16, prefill_chunk=8,
                  mixed_batch=mixed, decode_scan_steps=int(scan))
    elif flavor == "ring":
        cfg = dataclasses.replace(cfg, sliding_window=W)
    elif flavor == "spec-paged":
        kw = dict(kv_pages=24, kv_page_size=16, prefill_chunk=8,
                  spec_gamma=3, spec_draft_params=p, spec_draft_config=cfg)
    elif flavor == "spec-dense":
        kw = dict(spec_gamma=3, draft_params=p, draft_config=cfg)
    return _engine(cfg, p, device=device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("flavor", ["paged-auto-1", "paged-off-4", "dense",
                                    "ring", "spec-paged", "spec-dense"])
def test_cuda_card_engines_match_the_cpu_engines(flavor):
    """Each flavor on the card against the same flavor on the CPU, f32,
    over two waves: the second captures nothing."""
    _cuda_or_skip()
    tc, tp, dp = _card_models()
    want = _streams(_card_flavor(flavor, tc, tp, "cpu"))
    eng = _card_flavor(flavor, tc, dp, "cuda")
    caps = _captures(eng)
    with eng:
        for wave in range(2):
            n0 = len(caps)
            hs = [eng.submit(p, max_new_tokens=GEN, **GREEDY)
                  for p in PROMPTS]
            assert all(h.wait(timeout=600) for h in hs)
            assert all(h._req.error is None for h in hs)
            assert [list(h._req.out_tokens) for h in hs] == want
    assert n0 > 0 and len(caps) == n0


@pytest.mark.cuda
def test_cuda_moe_wave_never_waits_for_the_stream():
    """A paged MoE wave whose mixed dispatches run under
    `torch.cuda.set_sync_debug_mode("error")` (the fetches are outside
    them): the expert FFN, its routing sort and scatter included, never
    waits for the stream; every graph was captured by a first wave."""
    _cuda_or_skip()
    tc, tp, dp = _card_models()
    want = _streams(_card_flavor("paged-auto-1", tc, tp, "cpu"))
    eng = _card_flavor("paged-auto-1", tc, dp, "cuda")
    guarded = []
    armed = [False]
    real = eng._mixed_dispatch

    def wrapped(*a, **k):
        if armed[0]:
            torch.cuda.set_sync_debug_mode("error")
            guarded.append(1)
        try:
            return real(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    eng._mixed_dispatch = wrapped
    with eng:
        for wave in range(2):
            armed[0] = wave == 1
            hs = [eng.submit(p, max_new_tokens=GEN, **GREEDY)
                  for p in PROMPTS]
            assert all(h.wait(timeout=600) for h in hs)
            assert all(h._req.error is None for h in hs)
            assert [list(h._req.out_tokens) for h in hs] == want
    assert guarded
