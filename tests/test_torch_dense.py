"""The port's dense model vs the JAX package's.

`prefill`, `decode_step`, `prefill_chunk` and `forward_logits_all` on
the tiny config (2 layers, f32 params and cache) give the JAX steps'
logits (1e-4) and caches (1e-5), with `use_flash_attention` off (the
masked einsum on both sides) and on (JAX through its Pallas kernels in
interpret mode, the port through the kernels' plain versions on the
CPU), with and without a sliding window. `update_layer_cache` clamps
its start as `lax.dynamic_update_slice` does. With int4 and int8 weights
carried over from `quantize_params` (hidden 128, intermediate 256, so
JAX's decode products reach its Pallas kernel, interpreted) the same
three steps give JAX's logits within 1e-3: the int4 kernel's f32 sums
run in another order than the port's plain version.
"""

import dataclasses
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cake_tpu.models.llama import model as jm
from cake_tpu.models.llama.cache import KVCache as JCache
from cake_tpu.models.llama.cache import update_layer_cache as j_update
from cake_tpu.models.llama.config import LlamaConfig as JConfig
from cake_tpu.models.llama.params import init_params as j_init
from cake_tpu.ops.quant import quantize_params as j_quantize_params
from cake_tpu_torch.models.llama import model as tm
from cake_tpu_torch.models.llama.cache import KVCache, update_layer_cache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.params import params_from_numpy
from cake_tpu_torch.ops import flash_attention as fa
from cake_tpu_torch.ops import int4_matmul as i4

LOGITS = dict(atol=1e-4, rtol=1e-4)
CACHE = dict(atol=1e-5, rtol=1e-5)
T = 64
L = 2

CONFIGS = {
    "einsum": dict(),
    "flash": dict(use_flash_attention=True),
    "einsum_window": dict(sliding_window=8),
    "flash_window": dict(use_flash_attention=True, sliding_window=8),
}


@pytest.fixture(scope="module")
def params():
    jp = j_init(JConfig.tiny(num_hidden_layers=L), jax.random.PRNGKey(0),
                dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _configs(name):
    kw = CONFIGS[name]
    return (dataclasses.replace(JConfig.tiny(num_hidden_layers=L), **kw),
            LlamaConfig.tiny(num_hidden_layers=L, **kw))


def _caches(jc, tc, B):
    return (JCache.create(jc, B, T, dtype=jnp.float32),
            KVCache.create(tc, B, T, dtype=torch.float32, device="cpu"))


def _ropes(jc, tc):
    return jm.RopeTables.create(jc, T), tm.RopeTables.create(tc, T)


def _same(jl, jcache, tl, tcache):
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               **CACHE)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               **CACHE)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_then_decode_matches_jax(params, name):
    """A right-padded 32-token window (prompts of 20 and 13 tokens),
    then two decode steps over the same caches."""
    jp, tp = params
    jc, tc = _configs(name)
    jrope, trope = _ropes(jc, tc)
    jcache, tcache = _caches(jc, tc, 2)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, size=(2, 32)).astype(np.int32)
    plen = np.array([20, 13], np.int32)
    jl, jcache = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(plen),
                            jcache, jrope, jc)
    fa.reset_launch_counts()
    tl, tcache = tm.prefill(tp, torch.from_numpy(toks),
                            torch.from_numpy(plen), tcache, trope, tc)
    _same(jl, jcache, tl, tcache)
    # the fresh-window route: one flash call per layer when flash is on
    assert fa.LAUNCHES["flash_attn_plain"] == (
        L if tc.use_flash_attention else 0)
    for pos in (20, 21):
        tok = rng.integers(0, 256, size=(2, 1)).astype(np.int32)
        jl, jcache = jm.decode_step(jp, jnp.asarray(tok), jnp.int32(pos),
                                    jcache, jrope, jc)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok), pos, tcache,
                                    trope, tc)
        _same(jl, jcache, tl, tcache)
    # decode stays on the masked einsum, as in JAX
    assert fa.LAUNCHES["flash_attn_cached_plain"] == 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_chunk_matches_jax(params, name):
    """Three 16-token windows at positions 0, 16, 32, the last one
    right-padded (9 real tokens), each against the growing cache."""
    jp, tp = params
    jc, tc = _configs(name)
    jrope, trope = _ropes(jc, tc)
    jcache, tcache = _caches(jc, tc, 1)
    rng = np.random.default_rng(1)
    fa.reset_launch_counts()
    for pos, n_real in ((0, 16), (16, 16), (32, 9)):
        toks = rng.integers(0, 256, size=(1, 16)).astype(np.int32)
        last = np.array([n_real - 1], np.int32)
        jl, jcache = jm.prefill_chunk(jp, jnp.asarray(toks), jnp.int32(pos),
                                      jnp.asarray(last), jcache, jrope, jc)
        tl, tcache = tm.prefill_chunk(tp, torch.from_numpy(toks), pos,
                                      torch.from_numpy(last), tcache, trope,
                                      tc)
        _same(jl, jcache, tl, tcache)
    assert fa.LAUNCHES["flash_attn_cached_plain"] == (
        3 * L if tc.use_flash_attention else 0)
    assert fa.LAUNCHES["flash_attn_plain"] == 0


@pytest.mark.parametrize("name", ["einsum", "flash_window"])
def test_forward_logits_all_matches_jax(params, name):
    jp, tp = params
    jc, tc = _configs(name)
    jrope, trope = _ropes(jc, tc)
    jcache, tcache = _caches(jc, tc, 2)
    toks = np.random.default_rng(2).integers(0, 256, size=(2, 12))
    toks = toks.astype(np.int32)
    jl, jcache = jm.forward_logits_all(jp, jnp.asarray(toks), jcache,
                                       jnp.int32(0), jrope, jc)
    tl, tcache = tm.forward_logits_all(tp, torch.from_numpy(toks), tcache,
                                       0, trope, tc)
    assert tl.shape == (2, 12, tc.vocab_size)
    _same(jl, jcache, tl, tcache)


def test_chunked_prefill_with_kv_dtype_unlike_q_takes_einsum(params):
    """bf16 activations over an f32 cache: the cache-aware kernel reads
    one dtype, so the chunk takes the masked einsum (as JAX routes it)."""
    _, tp = params
    tc = LlamaConfig.tiny(num_hidden_layers=L, use_flash_attention=True)
    bf = jax.tree.map(lambda t: t.bfloat16(), tp)
    cache = KVCache.create(tc, 1, T, dtype=torch.float32, device="cpu")
    fa.reset_launch_counts()
    logits, _ = tm.prefill_chunk(bf, torch.zeros((1, 16), dtype=torch.int32),
                                 16, torch.tensor([15]), cache,
                                 tm.RopeTables.create(tc, T), tc)
    assert torch.isfinite(logits).all()
    assert fa.LAUNCHES["flash_attn_cached_plain"] == 0


QCFG = dict(num_hidden_layers=L, hidden_size=128, intermediate_size=256)
QLOGITS = dict(atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_weights_steps_match_jax(bits):
    """prefill (M = 64 rows), a 16-token prefill_chunk and two decode
    steps over int4 / int8 weights: JAX's logits within 1e-3 and its
    caches within 1e-4; int4 decode products go through int4_matmul (its
    plain version here), seven per layer and step."""
    jc, tc = JConfig.tiny(**QCFG), LlamaConfig.tiny(**QCFG)
    jp = jax.jit(partial(j_quantize_params, bits=bits))(
        j_init(jc, jax.random.PRNGKey(1), dtype=jnp.float32))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jrope, trope = _ropes(jc, tc)
    jcache, tcache = _caches(jc, tc, 2)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 256, size=(2, 32)).astype(np.int32)
    plen = np.array([32, 20], np.int32)
    i4.reset_launch_counts()
    jl, jcache = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(plen),
                            jcache, jrope, jc)
    tl, tcache = tm.prefill(tp, torch.from_numpy(toks),
                            torch.from_numpy(plen), tcache, trope, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **QLOGITS)
    win = rng.integers(0, 256, size=(2, 16)).astype(np.int32)
    last = np.array([15, 15], np.int32)
    jl, jcache = jm.prefill_chunk(jp, jnp.asarray(win), jnp.int32(32),
                                  jnp.asarray(last), jcache, jrope, jc)
    tl, tcache = tm.prefill_chunk(tp, torch.from_numpy(win), 32,
                                  torch.from_numpy(last), tcache, trope, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **QLOGITS)
    before = i4.LAUNCHES["int4_matmul_plain"]
    for pos in (48, 49):
        tok = rng.integers(0, 256, size=(2, 1)).astype(np.int32)
        jl, jcache = jm.decode_step(jp, jnp.asarray(tok), jnp.int32(pos),
                                    jcache, jrope, jc)
        tl, tcache = tm.decode_step(tp, torch.from_numpy(tok), pos, tcache,
                                    trope, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **QLOGITS)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-4, rtol=1e-4)
    # the 2 x 32 prefill and the 2 x 16 window are M <= 64 too
    want = 7 * L * 2 if bits == 4 else 0
    assert i4.LAUNCHES["int4_matmul_plain"] - before == want
    assert (before > 0) == (bits == 4)
    assert i4.LAUNCHES["int4_matmul"] == 0


@pytest.mark.parametrize("pos", [-30, -3, 0, 7, 11, 14, 20])
def test_update_layer_cache_clamps_like_dynamic_update_slice(pos):
    """A window that would run past the cache is shifted back to T - S
    and written whole, as lax.dynamic_update_slice clamps its start (a
    negative start counts from the end first)."""
    rng = np.random.default_rng(3)
    kc = rng.normal(size=(2, 16, 2, 4)).astype(np.float32)
    vc = rng.normal(size=(2, 16, 2, 4)).astype(np.float32)
    nk = rng.normal(size=(2, 5, 2, 4)).astype(np.float32)
    nv = rng.normal(size=(2, 5, 2, 4)).astype(np.float32)
    jk, jv = j_update(*(jnp.asarray(x) for x in (kc, vc, nk, nv)),
                      jnp.int32(pos))
    tk, tv = update_layer_cache(*(torch.from_numpy(x.copy())
                                  for x in (kc, vc, nk, nv)), pos)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    start = min(max(pos + 16 if pos < 0 else pos, 0), 16 - 5)
    np.testing.assert_array_equal(tk.numpy()[:, start:start + 5], nk)
