"""The dense and ring engines' model steps in the port vs the JAX package.

On the tiny config (2 layers, f32 params and cache), from the same
seeded inputs:

  * the masks `decode_mask_per_row`, `ring_decode_mask_per_row`,
    `ring_concat_mask` and `uniform_forward_mask`'s ring branch equal
    JAX's, positions before, at and past a wrap;
  * the four cache writers (per row, ring with a short final window's
    padding, per-row ring, window per row) write JAX's bytes, and an
    inactive row keeps its lines;
  * `decode_step_ragged`, `forward_window_ragged`, the ring decode and
    the ring chunk across a wrap give JAX's logits and caches;
  * each one-slot prefill (`prefill_slot`, `prefill_slot_chunk`,
    `prefill_slot_chunk_ring`, `prefill_slot_prefixed`) and
    `install_prefix_slot` give JAX's logits and caches within 1e-5, the
    other slots untouched, with flash off (the einsum on both sides) and
    on (JAX's Pallas kernels in interpret mode, the port's kernels'
    plain versions), a slot given as an int or as a device tensor.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cake_tpu.models.llama import cache as jcache
from cake_tpu.models.llama import model as jm
from cake_tpu.models.llama.cache import KVCache as JCache
from cake_tpu.models.llama.config import LlamaConfig as JConfig
from cake_tpu.models.llama.params import init_params as j_init
from cake_tpu.ops import attention as ja
from cake_tpu_torch.models.llama import cache as tcache
from cake_tpu_torch.models.llama import model as tm
from cake_tpu_torch.models.llama.cache import KVCache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.params import params_from_numpy
from cake_tpu_torch.ops import attention as ta

TOL = dict(atol=1e-5, rtol=1e-5)
T = 64
L = 2
B = 3
W = 16          # the ring's window


@pytest.fixture(scope="module")
def params():
    jp = j_init(JConfig.tiny(num_hidden_layers=L), jax.random.PRNGKey(0),
                dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _configs(**kw):
    return (dataclasses.replace(JConfig.tiny(num_hidden_layers=L), **kw),
            LlamaConfig.tiny(num_hidden_layers=L, **kw))


def _filled(jc, tc, batch, length, seed=1):
    """A JAX and a port cache holding the same random lines."""
    rng = np.random.default_rng(seed)
    shape = (L, batch, length, jc.num_key_value_heads, jc.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return (JCache(k=jnp.asarray(k), v=jnp.asarray(v)),
            KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy())))


def _ropes(jc, tc):
    return jm.RopeTables.create(jc, T), tm.RopeTables.create(tc, T)


def _same_cache(jc_, tc_):
    np.testing.assert_allclose(tc_.k.numpy(), np.asarray(jc_.k), **TOL)
    np.testing.assert_allclose(tc_.v.numpy(), np.asarray(jc_.v), **TOL)


# -- masks ---------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 5])
def test_decode_mask_per_row(window):
    pos = np.array([0, 7, 31, 63], np.int32)
    want = np.asarray(ja.decode_mask_per_row(jnp.asarray(pos), T,
                                             window=window))
    got = ta.decode_mask_per_row(torch.from_numpy(pos), T, window=window)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ring_decode_mask_per_row():
    pos = np.array([0, 5, W - 1, W, 3 * W + 2], np.int32)
    want = np.asarray(ja.ring_decode_mask_per_row(jnp.asarray(pos), W))
    got = ta.ring_decode_mask_per_row(torch.from_numpy(pos), W)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pos", [0, 3, W - 4, W, W + 5, 3 * W + 7])
@pytest.mark.parametrize("S", [1, 8, W])
def test_ring_concat_mask(pos, S):
    want = np.asarray(ja.ring_concat_mask(jnp.int32(pos), S, W, W))
    for p in (pos, torch.tensor(pos)):
        got = ta.ring_concat_mask(p, S, W, W)
        np.testing.assert_array_equal(got.numpy(), want)
    uni = ta.uniform_forward_mask(pos, S, W, W, ring=True, n_real=S)
    np.testing.assert_array_equal(uni.numpy(), np.asarray(
        ja.uniform_forward_mask(jnp.int32(pos), S, W, W, True, n_real=S)))
    dense = ta.uniform_forward_mask(pos, S, T, None)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(
        ja.uniform_forward_mask(jnp.int32(pos), S, T, None, False)))


# -- cache writers ---------------------------------------------------------------


def _layer(seed, batch, length, kv=2, hd=16):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, length, kv, hd)).astype(np.float32)


def _both(fn_j, fn_t, k, v, *args_j, args_t):
    jk, jv = fn_j(jnp.asarray(k), jnp.asarray(v), *args_j)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    rk, rv = fn_t(tk, tv, *args_t)
    assert rk is tk and rv is tv           # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_per_row_writer_keeps_inactive_rows():
    k, v = _layer(1, B, T), _layer(2, B, T)
    nk, nv = _layer(3, B, 1), _layer(4, B, 1)
    pos = np.array([4, 60, 9], np.int32)
    active = np.array([True, False, True])
    _both(jcache.update_layer_cache_per_row,
          tcache.update_layer_cache_per_row, k, v, jnp.asarray(nk),
          jnp.asarray(nv), jnp.asarray(pos), jnp.asarray(active),
          args_t=(torch.from_numpy(nk), torch.from_numpy(nv),
                  torch.from_numpy(pos), torch.from_numpy(active)))


def test_per_row_ring_writer_wraps():
    k, v = _layer(5, B, W), _layer(6, B, W)
    nk, nv = _layer(7, B, 1), _layer(8, B, 1)
    pos = np.array([3, W + 2, 5 * W - 1], np.int32)
    active = np.array([True, True, False])
    _both(jcache.update_layer_cache_per_row_ring,
          tcache.update_layer_cache_per_row_ring, k, v, jnp.asarray(nk),
          jnp.asarray(nv), jnp.asarray(pos), jnp.asarray(active),
          args_t=(torch.from_numpy(nk), torch.from_numpy(nv),
                  torch.from_numpy(pos), torch.from_numpy(active)))


@pytest.mark.parametrize("pos,S,n_real", [(0, W, W), (W - 3, 8, 8),
                                          (2 * W + 5, 8, 3), (7, 4, None)])
def test_ring_writer_masks_a_short_window(pos, S, n_real):
    k, v = _layer(9, 1, W), _layer(10, 1, W)
    nk, nv = _layer(11, 1, S), _layer(12, 1, S)
    for n_t in (n_real, None if n_real is None else torch.tensor(n_real)):
        _both(jcache.update_layer_cache_ring, tcache.update_layer_cache_ring,
              k, v, jnp.asarray(nk), jnp.asarray(nv), jnp.int32(pos),
              n_real, args_t=(torch.from_numpy(nk), torch.from_numpy(nv),
                              torch.tensor(pos), n_t))


def test_window_per_row_writer():
    G = 5
    k, v = _layer(13, B, T), _layer(14, B, T)
    nk, nv = _layer(15, B, G), _layer(16, B, G)
    pos0 = np.array([10, T - 2, 0], np.int32)     # row 1 clamps (inactive)
    active = np.array([True, False, True])
    _both(jcache.update_layer_cache_window_per_row,
          tcache.update_layer_cache_window_per_row, k, v, jnp.asarray(nk),
          jnp.asarray(nv), jnp.asarray(pos0), jnp.asarray(active),
          args_t=(torch.from_numpy(nk), torch.from_numpy(nv),
                  torch.from_numpy(pos0), torch.from_numpy(active)))


def test_kvcache_batch_size_and_bytes():
    c = KVCache.create(LlamaConfig.tiny(num_hidden_layers=L), B, T,
                       dtype=torch.bfloat16, device="cpu")
    assert c.batch_size == B and c.max_seq_len == T
    assert c.memory_bytes() == 2 * L * B * T * 2 * 16 * 2


# -- ragged steps ----------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 6])
def test_decode_step_ragged(params, window):
    jp, tp = params
    jc, tc = _configs(sliding_window=window)
    jr, tr = _ropes(jc, tc)
    j_cache, t_cache = _filled(jc, tc, B, T)
    tokens = np.array([[5], [17], [200]], np.int32)
    pos = np.array([3, 40, 12], np.int32)
    active = np.array([True, True, False])
    jl, j_cache = jm.decode_step_ragged(jp, jnp.asarray(tokens),
                                        jnp.asarray(pos), jnp.asarray(active),
                                        j_cache, jr, jc)
    tl, t_cache = tm.decode_step_ragged(
        tp, torch.from_numpy(tokens), torch.from_numpy(pos),
        torch.from_numpy(active), t_cache, tr, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _same_cache(j_cache, t_cache)


def test_forward_window_ragged(params):
    jp, tp = params
    jc, tc = _configs()
    jr, tr = _ropes(jc, tc)
    j_cache, t_cache = _filled(jc, tc, B, T, seed=3)
    tokens = np.array([[5, 6, 7, 8], [9, 10, 11, 12], [1, 2, 3, 4]],
                      np.int32)
    pos0 = np.array([0, 30, T - 2], np.int32)
    active = np.array([True, True, False])
    jl, j_cache = jax.jit(jm.forward_window_ragged, static_argnames=(
        "config",))(jp, jnp.asarray(tokens), j_cache, jnp.asarray(pos0),
                    jnp.asarray(active), jr, config=jc)
    tl, t_cache = tm.forward_window_ragged(
        tp, torch.from_numpy(tokens), t_cache, torch.from_numpy(pos0),
        torch.from_numpy(active), tr, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _same_cache(j_cache, t_cache)


def test_ring_chunk_and_decode_across_a_wrap(params):
    """A prompt of 2.5 windows walks the ring chunk (the last window
    padded), then decode steps run past another wrap, one row idle: the
    port's logits and ring equal JAX's after every step."""
    jp, tp = params
    jc, tc = _configs(sliding_window=W)
    jr, tr = _ropes(jc, tc)
    j_cache = JCache.create(jc, 2, W, dtype=jnp.float32)
    t_cache = KVCache.create(tc, 2, W, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    ids = rng.integers(3, 250, size=2 * W + W // 2).tolist()
    C = W
    for start in range(0, len(ids), C):
        win = ids[start:start + C]
        n = len(win)
        toks = np.array([win + [0] * (C - n)], np.int32)
        jl, j_cache = jm.prefill_slot_chunk_ring(
            jp, jnp.asarray(toks), jnp.asarray([n], jnp.int32), jnp.int32(1),
            jnp.int32(start), j_cache, jr, jc)
        tl, t_cache = tm.prefill_slot_chunk_ring(
            tp, torch.from_numpy(toks), torch.tensor([n], dtype=torch.int32),
            torch.tensor([1]), torch.tensor([start], dtype=torch.int32),
            t_cache, tr, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _same_cache(j_cache, t_cache)
    tok, p = int(np.argmax(np.asarray(jl)[0])), len(ids)
    active = np.array([False, True])
    for _ in range(W + 3):
        toks = np.array([[0], [tok]], np.int32)
        pos = np.array([0, p], np.int32)
        jl, j_cache = jm.decode_step_ragged_ring(
            jp, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(active),
            j_cache, jr, jc)
        tl, t_cache = tm.decode_step_ragged_ring(
            tp, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(active), t_cache, tr, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _same_cache(j_cache, t_cache)
        tok, p = int(np.argmax(np.asarray(jl)[1])), p + 1


# -- one-slot prefills -------------------------------------------------------------


FLASH = {"einsum": False, "flash": True}


@pytest.mark.parametrize("flash", FLASH)
@pytest.mark.parametrize("device_slot", [False, True])
def test_slot_prefills(params, flash, device_slot):
    """prefill_slot into slot 1, a chunk window at pos0 = 16 into slot
    2, an install then a prefixed prefill into slot 0: each gives JAX's
    logits and cache, and slots it does not name keep their lines."""
    jp, tp = params
    jc, tc = _configs(use_flash_attention=FLASH[flash])
    jr, tr = _ropes(jc, tc)
    j_cache, t_cache = _filled(jc, tc, B, T, seed=5)

    def slot(s):
        return torch.tensor([s]) if device_slot else s

    rng = np.random.default_rng(6)
    ids = rng.integers(3, 250, size=13).tolist()
    toks = np.array([ids + [0] * 3], np.int32)               # bucket 16
    jl, j_cache = jm.prefill_slot(jp, jnp.asarray(toks),
                                  jnp.asarray([13], jnp.int32), jnp.int32(1),
                                  j_cache, jr, jc)
    tl, t_cache = tm.prefill_slot(tp, torch.from_numpy(toks),
                                  torch.tensor([13], dtype=torch.int32),
                                  slot(1), t_cache, tr, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _same_cache(j_cache, t_cache)

    win = np.array([ids[:8] + [0] * 8], np.int32)
    jl, j_cache = jm.prefill_slot_chunk(
        jp, jnp.asarray(win), jnp.asarray([8], jnp.int32), jnp.int32(2),
        jnp.int32(16), j_cache, jr, jc)
    tl, t_cache = tm.prefill_slot_chunk(
        tp, torch.from_numpy(win), torch.tensor([8], dtype=torch.int32),
        slot(2), torch.tensor([16], dtype=torch.int32) if device_slot
        else 16, t_cache, tr, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _same_cache(j_cache, t_cache)

    P = 8
    pk = np.asarray(j_cache.k[:, 1:2, :P])
    pv = np.asarray(j_cache.v[:, 1:2, :P])
    j_cache = jm.install_prefix_slot(j_cache, jnp.asarray(pk),
                                     jnp.asarray(pv), jnp.int32(0))
    t_cache = tm.install_prefix_slot(t_cache, torch.from_numpy(pk.copy()),
                                     torch.from_numpy(pv.copy()), slot(0))
    _same_cache(j_cache, t_cache)
    suffix = np.array([ids[P:] + [0] * (16 - len(ids[P:]))], np.int32)
    n = len(ids) - P
    jl, j_cache = jm.prefill_slot_prefixed(
        jp, jnp.asarray(suffix), jnp.asarray([n], jnp.int32), jnp.int32(2),
        jnp.asarray(pk), jnp.asarray(pv), j_cache, jr, jc)
    tl, t_cache = tm.prefill_slot_prefixed(
        tp, torch.from_numpy(suffix), torch.tensor([n], dtype=torch.int32),
        slot(2), torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()),
        t_cache, tr, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _same_cache(j_cache, t_cache)
