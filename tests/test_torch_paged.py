"""The port's paged KV cache vs the JAX package's.

PageAllocator keeps its refcount invariants; the pool writers scatter
exactly where the JAX writers do; `mixed_step_paged` and
`decode_step_ragged_paged` give the JAX steps' logits (1e-4 at f32) and
pools (JAX attn="fold"; the port's "auto", which is the plain fold on
CPU tensors).
"""

from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cake_tpu.models.llama import paged as jpg
from cake_tpu.models.llama.config import LlamaConfig as JConfig
from cake_tpu.models.llama.model import RopeTables as JRope
from cake_tpu.models.llama.params import init_params as j_init
from cake_tpu.ops.quant import quantize_params as j_quantize_params
from cake_tpu_torch.models.llama import paged as tpg
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.models.llama.model import RopeTables
from cake_tpu_torch.models.llama.params import params_from_numpy
from cake_tpu_torch.ops import int4_matmul as i4
from cake_tpu_torch.ops import ragged_paged_attention as rpa

LOGITS = dict(atol=1e-4, rtol=1e-4)
POOL = dict(atol=1e-5, rtol=1e-5)
P = 16


# -- allocator --------------------------------------------------------------


def test_allocator_alloc_release_invariant():
    a = tpg.PageAllocator(8, P)
    pages = a.alloc(3 * P + 1)                # 4 pages
    assert len(pages) == 4 and a.free_pages == 4 and a.live_pages == 4
    assert a.alloc(5 * P) is None             # exhausted: caller requeues
    a.retain(pages[:2])                       # a shared mapping
    a.release(pages)
    assert a.free_pages == 6 and a.live_pages == 2
    assert a.refcount(pages[0]) == 1
    a.release(pages[:2])
    assert a.free_pages + a.live_pages == a.n_pages == a.free_pages


def test_allocator_raises_on_double_free_and_foreign_ids():
    a = tpg.PageAllocator(4, P)
    pages = a.alloc(P)
    a.release(pages)
    with pytest.raises(ValueError, match="double-free"):
        a.release(pages)
    with pytest.raises(ValueError, match="foreign"):
        a.release([4])
    with pytest.raises(ValueError, match="not allocated"):
        a.retain([0])
    assert a.free_pages + a.live_pages == a.n_pages


def test_allocator_matches_jax_page_order():
    ja, ta = jpg.PageAllocator(6, P), tpg.PageAllocator(6, P)
    for n in (P, 3 * P, 1):
        assert ta.alloc(n) == ja.alloc(n)


# -- pool writers -----------------------------------------------------------


def _pools(rng, N=6, KV=2, hd=8):
    k = rng.normal(size=(N, P, KV, hd)).astype(np.float32)
    return k, k * 2.0


def test_write_windows_pages_matches_jax():
    rng = np.random.default_rng(0)
    pk, pv = _pools(rng)
    C = 5
    k = rng.normal(size=(3, C, 2, 8)).astype(np.float32)
    v = rng.normal(size=(3, C, 2, 8)).astype(np.float32)
    table = np.array([[0, 1, -1], [2, -1, 3], [4, 5, -1]], np.int32)
    pos = np.array([P - 2, P - 1, 3], np.int32)   # straddle / hole / mid
    qlen = np.array([5, 4, 2], np.int32)
    active = np.array([True, True, False])
    jk, jv = jpg.write_windows_pages(*(jnp.asarray(x) for x in (
        pk, pv, k, v, pos, qlen, active, table)))
    tk, tv = (torch.from_numpy(x.copy()) for x in (pk, pv))
    tpg.write_windows_pages(tk, tv, *(torch.from_numpy(x) for x in (
        k, v, pos, qlen, active, table)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_update_pool_per_row_matches_jax():
    """The port's pools carry one more page, the sink, where the rows
    JAX drops (the hole, the inactive row) land; the real pages match."""
    rng = np.random.default_rng(1)
    pk, pv = _pools(rng)
    k = rng.normal(size=(3, 1, 2, 8)).astype(np.float32)
    v = rng.normal(size=(3, 1, 2, 8)).astype(np.float32)
    table = np.array([[0, 1, -1], [2, -1, 3], [4, 5, -1]], np.int32)
    pos = np.array([P + 3, P + 1, 7], np.int32)   # mapped / hole / mapped
    active = np.array([True, True, False])
    jk, jv = jpg.update_pool_per_row(*(jnp.asarray(x) for x in (
        pk, pv, k, v, pos, active, table)))
    N = pk.shape[0]
    tk, tv = (torch.from_numpy(np.concatenate([x, np.zeros_like(x[:1])]))
              for x in (pk, pv))
    tpg.update_pool_per_row(tk, tv, *(torch.from_numpy(x) for x in (
        k, v, pos, active, table)))
    np.testing.assert_array_equal(tk[:N].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv[:N].numpy(), np.asarray(jv))


def test_table_set_slot_matches_jax():
    jt = jnp.full((2, 4), -1, jnp.int32)
    tt = torch.full((2, 4), -1, dtype=torch.int32)
    jt = jpg.table_set_slot(jt, 1, [3, 0])
    tpg.table_set_slot(tt, 1, [3, 0])
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


# -- steps --------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jc = JConfig.tiny(num_hidden_layers=2)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, LlamaConfig.tiny(num_hidden_layers=2), tp


def _caches(jc, tc, rng, B=3, N=12, T=64):
    """JAX and port caches with identical random pools and tables."""
    jcache = jpg.PagedKVCache.create(jc, B, N, P, T, dtype=jnp.float32)
    k = rng.normal(size=jcache.k.shape).astype(np.float32)
    v = rng.normal(size=jcache.v.shape).astype(np.float32)
    table = np.array([[0, 1, 2, -1], [3, 4, -1, -1], [5, 6, 7, 8]],
                     np.int32)
    jcache = jcache._replace(k=jnp.asarray(k), v=jnp.asarray(v),
                             table=jnp.asarray(table))
    tcache = tpg.PagedKVCache.create(tc, B, N, P, T, dtype=torch.float32,
                                     device="cpu")
    tcache.k.copy_(torch.from_numpy(k))
    tcache.v.copy_(torch.from_numpy(v))
    tcache.table.copy_(torch.from_numpy(table))
    return jcache, tcache


def _check(jl, jcache, tl, tcache, rows):
    np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                               **LOGITS)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k),
                               **POOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v),
                               **POOL)


def test_mixed_step_paged_matches_jax(tiny):
    """A decode row, a chunk row straddling a page boundary, an idle row
    — then one decode step over the same pools."""
    jc, jp, tc, tp = tiny
    rng = np.random.default_rng(2)
    jcache, tcache = _caches(jc, tc, rng)
    jrope, trope = JRope.create(jc, 64), RopeTables.create(tc, 64)
    C = 8
    tokens = rng.integers(0, 256, size=(3, C)).astype(np.int32)
    pos = np.array([20, 13, 0], np.int32)
    qlen = np.array([1, 8, 0], np.int32)
    active = qlen > 0
    jl, jcache = jpg.mixed_step_paged(
        jp, *(jnp.asarray(x) for x in (tokens, pos, qlen, active)), jcache,
        jrope, jc, attn="fold")
    rpa.reset_launch_counts()
    tl, tcache = tpg.mixed_step_paged(
        tp, *(torch.from_numpy(x) for x in (tokens, pos, qlen, active)),
        tcache, trope, tc)
    assert rpa.LAUNCHES["rpa_mixed_plain"] == tc.num_hidden_layers
    _check(jl, jcache, tl, tcache, rows=[0, 1])

    dpos = np.array([21, 21, 0], np.int32)
    dtok = tokens[:, :1]
    jl, jcache = jpg.decode_step_ragged_paged(
        jp, jnp.asarray(dtok), jnp.asarray(dpos), jnp.asarray(active),
        jcache, jrope, jc, attn="fold")
    tl, tcache = tpg.decode_step_ragged_paged(
        tp, torch.from_numpy(dtok), torch.from_numpy(dpos),
        torch.from_numpy(active), tcache, trope, tc, attn="plain")
    _check(jl, jcache, tl, tcache, rows=[0, 1])


def test_decode_step_ragged_paged_matches_jax(tiny):
    jc, jp, tc, tp = tiny
    rng = np.random.default_rng(3)
    jcache, tcache = _caches(jc, tc, rng)
    jrope, trope = JRope.create(jc, 64), RopeTables.create(tc, 64)
    toks = rng.integers(0, 256, size=(3, 1)).astype(np.int32)
    pos = np.array([47, P, 63], np.int32)     # page edge, full table
    active = np.array([True, True, True])
    jl, jcache = jpg.decode_step_ragged_paged(
        jp, *(jnp.asarray(x) for x in (toks, pos, active)), jcache, jrope,
        jc, attn="fold")
    tl, tcache = tpg.decode_step_ragged_paged(
        tp, *(torch.from_numpy(x) for x in (toks, pos, active)), tcache,
        trope, tc)
    _check(jl, jcache, tl, tcache, rows=[0, 1, 2])


def test_moe_router_leaf_is_refused(tiny):
    _, _, tc, tp = tiny
    blocks = dict(tp["blocks"], router=torch.zeros(2, 64, 4))
    cache = tpg.PagedKVCache.create(tc, 1, 4, P, 64, dtype=torch.float32,
                                    device="cpu")
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        tpg.decode_step_ragged_paged(
            dict(tp, blocks=blocks), torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=bool),
            cache, RopeTables.create(tc, 64), tc)


# -- int4 / int8 weights --------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_weights_steps_match_jax(bits):
    """The mixed step (3 x 8 rows) and the decode step (3 rows) over
    int4 / int8 weights quantized by the JAX package (hidden 128,
    intermediate 256: JAX's products reach its Pallas kernel,
    interpreted), f32 pools: JAX's logits within 1e-3 (the f32 sums of
    the int4 product run in another order), pools within 1e-4."""
    cfg = dict(num_hidden_layers=2, hidden_size=128, intermediate_size=256)
    jc, tc = JConfig.tiny(**cfg), LlamaConfig.tiny(**cfg)
    jp = jax.jit(partial(j_quantize_params, bits=bits))(
        j_init(jc, jax.random.PRNGKey(2), dtype=jnp.float32))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    jcache, tcache = _caches(jc, tc, rng)
    jrope, trope = JRope.create(jc, 64), RopeTables.create(tc, 64)
    tokens = rng.integers(0, 256, size=(3, 8)).astype(np.int32)
    pos = np.array([20, 13, 0], np.int32)
    qlen = np.array([1, 8, 0], np.int32)
    active = qlen > 0
    tol = dict(atol=1e-3, rtol=1e-3)
    i4.reset_launch_counts()
    jl, jcache = jpg.mixed_step_paged(
        jp, *(jnp.asarray(x) for x in (tokens, pos, qlen, active)), jcache,
        jrope, jc, attn="fold")
    tl, tcache = tpg.mixed_step_paged(
        tp, *(torch.from_numpy(x) for x in (tokens, pos, qlen, active)),
        tcache, trope, tc)
    np.testing.assert_allclose(tl.numpy()[[0, 1]], np.asarray(jl)[[0, 1]],
                               **tol)
    dpos = np.array([21, 21, 0], np.int32)
    jl, jcache = jpg.decode_step_ragged_paged(
        jp, jnp.asarray(tokens[:, :1]), jnp.asarray(dpos),
        jnp.asarray(active), jcache, jrope, jc, attn="fold")
    tl, tcache = tpg.decode_step_ragged_paged(
        tp, torch.from_numpy(tokens[:, :1]), torch.from_numpy(dpos),
        torch.from_numpy(active), tcache, trope, tc)
    np.testing.assert_allclose(tl.numpy()[[0, 1]], np.asarray(jl)[[0, 1]],
                               **tol)
    for a, b in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
    # both steps are decode-shaped (24 and 3 rows): seven products a layer
    assert i4.LAUNCHES["int4_matmul_plain"] == (28 if bits == 4 else 0)
    assert i4.LAUNCHES["int4_matmul"] == 0


# -- int8 / int4 pools ----------------------------------------------------------


def _qcaches(jc, tc, rng, fmt, B=3, N=12, T=64):
    """JAX and port quantized caches holding the same pages: every page
    of every layer written fresh by the JAX prompt writer."""
    from cake_tpu.kv import quantized_pool as jq
    from cake_tpu_torch.kv import quantized_pool as tq
    jcls, tcls = ((jq.Int4PagedKVCache, tq.Int4PagedKVCache) if fmt == "int4"
                  else (jq.QuantizedPagedKVCache, tq.QuantizedPagedKVCache))
    jcache = jcls.create(jc, B, N, P, T)
    tcache = tcls.create(tc, B, N, P, T, device="cpu")
    table = np.array([[0, 1, 2, -1], [3, 4, -1, -1], [5, 6, 7, 8]],
                     np.int32)
    every = jnp.arange(N, dtype=jnp.int32)
    halves = []
    for jpool, tpool in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
        qs, ss = [], []
        for i in range(jc.num_hidden_layers):
            leaf = type(jpool)(q=jpool.q[i], scale=jpool.scale[i])
            vals = rng.normal(size=(1, N * P, jc.num_key_value_heads,
                                    jc.head_dim)).astype(np.float32)
            leaf = jax.jit(jq.qwrite_prompt_pages)(leaf, jnp.asarray(vals),
                                                   every)
            qs.append(leaf.q)
            ss.append(leaf.scale)
        jpool = jpool._replace(q=jnp.stack(qs), scale=jnp.stack(ss))
        tpool.q.copy_(torch.from_numpy(np.array(jpool.q)))
        tpool.scale.copy_(torch.from_numpy(np.array(jpool.scale)))
        halves.append(jpool)
    jcache = jcache._replace(k=halves[0], v=halves[1],
                             table=jnp.asarray(table))
    tcache.table.copy_(torch.from_numpy(table))
    return jcache, tcache


def _check_q(jl, jcache, tl, tcache, rows, tol):
    """Logits within `tol`; the pools within one quantization step of
    JAX's (their k/v inputs come out of matmuls that differ from JAX's
    in the last ulp, which can move a value across a rounding edge) and
    the scales within f32 rounding."""
    np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                               **tol)
    for tp, jp in ((tcache.k, jcache.k), (tcache.v, jcache.v)):
        dq = np.abs(tp.q.numpy().astype(np.int32)
                    - np.asarray(jp.q).astype(np.int32))
        if tp.q.dtype == torch.uint8:       # compare each nibble
            dq = np.maximum(np.abs((tp.q.numpy() & 0xF).astype(np.int32)
                                   - (np.asarray(jp.q) & 0xF)),
                            np.abs((tp.q.numpy() >> 4).astype(np.int32)
                                   - (np.asarray(jp.q) >> 4)))
        assert dq.max() <= 1
        np.testing.assert_allclose(tp.scale.numpy(), np.asarray(jp.scale),
                                   rtol=1e-5, atol=0)


QLOGITS = dict(atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_quantized_steps_match_jax(tiny, fmt):
    """A mixed step (a decode row, a chunk straddling a page edge, an
    idle row) then a decode step (a page edge), over int8 and int4
    pools, against the JAX steps at the same kv dtype (fold)."""
    jc, jp, tc, tp = tiny
    rng = np.random.default_rng(4)
    jcache, tcache = _qcaches(jc, tc, rng, fmt)
    jrope, trope = JRope.create(jc, 64), RopeTables.create(tc, 64)
    C = 8
    tokens = rng.integers(0, 256, size=(3, C)).astype(np.int32)
    pos = np.array([20, 13, 0], np.int32)
    qlen = np.array([1, 8, 0], np.int32)
    active = qlen > 0
    jl, jcache = jpg.mixed_step_paged(
        jp, *(jnp.asarray(x) for x in (tokens, pos, qlen, active)), jcache,
        jrope, jc, attn="fold")
    rpa.reset_launch_counts()
    tl, tcache = tpg.mixed_step_paged(
        tp, *(torch.from_numpy(x) for x in (tokens, pos, qlen, active)),
        tcache, trope, tc)
    name = "rpa_mixed_q4_plain" if fmt == "int4" else "rpa_mixed_q8_plain"
    assert rpa.LAUNCHES[name] == tc.num_hidden_layers
    _check_q(jl, jcache, tl, tcache, [0, 1], QLOGITS)

    dpos = np.array([21, P, 0], np.int32)
    dtok = tokens[:, :1]
    jl, jcache = jpg.decode_step_ragged_paged(
        jp, jnp.asarray(dtok), jnp.asarray(dpos), jnp.asarray(active),
        jcache, jrope, jc, attn="fold")
    tl, tcache = tpg.decode_step_ragged_paged(
        tp, torch.from_numpy(dtok), torch.from_numpy(dpos),
        torch.from_numpy(active), tcache, trope, tc, attn="plain")
    _check_q(jl, jcache, tl, tcache, [0, 1], QLOGITS)
