"""The port's int8/int4 KV page pools vs `cake_tpu/kv/quantized_pool.py`.

Every writer, pack/unpack, dequantize_pages, reset_page_scales,
page_bytes and memory_bytes give BIT-identical results to the JAX
package (the same int bytes and the same f32 scales), on ragged
positions, page-straddling windows, unmapped pages, inactive and idle
rows, and n_real / q_len padding that must not raise a scale. Inputs
come from a seeded numpy generator and go to both sides as numpy.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cake_tpu.kv import quantized_pool as jq
from cake_tpu.models.llama.config import LlamaConfig as JConfig
from cake_tpu_torch.kv import quantized_pool as tq
from cake_tpu_torch.models.llama.config import LlamaConfig

# The JAX writers run jitted, as the JAX engine's steps run them: XLA
# then multiplies an amax by the f32 reciprocal of qmax where the
# op-by-op code divides (an ulp apart in the scale), and the file runs
# several times faster than with each primitive compiled on its own.
j_prompt = jax.jit(jq.qwrite_prompt_pages)
j_update = jax.jit(jq.qupdate_pool_per_row)
j_window = jax.jit(jq.qwrite_window_pages)
j_windows = jax.jit(jq.qwrite_windows_pages)

P = 8
N = 10
KV, HD = 2, 4
FORMATS = ("int8", "int4")


def _pools(rng, fmt):
    """The same pool on both sides, every page written fresh through
    the JAX prompt writer (so each carries its own scales)."""
    if fmt == "int8":
        jpool = jq.QuantPool(q=jnp.zeros((N, P, KV, HD), jnp.int8),
                             scale=jnp.zeros((N, KV), jnp.float32))
    else:
        jpool = jq.Int4Pool(q=jnp.zeros((N, P // 2, KV, HD), jnp.uint8),
                            scale=jnp.zeros((N, KV), jnp.float32))
    vals = rng.normal(size=(1, N * P, KV, HD)).astype(np.float32)
    jpool = j_prompt(jpool, jnp.asarray(vals),
                     jnp.arange(N, dtype=jnp.int32))
    return jpool, _torch_pool(jpool)


def _torch_pool(jpool):
    cls = tq.Int4Pool if isinstance(jpool, jq.Int4Pool) else tq.QuantPool
    return cls(q=torch.from_numpy(np.array(jpool.q)),
               scale=torch.from_numpy(np.array(jpool.scale)))


def _with_sink(tpool):
    """The pool with one more (zero) page past the real ones: the decode
    writer's sink."""
    return type(tpool)(*(torch.cat([t, torch.zeros_like(t[:1])])
                         for t in tpool))


def _same(tpool, jpool):
    np.testing.assert_array_equal(tpool.q.numpy(), np.asarray(jpool.q))
    np.testing.assert_array_equal(tpool.scale.numpy(),
                                  np.asarray(jpool.scale))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_pack_unpack_bit_identical():
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, size=(3, 2 * P, KV, HD)).astype(np.int8)
    tp = tq.pack_page_nibbles(torch.from_numpy(q))
    jp = jq.pack_page_nibbles(jnp.asarray(q))
    assert tp.dtype == torch.uint8
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    tu = tq.unpack_page_nibbles(tp)
    np.testing.assert_array_equal(tu.numpy(),
                                  np.asarray(jq.unpack_page_nibbles(jp)))
    np.testing.assert_array_equal(tu.numpy(), q)       # round trip


@pytest.mark.parametrize("fmt", FORMATS)
def test_prompt_pages_bit_identical(fmt):
    """Page-aligned prompt windows: a partial last window, an unmapped
    window, and n_real padding whose garbage must not enter a scale."""
    rng = np.random.default_rng(1)
    jpool, tpool = _pools(rng, fmt)
    S = 2 * P + 3
    vals = rng.normal(size=(1, S, KV, HD)).astype(np.float32)
    vals[:, P + 5:] *= 100.0                 # padding garbage past n_real
    row = np.array([7, -1, 2, 9], np.int32)
    for n_real in (None, P + 5):
        jn = None if n_real is None else jnp.int32(n_real)
        jp2 = j_prompt(jpool, *_j(vals, row), jn)
        tp2 = tq.qwrite_prompt_pages(
            type(tpool)(*(x.clone() for x in tpool)), *_t(vals, row),
            n_real)
        _same(tp2, jp2)


@pytest.mark.parametrize("fmt", FORMATS)
def test_update_pool_per_row_bit_identical(fmt):
    """Decode tokens: a page-edge position, a mid-page one, a row whose
    page is unmapped, an inactive row, and a token large enough to grow
    its page's scale (the residents re-quantize)."""
    rng = np.random.default_rng(2)
    jpool, tpool = _pools(rng, fmt)
    vals = rng.normal(size=(4, 1, KV, HD)).astype(np.float32)
    vals[1] *= 10.0
    table = np.array([[0, 1, -1], [2, 3, -1], [4, -1, 5], [6, 7, 8]],
                     np.int32)
    pos = np.array([P, 2 * P - 3, P + 1, 5], np.int32)
    active = np.array([True, True, True, False])
    jp2 = j_update(jpool, *_j(vals, pos, active, table))
    # the port's pool carries the sink page past the real ones, where the
    # rows JAX drops (the unmapped page, the inactive row) land
    tp2 = tq.qupdate_pool_per_row(_with_sink(tpool),
                                  *_t(vals, pos, active, table))
    _same(type(tp2)(tp2.q[:N], tp2.scale[:N]), jp2)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("pos0,n_real", [(3, None), (P - 2, 5), (2 * P, 1)])
def test_window_pages_bit_identical(fmt, pos0, n_real):
    """One chunk window at any offset: straddling page edges, padding
    past n_real (x100 garbage), a window running off a short table."""
    rng = np.random.default_rng(3)
    jpool, tpool = _pools(rng, fmt)
    C = P + 5
    vals = rng.normal(size=(1, C, KV, HD)).astype(np.float32)
    if n_real is not None:
        vals[:, n_real:] *= 100.0
    row = np.array([7, 2, 9], np.int32)
    jn = None if n_real is None else jnp.int32(n_real)
    jp2 = j_window(jpool, *_j(vals, row), jnp.int32(pos0), jn)
    tp2 = tq.qwrite_window_pages(tpool, *_t(vals, row), pos0, n_real)
    _same(tp2, jp2)


@pytest.mark.parametrize("fmt", FORMATS)
def test_windows_pages_bit_identical(fmt):
    """The batched mixed writer: a decode row, a chunk straddling a page
    edge, a chunk over an unmapped hole, an inactive row, an idle
    (q_len=0) row, and padding columns holding x100 garbage."""
    rng = np.random.default_rng(4)
    jpool, tpool = _pools(rng, fmt)
    C = 6
    vals = rng.normal(size=(5, C, KV, HD)).astype(np.float32)
    table = np.array([[0, 1, -1], [2, 3, -1], [4, -1, 5], [6, 7, -1],
                      [8, 9, -1]], np.int32)
    pos = np.array([P + 3, P - 2, P - 4, 0, 2], np.int32)
    q_len = np.array([1, 6, 6, 3, 0], np.int32)
    active = np.array([True, True, True, False, False])
    for b, n in enumerate(q_len):
        vals[b, n:] *= 100.0
    jp2 = j_windows(jpool, *_j(vals, pos, q_len, active, table))
    tp2 = tq.qwrite_windows_pages(tpool, *_t(vals, pos, q_len, active,
                                             table))
    _same(tp2, jp2)


@pytest.mark.parametrize("fmt", FORMATS)
def test_writes_into_fresh_pages_after_reset(fmt):
    """reset_page_scales zeroes the scales of the given pages in every
    layer; a decode token into such a page then sets its scale alone."""
    rng = np.random.default_rng(5)
    cfg_j, cfg_t = JConfig.tiny(num_hidden_layers=2), \
        LlamaConfig.tiny(num_hidden_layers=2)
    jcls = jq.Int4PagedKVCache if fmt == "int4" else \
        jq.QuantizedPagedKVCache
    tcls = tq.Int4PagedKVCache if fmt == "int4" else \
        tq.QuantizedPagedKVCache
    jc = jcls.create(cfg_j, 2, N, P, 4 * P)
    tc = tcls.create(cfg_t, 2, N, P, 4 * P, device="cpu")
    scale = rng.random(size=tuple(jc.k.scale.shape)).astype(np.float32)
    jc = jc._replace(k=jc.k._replace(scale=jnp.asarray(scale)),
                     v=jc.v._replace(scale=jnp.asarray(scale * 2)))
    tc.k.scale.copy_(torch.from_numpy(scale))
    tc.v.scale.copy_(torch.from_numpy(scale * 2))
    jc = jq.reset_page_scales(jc, [3, 7])
    tq.reset_page_scales(tc, [3, 7])
    for tp, jp in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_array_equal(tp.scale.numpy(), np.asarray(jp.scale))
    assert not tc.k.scale[:, [3, 7]].any()
    # one layer's leaves are views: a write through them lands in the cache
    tk, _ = tc.layer(1)
    jk = type(jc.k)(q=jc.k.q[1], scale=jc.k.scale[1])
    tok = rng.normal(size=(1, 1, cfg_t.num_key_value_heads,
                           cfg_t.head_dim)).astype(np.float32)
    table = np.array([[3, 7, -1, -1]], np.int32)
    args = (tok, np.array([P + 2], np.int32), np.array([True]), table)
    jk = j_update(jk, *_j(*args))
    tq.qupdate_pool_per_row(tk, *_t(*args))
    np.testing.assert_array_equal(tc.k.q[1].numpy(), np.asarray(jk.q))
    np.testing.assert_array_equal(tc.k.scale[1].numpy(),
                                  np.asarray(jk.scale))


@pytest.mark.parametrize("fmt", FORMATS)
def test_dequantize_pages_bit_identical(fmt):
    rng = np.random.default_rng(6)
    jpool, tpool = _pools(rng, fmt)
    idx = np.array([[3, 0], [N - 1, 5]], np.int32)
    np.testing.assert_array_equal(
        tq.dequantize_pages(tpool, torch.from_numpy(idx)).numpy(),
        np.asarray(jq.dequantize_pages(jpool, jnp.asarray(idx))))
    # out-of-range ids (the fold's unmapped pages) read as a zero page
    idx = np.array([2, N, N + 3, 0], np.int32)
    got = tq.dequantize_pages(tpool, torch.from_numpy(idx), fill_zero=True)
    want = jq.dequantize_pages(jpool, jnp.asarray(idx), fill_zero=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[1:3].any()


@pytest.mark.parametrize("fmt", FORMATS)
def test_caches_match_jax_shapes_and_bytes(fmt):
    """create(), the property surface, memory_bytes (scales counted) and
    page_bytes against the JAX caches, at the tiny and the 8B config."""
    jcls = jq.Int4PagedKVCache if fmt == "int4" else \
        jq.QuantizedPagedKVCache
    tcls = tq.Int4PagedKVCache if fmt == "int4" else \
        tq.QuantizedPagedKVCache
    for jcfg, tcfg in ((JConfig.tiny(), LlamaConfig.tiny()),
                       (JConfig.llama3_8b(), LlamaConfig.llama3_8b())):
        assert tq.page_bytes(tcfg, 128, fmt) == jq.page_bytes(jcfg, 128, fmt)
        for jd, td in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
            assert tq.page_bytes(tcfg, 128, td) == jq.page_bytes(jcfg, 128,
                                                                 jd)
    cfg_j, cfg_t = JConfig.tiny(num_hidden_layers=2), \
        LlamaConfig.tiny(num_hidden_layers=2)
    jc = jcls.create(cfg_j, 3, N, P, 4 * P)
    tc = tcls.create(cfg_t, 3, N, P, 4 * P, device="cpu")
    for name in ("page_size", "n_pages", "max_pages", "max_seq_len"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert tuple(tc.k.q.shape) == tuple(jc.k.q.shape)
    assert str(tc.k.q.dtype).split(".")[-1] == jc.k.q.dtype.name
    assert tuple(tc.k.scale.shape) == tuple(jc.k.scale.shape)
    np.testing.assert_array_equal(tc.table.numpy(), np.asarray(jc.table))
    # the storage holds one more page than JAX's, the sink
    assert tc.memory_bytes() == (jc.memory_bytes()
                                 + tq.page_bytes(cfg_t, P, fmt))
    assert tc.memory_bytes() == (N + 1) * tq.page_bytes(cfg_t, P, fmt)
    assert tuple(tc.layer(0)[0].q.shape)[0] == N + 1
    with pytest.raises(ValueError, match="must divide"):
        tcls.create(cfg_t, 1, N, P, 4 * P + 1, device="cpu")
    if fmt == "int4":
        with pytest.raises(ValueError, match="must be even"):
            tcls.create(cfg_t, 1, N, 7, 28, device="cpu")
