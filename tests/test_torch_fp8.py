"""fp8 KV storage in the port (--kv-dtype f8_e4m3 | f8_e5m2) against the
JAX package.

  * The names: `resolve_kv_dtype` takes JAX's --kv-dtype names (fp8
    included) to the same formats; `resolve_dtype` (--dtype) refuses fp8.
  * The writers' bytes: every paged writer and the dense cache's writer
    cast as JAX's `.astype(pool.dtype)` does, byte for byte over edge
    values from f32 and from bf16, e4m3 overflow (NaN in JAX, where
    torch alone would saturate to 448) included; a NaN written is NaN
    in both, its payload bits unpinned (XLA's own differ: e5m2 0x7e from
    a convert, 0x7f from the same convert fused into a scatter).
  * The plain versions of the ragged kernels over fp8 pools against
    JAX's fold (`paged_attention` / `paged_attention_mixed`,
    impl="fold"): f32 queries within 1e-5, bf16 queries within one bf16
    step (8e-3). Against the Pallas kernels (interpret mode, which runs
    fp8 page refs on the CPU) they differ by the p rounding: Pallas
    rounds p to the PAGE dtype before p v (3 or 2 mantissa bits), the
    fold and the port to q's; that gap is pinned here (ROADMAP C).
  * Greedy engine streams at f32 params over fp8 pools are
    token-identical to the JAX paged engine's, at decode_scan 1 and 4 and
    --mixed-batch auto and off; the dense generator over an fp8 cache is
    token-identical to JAX's; memory_bytes counts one byte an element.

The JAX package is imported inside the cases that use it, so on the card
(which has no jax) the file collects and its `cuda` cases run:

    python -m pytest --noconftest -m cuda tests/test_torch_fp8.py
"""

import numpy as np
import pytest

import torch

from cake_tpu_torch.args import Args
from cake_tpu_torch.models.llama import paged as tpaged
from cake_tpu_torch.models.llama.cache import update_layer_cache
from cake_tpu_torch.models.llama.config import LlamaConfig
from cake_tpu_torch.ops import ragged_paged_attention as rpa
from cake_tpu_torch.utils.devices import (
    resolve_dtype, resolve_kv_dtype, to_storage,
)

FP8 = {"f8_e4m3": torch.float8_e4m3fn, "f8_e5m2": torch.float8_e5m2}
P = 8
N_PAGES = 12
# every edge the two frameworks could disagree on: e4m3's largest finite
# value and the round-to-nearest-even cut above it (464 -> 448, more ->
# NaN), far overflow, e5m2's range, subnormals, signed zero, inf and NaN
EDGES = np.array([447, 448, 449, 455, 456, 463.9, 464, 464.1, 470, 480,
                  500, 1e4, 57344, 61440, 1e6, np.inf, 2 ** -6, 2 ** -9,
                  2 ** -10, 1.5 * 2 ** -10, 2 ** -17, 1e-30, 0.0, 3.14159,
                  0.1], np.float32)


def _jnp():
    import jax.numpy as jnp
    return jnp


def _jfp8(name):
    jnp = _jnp()
    return {"f8_e4m3": jnp.float8_e4m3fn, "f8_e5m2": jnp.float8_e5m2}[name]


def _edge_values(shape, seed=0):
    """f32 values of `shape`: every edge value with both signs and NaNs
    of both signs, the rest normal draws."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=int(np.prod(shape))).astype(np.float32)
    nans = np.array([0x7fc00000, 0xffc00000, 0x7f800001], np.uint32).view(
        np.float32)
    edges = np.concatenate([EDGES, -EDGES, nans])
    vals[:len(edges)] = edges
    rng.shuffle(vals)
    return vals.reshape(shape)


def _sources(vals):
    """(jax array, torch tensor) pairs holding the same bits: f32, and
    bf16 (round to nearest even)."""
    import ml_dtypes
    jnp = _jnp()
    with np.errstate(invalid="ignore"):     # the NaNs
        vb = vals.astype(ml_dtypes.bfloat16)
    tb = torch.from_numpy(vb.view(np.int16)).view(torch.bfloat16)
    return [("f32", jnp.asarray(vals), torch.from_numpy(vals)),
            ("bf16", jnp.asarray(vb), tb)]


def _bytes_j(a):
    return np.asarray(a).view(np.uint8)


def _bytes_t(t):
    return t.contiguous().view(torch.uint8).numpy()


def _assert_same_storage(got, want, err_msg=""):
    """fp8 bytes equal, but where JAX's value is NaN: NaN in both (the
    payload bits are not pinned)."""
    jnp = _jnp()
    want_nan = np.isnan(np.asarray(want.astype(jnp.float32)))
    got_nan = torch.isnan(got.float()).numpy()
    np.testing.assert_array_equal(got_nan, want_nan, err_msg=err_msg)
    np.testing.assert_array_equal(
        np.where(want_nan, 0, _bytes_t(got)),
        np.where(want_nan, 0, _bytes_j(want)), err_msg=err_msg)


# -- names --------------------------------------------------------------------


def test_kv_dtype_names_match_jax_and_dtype_refuses_fp8():
    from cake_tpu.utils import devices as jdev
    for name in jdev._KV_DTYPES:
        got = resolve_kv_dtype(name)
        want = np.dtype(jdev.resolve_kv_dtype(name)).name
        assert str(got).rsplit(".", 1)[-1] == want, name
        assert got.itemsize == np.dtype(jdev.resolve_kv_dtype(name)).itemsize
    for name in FP8:
        with pytest.raises(ValueError):
            jdev.resolve_dtype(name)
        with pytest.raises(ValueError, match="unknown dtype"):
            resolve_dtype(name)
    for bad in ("f8", "fp8", "int3"):
        with pytest.raises(ValueError):
            jdev.resolve_kv_dtype(bad)
        with pytest.raises(ValueError, match="unknown dtype"):
            resolve_kv_dtype(bad)
    for name in FP8:
        Args(kv_dtype=name).validate()
    with pytest.raises(ValueError, match="unknown dtype"):
        Args(kv_dtype="f8_e3m4").validate()


# -- the writers' bytes -------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FP8))
def test_to_storage_bytes_equal_jax_astype(name):
    vals = _edge_values((4, 64))
    for src, j, t in _sources(vals):
        _assert_same_storage(to_storage(t, FP8[name]), j.astype(_jfp8(name)),
                             err_msg=src)
    # the trap itself: torch alone saturates where XLA overflows to NaN
    x = torch.tensor([500.0, -1e4, 464.0])
    assert torch.isnan(to_storage(x, torch.float8_e4m3fn).float()[:2]).all()
    assert to_storage(x, torch.float8_e4m3fn).float()[2] == 448.0
    assert (x.to(torch.float8_e4m3fn).float().abs()[:2] == 448.0).all()


def _j_writers():
    from cake_tpu.models.llama import paged as jpaged
    return jpaged


@pytest.mark.parametrize("name", sorted(FP8))
def test_paged_writers_bytes_equal_jax(name):
    """update_pool_per_row (decode), write_windows_pages (mixed) and
    write_prompt_pages (prefill) over fp8 pools: the real pages' bytes
    equal JAX's after the same writes (the port's decode pool has its
    sink page past them)."""
    jnp = _jnp()
    jp = _j_writers()
    KV, hd, B, C = 2, 16, 3, 5
    table = np.array([[3, 7, -1], [0, 5, 9], [-1, -1, -1]], np.int32)
    pos = np.array([P + 2, 2 * P - 3, 4], np.int32)
    active = np.array([True, True, False])
    qlen = np.array([1, 5, 2], np.int32)
    for (src, kj, kt), (_, vj, vt) in zip(
            _sources(_edge_values((B, C, KV, hd), 1)),
            _sources(_edge_values((B, C, KV, hd), 3))):
        for writer in ("decode", "windows", "prompt"):
            zero_j = jnp.zeros((N_PAGES, P, KV, hd), _jfp8(name))
            sink = 1 if writer == "decode" else 0
            zero_t = torch.zeros((N_PAGES + sink, P, KV, hd), dtype=FP8[name])
            pk_t, pv_t = zero_t.clone(), zero_t.clone()
            if writer == "decode":
                pk_j, pv_j = jp.update_pool_per_row(
                    zero_j, zero_j, kj[:, :1], vj[:, :1], pos, active,
                    table)
                tpaged.update_pool_per_row(
                    pk_t, pv_t, kt[:, :1], vt[:, :1],
                    torch.from_numpy(pos), torch.from_numpy(active),
                    torch.from_numpy(table))
            elif writer == "windows":
                pk_j, pv_j = jp.write_windows_pages(
                    zero_j, zero_j, kj, vj, pos, qlen, active, table)
                tpaged.write_windows_pages(
                    pk_t, pv_t, kt, vt, torch.from_numpy(pos),
                    torch.from_numpy(qlen), torch.from_numpy(active),
                    torch.from_numpy(table))
            else:
                pk_j, pv_j = jp.write_prompt_pages(
                    zero_j, zero_j, kj[1:2, :], vj[1:2, :], table[1])
                tpaged.write_prompt_pages(
                    pk_t, pv_t, kt[1:2, :], vt[1:2, :],
                    torch.from_numpy(table[1]))
            for a, b in ((pk_j, pk_t), (pv_j, pv_t)):
                _assert_same_storage(b[:N_PAGES], a,
                                     err_msg=f"{writer} from {src}")
            if sink:
                assert _bytes_t(pk_t[:N_PAGES]).any()


@pytest.mark.parametrize("name", sorted(FP8))
def test_dense_cache_writer_bytes_equal_jax(name):
    from cake_tpu.models.llama.cache import update_layer_cache as j_write
    jnp = _jnp()
    for src, kj, kt in _sources(_edge_values((2, 6, 2, 16), 2)):
        kc_j = jnp.zeros((2, 16, 2, 16), _jfp8(name))
        kc_t = torch.zeros((2, 16, 2, 16), dtype=FP8[name])
        vc_t = kc_t.clone()
        for pos in (0, 7, 13):       # 13: shifted back to fit, as JAX
            kc_j, _ = j_write(kc_j, kc_j, kj, kj, pos)
            update_layer_cache(kc_t, vc_t, kt, kt, pos)
            _assert_same_storage(kc_t, kc_j, err_msg=f"{src} pos {pos}")


# -- the plain versions against JAX's fold and Pallas -------------------------


def _fp8_pools(name, rng, KV=2, hd=16):
    """(jax pools, torch pools) of the same fp8 bytes, from normals."""
    jnp = _jnp()
    k, v = (rng.normal(size=(N_PAGES, P, KV, hd)).astype(np.float32)
            for _ in range(2))
    js = [jnp.asarray(a).astype(_jfp8(name)) for a in (k, v)]
    ts = [to_storage(torch.from_numpy(a), FP8[name]) for a in (k, v)]
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(_bytes_t(b), _bytes_j(a))
    return js, ts


DECODE_TABLE = [[7, 2, 9, -1, -1], [4, -1, 11, 3, -1], [-1] * 5,
                [3, 6, 0, 10, 5]]
DECODE_POS = [2 * P + 5, 3 * P + 2, P + 4, 2 * P]
MIXED_QLEN = [1, 5, 3, 4]
QTOL = {"float32": dict(atol=1e-5, rtol=1e-5),
        "bfloat16": dict(atol=8e-3, rtol=8e-3)}
# the largest |port - Pallas| allowed over these unit-normal pools, about
# twice the measured gaps (e4m3 0.0151 decode, 0.0224 mixed; e5m2 0.0250,
# 0.0429): Pallas rounds p to the page dtype for p v
PALLAS_GAP = {"f8_e4m3": 0.04, "f8_e5m2": 0.08}


def _q(rng, shape, dt):
    jnp = _jnp()
    x = rng.normal(size=shape).astype(np.float32)
    jd = jnp.float32 if dt == "float32" else jnp.bfloat16
    jq = jnp.asarray(x).astype(jd)
    return jq, torch.from_numpy(np.array(jq.astype(jnp.float32))).to(
        getattr(torch, dt))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FP8))
def test_plain_versions_match_jax_fold_over_fp8_pools(name, dt):
    from cake_tpu.models.llama.paged import (
        paged_attention as j_pa, paged_attention_mixed as j_pam,
    )
    jnp = _jnp()
    rng = np.random.default_rng(5)
    (jk, jv), (tk, tv) = _fp8_pools(name, rng)
    table = np.asarray(DECODE_TABLE, np.int32)
    pos = np.asarray(DECODE_POS, np.int32)
    qlen = np.asarray(MIXED_QLEN, np.int32)
    jq, tq = _q(rng, (4, 1, 4, 16), dt)
    want = np.asarray(j_pa(jq, jk, jv, jnp.asarray(table), jnp.asarray(pos),
                           impl="fold").astype(jnp.float32))
    rpa.reset_launch_counts()
    got = rpa.ragged_paged_attention(tq, tk, tv, torch.from_numpy(table),
                                     torch.from_numpy(pos))
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), want, **QTOL[dt])
    assert not got[2].any()                       # the dead row
    jq, tq = _q(rng, (4, 5, 4, 16), dt)
    want = np.asarray(j_pam(jq, jk, jv, jnp.asarray(table), jnp.asarray(pos),
                            jnp.asarray(qlen), impl="fold").astype(
                                jnp.float32))
    got = rpa.ragged_paged_attention_mixed(
        tq, tk, tv, torch.from_numpy(table), torch.from_numpy(pos),
        torch.from_numpy(qlen)).float().numpy()
    for b, n in enumerate(qlen):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **QTOL[dt])
        assert not got[b, n:].any()
    # fp8 pages count under their own kernels' plain names
    suffix = "_f8e4m3" if name == "f8_e4m3" else "_f8e5m2"
    assert rpa.LAUNCHES["rpa_decode" + suffix + "_plain"] == 1
    assert rpa.LAUNCHES["rpa_mixed" + suffix + "_plain"] == 1
    assert rpa.LAUNCHES["rpa_decode_plain"] == 0


@pytest.mark.parametrize("name", sorted(FP8))
def test_pallas_rounds_p_to_the_page_dtype(name):
    """The Pallas bodies (interpret mode) run fp8 page refs, and differ
    from the fold (which the port follows) by rounding p to the page
    dtype before p v: a gap far above the fold's 1e-5, bounded by
    PALLAS_GAP, and the same gap between JAX's own fold and Pallas."""
    from cake_tpu.models.llama.paged import paged_attention as j_pa
    from cake_tpu.ops.ragged_paged_attention import (
        ragged_paged_attention as j_rpa,
        ragged_paged_attention_mixed as j_rpam,
    )
    jnp = _jnp()
    rng = np.random.default_rng(6)
    (jk, jv), (tk, tv) = _fp8_pools(name, rng)
    table = np.asarray(DECODE_TABLE, np.int32)
    pos = np.asarray(DECODE_POS, np.int32)
    qlen = np.asarray(MIXED_QLEN, np.int32)
    jq, tq = _q(rng, (4, 1, 4, 16), "float32")
    args = (jnp.asarray(table), jnp.asarray(pos))
    pallas = np.asarray(j_rpa(jq, jk, jv, *args, interpret=True))
    fold = np.asarray(j_pa(jq, jk, jv, *args, impl="fold"))
    got = rpa.ragged_paged_attention(tq, tk, tv, torch.from_numpy(table),
                                     torch.from_numpy(pos)).numpy()
    gap = np.abs(got - pallas).max()
    print(f"{name} decode: |port - Pallas| {gap:.4g}, |port - fold| "
          f"{np.abs(got - fold).max():.3g}")
    assert 1e-3 < gap <= PALLAS_GAP[name], gap
    np.testing.assert_allclose(np.abs(fold - pallas).max(), gap, atol=1e-5)
    jq, tq = _q(rng, (4, 5, 4, 16), "float32")
    pallas = np.asarray(j_rpam(jq, jk, jv, *args, jnp.asarray(qlen),
                               interpret=True))
    got = rpa.ragged_paged_attention_mixed(
        tq, tk, tv, torch.from_numpy(table), torch.from_numpy(pos),
        torch.from_numpy(qlen)).numpy()
    gap = max(np.abs(got[b, :n] - pallas[b, :n]).max()
              for b, n in enumerate(qlen))
    print(f"{name} mixed: |port - Pallas| {gap:.4g}")
    assert 1e-3 < gap <= PALLAS_GAP[name], gap


def test_fp8_pages_take_the_fp8_kernels_gates():
    """The kernel table's codes and names: fp8 pools have codes of their
    own (uint8 stays packed int4), take the tensor-core mixed body under
    bf16 queries, and rpa_cta under f32 ones."""
    assert rpa._KV_CODES[torch.float8_e4m3fn] == 4
    assert rpa._KV_CODES[torch.float8_e5m2] == 5
    assert rpa._KV_CODES[torch.uint8] == 3
    for name, dt in FP8.items():
        pool = torch.zeros((5, 4, 2, 128), dtype=dt)
        for qdt, want in ((torch.bfloat16, True), (torch.float32, False)):
            q = torch.zeros((2, 3, 4, 128), dtype=qdt)
            assert rpa.mixed_takes_tc(q, pool, pool) is want
        assert rpa.kernel_name("rpa_mixed", kv_dtype=dt) == (
            "rpa_mixed_" + name.replace("_", ""))
    assert rpa.kernel_name("rpa_decode", kv_dtype=torch.bfloat16) == \
        "rpa_decode"


# -- the engine and the dense generator against JAX ---------------------------


@pytest.fixture(scope="module")
def models():
    import jax
    import jax.numpy as jnp
    from cake_tpu.models.llama.config import LlamaConfig as JConfig
    from cake_tpu.models.llama.params import init_params as j_init
    from cake_tpu_torch.models.llama.params import params_from_numpy

    jc = JConfig.tiny(num_hidden_layers=2)
    jp = j_init(jc, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, LlamaConfig.tiny(num_hidden_layers=2), tp


PROMPTS = [[5] * 9, [3, 7, 9, 11, 2, 8, 6, 1, 9, 4, 3, 2, 7],
           [2, 9, 4, 7, 3]]
ENGINE_KW = dict(max_seq_len=64, kv_pages=16, kv_page_size=16,
                 prefill_chunk=8)
_JAX_RUNS: dict = {}


def _drive(eng):
    with eng:
        hs = [eng.submit(p, max_new_tokens=12, temperature=0.0,
                         repeat_penalty=1.1) for p in PROMPTS]
        assert all(h.wait(timeout=300) for h in hs)
    return [list(h._req.out_tokens) for h in hs]


def _jax_streams(models, kv, mixed):
    import jax.numpy as jnp
    from cake_tpu.models.llama.generator import ByteTokenizer as JTok
    from cake_tpu.ops.sampling import SamplingConfig as JSampling
    from cake_tpu.serve.engine import InferenceEngine as JEngine

    key = (kv, mixed)
    if key not in _JAX_RUNS:
        jc, jp, _, _ = models
        eng = JEngine(jc, jp, JTok(jc.vocab_size),
                      sampling=JSampling(temperature=0.0),
                      cache_dtype=jnp.float32, paged_attn="fold",
                      mixed_batch=mixed, kv_dtype=kv, **ENGINE_KW)
        assert eng.cache.k.dtype == _jfp8(kv)
        _JAX_RUNS[key] = _drive(eng)
    return _JAX_RUNS[key]


def _port_engine(tc, tp, device="cpu", **kw):
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    args = dict(ENGINE_KW, **kw)
    return InferenceEngine(tc, tp, ByteTokenizer(tc.vocab_size),
                           device=device,
                           sampling=SamplingConfig(temperature=0.0),
                           cache_dtype=torch.float32, **args)


@pytest.mark.parametrize("scan", [1, 4])
@pytest.mark.parametrize("mixed", ["auto", "off"])
@pytest.mark.parametrize("kv", sorted(FP8))
def test_engine_streams_token_identical_to_jax_over_fp8_pools(models, kv,
                                                              mixed, scan):
    _, _, tc, tp = models
    want = _jax_streams(models, kv, mixed)
    eng = _port_engine(tc, tp, mixed_batch=mixed, kv_dtype=kv,
                       decode_scan_steps=scan)
    assert eng.cache.k.dtype == FP8[kv]
    rpa.reset_launch_counts()
    got = _drive(eng)
    assert got == want
    suffix = "_f8e4m3" if kv == "f8_e4m3" else "_f8e5m2"
    assert rpa.LAUNCHES["rpa_decode" + suffix + "_plain"] > 0
    assert rpa.LAUNCHES["rpa_decode_plain"] == 0
    assert eng._pager.free_pages == eng.cache.n_pages


def test_fp8_pool_bytes_and_step_cost(models):
    """memory_bytes counts one byte an element, the sink page included
    (JAX's pool with one more page has the same bytes); the step cost's
    pool bytes a token are a quarter of an f32 pool's."""
    import jax.numpy as jnp
    from cake_tpu.models.llama.paged import PagedKVCache as JCache
    from cake_tpu_torch.kv.quantized_pool import page_bytes

    jc, _, tc, tp = models
    for kv, dt in FP8.items():
        t = tpaged.PagedKVCache.create(tc, 2, 6, 16, 64, dtype=dt,
                                       device="cpu")
        j = JCache.create(jc, 2, 7, 16, 64, dtype=_jfp8(kv))
        assert t.memory_bytes() == j.memory_bytes()
        assert t.memory_bytes() == 7 * page_bytes(tc, 16, kv)
        f8 = _port_engine(tc, tp, kv_dtype=kv)
        f32 = _port_engine(tc, tp)
        assert f8._kv_bytes_per_token * 4 == f32._kv_bytes_per_token
    assert jnp.dtype(_jfp8("f8_e4m3")).itemsize == 1


def _generators(models, kv, flash, prefill_chunk):
    import dataclasses
    from cake_tpu.models.llama import generator as jgen
    from cake_tpu.ops import sampling as jsmp
    from cake_tpu_torch.models.llama import generator as tgen
    from cake_tpu_torch.ops import sampling as tsmp

    jc, jp, _, tp = models
    jc = dataclasses.replace(jc, use_flash_attention=flash)
    tc = LlamaConfig.tiny(num_hidden_layers=2, use_flash_attention=flash)
    j = jgen.LlamaGenerator(
        jc, jp, jgen.ByteTokenizer(jc.vocab_size), max_seq_len=256,
        sampling=jsmp.SamplingConfig(temperature=0.0, repeat_penalty=1.1),
        cache_dtype=_jfp8(kv), prefill_chunk=prefill_chunk)
    t = tgen.LlamaGenerator(
        tc, tp, tgen.ByteTokenizer(tc.vocab_size), max_seq_len=256,
        sampling=tsmp.SamplingConfig(temperature=0.0, repeat_penalty=1.1),
        cache_dtype=FP8[kv], prefill_chunk=prefill_chunk, device="cpu")
    return j, t


def _stream(gen, message_cls, n=8):
    gen.add_message(message_cls.user("hello there, sky"))
    return [gen.next_token(i).id for i in range(n)]


@pytest.mark.parametrize("flash,prefill_chunk", [(False, None),
                                                 (True, None), (False, 16)])
@pytest.mark.parametrize("kv", sorted(FP8))
def test_dense_generator_over_fp8_cache_matches_jax(models, kv, flash,
                                                    prefill_chunk):
    """The JAX generator tests' fp8 cases (tests/test_generator.py): the
    cache really is one byte an element, greedy generation is
    deterministic across a reset, and here token-identical to JAX's."""
    from cake_tpu.models.chat import Message as JMessage
    from cake_tpu_torch.models.chat import Message

    j, t = _generators(models, kv, flash, prefill_chunk)
    assert t.cache.k.dtype == FP8[kv] and t.cache.k.element_size() == 1
    want = _stream(j, JMessage)
    got = _stream(t, Message)
    assert got == want
    t.reset()
    assert _stream(t, Message) == got
    np.testing.assert_array_equal(_bytes_t(t.cache.k[:, :, :t.index_pos]),
                                  _bytes_j(j.cache.k[:, :, :j.index_pos]))


# -- on the card --------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")


def _graph_replay(fn):
    """fn() eagerly, and the same call captured in a CUDA graph and
    replayed: (eager output, replayed output)."""
    eager = fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                         # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        replayed = fn()
    replayed.zero_()                 # the replay, not the capture, fills it
    graph.replay()
    torch.cuda.synchronize()
    return eager, replayed


def _card_fp8_case(g, dt, P, B, MP, pos_l, C=1, qlen_l=None, qdt=None):
    """An fp8 pool (written from normals through to_storage, NaN bytes in
    every page no row reaches), a permuted table with a hole and a dead
    row, queries."""
    KV, hd, H = 8, 128, 32
    N = B * MP + 4
    vals = torch.randn((2, N, P, KV, hd), generator=g, device="cuda")
    pk, pv = (to_storage(x, dt) for x in vals)
    table = torch.randperm(N, generator=g, device="cuda")[:B * MP].to(
        torch.int32).reshape(B, MP).contiguous()
    used = torch.zeros(N, dtype=torch.bool, device="cuda")
    used[table.flatten().long()] = True
    for pool in (pk, pv):
        pool.view(torch.uint8)[~used] = 0x7F     # NaN in both formats
    table[1, 1] = -1
    table[B - 1] = -1
    q = torch.randn((B, C, H, hd), generator=g, device="cuda",
                    dtype=qdt or torch.bfloat16)
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    out = [q, pk, pv, table, pos]
    if qlen_l is not None:
        out.append(torch.tensor(qlen_l, dtype=torch.int32, device="cuda"))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FP8))
def test_cuda_fp8_kernels_match_plain_versions(name, qdt):
    """The fp8 split decode body and the fp8 mixed bodies (tensor-core
    under bf16 queries, rpa_cta under f32) against their plain versions
    on the card: a row of 8192 slots (64 table columns, many splits)
    beside short ones, rows ending at page and split edges, a hole, a
    dead row (exact zeros), NaN bytes in unread pages; chunk rows at odd
    offsets, an idle row. f32 queries atol 1e-4; bf16 atol/rtol 2e-2
    (output rounding; the tensor-core body rounds p to bf16). Two
    launches give the same bits, one call counts one launch under the
    fp8 name, and a captured call replays to the same bits."""
    _cuda_or_skip()
    dt, qd = FP8[name], getattr(torch, qdt)
    tol = (dict(atol=1e-4, rtol=0.0) if qdt == "float32"
           else dict(atol=2e-2, rtol=2e-2))
    suffix = "_f8e4m3" if name == "f8_e4m3" else "_f8e5m2"
    g = torch.Generator(device="cuda").manual_seed(21)
    P = 128
    args = _card_fp8_case(g, dt, P, 6, 64,
                          [8191, 300, P - 1, 16 * P, 0, 1000], qdt=qd)
    splits, _ = rpa.split_plan(6, 8, 64, P, rpa.sm_count("cuda"))
    assert splits > 1
    rpa.reset_launch_counts()
    got = rpa.ragged_paged_attention(*args)
    again = rpa.ragged_paged_attention(*args)
    torch.cuda.synchronize()
    assert rpa.LAUNCHES["rpa_decode" + suffix] == 2
    want = rpa.ragged_paged_attention_plain(*args)
    assert torch.isfinite(got[:5].float()).all()
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again) and not got[5].any()
    eager, replayed = _graph_replay(lambda: rpa.ragged_paged_attention(*args))
    assert torch.equal(eager, replayed)
    qlen = [1, 64, 37, 0, 64, 1]
    args = _card_fp8_case(g, dt, P, 6, 18, [2047, 5 * P + 7, 3 * P - 5, 9,
                                            64, 0], C=64, qlen_l=qlen,
                          qdt=qd)
    assert rpa.mixed_takes_tc(*args[:3]) is (qdt == "bfloat16")
    rpa.reset_launch_counts()
    got = rpa.ragged_paged_attention_mixed(*args)
    again = rpa.ragged_paged_attention_mixed(*args)
    torch.cuda.synchronize()
    assert rpa.LAUNCHES["rpa_mixed" + suffix] == 2
    want = rpa.ragged_paged_attention_mixed_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert torch.equal(got, again)
    for b, n in enumerate(qlen):
        assert not got[b, n:].any()
    assert not got[5].any()
    eager, replayed = _graph_replay(
        lambda: rpa.ragged_paged_attention_mixed(*args))
    assert torch.equal(eager, replayed)


@pytest.mark.cuda
@pytest.mark.parametrize("scan", [1, 4])
def test_cuda_engine_over_fp8_pool_matches_the_cpu_engine(scan):
    """The engine on the card over an fp8 e4m3 pool (both steps captured,
    the fp8 kernels) gives the CPU engine's greedy streams (f32 params:
    the kernels' f32 summation-order differences stay below a token
    flip on this tiny model), and every page returns."""
    _cuda_or_skip()
    from cake_tpu_torch.models.llama.params import init_params

    runs = []
    for device in ("cpu", "cuda"):
        cfg = LlamaConfig.tiny(num_hidden_layers=2)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu", dtype=torch.float32)
        params = {k: ({n: t.to(device) for n, t in v.items()}
                      if isinstance(v, dict) else v.to(device))
                  for k, v in params.items()}
        eng = _port_engine(cfg, params, device=device, kv_dtype="f8_e4m3",
                           decode_scan_steps=scan)
        rpa.reset_launch_counts()
        runs.append(_drive(eng))
        assert eng._pager.free_pages == eng.cache.n_pages
        if device == "cuda":
            assert rpa.LAUNCHES["rpa_mixed_f8e4m3"] > 0
            assert not any(n for k, n in rpa.LAUNCHES.items()
                           if k.endswith("_plain"))
    assert runs[1] == runs[0]
