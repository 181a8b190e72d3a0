"""The port's flash attention vs the JAX Pallas kernels.

On the CPU the wrappers run their plain versions (masked f32 softmax
attention); here those are held against the JAX kernels run in
interpret mode with 16-row tiles, as tests/test_flash.py runs them:
causal at GQA group sizes 1/2/4, non-causal, a sliding window, bf16, and
the cache-aware kernel at several positions with a NaN-filled cache tail
past the write frontier. Tolerance: 2e-5 at f32 (the JAX flash tests'
own); 3e-2 at bf16 (the Pallas kernel rounds p to bf16 before p @ v, the
plain version keeps it in f32).

The CUDA kernels themselves build and run only on a card: the `cuda`
case holds each against its plain version there and skips elsewhere.
The JAX package is imported inside the JAX cases, so on the card (which
has no jax) the file still collects and its `cuda` case runs:

    python -m pytest --noconftest -m cuda tests/test_torch_flash.py
"""

import numpy as np
import pytest

import torch

from cake_tpu_torch.ops import flash_attention as fa

ATTN = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
BLOCKS = dict(block_q=16, block_k=16, interpret=True)


def _qkv(seed, B, S, T, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays, dtype=None):
    import jax.numpy as jnp
    return [jnp.asarray(a, dtype) for a in arrays]


def _j_flash():
    from cake_tpu.ops.flash_attention import (
        flash_attention, flash_attention_cached,
    )
    return flash_attention, flash_attention_cached


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)])
def test_flash_plain_matches_jax_kernel_causal(H, KV):
    j_flash, _ = _j_flash()
    q, k, v = _qkv(0, 2, 32, 32, H, KV, 16)
    want = np.asarray(j_flash(*_j(q, k, v), causal=True, **BLOCKS))
    fa.reset_launch_counts()
    got = fa.flash_attention(*_t(q, k, v), causal=True).numpy()
    np.testing.assert_allclose(got, want, **ATTN)
    assert fa.LAUNCHES["flash_attn_plain"] == 1
    assert fa.LAUNCHES["flash_attn"] == 0


def test_flash_plain_matches_jax_kernel_non_causal():
    j_flash, _ = _j_flash()
    q, k, v = _qkv(1, 1, 32, 48, 4, 2, 16)       # T > S
    want = np.asarray(j_flash(*_j(q, k, v), causal=False, **BLOCKS))
    got = fa.flash_attention(*_t(q, k, v), causal=False).numpy()
    np.testing.assert_allclose(got, want, **ATTN)


def test_flash_plain_matches_jax_kernel_window():
    """window=8 inside 16-key tiles: the JAX kernel skips tiles below
    every query's window, the plain version masks them."""
    j_flash, _ = _j_flash()
    q, k, v = _qkv(2, 2, 48, 48, 4, 2, 16)
    want = np.asarray(j_flash(*_j(q, k, v), causal=True, window=8,
                              **BLOCKS))
    got = fa.flash_attention(*_t(q, k, v), causal=True, window=8).numpy()
    np.testing.assert_allclose(got, want, **ATTN)


def test_flash_plain_matches_jax_kernel_bf16():
    j_flash, _ = _j_flash()
    q, k, v = _qkv(3, 1, 32, 32, 4, 2, 16)
    want = np.asarray(j_flash(*_j(q, k, v, dtype="bfloat16"), causal=True,
                              **BLOCKS), np.float32)
    got = fa.flash_attention(*[t.bfloat16() for t in _t(q, k, v)])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


@pytest.mark.parametrize("pos", [0, 16, 40])
def test_flash_cached_plain_matches_jax_kernel_nan_tail(pos):
    """Queries at pos..pos+15 over a 64-slot cache whose slots at or
    past the frontier pos + 16 hold NaN: both outputs finite and equal."""
    _, j_cached = _j_flash()
    S, T = 16, 64
    q, kc, vc = _qkv(4 + pos, 2, S, T, 4, 2, 16)
    kc[:, pos + S:] = np.nan
    vc[:, pos + S:] = np.nan
    want = np.asarray(j_cached(*_j(q, kc, vc), pos, **BLOCKS))
    fa.reset_launch_counts()
    got = fa.flash_attention_cached(*_t(q, kc, vc), pos).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **ATTN)
    assert fa.LAUNCHES["flash_attn_cached_plain"] == 1


def test_flash_cached_plain_matches_jax_kernel_window():
    _, j_cached = _j_flash()
    S, T, pos = 16, 64, 40
    q, kc, vc = _qkv(9, 1, S, T, 4, 2, 16)
    kc[:, pos + S:] = np.nan
    vc[:, pos + S:] = np.nan
    want = np.asarray(j_cached(*_j(q, kc, vc), pos, window=8, **BLOCKS))
    got = fa.flash_attention_cached(*_t(q, kc, vc), pos, window=8).numpy()
    np.testing.assert_allclose(got, want, **ATTN)


@pytest.mark.parametrize("shape", [
    (1, 1, 4, 1, 16),          # one query, one key; the tiny head dim
    (1024, 1024, 32, 8, 128),  # Llama-3-8B prefill
    (100, 300, 32, 8, 128),    # ragged S, T: no tile divisibility
    (256, 4096, 32, 8, 128),   # a chunk against the whole cache
    (64, 64, 32, 1, 64),       # group of 32 query heads
])
def test_hopper_gate_accepts(shape):
    assert fa.flash_supported(*shape)
    assert fa.flash_supported(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("shape,dtype", [
    ((64, 32, 4, 2, 16), None),          # T < S
    ((0, 32, 4, 2, 16), None),           # no query
    ((64, 64, 6, 4, 16), None),          # KV does not divide H
    ((64, 64, 64, 1, 64), None),         # 64 query heads per kv head
    ((64, 64, 4, 2, 256), None),         # head dim past 128
    ((64, 64, 4, 2, 18), None),          # head dim not a multiple of 4
    ((64, 64, 4, 2, 16), torch.float64),
])
def test_hopper_gate_rejects(shape, dtype):
    assert not fa.flash_supported(*shape, dtype=dtype)


def test_wrappers_validate_their_options():
    q, k, v = _t(*_qkv(5, 1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="window requires causal"):
        fa.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="window must be"):
        fa.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="runs past the cache"):
        fa.flash_attention_cached(q, k, v, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_cuda_kernels_match_plain_versions(dtype):
    """Each CUDA kernel against its plain version on the card (f32 atol
    1e-4; bf16/f16 atol/rtol 2e-2: output rounding, summation order, and
    p rounded to the value dtype before p @ v in the tensor-core body, as
    in the Pallas kernel): ragged S, a window, non-causal, the tiny head
    dim, and the cached kernel with a NaN tail and pos inside a key tile;
    two launches of flash_attn give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    dt = getattr(torch, dtype)
    tol = (dict(atol=1e-4, rtol=0.0) if dtype == "float32"
           else dict(atol=2e-2, rtol=2e-2))
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=dt)

    fa.reset_launch_counts()
    cases = [(2, 200, 200, 32, 8, 128, dict()),
             (1, 333, 333, 32, 8, 128, dict(window=50)),
             (1, 64, 96, 32, 8, 128, dict(causal=False)),
             (2, 37, 37, 4, 2, 16, dict())]
    if dtype != "float32":
        # the tensor-core body: G of 1 to 32 (64 / G query positions a
        # CTA), head dims 16 to 128 (20 is zero-padded to 32 in shared
        # memory and copied in 8-byte pieces), S off the 64-row tile, a
        # window, non-causal with S < T
        cases += [(1, 150, 150, 8, 8, 64, dict()),
                  (1, 97, 97, 16, 8, 20, dict()),
                  (1, 130, 130, 32, 4, 128, dict(window=70)),
                  (1, 45, 200, 32, 1, 64, dict(causal=False)),
                  (2, 77, 77, 32, 1, 16, dict()),
                  (1, 300, 300, 12, 4, 20, dict(window=33))]
    for B, S, T, H, KV, hd, kw in cases:
        q, k, v = rnd(B, S, H, hd), rnd(B, T, KV, hd), rnd(B, T, KV, hd)
        got = fa.flash_attention(q, k, v, **kw)
        again = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert torch.equal(got, again)
    S, T, pos = 96, 512, 133
    q, kc, vc = rnd(1, S, 32, 128), rnd(1, T, 8, 128), rnd(1, T, 8, 128)
    kc[:, pos + S:] = float("nan")
    vc[:, pos + S:] = float("nan")
    for kw in (dict(), dict(window=64)):
        got = fa.flash_attention_cached(q, kc, vc, pos, **kw)
        want = fa.flash_attention_cached_plain(q, kc, vc, pos, **kw)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), **tol)
    assert fa.LAUNCHES["flash_attn"] == 2 * len(cases)
    assert fa.LAUNCHES["flash_attn_cached"] == 2
