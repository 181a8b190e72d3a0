"""The port's ragged paged attention vs the JAX Pallas kernels.

On the CPU the wrappers run their plain versions (the online-softmax
folds); here those are held against the JAX kernels run in interpret
mode, as tests/test_ragged_paged_attn.py runs them, on every ragged
shape the engine produces: ragged positions, page boundaries, unmapped
holes, GQA group sizes 4/2/1, idle (q_len=0) rows and a bf16 pool. The
mixed kernel is compared on real query columns only (padding columns
are garbage in JAX and zeros in the port). Tolerance: 2e-5 at f32.

The CUDA kernels themselves build and run only on a card: the `cuda`
case holds each against its plain version there and skips elsewhere.
The JAX package is imported inside the JAX cases, so on the card (which
has no jax) the file still collects and its `cuda` case runs:

    python -m pytest --noconftest -m cuda tests/test_torch_ragged_paged_attn.py
"""

import numpy as np
import pytest

import torch

from cake_tpu_torch.models.llama.paged import (
    paged_attention, paged_attention_mixed,
)
from cake_tpu_torch.ops import ragged_paged_attention as rpa

P = 8           # page size
N_PAGES = 12
ATTN = dict(atol=2e-5, rtol=2e-5)


def _pool(rng, KV, hd, dtype=np.float32):
    k = rng.normal(size=(N_PAGES, P, KV, hd)).astype(dtype)
    v = rng.normal(size=(N_PAGES, P, KV, hd)).astype(dtype)
    return k, v


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays, dtype=None):
    import jax.numpy as jnp
    return [jnp.asarray(a, dtype) for a in arrays]


def _j_kernels():
    """The JAX Pallas kernels (run in interpret mode on the CPU)."""
    from cake_tpu.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_mixed,
    )
    return ragged_paged_attention, ragged_paged_attention_mixed


def _decode_parity(q, pk, pv, table, pos, tol=ATTN):
    j_rpa, _ = _j_kernels()
    want = np.asarray(j_rpa(*_j(q, pk, pv, table, pos), interpret=True))
    got = rpa.ragged_paged_attention(*_t(q, pk, pv, table, pos)).numpy()
    np.testing.assert_allclose(got, want, **tol)
    return got


def _mixed_parity(q, pk, pv, table, pos, qlen, tol=ATTN):
    _, j_rpa_mixed = _j_kernels()
    want = np.asarray(j_rpa_mixed(*_j(q, pk, pv, table, pos, qlen),
                                  interpret=True))
    got = rpa.ragged_paged_attention_mixed(
        *_t(q, pk, pv, table, pos, qlen)).numpy()
    for b in range(q.shape[0]):
        n = int(qlen[b])
        np.testing.assert_allclose(got[b, :n], want[b, :n], **tol)
        # padding columns (and a whole idle row) are zeros
        assert not got[b, n:].any()
    return got


DECODE_CASES = {
    # rows at different positions, partial last pages, a first token
    "ragged_pos": ([[7, 2, 9, -1, -1], [4, 11, -1, -1, -1],
                    [1, -1, -1, -1, -1]], [2 * P + 5, P + 3, 0]),
    # pos exactly at page edges: last slot of a page, first of the next
    "page_boundaries": ([[3, 6, 0, 10, 5]] * 4, [P - 1, P, 2 * P - 1, 2 * P]),
    # holes inside the live range and a fully unmapped row
    "unmapped_holes": ([[4, -1, 11, 3, -1], [-1, 2, 7, -1, -1],
                        [-1, -1, -1, -1, -1]], [3 * P + 2, 2 * P + 1, P + 4]),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_jax_kernel(case):
    rng = np.random.default_rng(0)
    table, pos = DECODE_CASES[case]
    table = np.asarray(table, np.int32)
    pos = np.asarray(pos, np.int32)
    pk, pv = _pool(rng, KV=2, hd=16)
    q = rng.normal(size=(len(pos), 1, 4, 16)).astype(np.float32)
    got = _decode_parity(q, pk, pv, table, pos)
    if case == "unmapped_holes":
        assert not got[2].any()          # the dead row emits zeros


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)])
def test_decode_plain_matches_jax_kernel_gqa(H, KV):
    rng = np.random.default_rng(3)
    pk, pv = _pool(rng, KV=KV, hd=16)
    q = rng.normal(size=(2, 1, H, 16)).astype(np.float32)
    table = np.asarray([[9, 1, 6, -1, -1], [0, 5, -1, -1, -1]], np.int32)
    pos = np.asarray([2 * P + 3, P + 6], np.int32)
    _decode_parity(q, pk, pv, table, pos)


def test_decode_plain_matches_jax_kernel_bf16_pool():
    """bf16 pool + bf16 queries (the serving dtype), at bf16 resolution."""
    rng = np.random.default_rng(4)
    pk, pv = _pool(rng, KV=2, hd=16)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    table = np.asarray([[7, 2, -1, -1, -1], [4, 11, 3, -1, -1]], np.int32)
    pos = np.asarray([P + 5, 2 * P + 7], np.int32)
    j_rpa, _ = _j_kernels()
    want = np.asarray(j_rpa(*_j(q, pk, pv, dtype="bfloat16"),
                            *_j(table, pos), interpret=True), np.float32)
    bf = [torch.from_numpy(a).bfloat16() for a in (q, pk, pv)]
    got = rpa.ragged_paged_attention(*bf, *_t(table, pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2,
                               rtol=3e-2)


MIXED_CASES = {
    # a decode row, a chunk straddling a page boundary, a mid-page start
    "decode_and_chunk_rows": (6, [[7, 2, 9, -1, -1], [4, 11, 3, -1, -1],
                                  [1, 8, -1, -1, -1]],
                              [2 * P + 5, P + 3, 3], [1, 6, 5]),
    # windows whose first token sits exactly at a page edge
    "page_boundary_offsets": (4, [[3, 6, 0, 10, 5]] * 4,
                              [P - 1, P, 2 * P - 1, 2 * P], [4, 4, 1, 3]),
    # an idle row (q_len=0) and a hole inside a chunk's window
    "idle_row_and_hole": (5, [[2, -1, 9, -1, -1], [4, 5, -1, -1, -1],
                              [6, 7, 8, -1, -1]],
                          [P + 2, 3, 2 * P], [5, 0, 2]),
}


@pytest.mark.parametrize("case", sorted(MIXED_CASES))
def test_mixed_plain_matches_jax_kernel(case):
    rng = np.random.default_rng(10)
    C, table, pos, qlen = MIXED_CASES[case]
    table = np.asarray(table, np.int32)
    pos = np.asarray(pos, np.int32)
    qlen = np.asarray(qlen, np.int32)
    pk, pv = _pool(rng, KV=2, hd=16)
    q = rng.normal(size=(len(pos), C, 4, 16)).astype(np.float32)
    _mixed_parity(q, pk, pv, table, pos, qlen)


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)])
def test_mixed_plain_matches_jax_kernel_gqa(H, KV):
    rng = np.random.default_rng(12)
    pk, pv = _pool(rng, KV=KV, hd=16)
    q = rng.normal(size=(2, 5, H, 16)).astype(np.float32)
    table = np.asarray([[9, 1, 6, -1, -1], [0, 5, 2, -1, -1]], np.int32)
    pos = np.asarray([2 * P + 3, P + 6], np.int32)
    qlen = np.asarray([1, 5], np.int32)
    _mixed_parity(q, pk, pv, table, pos, qlen)


def test_mixed_plain_matches_jax_kernel_bf16_pool():
    rng = np.random.default_rng(13)
    pk, pv = _pool(rng, KV=2, hd=16)
    q = rng.normal(size=(2, 4, 4, 16)).astype(np.float32)
    table = np.asarray([[7, 2, -1, -1, -1], [4, 11, 3, -1, -1]], np.int32)
    pos = np.asarray([P + 5, 2 * P + 2], np.int32)
    qlen = np.asarray([1, 4], np.int32)
    _, j_rpa_mixed = _j_kernels()
    want = np.asarray(j_rpa_mixed(
        *_j(q, pk, pv, dtype="bfloat16"), *_j(table, pos, qlen),
        interpret=True), np.float32)
    bf = [torch.from_numpy(a).bfloat16() for a in (q, pk, pv)]
    got = rpa.ragged_paged_attention_mixed(*bf, *_t(table, pos, qlen))
    got = got.float().numpy()
    for b, n in enumerate(qlen):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=3e-2,
                                   rtol=3e-2)


def test_cpu_wrappers_run_plain_versions_and_count():
    """A CPU tensor goes to the plain version (its counter moves, the
    kernel's does not); impl='kernel' refuses a CPU tensor."""
    rng = np.random.default_rng(20)
    pk, pv = _t(*_pool(rng, KV=2, hd=16))
    q = torch.from_numpy(rng.normal(size=(1, 3, 4, 16)).astype(np.float32))
    table = torch.tensor([[3, 4, -1, -1, -1]], dtype=torch.int32)
    pos = torch.tensor([5], dtype=torch.int32)
    qlen = torch.tensor([3], dtype=torch.int32)
    rpa.reset_launch_counts()
    paged_attention(q[:, :1], pk, pv, table, pos)
    paged_attention_mixed(q, pk, pv, table, pos, qlen, impl="plain")
    assert rpa.LAUNCHES == {"rpa_decode": 0, "rpa_mixed": 0,
                            "rpa_decode_plain": 1, "rpa_mixed_plain": 1}
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(q[:, :1], pk, pv, table, pos, impl="kernel")
    with pytest.raises(ValueError, match="unknown paged_attn"):
        paged_attention(q[:, :1], pk, pv, table, pos, impl="fold")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    """Each CUDA kernel against its plain version on the card (f32 atol
    1e-4; bf16 atol/rtol 2e-2 for output rounding and summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    dt = getattr(torch, dtype)
    tol = (dict(atol=1e-4, rtol=0.0) if dtype == "float32"
           else dict(atol=2e-2, rtol=2e-2))
    g = torch.Generator(device="cuda").manual_seed(0)
    N, Pg, KV, hd, H = 32, 128, 8, 128, 32
    pk = torch.randn((N, Pg, KV, hd), generator=g, device="cuda", dtype=dt)
    pv = torch.randn((N, Pg, KV, hd), generator=g, device="cuda", dtype=dt)
    table = torch.randperm(N, generator=g, device="cuda").to(
        torch.int32).reshape(4, 8).contiguous()
    table[1, 1] = -1
    table[3] = -1
    pos = torch.tensor([0, 300, 1023, 129], dtype=torch.int32,
                       device="cuda")
    q1 = torch.randn((4, 1, H, hd), generator=g, device="cuda", dtype=dt)
    got = rpa.ragged_paged_attention(q1, pk, pv, table, pos)
    want = rpa.ragged_paged_attention_plain(q1, pk, pv, table, pos)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    qlen = torch.tensor([1, 64, 0, 17], dtype=torch.int32, device="cuda")
    qm = torch.randn((4, 64, H, hd), generator=g, device="cuda", dtype=dt)
    got = rpa.ragged_paged_attention_mixed(qm, pk, pv, table, pos, qlen)
    want = rpa.ragged_paged_attention_mixed_plain(qm, pk, pv, table, pos,
                                                  qlen)
    torch.testing.assert_close(got.float(), want.float(), **tol)
