"""The port's ragged paged attention vs the JAX Pallas kernels.

On the CPU the wrappers run their plain versions (the online-softmax
folds); here those are held against the JAX kernels run in interpret
mode, as tests/test_ragged_paged_attn.py runs them, on every ragged
shape the engine produces: ragged positions, page boundaries, unmapped
holes, GQA group sizes 4/2/1, idle (q_len=0) rows and a bf16 pool. The
mixed kernel is compared on real query columns only (padding columns
are garbage in JAX and zeros in the port). Tolerance: 2e-5 at f32.
The decode's plain version folds the table columns in the splits of
the CUDA kernel's plan (`split_plan`) and merges them in order, so the
parity cases around split boundaries pin that merge against the JAX
kernel at several groupings.

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


@pytest.mark.parametrize("B,KV,max_pages,P,n_sm", [
    (8, 8, 16, 128, 132),     # the serving shapes: a split a page
    (8, 8, 64, 128, 132),     # one long row's table: 64 splits
    (32, 8, 16, 128, 132),    # many rows
    (1, 1, 1, 128, 132),      # one page
    (3, 2, 5, 8, 132),        # the tiny config: a split per column
    (6, 2, 6, 8, 12),         # a split boundary at column 3
    (2, 8, 7, 16, 132),       # ragged last split
    (64, 8, 128, 16, 8),      # more CTAs than the target already
    (8, 8, 64, 16, 132),      # short pages: SPLIT_SLOTS bounds a split
])
def test_split_plan_covers_every_column_once(B, KV, max_pages, P, n_sm):
    """The decode's split plan, from shapes alone: every table column in
    exactly one split, splits of whole columns (so on page boundaries),
    1 <= splits <= max_pages, no split past SPLIT_SLOTS slots unless a
    page alone is longer, and at least one CTA an SM where the columns
    allow it (the plan aims at two)."""
    splits, pps = rpa.split_plan(B, KV, max_pages, P, n_sm)
    assert 1 <= splits <= max_pages and pps >= 1
    cols = [j for s in range(splits)
            for j in range(s * pps, min((s + 1) * pps, max_pages))]
    assert cols == list(range(max_pages))
    assert (splits - 1) * pps < max_pages <= splits * pps
    assert pps * P <= max(P, rpa.SPLIT_SLOTS)
    assert B * KV * splits >= min(n_sm, B * KV * max_pages)


# rows around the split boundaries of a 6-column table at G = 2: a live
# range ending on the last slot of a split and on the first of the next,
# -1 holes at a boundary, pos = 0, a row with every page unmapped
SPLIT_TABLE = [[3, 6, 0, 10, 5, 1], [4, 11, -1, -1, 2, 9],
               [7, 8, 9, 1, 2, 3], [-1, -1, -1, -1, -1, -1],
               [5, 2, 8, 11, 0, 6], [9, 10, 4, 7, 3, 1]]
SPLIT_POS = [2 * P - 1, 5 * P + 3, 0, 3 * P + 1, 3 * P - 1, 2 * P]


SPLIT_GROUPINGS = [(132, 1), (18, 2), (12, 3), (6, 6)]


@pytest.mark.parametrize("n_sm,pps,fmt", [
    pytest.param(n_sm, pps, fmt,
                 id=f"{n_sm}-{pps}" + ("" if fmt == "f32" else f"-{fmt}"))
    for fmt in ("f32", "q8", "q4") for n_sm, pps in SPLIT_GROUPINGS])
def test_decode_plain_matches_jax_kernel_split_boundaries(monkeypatch, n_sm,
                                                          pps, fmt):
    """The plain version folds the kernel's splits and merges them in
    order, over f32 pages and over int8 (q8) and int4 (q4) pages written
    by the JAX package's qwrite_prompt_pages; at every grouping it agrees
    with the JAX kernel (`_rpa_kernel`, `_rpa_kernel_q8`, `_rpa_kernel_q4`
    in interpret mode; f32, the file's tolerance), and the dead row is
    exactly zero."""
    monkeypatch.setattr(rpa, "CPU_SM_COUNT", n_sm)
    table = np.asarray(SPLIT_TABLE, np.int32)
    pos = np.asarray(SPLIT_POS, np.int32)
    assert rpa.split_plan(len(pos), 2, table.shape[1], P, n_sm)[1] == pps
    rng = np.random.default_rng(30 + pps)
    pk, pv = (_pool(rng, KV=2, hd=16) if fmt == "f32"
              else _qpools(rng, fmt, KV=2, hd=16))
    q = rng.normal(size=(len(pos), 1, 4, 16)).astype(np.float32)
    got = (_decode_parity(q, pk, pv, table, pos) if fmt == "f32"
           else _q_parity(fmt, q, pk, pv, table, pos))
    assert not got[3].any()


@pytest.mark.parametrize("B,C,H,KV,hd,max_pages,P,n_sm", [
    (8, 64, 32, 8, 128, 16, 128, 132),   # the serving shapes: 4 splits
    (1, 64, 32, 8, 128, 16, 128, 132),   # one row: splits of 2 pages
    (8, 64, 32, 8, 128, 132, 16, 132),   # 16-token pages, a long table
    (32, 512, 32, 8, 128, 64, 128, 132),  # big chunks: the scratch cap
    (3, 5, 4, 2, 16, 5, 8, 132),         # the tiny config: one split
    (6, 5, 4, 2, 16, 6, 8, 12),          # few SMs
    (2, 1, 64, 8, 256, 7, 16, 132),      # C = 1, hd 256
    (4, 64, 32, 8, 128, 1, 128, 132),    # one page
])
def test_mixed_split_plan_covers_every_column_once(B, C, H, KV, hd,
                                                   max_pages, P, n_sm):
    """The mixed step's split plan, from shapes alone: every table
    column in exactly one split, splits of whole columns (so on page
    boundaries), 1 <= splits <= max_pages, no split shorter than
    MIXED_MIN_SLOTS unless the table is, the partials within
    MIXED_SCRATCH_BYTES unless one split exceeds it alone, and a long
    row's kv heads on at least two CTAs an SM where the slots allow."""
    splits, pps = rpa.mixed_split_plan(B, C, H, KV, hd, max_pages, P, n_sm)
    assert 1 <= splits <= max_pages and pps >= 1
    cols = [j for s in range(splits)
            for j in range(s * pps, min((s + 1) * pps, max_pages))]
    assert cols == list(range(max_pages))
    assert (splits - 1) * pps < max_pages <= splits * pps
    assert pps * P >= min(rpa.MIXED_MIN_SLOTS, max_pages * P)
    part = 4 * splits * B * C * H * (hd + 2)
    assert splits == 1 or part <= rpa.MIXED_SCRATCH_BYTES
    by_slots = -(-max_pages * P // rpa.MIXED_MIN_SLOTS)
    if part <= rpa.MIXED_SCRATCH_BYTES // 2:
        assert B * KV * splits >= min(2 * n_sm, B * KV * by_slots)


# chunk and decode rows around the split boundaries of the 6-column
# SPLIT_TABLE at G = 2: a window straddling a page (and split) boundary,
# a decode row past -1 holes, a window from pos 0, a dead row, an idle
# (q_len = 0) row, a window starting on a boundary
MIXED_SPLIT_POS = [2 * P - 3, 5 * P + 3, 0, 3 * P + 1, 3 * P - 1, 2 * P]
MIXED_SPLIT_QLEN = [5, 1, 5, 3, 0, 4]


@pytest.mark.parametrize("n_sm,pps", [(132, 1), (18, 2), (12, 3), (6, 6)])
def test_mixed_plain_matches_jax_kernel_split_boundaries(monkeypatch, n_sm,
                                                         pps):
    """The mixed plain version folds the splits of mixed_split_plan and
    merges them in order; at every grouping it agrees with the JAX
    kernel on the real columns (f32, the file's tolerance), padding
    columns, the idle row and the dead row are exactly zero."""
    monkeypatch.setattr(rpa, "CPU_SM_COUNT", n_sm)
    monkeypatch.setattr(rpa, "MIXED_MIN_SLOTS", P)
    table = np.asarray(SPLIT_TABLE, np.int32)
    pos = np.asarray(MIXED_SPLIT_POS, np.int32)
    qlen = np.asarray(MIXED_SPLIT_QLEN, np.int32)
    C = 5
    assert rpa.mixed_split_plan(len(pos), C, 4, 2, 16, table.shape[1], P,
                                n_sm)[1] == pps
    rng = np.random.default_rng(40 + pps)
    pk, pv = _pool(rng, KV=2, hd=16)
    q = rng.normal(size=(len(pos), C, 4, 16)).astype(np.float32)
    got = _mixed_parity(q, pk, pv, table, pos, qlen)
    assert not got[3].any()


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
    want = dict.fromkeys(rpa.LAUNCHES, 0)
    assert rpa.LAUNCHES == dict(want, rpa_decode_plain=1, rpa_mixed_plain=1)
    # quantized pages count under their own kernels' plain names
    rpa.reset_launch_counts()
    scales = torch.ones((N_PAGES, 2))
    i8 = pk.to(torch.int8)
    rpa.ragged_paged_attention(q[:, :1], i8, i8, table, pos,
                               scale_k=scales, scale_v=scales)
    u8 = i8[:, :P // 2].to(torch.uint8)
    rpa.ragged_paged_attention_mixed(q, u8, u8, table, pos, qlen,
                                     scale_k=scales, scale_v=scales,
                                     packed4=True)
    assert rpa.LAUNCHES == dict(want, rpa_decode_q8_plain=1,
                                rpa_mixed_q4_plain=1)
    with pytest.raises(ValueError, match="packed4 pools require"):
        rpa.ragged_paged_attention(q[:, :1], u8, u8, table, pos,
                                   packed4=True)
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
    assert not got[3].any()
    qlen = torch.tensor([1, 64, 0, 17], dtype=torch.int32, device="cuda")
    qm = torch.randn((4, 64, H, hd), generator=g, device="cuda", dtype=dt)
    got = rpa.ragged_paged_attention_mixed(qm, pk, pv, table, pos, qlen)
    want = rpa.ragged_paged_attention_mixed_plain(qm, pk, pv, table, pos,
                                                  qlen)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_split_decode_long_rows_and_boundaries(dtype):
    """rpa_decode's split body and merge against the plain version on
    the card: a row of 8192 slots (64 table columns) beside short ones;
    rows ending on the last slot of a split and on the first of the
    next, a -1 hole at a split boundary, pos = 0, a dead row (exactly
    zero); G = 16 and head dims whose slot rows are not 16-byte
    multiples (narrower copies); two launches give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    dt = getattr(torch, dtype)
    tol = (dict(atol=1e-4, rtol=0.0) if dtype == "float32"
           else dict(atol=2e-2, rtol=2e-2))
    g = torch.Generator(device="cuda").manual_seed(3)
    Pg, MP = 128, 64
    for B, H, KV, hd in ((6, 32, 8, 128), (6, 32, 2, 20), (6, 8, 8, 17),
                         (6, 16, 4, 256)):
        N = 96
        pk = torch.randn((N, Pg, KV, hd), generator=g, device="cuda",
                         dtype=dt)
        pv = torch.randn((N, Pg, KV, hd), generator=g, device="cuda",
                         dtype=dt)
        table = torch.randint(0, N, (B, MP), generator=g, device="cuda",
                              dtype=torch.int32)
        splits, pps = rpa.split_plan(B, KV, MP, Pg, rpa.sm_count("cuda"))
        assert splits > 1
        table[2, pps] = -1          # a hole at the first split boundary
        table[2, pps - 1] = -1
        table[5] = -1               # a dead row
        pos = torch.tensor([8191, pps * Pg - 1, 2 * pps * Pg + 7, 0,
                            pps * Pg, 3000], dtype=torch.int32,
                           device="cuda")
        q = torch.randn((B, 1, H, hd), generator=g, device="cuda", dtype=dt)
        got = rpa.ragged_paged_attention(q, pk, pv, table, pos)
        again = rpa.ragged_paged_attention(q, pk, pv, table, pos)
        want = rpa.ragged_paged_attention_plain(q, pk, pv, table, pos)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert torch.equal(got, again)
        assert not got[5].any()


def _graph_replay(fn):
    """fn() run eagerly and from a captured CUDA graph: (eager, replayed)
    outputs. The call must read nothing back to the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        replayed = fn()
    replayed.zero_()                 # the replay, not the capture, fills it
    graph.replay()
    torch.cuda.synchronize()
    return eager, replayed


# (page size, H, KV, hd): P 16 and 128, G = 1, 2, 4, 8, 16, hd 64 and 128
MIXED_TC_CASES = [(16, 32, 8, 128), (128, 32, 8, 128), (16, 8, 8, 64),
                  (128, 16, 8, 64), (16, 32, 4, 128), (128, 32, 2, 64)]
# rows: idle (q_len 0), a decode row at 2047 (long enough to split), a
# 37-column chunk at an odd page offset, a 64-column chunk straddling key
# tiles from just below a page edge with a -1 hole, a dead row, a decode
# row at pos 0
MIXED_TC_POS = lambda P: [100, 2047, 5 * P + 7, 3 * P - 5, 64, 0]  # noqa
MIXED_TC_QLEN = [0, 1, 37, 64, 64, 1]


def _mixed_tc_inputs(g, P, H, KV, hd, dt, C=64):
    """Pools whose every page belongs to one row (a permuted table), with
    NaN in each row's slots past its last query and in unused pages."""
    pos_l, ql = MIXED_TC_POS(P), MIXED_TC_QLEN
    B = len(pos_l)
    MP = -(-(2048 + C) // P)
    N = B * MP + 4
    pk = torch.randn((N, P, KV, hd), generator=g, device="cuda", dtype=dt)
    pv = torch.randn((N, P, KV, hd), generator=g, device="cuda", dtype=dt)
    table = torch.randperm(N, generator=g, device="cuda")[:B * MP].to(
        torch.int32).reshape(B, MP).contiguous()
    stale = torch.ones((N, P), dtype=torch.bool, device="cuda")
    for b in range(B):
        last = pos_l[b] + max(ql[b], 1) - 1
        for j in range(MP):
            live = min(P, max(0, last - j * P + 1))
            stale[table[b, j], :live] = False
    pk[stale] = float("nan")
    pv[stale] = float("nan")
    table[3, 1] = -1                 # an unmapped hole inside a chunk's range
    table[4] = -1                    # a dead row
    q = torch.randn((B, C, H, hd), generator=g, device="cuda", dtype=dt)
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    qlen = torch.tensor(ql, dtype=torch.int32, device="cuda")
    return q, pk, pv, table, pos, qlen


@pytest.mark.cuda
def test_cuda_mixed_tensor_core_body_matches_plain():
    """rpa_mixed over bf16 pages runs rpa_mixed_tc (split by pages and
    merged in order): against its plain version (atol/rtol 2e-2: p
    rounded to bf16 before p v, output rounding) for every
    MIXED_TC_CASES pair of page size, grouping and head dim, with NaN in
    every stale slot; padding columns, the idle and the dead row exactly
    zero; two launches give the same bits; one call counts one launch;
    a call captured in a CUDA graph replays to the same bits. hd 256 and
    an f32 pool still take rpa_cta and match at their tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    g = torch.Generator(device="cuda").manual_seed(8)
    for P, H, KV, hd in MIXED_TC_CASES:
        args = _mixed_tc_inputs(g, P, H, KV, hd, torch.bfloat16)
        q, pk, table = args[0], args[1], args[3]
        assert rpa.mixed_takes_tc(q, pk, args[2])
        B, C = q.shape[:2]
        splits, _ = rpa.mixed_split_plan(B, C, H, KV, hd, table.shape[1], P,
                                         rpa.sm_count("cuda"))
        assert splits > 1
        rpa.reset_launch_counts()
        got = rpa.ragged_paged_attention_mixed(*args)
        again = rpa.ragged_paged_attention_mixed(*args)
        torch.cuda.synchronize()
        assert rpa.LAUNCHES["rpa_mixed"] == 2
        want = rpa.ragged_paged_attention_mixed_plain(*args)
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
        assert torch.equal(got, again)
        for b, n in enumerate(MIXED_TC_QLEN):
            assert not got[b, n:].any()
        assert not got[4].any()
    eager, replayed = _graph_replay(
        lambda: rpa.ragged_paged_attention_mixed(*args))
    assert torch.equal(eager, replayed)
    # one split: the body writes the output itself (a short table)
    q, pk, pv, table, pos, qlen = args
    short = table[:, :2].contiguous()
    pos_s = torch.clamp(pos, max=P - 1)
    assert rpa.mixed_split_plan(B, C, H, KV, hd, 2, P, 132)[0] == 1
    got = rpa.ragged_paged_attention_mixed(q, pk, pv, short, pos_s, qlen)
    want = rpa.ragged_paged_attention_mixed_plain(q, pk, pv, short, pos_s,
                                                  qlen)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    # hd 256 (bf16) and an f32 pool keep rpa_cta
    for P, H, KV, hd, dt, tol in ((128, 16, 4, 256, torch.bfloat16, 2e-2),
                                  (16, 32, 8, 128, torch.float32, 1e-4)):
        args = _mixed_tc_inputs(g, P, H, KV, hd, dt)
        assert not rpa.mixed_takes_tc(*args[:3])
        got = rpa.ragged_paged_attention_mixed(*args)
        want = rpa.ragged_paged_attention_mixed_plain(*args)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol if dt != torch.float32 else 0.0)
        assert not got[4].any() and not got[0].any()


# -- int8 / int4 pages --------------------------------------------------------
#
# The port's plain versions over quantized pages (each page dequantized in
# f32 and folded, as the JAX fold does) against the JAX Pallas bodies
# `_rpa_kernel_q8` / `_rpa_mixed_kernel_q8` / `_rpa_kernel_q4` /
# `_rpa_mixed_kernel_q4` in interpret mode, which scale the dot outputs
# instead: 2e-5 at f32, real query columns only. The pools are written by
# the JAX package's own prompt writer, so every page has its own scales.

QFORMATS = ("q8", "q4")


def _qpools(rng, fmt, KV, hd):
    """(k, v) as numpy (q, scale) pairs, written by qwrite_prompt_pages
    (jitted, as the JAX engine runs it)."""
    import jax
    import jax.numpy as jnp
    from cake_tpu.kv.quantized_pool import (
        Int4Pool, QuantPool, qwrite_prompt_pages,
    )

    def one():
        if fmt == "q8":
            pool = QuantPool(q=jnp.zeros((N_PAGES, P, KV, hd), jnp.int8),
                             scale=jnp.zeros((N_PAGES, KV), jnp.float32))
        else:
            pool = Int4Pool(q=jnp.zeros((N_PAGES, P // 2, KV, hd),
                                        jnp.uint8),
                            scale=jnp.zeros((N_PAGES, KV), jnp.float32))
        vals = rng.normal(size=(1, N_PAGES * P, KV, hd)).astype(np.float32)
        pool = jax.jit(qwrite_prompt_pages)(
            pool, jnp.asarray(vals), jnp.arange(N_PAGES, dtype=jnp.int32))
        return np.array(pool.q), np.array(pool.scale)

    return one(), one()


def _q_parity(fmt, q, pk, pv, table, pos, qlen=None, tol=ATTN):
    """Port plain version vs the JAX Pallas body (interpret) on real
    columns; returns the port's output."""
    j_rpa, j_rpa_mixed = _j_kernels()
    kw = dict(packed4=fmt == "q4")
    rest = (table, pos) if qlen is None else (table, pos, qlen)
    want = np.asarray((j_rpa if qlen is None else j_rpa_mixed)(
        *_j(q, pk[0], pv[0], *rest), scale_k=_j(pk[1])[0],
        scale_v=_j(pv[1])[0], interpret=True, **kw))
    tk, tv = _t(*pk), _t(*pv)
    fn = (rpa.ragged_paged_attention if qlen is None
          else rpa.ragged_paged_attention_mixed)
    rpa.reset_launch_counts()
    got = fn(*_t(q), tk[0], tv[0], *_t(*rest), scale_k=tk[1],
             scale_v=tv[1], **kw).numpy()
    base = "rpa_decode" if qlen is None else "rpa_mixed"
    assert rpa.LAUNCHES[f"{base}_{fmt}_plain"] == 1
    n_real = np.ones(len(pos), int) if qlen is None else qlen
    for b, n in enumerate(n_real):
        np.testing.assert_allclose(got[b, :n], want[b, :n], **tol)
        assert not got[b, n:].any()
    return got


@pytest.mark.parametrize("fmt", QFORMATS)
def test_quant_decode_plain_matches_jax_kernel_page_boundaries(fmt):
    """Page-edge positions: the live page count flips at
    ceil((pos+1)/P) in real tokens, with scales following the pages."""
    rng = np.random.default_rng(20)
    pk, pv = _qpools(rng, fmt, KV=2, hd=16)
    q = rng.normal(size=(4, 1, 4, 16)).astype(np.float32)
    table = np.asarray([[3, 6, 0, 10, 5]] * 4, np.int32)
    pos = np.asarray([P - 1, P, 2 * P - 1, 2 * P], np.int32)
    _q_parity(fmt, q, pk, pv, table, pos)


@pytest.mark.parametrize("fmt", QFORMATS)
@pytest.mark.parametrize("H,KV", [(8, 2), (6, 3), (4, 4)])
def test_quant_decode_plain_matches_jax_kernel_gqa(fmt, H, KV):
    """Each query group reads its own kv head's scale."""
    rng = np.random.default_rng(21)
    pk, pv = _qpools(rng, fmt, KV=KV, hd=16)
    q = rng.normal(size=(2, 1, H, 16)).astype(np.float32)
    table = np.asarray([[9, 1, 6, -1, -1], [0, 5, -1, -1, -1]], np.int32)
    pos = np.asarray([2 * P + 3, P + 6], np.int32)
    _q_parity(fmt, q, pk, pv, table, pos)


@pytest.mark.parametrize("fmt", QFORMATS)
def test_quant_decode_plain_matches_jax_kernel_unmapped_holes(fmt):
    """-1 holes inside the live range (page 0's scale must not leak in)
    and a fully unmapped row, which gives zeros."""
    rng = np.random.default_rng(22)
    pk, pv = _qpools(rng, fmt, KV=2, hd=16)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    table = np.asarray([[4, -1, 11, 3, -1], [-1, 2, 7, -1, -1],
                        [-1, -1, -1, -1, -1]], np.int32)
    pos = np.asarray([3 * P + 2, 2 * P + 1, P + 4], np.int32)
    got = _q_parity(fmt, q, pk, pv, table, pos)
    assert not got[2].any()


@pytest.mark.parametrize("fmt", QFORMATS)
def test_quant_decode_plain_matches_jax_kernel_hole_at_split_boundary(
        monkeypatch, fmt):
    """Splits of three columns (n_sm = 12) over a quantized pool, with
    -1 holes on both sides of the split boundary (columns 2 and 3): a row
    ending in the hole, a row whose whole first split is unmapped, a row
    whose second split is unmapped up to its last page, and a row that
    ends on the boundary's first slot. Each agrees with the JAX kernel
    (2e-5); an empty split adds nothing, and no unmapped id's scale
    (page 0's, were it clamped) reaches a row."""
    monkeypatch.setattr(rpa, "CPU_SM_COUNT", 12)
    table = np.asarray([[3, 6, -1, -1, 5, 1], [-1, -1, -1, 10, 2, 9],
                        [7, 8, 9, -1, -1, 3], [5, 2, -1, -1, 0, 6],
                        [9, 10, 4, 7, 3, 1], [0, 0, -1, -1, 0, 0]],
                       np.int32)
    pos = np.asarray([3 * P + 4, 4 * P + 2, 5 * P + 1, 3 * P, 3 * P,
                      4 * P + 7], np.int32)
    assert rpa.split_plan(len(pos), 2, table.shape[1], P, 12) == (2, 3)
    rng = np.random.default_rng(25)
    pk, pv = _qpools(rng, fmt, KV=2, hd=16)
    q = rng.normal(size=(len(pos), 1, 4, 16)).astype(np.float32)
    _q_parity(fmt, q, pk, pv, table, pos)


@pytest.mark.parametrize("fmt", QFORMATS)
def test_quant_mixed_plain_matches_jax_kernel_offsets_and_holes(fmt):
    """A decode row, a chunk straddling a page edge at an odd offset (for
    int4 the straddle crosses the packed low/high nibble halves), a
    chunk behind an unmapped hole, and an idle (q_len=0) row."""
    rng = np.random.default_rng(23)
    pk, pv = _qpools(rng, fmt, KV=2, hd=16)
    q = rng.normal(size=(4, 6, 4, 16)).astype(np.float32)
    table = np.asarray([[7, 2, 9, -1, -1], [4, 11, 3, -1, -1],
                        [-1, 8, 5, -1, -1], [-1, -1, -1, -1, -1]], np.int32)
    pos = np.asarray([2 * P + 5, P + 3, P + 2, 0], np.int32)
    qlen = np.asarray([1, 6, 4, 0], np.int32)
    _q_parity(fmt, q, pk, pv, table, pos, qlen)


@pytest.mark.parametrize("fmt", QFORMATS)
@pytest.mark.parametrize("H,KV", [(8, 2), (6, 3), (4, 4)])
def test_quant_mixed_plain_matches_jax_kernel_gqa(fmt, H, KV):
    rng = np.random.default_rng(24)
    pk, pv = _qpools(rng, fmt, KV=KV, hd=16)
    q = rng.normal(size=(2, 5, H, 16)).astype(np.float32)
    table = np.asarray([[9, 1, 6, -1, -1], [0, 5, 2, -1, -1]], np.int32)
    pos = np.asarray([2 * P + 3, P + 6], np.int32)
    qlen = np.asarray([1, 5], np.int32)
    _q_parity(fmt, q, pk, pv, table, pos, qlen)


# chunk and decode rows around the split boundaries of a 6-column table
# over quantized pages at G = 2 (P = 8, so an int4 page's high nibbles hold
# its slots 4..7): -1 holes on both sides of the boundary at column 3; a
# 7-column chunk from slot 18 straddling page 2's P/2 (slot 20) and the
# page (and split) edge at slot 24; a row whose first three columns (its
# whole first split at every grouping) are unmapped; an idle row; a decode
# row on the first slot past the boundary; a dead row
QMIXED_SPLIT_TABLE = [[3, 6, -1, -1, 5, 1], [4, 11, 7, 8, 2, 9],
                      [-1, -1, -1, 10, 2, 9], [5, 2, 8, 11, 0, 6],
                      [9, 10, 4, 7, 3, 1], [-1, -1, -1, -1, -1, -1]]
QMIXED_SPLIT_POS = [4 * P + 2, 2 * P + 2, 4 * P + 1, 3 * P - 1, 3 * P, P + 1]
QMIXED_SPLIT_QLEN = [5, 7, 3, 0, 1, 2]


@pytest.mark.parametrize("n_sm,pps", [(132, 1), (18, 2), (12, 3)])
@pytest.mark.parametrize("fmt", QFORMATS)
def test_quant_mixed_plain_matches_jax_kernel_split_boundaries(monkeypatch,
                                                               fmt, n_sm,
                                                               pps):
    """The mixed plain version over int8 (q8) and packed int4 (q4) pages
    folds the splits of mixed_split_plan, planned with the real page size,
    and merges them in order; at every grouping it agrees with the JAX
    kernel (`_rpa_mixed_kernel_q8` / `_q4` in interpret mode; f32, the
    file's tolerance) on the real columns, and padding columns, the idle
    and the dead row are exactly zero."""
    monkeypatch.setattr(rpa, "CPU_SM_COUNT", n_sm)
    monkeypatch.setattr(rpa, "MIXED_MIN_SLOTS", P)
    table = np.asarray(QMIXED_SPLIT_TABLE, np.int32)
    pos = np.asarray(QMIXED_SPLIT_POS, np.int32)
    qlen = np.asarray(QMIXED_SPLIT_QLEN, np.int32)
    C = 7
    assert rpa.mixed_split_plan(len(pos), C, 4, 2, 16, table.shape[1], P,
                                n_sm)[1] == pps
    rng = np.random.default_rng(50 + pps)
    pk, pv = _qpools(rng, fmt, KV=2, hd=16)
    q = rng.normal(size=(len(pos), C, 4, 16)).astype(np.float32)
    got = _q_parity(fmt, q, pk, pv, table, pos, qlen)
    assert not got[3].any() and not got[5].any()


# (q dtype, page dtype, head dim, byte offset of the pools) -> whether
# rpa_mixed runs the tensor-core body
TC_GATE = {
    "bf16_pages": ("bfloat16", "bfloat16", 128, 0, True),
    "int8_pages": ("bfloat16", "int8", 128, 0, True),
    "int4_pages": ("bfloat16", "uint8", 128, 0, True),
    "int8_hd_20": ("bfloat16", "int8", 20, 0, True),
    "f32_q_int8": ("float32", "int8", 128, 0, False),
    "f32_q_int4": ("float32", "uint8", 128, 0, False),
    "int8_hd_256": ("bfloat16", "int8", 256, 0, False),
    "int4_hd_256": ("bfloat16", "uint8", 256, 0, False),
    "int8_rows_18_bytes": ("bfloat16", "int8", 18, 0, False),
    "int4_rows_6_bytes": ("bfloat16", "uint8", 6, 0, False),
    "int8_pool_at_2_bytes": ("bfloat16", "int8", 128, 2, False),
}


@pytest.mark.parametrize("case", sorted(TC_GATE))
def test_mixed_takes_tc_gate(case):
    """The tensor-core gate reads only dtypes, shapes and pointers (CPU
    tensors here): bf16 queries over bf16, int8 and packed int4 pages
    with hd <= 128 and 4-byte aligned rows take rpa_mixed_tc; f32
    queries over quantized pages, hd > 128, page rows that are not
    4-byte multiples and pools off a 4-byte boundary keep rpa_cta."""
    qdt, pdt, hd, off, want = TC_GATE[case]
    q = torch.zeros((2, 3, 4, hd), dtype=getattr(torch, qdt))
    n = 5 * 4 * 2 * hd
    buf = torch.zeros(n + off, dtype=getattr(torch, pdt))
    pool = buf[off:].view(5, 4, 2, hd)
    scale = None if pdt == "bfloat16" else torch.ones((5, 2))
    assert (pool.data_ptr() % 4 == 0) == (off == 0)
    assert rpa.mixed_takes_tc(q, pool, pool, scale) is want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_quant_kernels_match_plain_versions(dtype):
    """The four quantized CUDA kernels (int8 and int4 pages, decode and
    mixed) against their plain versions on the card, at 128-token pages
    with a hole and a dead row. f32 queries: atol 1e-4 (summation
    order); bf16 queries: atol/rtol 2e-2 (the plain version rounds the
    dequantized K/V and p to bf16, as the JAX fold does; the decode
    kernel keeps them in f32, and the mixed kernel, the tensor-core body,
    keeps K/V exact and rounds p times the v scale to bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    from cake_tpu_torch.kv.quantized_pool import (
        Int4Pool, QuantPool, qwrite_prompt_pages,
    )
    dt = getattr(torch, dtype)
    tol = (dict(atol=1e-4, rtol=0.0) if dtype == "float32"
           else dict(atol=2e-2, rtol=2e-2))
    g = torch.Generator(device="cuda").manual_seed(1)
    N, Pg, KV, hd, H = 32, 128, 8, 128, 32
    table = torch.randperm(N, generator=g, device="cuda").to(
        torch.int32).reshape(4, 8).contiguous()
    table[1, 1] = -1
    table[3] = -1
    pos = torch.tensor([0, 300, 1023, 129], dtype=torch.int32,
                       device="cuda")
    qlen = torch.tensor([1, 64, 0, 17], dtype=torch.int32, device="cuda")
    q1 = torch.randn((4, 1, H, hd), generator=g, device="cuda", dtype=dt)
    qm = torch.randn((4, 64, H, hd), generator=g, device="cuda", dtype=dt)
    every = torch.arange(N, dtype=torch.int32, device="cuda")
    for cls, store, packed4 in ((QuantPool, torch.int8, False),
                                (Int4Pool, torch.uint8, True)):
        rows = Pg // 2 if packed4 else Pg
        pools = []
        for _ in range(2):
            pool = cls(torch.zeros((N, rows, KV, hd), dtype=store,
                                   device="cuda"),
                       torch.zeros((N, KV), device="cuda"))
            vals = torch.randn((1, N * Pg, KV, hd), generator=g,
                               device="cuda")
            pools.append(qwrite_prompt_pages(pool, vals, every))
        (kq, ks), (vq, vs) = pools
        kw = dict(scale_k=ks, scale_v=vs, packed4=packed4)
        got = rpa.ragged_paged_attention(q1, kq, vq, table, pos, **kw)
        want = rpa.ragged_paged_attention_plain(q1, kq, vq, table, pos, **kw)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert not got[3].any()
        got = rpa.ragged_paged_attention_mixed(qm, kq, vq, table, pos, qlen,
                                               **kw)
        want = rpa.ragged_paged_attention_mixed_plain(qm, kq, vq, table, pos,
                                                      qlen, **kw)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        with pytest.raises(ValueError, match="pool dtype"):
            rpa.ragged_paged_attention(q1, kq.float(), vq.float(), table,
                                       pos, **kw)


def _mixed_tc_qinputs(g, P, H, KV, hd, fmt, C=64):
    """((q, pool_k, pool_v, table, pos, q_len), scale kwargs): the
    MIXED_TC rows at bf16 over an int8 (q8) or packed int4 (q4) pool
    written by the port's qwrite_prompt_pages from normal draws. Page 0
    is in no table and its k and v scales are NaN, so a -1 read as page
    0 would show."""
    from cake_tpu_torch.kv.quantized_pool import (
        Int4Pool, QuantPool, qwrite_prompt_pages,
    )
    pos_l, ql = MIXED_TC_POS(P), MIXED_TC_QLEN
    B = len(pos_l)
    MP = -(-(2048 + C) // P)
    N = B * MP + 4
    packed = fmt == "q4"
    cls, store, rows = ((Int4Pool, torch.uint8, P // 2) if packed
                        else (QuantPool, torch.int8, P))
    every = torch.arange(N, dtype=torch.int32, device="cuda")
    pools = []
    for _ in range(2):
        pool = cls(torch.zeros((N, rows, KV, hd), dtype=store,
                               device="cuda"),
                   torch.zeros((N, KV), device="cuda"))
        vals = torch.randn((1, N * P, KV, hd), generator=g, device="cuda")
        pools.append(qwrite_prompt_pages(pool, vals, every))
    (pk, sk), (pv, sv) = pools
    sk[0] = float("nan")
    sv[0] = float("nan")
    table = (torch.randperm(N - 1, generator=g, device="cuda")[:B * MP]
             + 1).to(torch.int32).reshape(B, MP).contiguous()
    table[3, 1] = -1                 # an unmapped hole inside a chunk's range
    table[4] = -1                    # a dead row
    q = torch.randn((B, C, H, hd), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    qlen = torch.tensor(ql, dtype=torch.int32, device="cuda")
    return (q, pk, pv, table, pos, qlen), dict(scale_k=sk, scale_v=sv,
                                               packed4=packed)


@pytest.mark.cuda
def test_cuda_quant_mixed_tensor_core_body_matches_plain():
    """rpa_mixed_q8 / rpa_mixed_q4 over bf16 queries run rpa_mixed_tc
    (raw int8 / packed int4 rows converted to exact bf16 integers in
    shared memory, scales applied per key on the fragments, split by
    pages and merged in order): against their plain versions (atol/rtol
    2e-2: p times the v scale rounded to bf16 before p v, the plain
    version's K/V rounded to bf16, output rounding) for every
    MIXED_TC_CASES pair and a head dim of 20 (zero-padded columns), with
    page 0's scales NaN and page 0 in no table; padding columns, the
    idle and the dead row exactly zero; two launches give the same bits;
    one call counts one launch; a call captured in a CUDA graph replays
    to the same bits. f32 queries over an int8 pool, hd 256 and rows of
    18 bytes still take rpa_cta and match at their tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    g = torch.Generator(device="cuda").manual_seed(9)
    for fmt in QFORMATS:
        name = f"rpa_mixed_{fmt}"
        for P, H, KV, hd in MIXED_TC_CASES + [(16, 8, 2, 20)]:
            args, kw = _mixed_tc_qinputs(g, P, H, KV, hd, fmt)
            q, pk, pv, table = args[:4]
            assert rpa.mixed_takes_tc(q, pk, pv, kw["scale_k"])
            B, C = q.shape[:2]
            splits, _ = rpa.mixed_split_plan(B, C, H, KV, hd, table.shape[1],
                                             P, rpa.sm_count("cuda"))
            assert splits > 1
            rpa.reset_launch_counts()
            got = rpa.ragged_paged_attention_mixed(*args, **kw)
            again = rpa.ragged_paged_attention_mixed(*args, **kw)
            torch.cuda.synchronize()
            assert rpa.LAUNCHES[name] == 2
            want = rpa.ragged_paged_attention_mixed_plain(*args, **kw)
            assert torch.isfinite(got.float()).all()
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                       rtol=2e-2)
            assert torch.equal(got, again)
            for b, n in enumerate(MIXED_TC_QLEN):
                assert not got[b, n:].any()
            assert not got[4].any()
        eager, replayed = _graph_replay(
            lambda: rpa.ragged_paged_attention_mixed(*args, **kw))
        assert torch.equal(eager, replayed)
    # f32 q over an int8 pool, hd 256 and 18-byte rows keep rpa_cta
    for P, H, KV, hd, fmt, f32 in ((16, 32, 8, 128, "q8", True),
                                   (128, 16, 4, 256, "q8", False),
                                   (16, 8, 2, 18, "q8", False),
                                   (16, 8, 2, 18, "q4", False)):
        args, kw = _mixed_tc_qinputs(g, P, H, KV, hd, fmt)
        if f32:
            args = (args[0].float(),) + args[1:]
        assert not rpa.mixed_takes_tc(*args[:3], kw["scale_k"])
        rpa.reset_launch_counts()
        got = rpa.ragged_paged_attention_mixed(*args, **kw)
        want = rpa.ragged_paged_attention_mixed_plain(*args, **kw)
        assert rpa.LAUNCHES[f"rpa_mixed_{fmt}"] == 1
        tol = dict(atol=1e-4, rtol=0.0) if f32 else dict(atol=2e-2,
                                                         rtol=2e-2)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert not got[4].any() and not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_quant_split_decode_long_rows_and_boundaries(dtype):
    """rpa_decode_q8 / rpa_decode_q4 run the split body (rpa_split +
    rpa_merge) over int8 and nibble-packed int4 pages: against their
    plain versions (f32 queries atol 1e-4; bf16 atol/rtol 2e-2, the
    plain version rounding the dequantized K/V to bf16) at 16-, 48- and
    128-token pages (P/2 = 8, 24, 64 packed rows: a tile of packed rows
    is consumed as low, then high nibbles); a row at pos 8191 beside
    short ones, rows ending on the last slot of a split and on the first
    of the next, -1 holes on both sides of a split boundary, pos = 0, a
    dead row (exactly zero); G = 1, 4 and 16, head dims 17 and 20 (slot
    rows of odd and 4-byte multiples, copied in 1- and 4-byte pieces),
    128 and 256. Two launches give the same bits, one call counts one
    launch, and a call captured in a CUDA graph replays to the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    dt = getattr(torch, dtype)
    tol = (dict(atol=1e-4, rtol=0.0) if dtype == "float32"
           else dict(atol=2e-2, rtol=2e-2))
    g = torch.Generator(device="cuda").manual_seed(5)
    B, N = 6, 96
    for store, packed4 in ((torch.int8, False), (torch.uint8, True)):
        name = "rpa_decode_q4" if packed4 else "rpa_decode_q8"
        lo, hi = (0, 256) if packed4 else (-127, 128)
        for Pg in (16, 48, 128):
            MP = -(-8192 // Pg)
            for H, KV, hd in ((32, 8, 128), (32, 2, 20), (8, 8, 17),
                              (16, 4, 256)):
                rows = Pg // 2 if packed4 else Pg
                pk, pv = (torch.randint(lo, hi, (N, rows, KV, hd),
                                        generator=g, device="cuda",
                                        dtype=torch.int32).to(store)
                          for _ in range(2))
                sk = torch.rand((N, KV), generator=g, device="cuda") / 64
                sv = torch.rand((N, KV), generator=g, device="cuda") / 64
                kw = dict(scale_k=sk, scale_v=sv, packed4=packed4)
                table = torch.randint(0, N, (B, MP), generator=g,
                                      device="cuda", dtype=torch.int32)
                splits, pps = rpa.split_plan(B, KV, MP, Pg,
                                             rpa.sm_count("cuda"))
                assert splits > 1
                table[2, pps] = -1      # holes on both sides of a boundary
                table[2, pps - 1] = -1
                table[5] = -1           # a dead row
                pos = torch.tensor([8191, pps * Pg - 1, 2 * pps * Pg + 7, 0,
                                    pps * Pg, 3000], dtype=torch.int32,
                                   device="cuda")
                q = torch.randn((B, 1, H, hd), generator=g, device="cuda",
                                dtype=dt)
                args = (q, pk, pv, table, pos)
                rpa.reset_launch_counts()
                got = rpa.ragged_paged_attention(*args, **kw)
                again = rpa.ragged_paged_attention(*args, **kw)
                torch.cuda.synchronize()
                assert rpa.LAUNCHES[name] == 2
                want = rpa.ragged_paged_attention_plain(*args, **kw)
                torch.testing.assert_close(got.float(), want.float(), **tol)
                assert torch.equal(got, again)
                assert not got[5].any()
        eager, replayed = _graph_replay(
            lambda: rpa.ragged_paged_attention(*args, **kw))
        assert torch.equal(eager, replayed)


def test_tpu_scale_budget_is_not_a_hopper_limit(monkeypatch):
    """Divergence of the gate: on a TPU the quantized kernels refuse a
    pool whose whole [N, KV] f32 scale arrays would overflow their SMEM
    budget (`_SCALE_SMEM_BUDGET`) and JAX falls back to the fold. The
    CUDA kernels read each live page's scales from device memory, so the
    port has no such limit: its wrappers take that pool (the plain
    version here; the CUDA kernels in the `cuda` case below)."""
    import jax
    from cake_tpu.ops import ragged_paged_attention as jrpa
    N = 4200                    # 2 * 4 * N * KV bytes of scales > 256 KB
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert 2 * 4 * N * 8 > jrpa._SCALE_SMEM_BUDGET
    assert not jrpa.ragged_paged_supported(128, 32, 8, 128, quantized=True,
                                           n_pages=N)
    rng = np.random.default_rng(40)
    q8 = torch.from_numpy(rng.integers(-127, 128, size=(N, 2, 2, 16),
                                       dtype=np.int8))
    scales = torch.from_numpy(rng.random((N, 2)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(1, 1, 4, 16)).astype(np.float32))
    table = torch.tensor([[N - 1, 7]], dtype=torch.int32)
    out = rpa.ragged_paged_attention(q, q8, q8, table,
                                     torch.tensor([3], dtype=torch.int32),
                                     scale_k=scales, scale_v=scales)
    assert out.shape == q.shape and torch.isfinite(out).all()


@pytest.mark.cuda
def test_cuda_quant_kernels_take_pools_past_the_tpu_scale_budget():
    """The int8 and int4 CUDA kernels over a 4200-page pool (scales past
    the TPU kernels' SMEM budget), rows reading its last pages, against
    their plain versions (f32 queries, atol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    g = torch.Generator(device="cuda").manual_seed(2)
    N, Pg, KV, hd, H = 4200, 16, 8, 128, 32
    table = torch.tensor([[N - 1, N - 2, 5], [17, N - 3, -1]],
                         dtype=torch.int32, device="cuda")
    pos = torch.tensor([40, 20], dtype=torch.int32, device="cuda")
    qlen = torch.tensor([3, 7], dtype=torch.int32, device="cuda")
    q = torch.randn((2, 8, H, hd), generator=g, device="cuda")
    for store, rows, packed4 in ((torch.int8, Pg, False),
                                 (torch.uint8, Pg // 2, True)):
        lo, hi = (0, 256) if packed4 else (-127, 128)
        pk, pv = (torch.randint(lo, hi, (N, rows, KV, hd), generator=g,
                                device="cuda", dtype=torch.int32).to(store)
                  for _ in range(2))
        sk = torch.rand((N, KV), generator=g, device="cuda") / 64
        sv = torch.rand((N, KV), generator=g, device="cuda") / 64
        kw = dict(scale_k=sk, scale_v=sv, packed4=packed4)
        got = rpa.ragged_paged_attention(q[:, :1].contiguous(), pk, pv,
                                         table, pos, **kw)
        want = rpa.ragged_paged_attention_plain(q[:, :1].contiguous(), pk,
                                                pv, table, pos, **kw)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0.0)
        got = rpa.ragged_paged_attention_mixed(q, pk, pv, table, pos, qlen,
                                               **kw)
        want = rpa.ragged_paged_attention_mixed_plain(q, pk, pv, table, pos,
                                                      qlen, **kw)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0.0)
