"""Ragged paged attention: the CUDA kernels, their wrappers, and their
plain PyTorch versions.

Counterpart of `cake_tpu/ops/ragged_paged_attention.py`
(`ragged_paged_attention` and `ragged_paged_attention_mixed`, whose
Pallas bodies are `_rpa_kernel` and `_rpa_mixed_kernel`, and over
quantized pages `_rpa_kernel_q8` / `_rpa_mixed_kernel_q8` (int8) and
`_rpa_kernel_q4` / `_rpa_mixed_kernel_q4` (nibble-packed int4)). On the
card all six run as hand-written CUDA C++ for Hopper
(`csrc/ragged_paged_attention.cu`), compiled with nvcc for sm_90a at
first use into `cake_tpu_torch/_build/` and bound with ctypes
(utils/cuda_build.py).

Each wrapper takes tensors on one device: a CUDA tensor launches the
kernel (or raises on a shape the kernel cannot take); a CPU tensor runs
the plain version, the online-softmax fold over every table column
that `cake_tpu/models/llama/paged.py` calls `impl="fold"` (over
quantized pages it dequantizes each page, `dequantize_pages(...,
fill_zero=True)`, and casts it to q's dtype, as that fold does). There
is no fallback from a CUDA tensor to the plain version.

Layout contract (the JAX package's): pool [N_pages, page, KV, hd] (a
nibble-packed int4 pool [N_pages, page//2, KV, hd] uint8), per-page
scales [N_pages, KV] f32 for int8/int4 pools, table [B, max_pages]
int32 with -1 = unmapped, pos [B] = absolute position of each row's
first query; the queries' KV is already written.

`LAUNCHES` counts kernel launches and plain-version calls by name, so a
run can show which path its attention took. The decode over every pool
(f32/bf16, fp8 e4m3/e5m2, int8, nibble-packed int4) is two launches
(`rpa_split`, then `rpa_merge`) counted as one call: its page loop is
split across CTAs by `split_plan`, which the plain version follows. The
mixed step over bf16 queries and bf16, fp8, int8 or nibble-packed int4
pages runs the tensor-core body `rpa_mixed_tc`, split by
`mixed_split_plan` (plus `rpa_mixed_merge` when it splits), again one
call; its plain version folds those splits over every pool. The other
mixed pairs (f32 queries or pages, head dim above 128, rows that are
not 4-byte multiples) run the scalar `rpa_cta`, unsplit.

fp8 pages (`torch.float8_e4m3fn`, `torch.float8_e5m2`: the --kv-dtype
f8_e4m3 / f8_e5m2 pools, which JAX runs through the same `_rpa_kernel`
and `_rpa_mixed_kernel`) carry no scales: every e4m3 and e5m2 value is
exact in bf16 and f32, so the kernels convert on load and the plain
versions upcast a page to q's dtype on read, as JAX's fold does
(`cake_tpu/parallel/context_parallel.py:partial_attention_stats`),
rounding p to q's dtype for p v as that fold does. They count under
names of their own (`rpa_decode_f8e4m3`, `rpa_mixed_f8e5m2`, ...).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cake_tpu_torch.kv.quantized_pool import (
    Int4Pool, QuantPool, _pool_page, dequantize_pages,
)
from cake_tpu_torch.ops.attention import (
    NEG_INF, merge_attention_stats, partial_attention_stats,
)
from cake_tpu_torch.utils.cuda_build import CudaLibrary
from cake_tpu_torch.utils.devices import (
    FP8_DTYPES, device_sm_count, take_rows,
)

KERNELS = ("rpa_decode", "rpa_mixed", "rpa_decode_q8", "rpa_mixed_q8",
           "rpa_decode_q4", "rpa_mixed_q4", "rpa_decode_f8e4m3",
           "rpa_mixed_f8e4m3", "rpa_decode_f8e5m2", "rpa_mixed_f8e5m2")
LAUNCHES = {name + suffix: 0 for name in KERNELS for suffix in ("", "_plain")}

_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
# page storage: f32, bf16, int8 (+ scales), nibble-packed int4 (+ scales),
# fp8 e4m3 and e5m2 (no scales; uint8 already means packed int4)
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.uint8: 3, torch.float8_e4m3fn: 4, torch.float8_e5m2: 5}
_FP8_SUFFIX = {torch.float8_e4m3fn: "_f8e4m3", torch.float8_e5m2: "_f8e5m2"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.rpa_decode.argtypes = [p] * 8 + [i] * 7 + [f, i, i, i, i, p, p]
    lib.rpa_mixed.argtypes = [p] * 9 + [i] * 8 + [f, i, i, i, i, i, p, p]
    lib.rpa_decode.restype = i
    lib.rpa_mixed.restype = i
    for fn in (lib.rpa_max_group, lib.rpa_max_head_dim):
        fn.argtypes = []
        fn.restype = i


LIBRARY = CudaLibrary("ragged_paged_attention.cu", _bind)
SOURCE = LIBRARY.source


# SMs of the card a plain version on the CPU plans for (an H100's); on a
# CUDA device the plan reads the device's own count
CPU_SM_COUNT = 132
# a split covers at most this many slots, so a long row is spread over
# more CTAs than the floor of two an SM asks for
SPLIT_SLOTS = 128
# a split of the mixed kernel covers at least this many slots (four of its
# 64-slot key tiles), and its f32 partials take at most this much scratch
MIXED_MIN_SLOTS = 256
MIXED_SCRATCH_BYTES = 64 << 20


def sm_count(device) -> int:
    """The SM count the split plans plan for: the card's, read once per
    device; CPU_SM_COUNT for a CPU tensor."""
    device = torch.device(device)
    if device.type != "cuda":
        return CPU_SM_COUNT
    return device_sm_count(device)


def split_plan(B: int, KV: int, max_pages: int, P: int,
               n_sm: int) -> tuple[int, int]:
    """(splits, pages per split) of the decode's page loop, from shapes
    alone: enough splits that B * KV * splits CTAs give every SM two when
    the rows are long, and no split longer than SPLIT_SLOTS slots. Split
    s covers table columns [s * pps, (s + 1) * pps); every column lies in
    exactly one split."""
    if max_pages < 1:
        return 1, 1
    want = -(-2 * n_sm // max(1, B * KV))
    pps = max(1, min(-(-max_pages // want), SPLIT_SLOTS // P))
    return -(-max_pages // pps), pps


def mixed_split_plan(B: int, C: int, H: int, KV: int, hd: int,
                     max_pages: int, P: int, n_sm: int) -> tuple[int, int]:
    """(splits, pages per split) of the mixed step's page loop, from
    shapes alone (never pos, q_len or the table, so the call captures
    into a CUDA graph): enough splits that one long row's kv heads take
    two CTAs an SM, no split shorter than MIXED_MIN_SLOTS slots, and the
    f32 partials (splits x B x C x H x (hd + 2) floats) within
    MIXED_SCRATCH_BYTES. Split s covers table columns [s * pps,
    (s + 1) * pps); every column lies in exactly one split."""
    if max_pages < 1:
        return 1, 1
    want = -(-2 * n_sm // max(1, B * KV))
    pps = max(-(-max_pages // want), -(-MIXED_MIN_SLOTS // P))
    cap = max(1, MIXED_SCRATCH_BYTES // max(1, 4 * B * C * H * (hd + 2)))
    pps = max(pps, -(-max_pages // cap))
    return -(-max_pages // pps), pps


def mixed_takes_tc(q, pool_k, pool_v, scale_k=None) -> bool:
    """Whether rpa_mixed runs its tensor-core body (rpa_mixed_tc): bf16
    queries over bf16 or fp8 (e4m3, e5m2) pages, or (with scales) over
    int8 or nibble-packed int4 (uint8) pages; head dim at most 128; q and
    the pools 4-byte aligned and their slot rows (hd elements of q's or
    the pool's type) 4-byte multiples, the least piece cp.async copies.
    Reads only dtypes, shapes and pointers. Every other pair runs
    rpa_cta, unsplit."""
    hd = q.shape[-1]
    pages = ((torch.bfloat16,) + FP8_DTYPES if scale_k is None
             else (torch.int8, torch.uint8))
    aligned = (q.data_ptr() | pool_k.data_ptr() | pool_v.data_ptr()
               | 2 * hd | hd * pool_k.element_size()) % 4
    return (q.dtype == torch.bfloat16 and pool_k.dtype in pages
            and hd <= 128 and aligned == 0)


def kernel_name(base: str, scale_k=None, packed4: bool = False,
                kv_dtype=None) -> str:
    """The kernel that serves a pool: `base` for f32/bf16 pages, `_q8`
    for int8 and `_q4` for nibble-packed int4 pages, `_f8e4m3` and
    `_f8e5m2` for fp8 pages (kv_dtype: the pool's dtype)."""
    if scale_k is None:
        return base + _FP8_SUFFIX.get(kv_dtype, "")
    return base + ("_q4" if packed4 else "_q8")


def _check_quant_args(scale_k, scale_v, packed4):
    if packed4 and scale_k is None:
        raise ValueError("packed4 pools require scale_k/scale_v")
    if (scale_k is None) != (scale_v is None):
        raise ValueError("scale_k and scale_v come together")


def _check_cuda_args(q, pool_k, pool_v, table, pos, q_len=None,
                     scale_k=None, scale_v=None, packed4=False):
    """Hopper gate: what the kernel takes, checked before launch."""
    lib = LIBRARY.get()
    B, C, H, hd = q.shape
    N, rows, KV, hd_k = pool_k.shape
    scales = [] if scale_k is None else [scale_k, scale_v]
    tensors = [q, pool_k, pool_v, table, pos] + (
        [q_len] if q_len is not None else []) + scales
    if any(t.device != q.device for t in tensors):
        raise ValueError("ragged paged attention: all tensors must be on "
                         "one CUDA device")
    if pool_v.shape != pool_k.shape or hd_k != hd:
        raise ValueError(f"pool shapes {tuple(pool_k.shape)} / "
                         f"{tuple(pool_v.shape)} do not match q {q.shape}")
    if H % KV or H // KV > lib.rpa_max_group():
        raise ValueError(
            f"H={H}, KV={KV}: the kernel takes KV dividing H with at "
            f"most {lib.rpa_max_group()} query heads per kv head")
    if hd > lib.rpa_max_head_dim():
        raise ValueError(f"head_dim {hd} > {lib.rpa_max_head_dim()}: the "
                         "kernel keeps two head dims per thread")
    if q.dtype not in _Q_CODES:
        raise ValueError(f"q dtype {q.dtype}: the kernel takes float32 "
                         "and bfloat16 queries")
    want = ((torch.float32, torch.bfloat16) + FP8_DTYPES if scale_k is None
            else (torch.uint8,) if packed4 else (torch.int8,))
    if pool_k.dtype not in want or pool_v.dtype != pool_k.dtype:
        kind = ("f32/bf16/fp8 pages" if scale_k is None else
                "nibble-packed int4 pages (uint8)" if packed4 else
                "int8 pages")
        raise ValueError(f"pool dtype {pool_k.dtype}: {kind} must be "
                         f"{' or '.join(str(d) for d in want)}")
    # (an int4 page is even by construction: the packed axis holds its
    # page // 2 rows, and the kernel reads 2 * rows tokens per page)
    for s in scales:
        if s.dtype != torch.float32 or tuple(s.shape) != (N, KV):
            raise ValueError(f"page scales {s.dtype} {tuple(s.shape)}: "
                             f"must be float32 [{N}, {KV}]")
    if table.dtype != torch.int32 or pos.dtype != torch.int32 or (
            q_len is not None and q_len.dtype != torch.int32):
        raise ValueError("table, pos and q_len must be int32")
    if table.shape[0] != B or pos.shape != (B,):
        raise ValueError(f"table {tuple(table.shape)} / pos "
                         f"{tuple(pos.shape)} do not match B={B}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ragged paged attention takes contiguous tensors")


def _launch(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def ragged_paged_attention(q, pool_k, pool_v, table, pos, *,
                           scale: Optional[float] = None,
                           scale_k=None, scale_v=None,
                           packed4: bool = False):
    """Ragged decode attention over a paged pool.

    q [B, 1, H, hd]; pool_k/v [N, P, KV, hd] (f32/bf16, or int8 with
    scale_k/scale_v [N, KV] f32, or with packed4 uint8 [N, P//2, KV, hd]
    nibble-packed int4 with scales); table [B, max_pages] int32; pos [B]
    int32 (position of the current token, its KV written). Returns
    [B, 1, H, hd] in q.dtype; a row with no live page gives 0.
    """
    B, S, H, hd = q.shape
    if S != 1:
        raise ValueError(f"decode kernel takes one query per row, got S={S}")
    _check_quant_args(scale_k, scale_v, packed4)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    quant = dict(scale_k=scale_k, scale_v=scale_v, packed4=packed4)
    if not q.is_cuda:
        return ragged_paged_attention_plain(q, pool_k, pool_v, table, pos,
                                            scale=scale, **quant)
    _check_cuda_args(q, pool_k, pool_v, table, pos, **quant)
    N, rows, KV, _ = pool_k.shape
    P = rows * (2 if packed4 else 1)
    max_pages = table.shape[1]
    out = torch.empty_like(q)
    # rpa_split + rpa_merge over every pool: f32 partials a split
    splits, pps = split_plan(B, KV, max_pages, P, sm_count(q.device))
    part = torch.empty(B * KV * splits * (H // KV) * (hd + 2),
                       dtype=torch.float32, device=q.device)
    lib = LIBRARY.get()
    rc = lib.rpa_decode(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        _ptr(scale_k), _ptr(scale_v), table.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, H, KV, hd, P, N, max_pages, float(scale),
        _Q_CODES[q.dtype], _KV_CODES[pool_k.dtype], pps, splits,
        part.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    _launch(kernel_name("rpa_decode", scale_k, packed4, pool_k.dtype), rc)
    return out


def ragged_paged_attention_mixed(q, pool_k, pool_v, table, pos, q_len, *,
                                 scale: Optional[float] = None,
                                 scale_k=None, scale_v=None,
                                 packed4: bool = False):
    """Mixed ragged attention: decode rows (q_len=1) and prefill-chunk
    rows (q_len up to C, at any page offset) in one launch.

    q [B, C, H, hd]; q_len [B] int32 (0 = idle row); pools and scales as
    `ragged_paged_attention`. Query column i of row b sits at
    pos[b] + i and attends slots <= pos[b] + i. Columns >= q_len and
    idle rows give 0. Returns [B, C, H, hd] in q.dtype.
    """
    B, C, H, hd = q.shape
    _check_quant_args(scale_k, scale_v, packed4)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    quant = dict(scale_k=scale_k, scale_v=scale_v, packed4=packed4)
    if not q.is_cuda:
        return ragged_paged_attention_mixed_plain(
            q, pool_k, pool_v, table, pos, q_len, scale=scale, **quant)
    _check_cuda_args(q, pool_k, pool_v, table, pos, q_len, **quant)
    N, rows, KV, _ = pool_k.shape
    P = rows * (2 if packed4 else 1)          # real tokens a page
    max_pages = table.shape[1]
    out = torch.empty_like(q)
    tc = mixed_takes_tc(q, pool_k, pool_v, scale_k)
    splits, pps, part = 1, max(1, max_pages), None
    if tc:                      # rpa_mixed_tc (+ rpa_mixed_merge): f32 partials
        splits, pps = mixed_split_plan(B, C, H, KV, hd, max_pages, P,
                                       sm_count(q.device))
        if splits > 1:
            part = torch.empty(splits * B * C * H * (hd + 2),
                               dtype=torch.float32, device=q.device)
    lib = LIBRARY.get()
    rc = lib.rpa_mixed(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        _ptr(scale_k), _ptr(scale_v), table.data_ptr(), pos.data_ptr(),
        q_len.data_ptr(), out.data_ptr(), B, C, H, KV, hd, P, N,
        max_pages, float(scale),
        _Q_CODES[q.dtype], _KV_CODES[pool_k.dtype], int(tc), pps, splits,
        _ptr(part), torch.cuda.current_stream(q.device).cuda_stream)
    _launch(kernel_name("rpa_mixed", scale_k, packed4, pool_k.dtype), rc)
    return out


# -- plain versions: the online-softmax fold over every table column ----------


def _page_reader(q, pool_k, pool_v, scale_k, scale_v, packed4):
    """(read, P): read(pages, mapped) gives table column j's K/V pages
    [B, P, KV, hd] (unmapped pages as zeros), P the real tokens per page.
    Quantized pages are dequantized in f32 and cast to q's dtype; fp8
    pages are upcast to q's dtype, as JAX's fold upcasts them."""
    if scale_k is None:
        dt = q.dtype if pool_k.dtype in FP8_DTYPES else pool_k.dtype
        zero = torch.zeros((), dtype=dt, device=q.device)

        def read(pages, mapped):
            idx = pages.clamp(min=0)
            keep = mapped[:, None, None, None]
            return (torch.where(keep, take_rows(pool_k, idx).to(dt), zero),
                    torch.where(keep, take_rows(pool_v, idx).to(dt), zero))

        return read, pool_k.shape[1]
    cls = Int4Pool if packed4 else QuantPool
    pk, pv = cls(pool_k, scale_k), cls(pool_v, scale_v)
    N = pool_k.shape[0]

    def read(pages, mapped):
        idx = torch.where(mapped, pages, torch.full_like(pages, N))
        return (dequantize_pages(pk, idx, fill_zero=True).to(q.dtype),
                dequantize_pages(pv, idx, fill_zero=True).to(q.dtype))

    return read, _pool_page(pk)


def _fold(q, read, KV, table, valid_fn, scale, pps=None):
    """Fold the table columns j into running (m, l, o) stats: read page
    j of each row (unmapped ids read zeros), mask with
    valid_fn(j, mapped) -> bool [B, C, P]. With `pps` each run of pps
    columns folds into stats of its own, as a split of the kernel does;
    the splits' stats then merge in order. Returns [B, C, H, hd]."""
    B, C, H, hd = q.shape
    G = H // KV
    n_cols = table.shape[1]
    pps = pps or max(1, n_cols)
    splits = []
    for j0 in range(0, max(1, n_cols), pps):
        m = torch.full((B, KV, G, C, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, C, 1), dtype=torch.float32,
                        device=q.device)
        o = torch.zeros((B, KV, G, C, hd), dtype=torch.float32,
                        device=q.device)
        for j in range(j0, min(j0 + pps, n_cols)):
            pages = table[:, j].long()
            mapped = pages >= 0
            kj, vj = read(pages, mapped)                      # [B, P, KV, hd]
            ok = valid_fn(j, mapped)                          # [B, C, P]
            # a slot no query attends may hold stale garbage (NaN) that
            # the kernels never read: p is 0 there, and 0 * NaN is NaN
            vj = torch.where(ok.any(dim=1)[:, :, None, None], vj,
                             torch.zeros((), dtype=vj.dtype,
                                         device=vj.device))
            valid = ok[:, None, None, :, :]                   # [B,1,1,C,P]
            mj, lj, oj = partial_attention_stats(q, kj, vj, valid,
                                                 scale=scale)
            m_new = torch.maximum(m, mj)
            a_old = torch.exp(m - m_new)
            a_new = torch.exp(mj - m_new)
            m, l, o = m_new, a_old * l + a_new * lj, a_old * o + a_new * oj
        splits.append((m, l, o))
    out = merge_attention_stats(splits)               # [B, KV, G, C, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, H, hd)


def ragged_paged_attention_plain(q, pool_k, pool_v, table, pos, *,
                                 scale: Optional[float] = None,
                                 scale_k=None, scale_v=None,
                                 packed4: bool = False):
    """Plain version of `ragged_paged_attention` (the JAX package's
    `paged_attention` fold): slot j*P + t attends iff <= pos and its
    page is mapped. The columns fold in the kernel's splits
    (`split_plan`), whose stats then merge in split order."""
    _check_quant_args(scale_k, scale_v, packed4)
    LAUNCHES[kernel_name("rpa_decode", scale_k, packed4, pool_k.dtype)
             + "_plain"] += 1
    read, P = _page_reader(q, pool_k, pool_v, scale_k, scale_v, packed4)
    t = torch.arange(P, device=q.device)
    KV = pool_k.shape[2]
    _, pps = split_plan(q.shape[0], KV, table.shape[1], P, sm_count(q.device))

    def valid(j, mapped):
        ok = (j * P + t)[None, :] <= pos[:, None].long()
        return (ok & mapped[:, None])[:, None, :]          # [B, 1, P]

    out = _fold(q, read, KV, table, valid, scale, pps)
    return out.to(q.dtype)


def ragged_paged_attention_mixed_plain(q, pool_k, pool_v, table, pos, q_len,
                                       *, scale: Optional[float] = None,
                                       scale_k=None, scale_v=None,
                                       packed4: bool = False):
    """Plain version of `ragged_paged_attention_mixed` (the JAX
    package's `paged_attention_mixed` fold): query i of row b attends
    slot j*P + t iff <= pos[b] + i and its page is mapped. Columns
    >= q_len attend nothing and give zeros, as the kernel writes them
    (so a stale slot past a row's last query is never read). The
    columns fold in the splits of `mixed_split_plan` (planned with the
    real page size P, also over packed int4 pages), whose stats then
    merge in split order, as the tensor-core kernel's do."""
    _check_quant_args(scale_k, scale_v, packed4)
    LAUNCHES[kernel_name("rpa_mixed", scale_k, packed4, pool_k.dtype)
             + "_plain"] += 1
    read, P = _page_reader(q, pool_k, pool_v, scale_k, scale_v, packed4)
    B, C = q.shape[:2]
    t = torch.arange(P, device=q.device)
    qi = torch.arange(C, device=q.device)
    horizon = pos[:, None].long() + qi[None, :]                 # [B, C]
    real = qi[None, :] < q_len[:, None].long()                 # [B, C]

    def valid(j, mapped):
        ok = (j * P + t)[None, None, :] <= horizon[:, :, None]
        return ok & mapped[:, None, None] & real[:, :, None]   # [B, C, P]

    KV = pool_k.shape[2]
    _, pps = mixed_split_plan(B, C, q.shape[2], KV, q.shape[3],
                              table.shape[1], P, sm_count(q.device))
    out = _fold(q, read, KV, table, valid, scale, pps)
    return out.to(q.dtype)
