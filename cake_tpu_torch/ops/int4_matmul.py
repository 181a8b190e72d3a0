"""Matmul over nibble-packed int4 weights (the decode hot path): the CUDA
kernel, its wrapper, and its plain PyTorch version.

Counterpart of `cake_tpu/ops/int4_matmul.py` (`pack_int4`, `unpack_int4`,
`kernel_supported`, `int4_matmul`, whose Pallas body is `_int4_kernel`).
On the card the product runs as hand-written CUDA C++ for Hopper
(`csrc/int4_matmul.cu`), compiled with nvcc for sm_90a at first use into
`cake_tpu_torch/_build/` and bound with ctypes (utils/cuda_build.py).
One launch a product: bf16/f16 x runs the tensor-core body (`takes_tc`),
f32 x the CUDA-core body; both cut the group axis into the ranks of a
thread-block cluster (`split_plan`) that sum their partials in rank order
over the cluster's shared memory, so no scratch is allocated and the same
inputs give the same bits.

Storage layout ("group-halves", produced by ops.quant.quantize_group): a
weight [In, Out] is grouped into G = In/g row groups; within group gi,
input row j (j < g/2) packs into the LOW nibble and row j + g/2 into the
HIGH nibble of packed byte [gi*g/2 + j, out], each stored biased by +8.
Both nibble-mates share the group's scale row; scales are f32 [G, Out].
This is not the layout of the int4 KV pages (kv/quantized_pool.py).

The wrapper takes tensors on one device: a CUDA tensor launches the
kernel, or raises on what the kernel cannot take (`kernel_supported` is
its gate); a CPU tensor runs the plain version. There is no fallback
from a CUDA tensor to the plain version. The product is decode-shaped
(M <= MAX_KERNEL_M rows); larger M dequantizes and takes a plain matmul
in ops/quant.py, as the JAX package does.

`LAUNCHES` counts kernel launches and plain-version calls by name, so a
run can show which path its weight products took.
"""

from __future__ import annotations

import ctypes

import torch

from cake_tpu_torch.utils.cuda_build import CudaLibrary
from cake_tpu_torch.utils.devices import device_sm_count

# decode/matvec shapes only; larger M takes the dequantize route
MAX_KERNEL_M = 64

KERNELS = ("int4_matmul",)
LAUNCHES = {"int4_matmul": 0, "int4_matmul_plain": 0}

# the kernel's limits and tiling (csrc/int4_matmul.cu: kMaxGroup, kMaxM,
# kTcCols / kColsPerBlock, kMTile, kChunk, kMaxSplits; its launcher
# refuses a shape or plan beyond them)
MAX_GROUP = 256
COLS_PER_CTA = 256
M_TILE = 8
OUT_MULTIPLE = 16
MAX_SPLITS = 16         # CTAs of a cluster (Hopper's largest)
# the tensor-core body takes bf16/f16 x with g a multiple of TC_GROUP_MULTIPLE
# (a k16 step is eight packed rows) and at least TC_MIN_M rows; f32 x and
# the rest run the CUDA-core body (one row of x: the faster on an H100)
TC_GROUP_MULTIPLE = 16
TC_MIN_M = 2
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int4_matmul.argtypes = [p] * 4 + [i] * 7 + [p]
    lib.int4_matmul.restype = i


LIBRARY = CudaLibrary("int4_matmul.cu", _bind)
SOURCE = LIBRARY.source


def pack_int4(q: torch.Tensor, g: int) -> torch.Tensor:
    """Pack int4 values (an int8 tensor in [-8, 7], contract dim -2) into
    uint8 bytes in the group-halves layout, biased by +8 (a nibble stores
    v + 8 in [0, 15]). [.., In, Out] -> [.., In/2, Out]."""
    *lead, In, Out = q.shape
    if In % g or g % 2:
        raise ValueError(f"pack_int4: In={In} must split into even groups "
                         f"of g={g}")
    G = In // g
    v = (q.to(torch.int32) + 8) & 0xF
    v = v.reshape(*lead, G, g, Out)
    lo = v[..., : g // 2, :]
    hi = v[..., g // 2:, :]
    packed = lo | (hi << 4)
    return packed.to(torch.uint8).reshape(*lead, In // 2, Out)


def unpack_int4(packed: torch.Tensor, g: int) -> torch.Tensor:
    """Inverse of pack_int4: [.., In/2, Out] uint8 -> [.., In, Out] int8
    (true signed int4 values; the storage bias is removed)."""
    *lead, half, Out = packed.shape
    G = half // (g // 2)
    p = packed.to(torch.int32).reshape(*lead, G, g // 2, Out)
    lo = (p & 0xF) - 8
    hi = (p >> 4) - 8
    w = torch.cat([lo, hi], dim=-2)                  # [.., G, g, Out]
    return w.to(torch.int8).reshape(*lead, G * g, Out)


def kernel_supported(m: int, in_dim: int, g: int, out: int) -> bool:
    """Hopper gate: the shapes the CUDA kernel takes. 1 <= m <=
    MAX_KERNEL_M rows, in_dim a whole number of even groups of at most
    MAX_GROUP rows, and out a multiple of OUT_MULTIPLE (packed rows are
    copied to shared memory in aligned 16-byte pieces). None of the TPU's
    tile conditions applies (in_dim % 128, (g/2) % 8, out % 128): every
    product of the tiny config and of Llama-3-8B passes."""
    return (1 <= m <= MAX_KERNEL_M and g >= 2 and g % 2 == 0
            and g <= MAX_GROUP and in_dim >= g and in_dim % g == 0
            and out >= OUT_MULTIPLE and out % OUT_MULTIPLE == 0)


def takes_tc(m: int, g: int, dtype: torch.dtype) -> bool:
    """Whether a product runs the tensor-core body (bf16/f16 x, g a
    multiple of TC_GROUP_MULTIPLE, m >= TC_MIN_M) rather than the
    CUDA-core body (f32 x: tensor cores would round x to tf32). Shapes and
    dtype only."""
    return (dtype in (torch.bfloat16, torch.float16)
            and g % TC_GROUP_MULTIPLE == 0 and m >= TC_MIN_M)


def ctas_per_sm(m: int, tc: bool) -> int:
    """CTAs of a body one SM holds at once at g = 128 (shared memory and
    registers, csrc/int4_matmul.cu): two of the CUDA-core body and of the
    tensor-core body up to 32 rows; one past 32 (256 threads of 192
    registers)."""
    return 1 if tc and m > 32 else 2


def split_plan(m: int, n_groups: int, out: int, tc: bool, n_sm: int) -> int:
    """How many CTAs share one output tile's walk over the group axis:
    the ranks of one thread-block cluster, at most MAX_SPLITS. Output tiles
    alone (COLS_PER_CTA columns; the CUDA-core body also tiles M by
    M_TILE) are too few CTAs to fill the card at decode shapes, so the
    group axis is cut into as many contiguous ranges as keep every CTA
    resident at once (`ctas_per_sm` on each of n_sm SMs: a second wave
    would double the time of the CTAs in it); the ranks sum their
    partials over the cluster's shared memory in rank order (no float
    atomics: the same inputs give the same bits). Range r covers groups
    [r * per, min(n_groups, (r + 1) * per)), per = ceil(n_groups /
    splits), and no range is empty. Shapes and the SM count only, so a
    call captures into a CUDA graph."""
    tiles = -(-out // COLS_PER_CTA) * (1 if tc else -(-m // M_TILE))
    fit = ctas_per_sm(m, tc) * n_sm // tiles
    want = max(1, min(MAX_SPLITS, n_groups, fit))
    per = -(-n_groups // want)
    return -(-n_groups // per)        # no empty range


def _check_shapes(x, packed, scale, g):
    """(M, In, Out) of a product whose shapes agree, else raise."""
    if x.ndim != 2 or packed.ndim != 2 or scale.ndim != 2:
        raise ValueError(
            f"int4_matmul takes x [M, In], packed [In/2, Out], scale "
            f"[G, Out]; got {tuple(x.shape)}, {tuple(packed.shape)}, "
            f"{tuple(scale.shape)}")
    M, In = x.shape
    half, Out = packed.shape
    G, s_out = scale.shape
    if In != 2 * half or G * g != In or s_out != Out:
        raise ValueError(
            f"int4_matmul: x {tuple(x.shape)}, packed {tuple(packed.shape)}"
            f", scale {tuple(scale.shape)} and g={g} do not agree")
    return M, In, Out


def _check_cuda_args(x, packed, scale, g, M, In, Out):
    """Raise a clear error on what the kernel cannot take."""
    if packed.device != x.device or scale.device != x.device:
        raise ValueError("int4_matmul: x, packed and scale must be on one "
                         "CUDA device")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"int4_matmul: x dtype {x.dtype}; the kernel takes "
                         "float32, bfloat16 and float16")
    if packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise ValueError(f"int4_matmul: packed {packed.dtype} / scale "
                         f"{scale.dtype} must be uint8 / float32")
    if not kernel_supported(M, In, g, Out):
        raise ValueError(
            f"int4_matmul kernel cannot take M={M} In={In} g={g} Out={Out}: "
            f"it needs 1 <= M <= {MAX_KERNEL_M}, In a whole number of even "
            f"groups of at most {MAX_GROUP} rows, and Out a multiple of "
            f"{OUT_MULTIPLE}")
    if not (packed.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int4_matmul takes contiguous packed and scale")


def _current_stream(device) -> int:
    """The raw handle of PyTorch's current stream on `device` (the
    private fast path when this PyTorch has it: the public one builds a
    Stream object on every call, and this wrapper runs 224 times per
    decode step of an 8B model)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                *, g: int) -> torch.Tensor:
    """x [M, In] @ packed-int4 [In/2, Out] with group scales [G, Out];
    f32 accumulation; returns [M, Out] in x.dtype. On the card: one launch
    (`takes_tc` picks the body, `split_plan` the cluster)."""
    if not x.is_cuda:
        return int4_matmul_plain(x, packed, scale, g=g)
    M, In, Out = _check_shapes(x, packed, scale, g)
    _check_cuda_args(x, packed, scale, g, M, In, Out)
    x = x.contiguous()           # a row sliced out of [B, S, D] is strided
    if x.data_ptr() % 16:        # ... or starts off a 16-byte boundary
        x = x.clone()
    p_ptr, s_ptr = packed.data_ptr(), scale.data_ptr()
    if p_ptr % 16 or s_ptr % 16:
        raise ValueError("int4_matmul: packed and scale must be 16-byte "
                         "aligned (the kernel copies 16-byte pieces)")
    tc = takes_tc(M, g, x.dtype)
    splits = split_plan(M, In // g, Out, tc, device_sm_count(x.device))
    out = torch.empty((M, Out), dtype=x.dtype, device=x.device)
    rc = LIBRARY.get().int4_matmul(
        x.data_ptr(), p_ptr, s_ptr, out.data_ptr(), M, In, Out, g, splits,
        _DTYPE_CODES[x.dtype], int(tc), _current_stream(x.device))
    if rc != 0:
        raise RuntimeError(f"int4_matmul launch failed: CUDA error {rc}")
    LAUNCHES["int4_matmul"] += 1
    return out


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                      scale: torch.Tensor, *, g: int) -> torch.Tensor:
    """Plain version of `int4_matmul`, the Pallas body's arithmetic: per
    group two half-dots of x over the biased nibbles, minus 8 * sum(x)
    for the bias, times the group's f32 scale row, summed over the groups
    in f32 and cast to x.dtype."""
    LAUNCHES["int4_matmul_plain"] += 1
    M, In, Out = _check_shapes(x, packed, scale, g)
    G, h = In // g, g // 2
    xg = x.float().reshape(M, G, 2, h)
    p = packed.reshape(G, h, Out).to(torch.int32)
    lo = (p & 0xF).float()
    hi = (p >> 4).float()
    part = (torch.einsum("mgk,gko->mgo", xg[:, :, 0], lo)
            + torch.einsum("mgk,gko->mgo", xg[:, :, 1], hi))
    xsum = xg.sum(dim=(2, 3))                                  # [M, G]
    acc = ((part - 8.0 * xsum[..., None]) * scale[None]).sum(dim=1)
    return acc.to(x.dtype)
