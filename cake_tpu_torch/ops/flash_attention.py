"""Flash attention for prefill: the CUDA kernels, their wrappers, and their
plain PyTorch versions.

Counterpart of `cake_tpu/ops/flash_attention.py` (`flash_attention` and
`flash_attention_cached`, whose Pallas bodies are `_flash_kernel` and
`_flash_kernel_cached`). On the card both run as hand-written CUDA C++
for Hopper (`csrc/flash_attention.cu`), compiled with nvcc for sm_90a at
first use into `cake_tpu_torch/_build/` and bound with ctypes
(utils/cuda_build.py).

Each wrapper takes tensors on one device: a CUDA tensor launches the
kernel, or raises on what the kernel cannot take (`flash_supported` is
its gate); a CPU tensor runs the plain version, masked f32 softmax
attention. There is no fallback from a CUDA tensor to the plain version.

Layout (the JAX package's): q [B, S, H, hd], k/v [B, T, KV, hd], output
[B, S, H, hd] in q's dtype; query head h reads kv head h // (H // KV).

`LAUNCHES` counts kernel launches and plain-version calls by name, so a
run can show which path its attention took. `flash_attn_cached` over
bf16/f16 may be two launches (the key splits of `flash_split_plan`,
then their in-order merge), counted as one call.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cake_tpu_torch.ops.attention import NEG_INF
from cake_tpu_torch.utils.cuda_build import CudaLibrary
from cake_tpu_torch.utils.devices import device_sm_count

KERNELS = ("flash_attn", "flash_attn_cached")
LAUNCHES = {"flash_attn": 0, "flash_attn_cached": 0,
            "flash_attn_plain": 0, "flash_attn_cached_plain": 0}

# the kernel's limits (csrc/flash_attention.cu kRows, kMaxHd, whose
# shape_ok refuses a launch beyond them)
MAX_GROUP = 32
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# flash_attn_cached's tensor-core body: warps a CTA (16 query rows each;
# 4 or 8) and the most key splits of a (query tile, kv head)
CACHED_WARPS = 8
MAX_KEY_SPLITS = 16
KEY_TILE = 64


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attn.argtypes = [p, p, p, p] + [i] * 8 + [f, i, p]
    # flash_attn_cached's pos is a device int32 the kernel reads
    lib.flash_attn_cached.argtypes = [p, p, p, p] + [i] * 6 + [
        p, i, f, i, i, i, p, p]
    for fn in (lib.flash_attn, lib.flash_attn_cached):
        fn.restype = i


LIBRARY = CudaLibrary("flash_attention.cu", _bind)
SOURCE = LIBRARY.source


def flash_supported(S: int, T: int, H: int, KV: int, hd: int,
                    dtype: Optional[torch.dtype] = None) -> bool:
    """Hopper gate: the shapes the CUDA kernels take (S = query window,
    T = key length). Any S >= 1 and T >= S (ragged tails are bounds-
    checked, so none of the TPU's tile divisibility applies), KV dividing
    H with at most MAX_GROUP query heads per kv head, a head dim that is a
    multiple of 4 up to MAX_HEAD_DIM (the tiny config's 16 to Llama's
    128), and f32, bf16 or f16 when a dtype is given."""
    return (S >= 1 and T >= S and KV >= 1 and H % KV == 0
            and H // KV <= MAX_GROUP and 4 <= hd <= MAX_HEAD_DIM
            and hd % 4 == 0 and (dtype is None or dtype in _DTYPE_CODES))


def flash_split_plan(B: int, S: int, T: int, H: int, KV: int, n_sm: int,
                     warps: int) -> int:
    """Key splits of flash_attn_cached's tensor-core body, from shapes and
    the SM count alone (never pos, so a captured call replays at any
    position): as many as keep B x KV x query tiles x splits CTAs within
    one wave of the card (two CTAs an SM at 4 warps, one at 8), at most
    MAX_KEY_SPLITS, and at most half the 64-key tiles of a T-slot cache.
    Split s of a CTA's n key tiles walks [s n // splits, (s + 1) n //
    splits)."""
    q_cols = max(1, 16 * warps // (H // KV))
    ctas = B * KV * -(-S // q_cols)
    want = (2 if warps == 4 else 1) * n_sm // max(1, ctas)
    cap = max(1, -(-T // KEY_TILE) // 2)
    return max(1, min(want, MAX_KEY_SPLITS, cap))


def _check_cuda_args(q, k, v):
    """Raise a clear error on what the kernel cannot take."""
    B, S, H, hd = q.shape
    Bk, T, KV, hd_k = k.shape
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash attention: q, k and v must be on one CUDA "
                         "device")
    if v.shape != k.shape or Bk != B or hd_k != hd:
        raise ValueError(f"flash attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention: q, k, v dtypes {q.dtype}, "
                         f"{k.dtype}, {v.dtype} differ; the kernel reads "
                         "one dtype")
    if not flash_supported(S, T, H, KV, hd, q.dtype):
        raise ValueError(
            f"flash attention kernel cannot take S={S} T={T} H={H} KV={KV} "
            f"hd={hd} {q.dtype}: it needs T >= S >= 1, KV dividing H with "
            f"at most {MAX_GROUP} query heads per kv head, hd a multiple of "
            f"4 up to {MAX_HEAD_DIM}, and f32/bf16/f16")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention takes contiguous tensors")


def _launch(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _check_window(window, causal=True):
    if window is None:
        return 0
    if not causal:
        raise ValueError(
            "window requires causal=True: the non-causal kernel applies "
            "no window mask, so the window would be silently ignored")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return int(window)


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    causal: bool = True, window: Optional[int] = None):
    """Flash attention over q [B, S, H, hd] and k/v [B, T, KV, hd].

    causal: query i attends keys j <= i (and j > i - window); otherwise
    every key, with no window. Returns [B, S, H, hd] in q.dtype."""
    B, S, H, hd = q.shape
    w = _check_window(window, causal)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     window=window)
    _check_cuda_args(q, k, v)
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rc = LIBRARY.get().flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, T, H, KV, hd, int(causal), w, float(scale),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _launch("flash_attn", rc)
    return out


def _device_pos(pos, device) -> torch.Tensor:
    """The kernel's pos: a one-element int32 tensor on `device`. A
    tensor is taken as it is (cast when it is not int32); an int is
    written there by a fill kernel, so the host does not wait and a
    capture records the value, not a host address."""
    if isinstance(pos, torch.Tensor):
        if pos.device != device or pos.numel() != 1:
            raise ValueError(
                f"flash_attention_cached: pos must be one element on "
                f"{device}, got {tuple(pos.shape)} on {pos.device}")
        return pos.reshape(1).to(torch.int32).contiguous()
    return torch.full((1,), pos, dtype=torch.int32, device=device)


def flash_attention_cached(q, k_cache, v_cache, pos, *,
                           scale: Optional[float] = None,
                           window: Optional[int] = None):
    """Flash attention for a query window at absolute position `pos`
    against a whole KV cache (chunked / continued prefill).

    q [B, S, H, hd]; k_cache/v_cache [B, T, KV, hd] with every slot
    < pos + S written (the window's own k/v included); later slots may
    hold garbage and are never read. Query i attends slots j <= pos + i
    (and j > pos + i - window). pos: an int, checked here against
    0 <= pos <= T - S, or a one-element tensor on q's device, which the
    kernel reads on the card (as the TPU kernel reads its scalar ref),
    so a captured call replays at any position; there a pos out of
    range traps the kernel. Returns [B, S, H, hd] in q.dtype."""
    B, S, H, hd = q.shape
    T = k_cache.shape[1]
    w = _check_window(window)
    if not isinstance(pos, torch.Tensor):
        pos = int(pos)
        if not 0 <= pos <= T - S:
            raise ValueError(f"flash_attention_cached: pos {pos} with "
                             f"S={S} runs past the cache (T={T})")
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    if not q.is_cuda:
        return flash_attention_cached_plain(q, k_cache, v_cache, pos,
                                            scale=scale, window=window)
    _check_cuda_args(q, k_cache, v_cache)
    KV = k_cache.shape[2]
    out = torch.empty_like(q)
    splits, part = 1, None
    aligned = (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 4 == 0
    if q.dtype != torch.float32 and aligned:   # flash_tc: f32 partials
        splits = flash_split_plan(B, S, T, H, KV, device_sm_count(q.device),
                                  CACHED_WARPS)
        if splits > 1:
            part = torch.empty(splits * B * S * H * (hd + 2),
                               dtype=torch.float32, device=q.device)
    pos_d = _device_pos(pos, q.device)
    rc = LIBRARY.get().flash_attn_cached(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        out.data_ptr(), B, S, T, H, KV, hd, pos_d.data_ptr(), w,
        float(scale),
        _DTYPE_CODES[q.dtype], CACHED_WARPS, splits,
        None if part is None else part.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _launch("flash_attn_cached", rc)
    return out


# -- plain versions: masked f32 softmax attention -----------------------------


def _masked_attention(q, k, v, mask, scale):
    """Softmax attention in f32 under mask [S, T] (True = attend); a row
    that attends nothing gives zeros. Returns [B, S, H, hd] in q.dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * scale
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgst,btkd->bkgsd", p, v.float())
    o = o / torch.where(l == 0.0, torch.ones_like(l), l)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def _window_mask(qpos, kpos, window):
    """[S, T] mask: key kj visible to query qi iff kj <= qi (and
    kj > qi - window)."""
    mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def flash_attention_plain(q, k, v, *, scale: Optional[float] = None,
                          causal: bool = True, window: Optional[int] = None):
    """Plain version of `flash_attention` (the einsum path the JAX model
    takes without flash)."""
    LAUNCHES["flash_attn_plain"] += 1
    S, hd = q.shape[1], q.shape[3]
    T = k.shape[1]
    _check_window(window, causal)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    kpos = torch.arange(T, device=q.device)
    if causal:
        mask = _window_mask(torch.arange(S, device=q.device), kpos, window)
    else:
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    return _masked_attention(q, k, v, mask, scale)


def flash_attention_cached_plain(q, k_cache, v_cache, pos, *,
                                 scale: Optional[float] = None,
                                 window: Optional[int] = None):
    """Plain version of `flash_attention_cached`. Value rows at or past
    the frontier pos + S are zeroed before the product, as the JAX kernel
    zeroes them: a masked p is 0, and 0 * NaN garbage is NaN. pos: an
    int or a one-element tensor on q's device (the mask is then built
    there)."""
    LAUNCHES["flash_attn_cached_plain"] += 1
    S, hd = q.shape[1], q.shape[3]
    T = k_cache.shape[1]
    pos = (pos.reshape(()).long() if isinstance(pos, torch.Tensor)
           else int(pos))
    _check_window(window)
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    kpos = torch.arange(T, device=q.device)
    mask = _window_mask(pos + torch.arange(S, device=q.device), kpos, window)
    live = (kpos < pos + S)[None, :, None, None]
    v = torch.where(live, v_cache, torch.zeros_like(v_cache))
    return _masked_attention(q, k_cache, v, mask, scale)
