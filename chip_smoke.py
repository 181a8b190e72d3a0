"""On-card smoke test of the PyTorch/CUDA port (`cake_tpu_torch`).

    python3 chip_smoke.py                 # every phase, one H100
    python3 chip_smoke.py --phases kernels,step
    python3 chip_smoke.py --phases device,generate --profile

Phases, in order (any failure exits non-zero):
  device    CUDA present; card name and power limit; both kernel
            libraries built from csrc/ (one nvcc each, in parallel).
  kernels   each CUDA kernel against its plain PyTorch version, f32 and
            bf16 queries: the ragged paged-attention kernels at the serving
            shapes (H=32, KV=8, hd=128, 128-token pages, 16 table columns,
            B=8, C=64) over f32/bf16 pages and over int8 and int4 pages
            written by the port's qwrite_prompt_pages, and the flash pair
            at the prefill shapes (S=T=1024 causal, plus window and
            non-causal cases; a 256-token chunk at pos 1280 of a 4096-slot
            cache with a NaN tail, plus one at an unaligned pos); times,
            the plain version's, the bound and the yardstick SDPA.
  step      at Llama-3-8B width (2 layers, f32 weights), kernel vs plain:
            mixed_step_paged + decode_step_ragged_paged logits and pools
            over f32, int8 and int4 pools; dense prefill, prefill_chunk
            and decode_step logits and caches with flash on vs off.
  generate  32-layer Llama-3-8B-width bf16 weights (random), sequential
            generator behind Master.generate_text: a ~1000-token prompt
            (bucket 1024, one flash_attn launch per layer) and a
            ~1500-token prompt in 256-token windows (six flash_attn_cached
            launches per layer), 32 greedy tokens each; then the
            `python3 -m cake_tpu_torch.cli` one-shot command on the card.
  serve     the same weights behind the HTTP API: concurrent chat
            requests, buffered and SSE, through the paged engine, over a
            bf16 pool, then --kv-dtype int8, then int4; each run's two
            ragged kernels must have run and no plain fold.

The line before last is a JSON `kernels` record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or `cake_tpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

PHASES = ("device", "kernels", "step", "generate", "serve")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}   # FMA-pipe f32; bf16 TC
# kernel -> (its source, the TPU kernel it replaces)
KERNELS = {
    "rpa_decode": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                   "cake_tpu/ops/ragged_paged_attention.py:65"),
    "rpa_mixed": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                  "cake_tpu/ops/ragged_paged_attention.py:391"),
    "rpa_decode_q8": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                      "cake_tpu/ops/ragged_paged_attention.py:141"),
    "rpa_mixed_q8": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                     "cake_tpu/ops/ragged_paged_attention.py:479"),
    "rpa_decode_q4": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                      "cake_tpu/ops/ragged_paged_attention.py:223"),
    "rpa_mixed_q4": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                     "cake_tpu/ops/ragged_paged_attention.py:557"),
    "flash_attn": ("cake_tpu_torch/csrc/flash_attention.cu",
                   "cake_tpu/ops/flash_attention.py:74"),
    "flash_attn_cached": ("cake_tpu_torch/csrc/flash_attention.cu",
                          "cake_tpu/ops/flash_attention.py:125"),
}
TOL = {"float32": dict(atol=1e-4, rtol=0.0),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# -- phase: device -------------------------------------------------------------


def phase_device(torch, rpa, fa) -> str:
    from cake_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout else "unknown"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    cuda_build.build_libraries([rpa.SOURCE, fa.SOURCE])   # nvcc in parallel
    rpa.LIBRARY.get()
    fa.LIBRARY.get()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s for both libraries")
    for src in (rpa.SOURCE, fa.SOURCE):
        info = cuda_build.BUILD_INFO.get(src, {})
        log(f"  {os.path.basename(src)}: nvcc {info.get('seconds', 0.0):.2f} s")
        for line in info.get("ptxas", "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")
    return card


# -- phase: kernels ------------------------------------------------------------


def _time_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn() after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _kernel_case(torch, dtype, gen, mixed: bool, fmt=None):
    """Serving-shape inputs: ragged positions, page boundaries, an
    unmapped hole, a dead row; for the mixed kernel decode rows, chunk
    rows at odd page offsets and an idle (q_len = 0) row. Pages are in
    q's dtype, or with fmt "int8"/"int4" written from a normal draw by
    the port's qwrite_prompt_pages (the kernel's scale arguments go in
    the returned kwargs)."""
    from cake_tpu_torch.kv.quantized_pool import (
        Int4Pool, QuantPool, qwrite_prompt_pages,
    )

    dev = "cuda"
    B, H, KV, hd, P, MP, N = 8, 32, 8, 128, 128, 16, 128
    C = 64 if mixed else 1
    kw = {}
    if fmt is None:
        pool_k = torch.randn((N, P, KV, hd), generator=gen, device=dev,
                             dtype=dtype)
        pool_v = torch.randn((N, P, KV, hd), generator=gen, device=dev,
                             dtype=dtype)
    else:
        cls, rows = ((Int4Pool, P // 2) if fmt == "int4"
                     else (QuantPool, P))
        every = torch.arange(N, dtype=torch.int32, device=dev)
        pools = []
        for _ in range(2):
            pool = cls(torch.zeros((N, rows, KV, hd), device=dev,
                                   dtype=(torch.uint8 if fmt == "int4"
                                          else torch.int8)),
                       torch.zeros((N, KV), device=dev))
            vals = torch.randn((1, N * P, KV, hd), generator=gen, device=dev)
            pools.append(qwrite_prompt_pages(pool, vals, every))
        (pool_k, sk), (pool_v, sv) = pools
        kw = dict(scale_k=sk, scale_v=sv, packed4=fmt == "int4")
    q = torch.randn((B, C, H, hd), generator=gen, device=dev, dtype=dtype)
    perm = torch.randperm(N, generator=gen, device=dev).to(torch.int32)
    table = perm.reshape(B, MP).clone()
    if mixed:
        pos = [2047, 127, 5 * P + 77, 3 * P + 100, 0, 9 * P + 127,
               1000, 400]
        q_len = [1, 64, 64, 0, 1, 37, 1, 64]
    else:
        pos = [0, 127, 128, 2 * P + 5, 1000, 2047, 4 * P, 300]
        q_len = None
    table[3, 1] = -1                  # unmapped hole inside the live range
    table[7 if not mixed else 4] = -1  # a dead row (every page unmapped)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    ql_t = (torch.tensor(q_len, dtype=torch.int32, device=dev)
            if mixed else None)
    return q, pool_k, pool_v, table, pos_t, ql_t, kw


def _work(q, P, KV, table, pos, q_len, elem_bytes, page_bytes=0):
    """(bytes, operations) the function needs on these inputs: every
    live, mapped K/V slot (elem_bytes per element) and the table entries
    of the live range read once, plus page_bytes per live mapped page
    (the scales of quantized pages); q read only for the query columns
    that attend to a slot (the output is zero elsewhere, whatever q
    holds); the whole output written once; 4*hd operations per (query
    head, attended slot)."""
    B, C, H, hd = q.shape
    tab = table.tolist()
    pos_l = pos.tolist()
    ql = q_len.tolist() if q_len is not None else [1] * B
    kv_slots = 0
    live_pages = 0
    attended = 0
    q_cols = 0
    table_entries = 0
    for b in range(B):
        if ql[b] == 0:
            continue
        last = pos_l[b] + ql[b] - 1
        n_pages = min(len(tab[b]), last // P + 1)
        table_entries += n_pages
        per_col = [0] * ql[b]
        for j in range(n_pages):
            if tab[b][j] < 0:
                continue
            lo = j * P
            live_pages += 1
            kv_slots += min(P, last - lo + 1)
            for i in range(ql[b]):
                per_col[i] += max(0, min(P, pos_l[b] + i - lo + 1))
        attended += sum(per_col)
        q_cols += sum(1 for n in per_col if n > 0)
    row_bytes = H * hd * q.element_size()
    nbytes = (2 * kv_slots * KV * hd * elem_bytes + live_pages * page_bytes
              + q_cols * row_bytes + B * C * row_bytes
              + table_entries * 4
              + 4 * B * (2 if q_len is not None else 1))
    ops = 4 * hd * attended * (H // KV) * KV
    return int(nbytes), ops


def _sdpa_yardstick(torch, q, pool_k, pool_v, table, pos, q_len):
    """One `scaled_dot_product_attention(enable_gqa=True)` call on dense
    K/V gathered to the same live lengths (a yardstick only: the port
    never calls it). Returns a closure timing just that call."""
    import torch.nn.functional as F
    B, C, H, hd = q.shape
    _, P, KV, _ = pool_k.shape
    ql = q_len if q_len is not None else torch.ones_like(pos)
    last = pos.long() + ql.long().clamp(min=1) - 1
    n_pages = int((last.max() // P + 1).item())
    idx = table[:, :n_pages].long().clamp(min=0)
    T = n_pages * P
    k = pool_k[idx].reshape(B, T, KV, hd).transpose(1, 2).contiguous()
    v = pool_v[idx].reshape(B, T, KV, hd).transpose(1, 2).contiguous()
    qq = q.transpose(1, 2).contiguous()                     # [B, H, C, hd]
    cols = torch.arange(T, device=q.device)
    horizon = pos.long()[:, None] + torch.arange(C, device=q.device)
    mapped = (table[:, :n_pages] >= 0).repeat_interleave(P, dim=1)
    mask = (cols[None, None, :] <= horizon[:, :, None]) & mapped[:, None, :]
    mask = mask[:, None]                                    # [B,1,C,T]
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def _measure(torch, label, dname, got, want, kern, plain, lib, nbytes,
             ops) -> dict:
    """Hold one kernel output against its plain version, then time the
    kernel, the plain version and the yardstick on the same inputs."""
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        fail(f"{label} {dname}: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **TOL[dname]):
        fail(f"{label} {dname}: max |kernel - plain| = {err:.3e} over "
             f"tolerance {TOL[dname]}")
    ms = _time_ms(torch, kern)
    plain_ms = _time_ms(torch, plain, reps=20)
    lib_ms = _time_ms(torch, lib)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dname] * 1e3
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=lib_ms, bytes=nbytes, ops=ops)
    log(f"{label} {dname}: max_abs_err {err:.3e} (tol {TOL[dname]}); "
        f"{ms:.4f} ms kernel, {plain_ms:.4f} ms plain, {lib_ms:.4f} ms sdpa, "
        f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}: {nbytes} B, "
        f"{ops} ops)")
    return rec


# bytes per K/V element of a quantized page; each live page also reads
# its k and v scales, 2 * 4 bytes per kv head
_ELEM_BYTES = {"int8": 1.0, "int4": 0.5}


def _rpa_kernels(torch, rpa, report) -> None:
    """The ragged kernels over f32/bf16 pages, then over int8 and int4
    pages. The quantized cases' yardstick is SDPA over the same live
    pages dequantized to q's dtype ahead of the call: it reads 2x (int8)
    or 4x (int4) the page bytes of a bf16 pool and dequantizes nothing."""
    from cake_tpu_torch.kv.quantized_pool import (
        Int4Pool, QuantPool, dequantize_pages,
    )

    gen = torch.Generator(device="cuda").manual_seed(1234)
    for fmt in (None, "int8", "int4"):
        for base, mixed in (("rpa_decode", False), ("rpa_mixed", True)):
            kern = (rpa.ragged_paged_attention_mixed if mixed
                    else rpa.ragged_paged_attention)
            plain = (rpa.ragged_paged_attention_mixed_plain if mixed
                     else rpa.ragged_paged_attention_plain)
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[-1]
                q, pk, pv, table, pos, ql, kw = _kernel_case(
                    torch, dtype, gen, mixed, fmt)
                name = rpa.kernel_name(base, kw.get("scale_k"),
                                       kw.get("packed4", False))
                args = (q, pk, pv, table, pos) + ((ql,) if mixed else ())
                got = kern(*args, **kw)
                # the dead row (and the mixed case's idle row) must come
                # back as exact zeros
                for dead in ((4, 3) if mixed else (7,)):
                    if got[dead].abs().max().item() != 0.0:
                        fail(f"{name} {dname}: dead row {dead} is not zero")
                if fmt is None:
                    dk, dv = pk, pv
                    nbytes, ops = _work(q, pk.shape[1], pk.shape[2], table,
                                        pos, ql, pk.element_size())
                else:
                    cls = Int4Pool if fmt == "int4" else QuantPool
                    every = torch.arange(pk.shape[0], device="cuda")
                    dk, dv = (dequantize_pages(cls(x, kw[s]), every).to(
                        dtype) for x, s in ((pk, "scale_k"), (pv, "scale_v")))
                    KV = pk.shape[2]
                    nbytes, ops = _work(q, dk.shape[1], KV, table, pos, ql,
                                        _ELEM_BYTES[fmt], 8 * KV)
                report[(name, dname)] = _measure(
                    torch, name, dname, got, plain(*args, **kw),
                    lambda: kern(*args, **kw), lambda: plain(*args, **kw),
                    _sdpa_yardstick(torch, q, dk, dv, table, pos, ql),
                    nbytes, ops)


# (label, kernel, shapes, options, the case the kernel table reports).
# B=1, H=32, KV=8, hd=128: Llama-3-8B prefill of one prompt.
FLASH_CASES = (
    ("flash_attn causal S=T=1024", "flash_attn",
     dict(S=1024, T=1024, pos=None), dict(), True),
    ("flash_attn window 256 S=T=1024", "flash_attn",
     dict(S=1024, T=1024, pos=None), dict(window=256), False),
    ("flash_attn non-causal S=256 T=1024", "flash_attn",
     dict(S=256, T=1024, pos=None), dict(causal=False), False),
    ("flash_attn_cached S=256 pos=1280 T=4096 NaN tail",
     "flash_attn_cached", dict(S=256, T=4096, pos=1280), dict(), True),
    ("flash_attn_cached S=256 pos=1301 T=4096 window 700 NaN tail",
     "flash_attn_cached", dict(S=256, T=4096, pos=1301), dict(window=700),
     False),
)


def _flash_work(B, S, T, H, KV, hd, pos, causal, window, elem_bytes):
    """(bytes, operations) of one flash call on these shapes: q read and
    the output written once, every key some query attends read once (k
    and v), 4*hd operations per attended (query head, key) pair."""
    base = 0 if pos is None else pos
    pairs = 0
    for i in range(S):
        qp = base + i
        hi = qp + 1 if causal else T
        lo = max(0, qp - window + 1) if window else 0
        pairs += hi - lo
    first_lo = max(0, base - window + 1) if window else 0
    keys = (base + S if causal else T) - first_lo
    nbytes = (2 * B * S * H * hd + 2 * B * keys * KV * hd) * elem_bytes
    return nbytes, 4 * hd * pairs * B * H


def _flash_sdpa(torch, q, k, v, pos, causal, window):
    """One `scaled_dot_product_attention(enable_gqa=True)` call on the
    same q/k/v (a cached case's k/v cut at the frontier, whose NaN tail
    SDPA would carry into 0 * NaN); a yardstick only, the port never
    calls it. Returns a closure timing just that call."""
    import torch.nn.functional as F
    S = q.shape[1]
    if pos is not None:
        k, v = k[:, :pos + S], v[:, :pos + S]
    qq, kk, vv = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if not causal:
        return lambda: F.scaled_dot_product_attention(qq, kk, vv,
                                                      enable_gqa=True)
    if pos is None and window is None and k.shape[1] == S:
        return lambda: F.scaled_dot_product_attention(
            qq, kk, vv, is_causal=True, enable_gqa=True)
    qp = (0 if pos is None else pos) + torch.arange(S, device=q.device)
    kp = torch.arange(k.shape[1], device=q.device)
    mask = kp[None, :] <= qp[:, None]
    if window is not None:
        mask &= kp[None, :] > qp[:, None] - window
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                                  enable_gqa=True)


def _flash_kernels(torch, fa, report) -> None:
    gen = torch.Generator(device="cuda").manual_seed(4321)
    B, H, KV, hd = 1, 32, 8, 128
    for label, name, shp, kw, main_case in FLASH_CASES:
        S, T, pos = shp["S"], shp["T"], shp["pos"]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q = torch.randn((B, S, H, hd), generator=gen, device="cuda",
                            dtype=dtype)
            k = torch.randn((B, T, KV, hd), generator=gen, device="cuda",
                            dtype=dtype)
            v = torch.randn((B, T, KV, hd), generator=gen, device="cuda",
                            dtype=dtype)
            if pos is None:
                args = (q, k, v)
                kern, plain = fa.flash_attention, fa.flash_attention_plain
            else:
                # slots at or past the frontier hold garbage: NaN here
                k[:, pos + S:] = float("nan")
                v[:, pos + S:] = float("nan")
                args = (q, k, v, pos)
                kern = fa.flash_attention_cached
                plain = fa.flash_attention_cached_plain
            causal = kw.get("causal", True)
            window = kw.get("window")
            nbytes, ops = _flash_work(B, S, T, H, KV, hd, pos, causal,
                                      window, q.element_size())
            rec = _measure(
                torch, label, dname, kern(*args, **kw), plain(*args, **kw),
                lambda: kern(*args, **kw), lambda: plain(*args, **kw),
                _flash_sdpa(torch, q, k, v, pos, causal, window), nbytes,
                ops)
            if main_case:
                report[(name, dname)] = rec


def phase_kernels(torch, rpa, fa) -> dict:
    report = {}
    _rpa_kernels(torch, rpa, report)
    _flash_kernels(torch, fa, report)
    return report


# -- phase: step ---------------------------------------------------------------


def phase_step(torch, rpa, fa) -> None:
    """At 8B width (2 layers, f32): mixed_step_paged then
    decode_step_ragged_paged, attn='kernel' vs attn='plain' from identical
    pools; then the dense prefill, prefill_chunk and decode_step with
    flash on (the CUDA kernels) vs off (the masked einsum)."""
    import dataclasses

    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.model import RopeTables
    from cake_tpu_torch.models.llama.paged import (
        PagedKVCache, decode_step_ragged_paged, mixed_step_paged,
        table_set_slot,
    )
    from cake_tpu_torch.models.llama.params import init_params

    dev = "cuda"
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=2)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = init_params(cfg, gen, device=dev, dtype=torch.float32)
    B, C, P, T = 4, 64, 128, 1024
    rope = RopeTables.create(cfg, T, device=dev)
    base = PagedKVCache.create(cfg, B, 32, P, T, dtype=torch.float32,
                               device=dev)
    for slot in range(B):
        table_set_slot(base.table, slot, list(range(slot * 8,
                                                    slot * 8 + 8)))
    # a decode row at 300 (its history is random), two chunk rows at odd
    # page offsets, an idle row
    base.k.normal_(generator=gen)
    base.v.normal_(generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, C), generator=gen,
                           device=dev, dtype=torch.int32)
    pos = torch.tensor([300, 100, 5, 0], dtype=torch.int32, device=dev)
    q_len = torch.tensor([1, 64, 37, 0], dtype=torch.int32, device=dev)
    active = q_len > 0
    out = {}
    for attn in ("kernel", "plain"):
        cache = PagedKVCache(base.k.clone(), base.v.clone(),
                             base.table.clone())
        lm, _ = mixed_step_paged(params, tokens, pos, q_len, active,
                                 cache, rope, cfg, attn=attn)
        dpos = pos + q_len.clamp(min=1) - 1 + 1
        ld, _ = decode_step_ragged_paged(params, tokens[:, :1], dpos,
                                         active, cache, rope, cfg,
                                         attn=attn)
        torch.cuda.synchronize()
        out[attn] = (lm, ld, cache)
    (lm_k, ld_k, ck), (lm_p, ld_p, cp) = out["kernel"], out["plain"]
    rows = active.nonzero().flatten()
    for what, a, b in (("mixed", lm_k, lm_p), ("decode", ld_k, ld_p)):
        err = (a[rows] - b[rows]).abs().max().item()
        log(f"step {what} logits: max |kernel - plain| = {err:.3e}")
        if not torch.isfinite(a[rows]).all() or err > 1e-3:
            fail(f"step {what}: logits differ by {err:.3e} (tol 1e-3)")
    # layer 0's pool writes see identical inputs; deeper layers' K/V
    # inherit the attention's summation-order differences
    if not (torch.equal(ck.k[0], cp.k[0]) and torch.equal(ck.v[0], cp.v[0])):
        fail("step: layer-0 pools differ between kernel and plain")
    perr = max((ck.k - cp.k).abs().max().item(),
               (ck.v - cp.v).abs().max().item())
    log(f"step pools: layer 0 identical, max |kernel - plain| = {perr:.3e}")
    if perr > 1e-4:
        fail(f"step: pools differ by {perr:.3e} (tol 1e-4)")
    del out, base
    _quant_steps(torch, rpa, cfg, params, rope, gen)
    _dense_step(torch, fa, cfg, params, rope, gen)
    del params
    torch.cuda.empty_cache()


# logits tolerance of the quantized steps, kernel vs plain: f32 queries
# and the same dequantized pages, so the attention differs only in
# summation order; but layer 1 quantizes K/V that inherit layer 0's
# differences, and a value that lands on a rounding edge moves by one
# step (1/127 or 1/7 of its page's amax)
QSTEP_TOL = {"int8": 1e-3, "int4": 1e-2}


def _quant_steps(torch, rpa, cfg, params, rope, gen) -> None:
    """The 8B-width 2-layer mixed and decode steps over an int8 and an
    int4 pool, kernel vs plain from identical pools (every page of every
    layer written by qwrite_prompt_pages from a normal draw)."""
    from cake_tpu_torch.kv.quantized_pool import (
        QUANTIZED_CACHES, qwrite_prompt_pages,
    )
    from cake_tpu_torch.models.llama.paged import (
        decode_step_ragged_paged, mixed_step_paged, table_set_slot,
    )

    dev = "cuda"
    B, C, P, T, N = 4, 64, 128, 1024, 32
    L, KV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    tokens = torch.randint(0, cfg.vocab_size, (B, C), generator=gen,
                           device=dev, dtype=torch.int32)
    pos = torch.tensor([300, 100, 5, 0], dtype=torch.int32, device=dev)
    q_len = torch.tensor([1, 64, 37, 0], dtype=torch.int32, device=dev)
    active = q_len > 0
    rows = active.nonzero().flatten()
    every = torch.arange(N, dtype=torch.int32, device=dev)
    for fmt, cls in QUANTIZED_CACHES.items():
        base = cls.create(cfg, B, N, P, T, device=dev)
        for slot in range(B):
            table_set_slot(base.table, slot, list(range(slot * 8,
                                                        slot * 8 + 8)))
        for i in range(L):
            for leaf in base.layer(i):
                vals = torch.randn((1, N * P, KV, hd), generator=gen,
                                   device=dev)
                qwrite_prompt_pages(leaf, vals, every)
        out = {}
        for attn in ("kernel", "plain"):
            cache = cls(*(type(h)(h.q.clone(), h.scale.clone())
                          for h in (base.k, base.v)), base.table.clone())
            rpa.reset_launch_counts()
            lm, _ = mixed_step_paged(params, tokens, pos, q_len, active,
                                     cache, rope, cfg, attn=attn)
            dpos = pos + q_len.clamp(min=1)
            ld, _ = decode_step_ragged_paged(params, tokens[:, :1], dpos,
                                             active, cache, rope, cfg,
                                             attn=attn)
            torch.cuda.synchronize()
            out[attn] = (lm, ld, cache, dict(rpa.LAUNCHES))
        (lm_k, ld_k, ck, nk), (lm_p, ld_p, cp, np_) = out["kernel"], \
            out["plain"]
        suffix = "_q4" if fmt == "int4" else "_q8"
        for attn, n, plain_n in (("kernel", nk, 0), ("plain", np_, L)):
            for b in ("rpa_mixed", "rpa_decode"):
                got = (n[b + suffix], n[b + suffix + "_plain"])
                want = (L - plain_n, plain_n)
                if got != want:
                    fail(f"step {fmt} ({attn}): {b}{suffix} launches/plain "
                         f"{got}, expected {want}")
        for what, a, b in (("mixed", lm_k, lm_p), ("decode", ld_k, ld_p)):
            err = (a[rows] - b[rows]).abs().max().item()
            log(f"step {fmt} {what} logits: max |kernel - plain| = "
                f"{err:.3e} (tol {QSTEP_TOL[fmt]})")
            if not torch.isfinite(a[rows]).all() or err > QSTEP_TOL[fmt]:
                fail(f"step {fmt} {what}: logits differ by {err:.3e}")
        if not all(torch.equal(x.q[0], y.q[0]) and torch.equal(
                x.scale[0], y.scale[0]) for x, y in ((ck.k, cp.k),
                                                     (ck.v, cp.v))):
            fail(f"step {fmt}: layer-0 pools differ between kernel and plain")
        steps = 0
        for x, y in ((ck.k, cp.k), (ck.v, cp.v)):
            a, b = x.q.int(), y.q.int()
            if fmt == "int4":     # compare each nibble
                a = torch.cat([a & 0xF, a >> 4])
                b = torch.cat([b & 0xF, b >> 4])
            steps = max(steps, (a - b).abs().max().item())
        log(f"step {fmt} pools: layer 0 identical, largest difference "
            f"{steps} quantization step(s)")
        if steps > 1:
            fail(f"step {fmt}: pools differ by {steps} steps (tol 1)")
        del out, base
    torch.cuda.empty_cache()


def _dense_step(torch, fa, cfg, params, rope, gen) -> None:
    """A 256-token prompt (prefill: flash_attn), a 128-token window at
    pos 256 (prefill_chunk: flash_attn_cached), one decode step at 384,
    flash on vs off over identical inputs."""
    import dataclasses

    from cake_tpu_torch.models.llama import model as dm
    from cake_tpu_torch.models.llama.cache import KVCache

    dev = "cuda"
    T = rope.cos.shape[0]
    prompt = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                           device=dev, dtype=torch.int32)
    window = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen,
                           device=dev, dtype=torch.int32)
    token = window[:, :1]
    out = {}
    for flash in (True, False):
        c = dataclasses.replace(cfg, use_flash_attention=flash)
        cache = KVCache.create(c, 1, T, dtype=torch.float32, device=dev)
        fa.reset_launch_counts()
        lp, _ = dm.prefill(params, prompt, torch.tensor([256], device=dev),
                           cache, rope, c)
        lc, _ = dm.prefill_chunk(params, window, 256,
                                 torch.tensor([127], device=dev), cache,
                                 rope, c)
        ld, _ = dm.decode_step(params, token, 384, cache, rope, c)
        torch.cuda.synchronize()
        out[flash] = (lp, lc, ld, cache, dict(fa.LAUNCHES))
    for flash, n in ((True, cfg.num_hidden_layers), (False, 0)):
        got = out[flash][4]
        if (got["flash_attn"], got["flash_attn_cached"]) != (n, n) or (
                got["flash_attn_plain"] or got["flash_attn_cached_plain"]):
            fail(f"step dense (flash {flash}): launches {got}, expected "
                 f"{n} of each kernel and no plain call")
    for i, what in enumerate(("prefill", "prefill_chunk", "decode_step")):
        a, b = out[True][i], out[False][i]
        err = (a - b).abs().max().item()
        log(f"step dense {what} logits: max |flash - einsum| = {err:.3e}")
        if not torch.isfinite(a).all() or err > 1e-3:
            fail(f"step dense {what}: logits differ by {err:.3e} (tol 1e-3)")
    ck, cp = out[True][3], out[False][3]
    if not (torch.equal(ck.k[0], cp.k[0]) and torch.equal(ck.v[0], cp.v[0])):
        fail("step dense: layer-0 caches differ between flash and einsum")
    cerr = max((ck.k - cp.k).abs().max().item(),
               (ck.v - cp.v).abs().max().item())
    log(f"step dense caches: layer 0 identical, max |flash - einsum| = "
        f"{cerr:.3e}")
    if cerr > 1e-4:
        fail(f"step dense: caches differ by {cerr:.3e} (tol 1e-4)")


# -- phase: serve --------------------------------------------------------------


def _post(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _device_time_table(prof, wall_s: float, top: int = 12) -> None:
    """Print the kernels that took the most device time in a profiled
    window, and the device's busy share of the window's wall time. Only
    kernel rows count: an operator row (aten::mm, ...) carries the time
    of the kernels it launched again."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t, e.count, e.key))
    busy = sum(t for t, _, _ in rows) / 1e3
    log(f"profile: device busy {busy:.1f} ms of {wall_s * 1e3:.1f} ms wall "
        f"({100 * busy / max(wall_s * 1e3, 1e-9):.1f}% busy)")
    for t, n, name in sorted(rows, reverse=True)[:top]:
        log(f"profile: {t / 1e3:10.2f} ms {100 * t / 1e3 / max(busy, 1e-9):5.1f}%"
            f" {n:7d}x {name[:90]}")


def _big_params(torch):
    """Llama-3-8B width and depth, random bf16 weights from a seed, made
    once for the generate and serve phases."""
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.params import init_params

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"32-layer 8B-width bf16 params on the card in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
    return cfg, params


def _profiled(torch, profile: bool, label: str, fn):
    """fn() under torch.profiler when asked (printing where the device
    time went); returns fn's result."""
    if not profile:
        return fn()
    from torch.profiler import ProfilerActivity
    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    with prof:
        out = fn()
        torch.cuda.synchronize()
    log(f"profile of {label}:")
    _device_time_table(prof, time.perf_counter() - t0)
    return out


def _prompt_of(tokenizer, n_tokens: int, system: str) -> str:
    """A user message whose chat rendering (Llama-3 template, with the
    system message) encodes to exactly n_tokens byte tokens."""
    from cake_tpu_torch.models.chat import History, Message

    h = History("llama3")
    h.add_message(Message.system(system))
    h.add_message(Message.user(""))
    overhead = len(tokenizer.encode(h.render()))
    if n_tokens < overhead:
        fail(f"a {n_tokens}-token prompt is shorter than its template "
             f"({overhead} tokens)")
    words = " ".join(f"w{i}" for i in range(n_tokens))
    return words[:n_tokens - overhead]


def phase_generate(torch, fa, cfg, params, profile: bool = False) -> dict:
    """The slice's path: Master.generate_text over the sequential
    generator at full width and depth, bf16, greedy. Run A: a prompt of
    1000 tokens, bucket 1024 (one flash_attn per layer). Run B: 1500
    tokens in 256-token windows (six flash_attn_cached per layer). Then
    the one-shot command line, in its own process on the card."""
    import dataclasses

    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.chat import Message
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.ops.sampling import SamplingConfig

    dev = "cuda"
    fcfg = dataclasses.replace(cfg, use_flash_attention=True)
    tok = ByteTokenizer(cfg.vocab_size)
    system = "You are a helpful AI assistant."
    n_new = 32

    def master(prefill_chunk=None):
        gen = LlamaGenerator(fcfg, params, tok, max_seq_len=4096,
                             sampling=SamplingConfig(temperature=0.0),
                             cache_dtype=torch.bfloat16,
                             prefill_chunk=prefill_chunk, device=dev)
        return Master(Args(sample_len=n_new, system_prompt=system),
                      text_generator=gen)

    def run(m, n_prompt):
        g = m.llm
        m.add_message(Message.system(system))
        m.add_message(Message.user(_prompt_of(tok, n_prompt, system)))
        timing = {}
        prefill_prompt = g._prefill_prompt

        def timed_prefill():
            t0 = time.perf_counter()
            logits = prefill_prompt()
            torch.cuda.synchronize()
            timing["prefill_s"] = time.perf_counter() - t0
            return logits

        g._prefill_prompt = timed_prefill
        t0 = time.perf_counter()

        def on_token(t):
            timing.setdefault("ttft_s", time.perf_counter() - t0)

        m.generate_text(on_token)
        timing.update(prompt=g._prompt_len, tokens=len(g.tokens),
                      tok_s=m.tokens_per_s,
                      eos=g.tokens[-1] in cfg.eos_token_ids)
        return timing

    # warm-up: cuBLAS handles and the kernel library, off the counts
    run(master(), 300)
    fa.reset_launch_counts()
    a = _profiled(torch, profile, "generate run A",
                  lambda: run(master(), 1000))
    counts_a = dict(fa.LAUNCHES)
    b = run(master(prefill_chunk=256), 1500)
    counts = dict(fa.LAUNCHES)
    L = cfg.num_hidden_layers
    for label, t in (("A (bucket 1024)", a), ("B (256-token windows)", b)):
        log(f"generate {label}: prompt {t['prompt']} tokens, TTFT "
            f"{t['ttft_s']:.3f} s, prefill {t['prefill_s']:.3f} s, "
            f"{t['tokens']} tokens, decode {t['tok_s']:.1f} tok/s")
        if t["tokens"] != n_new and not t["eos"]:
            fail(f"generate {label}: {t['tokens']} tokens, expected {n_new}")
    log(f"generate: launches {counts} (after run A: {counts_a})")
    want = {"flash_attn": L, "flash_attn_cached": 6 * L,
            "flash_attn_plain": 0, "flash_attn_cached_plain": 0}
    if counts != want or counts_a["flash_attn_cached"] != 0:
        fail(f"generate: launches {counts}, expected {want}")

    cmd = [sys.executable, "-m", "cake_tpu_torch.cli", "--prompt",
           "Why is the sky blue?", "--sample-len", "8"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=600)
    log(f"generate: `{' '.join(cmd[1:])}` exit {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; stdout tail "
        f"{r.stdout.strip().splitlines()[-1:]!r}")
    if r.returncode != 0:
        fail(f"generate: the command line failed:\n{r.stderr[-3000:]}")
    return counts


def phase_serve(torch, rpa, cfg, params, kv_dtype=None,
                profile: bool = False) -> dict:
    """Six concurrent chats (three SSE) of 32 greedy tokens through the
    HTTP API and the paged engine, over a bf16 pool or with kv_dtype
    "int8"/"int4" a quantized one. Returns the launch counts of the two
    kernels that pool's attention runs, read right after the run, and
    the pool's GiB."""
    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.ops.sampling import SamplingConfig

    dev = "cuda"
    args = Args(max_slots=8, max_seq_len=2048, kv_pages=128,
                kv_page_size=128, prefill_chunk=64, temperature=0.0,
                sample_len=32, dtype="bf16", kv_dtype=kv_dtype).validate()
    label = f"serve ({kv_dtype or 'bf16'} pool)"
    gen = LlamaGenerator(cfg, params, ByteTokenizer(cfg.vocab_size),
                         max_seq_len=2048,
                         sampling=SamplingConfig(temperature=0.0),
                         cache_dtype=torch.bfloat16, device=dev)
    master = Master(args, text_generator=gen)
    engine = master.make_engine()
    httpd = start(master, "127.0.0.1:0", block=False, engine=engine)
    url = (f"http://127.0.0.1:{httpd.server_address[1]}"
           "/api/v1/chat/completions")
    long_text = " ".join(f"word{i}" for i in range(60))   # ~400 tokens
    prompts = ["Why is the sky blue?", long_text, "Name three colours.",
               "Count to five.", "Tell me about pages.", "Hello there."]
    results = [None] * len(prompts)

    def one(i):
        stream = i % 2 == 1          # three SSE, three buffered
        body = {"messages": [{"role": "user", "content": prompts[i]}],
                "max_tokens": 32, "temperature": 0.0, "stream": stream}
        t_start = time.perf_counter()
        try:
            with _post(url, body) as r:
                if not stream:
                    doc = json.loads(r.read())
                    results[i] = dict(status=r.status, stream=False,
                                      text=doc["choices"][0]["message"]
                                      ["content"],
                                      wall=time.perf_counter() - t_start)
                    return
                first, chunks, finish, done = None, 0, None, False
                for raw in r:
                    line = raw.decode().strip()
                    if line == "data: [DONE]":
                        done = True
                    if not line.startswith("data: ") or done:
                        continue
                    if first is None:
                        first = time.perf_counter() - t_start
                    obj = json.loads(line[6:])
                    if "error" in obj:
                        raise RuntimeError(obj["error"])
                    if obj["choices"][0]["delta"].get("content"):
                        chunks += 1
                    finish = obj["choices"][0]["finish_reason"] or finish
                # random weights mostly pick ids outside the byte
                # tokenizer's range, so text chunks may be few; the
                # stream must still end with a stop chunk and [DONE]
                results[i] = dict(status=r.status if finish == "stop"
                                  and done else -2, stream=True,
                                  first_event_s=first, chunks=chunks,
                                  wall=time.perf_counter() - t_start)
        except Exception as e:   # noqa: BLE001
            results[i] = dict(status=-1, error=repr(e))

    def drive():
        t_serve = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        return time.perf_counter() - t_serve

    rpa.reset_launch_counts()
    wall = _profiled(torch, profile, label, drive)
    counts = dict(rpa.LAUNCHES)
    stats = engine.stats
    retired = list(engine.retired)
    httpd.shutdown()
    httpd.server_close()
    engine.stop()
    gib = engine.cache.memory_bytes() / 2**30
    log(f"{label}: launches {counts}")
    for i, r in enumerate(results):
        log(f"{label} request {i}: {r}")
        if r is None or r.get("status") != 200:
            fail(f"{label} request {i} failed: {r}")
    n_tok = [len(r.out_tokens) for r in retired]
    ttfts = [r.first_token_t - r.submit_t for r in retired]
    log(f"{label}: {len(retired)} requests retired, generated tokens "
        f"{n_tok}; TTFT p50 {statistics.median(ttfts):.3f} s; aggregate "
        f"decode {stats.decode_tokens_per_s:.1f} tok/s over "
        f"{stats.decode_time_s:.2f} s of decode; {stats.steps} engine "
        f"steps; wall {wall:.2f} s; pool {gib:.3f} GiB; "
        f"pool pages free {engine._pager.free_pages}/{engine.cache.n_pages}")
    if len(retired) != len(prompts) or any(n != 32 for n in n_tok):
        fail(f"{label}: expected {len(prompts)} requests of 32 tokens, got "
             f"{n_tok}")
    if engine._pager.free_pages != engine.cache.n_pages:
        fail(f"{label}: pages leaked after every request retired")
    suffix = {"int8": "_q8", "int4": "_q4"}.get(kv_dtype, "")
    served = [b + suffix for b in ("rpa_decode", "rpa_mixed")]
    for k in served:
        if counts[k] <= 0:
            fail(f"{label}: kernel {k} was never launched on the served "
                 "path")
    ran_plain = {k: n for k, n in counts.items() if k.endswith("_plain") and n}
    if ran_plain:
        fail(f"{label}: plain folds ran on the served path: {ran_plain}")
    del engine, master, gen, httpd
    torch.cuda.empty_cache()
    return {k: counts[k] for k in served}, gib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list out of {PHASES}")
    ap.add_argument("--profile", action="store_true",
                    help="trace generate run A and the serve runs with "
                         "torch.profiler and print where the device time "
                         "went")
    a = ap.parse_args(argv)
    phases = [p for p in a.phases.split(",") if p]
    bad = set(phases) - set(PHASES)
    if bad:
        fail(f"unknown phases {sorted(bad)}")

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "an NVIDIA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import cake_tpu_torch.ops.flash_attention as fa
        import cake_tpu_torch.ops.ragged_paged_attention as rpa
    except ImportError as e:
        fail(f"cake_tpu_torch is not importable next to this script "
             f"({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_device(torch, rpa, fa)
    kern = phase_kernels(torch, rpa, fa) if "kernels" in phases else {}
    if "step" in phases:
        phase_step(torch, rpa, fa)
    # launch counts of each path, read right after it ran (null in the
    # kernels line, not 0, when its phase did not run)
    counts = {}
    if "generate" in phases or "serve" in phases:
        cfg, params = _big_params(torch)
        if "generate" in phases:
            counts.update(phase_generate(torch, fa, cfg, params,
                                         profile=a.profile))
        if "serve" in phases:
            pools = {}
            for kv in (None, "int8", "int4"):
                got, pools[kv or "bf16"] = phase_serve(
                    torch, rpa, cfg, params, kv_dtype=kv,
                    profile=a.profile)
                counts.update(got)
            log("serve pools (128 pages x 128 tokens, 32 layers): "
                + ", ".join(f"{k} {v:.3f} GiB" for k, v in pools.items()))

    rows = []
    for name, (source, replaces) in KERNELS.items():
        rec = kern.get((name, "bfloat16"), {})
        f32 = kern.get((name, "float32"), {})
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts.get(name),
            "max_abs_err": rec.get("max_abs_err"),
            "max_abs_err_f32": f32.get("max_abs_err"),
            "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"),
            "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms"),
            "ms_f32": f32.get("ms"), "plain_ms_f32": f32.get("plain_ms"),
            "bound_ms_f32": f32.get("bound_ms"),
            "library_ms_f32": f32.get("library_ms"),
        })
    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
