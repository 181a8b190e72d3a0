"""On-card smoke test of the PyTorch/CUDA port (`cake_tpu_torch`).

    python3 chip_smoke.py                 # every phase, one H100
    python3 chip_smoke.py --phases kernels,step
    python3 chip_smoke.py --phases device,generate --profile
    python3 chip_smoke.py --phases device,kernels --kernels rpa_decode,flash_attn \
        --tree DIR            # the same cases over the package in DIR

Phases, in order (any failure exits non-zero):
  device    CUDA present; card name and power limit; the three kernel
            libraries built from csrc/ (one nvcc each, in parallel).
  kernels   each CUDA kernel against its plain PyTorch version, f32 and
            bf16 queries: the ragged paged-attention kernels at the serving
            shapes (H=32, KV=8, hd=128, 128-token pages, 16 table columns,
            B=8, C=64) over f32/bf16 pages and over int8 and int4 pages
            written by the port's qwrite_prompt_pages, and the flash pair
            at the prefill shapes (S=T=1024 causal, plus window and
            non-causal cases; a 256-token chunk at pos 1280 of a 4096-slot
            cache with a NaN tail, plus one at an unaligned pos); device
            times from a replayed CUDA graph of 30 calls (rpa_decode's
            cycling through pool copies larger than L2) with the
            host-launched time beside them, the plain version's time,
            the bound and the yardstick SDPA timed the same way;
            rpa_decode, rpa_mixed and the flash pair must give the same
            bits twice.
            Two more rpa_decode cases show its split: B = 8 with one row
            at pos 8191 (64 table columns), B = 32 rows up to 2047. Then
            the int4 matmul against its plain version at the four
            Llama-3-8B weight shapes, M = 1, 8 and 64, f32 and bf16 x,
            weights from quantize_group of seeded normals, plus a
            tiny-config shape; its yardstick is torch.matmul over the
            weight dequantized ahead of time.
  step      at Llama-3-8B width (2 layers, f32 weights), kernel vs plain:
            mixed_step_paged + decode_step_ragged_paged logits and pools
            over f32, int8 and int4 pools; dense prefill, prefill_chunk
            and decode_step logits and caches with flash on vs off; with
            int4 weights (quantize_params on the card) the dense and the
            paged decode step, kernel vs plain logits, and one prefill
            (M > 64) down the dequantize route.
  generate  32-layer Llama-3-8B-width bf16 weights (random), sequential
            generator behind Master.generate_text: a ~1000-token prompt
            (bucket 1024, one flash_attn launch per layer) and a
            ~1500-token prompt in 256-token windows (six flash_attn_cached
            launches per layer), 32 greedy tokens each; then the
            `python3 -m cake_tpu_torch.cli` one-shot command on the card.
            Then 32-layer int4 weights (init_params_quantized, bits=4)
            behind the same Master: 32 greedy tokens, 7 x 32 int4_matmul
            launches per decode step and no plain call; a few tokens
            with int8 weights; and the command line with --quant int4.
  serve     the same weights behind the HTTP API: concurrent chat
            requests, buffered and SSE, through the paged engine, over a
            bf16 pool, then --kv-dtype int8, then int4; each run's two
            ragged kernels must have run and no plain fold. Then the
            int4 weights over the bf16 pool: 224 int4_matmul launches
            per decode step.

The line before last is a JSON `kernels` record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or `cake_tpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
    "int4_matmul": ("cake_tpu_torch/csrc/int4_matmul.cu",
                    "cake_tpu/ops/int4_matmul.py:73"),
}
TOL = {"float32": dict(atol=1e-4, rtol=0.0),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# -- phase: device -------------------------------------------------------------


def phase_device(torch, *ops) -> str:
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
    sources = [op.SOURCE for op in ops]
    cuda_build.build_libraries(sources)                   # nvcc in parallel
    for op in ops:
        op.LIBRARY.get()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s for the "
        f"{len(ops)} libraries")
    for src in sources:
        info = cuda_build.BUILD_INFO.get(src, {})
        log(f"  {os.path.basename(src)}: nvcc {info.get('seconds', 0.0):.2f} s")
        entry = ""
        for line in info.get("ptxas", "").splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line:
                log(f"    ptxas: {entry}: {line.split(':', 1)[-1].strip()}")
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


def _measure(torch, label, dname, got, want, kerns, plain, libs, nbytes,
             ops, again=None) -> dict:
    """Hold one kernel output against its plain version (and, given
    `again`, a second launch on the same inputs against the first, bit
    for bit), then time the kernel, the plain version and the yardstick
    on the same inputs. kerns / libs: the kernel's and the yardstick's
    calls, one per copy of the inputs where a copy is cycled through (see
    _stream_ms): device time by graph replay, the host-launched time
    beside it. The plain version is timed from the host (milliseconds)."""
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        fail(f"{label} {dname}: non-finite output")
    if again is not None and not torch.equal(got, again):
        fail(f"{label} {dname}: two launches on the same inputs differ")
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **TOL[dname]):
        fail(f"{label} {dname}: max |kernel - plain| = {err:.3e} over "
             f"tolerance {TOL[dname]}")
    ms, eager_ms = _stream_ms(torch, kerns)
    plain_ms = _time_ms(torch, plain, reps=10, warmup=1)
    lib_ms, lib_eager_ms = _stream_ms(torch, libs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dname] * 1e3
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=lib_ms, bytes=nbytes, ops=ops, eager_ms=eager_ms,
               library_eager_ms=lib_eager_ms)
    log(f"{label} {dname}: max_abs_err {err:.3e} (tol {TOL[dname]}"
        f"{', same bits twice' if again is not None else ''}); "
        f"{ms:.4f} ms kernel ({eager_ms:.4f} eager), {plain_ms:.4f} ms plain, "
        f"{lib_ms:.4f} ms sdpa ({lib_eager_ms:.4f} eager), bound "
        f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}: {nbytes} B, {ops} "
        f"ops); {rec['bound_ms'] and ms / rec['bound_ms']:.1f}x bound")
    return rec


# bytes per K/V element of a quantized page; each live page also reads
# its k and v scales, 2 * 4 bytes per kv head
_ELEM_BYTES = {"int8": 1.0, "int4": 0.5}


def _rpa_kernels(torch, rpa, report, only=None) -> None:
    """The ragged kernels over f32/bf16 pages, then over int8 and int4
    pages. The quantized cases' yardstick is SDPA over the same live
    pages dequantized to q's dtype ahead of the call: it reads 2x (int8)
    or 4x (int4) the page bytes of a bf16 pool and dequantizes nothing.
    rpa_decode cycles through pool copies larger than L2 (a served
    decode step finds each layer's pool cold) and must give the same
    bits twice. `only`: the kernel names to run (None: all)."""
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
                if only is not None and name not in only:
                    continue
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
                pools = [(pk, pv, dk, dv)]
                if name == "rpa_decode":
                    pools += [(a, b, a, b) for a, b in zip(
                        _copies(pk, 2 * pk.numel() * pk.element_size())[1:],
                        _copies(pv, 2 * pv.numel() * pv.element_size())[1:])]
                rest = args[3:]
                report[(name, dname)] = _measure(
                    torch, name, dname, got, plain(*args, **kw),
                    [(lambda a=a, b=b: kern(q, a, b, *rest, **kw))
                     for a, b, _, _ in pools],
                    lambda: plain(*args, **kw),
                    [_sdpa_yardstick(torch, q, c, d, table, pos, ql)
                     for _, _, c, d in pools],
                    nbytes, ops,
                    again=(kern(*args, **kw)
                           if name in ("rpa_decode", "rpa_mixed") else None))
                if name == "rpa_mixed" and hasattr(rpa, "mixed_split_plan"):
                    tc = rpa.mixed_takes_tc(q, pk, pv, kw.get("scale_k"))
                    plan = rpa.mixed_split_plan(
                        *q.shape[:3], pk.shape[2], q.shape[3], table.shape[1],
                        pk.shape[1], rpa.sm_count("cuda"))
                    log(f"rpa_mixed {dname}: "
                        + (f"tensor-core body, plan (splits, pages a split) "
                           f"{plan}" if tc else "rpa_cta"))
                del pools
    torch.cuda.empty_cache()


def _split_cases(torch, rpa) -> None:
    """Two logged decode cases that show the split of rpa_decode (bf16,
    128-token pages, H=32, KV=8, hd=128; pools cycled past L2): B = 8
    with one row at pos 8191 (64 table columns) beside rows at
    0..2047, and B = 32 rows at mixed positions up to 2047. Each against
    its plain version, with the plan, device time, bound and SDPA."""
    gen = torch.Generator(device="cuda").manual_seed(777)
    H, KV, hd, P, dtype = 32, 8, 128, 128, torch.bfloat16
    cases = (
        ("B=8 one row at 8191", 8, 64,
         [8191, 0, 127, 500, 1000, 1500, 2047, 300]),
        ("B=32 mixed up to 2047", 32, 16,
         [int(x) for x in torch.randint(0, 2048, (32,), generator=gen,
                                        device="cuda").tolist()]),
    )
    for label, B, MP, pos_l in cases:
        N = 256
        pk = torch.randn((N, P, KV, hd), generator=gen, device="cuda",
                         dtype=dtype)
        pv = torch.randn((N, P, KV, hd), generator=gen, device="cuda",
                         dtype=dtype)
        table = torch.randint(0, N, (B, MP), generator=gen, device="cuda",
                              dtype=torch.int32)
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
        q = torch.randn((B, 1, H, hd), generator=gen, device="cuda",
                        dtype=dtype)
        args = (q, pk, pv, table, pos)
        got = rpa.ragged_paged_attention(*args)
        pools = [(pk, pv)] + list(zip(
            _copies(pk, 2 * pk.numel() * pk.element_size())[1:],
            _copies(pv, 2 * pv.numel() * pv.element_size())[1:]))
        nbytes, ops = _work(q, P, KV, table, pos, None, pk.element_size())
        plan = (rpa.split_plan(B, KV, MP, P, rpa.sm_count("cuda"))
                if hasattr(rpa, "split_plan") else "none")
        log(f"rpa_decode split case {label}: plan (splits, pages a split) "
            f"{plan}")
        _measure(torch, f"rpa_decode {label}", "bfloat16", got,
                 rpa.ragged_paged_attention_plain(*args),
                 [(lambda a=a, b=b: rpa.ragged_paged_attention(
                     q, a, b, table, pos)) for a, b in pools],
                 lambda: rpa.ragged_paged_attention_plain(*args),
                 [_sdpa_yardstick(torch, q, a, b, table, pos, None)
                  for a, b in pools], nbytes, ops,
                 again=rpa.ragged_paged_attention(*args))
        del pools, pk, pv
        torch.cuda.empty_cache()


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


def _flash_kernels(torch, fa, report, only=None) -> None:
    gen = torch.Generator(device="cuda").manual_seed(4321)
    B, H, KV, hd = 1, 32, 8, 128
    for label, name, shp, kw, main_case in FLASH_CASES:
        if only is not None and name not in only:
            continue
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
                [lambda: kern(*args, **kw)], lambda: plain(*args, **kw),
                [_flash_sdpa(torch, q, k, v, pos, causal, window)], nbytes,
                ops, again=kern(*args, **kw))
            if pos is not None and hasattr(fa, "flash_split_plan") and \
                    dtype != torch.float32:
                n_sm = fa.device_sm_count("cuda")
                splits = fa.flash_split_plan(B, S, T, H, KV, n_sm,
                                             fa.CACHED_WARPS)
                log(f"{label} {dname}: tensor-core body, {fa.CACHED_WARPS} "
                    f"warps a CTA, {splits} key splits on {n_sm} SMs")
            if main_case:
                report[(name, dname)] = rec


# (In, Out) of the Llama-3-8B block weights: wq/wo, wk/wv, w_gate/w_up,
# w_down; g = 128. The kernel table reports w_gate/w_up at M = 1 (the
# generator's decode step)
INT4_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
INT4_MAIN = (1, 4096, 14336)
# int4_matmul against its plain version: the same products summed in f32
# in another order (for bf16 x every product is exact in f32), so at f32
# the difference stays under 1e-5 of the largest output; at bf16 the two
# f32 sums round to bf16 apart by at most one unit, 2^-7 relative
INT4_ATOL_OF_MAX = 1e-5
INT4_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}


def _stream_ms(torch, fns, reps: int = 30, rounds: int = 5):
    """(device ms, eager ms) of one call, each the median over `rounds`
    of the mean of `reps` back-to-back calls cycling through `fns`: the
    same function over copies of its weight that together exceed the L2
    cache, so each call streams its weight from device memory as a
    layer's does in a decode step. Device: the calls captured once into
    a CUDA graph and replayed, so no host time lies between the
    launches; eager: the calls made from Python, where a product of a
    few microseconds waits for its wrapper."""
    def burst():
        for i in range(reps):
            fns[i % len(fns)]()

    def timed(fn):
        times = []
        for _ in range(rounds):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    eager = timed(burst)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm up on the capture's own stream
        burst()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        burst()
    graph.replay()
    torch.cuda.synchronize()
    device = timed(graph.replay)
    del graph
    return device, eager


def _copies(t, nbytes: int):
    """t and enough clones of it to hold 100 MB, twice the L2 cache."""
    n = max(2, -(-100_000_000 // max(nbytes, 1)))
    return [t] + [t.clone() for _ in range(n - 1)]


def _int4_kernels(torch, i4, report) -> None:
    from cake_tpu_torch.ops.quant import group_size, quantize_group

    gen = torch.Generator(device="cuda").manual_seed(99)
    shapes = [(m, i, o) for (i, o) in INT4_SHAPES for m in (1, 8, 64)]
    shapes.append((2, 64, 32))         # the tiny config's wk/wv, g = 64
    weights = {}
    for M, In, Out in shapes:
        if (In, Out) not in weights:
            w = torch.randn((In, Out), generator=gen, device="cuda")
            weights[(In, Out)] = quantize_group(w * In ** -0.5, 0)
            del w
        qt = weights[(In, Out)]
        g = group_size(qt)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x = torch.randn((M, In), generator=gen, device="cuda").to(dtype)
            got = i4.int4_matmul(x, qt.q, qt.scale, g=g)
            again = i4.int4_matmul(x, qt.q, qt.scale, g=g)
            want = i4.int4_matmul_plain(x, qt.q, qt.scale, g=g)
            torch.cuda.synchronize()
            label = f"int4_matmul M={M} In={In} Out={Out} g={g} {dname}"
            if not torch.isfinite(got.float()).all():
                fail(f"{label}: non-finite output")
            if not torch.equal(got, again):
                fail(f"{label}: two launches on the same inputs differ")
            err = (got.float() - want.float()).abs().max().item()
            atol = INT4_ATOL_OF_MAX * want.float().abs().max().item()
            if not torch.allclose(got.float(), want.float(), atol=atol,
                                  rtol=INT4_RTOL[dname]):
                fail(f"{label}: max |kernel - plain| = {err:.3e} over "
                     f"atol {atol:.3e} rtol {INT4_RTOL[dname]}")
            if In < 1024:
                log(f"{label}: max_abs_err {err:.3e} (atol {atol:.3e})")
                continue
            wbytes = qt.q.numel() + 4 * qt.scale.numel()
            nbytes = wbytes + (M * In + M * Out) * x.element_size()
            ops = 2 * M * In * Out
            qs = _copies(qt.q, wbytes)
            ss = [qt.scale.clone() for _ in qs]
            ms, eager_ms = _stream_ms(torch, [
                (lambda q=q, s=s: i4.int4_matmul(x, q, s, g=g))
                for q, s in zip(qs, ss)])
            plain_ms = _time_ms(
                torch, lambda: i4.int4_matmul_plain(x, qt.q, qt.scale, g=g),
                reps=5, warmup=1)
            # yardstick: one torch.matmul over the weight dequantized to
            # x's dtype ahead of time (4x or 8x the bytes, no unpacking)
            wd = (i4.unpack_int4(qt.q, g).to(dtype).reshape(In // g, g, Out)
                  * qt.scale[:, None, :].to(dtype)).reshape(In, Out)
            wds = _copies(wd, wd.numel() * wd.element_size())
            lib_ms, lib_eager_ms = _stream_ms(
                torch, [(lambda w=w: torch.matmul(x, w)) for w in wds])
            del qs, ss, wd, wds
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[dname] * 1e3
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       library_ms=lib_ms, bytes=nbytes, ops=ops,
                       eager_ms=eager_ms, library_eager_ms=lib_eager_ms)
            log(f"{label}: max_abs_err {err:.3e} (atol {atol:.3e}, rtol "
                f"{INT4_RTOL[dname]}); {ms:.4f} ms kernel ({eager_ms:.4f} "
                f"eager), {plain_ms:.4f} ms plain, {lib_ms:.4f} ms matmul of "
                f"the dequantized weight ({lib_eager_ms:.4f} eager), bound "
                f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}: {nbytes} B, "
                f"{ops} ops)")
            if (M, In, Out) == INT4_MAIN:
                report[("int4_matmul", dname)] = rec
    torch.cuda.empty_cache()


def int4_sweep(torch, i4, targets) -> None:
    """Device time of int4_matmul (graph replay, bf16 x, M = 1 and 8) at
    the four Llama-3-8B weight shapes for each value of TARGET_BLOCKS,
    the block count its split over the group axis aims at."""
    from cake_tpu_torch.ops.quant import group_size, quantize_group

    gen = torch.Generator(device="cuda").manual_seed(99)
    for In, Out in INT4_SHAPES:
        w = torch.randn((In, Out), generator=gen, device="cuda")
        qt = quantize_group(w * In ** -0.5, 0)
        del w
        g = group_size(qt)
        wbytes = qt.q.numel() + 4 * qt.scale.numel()
        qs = _copies(qt.q, wbytes)
        ss = [qt.scale.clone() for _ in qs]
        for M in (1, 8):
            x = torch.randn((M, In), generator=gen,
                            device="cuda").to(torch.bfloat16)
            cells = []
            for target in targets:
                i4.TARGET_BLOCKS = target
                ms, _ = _stream_ms(torch, [
                    (lambda q=q, s=s: i4.int4_matmul(x, q, s, g=g))
                    for q, s in zip(qs, ss)])
                cells.append(f"{target}: {ms:.4f} ms "
                             f"({i4.split_groups(M, In // g, Out)} splits)")
            log(f"int4 sweep M={M} In={In} Out={Out}: " + ", ".join(cells))


def phase_kernels(torch, rpa, fa, i4, only=None) -> dict:
    """Every kernel against its plain version, timed; `only` restricts
    the phase to some kernel names (with rpa_decode, its split cases)."""
    report = {}
    _rpa_kernels(torch, rpa, report, only)
    if only is None or "rpa_decode" in only:
        _split_cases(torch, rpa)
    _flash_kernels(torch, fa, report, only)
    if only is None or "int4_matmul" in only:
        _int4_kernels(torch, i4, report)
    return report


# -- phase: step ---------------------------------------------------------------


def phase_step(torch, rpa, fa, i4) -> None:
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
    _int4_steps(torch, i4, cfg, params, rope, gen)
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


class _plain_int4:
    """Inside the block, `int4_matmul` is its plain version even for CUDA
    tensors (the wrapper itself never takes it for one): the reference
    side of a kernel-vs-plain comparison of whole steps."""

    def __init__(self, i4):
        self.i4 = i4

    def __enter__(self):
        self.kernel = self.i4.int4_matmul
        self.i4.int4_matmul = self.i4.int4_matmul_plain

    def __exit__(self, *exc):
        self.i4.int4_matmul = self.kernel


def _int4_steps(torch, i4, cfg, params, rope, gen) -> None:
    """int4 weights at 8B width, 2 layers, f32 activations: the f32 tree
    quantized on the card by quantize_params (bits=4); a dense decode
    step and a paged decode step of 4 rows, kernel vs plain logits; then
    a 256-token prefill, whose M > 64 products take the dequantize
    route."""
    import contextlib

    from cake_tpu_torch.models.llama import model as dm
    from cake_tpu_torch.models.llama.cache import KVCache
    from cake_tpu_torch.models.llama.paged import (
        PagedKVCache, decode_step_ragged_paged, table_set_slot,
    )
    from cake_tpu_torch.ops.quant import quantize_params

    dev = "cuda"
    L = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    qparams = quantize_params(params, bits=4)
    torch.cuda.synchronize()
    log(f"step int4: quantize_params(bits=4) of the 2-layer f32 tree on the "
        f"card: peak {(torch.cuda.max_memory_allocated() - before) / 2**30:.2f}"
        f" GiB above the {before / 2**30:.2f} GiB already held")
    T = rope.cos.shape[0]
    B, P = 4, 128
    prompt = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                           device=dev, dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                         device=dev, dtype=torch.int32)
    pos = torch.tensor([300, 100, 5, 640], dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    base_k = torch.randn((L, 32, P, cfg.num_key_value_heads, cfg.head_dim),
                         generator=gen, device=dev)
    base_v = torch.randn(base_k.shape, generator=gen, device=dev)
    out = {}
    for route in ("kernel", "plain"):
        ctx = _plain_int4(i4) if route == "plain" else contextlib.nullcontext()
        dense = KVCache.create(cfg, 1, T, dtype=torch.float32, device=dev)
        dense.k.normal_(generator=torch.Generator(device=dev).manual_seed(5))
        dense.v.normal_(generator=torch.Generator(device=dev).manual_seed(6))
        paged = PagedKVCache.create(cfg, B, 32, P, T, dtype=torch.float32,
                                    device=dev)
        paged.k.copy_(base_k)
        paged.v.copy_(base_v)
        for slot in range(B):
            table_set_slot(paged.table, slot,
                           list(range(slot * 8, slot * 8 + 8)))
        i4.reset_launch_counts()
        with ctx:
            ld, _ = dm.decode_step(qparams, toks[:1], 384, dense, rope, cfg)
            lp, _ = decode_step_ragged_paged(qparams, toks, pos, active,
                                             paged, rope, cfg)
        torch.cuda.synchronize()
        out[route] = (ld, lp, dict(i4.LAUNCHES))
    for route, want in (("kernel", (14 * L, 0)), ("plain", (0, 14 * L))):
        n = out[route][2]
        if (n["int4_matmul"], n["int4_matmul_plain"]) != want:
            fail(f"step int4 ({route}): launches {n}, expected {want}")
    for i, what in enumerate(("dense decode_step", "paged decode step")):
        a, b = out["kernel"][i], out["plain"][i]
        err = (a - b).abs().max().item()
        log(f"step int4 {what} logits: max |kernel - plain| = {err:.3e}")
        if not torch.isfinite(a).all() or err > 1e-3:
            fail(f"step int4 {what}: logits differ by {err:.3e} (tol 1e-3)")
    # the same weights dequantized ahead of time into plain f32 tensors:
    # the reference of the dequantize route (same function, other
    # summation order)
    from cake_tpu_torch.ops.quant import (
        QTensor, dequantize_group, is_groupwise,
    )

    def dequantized(w):
        if not isinstance(w, QTensor):
            return w
        if not is_groupwise(w):
            return w.q.float() * w.scale
        return dequantize_group(w, torch.float32)

    dq = {k: dequantized(v) for k, v in qparams.items() if k != "blocks"}
    dq["blocks"] = {k: dequantized(v) for k, v in qparams["blocks"].items()}
    logits = []
    i4.reset_launch_counts()
    for tree in (qparams, dq, params):
        cache = KVCache.create(cfg, 1, T, dtype=torch.float32, device=dev)
        lg, _ = dm.prefill(tree, prompt, torch.tensor([256], device=dev),
                           cache, rope, cfg)
        logits.append(lg)
    torch.cuda.synchronize()
    if sum(i4.LAUNCHES.values()) != 0:
        fail(f"step int4 prefill: an M = 256 product reached int4_matmul "
             f"({i4.LAUNCHES}); it takes the dequantize route")
    lq, ld, lf = logits
    err = (lq - ld).abs().max().item()
    log(f"step int4 prefill (M = 256, dequantize route): max |QTensor - "
        f"weights dequantized ahead| = {err:.3e}; against the f32 weights "
        f"the int4 rounding moves the logits by {(lq - lf).std().item():.3e}"
        f" rms (their spread {lf.std().item():.3e})")
    if not torch.isfinite(lq).all() or err > 1e-3:
        fail(f"step int4 prefill: logits differ by {err:.3e} (tol 1e-3)")
    del dq, logits
    del qparams, out, base_k, base_v
    torch.cuda.empty_cache()


# -- phase: serve --------------------------------------------------------------


def _post(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


_PORT_KERNEL = re.compile(r"\(anonymous namespace\)::(rpa_|flash_|int4_)")


def _device_time_table(prof, wall_s: float, top: int = 12) -> None:
    """Print the kernels that took the most device time in a profiled
    window, then the port's own kernels (csrc/) ranked below them, and
    the device's busy share of the window's wall time. Only
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
    for i, (t, n, name) in enumerate(sorted(rows, reverse=True)):
        if i < top or _PORT_KERNEL.search(name):
            log(f"profile: {t / 1e3:10.2f} ms "
                f"{100 * t / 1e3 / max(busy, 1e-9):5.1f}% {n:7d}x {name[:90]}")


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

    def run(m, n_prompt, prefill_label=None):
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

        g._prefill_prompt = timed_prefill if prefill_label is None else \
            (lambda: _profiled(torch, profile, prefill_label, timed_prefill))
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
    b = run(master(prefill_chunk=256), 1500, "generate run B's prefill")
    counts = dict(fa.LAUNCHES)
    L = cfg.num_hidden_layers
    for label, t in (("A (bucket 1024)", a), ("B (256-token windows)", b)):
        log(f"generate {label}: prompt {t['prompt']} tokens, TTFT "
            f"{t['ttft_s']:.3f} s, prefill {t['prefill_s']:.3f} s, "
            f"{t['tokens']} tokens, decode {t['tok_s']:.1f} tok/s")
        if t["tokens"] != n_new and not t["eos"]:
            fail(f"generate {label}: {t['tokens']} tokens, expected {n_new}")
    log(f"generate: launches {counts} (after run A: {counts_a})")
    if hasattr(fa, "flash_split_plan"):
        splits = fa.flash_split_plan(
            1, 256, 4096, cfg.num_attention_heads, cfg.num_key_value_heads,
            fa.device_sm_count("cuda"), fa.CACHED_WARPS)
        log(f"generate B: flash_attn_cached over bf16 runs the tensor-core "
            f"body at {fa.CACHED_WARPS} warps a CTA, {splits} key splits "
            "a 256-token window")
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


def phase_generate_quant(torch, i4, cfg) -> dict:
    """The weight-quantized path: Master.generate_text over 32-layer
    8B-width int4 weights (init_params_quantized, bits=4), a 300-token
    prompt (prefill: the dequantize route) and 32 greedy tokens (decode:
    7 int4_matmul launches per layer and step, no plain call); the same
    with int8 weights for 4 tokens; then the command line with --quant
    int4 in its own process (the tiny model: context._maybe_quantize and
    the gate's small shapes on the card). Returns the int4 params and the
    int4 run's launch counts."""
    import dataclasses

    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.chat import Message
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.models.llama.params import (
        init_params_quantized, params_bytes,
    )
    from cake_tpu_torch.ops.sampling import SamplingConfig

    dev = "cuda"
    fcfg = dataclasses.replace(cfg, use_flash_attention=True)
    tok = ByteTokenizer(cfg.vocab_size)
    system = "You are a helpful AI assistant."
    L = cfg.num_hidden_layers

    def run(params, quant, n_new):
        gen = LlamaGenerator(fcfg, params, tok, max_seq_len=4096,
                             sampling=SamplingConfig(temperature=0.0),
                             cache_dtype=torch.bfloat16, device=dev)
        m = Master(Args(sample_len=n_new, system_prompt=system, quant=quant),
                   text_generator=gen)
        m.add_message(Message.system(system))
        m.add_message(Message.user(_prompt_of(tok, 300, system)))
        t0 = time.perf_counter()
        timing = {}
        m.generate_text(
            lambda t: timing.setdefault("ttft_s", time.perf_counter() - t0))
        torch.cuda.synchronize()
        g = m.llm
        timing.update(prompt=g._prompt_len, tokens=len(g.tokens),
                      tok_s=m.tokens_per_s,
                      eos=g.tokens[-1] in cfg.eos_token_ids)
        return timing

    def made(bits):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = init_params_quantized(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
            dtype=torch.bfloat16, bits=bits)
        torch.cuda.synchronize()
        log(f"generate int{bits}: 32-layer 8B-width params on the card in "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{params_bytes(params) / 2**30:.3f} GiB of tensors, peak "
            f"{(torch.cuda.max_memory_allocated() - before) / 2**30:.3f} GiB "
            "while making them")
        return params

    q4 = made(4)
    run(q4, "int4", 4)            # warm-up, off the counts
    i4.reset_launch_counts()
    t = run(q4, "int4", 32)
    counts = dict(i4.LAUNCHES)
    log(f"generate int4: prompt {t['prompt']} tokens, TTFT {t['ttft_s']:.3f} "
        f"s, {t['tokens']} tokens, decode {t['tok_s']:.1f} tok/s; launches "
        f"{counts}")
    if t["tokens"] != 32 and not t["eos"]:
        fail(f"generate int4: {t['tokens']} tokens, expected 32")
    # token 1 comes from the prefill (M = its bucket > 64: the dequantize
    # route), every later one from a decode step
    want = 7 * L * (t["tokens"] - 1)
    if counts != {"int4_matmul": want, "int4_matmul_plain": 0}:
        fail(f"generate int4: launches {counts}, expected {want} (7 x {L} "
             "per decode step) and no plain call")

    q8 = made(8)
    i4.reset_launch_counts()
    t8 = run(q8, "int8", 4)
    log(f"generate int8: prompt {t8['prompt']} tokens, TTFT "
        f"{t8['ttft_s']:.3f} s, {t8['tokens']} tokens, decode "
        f"{t8['tok_s']:.1f} tok/s (plain PyTorch: each weight is converted "
        "to the activation dtype before its product)")
    if t8["tokens"] != 4 and not t8["eos"]:
        fail(f"generate int8: {t8['tokens']} tokens, expected 4")
    if sum(i4.LAUNCHES.values()) != 0:
        fail(f"generate int8: int4_matmul ran ({i4.LAUNCHES})")
    del q8
    torch.cuda.empty_cache()

    cmd = [sys.executable, "-m", "cake_tpu_torch.cli", "--quant", "int4",
           "--prompt", "Why is the sky blue?", "--sample-len", "8"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=600)
    log(f"generate int4: `{' '.join(cmd[1:])}` exit {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; stdout tail "
        f"{r.stdout.strip().splitlines()[-1:]!r}")
    if r.returncode != 0 or "weights quantized to int4" not in r.stderr:
        fail(f"generate int4: the command line failed:\n{r.stderr[-3000:]}")
    return q4, counts


def phase_serve(torch, rpa, cfg, params, kv_dtype=None,
                profile: bool = False, i4=None) -> dict:
    """Six concurrent chats (three SSE) of 32 greedy tokens through the
    HTTP API and the paged engine, over a bf16 pool or with kv_dtype
    "int8"/"int4" a quantized one. Returns the launch counts of the two
    kernels that pool's attention runs, read right after the run, and
    the pool's GiB. With `i4` (the int4 matmul module) `params` hold int4
    weights: its launches are counted and returned too, 7 per layer and
    decode step (a mixed step's 8 x 64 rows take the dequantize route)."""
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
    label = f"serve ({kv_dtype or 'bf16'} pool{', int4 weights' if i4 else ''})"
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
    if i4 is not None:
        i4.reset_launch_counts()
    wall = _profiled(torch, profile, label, drive)
    # an SSE client reads its last chunk before the engine releases the
    # request's pages and retires it, so wait for the engine to retire
    # every request before reading its records
    deadline = time.monotonic() + 30.0
    while len(engine.retired) < len(prompts) and time.monotonic() < deadline:
        time.sleep(0.01)
    counts = dict(rpa.LAUNCHES)
    if i4 is not None:
        counts.update(i4.LAUNCHES)
    stats = engine.stats
    retired = list(engine.retired)
    httpd.shutdown()
    httpd.server_close()
    engine.stop()
    gib = engine.cache.memory_bytes() / 2**30
    log(f"{label}: launches {counts}")
    if kv_dtype is None and hasattr(rpa, "mixed_split_plan"):
        plan = rpa.mixed_split_plan(
            8, 64, cfg.num_attention_heads, cfg.num_key_value_heads,
            cfg.head_dim, 2048 // 128, 128, rpa.sm_count("cuda"))
        log(f"{label}: rpa_mixed over the bf16 pool runs the tensor-core "
            f"body, plan (splits, pages a split) {plan} at B = 8, C = 64, "
            "16 table columns")
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
    if i4 is not None:
        served.append("int4_matmul")
        L = cfg.num_hidden_layers
        want = 7 * counts["rpa_decode" + suffix]     # 32 per decode step
        if counts["int4_matmul"] != want or want <= 0:
            fail(f"{label}: {counts['int4_matmul']} int4_matmul launches, "
                 f"expected {want} (7 x {L} per decode step)")
    del engine, master, gen, httpd
    torch.cuda.empty_cache()
    return {k: counts[k] for k in served}, gib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list out of {PHASES}")
    ap.add_argument("--profile", action="store_true",
                    help="trace generate run A, run B's prefill and the "
                         "serve runs with "
                         "torch.profiler and print where the device time "
                         "went")
    ap.add_argument("--kernels", default="",
                    help="comma list of kernel names: the kernels phase "
                         "runs only these (a parent-against-change aid)")
    ap.add_argument("--tree", default="",
                    help="import cake_tpu_torch from this directory (for "
                         "example a parent commit unpacked with git "
                         "archive) instead of the one beside this script")
    ap.add_argument("--int4-sweep", default="",
                    help="comma list of TARGET_BLOCKS values: time "
                         "int4_matmul at each and exit (a tuning aid, not "
                         "part of the smoke)")
    a = ap.parse_args(argv)
    phases = [p for p in a.phases.split(",") if p]
    bad = set(phases) - set(PHASES)
    if bad:
        fail(f"unknown phases {sorted(bad)}")

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "an NVIDIA card")
    tree = os.path.abspath(a.tree) if a.tree else \
        os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, tree)
    log(f"cake_tpu_torch from {tree}")
    try:
        import cake_tpu_torch.ops.flash_attention as fa
        import cake_tpu_torch.ops.int4_matmul as i4
        import cake_tpu_torch.ops.ragged_paged_attention as rpa
    except ImportError as e:
        fail(f"cake_tpu_torch is not importable next to this script "
             f"({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if a.int4_sweep:
        log(phase_device(torch, i4))
        default = i4.TARGET_BLOCKS
        int4_sweep(torch, i4, [int(t) for t in a.int4_sweep.split(",")])
        i4.TARGET_BLOCKS = default
        return 0
    card = phase_device(torch, rpa, fa, i4)
    only = set(a.kernels.split(",")) - {""} or None
    kern = (phase_kernels(torch, rpa, fa, i4, only) if "kernels" in phases
            else {})
    if "step" in phases:
        phase_step(torch, rpa, fa, i4)
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
        # the weight-quantized path, after the bf16 tree is dropped
        del params
        torch.cuda.empty_cache()
        q4 = None
        if "generate" in phases:
            q4, got = phase_generate_quant(torch, i4, cfg)
            counts["int4_matmul"] = got["int4_matmul"]
        if "serve" in phases:
            if q4 is None:
                from cake_tpu_torch.models.llama.params import (
                    init_params_quantized,
                )
                q4 = init_params_quantized(
                    cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda", dtype=torch.bfloat16, bits=4)
            got, _ = phase_serve(torch, rpa, cfg, q4, profile=a.profile,
                                 i4=i4)
            # the ragged kernels' counts stay those of the bf16-weight run
            counts["int4_matmul"] = (counts.get("int4_matmul", 0)
                                     + got["int4_matmul"])

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
            # `ms` is device time (a CUDA graph of back-to-back calls,
            # replayed); these are the same calls made from the host
            "eager_ms": rec.get("eager_ms"),
            "library_eager_ms": rec.get("library_eager_ms"),
        })
    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
