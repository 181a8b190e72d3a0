"""On-card smoke test of the PyTorch/CUDA port (`cake_tpu_torch`).

    python3 chip_smoke.py                 # every phase, one H100
    python3 chip_smoke.py --phases kernels,step
    python3 chip_smoke.py --phases device,generate --profile
    python3 chip_smoke.py --phases device,serve --tree DIR  # a parent's serve
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
            times from a replayed CUDA graph of 30 calls (the three
            decode kernels' cycling through pool copies larger than L2)
            with the host-launched time beside them, the plain version's
            time, the bound and the yardstick SDPA timed the same way;
            every ragged kernel and the flash pair must give the same
            bits twice; each mixed case logs the body it ran (the
            tensor-core body or rpa_cta) and its split plan.
            More decode cases show the split body: B = 8 with one row
            at pos 8191 (64 table columns) over a bf16, an int8 and an
            int4 pool, B = 32 rows up to 2047 over bf16. Then
            the int4 matmul against its plain version at the four
            Llama-3-8B weight shapes, M = 1, 8 and 64, f32 and bf16 x
            (and f16 over w_gate/w_up, the table's row), weights from
            quantize_group of seeded normals, plus a tiny-config shape:
            one launch counted a product, the same bits twice, the body
            and cluster plan logged; its yardstick is torch.matmul over
            the weight dequantized ahead of time. The kernels line
            carries M = 1 in row 9's numbers and M = 8 and 64 beside
            them ("m8", "m64").
  step      at Llama-3-8B width (2 layers, f32 weights), kernel vs plain:
            mixed_step_paged + decode_step_ragged_paged logits and pools
            over f32, int8 and int4 pools; dense prefill, prefill_chunk
            and decode_step logits and caches with flash on vs off; with
            int4 weights (quantize_params on the card) the dense and the
            paged decode step, kernel vs plain logits, and one prefill
            (M > 64) down the dequantize route. Then at full width and
            depth (the 32-layer random bf16 weights, and later int4
            weights) the engine's decode step as serve/graphs.DecodeRunner
            runs it: K = 4 replays of the captured CUDA graph against the
            same step run 4 times eagerly from identical pools, over a
            bf16, an int8 and an int4 pool (int4 weights: bf16 pool);
            identical tokens, byte-identical pages, the last step's
            logits' difference (0 expected), 4 x 32 decode launches a
            side, the replay's device ms and the eager step's host ms.
            Then the engine's mixed step as serve/graphs.MixedRunner
            runs it, at the same weights and pools (B = 8, C = 64):
            4 replays of the captured step against the same 4 steps
            run eagerly, with decode rows (one on an unmapped page),
            chunk rows at in-page offsets, a chunk row after two shared
            prefix pages and an idle row; identical tokens, byte-
            identical real pages, the shared pages unchanged, logits
            within GRAPH_TOL, 4 x 32 mixed-attention launches a side
            (and no int4_matmul: the block products have 512 rows, the
            lm_head is int8), a replay's device ms beside the step's
            bound, and each pool's window writer's device ms a layer.
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
  serve     the same weights behind the HTTP API: six concurrent chat
            requests (three SSE) of 32 tokens through the paged engine,
            over a bf16 pool at --decode-scan 1 and 4, then int8 and int4
            pools at 4, then int4 weights over a bf16 pool at 4. Each
            configuration drives the chats three times through one
            engine (cold, warm, warm under torch.profiler) and prints
            decode tok/s, TTFT p50, the served wall and (profiled) the
            device's busy share; its kernels must have run (replays of
            the captured decode and mixed steps counted) and no plain
            version; int4
            weights: 7 int4_matmul launches per rpa_decode launch. A
            tree without the captured step (--tree of a parent) serves
            at --decode-scan 1 only. A `serve` JSON line holds the
            drives' records.
  prefix    shared-prefix pages and the phase-split prefill at the same
            width and depth, over a bf16 and an int8 pool: the prefix's
            prefill into its 5 pages, a suffix after it and a window of a
            row that maps it, each with attn="kernel" (flash_attn,
            flash_attn_cached: 32 launches a call) and attn="plain" from
            one pool (layer 0's pages identical, logits and pages within
            PREFIX_REL_TOL of their magnitude); then a warm-up chat and six
            concurrent chats with one ~700-token system message through
            the HTTP API with --auto-prefix at --mixed-batch auto and off
            (--decode-scan 4), and the same chats without it: 6 prefix
            hits a drive, fewer pages in use at peak than without, the
            shared pages' bytes and scales unchanged, only the registry's
            pages live at the end, flash launches on the served path and
            no plain version; TTFT p50, decode tok/s and wall beside the
            card's name and power limit. A `prefix` JSON line holds the
            drives' records.
  sched     SLO scheduling and the observability core at the same width
            and depth (bf16 weights, a 40-page bf16 pool, 8 slots, chunk
            64, --decode-scan 4) through the HTTP API with
            --priority-classes: round A, six batch chats of 512 + 256
            tokens (6 pages each), then two interactive chats of 300 +
            64 (3 pages), the second page-starved: exactly one "pages"
            preemption; round B, eight batch chats of 128 + 64 fill the
            slots, one interactive chat: exactly one "slots" preemption
            (both read from /metrics). Every chat completes and the free
            pages return to 40. The same arrivals without the classes
            (the FIFO drive) give the interactive TTFT p50 beside the
            classes' (printed). /api/v1/steps: every record's mfu in
            (0, 1], its unclamped ratios at most 1.05, means per kind,
            and the decode records' hbm_util within 30% of the step
            phase's decode bound over its replay (same call). Each
            preempted stream against the FIFO drive's: printed at bf16,
            required token-identical at f32 (the same rounds at 8B
            width, 4 layers, f32 weights and pool). Then a burst of 48
            batch chats past the shed's depth (--shed, batch held to a
            1 s queue-wait target): some get 429 with a Retry-After
            above 0. A `sched` JSON line holds the phase's record.

The line before last is a JSON `kernels` record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or `cake_tpu`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

PHASES = ("device", "kernels", "step", "generate", "serve", "prefix",
          "sched")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12,    # FMA-pipe f32; TC
            "float16": 989e12}
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
    dev = "cuda"
    B, H, KV, hd, P, MP, N = 8, 32, 8, 128, 128, 16, 128
    C = 64 if mixed else 1
    pool_k, pool_v, kw = _pools(torch, gen, fmt, dtype, N, P, KV, hd)
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


def _pools(torch, gen, fmt, dtype, N, P, KV, hd):
    """(pool_k, pool_v, kw): normal draws in `dtype`, or with fmt
    "int8"/"int4" normal draws written by the port's qwrite_prompt_pages
    (the kernel's scale arguments go in kw)."""
    from cake_tpu_torch.kv.quantized_pool import (
        Int4Pool, QuantPool, qwrite_prompt_pages,
    )

    dev = "cuda"
    if fmt is None:
        return tuple(torch.randn((N, P, KV, hd), generator=gen, device=dev,
                                 dtype=dtype) for _ in range(2)) + ({},)
    cls, rows = (Int4Pool, P // 2) if fmt == "int4" else (QuantPool, P)
    every = torch.arange(N, dtype=torch.int32, device=dev)
    pools = []
    for _ in range(2):
        pool = cls(torch.zeros((N, rows, KV, hd), device=dev,
                               dtype=(torch.uint8 if fmt == "int4"
                                      else torch.int8)),
                   torch.zeros((N, KV), device=dev))
        vals = torch.randn((1, N * P, KV, hd), generator=gen, device=dev)
        pools.append(qwrite_prompt_pages(pool, vals, every))
        del vals
    (pool_k, sk), (pool_v, sv) = pools
    return pool_k, pool_v, dict(scale_k=sk, scale_v=sv,
                                packed4=fmt == "int4")


def _dequantized(torch, pool_k, pool_v, kw, dtype):
    """A quantized pool pair's pages dequantized to `dtype` ahead of
    time (the SDPA yardstick's K/V); f32/bf16 pools as they are."""
    from cake_tpu_torch.kv.quantized_pool import (
        Int4Pool, QuantPool, dequantize_pages,
    )

    if not kw:
        return pool_k, pool_v
    cls = Int4Pool if kw["packed4"] else QuantPool
    every = torch.arange(pool_k.shape[0], device=pool_k.device)
    return tuple(dequantize_pages(cls(x, kw[s]), every).to(dtype)
                 for x, s in ((pool_k, "scale_k"), (pool_v, "scale_v")))


def _cold_copies(torch, pool_k, pool_v, kw):
    """[(pool_k, pool_v, kw)] copies of a pool pair (scales cloned with
    their pages) that together exceed the L2 cache twice over, so a
    replayed burst of calls cycling through them finds each copy's pages
    cold, as a served decode step finds each layer's pool."""
    nbytes = 2 * pool_k.numel() * pool_k.element_size()
    out = [(pool_k, pool_v, kw)]
    for a, b in zip(_copies(pool_k, nbytes)[1:], _copies(pool_v, nbytes)[1:]):
        out.append((a, b, {k: (v.clone() if torch.is_tensor(v) else v)
                           for k, v in kw.items()}))
    return out


def _decode_pools(torch, pool_k, pool_v, kw, dtype):
    """(kernel pools, SDPA pools) of a decode case, each cycled past L2:
    [(pool_k, pool_v, kw)] for the kernel, [(k, v)] for the yardstick
    (a quantized pool's pages dequantized to `dtype` ahead of time)."""
    kpools = _cold_copies(torch, pool_k, pool_v, kw)
    if not kw:
        return kpools, [(a, b) for a, b, _ in kpools]
    dk, dv = _dequantized(torch, pool_k, pool_v, kw, dtype)
    return kpools, [(a, b) for a, b, _ in _cold_copies(torch, dk, dv, {})]


def _elem_bytes(fmt, pool_k):
    """(bytes a K/V element, bytes a live page adds: its k and v scales,
    4 each a kv head) of a pool stored as fmt (None: q's dtype)."""
    if fmt is None:
        return pool_k.element_size(), 0
    return _ELEM_BYTES[fmt], 8 * pool_k.shape[2]


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
    The decode kernels (every pool) cycle through pool copies larger than
    L2, and SDPA through copies of its own pages (a served decode step
    finds each layer's pool cold). Every kernel must give the same bits
    twice. `only`: the kernel names to run (None: all)."""
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
                KV = pk.shape[2]
                P = pk.shape[1] * (2 if fmt == "int4" else 1)
                nbytes, ops = _work(q, P, KV, table, pos, ql,
                                    *_elem_bytes(fmt, pk))
                if mixed:
                    kpools = [(pk, pv, kw)]
                    dpools = [_dequantized(torch, pk, pv, kw, dtype)]
                else:
                    kpools, dpools = _decode_pools(torch, pk, pv, kw, dtype)
                    plan = rpa.split_plan(q.shape[0], KV, table.shape[1], P,
                                          rpa.sm_count("cuda"))
                    log(f"{name} {dname}: split plan (splits, pages a "
                        f"split) {plan}; {len(kpools)} pool copies")
                rest = args[3:]
                report[(name, dname)] = _measure(
                    torch, name, dname, got, plain(*args, **kw),
                    [(lambda a=a, b=b, k=k: kern(q, a, b, *rest, **k))
                     for a, b, k in kpools],
                    lambda: plain(*args, **kw),
                    [_sdpa_yardstick(torch, q, c, d, table, pos, ql)
                     for c, d in dpools],
                    nbytes, ops, again=kern(*args, **kw))
                if mixed and hasattr(rpa, "mixed_split_plan"):
                    log(f"{name} {dname}: "
                        + _mixed_body(rpa, q, pk, pv, kw, table.shape[1], P))
                del kpools, dpools
    torch.cuda.empty_cache()


def _mixed_body(rpa, q, pool_k, pool_v, kw, max_pages, P) -> str:
    """Which body the package's mixed wrapper launches for these inputs,
    and its split plan (planned with the real page size P)."""
    if not rpa.mixed_takes_tc(q, pool_k, pool_v, kw.get("scale_k")):
        return "rpa_cta"
    plan = rpa.mixed_split_plan(*q.shape[:3], pool_k.shape[2], q.shape[3],
                                max_pages, P, rpa.sm_count("cuda"))
    return f"tensor-core body, plan (splits, pages a split) {plan}"


def _split_cases(torch, rpa, only=None) -> None:
    """Decode cases that show the split of rpa_decode (bf16 queries,
    128-token pages, H=32, KV=8, hd=128; pools cycled past L2): B = 8
    with one row at pos 8191 (64 table columns) beside rows at 0..2047,
    over a bf16, an int8 and an int4 pool (rpa_decode, rpa_decode_q8,
    rpa_decode_q4), and B = 32 rows at mixed positions up to 2047 over
    a bf16 pool. Each against its plain version, with the plan, device
    time, bound and SDPA (over the pages dequantized to bf16 for the
    quantized pools). `only`: the kernel names to run (None: all)."""
    gen = torch.Generator(device="cuda").manual_seed(777)
    H, KV, hd, P, dtype = 32, 8, 128, 128, torch.bfloat16
    long_row = [8191, 0, 127, 500, 1000, 1500, 2047, 300]
    cases = (
        ("B=8 one row at 8191", 8, 64, long_row, None),
        ("B=32 mixed up to 2047", 32, 16,
         [int(x) for x in torch.randint(0, 2048, (32,), generator=gen,
                                        device="cuda").tolist()], None),
        ("B=8 one row at 8191", 8, 64, long_row, "int8"),
        ("B=8 one row at 8191", 8, 64, long_row, "int4"),
    )
    for label, B, MP, pos_l, fmt in cases:
        name = "rpa_decode" + {"int8": "_q8", "int4": "_q4"}.get(fmt, "")
        if only is not None and name not in only:
            continue
        N = 256
        pk, pv, kw = _pools(torch, gen, fmt, dtype, N, P, KV, hd)
        table = torch.randint(0, N, (B, MP), generator=gen, device="cuda",
                              dtype=torch.int32)
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
        q = torch.randn((B, 1, H, hd), generator=gen, device="cuda",
                        dtype=dtype)
        args = (q, pk, pv, table, pos)
        got = rpa.ragged_paged_attention(*args, **kw)
        kpools, dpools = _decode_pools(torch, pk, pv, kw, dtype)
        nbytes, ops = _work(q, P, KV, table, pos, None, *_elem_bytes(fmt, pk))
        plan = (rpa.split_plan(B, KV, MP, P, rpa.sm_count("cuda"))
                if hasattr(rpa, "split_plan") else "none")
        log(f"{name} split case {label}: plan (splits, pages a split) "
            f"{plan}")
        _measure(torch, f"{name} {label}", "bfloat16", got,
                 rpa.ragged_paged_attention_plain(*args, **kw),
                 [(lambda a=a, b=b, k=k: rpa.ragged_paged_attention(
                     q, a, b, table, pos, **k)) for a, b, k in kpools],
                 lambda: rpa.ragged_paged_attention_plain(*args, **kw),
                 [_sdpa_yardstick(torch, q, a, b, table, pos, None)
                  for a, b in dpools], nbytes, ops,
                 again=rpa.ragged_paged_attention(*args, **kw))
        del kpools, dpools, pk, pv
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
    # the prefix phase's shapes: a 5-page prefix registration, the
    # prefixed suffix window, and a chunk window over a slot's whole
    # gathered row (max_seq_len 2048), whose unmapped pages read as zeros
    ("flash_attn causal S=T=640 (prefix registration)", "flash_attn",
     dict(S=640, T=640, pos=None), dict(), False),
    ("flash_attn_cached S=128 pos=640 T=768 NaN tail (prefixed suffix)",
     "flash_attn_cached", dict(S=128, T=768, pos=640), dict(), False),
    ("flash_attn_cached S=64 pos=704 T=2048 zero tail (chunk window)",
     "flash_attn_cached", dict(S=64, T=2048, pos=704, tail=0.0), dict(),
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
                # slots at or past the frontier hold garbage (NaN), or
                # the zeros of unmapped pages
                k[:, pos + S:] = shp.get("tail", float("nan"))
                v[:, pos + S:] = shp.get("tail", float("nan"))
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
# w_down; g = 128. The kernel table reports w_gate/w_up (INT4_MAIN) at
# each of INT4_MS
INT4_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
INT4_MAIN = (4096, 14336)
# int4_matmul against its plain version: the same products summed in f32
# in another order (for bf16 and f16 x every product is exact in f32), so
# at f32 the difference stays under 1e-5 of the largest output; at bf16 and
# f16 the two f32 sums round apart by at most one unit, 2^-7 and 2^-10
# relative
INT4_ATOL_OF_MAX = 1e-5
INT4_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
# the M of the kernel table's row 9: the generator's decode step, the served
# decode launch, the largest the gate takes
INT4_MS = (1, 8, 64)


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


def _int4_plan(torch, i4, M, In, Out, g, dtype) -> str:
    """The body and split plan a product runs (a tree without the
    tensor-core body says so)."""
    if not hasattr(i4, "split_plan"):
        return "CUDA-core body, split + sum kernel"
    from cake_tpu_torch.utils.devices import device_sm_count

    tc = i4.takes_tc(M, g, dtype)
    s = i4.split_plan(M, In // g, Out, tc, device_sm_count("cuda"))
    return (f"{'tensor-core' if tc else 'CUDA-core'} body, clusters of "
            f"{s} over {In // g} groups")


def _int4_kernels(torch, i4, report) -> None:
    from cake_tpu_torch.ops.quant import group_size, quantize_group

    gen = torch.Generator(device="cuda").manual_seed(99)
    shapes = [(m, i, o) for (i, o) in INT4_SHAPES for m in INT4_MS]
    shapes.append((2, 64, 32))         # the tiny config's wk/wv, g = 64
    weights = {}
    for M, In, Out in shapes:
        if (In, Out) not in weights:
            w = torch.randn((In, Out), generator=gen, device="cuda")
            weights[(In, Out)] = quantize_group(w * In ** -0.5, 0)
            del w
        qt = weights[(In, Out)]
        g = group_size(qt)
        main = (In, Out) == INT4_MAIN
        dtypes = (torch.float32, torch.bfloat16) + ((torch.float16,)
                                                    if main else ())
        for dtype in dtypes:
            dname = str(dtype).split(".")[-1]
            x = torch.randn((M, In), generator=gen, device="cuda").to(dtype)
            n0 = i4.LAUNCHES["int4_matmul"]
            got = i4.int4_matmul(x, qt.q, qt.scale, g=g)
            launches = i4.LAUNCHES["int4_matmul"] - n0
            again = i4.int4_matmul(x, qt.q, qt.scale, g=g)
            want = i4.int4_matmul_plain(x, qt.q, qt.scale, g=g)
            torch.cuda.synchronize()
            label = f"int4_matmul M={M} In={In} Out={Out} g={g} {dname}"
            if launches != 1:
                fail(f"{label}: {launches} launches counted for one product")
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
            plan = _int4_plan(torch, i4, M, In, Out, g, dtype)
            if In < 1024:
                log(f"{label}: max_abs_err {err:.3e} (atol {atol:.3e}); "
                    f"{plan}")
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
                f"{ops} ops), x{ms / rec['bound_ms']:.1f} bound; {plan}")
            if main:
                report[("int4_matmul", dname, M)] = rec
    torch.cuda.empty_cache()


def int4_sweep(torch, i4, splits) -> None:
    """Device time of int4_matmul (graph replay, bf16 x, each of INT4_MS)
    at the four Llama-3-8B weight shapes: the plan's own clusters, then
    each cluster size in `splits` (cut to one with no empty range); at
    M = 1 for both bodies (TC_MIN_M 1: tensor cores, 2: CUDA cores)."""
    from cake_tpu_torch.ops.quant import group_size, quantize_group
    from cake_tpu_torch.utils.devices import device_sm_count

    plan, tc_min = i4.split_plan, i4.TC_MIN_M
    n_sm = device_sm_count("cuda")
    gen = torch.Generator(device="cuda").manual_seed(99)
    for In, Out in INT4_SHAPES:
        w = torch.randn((In, Out), generator=gen, device="cuda")
        qt = quantize_group(w * In ** -0.5, 0)
        del w
        g = group_size(qt)
        G = In // g
        wbytes = qt.q.numel() + 4 * qt.scale.numel()
        qs = _copies(qt.q, wbytes)
        ss = [qt.scale.clone() for _ in qs]
        for M in INT4_MS:
            x = torch.randn((M, In), generator=gen,
                            device="cuda").to(torch.bfloat16)
            cells = []
            for body in ((1, 2) if M == 1 else (tc_min,)):
                i4.TC_MIN_M = body
                tc = i4.takes_tc(M, g, x.dtype)
                for n in [None] + list(splits):
                    fixed = -(-G // -(-G // min(n, G))) if n else None
                    i4.split_plan = plan if n is None else (
                        lambda *a, f=fixed: f)
                    ms, _ = _stream_ms(torch, [
                        (lambda q=q, s=s: i4.int4_matmul(x, q, s, g=g))
                        for q, s in zip(qs, ss)])
                    used = fixed or plan(M, G, Out, tc, n_sm)
                    cells.append(f"{'tc' if tc else 'core'} {used}"
                                 f"{'' if n else ' (plan)'}: {ms:.4f} ms")
            i4.split_plan, i4.TC_MIN_M = plan, tc_min
            log(f"int4 sweep M={M} In={In} Out={Out}: " + ", ".join(cells))
        del qs, ss
        torch.cuda.empty_cache()


def phase_kernels(torch, rpa, fa, i4, only=None) -> dict:
    """Every kernel against its plain version, timed; `only` restricts
    the phase to some kernel names (with a decode kernel, its split
    cases)."""
    report = {}
    _rpa_kernels(torch, rpa, report, only)
    _split_cases(torch, rpa, only)
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
        cache = base.clone()
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
            cache = base.clone()
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


# logits of the captured step against the same step run eagerly: the
# same kernels on the same inputs in the same order, so 0 is expected
GRAPH_TOL = 0.0
# the decode graph's replay ms a step and the step's bound, by (weights,
# pool), as the step phase measured them (the sched phase holds its
# decode records' HBM share against bound / replay)
GRAPH_REPLAY = {}


def _graph_steps(torch, rpa, i4, cfg, params,
                 int4_weights: bool = False) -> None:
    """The engine's decode step at full width and depth: K = 4 replays of
    the captured step (`serve/graphs.DecodeRunner`) against the same
    step run 4 times eagerly, from identical pools: bf16 weights over a
    bf16, an int8 and an int4 pool, int4 weights over a bf16 pool. Eight slots of 16 pages: six live rows at ragged
    positions (one with a budget of 2, so it freezes mid-burst), one
    inactive mapped row, one unmapped. Greedy tokens must be identical,
    the real pages byte-identical and the last step's logits within
    GRAPH_TOL; each side launches 4 x L decode kernels (7 x 4 x L int4
    products with int4 weights) and no plain version."""
    import numpy as np

    from cake_tpu_torch.kv.quantized_pool import (
        QUANTIZED_CACHES, qwrite_prompt_pages,
    )
    from cake_tpu_torch.models.llama.model import RopeTables
    from cake_tpu_torch.models.llama.paged import (
        PagedKVCache, table_set_slot,
    )
    from cake_tpu_torch.serve.graphs import DecodeRunner

    dev = "cuda"
    B, P, T, N, K = 8, 128, 2048, 128, 4
    L, KV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(11)
    rope = RopeTables.create(cfg, T, device=dev)
    pos = np.array([100, 400, 1000, 1500, 129, 7, 300, 0])
    live = np.array([True] * 6 + [False, False])
    budget = np.array([K, K, K, K, 2, K, K, K])
    toks = np.arange(B) * 1009 % cfg.vocab_size
    label = "int4 weights" if int4_weights else "bf16 weights"
    for kv in ((None,) if int4_weights else (None, "int8", "int4")):
        if kv is None:
            base = PagedKVCache.create(cfg, B, N, P, T, dtype=torch.bfloat16,
                                       device=dev)
            base.k.normal_(generator=gen)
            base.v.normal_(generator=gen)
        else:
            base = QUANTIZED_CACHES[kv].create(cfg, B, N, P, T, device=dev)
            every = torch.arange(N, dtype=torch.int32, device=dev)
            for i in range(L):
                for leaf in base.layer(i):
                    vals = torch.randn((1, N * P, KV, hd), generator=gen,
                                       device=dev)
                    qwrite_prompt_pages(leaf, vals, every)
        for b in range(B - 1):                  # slot 7: every page unmapped
            table_set_slot(base.table, b, list(range(16 * b, 16 * b + 16)))
        runs = {}
        for mode in ("graph", "eager"):
            cache = base.clone()
            runner = DecodeRunner(
                params, cache, rope, cfg, attn="kernel",
                ring=torch.full((B, 128), -1, dtype=torch.int64, device=dev),
                seeds=torch.arange(B, device=dev),
                counters=torch.zeros(B, dtype=torch.int64, device=dev),
                max_steps=K, n_top_cap=20, top_k=None)
            runner.load(0, toks, pos, live, np.zeros(B, np.int64),
                        np.zeros(B, np.float32), np.ones(B, np.float32),
                        np.full(B, 1.1, np.float32))
            torch.cuda.synchronize()
            rpa.reset_launch_counts()
            i4.reset_launch_counts()
            if mode == "graph":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                handle = runner.run(K, budget, 0)
                b.record()
                out = DecodeRunner.fetch(handle)[0]
                ms = a.elapsed_time(b) / K
            else:
                runner.begin(budget)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(K):
                    runner.step(0)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / K
                out = runner.out[0][:, :K].cpu().numpy()
            counts = {**rpa.LAUNCHES, **i4.LAUNCHES}
            runs[mode] = (out, runner.logits.clone(), cache, counts, ms)
            del runner
        (tg, lg, cg, ng, ms_g), (te, le, ce, ne, ms_e) = (runs["graph"],
                                                          runs["eager"])
        name = f"{label}, {kv or 'bf16'} pool"
        if kv is None:
            bound = _mixed_step_bound(
                cfg, params, B, 1, pos, live.astype(int),
                2 * L * KV * hd * 2)[0]
            GRAPH_REPLAY[label] = (ms_g, bound)
            log(f"step graph ({name}): a decode step's bound {bound:.3f} "
                f"ms (bytes), the replay {bound / ms_g:.3f} of it")
        rows = torch.as_tensor(np.flatnonzero(live & (budget == K)),
                               device=dev)
        err = (lg[rows] - le[rows]).abs().max().item()
        log(f"step graph ({name}): {K} replays {ms_g:.3f} ms a step "
            f"(device, CUDA events), eager step {ms_e:.3f} ms (host, "
            f"synchronized); tokens {tg[live].tolist()}; last step's logits "
            f"max |graph - eager| = {err:.3e} (tol {GRAPH_TOL})")
        if not np.array_equal(tg, te):
            fail(f"step graph ({name}): tokens differ:\n{tg}\n{te}")
        if not torch.isfinite(lg[rows]).all() or err > GRAPH_TOL:
            fail(f"step graph ({name}): logits differ by {err:.3e}")
        pages = ((cg.k, ce.k), (cg.v, ce.v))
        if kv is not None:
            pages = tuple((x, y) for a, b in pages for x, y in zip(a, b))
        if not all(torch.equal(x, y) for x, y in pages):
            fail(f"step graph ({name}): the written pages differ")
        suffix = {"int8": "_q8", "int4": "_q4"}.get(kv, "")
        want = {"rpa_decode" + suffix: K * L}
        if int4_weights:
            want["int4_matmul"] = 7 * K * L
        for mode, n in (("graph", ng), ("eager", ne)):
            got = {k: n[k] for k in want}
            plain = {k: v for k, v in n.items() if k.endswith("_plain") and v}
            if got != want or plain:
                fail(f"step graph ({name}, {mode}): launches {got}, plain "
                     f"{plain}; expected {want} and no plain call")
        del runs, base, cg, ce
        torch.cuda.empty_cache()


def _mixed_step_bound(cfg, params, B, C, pos, q_len, kv_bytes_per_token):
    """(bound ms, what bounds it, ms at all B x C columns) of one mixed
    step: the larger of the bytes it must move over HBM_BYTES_PER_S
    (every weight read once but the embedding, of which the step gathers
    B x C rows; each row's KV history read once) and its operations over
    the bf16 peak: 2 x (matmul weights) per real token (sum(q_len)), the
    lm_head's 2 x D x V per row, and 4 x H x hd per (query, key) pair of
    the attention."""
    import torch

    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(v) for v in t.values())
        if isinstance(t, torch.Tensor):
            return t.numel() * t.element_size()
        return sum(nbytes(x) for x in t)        # a QTensor's (q, scale)

    D, H, KV, hd = (cfg.hidden_size, cfg.num_attention_heads,
                    cfg.num_key_value_heads, cfg.head_dim)
    L, F, V = cfg.num_hidden_layers, cfg.intermediate_size, cfg.vocab_size
    embed = params["embed"]
    weights = nbytes(params) - nbytes(embed) + B * C * D * embed.element_size()
    kv = sum(int(p) + int(n) for p, n in zip(pos, q_len) if n) \
        * kv_bytes_per_token
    per_token = L * (2 * D * H * hd + 2 * D * KV * hd + 3 * D * F)
    pairs = sum(n * p + n * (n + 1) // 2 for p, n in zip(pos, q_len))
    attn = 4 * H * hd * L

    def ops(tokens, qk_pairs):
        return 2 * per_token * tokens + 2 * B * D * V + attn * qk_pairs

    t_bytes = (weights + kv) / HBM_BYTES_PER_S * 1e3
    t_ops = ops(int(sum(q_len)), pairs) / PEAK_OPS["bfloat16"] * 1e3
    all_cols = sum(C * p + C * (C + 1) // 2 for p in pos)
    t_all = max(t_bytes,
                ops(B * C, all_cols) / PEAK_OPS["bfloat16"] * 1e3)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", t_all)


def _window_writer_ms(torch, cache, pos, q_len, active, C, KV,
                      hd) -> float:
    """Device ms of one layer's k-leaf window write at the step's rows
    (`write_windows_pages` through the step's fixed-shape targets),
    from a CUDA graph of 30 calls, replayed."""
    from cake_tpu_torch.models.llama.paged import (
        step_write_targets, write_windows_pages,
    )

    tg = step_write_targets(cache, pos, active, q_len, C)
    vals = torch.randn((len(pos), C, KV, hd), device="cuda",
                       dtype=torch.bfloat16)
    pk, pv = cache.layer(0)

    def one():
        write_windows_pages(pk, pv, vals, vals, pos, q_len, active,
                            cache.table, tg)

    # a call writes both halves: half of it is one leaf's
    return _stream_ms(torch, [one])[0] / 2


def _mixed_graph_steps(torch, rpa, i4, cfg, params,
                       int4_weights: bool = False) -> None:
    """The engine's mixed step at full width and depth: 4 replays of the
    captured step (`serve/graphs.MixedRunner`) against the same 4 steps
    run eagerly, from identical pools: bf16 weights over a bf16, an int8
    and an int4 pool, int4 weights over a bf16 pool. B = 8, C = 64,
    128-token pages: decode rows (one on an unmapped page), chunk rows at
    in-page offsets (one of 37 real tokens), a chunk row after two
    shared prefix pages (which a decode row maps too), an idle row; the
    decode rows emit every step, the chunk rows at the last. Greedy
    tokens must be identical, the real pages byte-identical, the shared
    pages (and scales) unchanged, the logits of the active rows within
    GRAPH_TOL; each side launches 4 x L mixed-attention kernels and no
    plain version (int4 weights: no int4_matmul either, as the block
    products have B x C = 512 rows and take the dequantize route and the
    lm_head is int8). Prints a replay's device ms beside the step's bound
    and the eager step's host ms, and each quantized pool's window writer
    device time a layer."""
    import numpy as np

    from cake_tpu_torch.kv.quantized_pool import (
        QUANTIZED_CACHES, qwrite_prompt_pages,
    )
    from cake_tpu_torch.models.llama.model import RopeTables
    from cake_tpu_torch.models.llama.paged import (
        PagedKVCache, table_set_slot,
    )
    from cake_tpu_torch.serve.graphs import MixedRunner

    dev = "cuda"
    B, C, P, T, N, K = 8, 64, 128, 2048, 128, 4
    L, KV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(12)
    rope = RopeTables.create(cfg, T, device=dev)
    shared = [126, 127]
    tables = [list(range(16 * b, 16 * b + 16)) for b in range(B)]
    tables[4] = shared + tables[4][2:]          # a chunk after the prefix
    tables[5] = shared + tables[5][2:]          # a decode row on it too
    tables[7] = [112, -1]                       # its page 1 unmapped
    pos0 = np.array([1000, 129, 100, 300, 256, 700, 0, 200])
    q_len = np.array([1, 1, 64, 37, 64, 1, 0, 1])
    active = q_len > 0
    decode = q_len == 1
    rng = np.random.default_rng(12)
    steps = []
    for k in range(K):
        tokens = rng.integers(0, cfg.vocab_size, size=(B, C))
        pos = pos0 + k * q_len
        emit = decode | (active & (k == K - 1))
        steps.append((tokens, pos, q_len, active, emit,
                      np.full(B, k, np.int64), np.zeros(B, np.float32),
                      np.ones(B, np.float32), np.full(B, 1.1, np.float32)))
    label = "int4 weights" if int4_weights else "bf16 weights"
    for kv in ((None,) if int4_weights else (None, "int8", "int4")):
        if kv is None:
            base = PagedKVCache.create(cfg, B, N, P, T, dtype=torch.bfloat16,
                                       device=dev)
            base.k.normal_(generator=gen)
            base.v.normal_(generator=gen)
        else:
            base = QUANTIZED_CACHES[kv].create(cfg, B, N, P, T, device=dev)
            every = torch.arange(N, dtype=torch.int32, device=dev)
            for i in range(L):
                for leaf in base.layer(i):
                    vals = torch.randn((1, N * P, KV, hd), generator=gen,
                                       device=dev)
                    qwrite_prompt_pages(leaf, vals, every)
        for b in range(B):
            table_set_slot(base.table, b, tables[b])
        torch.cuda.synchronize()
        runs = {}
        for mode in ("graph", "eager"):
            cache = base.clone()
            runner = MixedRunner(
                params, cache, rope, cfg, attn="kernel",
                ring=torch.full((B, 128), -1, dtype=torch.int64, device=dev),
                seeds=torch.arange(B, device=dev),
                counters=torch.zeros(B, dtype=torch.int64, device=dev),
                chunk=C, n_top_cap=20, top_k=None)
            runner.captured(0)
            torch.cuda.synchronize()
            rpa.reset_launch_counts()
            i4.reset_launch_counts()
            toks, logits, ms = [], [], []
            for rows in steps:
                runner.load(0, *rows)
                if mode == "graph":
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    runner.replay(0)
                    b.record()
                    out = MixedRunner.fetch(runner.download(1, 0))[0][:, 0]
                    ms.append(a.elapsed_time(b))
                else:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runner.step(0)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    out = runner.out[0][:, 0].clone().cpu().numpy()
                toks.append(out)
                logits.append(runner.logits.clone())
            counts = {**rpa.LAUNCHES, **i4.LAUNCHES}
            runs[mode] = (np.stack(toks), logits, cache, counts,
                          statistics.median(ms))
            del runner
        (tg, lg, cg, ng, ms_g), (te, le, ce, ne, ms_e) = (runs["graph"],
                                                          runs["eager"])
        name = f"{label}, {kv or 'bf16'} pool"
        rows = torch.as_tensor(np.flatnonzero(active), device=dev)
        err = max((a[rows] - b[rows]).abs().max().item()
                  for a, b in zip(lg, le))
        kv_token = (2 * L * KV * hd
                    * {"int8": 1.0, "int4": 0.5}.get(kv, 2.0))
        bound, by, bound_all = _mixed_step_bound(
            cfg, params, B, C, steps[0][1], q_len, kv_token)
        log(f"mixed graph ({name}): {K} replays, {ms_g:.3f} ms a step "
            f"(device, CUDA events, median), bound {bound:.3f} ms "
            f"({by}; {bound_all:.3f} ms at all {B} x {C} columns), eager "
            f"step {ms_e:.3f} ms (host, synchronized); emitted tokens "
            f"{[t[e].tolist() for t, e in zip(tg, (s[4] for s in steps))]}"
            f"; logits max |graph - eager| = {err:.3e} (tol {GRAPH_TOL})")
        emitted = np.stack([s[4] for s in steps])
        if not np.array_equal(tg[emitted], te[emitted]):
            fail(f"mixed graph ({name}): tokens differ:\n{tg}\n{te}")
        if not all(torch.isfinite(x[rows]).all() for x in lg) or \
                err > GRAPH_TOL:
            fail(f"mixed graph ({name}): logits differ by {err:.3e}")
        halves = ((cg.k, ce.k, base.k), (cg.v, ce.v, base.v))
        if kv is not None:
            halves = tuple(z for h in halves for z in zip(*h))
        if not all(torch.equal(x, y) for x, y, _ in halves):
            fail(f"mixed graph ({name}): the written pages differ")
        idx = torch.tensor(shared, device=dev)
        if not all(torch.equal(x[:, idx], z[:, idx]) for x, _, z in halves):
            fail(f"mixed graph ({name}): a shared prefix page was written")
        suffix = {"int8": "_q8", "int4": "_q4"}.get(kv, "")
        want = {"rpa_mixed" + suffix: K * L, "int4_matmul": 0}
        for mode, n in (("graph", ng), ("eager", ne)):
            got = {k: n.get(k, 0) for k in want}
            plain = {k: v for k, v in n.items() if k.endswith("_plain") and v}
            if got != want or plain:
                fail(f"mixed graph ({name}, {mode}): launches {got}, plain "
                     f"{plain}; expected {want} and no plain call")
        wms = _window_writer_ms(torch, ce, *(torch.as_tensor(
            x, device=dev) for x in (steps[0][1], q_len, active)), C,
            KV, hd)
        log(f"mixed graph ({name}): the fixed-shape window writer, "
            f"{B} rows x {-(-C // P) + 1} pages: {wms:.4f} ms a layer's "
            f"k or v leaf (device, a CUDA graph of 30 calls)")
        del runs, base, cg, ce
        torch.cuda.empty_cache()


# -- phase: serve --------------------------------------------------------------


def _post(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


_PORT_KERNEL = re.compile(r"\(anonymous namespace\)::(rpa_|flash_|int4_)")


def _device_time_table(prof, wall_s: float, top: int = 12) -> list:
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
    return rows


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


def _profiled(torch, profile: bool, label: str, fn, rows=None):
    """fn() under torch.profiler when asked (printing where the device
    time went, and appending its (device us, count, kernel) rows to
    `rows`); returns fn's result."""
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
    table = _device_time_table(prof, time.perf_counter() - t0)
    if rows is not None:
        rows.extend(table)
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


# the serve phase's three drives of the same six chats through one engine
SERVE_DRIVES = ("cold", "warm", "profiled")


def phase_serve(torch, rpa, cfg, params, kv_dtype=None, i4=None,
                decode_scan: int = 1) -> tuple:
    """Six concurrent chats (three SSE) of 32 greedy tokens through the
    HTTP API and the paged engine, over a bf16 pool or with kv_dtype
    "int8"/"int4" a quantized one, at --decode-scan `decode_scan` (the
    option left out for a tree whose Args lack it). Three drives of the
    same chats through one engine: cold (the first, which captures the
    decode graphs), warm, and warm under torch.profiler (the device's
    busy share of the drive's wall). Each prints decode tok/s (the
    engine's tokens over its decode time in the drive), TTFT p50 and the
    served wall. Returns (launch counts of the kernels the path runs,
    read after the three drives; the pool's GiB; the drives' records).
    With `i4` (the int4 matmul module) `params` hold int4 weights: its
    launches are counted too, 7 per layer and decode step (a mixed
    step's 8 x 64 rows take the dequantize route)."""
    import dataclasses

    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.ops.sampling import SamplingConfig

    dev = "cuda"
    scan = ({"decode_scan": decode_scan}
            if "decode_scan" in {f.name for f in dataclasses.fields(Args)}
            else {})
    if decode_scan != 1 and not scan:
        fail("this tree's Args have no decode_scan")
    args = Args(max_slots=8, max_seq_len=2048, kv_pages=128,
                kv_page_size=128, prefill_chunk=64, temperature=0.0,
                sample_len=32, dtype="bf16", kv_dtype=kv_dtype,
                **scan).validate()
    label = (f"serve ({kv_dtype or 'bf16'} pool"
             f"{', int4 weights' if i4 else ''}, decode_scan {decode_scan})")
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
    stats = engine.stats
    records = []
    for run in SERVE_DRIVES:
        results[:] = [None] * len(prompts)
        tok0, dec0, steps0 = (stats.tokens_generated, stats.decode_time_s,
                              stats.steps)
        n0 = len(engine.retired)
        prof_rows = []
        wall = _profiled(torch, run == "profiled", f"{label} [{run}]", drive,
                         prof_rows)
        # an SSE client reads its last chunk before the engine releases
        # the request's pages and retires it, so wait for the engine to
        # retire every request before reading its records
        deadline = time.monotonic() + 30.0
        while (len(engine.retired) < n0 + len(prompts)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        for i, r in enumerate(results):
            if r is None or r.get("status") != 200:
                fail(f"{label} [{run}] request {i} failed: {r}")
        retired = list(engine.retired)[n0:]
        n_tok = [len(r.out_tokens) for r in retired]
        if len(retired) != len(prompts) or any(n != 32 for n in n_tok):
            fail(f"{label} [{run}]: expected {len(prompts)} requests of 32 "
                 f"tokens, got {n_tok}")
        dec = stats.decode_time_s - dec0
        rec = dict(
            label=label, run=run, wall_s=wall,
            decode_tok_s=(stats.tokens_generated - tok0) / dec if dec else 0,
            ttft_p50_s=statistics.median(r.first_token_t - r.submit_t
                                         for r in retired),
            steps=stats.steps - steps0,
            busy=(sum(t for t, _, _ in prof_rows) / 1e6 / wall
                  if prof_rows else None))
        records.append(rec)
        log(f"{label} [{run}]: decode {rec['decode_tok_s']:.1f} tok/s, TTFT "
            f"p50 {rec['ttft_p50_s']:.3f} s, wall {wall:.2f} s, "
            f"{rec['steps']} engine steps"
            + (f", device busy {100 * rec['busy']:.1f}%"
               if rec["busy"] is not None else ""))
    counts = dict(rpa.LAUNCHES)
    if i4 is not None:
        counts.update(i4.LAUNCHES)
    mine = [(t, n) for t, n, name in prof_rows if "::int4_" in name]
    httpd.shutdown()
    httpd.server_close()
    engine.stop()
    gib = engine.cache.memory_bytes() / 2**30
    log(f"{label}: launches {counts}; pool {gib:.3f} GiB (the sink page "
        f"included); pool pages free {engine._pager.free_pages}/"
        f"{engine.cache.n_pages}")
    suffix = {"int8": "_q8", "int4": "_q4"}.get(kv_dtype, "")
    if hasattr(rpa, "mixed_split_plan"):
        # the served shapes' mixed body, asked of the wrapper's gate on
        # small tensors of the served dtypes
        H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        store = {"int8": torch.int8, "int4": torch.uint8}.get(
            kv_dtype, torch.bfloat16)
        pool = torch.zeros((1, 64 if kv_dtype == "int4" else 128, KV, hd),
                           dtype=store, device=dev)
        kw = ({} if kv_dtype is None
              else dict(scale_k=torch.ones((1, KV), device=dev)))
        q = torch.zeros((8, 64, H, hd), dtype=torch.bfloat16, device=dev)
        log(f"{label}: rpa_mixed{suffix} at B = 8, C = 64, 16 table "
            f"columns: {_mixed_body(rpa, q, pool, pool, kw, 16, 128)}")
    if engine._pager.free_pages != engine.cache.n_pages:
        fail(f"{label}: pages leaked after every request retired")
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
        if mine:
            log(f"{label}: int4_matmul kernels {sum(n for _, n in mine)} "
                f"launches, {sum(t for t, _ in mine) / 1e3:.2f} ms of "
                f"device time (profiled drive)")
        L = cfg.num_hidden_layers
        want = 7 * counts["rpa_decode" + suffix]     # 32 per decode step
        if counts["int4_matmul"] != want or want <= 0:
            fail(f"{label}: {counts['int4_matmul']} int4_matmul launches, "
                 f"expected {want} (7 x {L} per decode step)")
    del engine, master, gen, httpd
    torch.cuda.empty_cache()
    return {k: counts[k] for k in served}, gib, records


# -- phase: prefix -------------------------------------------------------------

# kernel against plain at full depth, bf16: layer 0's pages are written
# before any attention, so they must be byte-identical; past it the two
# routes drift apart through 32 layers of bf16 rounding (flash rounds p
# to bf16, as Pallas does; the einsum keeps it in f32), so logits and
# pages are held to a share of their largest magnitude
PREFIX_REL_TOL = 5e-2
# the system message of the prefix phase's chats: its rendered Llama-3
# head is 701 byte tokens, 5 shared pages of 128 after rounding down
PREFIX_SYSTEM = ("You are a careful assistant for a team that shares one "
                 "long system prompt. " * 8)[:630]
# the prefix phase's device (a rehearsal on the CPU may set another)
DEV = "cuda"
PREFIX_USERS = ("Why is the sky blue?", "Name three colours.",
                "Count to five.", "Tell me about pages.", "Hello there.",
                "What is a prefix?")


def _pool_leaves(cache):
    return [t for pool in (cache.k, cache.v)
            for t in (pool if isinstance(pool, tuple) else (pool,))]


def _prefix_steps(torch, fa, cfg, params, kv_dtype) -> dict:
    """The three prefills of the shared-prefix path at full width and
    depth, each run with attn="kernel" and attn="plain" on clones of one
    pool: the 640-token prefix into its 5 pages (prefill_prefix_pages,
    flash_attn), a 100-token suffix after it in a 128 bucket
    (prefill_slot_paged_prefixed at pos 640, flash_attn_cached) and a
    64-token window at pos 704 of a row that maps the prefix
    (prefill_slot_paged_chunk, flash_attn_cached over the gathered row).
    The kernel side carries on to the next call."""
    from cake_tpu_torch.kv.quantized_pool import QUANTIZED_CACHES
    from cake_tpu_torch.models.llama import paged as pg
    from cake_tpu_torch.models.llama.model import RopeTables

    dev, T, P = DEV, 2048, 128
    L = cfg.num_hidden_layers
    gen = torch.Generator(device=dev).manual_seed(21)
    rope = RopeTables.create(cfg, T, device=dev)
    if kv_dtype is None:
        cache = pg.PagedKVCache.create(cfg, 4, 32, P, T,
                                       dtype=torch.bfloat16, device=dev)
    else:
        cache = QUANTIZED_CACHES[kv_dtype].create(cfg, 4, 32, P, T,
                                                  device=dev)
    ids = lambda n: torch.randint(0, cfg.vocab_size, (1, n), generator=gen,  # noqa: E731
                                  device=dev, dtype=torch.int32)
    prefix = ids(5 * P)
    row = torch.full((T // P,), -1, dtype=torch.int32, device=dev)
    row[:5] = torch.arange(5, dtype=torch.int32, device=dev)
    table = torch.full_like(cache.table, -1)
    table[0, :8] = torch.arange(8, dtype=torch.int32, device=dev)
    table[1, :5] = torch.arange(5, dtype=torch.int32, device=dev)
    table[1, 5:8] = torch.arange(8, 11, dtype=torch.int32, device=dev)
    suffix = torch.cat([ids(100), torch.zeros((1, 28), dtype=torch.int32,
                                              device=dev)], dim=1)
    window = ids(64)
    calls = (
        ("prefill_prefix_pages", False,
         lambda c, a: pg.prefill_prefix_pages(params, prefix, row, c, rope,
                                              cfg, attn=a)),
        ("prefill_slot_paged_prefixed", True,
         lambda c, a: pg.prefill_slot_paged_prefixed(
             params, suffix, 100, 0, c, rope, cfg, n_prefix=5 * P, attn=a)),
        ("prefill_slot_paged_chunk", True,
         lambda c, a: pg.prefill_slot_paged_chunk(
             params, window, 64, 1, 5 * P + 64, c, rope, cfg, attn=a)),
    )
    label = f"prefix steps ({kv_dtype or 'bf16'} pool)"
    counts = {}
    for name, has_logits, fn in calls:
        sides = {}
        for attn in ("kernel", "plain"):
            c = cache.clone()
            fa.reset_launch_counts()
            out = fn(c, attn)
            torch.cuda.synchronize()
            sides[attn] = ((out[0] if has_logits else None), c,
                           dict(fa.LAUNCHES))
        (lk, ck, nk), (lp, cp, npl) = sides["kernel"], sides["plain"]
        kern = "flash_attn_cached" if has_logits else "flash_attn"
        want = {kern: L}
        got = {k: v for k, v in nk.items() if v}
        if got != want or any(npl.values()):
            fail(f"{label} {name}: kernel side launched {got}, plain side "
                 f"{ {k: v for k, v in npl.items() if v} }; expected {want} "
                 "and nothing on the plain side")
        counts[kern] = counts.get(kern, 0) + L
        msg = f"{label} {name}: {L} {kern} launches"
        if has_logits:
            err = (lk - lp).abs().max().item()
            ref = lp.abs().max().item()
            msg += (f"; logits max |kernel - plain| = {err:.3e} "
                    f"({err / ref:.3e} of max |plain| {ref:.3e}, tol "
                    f"{PREFIX_REL_TOL})")
            if not torch.isfinite(lk).all() or err > PREFIX_REL_TOL * ref:
                fail(msg)
        pk, pp = _pool_leaves(ck), _pool_leaves(cp)
        if not all(torch.equal(a[0], b[0]) for a, b in zip(pk, pp)):
            fail(f"{label} {name}: layer 0's pages differ between the "
                 "kernel and the plain route")
        perr = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(pk, pp))
        pref = max(b.float().abs().max().item() for b in pp)
        msg += (f"; pool layer 0 identical, max |kernel - plain| = "
                f"{perr:.3e} ({perr / pref:.3e} of {pref:.3e}, tol "
                f"{PREFIX_REL_TOL})")
        log(msg)
        if perr > PREFIX_REL_TOL * pref:
            fail(msg)
        cache = ck
        if name == "prefill_prefix_pages":
            cache.table.copy_(table)
        del sides, cp
    del cache
    torch.cuda.empty_cache()
    return counts


def _prefix_serve(torch, rpa, fa, cfg, params, kv_dtype, mixed: str,
                  auto_prefix: bool, profile: bool = False) -> dict:
    """One engine behind the HTTP API (the serve phase's Args, plus
    --auto-prefix, --mixed-batch `mixed`, --decode-scan 4): a warm-up chat
    with PREFIX_SYSTEM (it registers the head), then six concurrent chats
    with the same system message and their own user turns, 32 greedy
    tokens each, while a thread samples the pages in use (with `profile`,
    under torch.profiler: the card's busy share of the drive). Returns
    the drive's record."""
    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.ops.sampling import SamplingConfig

    args = Args(max_slots=8, max_seq_len=2048, kv_pages=128,
                kv_page_size=128, prefill_chunk=64, temperature=0.0,
                sample_len=32, dtype="bf16", kv_dtype=kv_dtype,
                decode_scan=4, mixed_batch=mixed,
                auto_prefix=auto_prefix).validate()
    label = (f"prefix serve ({kv_dtype or 'bf16'} pool, mixed-batch "
             f"{mixed}, {'auto-prefix' if auto_prefix else 'no prefix'})")
    gen = LlamaGenerator(cfg, params, ByteTokenizer(cfg.vocab_size),
                         max_seq_len=2048,
                         sampling=SamplingConfig(temperature=0.0),
                         cache_dtype=torch.bfloat16, device=DEV)
    master = Master(args, text_generator=gen)
    engine = master.make_engine()
    httpd = start(master, "127.0.0.1:0", block=False, engine=engine)
    url = (f"http://127.0.0.1:{httpd.server_address[1]}"
           "/api/v1/chat/completions")
    errors = []

    def chat(user):
        body = {"messages": [{"role": "system", "content": PREFIX_SYSTEM},
                             {"role": "user", "content": user}],
                "max_tokens": 32, "temperature": 0.0}
        try:
            with _post(url, body) as r:
                json.loads(r.read())
                if r.status != 200:
                    errors.append(r.status)
        except Exception as e:   # noqa: BLE001
            errors.append(repr(e))

    def wait_retired(n):
        deadline = time.monotonic() + 60.0
        while len(engine.retired) < n and time.monotonic() < deadline:
            time.sleep(0.005)

    stats = engine.stats
    rpa.reset_launch_counts()
    fa.reset_launch_counts()
    chat("Warm up.")
    wait_retired(1)
    shared, before = [], []
    if auto_prefix:
        if (len(engine._prefixes) != 1
                or any(p is None or p < 0
                       for p in engine._auto_pids.values())):
            fail(f"{label}: the system prompt's head did not register "
                 f"(registry {list(engine._prefixes)}, heads "
                 f"{list(engine._auto_pids.values())}): the auto-prefix "
                 "registration failed and requests were served whole")
        (_, shared), = engine._prefixes.values()
        idx = torch.tensor(shared, device=DEV)
        before = [t[:, idx].clone() for t in _pool_leaves(engine.cache)]
    hits0, tok0, dec0 = (stats.prefix_hits, stats.tokens_generated,
                         stats.decode_time_s)
    n0 = len(engine.retired)
    peak = [engine._pager.live_pages]
    done = threading.Event()

    def sample():
        while not done.is_set():
            peak[0] = max(peak[0], engine._pager.live_pages)
            time.sleep(0.0005)

    def drive():
        t0 = time.perf_counter()
        threads = [threading.Thread(target=chat, args=(u,))
                   for u in PREFIX_USERS]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        return time.perf_counter() - t0

    sampler = threading.Thread(target=sample)
    sampler.start()
    prof_rows = []
    wall = _profiled(torch, profile, label, drive, prof_rows)
    wait_retired(n0 + len(PREFIX_USERS))
    done.set()
    sampler.join()
    retired = list(engine.retired)[n0:]
    n_tok = [len(r.out_tokens) for r in retired]
    if errors or len(retired) != len(PREFIX_USERS) or any(
            n != 32 for n in n_tok):
        fail(f"{label}: errors {errors}, tokens {n_tok}")
    dec = stats.decode_time_s - dec0
    rec = dict(
        label=label, kv_dtype=kv_dtype or "bf16", mixed=mixed,
        auto_prefix=auto_prefix, wall_s=wall,
        prefix_hits=stats.prefix_hits - hits0,
        shared_pages=len(shared), peak_pages=peak[0],
        decode_tok_s=(stats.tokens_generated - tok0) / dec if dec else 0,
        ttft_p50_s=statistics.median(r.first_token_t - r.submit_t
                                     for r in retired),
        launches={k: v for c in (fa.LAUNCHES, rpa.LAUNCHES)
                  for k, v in c.items() if v},
        busy=(sum(t for t, _, _ in prof_rows) / 1e6 / wall
              if prof_rows else None))
    if auto_prefix:
        after = [t[:, idx] for t in _pool_leaves(engine.cache)]
        if not all(torch.equal(a, b) for a, b in zip(before, after)):
            fail(f"{label}: a shared prefix page (or its scale) was "
                 "written while serving")
        if rec["prefix_hits"] != len(PREFIX_USERS):
            fail(f"{label}: {rec['prefix_hits']} prefix hits, expected "
                 f"{len(PREFIX_USERS)}")
    httpd.shutdown()
    httpd.server_close()
    engine.stop()
    live, registry = engine._pager.live_pages, len(shared)
    if live != registry:
        fail(f"{label}: {live} pages live after every request retired, "
             f"the registry holds {registry}")
    plain = {k: v for k, v in rec["launches"].items() if k.endswith("_plain")}
    if plain:
        fail(f"{label}: plain versions ran on the served path: {plain}")
    log(f"{label}: {rec['prefix_hits']} prefix hits over "
        f"{len(PREFIX_USERS)} chats ({len(shared)} shared pages), peak "
        f"{rec['peak_pages']} pages in use, TTFT p50 "
        f"{rec['ttft_p50_s']:.3f} s, decode {rec['decode_tok_s']:.1f} "
        f"tok/s, wall {wall:.2f} s"
        + (f", device busy {100 * rec['busy']:.1f}%"
           if rec["busy"] is not None else "")
        + f"; launches {rec['launches']}")
    del engine, master, gen, httpd
    torch.cuda.empty_cache()
    return rec


def phase_prefix(torch, rpa, fa, cfg, params, card: str,
                 profile: bool = False) -> tuple:
    """Shared-prefix pages and the phase-split prefill at Llama-3-8B width
    and depth, over a bf16 and an int8 pool: the three prefills kernel
    against plain (`_prefix_steps`), then the six chats with one system
    message through the HTTP API at --mixed-batch auto and off with
    --auto-prefix, against the same chats without it (each drive under
    torch.profiler with `profile`). Returns (the flash launches of the
    served drives, the drives' records)."""
    served = {"flash_attn": 0, "flash_attn_cached": 0}
    records = []
    for kv in (None, "int8"):
        _prefix_steps(torch, fa, cfg, params, kv)
        recs = {(m, a): _prefix_serve(torch, rpa, fa, cfg, params, kv, m, a,
                                      profile)
                for m, a in (("auto", False), ("auto", True), ("off", True))}
        base = recs[("auto", False)]["peak_pages"]
        for (m, a), r in recs.items():
            if a and not r["peak_pages"] < base:
                fail(f"{r['label']}: peak {r['peak_pages']} pages, not "
                     f"fewer than {base} without the prefix")
            if a:
                for k in served:
                    served[k] += r["launches"].get(k, 0)
        off = recs[("off", True)]["launches"]
        if not (off.get("flash_attn", 0) > 0
                and off.get("flash_attn_cached", 0) > 0):
            fail(f"prefix ({kv or 'bf16'} pool): the mixed-batch off drive "
                 f"launched {off}, expected flash_attn and "
                 "flash_attn_cached")
        records += list(recs.values())
    for r in records:
        busy = "-" if r["busy"] is None else f"{100 * r['busy']:.1f}%"
        log(f"prefix summary: {r['label']:<58} hits {r['prefix_hits']}  "
            f"peak pages {r['peak_pages']:3d}  TTFT p50 "
            f"{r['ttft_p50_s']:.3f} s  decode {r['decode_tok_s']:7.1f} "
            f"tok/s  wall {r['wall_s']:5.2f} s  busy {busy}  [{card}]")
    return served, records



# -- phase: sched --------------------------------------------------------------

# the sched phase's pool: 40 pages of 128 tokens (+ the sink), 8 slots
SCHED_PAGES = 40
SCHED_LAYERS_F32 = 4       # the f32 identity drive's depth (8B width)
# (round, class, prompt tokens, max tokens, how many); round A: six
# batch chats of 6 pages each (36), then two interactive of 3 (the
# second finds 4 free and must preempt one batch slot for "pages");
# round B: eight batch chats fill every slot, one interactive preempts
# for "slots"
SCHED_ROUNDS = {
    "A": (("batch", 512, 256, 6), ("interactive", 300, 64, 2)),
    "B": (("batch", 128, 64, 8), ("interactive", 128, 32, 1)),
}
MFU_RAW_MAX = 1.05
HBM_SHARE_TOL = 0.30       # decode records' HBM share against bound/replay


def _metric(text: str, name: str, **labels) -> float:
    """One sample of a Prometheus exposition (0 when absent)."""
    want = ",".join(f'{k}="{v}"' for k, v in labels.items())
    pat = re.escape(name) + (r"\{" + re.escape(want) + r"\}" if want
                             else "") + r" (\S+)$"
    m = re.search(pat, text, re.M)
    return float(m.group(1)) if m else 0.0


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read()


def _tagged_chat(tokenizer, tag: str, n_tokens: int) -> str:
    """A user message (no system message) whose Llama-3 rendering encodes
    to exactly n_tokens byte tokens, starting with `tag`."""
    from cake_tpu_torch.models.chat import History, Message

    h = History("llama3")
    h.add_message(Message.user(""))
    room = n_tokens - len(tokenizer.encode(h.render())) - len(tag) - 1
    if room < 0:
        fail(f"a {n_tokens}-token chat cannot hold its template and tag")
    return f"{tag} " + "".join("abcdefgh"[i % 8] for i in range(room))


class _SchedServer:
    """One engine behind the HTTP API at the sched phase's geometry, and
    the client side of the rounds: chats posted from threads with their
    class in the body, each named by the tag its message starts with (the
    same tags, so the same prompts, in every drive)."""

    def __init__(self, torch, cfg, params, dtype, classes: bool,
                 shed: bool = False, sched_config=None):
        from cake_tpu_torch.api.server import start
        from cake_tpu_torch.args import Args
        from cake_tpu_torch.master import Master
        from cake_tpu_torch.models.llama.generator import (
            ByteTokenizer, LlamaGenerator,
        )
        from cake_tpu_torch.ops.sampling import SamplingConfig

        args = Args(max_slots=8, max_seq_len=2048, kv_pages=SCHED_PAGES,
                    kv_page_size=128, prefill_chunk=64, temperature=0.0,
                    sample_len=32, decode_scan=4, step_ring=8192,
                    priority_classes=classes, shed=shed).validate()
        self.gen = LlamaGenerator(cfg, params, ByteTokenizer(cfg.vocab_size),
                                  max_seq_len=2048,
                                  sampling=SamplingConfig(temperature=0.0),
                                  cache_dtype=dtype, device=DEV)
        self.master = Master(args, text_generator=self.gen)
        kw = {"sched_config": sched_config} if sched_config else {}
        self.engine = self.master.make_engine(**kw)
        self.httpd = start(self.master, "127.0.0.1:0", block=False,
                           engine=self.engine)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.threads, self.status, self._reqs = [], {}, {}

    def post(self, system: str, cls: str, n_prompt: int, max_tokens: int):
        user = _tagged_chat(self.engine.tokenizer, system, n_prompt)
        body = {"messages": [{"role": "user", "content": user}],
                "max_tokens": max_tokens, "temperature": 0.0,
                "priority": cls}

        def one():
            try:
                with _post(self.url + "/api/v1/chat/completions",
                           body) as r:
                    json.loads(r.read())
                    self.status[system] = (r.status, None)
            except urllib.error.HTTPError as e:
                self.status[system] = (e.code,
                                       e.headers.get("Retry-After"))
            except Exception as e:   # noqa: BLE001
                self.status[system] = (-1, repr(e))

        t = threading.Thread(target=one)
        t.start()
        self.threads.append(t)

    def request(self, system: str):
        """The engine's request for a chat (live or retired), by its tag
        (found once, then kept)."""
        got = self._reqs.get(system)
        if got is None:
            key = f"\n\n{system} "
            dec = self.engine.tokenizer.decode
            for req in list(self.engine._requests.values()) + list(
                    self.engine.retired):
                if key in dec(req.prompt_ids[:160]):
                    got = self._reqs[system] = req
                    break
        return got

    def wait_tokens(self, systems, n: int, timeout: float = 120.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            reqs = [self.request(s) for s in systems]
            if all(r is not None and len(r.out_tokens) >= n for r in reqs):
                return
            time.sleep(0.005)
        fail(f"sched: {systems} did not reach {n} tokens")

    def join(self):
        for t in self.threads:
            t.join(timeout=900)
        self.threads = []

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.stop()


def _sched_round(srv: "_SchedServer", rnd: str, tag: str) -> dict:
    """One round's arrivals: the batch chats together, then (once every
    batch chat is decoding) the interactive ones one after the other,
    each once the one before it has its first token. Returns system ->
    (class, the request) after every chat has completed."""
    (bcls, bp, bn, bk), (icls, ip, inn, ik) = SCHED_ROUNDS[rnd]
    batch = [f"{rnd}b{i}" for i in range(bk)]
    inter = [f"{rnd}i{i}" for i in range(ik)]
    for sysmsg in batch:
        srv.post(sysmsg, bcls, bp, bn)
    srv.wait_tokens(batch, 8)
    for sysmsg in inter:
        srv.post(sysmsg, icls, ip, inn)
        srv.wait_tokens([sysmsg], 1)
    srv.join()
    out = {}
    for sysmsg, cls in [(b, bcls) for b in batch] + [(i, icls)
                                                    for i in inter]:
        code, err = srv.status.get(sysmsg, (None, None))
        if code != 200:
            fail(f"sched round {rnd} ({tag}): {sysmsg!r} got {code} {err}")
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            req = srv.request(sysmsg)
            if req is not None and req.done.is_set():
                break
            time.sleep(0.005)
        out[sysmsg] = (cls, req)
    return out


def _sched_drive(torch, cfg, params, dtype, classes: bool, tag: str):
    """Rounds A and B through one server: returns (the rounds' requests,
    the preemptions by round and reason read from /metrics, the server,
    still open)."""
    srv = _SchedServer(torch, cfg, params, dtype, classes)
    rounds, preempted = {}, {}
    for rnd in SCHED_ROUNDS:
        before = _get(srv.url + "/metrics").decode()
        rounds[rnd] = _sched_round(srv, rnd, tag)
        after = _get(srv.url + "/metrics").decode()
        preempted[rnd] = {
            r: _metric(after, "cake_preemptions_total", reason=r)
            - _metric(before, "cake_preemptions_total", reason=r)
            for r in ("pages", "slots")}
        free = srv.engine._pager.free_pages
        if free != SCHED_PAGES:
            fail(f"sched round {rnd} ({tag}): {free} of {SCHED_PAGES} "
                 "pages free after every chat completed")
    return rounds, preempted, srv


def _sched_identity(rounds, fifo, label: str, card: str,
                    required: bool) -> list:
    """Each preempted stream against the same chat in the FIFO drive:
    prints where each differs (if it does); with `required` a difference
    fails. Returns the preempted chats' (system, tokens, preemptions)."""
    victims = []
    for rnd, chats in rounds.items():
        for sysmsg, (cls, req) in chats.items():
            want = fifo[rnd][sysmsg][1].out_tokens
            if req.out_tokens != want:
                k = next((i for i, (a, b) in enumerate(
                    zip(req.out_tokens, want)) if a != b),
                    min(len(req.out_tokens), len(want)))
                msg = (f"sched identity ({label}): {sysmsg!r} "
                       f"({'preempted' if req.preemptions else 'never preempted'}) "
                       f"differs from the FIFO drive at token {k} of "
                       f"{len(want)}")
                if required:
                    fail(msg)
                log(msg + f" [{card}]")
            if req.preemptions:
                victims.append((sysmsg, len(req.out_tokens),
                                req.preemptions,
                                req.out_tokens == want))
    for v in victims:
        log(f"sched identity ({label}): victim {v[0]!r}: {v[1]} tokens, "
            f"preempted {v[2]}x, identical to FIFO: {v[3]} [{card}]")
    return victims


def _sched_shed(torch, cfg, params, card: str) -> dict:
    """A burst of batch chats past the shed's depth: a server with
    --priority-classes --shed whose batch class holds a 1 s queue-wait
    target; four warm-up chats one after the other, then a second's
    pause, give the controller a measured rate of a few retirements a
    second, then 48 batch chats arrive at once. Some must get 429 with a
    Retry-After above 0 (and every other one 200)."""
    from cake_tpu_torch.sched import SchedConfig
    from cake_tpu_torch.sched.classes import DEFAULT_POLICIES, ClassPolicy

    pol = tuple(ClassPolicy(p.name, p.rank, p.aging_s,
                            1.0 if p.name == "batch" else p.target_wait_s)
                for p in DEFAULT_POLICIES)
    srv = _SchedServer(torch, cfg, params, torch.bfloat16, True, shed=True,
                       sched_config=SchedConfig(policies=pol))
    for i in range(4):
        srv.post(f"W{i}", "batch", 160, 4)
        srv.join()
    time.sleep(1.0)
    burst = [f"S{i}" for i in range(48)]
    for sysmsg in burst:
        srv.post(sysmsg, "batch", 160, 8)
    srv.join()
    codes = [srv.status[s] for s in burst]
    shed = [ra for c, ra in codes if c == 429]
    if not shed or any(c not in (200, 429) for c, _ in codes):
        fail(f"sched shed: expected some 429s and otherwise 200, got "
             f"{sorted(set(c for c, _ in codes))}")
    if any(ra is None or float(ra) <= 0 for ra in shed):
        fail(f"sched shed: 429 without a Retry-After above 0: {shed}")
    evs = json.loads(_get(srv.url + "/api/v1/events?type=shed"))
    text = _get(srv.url + "/metrics").decode()
    n_metric = _metric(text, "cake_shed_requests_total", **{"class": "batch"})
    rec = dict(admitted=len(codes) - len(shed), shed=len(shed),
               retry_after_s=sorted(set(int(r) for r in shed)),
               events=len(evs["events"]), metric=n_metric)
    if rec["events"] != len(shed):
        fail(f"sched shed: {len(shed)} 429s but {rec['events']} shed events")
    log(f"sched shed: 48 batch chats at once: {rec['admitted']} admitted, "
        f"{rec['shed']} shed with Retry-After {rec['retry_after_s']} s "
        f"(cake_shed_requests_total{{class=batch}} {n_metric:.0f}) [{card}]")
    srv.close()
    return rec


def _sched_steps(srv, card: str) -> dict:
    """The classes drive's flight records through /api/v1/steps: every
    record's mfu in (0, 1] and its unclamped ratios (the engine's own
    records) at most MFU_RAW_MAX; mean mfu and hbm_util per kind; the
    decode records' HBM share against the step phase's bound over its
    replay (when the step phase ran in this call)."""
    doc = json.loads(_get(srv.url + "/api/v1/steps?limit=8192"))
    steps = doc["steps"]
    raw = srv.engine.flight.records()
    if not steps or len(raw) != len(steps):
        fail(f"sched steps: {len(steps)} records served, {len(raw)} held")
    bad = [s for s in steps if s["mfu"] is None or not 0 < s["mfu"] <= 1
           or s["hbm_util"] is None or not 0 < s["hbm_util"] <= 1]
    if bad:
        fail(f"sched steps: {len(bad)} records with mfu or hbm_util "
             f"outside (0, 1], e.g. {bad[0]}")
    top = max(max(r.mfu_raw, r.hbm_raw) for r in raw)
    if top > MFU_RAW_MAX:
        fail(f"sched steps: an unclamped ratio of {top:.3f} (> "
             f"{MFU_RAW_MAX}): the count or the clock is wrong")
    kinds = {}
    for s in steps:
        if s["compiled"]:
            continue
        k = kinds.setdefault(s["kind"], {"n": 0, "mfu": 0.0, "hbm": 0.0,
                                         "dev_ms": 0.0, "tokens": 0})
        k["n"] += 1
        k["mfu"] += s["mfu"]
        k["hbm"] += s["hbm_util"]
        k["dev_ms"] += s["device_s"] * 1e3
        k["tokens"] += s["tokens"]
    for name, k in sorted(kinds.items()):
        k["mfu"] /= k["n"]
        k["hbm"] /= k["n"]
        k["dev_ms"] /= k["n"]
        log(f"sched steps: {name:<12} {k['n']:4d} records, mean mfu "
            f"{k['mfu']:.5f}, mean hbm_util {k['hbm']:.4f}, mean device "
            f"{k['dev_ms']:.3f} ms [{card}]")
    log(f"sched steps: largest unclamped ratio {top:.4f}; summary "
        f"{json.dumps(doc['summary']['kinds'])}")
    out = {"kinds": kinds, "raw_max": top}
    rep = GRAPH_REPLAY.get("bf16 weights")
    dec = [s for s in steps if s["kind"] in ("decode", "decode_scan")
           and not s["compiled"]]
    if dec:
        share = statistics.mean(s["hbm_util"] for s in dec)
        out["decode_hbm_util"] = share
        if rep is None:
            log(f"sched steps: decode hbm_util {share:.4f}; the step phase "
                "did not run, so no bound/replay to hold it against")
        else:
            replay_ms, bound_ms = rep
            want = bound_ms / replay_ms
            out["bound_over_replay"] = want
            log(f"sched steps: decode hbm_util {share:.4f} against the "
                f"step phase's bound {bound_ms:.3f} ms over its replay "
                f"{replay_ms:.3f} ms = {want:.4f} [{card}]")
            if abs(share / want - 1) > HBM_SHARE_TOL:
                fail(f"sched steps: decode hbm_util {share:.4f} is not "
                     f"within {HBM_SHARE_TOL:.0%} of bound/replay "
                     f"{want:.4f}")
    return out


def phase_sched(torch, rpa, cfg, params, card: str) -> tuple:
    """SLO scheduling and the observability core through the front door
    at Llama-3-8B width and depth, random bf16 weights: a 40-page bf16
    pool, 8 slots, chunk 64, --decode-scan 4. Rounds A (page
    preemption) and B (slot preemption) with --priority-classes, then
    the same arrivals without (the FIFO drive): exactly one "pages" and
    one "slots" preemption by /metrics, every chat completes, the free
    pages back to 40; interactive TTFT p50 with and without classes;
    /api/v1/steps records with mfu in (0, 1] (unclamped at most
    MFU_RAW_MAX), means per kind, and the decode records' HBM share
    against the step phase's bound over its replay. Each preempted
    stream is compared token for token with the FIFO drive's: at bf16
    printed, at f32 (the same rounds at 8B width, SCHED_LAYERS_F32
    layers, f32 weights and pool) required. Then the shed burst.
    Returns (the decode and mixed kernels' launches on the classes
    drive, the phase's record)."""
    from cake_tpu_torch.models.llama.params import init_params

    t_phase = time.perf_counter()
    rpa.reset_launch_counts()
    rounds, preempted, srv = _sched_drive(torch, cfg, params,
                                          torch.bfloat16, True, "bf16")
    counts = dict(rpa.LAUNCHES)
    steps = _sched_steps(srv, card)
    srv.close()
    want = {"A": {"pages": 1.0, "slots": 0.0},
            "B": {"pages": 0.0, "slots": 1.0}}
    if preempted != want:
        fail(f"sched: preemptions by round and reason {preempted}, "
             f"expected {want}")
    for k in ("rpa_decode", "rpa_mixed"):
        if counts.get(k, 0) <= 0:
            fail(f"sched: kernel {k} was never launched on the drive")
    plain = {k: n for k, n in counts.items() if k.endswith("_plain") and n}
    if plain:
        fail(f"sched: plain versions ran on the drive: {plain}")
    fifo, fifo_pre, fsrv = _sched_drive(torch, cfg, params, torch.bfloat16,
                                        False, "bf16")
    fsrv.close()
    if any(v for r in fifo_pre.values() for v in r.values()):
        fail(f"sched: the FIFO drive preempted: {fifo_pre}")
    victims = _sched_identity(rounds, fifo, "bf16, 32 layers", card,
                              required=False)

    def ttft(rs, cls):
        return statistics.median(
            req.first_token_t - req.submit_t for r in rs.values()
            for c, req in r.values() if c == cls)

    rec = dict(preempted=preempted, launches=counts,
               ttft_interactive_classes_s=ttft(rounds, "interactive"),
               ttft_interactive_fifo_s=ttft(fifo, "interactive"),
               ttft_batch_classes_s=ttft(rounds, "batch"),
               ttft_batch_fifo_s=ttft(fifo, "batch"),
               victims_bf16=victims, steps=steps)
    log(f"sched: preemptions {preempted}; interactive TTFT p50 "
        f"{rec['ttft_interactive_classes_s']:.3f} s with classes, "
        f"{rec['ttft_interactive_fifo_s']:.3f} s FIFO; batch "
        f"{rec['ttft_batch_classes_s']:.3f} / "
        f"{rec['ttft_batch_fifo_s']:.3f} s; launches {counts} [{card}]")
    # the fold's token identity at f32 (bf16 rounding makes the
    # re-prefilled KV of the generated tokens differ from what the
    # decode steps wrote, and 32 random layers turn that into greedy
    # near-tie flips)
    import dataclasses
    cfg32 = dataclasses.replace(cfg, num_hidden_layers=SCHED_LAYERS_F32)
    p32 = init_params(cfg32, torch.Generator(device=DEV).manual_seed(3),
                      device=DEV, dtype=torch.float32)
    r32, pre32, s32 = _sched_drive(torch, cfg32, p32, torch.float32, True,
                                   "f32")
    s32.close()
    if pre32 != want:
        fail(f"sched (f32): preemptions {pre32}, expected {want}")
    f32, _, f32s = _sched_drive(torch, cfg32, p32, torch.float32, False,
                                "f32")
    f32s.close()
    rec["victims_f32"] = _sched_identity(
        r32, f32, f"f32, {SCHED_LAYERS_F32} layers", card, required=True)
    if not rec["victims_f32"]:
        fail("sched (f32): no preempted stream to compare")
    del p32
    torch.cuda.empty_cache()
    rec["shed"] = _sched_shed(torch, cfg, params, card)
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"sched: phase wall {rec['wall_s']:.1f} s [{card}]")
    return {k: counts[k] for k in ("rpa_decode", "rpa_mixed")}, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list out of {PHASES}")
    ap.add_argument("--profile", action="store_true",
                    help="trace generate run A and run B's prefill, and the "
                         "prefix phase's drives, with torch.profiler and "
                         "print where the device time went (the serve phase "
                         "always profiles its third drive)")
    ap.add_argument("--kernels", default="",
                    help="comma list of kernel names: the kernels phase "
                         "runs only these (a parent-against-change aid)")
    ap.add_argument("--tree", default="",
                    help="import cake_tpu_torch from this directory (for "
                         "example a parent commit unpacked with git "
                         "archive) instead of the one beside this script")
    ap.add_argument("--int4-sweep", default="",
                    help="comma list of cluster sizes (ranges of the group "
                         "axis): time int4_matmul at each and exit (a "
                         "tuning aid, not part of the smoke)")
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
        int4_sweep(torch, i4, [int(t) for t in a.int4_sweep.split(",")])
        return 0
    card = phase_device(torch, rpa, fa, i4)
    only = set(a.kernels.split(",")) - {""} or None
    kern = (phase_kernels(torch, rpa, fa, i4, only) if "kernels" in phases
            else {})
    if "step" in phases:
        phase_step(torch, rpa, fa, i4)
    # the captured decode step and --decode-scan exist in this tree (a
    # parent tree without them serves at decode_scan 1 only)
    graphs = importlib.util.find_spec("cake_tpu_torch.serve.graphs")
    scans = (1, 4) if graphs else (1,)
    # and the captured mixed step (a parent tree may have only the decode
    # step's)
    mixed_graph = graphs is not None and hasattr(
        importlib.import_module("cake_tpu_torch.serve.graphs"),
        "MixedRunner")
    # launch counts of each path, read right after it ran (null in the
    # kernels line, not 0, when its phase did not run)
    counts = {}
    serve_records = []
    prefix_records = []
    sched_record = None
    if {"step", "generate", "serve", "prefix", "sched"} & set(phases):
        cfg, params = _big_params(torch)
        if "step" in phases and graphs:
            _graph_steps(torch, rpa, i4, cfg, params)
            if mixed_graph:
                _mixed_graph_steps(torch, rpa, i4, cfg, params)
        if "generate" in phases:
            counts.update(phase_generate(torch, fa, cfg, params,
                                         profile=a.profile))
        if "serve" in phases:
            pools = {}
            runs = [(None, k) for k in scans] + [
                (kv, scans[-1]) for kv in ("int8", "int4")]
            for kv, k in runs:
                got, pools[kv or "bf16"], recs = phase_serve(
                    torch, rpa, cfg, params, kv_dtype=kv, decode_scan=k)
                counts.update(got)
                serve_records += recs
            log("serve pools (128 pages x 128 tokens + the sink, 32 "
                "layers): "
                + ", ".join(f"{k} {v:.3f} GiB" for k, v in pools.items()))
        if "prefix" in phases:
            # the flash kernels' launches on the serve path join the
            # generator's in the kernels line
            served, prefix_records = phase_prefix(torch, rpa, fa, cfg,
                                                  params, card, a.profile)
            for k, n in served.items():
                counts[k] = counts.get(k, 0) + n
        if "sched" in phases:
            # the scheduling drive's decode and mixed launches join the
            # serve phase's in the kernels line
            got, sched_record = phase_sched(torch, rpa, cfg, params, card)
            for k, n in got.items():
                counts[k] = counts.get(k, 0) + n
        # the weight-quantized path, after the bf16 tree is dropped
        del params
        torch.cuda.empty_cache()
        q4 = None
        if "generate" in phases:
            q4, got = phase_generate_quant(torch, i4, cfg)
            counts["int4_matmul"] = got["int4_matmul"]
        if q4 is None and ("serve" in phases
                           or ("step" in phases and graphs)):
            from cake_tpu_torch.models.llama.params import (
                init_params_quantized,
            )
            q4 = init_params_quantized(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                device="cuda", dtype=torch.bfloat16, bits=4)
        if "step" in phases and graphs:
            _graph_steps(torch, rpa, i4, cfg, q4, int4_weights=True)
            if mixed_graph:
                _mixed_graph_steps(torch, rpa, i4, cfg, q4,
                                   int4_weights=True)
        if "serve" in phases:
            got, _, recs = phase_serve(torch, rpa, cfg, q4, i4=i4,
                                       decode_scan=scans[-1])
            serve_records += recs
            # the ragged kernels' counts stay those of the bf16-weight run
            counts["int4_matmul"] = (counts.get("int4_matmul", 0)
                                     + got["int4_matmul"])
    for r in serve_records:
        busy = "-" if r["busy"] is None else f"{100 * r['busy']:.1f}%"
        log(f"serve summary: {r['label']:<52} {r['run']:<8} decode "
            f"{r['decode_tok_s']:8.1f} tok/s  TTFT p50 {r['ttft_p50_s']:.3f} s"
            f"  wall {r['wall_s']:6.2f} s  busy {busy}")
    if serve_records:
        print(json.dumps({"serve": serve_records}), flush=True)
    if prefix_records:
        print(json.dumps({"prefix": prefix_records, "card": card}),
              flush=True)
    if sched_record is not None:
        print(json.dumps({"sched": sched_record, "card": card}),
              flush=True)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        rec = kern.get((name, "bfloat16"), {})
        f32 = kern.get((name, "float32"), {})
        extra = {}
        if name == "int4_matmul":
            # the top-level numbers are M = 1's; M = 8 and 64 ride beside
            rec = kern.get((name, "bfloat16", 1), {})
            f32 = kern.get((name, "float32", 1), {})
            extra = {f"m{m}": {
                k: kern.get((name, "bfloat16", m), {}).get(k)
                for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms", "max_abs_err")}
                for m in INT4_MS[1:]}
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
            **extra,
        })
    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
