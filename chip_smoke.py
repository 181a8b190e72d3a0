"""On-card smoke test of the PyTorch/CUDA port (`cake_tpu_torch`).

    python3 chip_smoke.py                 # every phase, one H100
    python3 chip_smoke.py --phases kernels,step

Phases, in order (any failure exits non-zero):
  device   CUDA present; card name and power limit; kernel build time.
  kernels  each ragged paged-attention kernel against its plain PyTorch
           version at the serving shapes (H=32, KV=8, hd=128, 128-token
           pages, 16 table columns, B=8, C=64), f32 and bf16 pools; its
           time, the plain version's, the bound and the yardstick SDPA.
  step     mixed_step_paged + decode_step_ragged_paged at Llama-3-8B
           width (2 layers, f32 weights and KV): kernel vs plain logits
           and pools.
  serve    32-layer Llama-3-8B-width bf16 server (random weights) behind
           the HTTP API: concurrent chat requests, buffered and SSE; both
           kernels must have run and the plain folds must not.

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

PHASES = ("device", "kernels", "step", "serve")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}   # FMA-pipe f32; bf16 TC
REPLACES = {
    "rpa_decode": "cake_tpu/ops/ragged_paged_attention.py:65",
    "rpa_mixed": "cake_tpu/ops/ragged_paged_attention.py:391",
}
SOURCE = "cake_tpu_torch/csrc/ragged_paged_attention.cu"
TOL = {"float32": dict(atol=1e-4, rtol=0.0),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# -- phase: device -------------------------------------------------------------


def phase_device(torch, rpa) -> str:
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
    rpa._library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {rpa.BUILD_INFO.get('seconds', 0.0):.2f} s)")
    for line in rpa.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
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


def _kernel_case(torch, dtype, gen, mixed: bool):
    """Serving-shape inputs: ragged positions, page boundaries, an
    unmapped hole, a dead row; for the mixed kernel decode rows, chunk
    rows at odd page offsets and an idle (q_len = 0) row."""
    dev = "cuda"
    B, H, KV, hd, P, MP, N = 8, 32, 8, 128, 128, 16, 128
    C = 64 if mixed else 1
    pool_k = torch.randn((N, P, KV, hd), generator=gen, device=dev,
                         dtype=dtype)
    pool_v = torch.randn((N, P, KV, hd), generator=gen, device=dev,
                         dtype=dtype)
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
    return q, pool_k, pool_v, table, pos_t, ql_t


def _work(q, pool_k, table, pos, q_len, elem_bytes):
    """(bytes, operations) the function needs on these inputs: every
    live, mapped K/V slot and the table entries of the live range read
    once; q read only for the query columns that attend to a slot (the
    output is zero elsewhere, whatever q holds); the whole output
    written once; 4*hd operations per (query head, attended slot)."""
    B, C, H, hd = q.shape
    _, P, KV, _ = pool_k.shape
    tab = table.tolist()
    pos_l = pos.tolist()
    ql = q_len.tolist() if q_len is not None else [1] * B
    kv_slots = 0
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
            kv_slots += min(P, last - lo + 1)
            for i in range(ql[b]):
                per_col[i] += max(0, min(P, pos_l[b] + i - lo + 1))
        attended += sum(per_col)
        q_cols += sum(1 for n in per_col if n > 0)
    row_bytes = H * hd * q.element_size()
    nbytes = (2 * kv_slots * KV * hd * elem_bytes
              + q_cols * row_bytes + B * C * row_bytes
              + table_entries * 4
              + 4 * B * (2 if q_len is not None else 1))
    ops = 4 * hd * attended * (H // KV) * KV
    return nbytes, ops


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


def phase_kernels(torch, rpa) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1234)
    report = {}
    for name, mixed in (("rpa_decode", False), ("rpa_mixed", True)):
        kern = (rpa.ragged_paged_attention_mixed if mixed
                else rpa.ragged_paged_attention)
        plain = (rpa.ragged_paged_attention_mixed_plain if mixed
                 else rpa.ragged_paged_attention_plain)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, pk, pv, table, pos, ql = _kernel_case(torch, dtype, gen,
                                                     mixed)
            args = (q, pk, pv, table, pos) + ((ql,) if mixed else ())
            got = kern(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not torch.isfinite(got.float()).all():
                fail(f"{name} {dname}: non-finite output")
            if not torch.allclose(got.float(), want.float(), **TOL[dname]):
                fail(f"{name} {dname}: max |kernel - plain| = {err:.3e} "
                     f"over tolerance {TOL[dname]}")
            # the dead row (and the mixed case's idle row) must come
            # back as exact zeros
            for dead in ((4, 3) if mixed else (7,)):
                if got[dead].abs().max().item() != 0.0:
                    fail(f"{name} {dname}: dead row {dead} is not zero")
            ms = _time_ms(torch, lambda: kern(*args))
            plain_ms = _time_ms(torch, lambda: plain(*args), reps=20)
            lib_ms = _time_ms(torch, _sdpa_yardstick(torch, *args[:5],
                                                     ql))
            nbytes, ops = _work(q, pk, table, pos, ql, pk.element_size())
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[dname] * 1e3
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations",
                       library_ms=lib_ms, bytes=nbytes, ops=ops)
            log(f"{name} {dname}: max_abs_err {err:.3e} "
                f"(tol {TOL[dname]}); {ms:.4f} ms kernel, "
                f"{plain_ms:.4f} ms plain, {lib_ms:.4f} ms sdpa, bound "
                f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}: "
                f"{nbytes} B, {ops} ops)")
            report[(name, dname)] = rec
    return report


# -- phase: step ---------------------------------------------------------------


def phase_step(torch) -> None:
    """mixed_step_paged then decode_step_ragged_paged at 8B width (2
    layers, f32), attn='kernel' vs attn='plain' from identical pools."""
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
    del params, out, base
    torch.cuda.empty_cache()


# -- phase: serve --------------------------------------------------------------


def _post(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _device_time_table(prof, wall_s: float, top: int = 12) -> None:
    """Print the kernels that took the most device time in a profiled
    window, and the device's busy share of the window's wall time."""
    rows = []
    for e in prof.key_averages():
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


def phase_serve(torch, rpa, profile: bool = False) -> dict:
    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master, TextModel
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.models.llama.params import init_params

    dev = "cuda"
    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"serve: 32-layer 8B-width bf16 params on the card in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
    args = Args(max_slots=8, max_seq_len=2048, kv_pages=128,
                kv_page_size=128, prefill_chunk=64, temperature=0.0,
                sample_len=32, dtype="bf16")
    master = Master(args, text_model=TextModel(
        cfg, params, ByteTokenizer(cfg.vocab_size)), device=dev)
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

    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA])
        prof.__enter__()
    rpa.reset_launch_counts()
    t_serve = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t_serve
    if prof is not None:
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        _device_time_table(prof, wall)
    counts = dict(rpa.LAUNCHES)
    stats = engine.stats
    retired = list(engine.retired)
    httpd.shutdown()
    httpd.server_close()
    engine.stop()
    log(f"serve: launches {counts}")
    for i, r in enumerate(results):
        log(f"serve request {i}: {r}")
        if r is None or r.get("status") != 200:
            fail(f"serve request {i} failed: {r}")
    n_tok = [len(r.out_tokens) for r in retired]
    ttfts = [r.first_token_t - r.submit_t for r in retired]
    log(f"serve: {len(retired)} requests retired, generated tokens "
        f"{n_tok}; TTFT p50 {statistics.median(ttfts):.3f} s; aggregate "
        f"decode {stats.decode_tokens_per_s:.1f} tok/s over "
        f"{stats.decode_time_s:.2f} s of decode; {stats.steps} engine "
        f"steps; wall {wall:.2f} s; "
        f"pool pages free {engine._pager.free_pages}/{engine.cache.n_pages}")
    if len(retired) != len(prompts) or any(n != 32 for n in n_tok):
        fail(f"serve: expected {len(prompts)} requests of 32 tokens, got "
             f"{n_tok}")
    if engine._pager.free_pages != engine.cache.n_pages:
        fail("serve: pages leaked after every request retired")
    for k in rpa.KERNELS:
        if counts[k] <= 0:
            fail(f"serve: kernel {k} was never launched on the served path")
        if counts[k + "_plain"] != 0:
            fail(f"serve: plain fold {k}_plain ran on the served path")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list out of {PHASES}")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve phase with torch.profiler and "
                         "print where the device time went")
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
        import cake_tpu_torch.ops.ragged_paged_attention as rpa
    except ImportError as e:
        fail(f"cake_tpu_torch is not importable next to this script "
             f"({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_device(torch, rpa)
    kern = phase_kernels(torch, rpa) if "kernels" in phases else {}
    if "step" in phases:
        phase_step(torch)
    counts = (phase_serve(torch, rpa, profile=a.profile)
              if "serve" in phases else {})

    rows = []
    for name in rpa.KERNELS:
        rec = kern.get((name, "bfloat16"), {})
        f32 = kern.get((name, "float32"), {})
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            # null, not 0, when the serve phase (the main path) did not run
            "replaces": REPLACES[name], "launches": counts.get(name),
            "max_abs_err": rec.get("max_abs_err"),
            "max_abs_err_f32": f32.get("max_abs_err"),
            "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"),
            "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms"),
            "ms_f32": f32.get("ms"),
        })
    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
