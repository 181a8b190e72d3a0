"""Ablation timing of the redesigned kernels on the card.

    python3 kernel_ablation.py
    python3 kernel_ablation.py --cases rpa_decode_q8,rpa_decode_q4

Builds patched copies of the sources in `cake_tpu_torch/csrc/`
(`flash_attention.cu`, `ragged_paged_attention.cu` and the tensor-core
tile loop they share, `tc_attention.cuh`), each variant with one part of
a kernel removed (a product, the loads of the loop, the exponentials,
the mask, the shuffle reductions, one of the two launches of a split
kernel), into `cake_tpu_torch/_build/ablation/` (one nvcc per library,
all in parallel), and times each variant the way `chip_smoke.py` times
the kernels (a replayed CUDA graph of 30 calls) at the kernel table's
shapes, bf16: `flash_attn` causal over S = T = 1024, `flash_attn_cached`
over S = 256 at pos 1280 of a 4096-slot cache, `rpa_decode` over the
table's ragged decode case at two split lengths, `rpa_decode_q8` and
`rpa_decode_q4` over the same case's int8 and int4 pools (the same split
body), `rpa_mixed` over the table's mixed case, `rpa_mixed_q8` and
`rpa_mixed_q4` over its int8 and int4 pools (the same tensor-core body,
whose raw rows are converted to bf16 a stage at a time; one variant
drops that conversion pass, another gives its raw ring three stages).
`int4_matmul` runs bf16 x over a [4096, 14336] weight (cycling copies
past the L2 cache) at M = 1, 8 and 64 and over a [14336, 4096] one at
M = 1 and 8 (one row on the CUDA-core body, the rest on the tensor-core
body: variants
without the nibble conversion, without the loop's loads, the ring alone
(no products, so no conversion either), at most two CTAs an SM, and in
natural column order with byte loads). Three variants move
`flash_attn_cached`'s pos read (none, the constant bank, a shuffled
global load).
The unpatched build also times the two split bodies at other plans
(`flash_attn_cached` at 4 and 8 warps a CTA and 1 to 6 key splits; the
three mixed kernels unsplit and at their plan; `int4_matmul` in one
range of the group axis, and at M = 1 on its tensor-core body). A variant's outputs are
wrong by design; only its time is read: the time a part removes is what
that part costs. `--cases` keeps only the variants, cases and plan
sweeps of the kernels it names (and builds only those libraries).
Imports nothing of JAX or `cake_tpu`; needs one NVIDIA card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

FA, RPA, TC = "flash_attention.cu", "ragged_paged_attention.cu", \
    "tc_attention.cuh"
INT4 = "int4_matmul.cu"
# int4_matmul bf16 over w_gate/w_up [4096, 14336] at the table's three M,
# and over w_down [14336, 4096] (16 column tiles: clusters of 16) at two
INT4_CASES = ("int4_matmul_m1", "int4_matmul_m8", "int4_matmul_m64",
              "int4_matmul_down_m1", "int4_matmul_down_m8")
# the three decode kernels: one split body over bf16, int8 and int4 pages
RPA_DECODES = ("rpa_decode", "rpa_decode_q8", "rpa_decode_q4")
# the three mixed kernels: one tensor-core body over bf16, int8 and int4
RPA_MIXED = ("rpa_mixed", "rpa_mixed_q8", "rpa_mixed_q4")
RPA_MIXED_Q = RPA_MIXED[1:]
TC_CASES = ("flash_attn", "flash_attn_cached") + RPA_MIXED
LOOP_LOADS = ("    if (j + tc::kStages < n_tiles) load_tile(j + tc::kStages);",
              "")
# variant -> ({file: [(text, replacement), ...]}, cases timed); {} = as is
FLASH = ("flash_attn", "flash_attn_cached")
POS_READ = "  const int p = g_pos;"
VARIANTS = {
    "as is": ({}, ("flash_attn", "flash_attn_cached") + RPA_DECODES
              + RPA_MIXED + INT4_CASES),
    "int4: without the nibble conversion": ({INT4: [
        ("af[t][0] = nibbles_to_pair<T>(p0);", "af[t][0] = p0;"),
        ("af[t][1] = nibbles_to_pair<T>(p1);", "af[t][1] = p1;"),
        ("af[t][2] = nibbles_to_pair<T>(p0 >> 4);", "af[t][2] = p0 >> 4;"),
        ("af[t][3] = nibbles_to_pair<T>(p1 >> 4);", "af[t][3] = p1 >> 4;")]},
        INT4_CASES),
    "int4: without the loop's loads": ({INT4: [
        ("    if (nxt < n_groups) start_group(g_begin + nxt, nxt % stages);",
         "")]}, INT4_CASES),
    "int4: the ring alone (no products, so no conversion or loads from shared memory)": ({INT4: [
        ("tc::mma16816<T>(part[t][0], af[t], b[0], b[1]);", "(void)0;"),
        ("tc::mma16816<T>(part[t][n], af[t], b[0], b[1]);", "(void)0;"),
        ("tc::mma16816<T>(part[t][n + 1], af[t], b[2], b[3]);",
         "(void)0;")]},
        INT4_CASES),
    "int4: at most two CTAs an SM (shared memory padded to 100 KB)": ({
        INT4: [("    const size_t smem = tc_smem_bytes(g, nt, stages);",
                "    const size_t smem = tc_smem_bytes(g, nt, stages) > 100000"
                " ? tc_smem_bytes(g, nt, stages) : 100000;"),
               ("  const size_t smem = core_smem_bytes(g, mt);",
                "  const size_t smem = core_smem_bytes(g, mt) > 100000 ?"
                " core_smem_bytes(g, mt) : 100000;")]}, INT4_CASES),
    "int4: natural column order, byte loads": ({INT4: [
        ("constexpr bool kWordLoads = true;",
         "constexpr bool kWordLoads = false;")]}, INT4_CASES),
    "tc: without the p.v mma": ({TC: [
        ("mma16816<T>(st.o[2 * np], pa, bv[np][0], bv[np][1]);", ""),
        ("mma16816<T>(st.o[2 * np + 1], pa, bv[np][2], bv[np][3]);", "")]},
        TC_CASES),
    "tc: without the q.k mma": ({TC: [
        ("mma16816<T>(s[2 * np], qf[kk], bk[np][0], bk[np][1]);", ""),
        ("mma16816<T>(s[2 * np + 1], qf[kk], bk[np][2], bk[np][3]);", "")]},
        TC_CASES),
    "tc: without the loop's loads": ({FA: [LOOP_LOADS], RPA: [
        LOOP_LOADS,
        ("      if (j + kRawStages < n_tiles) load_tile(j + kRawStages);",
         "")]}, TC_CASES),
    "tc: without exp2f": ({TC: [
        ("exp2f(x - (e < 2 ? mn0 : mn1))", "(x - (e < 2 ? mn0 : mn1))")]},
        TC_CASES),
    "tc: without the mask": ({TC: [
        ("const bool keep = interior || ok(j, e >> 1);",
         "const bool keep = true || ok(j, e >> 1);")]}, TC_CASES),
    "rpa_mixed_q: without the int -> bf16 conversion pass": ({RPA: [
        ("      convert(stg, hi);", "")]}, RPA_MIXED_Q),
    "rpa_mixed_q: three raw stages": ({RPA: [
        ("constexpr int kRawStages = 2;", "constexpr int kRawStages = 3;")]},
        RPA_MIXED_Q),
    "flash_attn_cached: merge launch only": ({FA: [
        ("    body<<<grid, 32 * warps, smem, stream>>>(a, vec);", "")]},
        ("flash_attn_cached",)),
    "flash_attn_cached: split launch only": ({FA: [
        ("    merge<<<blocks, 256, 0, stream>>>(a);", "")]},
        ("flash_attn_cached",)),
    "rpa_mixed: merge launch only": ({RPA: [
        ("  fn<<<grid, kThreads, smem, stream>>>(a, vec);", "")]},
        RPA_MIXED),
    "rpa_mixed: split launch only": ({RPA: [
        ("  rpa_mixed_merge_kernel<<<blocks, 256, 0, stream>>>(a);", "")]},
        RPA_MIXED),
    "rpa_decode: without the tile's compute": ({RPA: [
        ("if (nu > 0)                    // warp-uniform", "if (nu < 0)"),
        ("if (kPacked && nu_hi > 0)", "if (false)")]}, RPA_DECODES),
    "rpa_decode: without the loop's loads": ({RPA: [
        ("if (p_ok) fetch();             // into tile it - 1's stage",
         "if (false) fetch();")]}, RPA_DECODES),
    "rpa_decode: without warp_sum": ({RPA: [
        ("sc[u][g] = warp_sum(sc[u][g]) * sk;", "sc[u][g] = sc[u][g] * sk;")]},
        ("rpa_decode",)),
    "rpa_decode: without exp2f": ({RPA: [
        ("const float p = u < nu ? exp2f(sc[u][g] - mn) : 0.f;",
         "const float p = u < nu ? (sc[u][g] - mn) : 0.f;")]},
        ("rpa_decode",)),
    "rpa_decode: without the p.v FMAs": ({RPA: [
        ("acc[g][i] = fmaf(sc[u][g], vx, acc[g][i]);",
         "acc[g][i] += vx;")]}, ("rpa_decode",)),
    "rpa_decode: merge launch only": ({RPA: [
        ("  fn<<<dim3(a.KV * n_hg, a.B, a.splits), kThreads, smem, "
         "stream>>>(a, vec);", "")]}, RPA_DECODES),
    "rpa_decode: split launch only": ({RPA: [
        ("  merge<<<(outs + 255) / 256, 256, 0, stream>>>(a);", "")]},
        RPA_DECODES),
    "rpa_decode: 64-slot ring stages": ({RPA: [
        ("constexpr int kSplitTile = 32;", "constexpr int kSplitTile = 64;")]},
        ("rpa_decode",)),
    # where flash_attn_cached reads its device pos (the wrapper copies it
    # to g_pos before each launch): without the read, from the constant
    # bank, and a global load broadcast by a shuffle
    "flash pos: no read": ({FA: [
        (POS_READ, "  const int p = 1280;")]}, FLASH),
    "flash pos: the constant bank": ({FA: [
        ("__device__ int g_pos;", "__constant__ int g_pos;")]}, FLASH),
    "flash pos: a shuffled load": ({FA: [
        (POS_READ, "  const int p = __shfl_sync(0xffffffffu, g_pos, 0);")]},
        FLASH),
}


def _sources(patches):
    """{file name: text} of every csrc source and header, patched."""
    from cake_tpu_torch.utils.cuda_build import CSRC_DIR

    out = {}
    for name in (FA, RPA, TC, INT4):
        with open(os.path.join(CSRC_DIR, name)) as f:
            text = f.read()
        for old, new in patches.get(name, []):
            if old not in text:
                raise SystemExit(f"kernel_ablation: {name} no longer holds "
                                 f"{old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build(out_dir, variants):
    """One nvcc per (variant, library) its cases need, all started at
    once, each variant's patched sources in a directory of its own (so
    its patched header is the one included); {variant: {file: CDLL}}."""
    from cake_tpu_torch.utils import cuda_build

    procs = []
    for i, (name, (patches, cases)) in enumerate(variants.items()):
        vdir = os.path.join(out_dir, f"v{i}")
        os.makedirs(vdir, exist_ok=True)
        for fname, text in _sources(patches).items():
            with open(os.path.join(vdir, fname), "w") as f:
                f.write(text)
        need = {FA for c in cases if c.startswith("flash")} | {
            RPA for c in cases if c.startswith("rpa")} | {
            INT4 for c in cases if c.startswith("int4")}
        for fname in sorted(need):
            lib = os.path.join(vdir, fname.replace(".cu", ".so"))
            procs.append((name, fname, lib, subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib,
                 os.path.join(vdir, fname)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, fname, lib, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"kernel_ablation: nvcc failed on {name} "
                             f"({fname}):\n{err[-3000:]}")
        libs.setdefault(name, {})[fname] = ctypes.CDLL(lib)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="",
                    help="comma list of kernel names (default: all)")
    want = set(ap.parse_args(argv).cases.split(",")) - {""}
    variants = {name: (patches, tuple(c for c in cases
                                      if not want or c in want))
                for name, (patches, cases) in VARIANTS.items()}
    variants = {k: v for k, v in variants.items() if v[1]}
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: needs an NVIDIA card")
    import chip_smoke as cs
    import cake_tpu_torch.ops.flash_attention as fa
    import cake_tpu_torch.ops.int4_matmul as i4
    import cake_tpu_torch.ops.ragged_paged_attention as rpa
    from cake_tpu_torch.ops.quant import group_size, quantize_group
    from cake_tpu_torch.utils.cuda_build import BUILD_DIR

    t0 = time.perf_counter()
    libs = _build(os.path.join(BUILD_DIR, "ablation"), variants)
    print(f"kernel_ablation: {sum(len(v) for v in libs.values())} libraries "
          f"of {len(libs)} variants built in {time.perf_counter() - t0:.1f} s",
          flush=True)

    gen = torch.Generator(device="cuda").manual_seed(4321)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    q, k, v = rnd(1, 1024, 32, 128), rnd(1, 1024, 8, 128), rnd(1, 1024, 8, 128)
    cq, ck, cv = rnd(1, 256, 32, 128), rnd(1, 4096, 8, 128), \
        rnd(1, 4096, 8, 128)
    ck[:, 1280 + 256:] = float("nan")
    cv[:, 1280 + 256:] = float("nan")
    # the kernel reads pos on the card
    cpos = torch.tensor([1280], dtype=torch.int32, device="cuda")
    dec = cs._kernel_case(torch, torch.bfloat16,
                          torch.Generator(device="cuda").manual_seed(1234),
                          False, None)[:5]
    mix = cs._kernel_case(torch, torch.bfloat16,
                          torch.Generator(device="cuda").manual_seed(1234),
                          True, None)[:6]
    q8, q4, m8, m4 = (
        cs._kernel_case(torch, torch.bfloat16,
                        torch.Generator(device="cuda").manual_seed(1234),
                        mixed, fmt)
        for mixed, fmt in ((False, "int8"), (False, "int4"), (True, "int8"),
                           (True, "int4")))
    int4_calls = {}
    for In, Out, tag, ms in ((4096, 14336, "", (1, 8, 64)),
                             (14336, 4096, "down_", (1, 8))):
        w4 = quantize_group(torch.randn((In, Out), generator=gen,
                                        device="cuda") * In ** -0.5, 0)
        q4s = cs._copies(w4.q, w4.q.numel() + 4 * w4.scale.numel())
        s4s = [w4.scale.clone() for _ in q4s]
        for m in ms:           # cycling weight copies past the L2 cache
            x = rnd(m, In)
            int4_calls[f"int4_matmul_{tag}m{m}"] = [
                (lambda x=x, q=q, s=s, g=group_size(w4):
                 i4.int4_matmul(x, q, s, g=g)) for q, s in zip(q4s, s4s)]
    calls = {
        "flash_attn": lambda: fa.flash_attention(q, k, v),
        "flash_attn_cached": lambda: fa.flash_attention_cached(cq, ck, cv,
                                                               cpos),
        "rpa_decode": lambda: rpa.ragged_paged_attention(*dec),
        "rpa_mixed": lambda: rpa.ragged_paged_attention_mixed(*mix),
        "rpa_decode_q8": lambda: rpa.ragged_paged_attention(*q8[:5],
                                                            **q8[6]),
        "rpa_decode_q4": lambda: rpa.ragged_paged_attention(*q4[:5],
                                                            **q4[6]),
        "rpa_mixed_q8": lambda: rpa.ragged_paged_attention_mixed(*m8[:6],
                                                                 **m8[6]),
        "rpa_mixed_q4": lambda: rpa.ragged_paged_attention_mixed(*m4[:6],
                                                                 **m4[6]),
    }
    calls.update(int4_calls)

    def timed(label, case):
        fns = calls[case]
        ms, _ = cs._stream_ms(torch, fns if isinstance(fns, list) else [fns])
        print(f"kernel_ablation: {label}: {ms * 1e3:.1f} us", flush=True)

    default_slots = rpa.SPLIT_SLOTS
    plan, warps0 = fa.flash_split_plan, fa.CACHED_WARPS
    mixed_plan = rpa.mixed_split_plan
    for name, (_, cases) in variants.items():
        lib = libs[name]
        if FA in lib:
            fa._bind(lib[FA])
            fa.LIBRARY._lib = lib[FA]
        if RPA in lib:
            rpa._bind(lib[RPA])
            rpa.LIBRARY._lib = lib[RPA]
        if INT4 in lib:
            i4._bind(lib[INT4])
            i4.LIBRARY._lib = lib[INT4]
        for case in cases:
            if case != "rpa_decode":
                timed(f"{name}, {case}", case)
                continue
            for slots in (default_slots, 2 * default_slots):
                rpa.SPLIT_SLOTS = slots
                timed(f"{name}, {case} at splits of {slots} slots", case)
            rpa.SPLIT_SLOTS = default_slots
        if name != "as is":
            continue
        # the split bodies at other plans than their own
        if "flash_attn_cached" in cases:
            for warps in (4, 8):
                fa.CACHED_WARPS = warps
                for n in (1, 2, 3, 4, 6):
                    fa.flash_split_plan = lambda *a, n=n: n
                    timed(f"as is, flash_attn_cached at {warps} warps and "
                          f"{n} key splits", "flash_attn_cached")
            fa.CACHED_WARPS, fa.flash_split_plan = warps0, plan
        # int4_matmul in one range of the group axis (no cluster), and at
        # M = 1 on the CUDA-core body
        plan, tc_min = i4.split_plan, i4.TC_MIN_M
        for case in (c for c in INT4_CASES if c in cases):
            i4.split_plan = lambda *a: 1
            timed(f"as is, {case} in one split (no cluster)", case)
            i4.split_plan = plan
        for case in (c for c in ("int4_matmul_m1", "int4_matmul_down_m1")
                     if c in cases):
            i4.TC_MIN_M = 1
            timed(f"as is, {case} on the tensor-core body", case)
            i4.TC_MIN_M = tc_min
        for case in (c for c in RPA_MIXED if c in cases):
            for label, fn in (("unsplit", lambda *a: (1, a[5])),
                              ("at its plan", mixed_plan)):
                rpa.mixed_split_plan = fn
                timed(f"as is, {case} {label}", case)
            rpa.mixed_split_plan = mixed_plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
