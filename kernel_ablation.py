"""Ablation timing of the redesigned attention kernels on the card.

    python3 kernel_ablation.py

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
table's ragged decode case at two split lengths, `rpa_mixed` over the
table's mixed case. The unpatched build also times the two split bodies
at other plans (`flash_attn_cached` at 4 and 8 warps a CTA and 1 to 6
key splits; `rpa_mixed` unsplit and at its plan). A variant's outputs
are wrong by design; only its time is read: the time a part removes is
what that part costs. Imports nothing of JAX or `cake_tpu`; needs one
NVIDIA card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

FA, RPA, TC = "flash_attention.cu", "ragged_paged_attention.cu", \
    "tc_attention.cuh"
LOOP_LOADS = ("    if (j + tc::kStages < n_tiles) load_tile(j + tc::kStages);",
              "")
# variant -> ({file: [(text, replacement), ...]}, cases timed); {} = as is
VARIANTS = {
    "as is": ({}, ("flash_attn", "flash_attn_cached", "rpa_decode",
                   "rpa_mixed")),
    "tc: without the p.v mma": ({TC: [
        ("mma16816<T>(st.o[2 * np], pa, bv[np][0], bv[np][1]);", ""),
        ("mma16816<T>(st.o[2 * np + 1], pa, bv[np][2], bv[np][3]);", "")]},
        ("flash_attn", "flash_attn_cached", "rpa_mixed")),
    "tc: without the q.k mma": ({TC: [
        ("mma16816<T>(s[2 * np], qf[kk], bk[np][0], bk[np][1]);", ""),
        ("mma16816<T>(s[2 * np + 1], qf[kk], bk[np][2], bk[np][3]);", "")]},
        ("flash_attn", "flash_attn_cached", "rpa_mixed")),
    "tc: without the loop's loads": ({FA: [LOOP_LOADS], RPA: [LOOP_LOADS]},
                                     ("flash_attn", "flash_attn_cached",
                                      "rpa_mixed")),
    "tc: without exp2f": ({TC: [
        ("exp2f(x - (e < 2 ? mn0 : mn1))", "(x - (e < 2 ? mn0 : mn1))")]},
        ("flash_attn", "flash_attn_cached", "rpa_mixed")),
    "tc: without the mask": ({TC: [
        ("const bool keep = interior || ok(j, e >> 1);",
         "const bool keep = true || ok(j, e >> 1);")]},
        ("flash_attn", "flash_attn_cached", "rpa_mixed")),
    "flash_attn_cached: merge launch only": ({FA: [
        ("    body<<<grid, 32 * warps, smem, stream>>>(a, vec);", "")]},
        ("flash_attn_cached",)),
    "flash_attn_cached: split launch only": ({FA: [
        ("    merge<<<blocks, 256, 0, stream>>>(a);", "")]},
        ("flash_attn_cached",)),
    "rpa_mixed: merge launch only": ({RPA: [
        ("  fn<<<grid, kThreads, kMixSmem, stream>>>(a, vec);", "")]},
        ("rpa_mixed",)),
    "rpa_mixed: split launch only": ({RPA: [
        ("  rpa_mixed_merge_kernel<<<blocks, 256, 0, stream>>>(a);", "")]},
        ("rpa_mixed",)),
    "rpa_decode: without the tile's compute": ({RPA: [
        ("if (nu > 0) {                  // warp-uniform", "if (nu < 0) {")]},
        ("rpa_decode",)),
    "rpa_decode: without the loop's loads": ({RPA: [
        ("if (p_ok) fetch();             // into tile it - 1's stage",
         "if (false) fetch();")]}, ("rpa_decode",)),
    "rpa_decode: without warp_sum": ({RPA: [
        ("sc[u][g] = warp_sum(sc[u][g]);", "sc[u][g] = sc[u][g];")]},
        ("rpa_decode",)),
    "rpa_decode: without exp2f": ({RPA: [
        ("const float p = u < nu ? exp2f(sc[u][g] - mn) : 0.f;",
         "const float p = u < nu ? (sc[u][g] - mn) : 0.f;")]},
        ("rpa_decode",)),
    "rpa_decode: without the p.v FMAs": ({RPA: [
        ("            acc[g][i] = fmaf(sc[u][g], vx, acc[g][i]);",
         "            acc[g][i] += vx;")]}, ("rpa_decode",)),
    "rpa_decode: merge launch only": ({RPA: [
        ("  fn<<<dim3(a.KV * n_hg, a.B, a.splits), kThreads, smem, "
         "stream>>>(a, vec);", "")]}, ("rpa_decode",)),
    "rpa_decode: split launch only": ({RPA: [
        ("  merge<<<dim3(a.KV, a.B), kThreads, 0, stream>>>(a);", "")]},
        ("rpa_decode",)),
    "rpa_decode: 64-slot ring stages": ({RPA: [
        ("constexpr int kSplitTile = 32;", "constexpr int kSplitTile = 64;")]},
        ("rpa_decode",)),
}


def _sources(patches):
    """{file name: text} of every csrc source and header, patched."""
    from cake_tpu_torch.utils.cuda_build import CSRC_DIR

    out = {}
    for name in (FA, RPA, TC):
        with open(os.path.join(CSRC_DIR, name)) as f:
            text = f.read()
        for old, new in patches.get(name, []):
            if old not in text:
                raise SystemExit(f"kernel_ablation: {name} no longer holds "
                                 f"{old!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build(out_dir):
    """One nvcc per (variant, library) its cases need, all started at
    once, each variant's patched sources in a directory of its own (so
    its patched header is the one included); {variant: {file: CDLL}}."""
    from cake_tpu_torch.utils import cuda_build

    procs = []
    for i, (name, (patches, cases)) in enumerate(VARIANTS.items()):
        vdir = os.path.join(out_dir, f"v{i}")
        os.makedirs(vdir, exist_ok=True)
        for fname, text in _sources(patches).items():
            with open(os.path.join(vdir, fname), "w") as f:
                f.write(text)
        need = {FA for c in cases if c.startswith("flash")} | {
            RPA for c in cases if c.startswith("rpa")}
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: needs an NVIDIA card")
    import chip_smoke as cs
    import cake_tpu_torch.ops.flash_attention as fa
    import cake_tpu_torch.ops.ragged_paged_attention as rpa
    from cake_tpu_torch.utils.cuda_build import BUILD_DIR

    t0 = time.perf_counter()
    libs = _build(os.path.join(BUILD_DIR, "ablation"))
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
    dec = cs._kernel_case(torch, torch.bfloat16,
                          torch.Generator(device="cuda").manual_seed(1234),
                          False, None)[:5]
    mix = cs._kernel_case(torch, torch.bfloat16,
                          torch.Generator(device="cuda").manual_seed(1234),
                          True, None)[:6]
    calls = {
        "flash_attn": lambda: fa.flash_attention(q, k, v),
        "flash_attn_cached": lambda: fa.flash_attention_cached(cq, ck, cv,
                                                               1280),
        "rpa_decode": lambda: rpa.ragged_paged_attention(*dec),
        "rpa_mixed": lambda: rpa.ragged_paged_attention_mixed(*mix),
    }

    def timed(label, case):
        ms, _ = cs._stream_ms(torch, [calls[case]])
        print(f"kernel_ablation: {label}: {ms * 1e3:.1f} us", flush=True)

    default_slots = rpa.SPLIT_SLOTS
    plan, warps0 = fa.flash_split_plan, fa.CACHED_WARPS
    mixed_plan = rpa.mixed_split_plan
    for name, (_, cases) in VARIANTS.items():
        lib = libs[name]
        if FA in lib:
            fa._bind(lib[FA])
            fa.LIBRARY._lib = lib[FA]
        if RPA in lib:
            rpa._bind(lib[RPA])
            rpa.LIBRARY._lib = lib[RPA]
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
        for warps in (4, 8):
            fa.CACHED_WARPS = warps
            for n in (1, 2, 3, 4, 6):
                fa.flash_split_plan = lambda *a, n=n: n
                timed(f"as is, flash_attn_cached at {warps} warps and {n} "
                      "key splits", "flash_attn_cached")
        fa.CACHED_WARPS, fa.flash_split_plan = warps0, plan
        for label, fn in (("unsplit", lambda *a: (1, a[5])),
                          ("at its plan", mixed_plan)):
            rpa.mixed_split_plan = fn
            timed(f"as is, rpa_mixed {label}", "rpa_mixed")
        rpa.mixed_split_plan = mixed_plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
