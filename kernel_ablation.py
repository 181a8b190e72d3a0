"""Ablation timing of the two redesigned attention kernels on the card.

    python3 kernel_ablation.py

Builds patched copies of `cake_tpu_torch/csrc/flash_attention.cu` and
`ragged_paged_attention.cu`, each with one part of the kernel removed
(a product, the loads of the loop, the exponentials, the mask, the
shuffle reductions, one of the two decode launches), into
`cake_tpu_torch/_build/ablation/` (one nvcc each, in parallel), and times
each variant the way `chip_smoke.py` times the kernels (a replayed CUDA
graph of 30 calls) at the kernel table's shapes, bf16: `flash_attn`
causal over S = T = 1024, `rpa_decode` over the table's ragged decode
case, at two split lengths. A variant's outputs are wrong by design;
only its time is read: the time a part removes is what that part costs.
Imports nothing of JAX or `cake_tpu`; needs one NVIDIA card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# variant -> [(text, replacement), ...] patched into its source; [] = as is
FLASH_VARIANTS = {
    "flash as is": [],
    "flash without the p.v mma": [
        ("mma16816<T>(o[2 * np], pa, bv[np][0], bv[np][1]);", ""),
        ("mma16816<T>(o[2 * np + 1], pa, bv[np][2], bv[np][3]);", "")],
    "flash without the q.k mma": [
        ("mma16816<T>(s[2 * np], qf[kk], bk[np][0], bk[np][1]);", ""),
        ("mma16816<T>(s[2 * np + 1], qf[kk], bk[np][2], bk[np][3]);", "")],
    "flash without the loop's loads": [
        ("if (it + kTcStages < n_tiles) load_tile(it + kTcStages);", "")],
    "flash without exp2f": [
        ("exp2f(x - (e < 2 ? mn0 : mn1))", "(x - (e < 2 ? mn0 : mn1))")],
    "flash without the mask": [
        ("const bool interior =\n", "const bool interior = true ||\n")],
}
RPA_VARIANTS = {
    "rpa as is": [],
    "rpa without the tile's compute": [
        ("if (nu > 0) {                  // warp-uniform", "if (nu < 0) {")],
    "rpa without the loop's loads": [
        ("if (p_ok) fetch();             // into tile it - 1's stage",
         "if (false) fetch();")],
    "rpa without warp_sum": [
        ("sc[u][g] = warp_sum(sc[u][g]);", "sc[u][g] = sc[u][g];")],
    "rpa without exp2f": [
        ("const float p = u < nu ? exp2f(sc[u][g] - mn) : 0.f;",
         "const float p = u < nu ? (sc[u][g] - mn) : 0.f;")],
    "rpa without the p.v FMAs": [
        ("            acc[g][i] = fmaf(sc[u][g], vx, acc[g][i]);",
         "            acc[g][i] += vx;")],
    "rpa merge launch only": [
        ("  fn<<<dim3(a.KV * n_hg, a.B, a.splits), kThreads, smem, "
         "stream>>>(a, vec);", "")],
    "rpa split launch only": [
        ("  merge<<<dim3(a.KV, a.B), kThreads, 0, stream>>>(a);", "")],
    "rpa with 64-slot ring stages": [
        ("constexpr int kSplitTile = 32;", "constexpr int kSplitTile = 64;")],
}


def _build(jobs, out_dir):
    """Start one nvcc per (name, source text); return {name: CDLL}."""
    from cake_tpu_torch.utils import cuda_build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(jobs):
        src = os.path.join(out_dir, f"v{i}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"v{i}.so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"kernel_ablation: nvcc failed on {name}:\n"
                             f"{err[-3000:]}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def _patched(path, reps):
    with open(path) as f:
        text = f.read()
    for old, new in reps:
        if old not in text:
            raise SystemExit(f"kernel_ablation: {os.path.basename(path)} "
                             f"no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: needs an NVIDIA card")
    import chip_smoke as cs
    import cake_tpu_torch.ops.flash_attention as fa
    import cake_tpu_torch.ops.ragged_paged_attention as rpa
    from cake_tpu_torch.utils.cuda_build import BUILD_DIR

    jobs = [(n, _patched(fa.SOURCE, r)) for n, r in FLASH_VARIANTS.items()]
    jobs += [(n, _patched(rpa.SOURCE, r)) for n, r in RPA_VARIANTS.items()]
    t0 = time.perf_counter()
    libs = _build(jobs, os.path.join(BUILD_DIR, "ablation"))
    print(f"kernel_ablation: {len(libs)} variants built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(4321)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
               for shape in ((1, 1024, 32, 128), (1, 1024, 8, 128),
                             (1, 1024, 8, 128)))
    case = cs._kernel_case(torch, torch.bfloat16,
                           torch.Generator(device="cuda").manual_seed(1234),
                           False, None)
    rq, pk, pv, table, pos = case[:5]
    default_slots = rpa.SPLIT_SLOTS
    for name, lib in libs.items():
        if name.startswith("flash"):
            fa._bind(lib)
            fa.LIBRARY._lib = lib
            ms, _ = cs._stream_ms(torch, [lambda: fa.flash_attention(q, k, v)])
            print(f"kernel_ablation: {name}: {ms * 1e3:.1f} us", flush=True)
            continue
        rpa._bind(lib)
        rpa.LIBRARY._lib = lib
        for slots in (default_slots, 2 * default_slots):
            rpa.SPLIT_SLOTS = slots
            ms, _ = cs._stream_ms(torch, [
                lambda: rpa.ragged_paged_attention(rq, pk, pv, table, pos)])
            print(f"kernel_ablation: {name}, splits of {slots} slots: "
                  f"{ms * 1e3:.1f} us", flush=True)
        rpa.SPLIT_SLOTS = default_slots
    return 0


if __name__ == "__main__":
    sys.exit(main())
