// Tensor-core attention pieces shared by flash_tc (flash_attention.cu) and
// rpa_mixed_tc (ragged_paged_attention.cu), for Hopper (sm_90a); the
// int4 matmul's tensor-core body (int4_matmul.cu) uses the cp.async,
// ldmatrix and mma.sync wrappers.
//
// A CTA holds up to 16 * warps query rows, 16 a warp, and walks keys in
// tiles of kKeys = 64 staged in shared memory by cp.async through a ring
// of kStages = 2 stages (the next tile's copies are in flight while the
// current one computes). Rows are kLd elements (272 bytes) apart, so the
// eight 16-byte rows an ldmatrix phase reads fall in distinct banks. The
// head dim is a compile-time 64 or 128 (kHd); a smaller one is
// zero-padded in shared memory (zero q/k columns leave the scores as they
// are; padded v columns are never written out), so the fragment loops
// unroll with no guard.
//
// tile_step is one tile of FlashAttention-2's online softmax for a warp's
// 16 rows: S = q k^T and O += p v on mma.sync.m16n8k16 (bf16/f16 in, f32
// accumulate), v read with ldmatrix.trans; a k-block's fragments are all
// loaded before its products, which are plain (not volatile) asm the
// compiler may interleave; the softmax runs on the accumulator fragments
// (row max by quad shuffles, rescale by exp2(m_old - m_new), scores in
// log2 units). p is rounded to the value dtype in registers to feed p v,
// as the Pallas kernels' p.astype(v.dtype), while l sums the f32 p. A
// masked key gets p = 0 exactly; every staged key row is finite or a
// zero pad, so no p meets a non-finite value. Over quantized pages
// (rpa_mixed_tc over int8/int4) the K/V tiles hold the pages' exact
// integers and KeyScales carries each key's scales: S is multiplied by
// the key's k scale before the row max, and p by its v scale before it
// is rounded for p v (l still sums the unscaled f32 p). NoScales, the
// default, compiles to the unscaled step.
//
// Split partials: a CTA that covers only part of a row's keys writes its
// f32 (m, l) and unnormalised acc; merge_split_stats folds the splits in
// split order (the same bits every run, no atomics). Layout over `rows`
// query rows and `splits` splits: (m, l) at part[(s * rows + r) * 2],
// acc at part[splits * rows * 2 + (s * rows + r) * hd]; m in log2 units.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace tc {

constexpr int kKeys = 64;                 // keys per tile
constexpr int kLd = 128 + 8;              // row stride in elements: 272 B
constexpr int kStages = 2;                // K/V ring depth
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a CTA of `rows` query rows: the q tile, then per stage
// a K tile and a V tile, [.][kLd] 2-byte elements each.
constexpr size_t smem_bytes(int rows) {
  return 2 * (size_t)kLd * (rows + 2 * kStages * kKeys);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy `bytes` (16, 8 or 4) from global to shared memory asynchronously;
// with ok false the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes, bool ok) {
  const int n = ok ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(n));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b on one m16n8k16 tile, f32 accumulate.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to T and packed, the lower column in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// Zero the pad columns [hd, kHd) of n_rows staged rows (the copies write
// only columns < hd, so they stay zero).
template <typename T, int kHd>
__device__ __forceinline__ void zero_pad_columns(T* base, int n_rows, int hd,
                                                 int nthreads) {
  if (kHd > hd) {
    const int w = kHd - hd;
    for (int i = threadIdx.x; i < n_rows * w; i += nthreads)
      base[(i / w) * kLd + hd + i % w] = T(0.f);
  }
}

// Stage n_rows rows of hd elements into dst (row stride kLd) by cp.async
// in `vec`-byte pieces. row(r) is row r's global address, or nullptr for
// a row to zero-fill (then `fallback`, any valid address, stands in and
// nothing is read).
template <typename T, typename RowFn>
__device__ __forceinline__ void stage_rows(T* dst, int n_rows, int hd,
                                           int vec, int nthreads,
                                           const T* fallback, RowFn row) {
  const int pieces = hd * (int)sizeof(T) / vec;
  auto one = [&](int r, int c) {
    const T* src = row(r);
    cp_async(reinterpret_cast<char*>(dst + r * kLd) + c * vec,
             reinterpret_cast<const char*>(src ? src : fallback) + c * vec,
             vec, src != nullptr);
  };
  if (nthreads % pieces == 0) {   // a fixed piece per thread, rows strided
    const int c = threadIdx.x % pieces, step = nthreads / pieces;
    for (int r = threadIdx.x / pieces; r < n_rows; r += step) one(r, c);
    return;
  }
  for (int i = threadIdx.x; i < n_rows * pieces; i += nthreads)
    one(i / pieces, i % pieces);
}

// Stage kKeys key rows of K into ks and of V into vs (rows kDst elements
// apart): off(r) is key row r's element offset into k and v (the same in
// both), or -1 for a row to zero-fill. A thread keeps one piece of the row
// across its rows when the pieces divide the threads, so each row's offset
// is found once a thread.
template <typename T, int kDst = kLd, typename OffFn>
__device__ __forceinline__ void stage_kv(T* ks, T* vs, const T* k,
                                         const T* v, int hd, int vec,
                                         int nthreads, OffFn off) {
  const int pieces = hd * (int)sizeof(T) / vec;
  auto one = [&](int r, int c, long long o) {
    const bool ok = o >= 0;
    const size_t at = ok ? (size_t)o : 0;
    const int dst = r * kDst * (int)sizeof(T) + c * vec;
    cp_async(reinterpret_cast<char*>(ks) + dst,
             reinterpret_cast<const char*>(k + at) + c * vec, vec, ok);
    cp_async(reinterpret_cast<char*>(vs) + dst,
             reinterpret_cast<const char*>(v + at) + c * vec, vec, ok);
  };
  if (nthreads % pieces == 0) {   // a fixed piece per thread, rows strided
    const int c = threadIdx.x % pieces, step = nthreads / pieces;
    for (int r = threadIdx.x / pieces; r < kKeys; r += step) one(r, c, off(r));
    return;
  }
  for (int i = threadIdx.x; i < kKeys * pieces; i += nthreads) {
    const int r = i / pieces;
    one(r, i - r * pieces, off(r));
  }
}

// One warp's running softmax state over its 16 rows: this thread holds
// rows r0 = 16 warp + lane / 4 (half 0) and r0 + 8 (half 1), and head
// dims n * 8 + 2 (lane % 4) + {0, 1} of o[n].
template <int kHd>
struct State {
  float o[kHd / 8][4];
  float m0, m1, l0, l1;
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < kHd / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m0 = m1 = kNegInf;
    l0 = l1 = 0.f;
  }
  // quad-sum l (each thread summed its own columns)
  __device__ __forceinline__ void finish() {
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  }
};

// The warp's q rows as mma A fragments, from the staged q tile.
template <typename T, int kHd>
__device__ __forceinline__ void load_q(uint32_t (&qf)[kHd / 16][4],
                                       const T* q_s, int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk)
    ldsm_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * kLd + kk * 16 +
                        (lane >> 4) * 8);
}

// Per-key scales of a tile (see above). NoScales: pages in the compute
// dtype, nothing to scale.
struct NoScales {
  static constexpr bool kOn = false;
};
// KeyScales: sk[j] = key j's k scale times the softmax scale in log2
// units (it replaces sl2), sv[j] its v scale; kKeys each, in shared memory.
struct KeyScales {
  static constexpr bool kOn = true;
  const float* sk;
  const float* sv;
  __device__ __forceinline__ float2 k(int j) const {
    return *reinterpret_cast<const float2*>(sk + j);
  }
  __device__ __forceinline__ float2 v(int j) const {
    return *reinterpret_cast<const float2*>(sv + j);
  }
};

// One key tile of the online softmax. ok(j, half) says whether key j of
// the tile (0..63) is attended by this thread's row of that half; it is
// not asked on an interior tile, every key of which every row attends.
// sl2: the softmax scale times log2 e. sc: the keys' scales (KeyScales
// over quantized pages).
template <typename T, int kHd, typename Ok, typename Sc = NoScales>
__device__ __forceinline__ void tile_step(const uint32_t (&qf)[kHd / 16][4],
                                          const T* ks, const T* vs,
                                          State<kHd>& st, float sl2,
                                          bool interior, int lane, Ok ok,
                                          Sc sc = Sc()) {
  // S = q k^T: eight n-tiles of 8 keys
  float s[kKeys / 8][4];
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) {
    uint32_t bk[kKeys / 16][4];
#pragma unroll
    for (int np = 0; np < kKeys / 16; ++np)
      ldsm_x4(bk[np], ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                          kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int np = 0; np < kKeys / 16; ++np) {
      mma16816<T>(s[2 * np], qf[kk], bk[np][0], bk[np][1]);
      mma16816<T>(s[2 * np + 1], qf[kk], bk[np][2], bk[np][3]);
    }
  }

  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
    // the score scale of this thread's two keys of the n-tile
    float f0 = sl2, f1 = sl2;
    if constexpr (Sc::kOn) {
      const float2 f = sc.k(n * 8 + 2 * (lane & 3));
      f0 = f.x;
      f1 = f.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = n * 8 + 2 * (lane & 3) + (e & 1);
      const bool keep = interior || ok(j, e >> 1);
      const float x = keep ? s[n][e] * (e & 1 ? f1 : f0) : kNegInf;
      s[n][e] = x;
      if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(st.m0, mx0), mn1 = fmaxf(st.m1, mx1);
  const float al0 = exp2f(st.m0 - mn0), al1 = exp2f(st.m1 - mn1);
  st.m0 = mn0;
  st.m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[n][e];
      const float p = x == kNegInf ? 0.f : exp2f(x - (e < 2 ? mn0 : mn1));
      s[n][e] = p;
      if (e < 2) ps0 += p; else ps1 += p;
    }
  }
  st.l0 = st.l0 * al0 + ps0;    // this thread's columns; quads sum at the end
  st.l1 = st.l1 * al1 + ps1;
#pragma unroll
  for (int n = 0; n < kHd / 8; ++n) {
    st.o[n][0] *= al0;
    st.o[n][1] *= al0;
    st.o[n][2] *= al1;
    st.o[n][3] *= al1;
  }

  // O += p v: p from the score fragments (times each key's v scale over
  // quantized pages), rounded to T; v by ldmatrix.trans
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    if constexpr (Sc::kOn) {
      const float2 v0 = sc.v(kk * 16 + 2 * (lane & 3));
      const float2 v1 = sc.v(kk * 16 + 8 + 2 * (lane & 3));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[2 * kk][e] *= e & 1 ? v0.y : v0.x;
        s[2 * kk + 1][e] *= e & 1 ? v1.y : v1.x;
      }
    }
    const uint32_t pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                            pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                            pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
    uint32_t bv[kHd / 16][4];
#pragma unroll
    for (int np = 0; np < kHd / 16; ++np)
      ldsm_x4_t(bv[np], vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 kLd + np * 16 + ((lane >> 4) & 1) * 8);
#pragma unroll
    for (int np = 0; np < kHd / 16; ++np) {
      mma16816<T>(st.o[2 * np], pa, bv[np][0], bv[np][1]);
      mma16816<T>(st.o[2 * np + 1], pa, bv[np][2], bv[np][3]);
    }
  }
}

// Write one of this thread's rows (half 0 or 1) normalised into orow, in
// T; a row that attended nothing (l == 0), or with zero true, writes 0.
template <typename T, int kHd>
__device__ __forceinline__ void store_row(const State<kHd>& st, int half,
                                          T* orow, int hd, int lane,
                                          bool zero) {
  const float l = half ? st.l1 : st.l0;
  const float inv = zero || !(l > 0.f) ? 0.f : 1.f / l;
#pragma unroll
  for (int n = 0; n < kHd / 8; ++n) {
    const int d = n * 8 + 2 * (lane & 3);
    if (d < hd)
      *reinterpret_cast<uint32_t*>(orow + d) =
          pack2<T>(st.o[n][2 * half] * inv, st.o[n][2 * half + 1] * inv);
  }
}

// Write one of this thread's rows as a split partial: (m, l) at ml (by
// the quad's first lane) and the unnormalised acc at acc.
template <int kHd>
__device__ __forceinline__ void store_partial(const State<kHd>& st, int half,
                                              float* ml, float* acc, int hd,
                                              int lane) {
  if ((lane & 3) == 0) {
    ml[0] = half ? st.m1 : st.m0;
    ml[1] = half ? st.l1 : st.l0;
  }
#pragma unroll
  for (int n = 0; n < kHd / 8; ++n) {
    const int d = n * 8 + 2 * (lane & 3);
    if (d < hd)
      *reinterpret_cast<float2*>(acc + d) =
          make_float2(st.o[n][2 * half], st.o[n][2 * half + 1]);
  }
}

// Head dims d and d + 1 (d even) of query row r from the first n_live of
// `splits` partials (layout above), folded in split order and normalised;
// a split with l == 0 attended nothing and is skipped; a total l of 0
// gives 0.
__device__ __forceinline__ float2 merge_split_stats(const float* part,
                                                    int splits, size_t rows,
                                                    size_t r, int hd, int d,
                                                    int n_live) {
  const float* ml = part + r * 2;
  const float* acc = part + (size_t)splits * rows * 2 + r * hd + d;
  float M = kNegInf;
  for (int s = 0; s < n_live; ++s)
    if (ml[s * rows * 2 + 1] > 0.f) M = fmaxf(M, ml[s * rows * 2]);
  float L = 0.f, A0 = 0.f, A1 = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const float l = ml[s * rows * 2 + 1];
    if (l > 0.f) {
      const float e = exp2f(ml[s * rows * 2] - M);
      const float2 x = *reinterpret_cast<const float2*>(acc + s * rows * hd);
      L += e * l;
      A0 += e * x.x;
      A1 += e * x.y;
    }
  }
  return L > 0.f ? make_float2(A0 / L, A1 / L) : make_float2(0.f, 0.f);
}

// A merge kernel's thread: query row `row` (of `rows`) and head dims d,
// d + 1, with hd / 2 threads a row and 256 / (hd / 2) rows a block of 256
// (32-bit index math: the 64-bit divisions of a thread per element cost
// more than the loads). Returns false for a thread past the rows.
__device__ __forceinline__ bool merge_thread(int rows, int hd, int& row,
                                             int& d) {
  const int per_row = hd / 2;
  const int rr = (int)threadIdx.x / per_row;
  row = (int)blockIdx.x * (256 / per_row) + rr;
  d = 2 * ((int)threadIdx.x - rr * per_row);
  return rr < 256 / per_row && row < rows;
}

// Blocks of 256 threads a merge over `rows` query rows launches.
inline unsigned merge_blocks(size_t rows, int hd) {
  const size_t per_block = 256 / (hd / 2);
  return (unsigned)((rows + per_block - 1) / per_block);
}

}  // namespace tc
