// Flash attention for Hopper (sm_90a): a fresh prompt window, and a window
// continuing a KV cache.
//
// Replaces the TPU kernels in cake_tpu/ops/flash_attention.py:
//   flash_attn         <- _flash_kernel         (via flash_attention)
//   flash_attn_cached  <- _flash_kernel_cached  (via flash_attention_cached)
// Both compute grouped-query attention of q [B, S, H, hd] against k/v
// [B, T, KV, hd] (query head h reads kv head h / G, G = H / KV) with an f32
// online softmax, and write [B, S, H, hd] in q's dtype:
//   flash_attn         query i sits at position i. Causal: it attends keys
//                      j <= i, and j > i - window with a window. Non-causal:
//                      every key.
//   flash_attn_cached  query i sits at absolute position pos + i and attends
//                      cache slots j <= pos + i (and j > pos + i - window).
//                      Slots at or past the write frontier pos + S may hold
//                      stale or non-finite values and are never read.
//
// What bounds it on this card: operations. Each attended (query head, key)
// pair costs 4 * hd flops (two dots); a causal window of S = 1024 at H = 32,
// hd = 128 does ~8.6 GFLOP against ~21 MB of q, k, v and o, some 400 flops
// per byte, above the ~295 where the H100's bf16 tensor cores, not memory,
// are the limit.
//
// Two device bodies share the rules below:
//   * one CTA per (batch row, kv head, tile of query positions). Its rows
//     are the tile's positions times the G query heads of the kv head, so
//     each K/V tile is staged in shared memory once for the whole group
//     (GQA without a repeated K/V);
//   * the CTA walks only the keys some row of it attends: from the lowest
//     in-window key of its first position to the causal limit of its last.
//     The tiles the TPU kernel skips with pl.when (and whose DMAs the cached
//     kernel elides by clamping its index map) are never fetched here, and
//     no slot at or past the frontier is read;
//   * a row's masked keys get p = 0 exactly, and every staged key lies below
//     the frontier (or is a zero pad), so no p of 0 meets a non-finite
//     value; a query row with no attended key (l == 0) writes zeros;
//   * tiles run longest first (the causal tail tiles start while the SMs
//     are empty).
//
// flash_tc -- flash_attn over bf16/f16 (the prefill path), FlashAttention-2
// shaped, on the tensor cores:
//   * four warps, 16 query rows each (64 rows a CTA: 16 positions at
//     G = 4, 2 at G = 32); key tiles of 64;
//   * q, K and V reach shared memory by cp.async in 16-byte pieces (8 or 4
//     when a row's bytes or a pointer are not 16-aligned), K/V through a
//     ring of two stages, so the next tile's copies are in flight while the
//     current one computes; rows are 272 bytes apart, so the eight 16-byte
//     rows an ldmatrix phase reads fall in distinct banks; the head dim is
//     a compile-time 64 or 128, a smaller one zero-padded in shared memory
//     (zero q/k columns leave the scores as they are; padded v columns are
//     never written out), so the fragment loops unroll with no guard;
//   * q is loaded once into registers as mma A fragments; S = q k^T and
//     O += p v run on mma.sync.m16n8k16 (bf16/f16 in, f32 accumulate), v
//     read with ldmatrix.trans; a k-block's fragments are all loaded before
//     its products, which are plain (not volatile) asm the compiler may
//     interleave; the online softmax runs on the accumulator
//     fragments (row max by quad shuffles, rescale by exp(m_old - m_new));
//     p is rounded to the value dtype in registers to feed p v, as the
//     Pallas kernel's p.astype(v.dtype), while l sums the f32 p;
//   * the mask is evaluated only on edge tiles (the diagonal, the window
//     floor, the ragged end); interior tiles skip it.
// Left for later: wgmma/TMA, a persistent schedule, and flash_attn_cached on
// this body.
//
// flash_cta -- f32 q/k/v (tensor cores would need TF32, which breaks the
// 1e-4 f32 parity) and flash_attn_cached for every dtype: scalar f32 FMAs.
// A warp owns 8 rows and a lane one key of a 32-key tile for the scores;
// a thread owns one head dim for p @ v; tiles converted to f32 on load.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;                 // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                     // keys staged per step (= lanes)
constexpr int kRows = 32;                     // query rows (position x head)
constexpr int kRowsPerWarp = kRows / kWarps;  // 8
constexpr int kMaxHd = kThreads;              // one head dim per thread in p@v
// ops/flash_attention.py gates on the same limits: MAX_GROUP = kRows query
// heads per kv head, MAX_HEAD_DIM = kMaxHd
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* q;    // [B, S, H, hd]
  const void* k;    // [B, T, KV, hd]
  const void* v;    // [B, T, KV, hd]
  void* out;        // [B, S, H, hd]
  int B, S, T, H, KV, hd;
  int q_cols;       // query positions per CTA
  int qbase;        // absolute position of query 0 (pos; 0 when fresh)
  int causal;       // 0 = every key
  int window;       // 0 = no window
  float scale;
};

// Shared memory of one CTA, in bytes (all f32): K tile [kTile][hd + 4]
// (padded so lane t's 16-byte reads fall in distinct banks), V tile
// [kTile][hd], q rows [kRows][hd], probabilities [kRows][kTile], and the
// per-row rescale and final sums [kRows] each. At hd = 128 that is 54 016
// bytes for every dtype (tiles are converted to f32 on load), well inside
// the 227 KB a block may use.
size_t smem_bytes(int hd) {
  return sizeof(float) * (size_t)(kTile * (hd + 4) + kTile * hd +
                                  kRows * hd + kRows * kTile + 2 * kRows);
}

template <typename T>
__device__ void flash_cta(const Args& a, int tile, int kv, int b) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int G = a.H / a.KV;
  const int hd = a.hd;
  const int ldk = hd + 4;
  float* k_s = smem;                  // [kTile][hd + 4]
  float* v_s = k_s + kTile * ldk;     // [kTile][hd]
  float* q_s = v_s + kTile * hd;      // [kRows][hd]
  float* p_s = q_s + kRows * hd;      // [kRows][kTile]
  float* a_s = p_s + kRows * kTile;   // [kRows] rescale of this tile
  float* l_s = a_s + kRows;           // [kRows] final softmax sums

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);

  const int c0 = tile * a.q_cols;
  const int cols = min(a.q_cols, a.S - c0);
  const int rows = cols * G;
  // keys [lo, hi) cover every key some row of this CTA attends
  const int first = a.qbase + c0;              // position of the first row
  const int last = a.qbase + c0 + cols - 1;    // position of the last row
  const int hi = a.causal ? min(a.T, last + 1) : a.T;
  const int lo = a.window > 0 ? max(0, first - a.window + 1) : 0;

  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    float x = 0.f;
    if (r < rows) {
      const int c = c0 + r / G, h = kv * G + r % G;
      x = to_f(q[(((size_t)b * a.S + c) * a.H + h) * hd + d]);
    }
    q_s[i] = x;
  }
  for (int i = tid; i < kRows * kTile; i += kThreads) p_s[i] = 0.f;
  if (tid < kRows) a_s[tid] = 0.f;

  // warp `warp` owns rows r0 .. r0 + 7; every lane holds their m and l
  const int r0 = warp * kRowsPerWarp;
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
  }
  float acc[kRows];   // thread tid owns head dim tid of every row
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  const size_t tok_stride = (size_t)a.KV * hd;
  const size_t src0 = (size_t)b * a.T * tok_stride + (size_t)kv * hd;
  for (int k0 = lo; k0 < hi; k0 += kTile) {
    const int nt = min(kTile, hi - k0);
    __syncthreads();   // the previous tile's p @ v is done with k_s, v_s
    // stage keys [k0, k0 + nt) of this kv head; pad rows are zeros
    for (int i = tid; i < kTile * hd; i += kThreads) {
      const int t = i / hd, d = i - t * hd;
      float kx = 0.f, vx = 0.f;
      if (t < nt) {
        const size_t s = src0 + (size_t)(k0 + t) * tok_stride + d;
        kx = to_f(kp[s]);
        vx = to_f(vp[s]);
      }
      k_s[t * ldk + d] = kx;
      v_s[t * hd + d] = vx;
    }
    __syncthreads();

    if (r0 < rows) {
      // scores of the warp's 8 rows against key k0 + lane
      float s[kRowsPerWarp];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) s[j] = 0.f;
      const float4* kr = reinterpret_cast<const float4*>(k_s + lane * ldk);
      for (int d4 = 0; d4 < hd / 4; ++d4) {
        const float4 kx = kr[d4];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const float4 qx =
              reinterpret_cast<const float4*>(q_s + (r0 + j) * hd)[d4];
          s[j] = fmaf(qx.x, kx.x, s[j]);
          s[j] = fmaf(qx.y, kx.y, s[j]);
          s[j] = fmaf(qx.z, kx.z, s[j]);
          s[j] = fmaf(qx.w, kx.w, s[j]);
        }
      }
      // online softmax, row by row, across the warp
      const int key = k0 + lane;
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int r = r0 + j;
        const int qpos = a.qbase + c0 + r / G;
        const bool valid = r < rows && lane < nt &&
                           (!a.causal || key <= qpos) &&
                           (a.window <= 0 || key > qpos - a.window);
        const float sv = valid ? s[j] * a.scale : kNegInf;
        const float m_new = fmaxf(m[j], warp_max(sv));
        const float p = valid ? expf(sv - m_new) : 0.f;
        const float alpha = expf(m[j] - m_new);
        l[j] = alpha * l[j] + warp_sum(p);
        m[j] = m_new;
        p_s[r * kTile + lane] = p;
        if (lane == 0) a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc[r] = acc[r] * alpha[r] + sum over the tile's keys of p[r][t] v[t]
    if (tid < hd) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] *= a_s[r];
      const float* vc = v_s + tid;
      for (int t = 0; t < nt; t += 4) {   // pad keys have p = 0, v = 0
        const float v0 = vc[t * hd], v1 = vc[(t + 1) * hd];
        const float v2 = vc[(t + 2) * hd], v3 = vc[(t + 3) * hd];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 p = reinterpret_cast<const float4*>(p_s + r * kTile)[t / 4];
          float x = acc[r];
          x = fmaf(p.x, v0, x);
          x = fmaf(p.y, v1, x);
          x = fmaf(p.z, v2, x);
          x = fmaf(p.w, v3, x);
          acc[r] = x;
        }
      }
    }
  }

  if (r0 < rows && lane == 0) {
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
      if (r0 + j < rows) l_s[r0 + j] = l[j];
  }
  __syncthreads();
  // normalise; a row that attended nothing writes 0
  if (tid < hd) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const int c = c0 + r / G, h = kv * G + r % G;
        const float lr = l_s[r];
        const float o = lr > 0.f ? acc[r] / lr : 0.f;
        out[(((size_t)b * a.S + c) * a.H + h) * hd + tid] = from_f<T>(o);
      }
    }
  }
}

// -- flash_tc: the tensor-core body (bf16 / f16) ------------------------------

constexpr int kTcRows = 64;               // query rows per CTA, 16 per warp
constexpr int kTcKeys = 64;               // keys per tile
constexpr int kTcLd = 128 + 8;            // row stride in elements: 272 B
constexpr int kTcStages = 2;              // K/V ring depth

// q tile, then per stage a K tile and a V tile, [64][kTcLd] 2-byte
// elements each: 87 040 bytes (two CTAs an SM).
constexpr size_t kTcSmem =
    2 * (size_t)kTcLd * (kTcRows + 2 * kTcStages * kTcKeys);

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

// Stage n_rows rows of hd elements into dst (row stride kTcLd) by cp.async
// in `vec`-byte pieces; rows >= n_valid are zero-filled. row(r) is the
// global address of row r (called only for valid rows).
template <typename T, typename RowFn>
__device__ __forceinline__ void stage_rows(T* dst, int n_rows, int n_valid,
                                           int hd, int vec, RowFn row) {
  const int pieces = hd * (int)sizeof(T) / vec;
  if (kThreads % pieces == 0) {   // a fixed piece per thread, rows strided
    const int c = threadIdx.x % pieces, step = kThreads / pieces;
    for (int r = threadIdx.x / pieces; r < n_rows; r += step) {
      const bool ok = r < n_valid;
      cp_async(reinterpret_cast<char*>(dst + r * kTcLd) + c * vec,
               reinterpret_cast<const char*>(row(ok ? r : 0)) + c * vec,
               vec, ok);
    }
    return;
  }
  for (int i = threadIdx.x; i < n_rows * pieces; i += kThreads) {
    const int r = i / pieces, c = i - r * pieces;
    const bool ok = r < n_valid;
    const char* src =
        reinterpret_cast<const char*>(row(ok ? r : 0)) + c * vec;
    cp_async(reinterpret_cast<char*>(dst + r * kTcLd) + c * vec, src, vec,
             ok);
  }
}

// kHd: the head dim padded to 64 or 128 (compile-time, so the fragment
// loops unroll without guards; zero columns cost work, not accuracy).
template <typename T, int kHd>
__device__ void flash_tc(const Args& a, int tile, int kv, int b, int vec) {
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);            // [64][kTcLd]
  T* ring = q_s + kTcRows * kTcLd;                 // stage s: K, then V
  const int G = a.H / a.KV;
  const int hd = a.hd;
  constexpr int hdp = kHd;                         // zero-padded
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);

  const int c0 = tile * a.q_cols;
  const int cols = min(a.q_cols, a.S - c0);
  const int rows = cols * G;
  const int first = a.qbase + c0;
  const int last = a.qbase + c0 + cols - 1;
  const int hi = a.causal ? min(a.T, last + 1) : a.T;
  const int lo = a.window > 0 ? max(0, first - a.window + 1) : 0;
  const int n_tiles = (hi - lo + kTcKeys - 1) / kTcKeys;

  // the pad columns [hd, hdp) of every tile are zero and stay so (the
  // copies below write only columns < hd)
  if (hdp > hd) {
    const int w = hdp - hd;
    for (int i = tid; i < (kTcRows + 2 * kTcStages * kTcKeys) * w;
         i += kThreads)
      q_s[(i / w) * kTcLd + hd + i % w] = from_f<T>(0.f);
  }
  stage_rows(q_s, kTcRows, rows, hd, vec, [&](int r) {
    return q + (((size_t)b * a.S + c0 + r / G) * a.H + kv * G + r % G) * hd;
  });
  const size_t tok = (size_t)a.KV * hd;
  const T* k0 = kp + (size_t)b * a.T * tok + (size_t)kv * hd;
  const T* v0 = vp + (size_t)b * a.T * tok + (size_t)kv * hd;
  auto load_tile = [&](int it) {
    T* ks = ring + (it % kTcStages) * 2 * kTcKeys * kTcLd;
    const int t0 = lo + it * kTcKeys;
    const int nt = min(kTcKeys, hi - t0);
    stage_rows(ks, kTcKeys, nt, hd, vec,
               [&](int r) { return k0 + (size_t)(t0 + r) * tok; });
    stage_rows(ks + kTcKeys * kTcLd, kTcKeys, nt, hd, vec,
               [&](int r) { return v0 + (size_t)(t0 + r) * tok; });
  };
  load_tile(0);
  cp_commit();                  // group 0: q and tile 0
  if (n_tiles > 1) load_tile(1);
  cp_commit();                  // group 1: tile 1 (or nothing)

  // this thread's two rows: r0 = 16 warp + lane / 4 and r0 + 8
  const int r0 = warp * 16 + (lane >> 2);
  const int pos0 = a.qbase + c0 + r0 / G;
  const int pos1 = a.qbase + c0 + (r0 + 8) / G;
  const float sl2 = a.scale * 1.4426950408889634f;   // scores in log2 units
  uint32_t qf[kHd / 16][4];
  float o[kHd / 8][4];
#pragma unroll
  for (int n = 0; n < kHd / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait_1();                // every group but the newest has landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk)
        ldsm_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * kTcLd + kk * 16 +
                            (lane >> 4) * 8);
    }
    const T* ks = ring + (it % kTcStages) * 2 * kTcKeys * kTcLd;
    const T* vs = ks + kTcKeys * kTcLd;
    const int t0 = lo + it * kTcKeys;

    // S = q k^T: eight n-tiles of 8 keys
    float s[kTcKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kTcKeys / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    // (each k-block's K fragments are loaded before its products, so the
    // shared-memory latency overlaps the tensor-core work)
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
      uint32_t bk[kTcKeys / 16][4];
#pragma unroll
      for (int np = 0; np < kTcKeys / 16; ++np)
        ldsm_x4(bk[np], ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                 kTcLd + kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < kTcKeys / 16; ++np) {
        mma16816<T>(s[2 * np], qf[kk], bk[np][0], bk[np][1]);
        mma16816<T>(s[2 * np + 1], qf[kk], bk[np][2], bk[np][3]);
      }
    }

    // mask only the edge tiles: an interior tile's keys are attended by
    // every row of the CTA
    const bool interior =
        t0 + kTcKeys <= hi && (!a.causal || t0 + kTcKeys - 1 <= first) &&
        (a.window <= 0 || t0 > last - a.window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kTcKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = t0 + n * 8 + 2 * (lane & 3) + (e & 1);
        const int qp = e < 2 ? pos0 : pos1;
        const bool ok = interior ||
                        (key < hi && (!a.causal || key <= qp) &&
                         (a.window <= 0 || key > qp - a.window));
        const float x = ok ? s[n][e] * sl2 : kNegInf;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < kTcKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float p = x == kNegInf ? 0.f : exp2f(x - (e < 2 ? mn0 : mn1));
        s[n][e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    }
    l0 = l0 * al0 + ps0;        // this thread's columns; quads sum at the end
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < kHd / 8; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // O += p v: p from the score fragments, rounded to T; v by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack2<T>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<T>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      uint32_t bv[kHd / 16][4];
#pragma unroll
      for (int np = 0; np < kHd / 16; ++np)
        ldsm_x4_t(bv[np], vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   kTcLd + np * 16 + ((lane >> 4) & 1) * 8);
#pragma unroll
      for (int np = 0; np < kHd / 16; ++np) {
        mma16816<T>(o[2 * np], pa, bv[np][0], bv[np][1]);
        mma16816<T>(o[2 * np + 1], pa, bv[np][2], bv[np][3]);
      }
    }
    __syncthreads();            // every warp is done with this stage
    if (it + kTcStages < n_tiles) load_tile(it + kTcStages);
    cp_commit();
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // normalise; a row that attended nothing writes 0
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    if (r >= rows) continue;
    const float l = half ? l1 : l0;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = out + (((size_t)b * a.S + c0 + r / G) * a.H + kv * G + r % G) * hd;
#pragma unroll
    for (int n = 0; n < kHd / 8; ++n) {
      const int d = n * 8 + 2 * (lane & 3);
      if (d < hd)
        *reinterpret_cast<uint32_t*>(orow + d) =
            pack2<T>(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
    }
  }
}

// Tiles run last-first: under a causal mask the late tiles hold the most
// keys, so they start while the SMs are empty.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(Args a) {
  flash_cta<T>(a, gridDim.x - 1 - blockIdx.x, blockIdx.y, blockIdx.z);
}

template <typename T, int kHd>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attn_tc_kernel(Args a, int vec) {
  flash_tc<T, kHd>(a, gridDim.x - 1 - blockIdx.x, blockIdx.y, blockIdx.z,
                   vec);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attn_cached_kernel(Args a) {
  flash_cta<T>(a, gridDim.x - 1 - blockIdx.x, blockIdx.y, blockIdx.z);
}

typedef void (*KernelFn)(Args);
typedef void (*TcKernelFn)(Args, int);

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16
template <typename T>
KernelFn pick_dtype(bool cached) {
  if (cached) return flash_attn_cached_kernel<T>;
  return flash_attn_kernel<T>;
}

KernelFn pick(bool cached, int dtype) {
  switch (dtype) {
    case 0: return pick_dtype<float>(cached);
    case 1: return pick_dtype<__nv_bfloat16>(cached);
    case 2: return pick_dtype<__half>(cached);
  }
  return nullptr;
}

bool shape_ok(int S, int T, int H, int KV, int hd) {
  return S >= 1 && T >= S && KV > 0 && H % KV == 0 && H / KV <= kRows &&
         hd >= 4 && hd <= kMaxHd && hd % 4 == 0;
}

// Raise a kernel's dynamic shared memory limit (once per kernel).
template <typename Fn>
int allow_smem(Fn fn, size_t smem, bool& done) {
  if (done || smem <= 48 * 1024) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  done = e == cudaSuccess;
  return (int)e;
}

// The widest cp.async piece (16, 8 or 4 bytes) that divides a row of hd
// 2-byte elements and the alignment of q, k and v; 0 if none does.
int copy_bytes(const Args& a) {
  const uintptr_t any = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                        (uintptr_t)(a.hd * 2);
  for (int v = 16; v >= 4; v >>= 1)
    if (any % v == 0) return v;
  return 0;
}

int launch(bool cached, Args a, int dtype, cudaStream_t stream) {
  if (!shape_ok(a.S, a.T, a.H, a.KV, a.hd)) return (int)cudaErrorInvalidValue;
  KernelFn fn = pick(cached, dtype);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  const int G = a.H / a.KV;
  const int vec = copy_bytes(a);
  if (!cached && dtype != 0 && vec != 0) {
    static bool done[4] = {false, false, false, false};
    const bool wide = a.hd > 64;
    TcKernelFn tc =
        dtype == 1 ? (wide ? flash_attn_tc_kernel<__nv_bfloat16, 128>
                           : flash_attn_tc_kernel<__nv_bfloat16, 64>)
                   : (wide ? flash_attn_tc_kernel<__half, 128>
                           : flash_attn_tc_kernel<__half, 64>);
    const int e = allow_smem(tc, kTcSmem, done[2 * (dtype - 1) + wide]);
    if (e != 0) return e;
    a.q_cols = kTcRows / G;
    const int tiles = (a.S + a.q_cols - 1) / a.q_cols;
    tc<<<dim3(tiles, a.KV, a.B), kThreads, kTcSmem, stream>>>(a, vec);
    return (int)cudaGetLastError();
  }
  a.q_cols = kRows / G;
  const size_t smem = smem_bytes(a.hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (a.S + a.q_cols - 1) / a.q_cols;
  fn<<<dim3(tiles, a.KV, a.B), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Fresh window: q/out [B, S, H, hd], k/v [B, T, KV, hd]; window 0 = none
// (a window needs causal). Returns cudaGetLastError() of the launch.
int flash_attn(const void* q, const void* k, const void* v, void* out, int B,
               int S, int T, int H, int KV, int hd, int causal, int window,
               float scale, int dtype, void* stream) {
  if (window > 0 && !causal) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, B, S, T, H, KV, hd, 0, 0, causal, window, scale};
  return launch(false, a, dtype, static_cast<cudaStream_t>(stream));
}

// Window at absolute position pos against a cache k/v [B, T, KV, hd]
// whose slots < pos + S are written (0 <= pos <= T - S).
int flash_attn_cached(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int T, int H, int KV, int hd, int pos,
                      int window, float scale, int dtype, void* stream) {
  if (pos < 0 || pos > T - S) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, B, S, T, H, KV, hd, 0, pos, 1, window, scale};
  return launch(true, a, dtype, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
