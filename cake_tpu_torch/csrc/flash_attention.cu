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
//                      cache slots j <= pos + i (and j > pos + i - window);
//                      pos is a device int32 the kernel reads (copied to
//                      a fixed address first), as the TPU kernel reads its
//                      scalar-prefetched pos_ref.
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
// flash_tc -- both kernels over bf16/f16, FlashAttention-2 shaped, on the
// tensor cores (the tile loop, fragments and staging are tc_attention.cuh's,
// shared with the ragged mixed kernel):
//   * 16 query rows a warp; flash_attn runs four warps (64 rows a CTA: 16
//     positions at G = 4, 2 at G = 32, two CTAs an SM), flash_attn_cached
//     the warps the wrapper asks for (8 by default: 128 rows, one CTA an
//     SM, so each K/V tile fetched from L2 serves twice the rows); key
//     tiles of 64 through a two-stage cp.async ring; q loaded once into
//     registers as mma A fragments;
//   * the mask is evaluated only on edge tiles (the diagonal, the window
//     floor, the ragged end); interior tiles skip it. Rows sit at absolute
//     positions qbase + c0 + r / G, so the cached kernel's query offset, a
//     window floor off the 64-key grid and the frontier (hi never passes
//     qbase + S) need nothing more;
//   * key splits (flash_attn_cached): the wrapper plans the split count
//     from shapes and the SM count alone (ops/flash_attention.py
//     flash_split_plan); split s of a (query tile, kv head) walks tiles
//     [s n / splits, (s + 1) n / splits) of its n key tiles and writes f32
//     partials, and flash_merge folds them in split order.
// Left for later: wgmma/TMA and a persistent schedule.
//
// flash_cta -- f32 q/k/v (tensor cores would need TF32, which breaks the
// 1e-4 f32 parity): scalar f32 FMAs. A warp owns 8 rows and a lane one key
// of a 32-key tile for the scores; a thread owns one head dim for p @ v;
// tiles converted to f32 on load.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_attention.cuh"

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
  int cached;       // 1: query 0 sits at g_pos (flash_attn_cached), 0: at 0
  int causal;       // 0 = every key
  int window;       // 0 = no window
  float scale;
  int splits;       // flash_tc: key splits per (query tile, kv head)
  float* part;      // flash_tc with splits > 1: f32 partials (tc_attention.cuh)
};

// flash_attn_cached's pos: the caller's device int32, copied here before
// each launch (a device-to-device copy in stream order, which a capture
// records with the launch, so a replayed launch reads the pos its buffer
// holds then), as the TPU kernel reads its scalar-prefetched pos_ref.
// Read from this fixed address it costs 0-2 us a launch, as from the
// constant bank; read through a pointer in Args it made both bodies 1.6x
// slower (the kernel table's shapes, H100; kernel_ablation.py's "flash
// pos" variants).
__device__ int g_pos;

// The window's absolute position: g_pos for the cached kernel, 0 for a
// fresh window. A pos outside [0, T - S] traps: it is never clamped.
__device__ __forceinline__ int query_base(const Args& a) {
  if (!a.cached) return 0;
  const int p = g_pos;
  if (p < 0 || p > a.T - a.S) __trap();
  return p;
}

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
  const int qbase = query_base(a);
  const int cols = min(a.q_cols, a.S - c0);
  const int rows = cols * G;
  // keys [lo, hi) cover every key some row of this CTA attends
  const int first = qbase + c0;              // position of the first row
  const int last = qbase + c0 + cols - 1;    // position of the last row
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
        const int qpos = qbase + c0 + r / G;
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

// kHd: the head dim padded to 64 or 128 (compile-time, so the fragment
// loops unroll without guards; zero columns cost work, not accuracy).
// kW: warps, 16 query rows each. `split` of a.splits: the CTA walks only
// its share of the key tiles [lo, hi) and, with a.part set, writes f32
// partials for flash_merge instead of the output.
template <typename T, int kHd, int kW>
__device__ void flash_tc(const Args& a, int tile, int kv, int b, int split,
                         int vec) {
  constexpr int kThr = 32 * kW;
  constexpr int kRowsTc = 16 * kW;
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);            // [kRowsTc][kLd]
  T* ring = q_s + kRowsTc * tc::kLd;               // stage s: K, then V
  const int G = a.H / a.KV;
  const int hd = a.hd;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);

  const int c0 = tile * a.q_cols;
  const int qbase = query_base(a);
  const int cols = min(a.q_cols, a.S - c0);
  const int rows = cols * G;
  const int first = qbase + c0;
  const int last = qbase + c0 + cols - 1;
  // keys [lo, hi) cover every key some row of this CTA attends; a cached
  // window's hi stays below the frontier qbase + S
  const int hi = a.causal ? min(a.T, last + 1) : a.T;
  const int lo = a.window > 0 ? max(0, first - a.window + 1) : 0;
  const int n_all = (hi - lo + tc::kKeys - 1) / tc::kKeys;
  // this split's tiles [it0, it0 + n_tiles): n_all shared out evenly
  const int splits = max(1, a.splits);
  const int it0 = (int)((long long)split * n_all / splits);
  const int n_tiles = (int)((long long)(split + 1) * n_all / splits) - it0;

  // this thread's two rows: r0 = 16 warp + lane / 4 and r0 + 8
  const int r0 = warp * 16 + (lane >> 2);
  const size_t prow = (size_t)a.B * a.S * a.H;     // partial rows
  auto qrow = [&](int r) {                         // [B, S, H] row index
    return ((size_t)b * a.S + c0 + r / G) * a.H + kv * G + r % G;
  };
  tc::State<kHd> st;
  st.init();
  if (n_tiles <= 0) {           // an empty split: l = 0, skipped by the merge
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + half * 8;
      if (r < rows)
        tc::store_partial<kHd>(st, half,
                               a.part + ((size_t)split * prow + qrow(r)) * 2,
                               a.part + 2 * splits * prow +
                                   ((size_t)split * prow + qrow(r)) * hd,
                               hd, lane);
    }
    return;
  }

  tc::zero_pad_columns<T, kHd>(q_s, kRowsTc + 2 * tc::kStages * tc::kKeys,
                               hd, kThr);
  tc::stage_rows(q_s, kRowsTc, hd, vec, kThr, q, [&](int r) -> const T* {
    return r < rows ? q + qrow(r) * hd : nullptr;
  });
  const size_t tok = (size_t)a.KV * hd;
  const T* k0 = kp + (size_t)b * a.T * tok + (size_t)kv * hd;
  const T* v0 = vp + (size_t)b * a.T * tok + (size_t)kv * hd;
  auto load_tile = [&](int j) {
    T* ks = ring + (j % tc::kStages) * 2 * tc::kKeys * tc::kLd;
    const int t0 = lo + (it0 + j) * tc::kKeys;
    tc::stage_kv(ks, ks + tc::kKeys * tc::kLd, k0, v0, hd, vec, kThr,
                 [&](int r) -> long long {
                   return t0 + r < hi ? (long long)(t0 + r) * (long long)tok
                                      : -1;
                 });
  };
  load_tile(0);
  tc::cp_commit();              // group 0: q and tile 0
  if (n_tiles > 1) load_tile(1);
  tc::cp_commit();              // group 1: tile 1 (or nothing)

  const int pos0 = qbase + c0 + r0 / G;
  const int pos1 = qbase + c0 + (r0 + 8) / G;
  const float sl2 = a.scale * tc::kLog2e;         // scores in log2 units
  uint32_t qf[kHd / 16][4];

  for (int j = 0; j < n_tiles; ++j) {
    tc::cp_wait_1();            // every group but the newest has landed
    __syncthreads();
    if (j == 0) tc::load_q<T, kHd>(qf, q_s, warp, lane);
    const T* ks = ring + (j % tc::kStages) * 2 * tc::kKeys * tc::kLd;
    const int t0 = lo + (it0 + j) * tc::kKeys;
    // mask only the edge tiles: an interior tile's keys are attended by
    // every row of the CTA
    const bool interior =
        t0 + tc::kKeys <= hi && (!a.causal || t0 + tc::kKeys - 1 <= first) &&
        (a.window <= 0 || t0 > last - a.window);
    if (warp * 16 < rows)       // a warp of padding rows only idles
      tc::tile_step<T, kHd>(
          qf, ks, ks + tc::kKeys * tc::kLd, st, sl2, interior, lane,
          [&](int jj, int half) {
            const int key = t0 + jj;
            const int qp = half ? pos1 : pos0;
            return key < hi && (!a.causal || key <= qp) &&
                   (a.window <= 0 || key > qp - a.window);
          });
    __syncthreads();            // every warp is done with this stage
    if (j + tc::kStages < n_tiles) load_tile(j + tc::kStages);
    tc::cp_commit();
  }

  st.finish();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    if (r >= rows) continue;
    if (a.part == nullptr) {    // normalise; a row that attended nothing: 0
      tc::store_row<T, kHd>(st, half, out + qrow(r) * hd, hd, lane, false);
    } else {
      const size_t pr = (size_t)split * prow + qrow(r);
      tc::store_partial<kHd>(st, half, a.part + pr * 2,
                             a.part + 2 * splits * prow + pr * hd, hd, lane);
    }
  }
}

// Tiles run last-first: under a causal mask the late tiles hold the most
// keys, so they start while the SMs are empty.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(Args a) {
  flash_cta<T>(a, gridDim.x - 1 - blockIdx.x, blockIdx.y, blockIdx.z);
}

// blockIdx.x runs over (query tile, split), the last tile first.
template <typename T, int kHd, int kW>
__global__ void __launch_bounds__(32 * kW, kW == 4 ? 2 : 1)
    flash_attn_tc_kernel(Args a, int vec) {
  const int splits = max(1, a.splits);
  const int n_q = gridDim.x / splits;
  flash_tc<T, kHd, kW>(a, n_q - 1 - (int)blockIdx.x / splits, blockIdx.y,
                       blockIdx.z, (int)blockIdx.x % splits, vec);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attn_cached_kernel(Args a) {
  flash_cta<T>(a, gridDim.x - 1 - blockIdx.x, blockIdx.y, blockIdx.z);
}

// Fold a.splits partials of every [B, S, H] row in split order; a thread
// per two head dims of a row.
template <typename T>
__global__ void __launch_bounds__(256) flash_merge_kernel(Args a) {
  const int rows = a.B * a.S * a.H;
  int r, d;
  if (!tc::merge_thread(rows, a.hd, r, d)) return;
  const float2 o =
      tc::merge_split_stats(a.part, a.splits, rows, r, a.hd, d, a.splits);
  *reinterpret_cast<uint32_t*>(static_cast<T*>(a.out) + (size_t)r * a.hd +
                               d) = tc::pack2<T>(o.x, o.y);
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

template <typename T, int kW>
TcKernelFn pick_tc(bool wide) {
  return wide ? flash_attn_tc_kernel<T, 128, kW>
              : flash_attn_tc_kernel<T, 64, kW>;
}

bool shape_ok(int S, int T, int H, int KV, int hd) {
  return S >= 1 && T >= S && KV > 0 && H % KV == 0 && H / KV <= kRows &&
         hd >= 4 && hd <= kMaxHd && hd % 4 == 0;
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

// bf16/f16 with a usable copy width run flash_tc (kW warps, a.splits key
// splits, then flash_merge when a.splits > 1); f32 runs flash_cta.
int launch(bool cached, Args a, int dtype, int warps, cudaStream_t stream) {
  if (!shape_ok(a.S, a.T, a.H, a.KV, a.hd)) return (int)cudaErrorInvalidValue;
  KernelFn fn = pick(cached, dtype);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (a.splits > 1 && (a.part == nullptr || dtype == 0))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  const int G = a.H / a.KV;
  const int vec = copy_bytes(a);
  if (dtype != 0 && vec != 0) {
    if (warps != 4 && warps != 8) return (int)cudaErrorInvalidValue;
    const bool wide = a.hd > 64;
    TcKernelFn body =
        warps == 4 ? (dtype == 1 ? pick_tc<__nv_bfloat16, 4>(wide)
                                 : pick_tc<__half, 4>(wide))
                   : (dtype == 1 ? pick_tc<__nv_bfloat16, 8>(wide)
                                 : pick_tc<__half, 8>(wide));
    const size_t smem = tc::smem_bytes(16 * warps);
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)body, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    a.q_cols = 16 * warps / G;
    const int splits = max(1, a.splits);
    const int tiles = (a.S + a.q_cols - 1) / a.q_cols;
    const dim3 grid(tiles * splits, a.KV, a.B);
    body<<<grid, 32 * warps, smem, stream>>>(a, vec);
    e = cudaGetLastError();
    if (e != cudaSuccess || splits == 1) return (int)e;
    const unsigned blocks = tc::merge_blocks((size_t)a.B * a.S * a.H, a.hd);
    KernelFn merge = dtype == 1 ? flash_merge_kernel<__nv_bfloat16>
                                : flash_merge_kernel<__half>;
    merge<<<blocks, 256, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (a.splits > 1) return (int)cudaErrorInvalidValue;   // flash_cta: one
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
  return launch(false, a, dtype, 4, static_cast<cudaStream_t>(stream));
}

// Window at absolute position *pos (a device int32, copied to g_pos in
// stream order and read by the kernel; one outside [0, T - S] traps)
// against a cache k/v [B, T, KV, hd] whose slots < *pos + S are written.
// bf16/f16 run
// flash_tc with `warps` (4 or 8) warps a CTA over `splits` key splits;
// splits > 1 needs `part`, f32 scratch of splits * B * S * H * (hd + 2)
// floats, and launches flash_merge after it (bf16/f16 only). f32 runs
// flash_cta (splits 1). Returns cudaGetLastError() of the launches.
int flash_attn_cached(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int T, int H, int KV, int hd,
                      const int* pos, int window, float scale, int dtype,
                      int warps, int splits, float* part, void* stream) {
  if (pos == nullptr || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyToSymbolAsync(g_pos, pos, sizeof(int), 0,
                                          cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return (int)e;
  Args a{q, k, v, out, B, S, T, H, KV, hd, 0, 1, 1, window, scale,
         splits, part};
  return launch(true, a, dtype, warps, st);
}

}  // extern "C"
