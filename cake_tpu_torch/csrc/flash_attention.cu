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
// What the design does about it (right first; tensor cores come later):
//   * one CTA per (batch row, kv head, tile of query positions). Its rows
//     are the tile's positions times the G query heads of the kv head, so
//     each K/V tile is staged in shared memory once for the whole group
//     (GQA without a repeated K/V);
//   * the CTA walks only the keys some row of it attends: from the lowest
//     in-window key of its first position to the causal limit of its last.
//     The tiles the TPU kernel skips with pl.when (and whose DMAs the cached
//     kernel elides by clamping its index map) are never fetched here, and
//     no slot at or past the frontier is read;
//   * scores: a warp owns 8 rows and a lane one key of the 32-key tile, so
//     each K element loaded feeds 8 FMAs and the online softmax reduces
//     across the warp in registers. p @ v: a thread owns one head dim and
//     walks the tile's keys once for all 32 rows. Shared-memory operands
//     are read 16 bytes at a time;
//   * a row's masked keys get p = 0 exactly, and every staged key lies below
//     the frontier (or is a zero pad), so no p of 0 meets a non-finite
//     value;
//   * a query row with no attended key (l == 0) writes zeros.
// Scalar f32 FMAs, no TMA, no tensor cores: mma/wgmma tiles, TMA loads and a
// persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Tiles run last-first: under a causal mask the late tiles hold the most
// keys, so they start while the SMs are empty.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(Args a) {
  flash_cta<T>(a, gridDim.x - 1 - blockIdx.x, blockIdx.y, blockIdx.z);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attn_cached_kernel(Args a) {
  flash_cta<T>(a, gridDim.x - 1 - blockIdx.x, blockIdx.y, blockIdx.z);
}

typedef void (*KernelFn)(Args);

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

int launch(bool cached, Args a, int dtype, cudaStream_t stream) {
  if (!shape_ok(a.S, a.T, a.H, a.KV, a.hd)) return (int)cudaErrorInvalidValue;
  KernelFn fn = pick(cached, dtype);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  a.q_cols = kRows / (a.H / a.KV);
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
