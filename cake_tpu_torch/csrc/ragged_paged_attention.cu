// Ragged paged attention for Hopper (sm_90a): decode and mixed steps.
//
// Replaces the TPU kernels in cake_tpu/ops/ragged_paged_attention.py:
//   rpa_decode  <- _rpa_kernel        (via ragged_paged_attention)
//   rpa_mixed   <- _rpa_mixed_kernel  (via ragged_paged_attention_mixed)
// Both compute, per row b of a continuous batch, attention of the row's
// queries against its KV history, read page by page from a shared pool
// [N, P, KV, hd] through table[b, :] (-1 = unmapped page), with an f32
// online softmax. Query column i of row b sits at absolute position
// pos[b] + i and attends slots <= pos[b] + i. Decode rows carry one
// query; mixed rows carry q_len[b] of C columns (0 = idle row).
//
// What bounds it on this card: the bytes of the live K/V pages. A row
// at position p reads 2 * (p + 1) * KV * hd elements once; the dots
// do 4 * hd flops per (query head, slot) — about G / 2 flops per byte
// for a bf16 pool (G = H / KV query heads per kv head), far below the
// ~295 flops/byte where the H100's tensor cores would bound it. So the
// floor is live K/V bytes / 3.35 TB/s.
//
// What the design does about it:
//   * one CTA per (row, kv head[, query tile]) reads its own pos and
//     table row and walks only the LIVE pages j < ceil((last + 1) / P),
//     where last is the position of its last real query; unmapped ids
//     are skipped outright, never clamped to page 0;
//   * within a page only slots up to `last` are fetched, 32 tokens at a
//     time, into shared memory (K rows padded by one float so the score
//     loop is free of bank conflicts), converted to f32 on load;
//   * the G query heads of the kv head (times the tile's query columns)
//     are scored against each staged tile, so a page is fetched once
//     per kv head for all of its query heads (GQA without repeat);
//   * masked slots are skipped, never multiplied by 0: a stale slot may
//     hold NaN, and 0 * NaN is NaN;
//   * a query with no attended slot (dead row, all pages unmapped,
//     q_len = 0, padding column) writes zeros.
// Scalar f32 FMAs, no TMA, no tensor cores: a first kernel that is
// right. At B = 8 the decode grid is B * KV = 64 CTAs on 132 SMs;
// splitting the page loop across CTAs is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 32;      // page slots staged per step (= warp size)
constexpr int kRows = 16;      // query rows (column x head) per CTA
constexpr int kMaxHd = 256;    // each thread owns head dims tid, tid+128
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
  const void* q;       // [B, C, H, hd]
  const void* k;       // [N, P, KV, hd]
  const void* v;       // [N, P, KV, hd]
  const int* table;    // [B, max_pages]
  const int* pos;      // [B]
  const int* qlen;     // [B], nullptr for decode (one query per row)
  void* out;           // [B, C, H, hd]
  int B, C, H, KV, hd, P, N, max_pages;
  int q_cols;          // query columns per CTA
  float scale;
};

size_t smem_bytes(int hd) {
  return sizeof(float) * (size_t)(kTile * (hd + 1) + kTile * hd +
                                  kRows * hd + kRows * kTile + 3 * kRows);
}

// One CTA: kv head `kv` of row `b`, query columns [c0, c0 + q_cols).
// Row r of the CTA is query column c0 + r / G, query head kv * G + r % G.
template <typename TQ, typename TKV>
__device__ void rpa_cta(const Args& a, int b, int kv, int c0) {
  extern __shared__ float smem[];
  const int G = a.H / a.KV;
  const int hd = a.hd;
  const int ldk = hd + 1;
  float* k_s = smem;                  // [kTile][hd + 1]
  float* v_s = k_s + kTile * ldk;     // [kTile][hd]
  float* q_s = v_s + kTile * hd;      // [kRows][hd]
  float* p_s = q_s + kRows * hd;      // [kRows][kTile] scores, then probs
  float* m_s = p_s + kRows * kTile;   // [kRows] running max
  float* l_s = m_s + kRows;           // [kRows] running sum
  float* a_s = l_s + kRows;           // [kRows] rescale of this tile

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* kp = static_cast<const TKV*>(a.k);
  const TKV* vp = static_cast<const TKV*>(a.v);
  TQ* out = static_cast<TQ*>(a.out);

  const int pos = a.pos[b];
  const int qlen = a.qlen ? a.qlen[b] : 1;
  const int cols = min(a.q_cols, a.C - c0);
  const int real = max(0, min(cols, qlen - c0));  // real query columns
  const int rows = real * G;
  // the tile's last real query position bounds every slot it may read
  const int last = pos + c0 + real - 1;
  int n_pages = 0;
  if (rows > 0 && last >= 0) n_pages = min(a.max_pages, last / a.P + 1);

  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int c = c0 + r / G, h = kv * G + r % G;
    q_s[i] = to_f(q[(((size_t)b * a.C + c) * a.H + h) * hd + d]);
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
  __syncthreads();

  const size_t tok_stride = (size_t)a.KV * hd;
  for (int j = 0; j < n_pages; ++j) {
    const int page = a.table[(size_t)b * a.max_pages + j];
    if (page < 0 || page >= a.N) continue;  // unmapped: nothing to read
    for (int t0 = 0; t0 < a.P; t0 += kTile) {
      const int base = j * a.P + t0;        // absolute slot of row 0
      if (base > last) break;
      const int nt = min(min(kTile, a.P - t0), last - base + 1);
      // stage K/V slots [t0, t0 + nt) of this page for kv head `kv`
      const size_t src0 =
          ((size_t)page * a.P + t0) * tok_stride + (size_t)kv * hd;
      for (int i = tid; i < nt * hd; i += kThreads) {
        const int t = i / hd, d = i - t * hd;
        const size_t s = src0 + (size_t)t * tok_stride + d;
        k_s[t * ldk + d] = to_f(kp[s]);
        v_s[t * hd + d] = to_f(vp[s]);
      }
      __syncthreads();
      // scores: one (row, slot) per thread per pass, masked slots skipped
      for (int i = tid; i < rows * kTile; i += kThreads) {
        const int r = i / kTile, t = i - r * kTile;
        const int qi = c0 + r / G;
        float s = kNegInf;
        if (t < nt && base + t <= pos + qi) {
          const float* qr = q_s + r * hd;
          const float* kr = k_s + t * ldk;
          float dot = 0.f;
          for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
          s = dot * a.scale;
        }
        p_s[i] = s;
      }
      __syncthreads();
      // online softmax: one warp per row, lane = slot
      for (int r = warp; r < rows; r += kThreads / 32) {
        const int qi = c0 + r / G;
        const bool valid = lane < nt && base + lane <= pos + qi;
        const float s = p_s[r * kTile + lane];
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, warp_max(valid ? s : kNegInf));
        const float p = valid ? expf(s - m_new) : 0.f;
        const float l_new = expf(m_old - m_new) * l_s[r] + warp_sum(p);
        p_s[r * kTile + lane] = p;
        __syncwarp();
        if (lane == 0) {
          a_s[r] = expf(m_old - m_new);
          m_s[r] = m_new;
          l_s[r] = l_new;
        }
      }
      __syncthreads();
      // acc[r][d] = acc * alpha + sum over the row's attended slots of
      // p * v; the loop stops at the last attended slot
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const int qi = c0 + r / G;
          const int nv = max(0, min(nt, pos + qi - base + 1));
          const float alpha = a_s[r];
          const float* pr = p_s + r * kTile;
#pragma unroll
          for (int dd = 0; dd < 2; ++dd) {
            const int d = tid + dd * kThreads;
            if (d < hd) {
              float x = acc[r][dd] * alpha;
              for (int t = 0; t < nv; ++t) x = fmaf(pr[t], v_s[t * hd + d], x);
              acc[r][dd] = x;
            }
          }
        }
      }
      __syncthreads();
    }
  }

  // normalise; rows with no attended slot and padding columns write 0
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < cols * G) {
      const int c = c0 + r / G, h = kv * G + r % G;
      const float l = r < rows ? l_s[r] : 0.f;
#pragma unroll
      for (int dd = 0; dd < 2; ++dd) {
        const int d = tid + dd * kThreads;
        if (d < hd) {
          const float o = l > 0.f ? acc[r][dd] / l : 0.f;
          out[(((size_t)b * a.C + c) * a.H + h) * hd + d] = from_f<TQ>(o);
        }
      }
    }
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) rpa_decode_kernel(Args a) {
  rpa_cta<TQ, TKV>(a, blockIdx.y, blockIdx.x, 0);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) rpa_mixed_kernel(Args a) {
  rpa_cta<TQ, TKV>(a, blockIdx.y, blockIdx.x, blockIdx.z * a.q_cols);
}

typedef void (*KernelFn)(Args);

// dtype codes: 0 = float32, 1 = bfloat16
KernelFn pick(bool mixed, int q_dtype, int kv_dtype) {
  const int key = q_dtype * 2 + kv_dtype;
  if (mixed) {
    switch (key) {
      case 0: return rpa_mixed_kernel<float, float>;
      case 1: return rpa_mixed_kernel<float, __nv_bfloat16>;
      case 2: return rpa_mixed_kernel<__nv_bfloat16, float>;
      case 3: return rpa_mixed_kernel<__nv_bfloat16, __nv_bfloat16>;
    }
  } else {
    switch (key) {
      case 0: return rpa_decode_kernel<float, float>;
      case 1: return rpa_decode_kernel<float, __nv_bfloat16>;
      case 2: return rpa_decode_kernel<__nv_bfloat16, float>;
      case 3: return rpa_decode_kernel<__nv_bfloat16, __nv_bfloat16>;
    }
  }
  return nullptr;
}

int launch(bool mixed, const Args& a, int q_dtype, int kv_dtype,
           dim3 grid, cudaStream_t stream) {
  KernelFn fn = pick(mixed, q_dtype, kv_dtype);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool shape_ok(int H, int KV, int hd) {
  return KV > 0 && H % KV == 0 && H / KV <= kRows && hd > 0 &&
         hd <= kMaxHd;
}

}  // namespace

extern "C" {

// Shape limits the wrapper checks before launching.
int rpa_max_group() { return kRows; }
int rpa_max_head_dim() { return kMaxHd; }

// Decode: q/out [B, 1, H, hd]. Returns cudaGetLastError() of the launch.
int rpa_decode(const void* q, const void* k, const void* v,
               const int* table, const int* pos, void* out, int B, int H,
               int KV, int hd, int P, int N, int max_pages, float scale,
               int q_dtype, int kv_dtype, void* stream) {
  if (!shape_ok(H, KV, hd)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a{q, k, v, table, pos, nullptr, out,
         B, 1, H, KV, hd, P, N, max_pages, 1, scale};
  return launch(false, a, q_dtype, kv_dtype, dim3(KV, B, 1),
                static_cast<cudaStream_t>(stream));
}

// Mixed: q/out [B, C, H, hd], q_len [B]. Returns cudaGetLastError().
int rpa_mixed(const void* q, const void* k, const void* v,
              const int* table, const int* pos, const int* q_len,
              void* out, int B, int C, int H, int KV, int hd, int P, int N,
              int max_pages, float scale, int q_dtype, int kv_dtype,
              void* stream) {
  if (!shape_ok(H, KV, hd)) return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return 0;
  const int q_cols = kRows / (H / KV);
  Args a{q, k, v, table, pos, q_len, out,
         B, C, H, KV, hd, P, N, max_pages, q_cols, scale};
  const int tiles = (C + q_cols - 1) / q_cols;
  return launch(true, a, q_dtype, kv_dtype, dim3(KV, B, tiles),
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
