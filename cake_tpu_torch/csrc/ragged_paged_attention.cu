// Ragged paged attention for Hopper (sm_90a): decode and mixed steps, over
// f32/bf16 pages and over int8 and nibble-packed int4 pages with scales.
//
// Replaces the TPU kernels in cake_tpu/ops/ragged_paged_attention.py:
//   rpa_decode     <- _rpa_kernel           (via ragged_paged_attention)
//   rpa_mixed      <- _rpa_mixed_kernel     (via ragged_paged_attention_mixed)
//   rpa_decode_q8  <- _rpa_kernel_q8        (int8 pages)
//   rpa_mixed_q8   <- _rpa_mixed_kernel_q8  (int8 pages)
//   rpa_decode_q4  <- _rpa_kernel_q4 + _unpack_nibbles  (int4 pages)
//   rpa_mixed_q4   <- _rpa_mixed_kernel_q4 + _unpack_nibbles
// All compute, per row b of a continuous batch, attention of the row's
// queries against its KV history, read page by page from a shared pool
// through table[b, :] (-1 = unmapped page), with an f32 online softmax.
// Query column i of row b sits at absolute position pos[b] + i and attends
// slots <= pos[b] + i. Decode rows carry one query; mixed rows carry
// q_len[b] of C columns (0 = idle row). One source, one template: the
// page element type picks how a slot is read.
//   float / bf16:  pool [N, P, KV, hd]
//   int8:          pool [N, P, KV, hd] int8, scale [N, KV] f32
//   uint8 (int4):  pool [N, P/2, KV, hd]; token t < P/2 is the low nibble
//                  of packed row t, token t + P/2 the high nibble of the
//                  same row, both biased by +8; scale [N, KV] f32
// A quantized slot is dequantized as it is staged (int value * the page's
// scale for that kv head, in f32), which is the function the TPU kernels
// compute by scaling the dot outputs instead, up to f32 rounding order.
//
// What bounds it on this card: the bytes of the live K/V pages. A row
// at position p reads 2 * (p + 1) * KV * hd elements once (4, 2, 1 or
// 0.5 bytes each) plus 8 * KV bytes of scales per live page; the dots
// do 4 * hd flops per (query head, slot) -- about G / 2 flops per byte
// for a bf16 pool (G = H / KV query heads per kv head), 2G for int4,
// still below the ~295 flops/byte where the H100's tensor cores would
// bound it. So the floor is live K/V bytes / 3.35 TB/s.
//
// What the design does about it:
//   * one CTA per (row, kv head[, query tile]) reads its own pos and
//     table row and walks only the LIVE pages j < ceil((last + 1) / P),
//     where last is the position of its last real query; unmapped ids
//     are skipped outright, never clamped to page 0, so page 0's scale
//     cannot leak into a quantized row;
//   * within a page only slots up to `last` are fetched, 32 tokens at a
//     time, into shared memory (K rows padded by one float so the score
//     loop is free of bank conflicts), converted to f32 on load; an int4
//     slot picks its nibble by its own index, so a 32-slot tile may
//     straddle the two packed halves (P/2 need not be a multiple of 32);
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

#include <type_traits>

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
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
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
  const void* k;       // [N, P, KV, hd] ([N, P/2, KV, hd] packed int4)
  const void* v;       // as k
  const float* sk;     // [N, KV] scales of k pages (int8/int4), else null
  const float* sv;     // [N, KV] scales of v pages (int8/int4), else null
  const int* table;    // [B, max_pages]
  const int* pos;      // [B]
  const int* qlen;     // [B], nullptr for decode (one query per row)
  void* out;           // [B, C, H, hd]
  int B, C, H, KV, hd, P, N, max_pages;  // P: real tokens per page
  int q_cols;          // query columns per CTA
  float scale;
};

size_t smem_bytes(int hd) {
  return sizeof(float) * (size_t)(kTile * (hd + 1) + kTile * hd +
                                  kRows * hd + kRows * kTile + 3 * kRows);
}

// Slot t of page `page`, kv head `kv`, head dim d, as f32 (not yet scaled).
template <typename TKV>
__device__ __forceinline__ float load_slot(const TKV* p, const Args& a,
                                           int page, int t, int kv, int d) {
  return to_f(p[(((size_t)page * a.P + t) * a.KV + kv) * a.hd + d]);
}
// Nibble-packed int4: token t < P/2 in the low nibble of packed row t,
// token t + P/2 in the high nibble of the same row, +8 bias.
__device__ __forceinline__ float load_slot(const uint8_t* p, const Args& a,
                                           int page, int t, int kv, int d) {
  const int half = a.P >> 1;
  const bool hi = t >= half;
  const uint8_t b =
      p[(((size_t)page * half + (hi ? t - half : t)) * a.KV + kv) * a.hd + d];
  return (float)((hi ? b >> 4 : b & 0xF) - 8);
}

// One CTA: kv head `kv` of row `b`, query columns [c0, c0 + q_cols).
// Row r of the CTA is query column c0 + r / G, query head kv * G + r % G.
template <typename TQ, typename TKV>
__device__ void rpa_cta(const Args& a, int b, int kv, int c0) {
  constexpr bool kQuant =
      std::is_same<TKV, int8_t>::value || std::is_same<TKV, uint8_t>::value;
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

  for (int j = 0; j < n_pages; ++j) {
    const int page = a.table[(size_t)b * a.max_pages + j];
    if (page < 0 || page >= a.N) continue;  // unmapped: nothing to read
    // a quantized page carries one scale per kv head for all its slots
    float sk = 1.f, sv = 1.f;
    if constexpr (kQuant) {
      sk = a.sk[(size_t)page * a.KV + kv];
      sv = a.sv[(size_t)page * a.KV + kv];
    }
    for (int t0 = 0; t0 < a.P; t0 += kTile) {
      const int base = j * a.P + t0;        // absolute slot of row 0
      if (base > last) break;
      const int nt = min(min(kTile, a.P - t0), last - base + 1);
      // stage K/V slots [t0, t0 + nt) of this page for kv head `kv`
      for (int i = tid; i < nt * hd; i += kThreads) {
        const int t = i / hd, d = i - t * hd;
        float kx = load_slot(kp, a, page, t0 + t, kv, d);
        float vx = load_slot(vp, a, page, t0 + t, kv, d);
        if constexpr (kQuant) {
          kx *= sk;
          vx *= sv;
        }
        k_s[t * ldk + d] = kx;
        v_s[t * hd + d] = vx;
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

// kv dtype codes: 0 = float32, 1 = bfloat16, 2 = int8, 3 = packed int4
template <typename TQ>
KernelFn pick_kv(bool mixed, int kv_dtype) {
  switch (kv_dtype) {
    case 0: return mixed ? &rpa_mixed_kernel<TQ, float>
                         : &rpa_decode_kernel<TQ, float>;
    case 1: return mixed ? &rpa_mixed_kernel<TQ, __nv_bfloat16>
                         : &rpa_decode_kernel<TQ, __nv_bfloat16>;
    case 2: return mixed ? &rpa_mixed_kernel<TQ, int8_t>
                         : &rpa_decode_kernel<TQ, int8_t>;
    case 3: return mixed ? &rpa_mixed_kernel<TQ, uint8_t>
                         : &rpa_decode_kernel<TQ, uint8_t>;
  }
  return nullptr;
}

// q dtype codes: 0 = float32, 1 = bfloat16
KernelFn pick(bool mixed, int q_dtype, int kv_dtype) {
  if (q_dtype == 0) return pick_kv<float>(mixed, kv_dtype);
  if (q_dtype == 1) return pick_kv<__nv_bfloat16>(mixed, kv_dtype);
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

// quantized pages need both scale arrays; packed int4 pages an even P
bool pool_ok(int kv_dtype, const float* sk, const float* sv, int P) {
  if (kv_dtype < 2) return true;
  return sk != nullptr && sv != nullptr && (kv_dtype != 3 || P % 2 == 0);
}

}  // namespace

extern "C" {

// Shape limits the wrapper checks before launching.
int rpa_max_group() { return kRows; }
int rpa_max_head_dim() { return kMaxHd; }

// Decode: q/out [B, 1, H, hd]; sk/sv null unless the pages are quantized;
// P counts real tokens per page. Returns cudaGetLastError() of the launch.
int rpa_decode(const void* q, const void* k, const void* v, const float* sk,
               const float* sv, const int* table, const int* pos, void* out,
               int B, int H, int KV, int hd, int P, int N, int max_pages,
               float scale, int q_dtype, int kv_dtype, void* stream) {
  if (!shape_ok(H, KV, hd) || !pool_ok(kv_dtype, sk, sv, P))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a{q, k, v, sk, sv, table, pos, nullptr, out,
         B, 1, H, KV, hd, P, N, max_pages, 1, scale};
  return launch(false, a, q_dtype, kv_dtype, dim3(KV, B, 1),
                static_cast<cudaStream_t>(stream));
}

// Mixed: q/out [B, C, H, hd], q_len [B]; scales and P as rpa_decode.
// Returns cudaGetLastError().
int rpa_mixed(const void* q, const void* k, const void* v, const float* sk,
              const float* sv, const int* table, const int* pos,
              const int* q_len, void* out, int B, int C, int H, int KV,
              int hd, int P, int N, int max_pages, float scale, int q_dtype,
              int kv_dtype, void* stream) {
  if (!shape_ok(H, KV, hd) || !pool_ok(kv_dtype, sk, sv, P))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return 0;
  const int q_cols = kRows / (H / KV);
  Args a{q, k, v, sk, sv, table, pos, q_len, out,
         B, C, H, KV, hd, P, N, max_pages, q_cols, scale};
  const int tiles = (C + q_cols - 1) / q_cols;
  return launch(true, a, q_dtype, kv_dtype, dim3(KV, B, tiles),
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
