// Ragged paged attention for Hopper (sm_90a): decode and mixed steps, over
// f32/bf16 and fp8 (e4m3, e5m2) pages and over int8 and nibble-packed int4
// pages with scales.
//
// Replaces the TPU kernels in cake_tpu/ops/ragged_paged_attention.py:
//   rpa_decode     <- _rpa_kernel           (via ragged_paged_attention)
//   rpa_mixed      <- _rpa_mixed_kernel     (via ragged_paged_attention_mixed)
//   rpa_decode_q8  <- _rpa_kernel_q8        (int8 pages)
//   rpa_mixed_q8   <- _rpa_mixed_kernel_q8  (int8 pages)
//   rpa_decode_q4  <- _rpa_kernel_q4 + _unpack_nibbles  (int4 pages)
//   rpa_mixed_q4   <- _rpa_mixed_kernel_q4 + _unpack_nibbles
//   rpa_decode_f8e4m3 / _f8e5m2 <- _rpa_kernel over fp8 pages
//   rpa_mixed_f8e4m3 / _f8e5m2  <- _rpa_mixed_kernel over fp8 pages
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
//   fp8 e4m3/e5m2: pool [N, P, KV, hd], no scales: every value is exact
//                  in bf16 and f32, so a slot converts on load
// What a page element is (scaled or not, nibble-packed or not, one byte
// staged raw and converted) is PageTraits' to say, never its size: an fp8
// page is one byte like an int8 one but has no scales to read.
// A quantized slot stands for int value * the page's scale for that kv
// head, in f32. rpa_split scales the dot outputs and p, as the TPU kernels
// do; rpa_mixed_tc multiplies exact-integer K/V tiles' scores by each
// key's k scale and p by its v scale; rpa_cta dequantizes each slot as it
// is staged: the same function up to rounding order (and, in rpa_mixed_tc,
// p times the v scale rounded to bf16 for p v).
//
// What bounds it on this card: the bytes of the live K/V pages. A row
// at position p reads 2 * (p + 1) * KV * hd elements once (4, 2, 1 or
// 0.5 bytes each) plus 8 * KV bytes of scales per live page; the dots
// do 4 * hd flops per (query head, slot) -- about G / 2 flops per byte
// for a bf16 pool (G = H / KV query heads per kv head), 2G for int4,
// still below the ~295 flops/byte where the H100's tensor cores would
// bound it. So the floor is live K/V bytes / 3.35 TB/s.
//
// rpa_decode over every pool (f32, bf16, int8, packed int4) -- rpa_split +
// rpa_merge, a flash-decoding design, because one CTA per (row, kv head)
// gave 64 CTAs on 132 SMs at B = 8 and the longest row's serial page walk
// set the time:
//   * the grid is (KV x head groups, B, splits); split s covers table
//     columns [s * pps, (s + 1) * pps) of its row, a head group up to four
//     of the kv head's G query heads (G = 4 for Llama-3: one group; a
//     larger G reads each page once per group). The wrapper picks pps and the
//     split count from shapes alone (B, KV, max_pages, P, the SM count),
//     never from pos or table, so the call reads nothing back to the host
//     and captures into a CUDA graph. A split past its row's live range, or
//     whose pages are all unmapped, writes m = -inf, l = 0 and exits;
//   * inside a CTA, live slot rows (hd contiguous elements of one kv head)
//     reach shared memory by cp.async in 16-byte pieces (narrower when a
//     row's bytes are not a multiple of 16, down to single bytes for an
//     odd hd over int8/int4 pages) through a ring of three stages of 32
//     rows, so two tiles' copies are in flight while one computes; only
//     rows holding slots up to pos are fetched. A tile never straddles
//     pages, so a quantized tile has one scale a kv head, read from device
//     memory for the consumer's (mapped) page only: page 0's scale never
//     leaks into a row through an unmapped id;
//   * a packed int4 row r holds tokens r and r + P/2, so a tile of up to
//     32 packed rows is staged once and consumed twice, the low nibbles as
//     tokens r0 + u and the high nibbles as tokens P/2 + r0 + u, each pass
//     with its own live count against pos (P/2 need not be a multiple of
//     32); every packed byte is read once, half a byte an element;
//   * the group's query rows live in registers, pre-scaled to log2 units;
//     warp w takes slots 8w .. 8w + 7 of each tile, its lanes split hd
//     (lane owns dims lane + 32 i), dots reduce by warp shuffles (then
//     times the page's k scale), and each warp keeps its own online
//     softmax (m, l, acc) in registers; the inner loops are branch-free
//     (selects mask the slots past the live count), so their 32
//     dot-and-shuffle chains interleave -- with per-slot branches each
//     chain's latency was exposed and a 32-slot tile cost ~9 us; at the
//     end the four warps merge in warp order through shared memory and
//     the split writes its f32 partial (m, l, acc[heads, hd]) to scratch
//     the wrapper allocated;
//   * the split's table columns (and a quantized pool's scales for its
//     mapped pages) are staged in shared memory once, so the page walk
//     never waits on a global load of the table between tiles;
//   * rpa_merge folds a query row's live splits (from pos, never past
//     them) in split order, a thread an output element, normalises, and
//     writes zeros where the total l is 0 (dead row, every page unmapped):
//     the same bits every run, no atomics;
//   * p stays f32 for p v, as in rpa_cta and the Pallas bodies; over
//     quantized pages p v multiplies p by the page's v scale in the FMA
//     only, and l sums the unscaled p (what _rpa_kernel_q8/_q4 compute by
//     scaling the dot outputs).
//
// rpa_mixed over bf16 q and bf16, int8 or packed int4 pages (hd <= 128,
// rows 4-byte aligned) -- rpa_mixed_tc (+ rpa_mixed_merge), because a
// chunk row carries C x G query rows a kv head, the shape of flash_tc's
// tensor-core tiles, and the scalar rpa_cta left one decode row at pos
// 2047 walking 16 pages alone:
//   * one CTA per (kv head x 64-row query tile, row, split): 16 columns x
//     G = 4 heads, the rows laid out as rpa_cta's; the tile loop is
//     tc_attention.cuh's (mma.sync m16n8k16, 64-slot key tiles, online
//     softmax on the fragments, p rounded to bf16 for p v as the Pallas
//     kernel rounds it, l summing the f32 p);
//   * a slot row's address comes from table[b, slot / P], looked up per
//     row, so a key tile may straddle pages of any size; unmapped pages
//     and slots past the CTA's last query are zero-filled and masked by a
//     64-bit live mask a ring stage (never clamped to page 0, never read);
//     a warp whose rows are all padding (a decode row fills 4 of 64) skips
//     its products but keeps to the copies and barriers;
//   * bf16 pages reach the tile by cp.async through a two-stage ring.
//     int8 and packed int4 pages cannot (cp.async copies bytes, and the
//     products want bf16): their raw slot rows (hd bytes; an int4 slot's
//     packed row, t mod P/2, with a per-slot high-nibble bit, so a tile may
//     straddle P/2) go through a two-stage ring of their own, and each
//     stage is converted once, by the whole CTA, into one bf16 tile: every
//     int8 value and every unbiased nibble is exact in bf16, so K and V
//     enter the tensor cores without their scales and unrounded. Each
//     key's k and v scales are staged beside its row (zero for an unmapped
//     page, whose scale is never read): S is multiplied by the key's k
//     scale before the row max, and p by its v scale before it is rounded
//     to bf16 for p v, while l sums the unscaled f32 p (the split decode
//     body's scheme on fragments; the Pallas bodies keep that p in f32). A
//     packed row holds two of a page's tokens, so each tile reads the
//     packed rows of its own slots: a page's packed bytes are read twice
//     (the second time mostly from L2), the price of tiles that may
//     straddle P/2 and pages;
//   * splits by pages: the wrapper picks (splits, pages a split) from
//     shapes and the SM count alone (mixed_split_plan), so the call reads
//     nothing back to the host and captures into a CUDA graph; a split
//     writes f32 partials of its real rows, and rpa_mixed_merge folds, per
//     column, the splits holding its slots in split order (the same bits
//     every run) and writes zeros for padding columns, idle and dead rows.
//     With one split the CTA writes the output itself.
//
// rpa_cta, which the other mixed pairs (f32 q or pages, hd > 128, rows
// that are not 4-byte multiples) still run (no decode runs it):
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
// Scalar f32 FMAs, no TMA, no tensor cores: a first kernel that is right.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_attention.cuh"

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
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f(__nv_fp8_e5m2 x) {
  return static_cast<float>(x);
}

// What a page element of type TKV is. kScaled: int8 or packed int4 values
// that stand for value * the page's scale (scale arrays present); kPacked:
// two int4 tokens a byte; kRaw: one byte, staged raw by rpa_mixed_tc and
// converted to its bf16 tile (int8, packed int4, fp8).
template <typename TKV>
struct PageTraits {
  static constexpr bool kPacked = std::is_same<TKV, uint8_t>::value;
  static constexpr bool kScaled =
      std::is_same<TKV, int8_t>::value || kPacked;
  static constexpr bool kFp8 = std::is_same<TKV, __nv_fp8_e4m3>::value ||
                               std::is_same<TKV, __nv_fp8_e5m2>::value;
  static constexpr bool kRaw = kScaled || kFp8;
};
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
  int pps;             // rpa_split: table columns per split
  int splits;          // rpa_split: splits per (row, kv head)
  float* part;         // rpa_split: [B, KV, splits, G, 2] (m, l), then
                       // [B, KV, splits, G, hd] acc
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
  constexpr bool kQuant = PageTraits<TKV>::kScaled;
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
  const int qlen = a.qlen[b];
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
__global__ void __launch_bounds__(kThreads) rpa_mixed_kernel(Args a) {
  rpa_cta<TQ, TKV>(a, blockIdx.y, blockIdx.x, blockIdx.z * a.q_cols);
}

// -- rpa_split / rpa_merge: the split decode body (every pool) ---------------

constexpr int kSplitTile = 32;                          // rows a ring stage
constexpr int kSplitStages = 3;
constexpr int kSlotsPerWarp = kSplitTile / (kThreads / 32);   // 8
constexpr int kSplitHeads = 4;     // query heads a CTA: G > 4 takes
                                   // ceil(G / 4) CTAs, each reading the pages

// Slot row t of page `page`, kv head `kv`: its hd contiguous elements (the
// indexing of load_slot, a whole row at a time; a packed int4 page has
// P/2 rows, row t holding tokens t and t + P/2).
template <typename TKV>
__device__ __forceinline__ const TKV* slot_row(const TKV* p, const Args& a,
                                               int page, int t, int kv) {
  const int rows = std::is_same<TKV, uint8_t>::value ? a.P >> 1 : a.P;
  return p + (((size_t)page * rows + t) * a.KV + kv) * a.hd;
}

// Element x of a staged slot row as f32, not yet scaled: a packed int4 byte
// gives its low (kHigh = 0) or high (kHigh = 1) nibble less the +8 bias.
template <int kHigh, typename TKV>
__device__ __forceinline__ float kv_f(TKV x) {
  if constexpr (std::is_same<TKV, uint8_t>::value)
    return (float)(((kHigh ? x >> 4 : x) & 0xF) - 8);
  else
    return to_f(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy one piece of `bytes` (16, 8 or 4 by cp.async; 2 or 1 by a plain
// load).
__device__ __forceinline__ void copy_piece(char* dst, const char* src,
                                           int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  else if (bytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  else if (bytes == 2)
    *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
  else
    *dst = *src;
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A split's shared memory: the ring (three stages of K and V tiles),
// reused after the page walk for the four warps' (m, l, acc) of the in-CTA
// merge, then at split_table_offset the split's pps table columns (int) and
// their pages' k and v scales (f32).
__host__ __device__ __forceinline__ size_t split_table_offset(int hd,
                                                              int elem_bytes) {
  const size_t ring = (size_t)kSplitStages * 2 * kSplitTile * hd * elem_bytes;
  const size_t merge =
      sizeof(float) * (kThreads / 32) * kSplitHeads * (hd + 2);
  return ((ring > merge ? ring : merge) + 15) / 16 * 16;
}
size_t split_smem_bytes(int hd, int elem_bytes, int pps) {
  return split_table_offset(hd, elem_bytes) + (size_t)pps * 12;
}

// One warp's share of a staged tile: K rows ks and V rows vs (hd elements
// each) of its kSlotsPerWarp slots, the first nu live, folded into the
// warp's online softmax (m, l, acc). sk / sv: the page's scales for the kv
// head (1 for f32/bf16 pages): the dot is scaled by sk after the shuffle
// sum, p by sv in the p v FMA only (l sums the unscaled p). The loops
// carry no branch: a slot past nu gets p = 0 and a v of 0.
template <int kHigh, typename TKV, int kD>
__device__ __forceinline__ void split_tile(
    const TKV* ks, const TKV* vs, int hd, int nu, float sk, float sv,
    const int (&dl)[kD], const float (&qr)[kSplitHeads][kD],
    float (&m)[kSplitHeads], float (&l)[kSplitHeads],
    float (&acc)[kSplitHeads][kD]) {
  float sc[kSlotsPerWarp][kSplitHeads];
#pragma unroll
  for (int u = 0; u < kSlotsPerWarp; ++u) {
    const TKV* kr = ks + u * hd;
#pragma unroll
    for (int g = 0; g < kSplitHeads; ++g) sc[u][g] = 0.f;
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      const float kx = kv_f<kHigh>(kr[dl[i]]);
#pragma unroll
      for (int g = 0; g < kSplitHeads; ++g)
        sc[u][g] = fmaf(qr[g][i], kx, sc[u][g]);
    }
  }
#pragma unroll
  for (int u = 0; u < kSlotsPerWarp; ++u)
#pragma unroll
    for (int g = 0; g < kSplitHeads; ++g)
      sc[u][g] = warp_sum(sc[u][g]) * sk;
  // online softmax over the warp's live slots of this tile
#pragma unroll
  for (int g = 0; g < kSplitHeads; ++g) {
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < kSlotsPerWarp; ++u)
      mx = fmaxf(mx, u < nu ? sc[u][g] : kNegInf);
    const float mn = fmaxf(m[g], mx);
    const float al = exp2f(m[g] - mn);
    m[g] = mn;
    float ps = 0.f;
#pragma unroll
    for (int u = 0; u < kSlotsPerWarp; ++u) {
      const float p = u < nu ? exp2f(sc[u][g] - mn) : 0.f;
      ps += p;
      sc[u][g] = p * sv;
    }
    l[g] = l[g] * al + ps;
#pragma unroll
    for (int i = 0; i < kD; ++i) acc[g][i] *= al;
  }
#pragma unroll
  for (int u = 0; u < kSlotsPerWarp; ++u) {
    const TKV* vr = vs + u * hd;
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      const float vx = u < nu ? kv_f<kHigh>(vr[dl[i]]) : 0.f;
#pragma unroll
      for (int g = 0; g < kSplitHeads; ++g)
        acc[g][i] = fmaf(sc[u][g], vx, acc[g][i]);
    }
  }
}

// One split of one (kv head, row) for one group of up to kSplitHeads of the
// kv head's G query heads: table columns [s * pps, (s + 1) * pps) of the
// live range. Writes the group's f32 partial (m, l) and acc[., hd], m in
// log2 units (scores are pre-scaled by log2 e). kD: head dims a lane owns
// (hd <= 32 kD). TKV: the page element (float, bf16, int8, or uint8 for
// packed int4, whose tiles are packed rows consumed once a nibble).
template <typename TQ, typename TKV, int kD>
__global__ void __launch_bounds__(kThreads) rpa_split_kernel(Args a, int vec) {
  constexpr bool kQuant = PageTraits<TKV>::kScaled;
  constexpr bool kPacked = PageTraits<TKV>::kPacked;
  extern __shared__ float4 smem4[];
  char* ring = reinterpret_cast<char*>(smem4);
  const int G = a.H / a.KV;
  const int n_hg = (G + kSplitHeads - 1) / kSplitHeads;
  const int kv = blockIdx.x / n_hg, g0 = (blockIdx.x % n_hg) * kSplitHeads;
  const int gn = min(kSplitHeads, G - g0);      // query heads of this CTA
  const int b = blockIdx.y, s = blockIdx.z;
  const int hd = a.hd;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row_bytes = hd * (int)sizeof(TKV);
  const int stage_bytes = 2 * kSplitTile * row_bytes;
  const int page_rows = kPacked ? a.P >> 1 : a.P;   // slot rows a page
  const TKV* kp = static_cast<const TKV*>(a.k);
  const TKV* vp = static_cast<const TKV*>(a.v);

  const int j0 = s * a.pps;
  const int nj = max(0, min(a.pps, a.max_pages - j0));   // columns a split
  int* pages_s = reinterpret_cast<int*>(
      ring + split_table_offset(hd, (int)sizeof(TKV)));  // [pps]
  float* sk_s = reinterpret_cast<float*>(pages_s + a.pps);  // [pps]
  float* sv_s = sk_s + a.pps;                               // [pps]
  // the split's table columns, loaded once beside pos (the page walk reads
  // them from shared memory); unmapped ids (-1, or >= N) become -1
  for (int t = tid; t < nj; t += kThreads) {
    const int page = a.table[(size_t)b * a.max_pages + j0 + t];
    pages_s[t] = page >= 0 && page < a.N ? page : -1;
  }
  const int pos = a.pos[b];
  const int n_live = pos < 0 ? 0 : min(a.max_pages, pos / a.P + 1);
  const int j1 = min(j0 + nj, n_live);
  const size_t cell = ((size_t)b * a.KV + kv) * a.splits + s;
  float* ml = a.part + (cell * G + g0) * 2;
  float* acc_out =
      a.part + (size_t)a.B * a.KV * a.splits * G * 2 + (cell * G + g0) * hd;
  // live tokens of table column j, and the slot rows that hold them (a
  // packed row r holds tokens r and r + P/2: min(P/2, live) rows)
  auto live = [&](int j) { return min(a.P, pos - j * a.P + 1); };
  auto live_rows = [&](int j) { return min(page_rows, pos - j * a.P + 1); };
  auto write_empty = [&]() {    // nothing live here: an empty partial
    if (tid < gn) {
      ml[2 * tid] = kNegInf;
      ml[2 * tid + 1] = 0.f;
    }
  };
  if (j0 >= j1) {               // past the row's live range (uniform)
    write_empty();
    return;
  }
  __syncthreads();

  // the split's live tiles in order: (column j, first row t0) of a mapped
  // page with t0 below the page's live row count; unmapped ids are
  // skipped before any load
  auto next = [&](int& j, int& t0, int& page) {
    for (; j < j1; ++j, t0 = 0) {
      page = pages_s[j - j0];
      if (page >= 0 && t0 < live_rows(j)) return true;
    }
    return false;
  };
  int cj = j0, ct = 0, cpage = -1;
  bool c_ok = next(cj, ct, cpage);
  if (!c_ok) {                  // every live page unmapped
    write_empty();
    return;
  }

  int pj = cj, pt = ct, ppage = cpage, fetched = 0;
  bool p_ok = true;
  auto fetch = [&]() {          // the producer's tile into the next stage
    char* st = ring + (fetched % kSplitStages) * stage_bytes;
    const int nt = min(kSplitTile, live_rows(pj) - pt);
    const int pieces = row_bytes / vec;
    for (int i = tid; i < 2 * nt * pieces; i += kThreads) {
      const int r = i / pieces, c = i - r * pieces;
      const bool is_v = r >= nt;                  // rows [0, nt) K, then V
      const int t = is_v ? r - nt : r;
      const char* src = reinterpret_cast<const char*>(
          slot_row(is_v ? vp : kp, a, ppage, pt + t, kv));
      copy_piece(st + (is_v ? kSplitTile * row_bytes : 0) + t * row_bytes +
                     c * vec,
                 src + c * vec, vec);
    }
    ++fetched;
    pt += kSplitTile;
    p_ok = next(pj, pt, ppage);
  };
  for (int i = 0; i < kSplitStages - 1; ++i) {
    if (p_ok) fetch();
    cp_commit();
  }
  // a quantized page's scales for this kv head, read while the first
  // tiles are in flight and only for mapped pages, so page 0's scale never
  // reaches a row through an unmapped id (the loop's barrier publishes
  // them)
  if (kQuant)
    for (int t = tid; t < j1 - j0; t += kThreads)
      if (pages_s[t] >= 0) {
        sk_s[t] = a.sk[(size_t)pages_s[t] * a.KV + kv];
        sv_s[t] = a.sv[(size_t)pages_s[t] * a.KV + kv];
      }

  // the group's query rows in registers, lane owning dims lane + 32 i; a
  // lane past hd reads dim hd - 1 against a zero q (and its acc is never
  // written out)
  const float sl2 = a.scale * 1.4426950408889634f;
  const TQ* q =
      static_cast<const TQ*>(a.q) + ((size_t)b * a.H + kv * G + g0) * hd;
  float qr[kSplitHeads][kD], acc[kSplitHeads][kD];
  float m[kSplitHeads], l[kSplitHeads];
  int dl[kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) dl[i] = min(lane + 32 * i, hd - 1);
#pragma unroll
  for (int g = 0; g < kSplitHeads; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kD; ++i) {
      acc[g][i] = 0.f;
      qr[g][i] = g < gn && lane + 32 * i < hd
                    ? to_f(q[min(g, gn - 1) * hd + dl[i]]) * sl2
                    : 0.f;
    }
  }

  for (int it = 0; c_ok; ++it) {
    cp_wait<kSplitStages - 2>();   // tile `it` has landed
    __syncthreads();               // and every warp is done with tile it - 1
    if (p_ok) fetch();             // into tile it - 1's stage
    cp_commit();
    float sk = 1.f, sv = 1.f;      // one scale a kv head for the tile's page
    if (kQuant) {
      sk = sk_s[cj - j0];
      sv = sv_s[cj - j0];
    }
    const int u0 = warp * kSlotsPerWarp;
    const char* st = ring + (it % kSplitStages) * stage_bytes;
    const TKV* ks = reinterpret_cast<const TKV*>(st) + u0 * hd;
    const TKV* vs =
        reinterpret_cast<const TKV*>(st + kSplitTile * row_bytes) + u0 * hd;
    const int nt = min(kSplitTile, live_rows(cj) - ct);
    const int nu = min(kSlotsPerWarp, nt - u0);   // live slots of the warp
    // a packed tile's high nibbles: tokens P/2 + ct + u0 + u
    const int nu_hi = min(nu, live(cj) - page_rows - ct - u0);
    if (nu > 0)                    // warp-uniform
      split_tile<0, TKV, kD>(ks, vs, hd, nu, sk, sv, dl, qr, m, l, acc);
    if (kPacked && nu_hi > 0)
      split_tile<1, TKV, kD>(ks, vs, hd, nu_hi, sk, sv, dl, qr, m, l, acc);
    ct += kSplitTile;
    c_ok = next(cj, ct, cpage);
  }

  // merge the four warps' stats in warp order through shared memory
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  constexpr int kW = kThreads / 32;
  float* wm = reinterpret_cast<float*>(ring);     // [4][kSplitHeads]
  float* wl = wm + kW * kSplitHeads;              // [4][kSplitHeads]
  float* wacc = wl + kW * kSplitHeads;            // [4][kSplitHeads][hd]
#pragma unroll
  for (int g = 0; g < kSplitHeads; ++g) {
    if (lane == 0) {
      wm[warp * kSplitHeads + g] = m[g];
      wl[warp * kSplitHeads + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < kD; ++i)
      if (lane + 32 * i < hd)
        wacc[(warp * kSplitHeads + g) * hd + lane + 32 * i] = acc[g][i];
  }
  __syncthreads();
  for (int i = tid; i < gn * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    float M = kNegInf;
    for (int w = 0; w < kW; ++w) M = fmaxf(M, wm[w * kSplitHeads + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < kW; ++w) {
      const float e = exp2f(wm[w * kSplitHeads + g] - M);
      L += e * wl[w * kSplitHeads + g];
      A += e * wacc[(w * kSplitHeads + g) * hd + d];
    }
    acc_out[i] = A;
    if (d == 0) {
      ml[2 * g] = M;
      ml[2 * g + 1] = L;
    }
  }
}

// Fold the splits of every [B, H] query row in split order and normalise, a
// thread per output element (B * H * hd of them). Only the splits that hold
// the row's live table columns are read (the rest wrote l = 0), and a
// split with l = 0 is skipped; a total l of 0 (dead row, every page
// unmapped) writes zeros. The same bits every run, no atomics.
template <typename TQ>
__global__ void __launch_bounds__(256) rpa_merge_kernel(Args a) {
  const int hd = a.hd;
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= a.B * a.H * hd) return;
  const int row = i / hd, d = i - row * hd;       // row = b * H + h
  const int b = row / a.H, h = row - b * a.H;
  const int G = a.H / a.KV;
  const int kv = h / G, g = h - kv * G;
  const int S = a.splits;
  const int pos = a.pos[b];
  const int n_pages = pos < 0 ? 0 : min(a.max_pages, pos / a.P + 1);
  const int n_live = min(S, (n_pages + a.pps - 1) / a.pps);
  const size_t cell = ((size_t)b * a.KV + kv) * S;
  const float* ml = a.part + (cell * G + g) * 2;  // split s at + s * G * 2
  const float* acc =
      a.part + (size_t)a.B * a.KV * S * G * 2 + (cell * G + g) * hd + d;
  float M = kNegInf;
#pragma unroll 4
  for (int s = 0; s < n_live; ++s) {
    const float2 x = *reinterpret_cast<const float2*>(ml + s * G * 2);
    if (x.y > 0.f) M = fmaxf(M, x.x);
  }
  float L = 0.f, A = 0.f;
#pragma unroll 4
  for (int s = 0; s < n_live; ++s) {
    const float2 x = *reinterpret_cast<const float2*>(ml + s * G * 2);
    if (x.y > 0.f) {            // an empty split wrote no acc
      const float e = exp2f(x.x - M);
      L += e * x.y;
      A += e * acc[(size_t)s * G * hd];
    }
  }
  static_cast<TQ*>(a.out)[i] = from_f<TQ>(L > 0.f ? A / L : 0.f);
}

// -- rpa_mixed_tc: the mixed body on the tensor cores -----------------------

constexpr int kMixRows = 64;       // query rows a CTA: 4 warps x 16
constexpr int kRawStages = 2;      // quantized pages: stages of raw slot rows

// Shared memory of rpa_mixed_tc over pages of TKV.
//   bf16: the q tile and the K/V ring (tc_attention.cuh), then a 64-bit
//   live-slot mask per ring stage.
//   int8 / packed int4 / fp8: the q tile, one bf16 K/V tile (the converted
//   stage), its keys' scales (k scale x sl2, v scale), then kRawStages
//   stages of raw slot rows (64 K rows, then 64 V rows, of kHd bytes),
//   each with its keys' k and v scales and its live and high-nibble masks.
template <int kHd>
__host__ __device__ constexpr int raw_stage_bytes() {
  return 2 * tc::kKeys * kHd + 2 * tc::kKeys * (int)sizeof(float) +
         4 * (int)sizeof(uint32_t);
}
template <int kHd, typename TKV>
constexpr size_t mixed_smem() {
  if constexpr (!PageTraits<TKV>::kRaw)
    return tc::smem_bytes(kMixRows) + tc::kStages * 2 * sizeof(uint32_t);
  else
    return 2 * (size_t)tc::kLd * (kMixRows + 2 * tc::kKeys) +
           2 * tc::kKeys * sizeof(float) +
           (size_t)kRawStages * raw_stage_bytes<kHd>();
}

// Four int8 values, or four int4 nibbles less their +8 bias (the high
// nibbles with hi), of a 32-bit word, as four exact bf16 (two bf16x2, the
// lower element in the low half): each byte goes into the low mantissa
// byte of 2^23, the bias is subtracted in f32 (exact for integers this
// small), and a small integer's f32 has zero low 16 bits, so its upper
// half is its bf16. Integer and f32 adds only: no conversion instruction.
template <typename TKV>
__device__ __forceinline__ uint2 int4x_to_bf16(uint32_t w, bool hi) {
  float bias;
  if constexpr (std::is_same<TKV, uint8_t>::value) {
    w = (hi ? w >> 4 : w) & 0x0F0F0F0Fu;
    bias = 8388616.f;            // 2^23 + 8
  } else {
    w ^= 0x80808080u;            // int8 x -> unsigned x + 128
    bias = 8388736.f;            // 2^23 + 128
  }
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(
        __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | i)) - bias);
  return make_uint2(__byte_perm(f[0], f[1], 0x7632),
                    __byte_perm(f[2], f[3], 0x7632));
}

// Four fp8 values of a 32-bit word as four bf16 (two bf16x2, the lower
// element in the low half): two cvt.f16x2 from fp8x2, then to f32 and
// bf16, each step exact (an fp8 value has at most 3 mantissa bits and
// e5m2's exponent range is f16's). NaN stays NaN, e5m2's inf stays inf.
template <typename TKV>
__device__ __forceinline__ uint2 fp8x4_to_bf16(uint32_t w) {
  constexpr __nv_fp8_interpretation_t kFmt =
      std::is_same<TKV, __nv_fp8_e4m3>::value ? __NV_E4M3 : __NV_E5M2;
  uint32_t out[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(w >> (16 * i)), kFmt));
    const float2 f = __half22float2(h);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
    out[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  return make_uint2(out[0], out[1]);
}

// Four raw one-byte page elements as four bf16: int8, int4 nibbles (hi:
// the high ones) or fp8.
template <typename TKV>
__device__ __forceinline__ uint2 raw4_to_bf16(uint32_t w, bool hi) {
  if constexpr (PageTraits<TKV>::kFp8)
    return fp8x4_to_bf16<TKV>(w);
  else
    return int4x_to_bf16<TKV>(w, hi);
}

// One CTA: kv head `kv` of row `b`, query columns [c0, c0 + q_cols) (row r
// is column c0 + r / G, query head kv * G + r % G, as in rpa_cta), the
// row's slots [s * pps * P, (s + 1) * pps * P) of split s. Slot rows reach
// shared memory through table[b, slot / P], looked up per row, so a 64-slot
// tile may straddle pages of any size; a slot of an unmapped page (or past
// the CTA's last query) is zero-filled, never read, and masked by the
// tile's live mask. Without partials (one split) the CTA writes its
// columns' output, zeros for padding columns and idle rows; with them it
// writes f32 partials of its real rows and rpa_mixed_merge writes the rest.
// TKV: bf16 pages, staged as they are through a two-stage ring; int8, or
// uint8 for packed int4 (slot t of a page is packed row t mod P/2, its high
// nibble iff t >= P/2, so a tile may straddle P/2), or fp8, whose raw rows
// go through a ring of their own and are converted a stage at a time into
// the bf16 tile the products read, exactly; over int8 and int4 each key's
// k and v scales (a zero for an unmapped page, whose scale is never read)
// are staged beside its row and applied on the fragments (tile_step's
// KeyScales); fp8 has none, and its tile goes to the products as a bf16
// page's does.
template <int kHd, typename TKV>
__global__ void __launch_bounds__(kThreads, 2)
    rpa_mixed_tc_kernel(Args a, int vec) {
  using T = __nv_bfloat16;
  constexpr bool kQuant = PageTraits<TKV>::kRaw;      // staged raw
  constexpr bool kScaled = PageTraits<TKV>::kScaled;
  constexpr bool kPacked = PageTraits<TKV>::kPacked;
  extern __shared__ float4 smem4[];
  T* q_s = reinterpret_cast<T*>(smem4);                // [64][kLd]
  // bf16: the ring, stage s: K, then V; quantized: the converted K, V tile
  T* ring = q_s + kMixRows * tc::kLd;
  const int G = a.H / a.KV;
  const int hd = a.hd;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_q = (a.C + a.q_cols - 1) / a.q_cols;
  const int kv = blockIdx.x / n_q, c0 = (blockIdx.x % n_q) * a.q_cols;
  const int b = blockIdx.y, s = blockIdx.z;
  const T* q = static_cast<const T*>(a.q);
  const TKV* kp = static_cast<const TKV*>(a.k);
  const TKV* vp = static_cast<const TKV*>(a.v);
  T* out = static_cast<T*>(a.out);

  const int pos = a.pos[b];
  const int cols = min(a.q_cols, a.C - c0);
  const int real = max(0, min(cols, a.qlen[b] - c0));  // real query columns
  const int rows = real * G;
  const int first = pos + c0;                // position of the first column
  const int last = pos + c0 + real - 1;      // and of the last real one
  const int span = a.pps * a.P;              // slots a split
  const int k_lo = s * span;
  const int k_hi = min(min(last + 1, k_lo + span), a.max_pages * a.P);
  const bool split = a.part != nullptr;
  auto orow = [&](int r) {                   // [B, C, H] row index
    return ((size_t)b * a.C + c0 + r / G) * a.H + kv * G + r % G;
  };
  if (rows == 0 || k_lo >= k_hi) {
    // nothing to attend: without partials the tile's columns are zeros; a
    // split writes nothing (the merge reads only splits holding a column's
    // slots)
    if (!split)
      for (int i = tid; i < cols * G * hd; i += kThreads)
        out[orow(i / hd) * hd + i % hd] = __float2bfloat16(0.f);
    return;
  }
  const int n_tiles = (k_hi - k_lo + tc::kKeys - 1) / tc::kKeys;

  tc::zero_pad_columns<T, kHd>(
      q_s, kMixRows + 2 * (kQuant ? 1 : tc::kStages) * tc::kKeys, hd,
      kThreads);
  tc::stage_rows(q_s, kMixRows, hd, vec, kThreads, q,
                 [&](int r) -> const T* {
                   return r < rows ? q + orow(r) * hd : nullptr;
                 });
  const int* trow = a.table + (size_t)b * a.max_pages;

  // this thread's two rows: r0 = 16 warp + lane / 4 and r0 + 8; a warp
  // past the real rows (a decode row fills 4 of 64) skips its products but
  // takes part in the copies and barriers
  const int r0 = warp * 16 + (lane >> 2);
  const int pos0 = first + r0 / G, pos1 = first + (r0 + 8) / G;
  const float sl2 = a.scale * tc::kLog2e;
  const bool active = warp * 16 < rows;
  uint32_t qf[kHd / 16][4];
  tc::State<kHd> st;
  st.init();

  if constexpr (!kQuant) {
    uint32_t* live_s = reinterpret_cast<uint32_t*>(
        ring + tc::kStages * 2 * tc::kKeys * tc::kLd);   // [kStages][2]
    // slot `key` of the row -> element offset of its K/V row in the pools,
    // or -1 (past the split's live slots, or an unmapped page)
    auto slot = [&](int key) -> long long {
      if (key >= k_hi) return -1;
      const int j = key / a.P;
      const int page = trow[j];
      if (page < 0 || page >= a.N) return -1;
      return (((long long)page * a.P + (key - j * a.P)) * a.KV + kv) * hd;
    };
    auto load_tile = [&](int j) {
      const int sg = j % tc::kStages;
      T* ks = ring + sg * 2 * tc::kKeys * tc::kLd;
      const int t0 = k_lo + j * tc::kKeys;
      tc::stage_kv(ks, ks + tc::kKeys * tc::kLd, kp, vp, hd, vec, kThreads,
                   [&](int r) { return slot(t0 + r); });
      if (warp < 2) {             // which of the tile's 64 slots are live
        const unsigned m = __ballot_sync(0xffffffffu, slot(t0 + tid) >= 0);
        if (lane == 0) live_s[sg * 2 + warp] = m;
      }
    };
    load_tile(0);
    tc::cp_commit();              // group 0: q and tile 0
    if (n_tiles > 1) load_tile(1);
    tc::cp_commit();              // group 1: tile 1 (or nothing)

    for (int j = 0; j < n_tiles; ++j) {
      tc::cp_wait_1();            // every group but the newest has landed
      __syncthreads();
      const int sg = j % tc::kStages;
      const T* ks = ring + sg * 2 * tc::kKeys * tc::kLd;
      const int t0 = k_lo + j * tc::kKeys;
      const unsigned long long live =
          live_s[sg * 2] | ((unsigned long long)live_s[sg * 2 + 1] << 32);
      if (active) {
        if (j == 0) tc::load_q<T, kHd>(qf, q_s, warp, lane);
        // interior: every slot live and at or before every row's position
        const bool interior = live == ~0ull && t0 + tc::kKeys - 1 <= first;
        tc::tile_step<T, kHd>(
            qf, ks, ks + tc::kKeys * tc::kLd, st, sl2, interior, lane,
            [&](int jj, int half) {
              return ((live >> jj) & 1ull) && t0 + jj <= (half ? pos1 : pos0);
            });
      }
      __syncthreads();            // every warp is done with this stage
      if (j + tc::kStages < n_tiles) load_tile(j + tc::kStages);
      tc::cp_commit();
    }
  } else {
    constexpr int kRaw = 2 * tc::kKeys * kHd;         // a stage's K, V rows
    constexpr int kStage = raw_stage_bytes<kHd>();
    float* sk_t = reinterpret_cast<float*>(ring + 2 * tc::kKeys * tc::kLd);
    float* sv_t = sk_t + tc::kKeys;                   // the tile's scales
    char* raw = reinterpret_cast<char*>(sv_t + tc::kKeys);
    const int prow = a.P >> 1;                        // packed rows a page
    // row r of tile j: byte offset of its slot's K/V row in the pools, or
    // -1 (past the split's live slots, or an unmapped page); page: its
    // page, hi: whether its token is a packed row's high nibble
    auto slot = [&](int j, int r, int& page, bool& hi) -> long long {
      hi = false;
      const int key = k_lo + j * tc::kKeys + r;
      if (key >= k_hi) return -1;
      const int jp = key / a.P;
      page = trow[jp];
      if (page < 0 || page >= a.N) return -1;
      int t = key - jp * a.P;
      if (kPacked) {
        hi = t >= prow;
        t -= hi ? prow : 0;
      }
      return (((long long)page * (kPacked ? prow : a.P) + t) * a.KV + kv) *
             hd;
    };
    auto load_tile = [&](int j) {
      char* stg = raw + (j % kRawStages) * kStage;
      float* sc = reinterpret_cast<float*>(stg + kRaw);    // sk[64], sv[64]
      uint32_t* masks = reinterpret_cast<uint32_t*>(sc + 2 * tc::kKeys);
      tc::stage_kv<TKV, kHd>(reinterpret_cast<TKV*>(stg),
                             reinterpret_cast<TKV*>(stg + tc::kKeys * kHd),
                             kp, vp, hd, vec, kThreads, [&](int r) {
                               int page;
                               bool hi;
                               return slot(j, r, page, hi);
                             });
      if (warp < 2) {             // the 64 slots' scales, live and hi masks
        int page = 0;
        bool hi;
        const bool ok = slot(j, tid, page, hi) >= 0;
        if constexpr (kScaled) {  // fp8 pages have no scales
          const size_t at = ok ? (size_t)page * a.KV + kv : 0;
          tc::cp_async(sc + tid, a.sk + at, 4, ok);  // unmapped: 0, unread
          tc::cp_async(sc + tc::kKeys + tid, a.sv + at, 4, ok);
        }
        const unsigned m = __ballot_sync(0xffffffffu, ok);
        const unsigned h = __ballot_sync(0xffffffffu, hi);
        if (lane == 0) {
          masks[warp] = m;
          masks[2 + warp] = h;
        }
      }
    };
    // stage `stg`'s raw rows into the bf16 tile (K rows, then V) and its
    // scales (k's times sl2). At hd = kHd a thread converts 8-byte chunks,
    // a compile-time count of them in one unrolled block (so their shared
    // loads overlap: a loop of dependent load-convert-store steps waits
    // on each load), storing 16 bytes (a row's consecutive chunks go to
    // consecutive banks); other head dims go a 32-bit word at a time.
    auto convert = [&](const char* stg, unsigned long long hi) {
      auto nib = [&](int r) { return (hi >> (r & (tc::kKeys - 1))) & 1ull; };
      if (hd == kHd) {
        constexpr int kChunks = kHd / 8;              // 8-byte chunks a row
#pragma unroll
        for (int i = 0; i < 2 * tc::kKeys * kChunks / kThreads; ++i) {
          const int r = i * (kThreads / kChunks) + tid / kChunks;
          const int c = tid % kChunks;
          const uint2 w =
              *reinterpret_cast<const uint2*>(stg + r * kHd + 8 * c);
          const uint2 lo = raw4_to_bf16<TKV>(w.x, nib(r));
          const uint2 up = raw4_to_bf16<TKV>(w.y, nib(r));
          *reinterpret_cast<uint4*>(ring + r * tc::kLd + 8 * c) =
              make_uint4(lo.x, lo.y, up.x, up.y);
        }
      } else {
        const int words = hd >> 2;
        for (int i = tid; i < 2 * tc::kKeys * words; i += kThreads) {
          const int r = i / words, c = i - r * words;
          const uint32_t w =
              *reinterpret_cast<const uint32_t*>(stg + r * kHd + 4 * c);
          *reinterpret_cast<uint2*>(ring + r * tc::kLd + 4 * c) =
              raw4_to_bf16<TKV>(w, nib(r));
        }
      }
      if (kScaled && tid < tc::kKeys) {
        const float* sc = reinterpret_cast<const float*>(stg + kRaw);
        sk_t[tid] = sc[tid] * sl2;
        sv_t[tid] = sc[tc::kKeys + tid];
      }
    };
    load_tile(0);
    tc::cp_commit();              // group 0: q and tile 0
    for (int i = 1; i < kRawStages; ++i) {
      if (i < n_tiles) load_tile(i);
      tc::cp_commit();            // group i: tile i (or nothing)
    }

    for (int j = 0; j < n_tiles; ++j) {
      cp_wait<kRawStages - 1>();  // tile j has landed
      __syncthreads();            // and every warp is done with tile j - 1
      const char* stg = raw + (j % kRawStages) * kStage;
      const uint32_t* masks =
          reinterpret_cast<const uint32_t*>(stg + kRaw) + 2 * tc::kKeys;
      const unsigned long long live =
          masks[0] | ((unsigned long long)masks[1] << 32);
      const unsigned long long hi =
          kPacked ? masks[2] | ((unsigned long long)masks[3] << 32) : 0ull;
      convert(stg, hi);
      __syncthreads();            // the tile is converted, its stage free
      if (j + kRawStages < n_tiles) load_tile(j + kRawStages);
      tc::cp_commit();
      if (active) {
        if (j == 0) tc::load_q<T, kHd>(qf, q_s, warp, lane);
        const int t0 = k_lo + j * tc::kKeys;
        const bool interior = live == ~0ull && t0 + tc::kKeys - 1 <= first;
        auto ok = [&](int jj, int half) {
          return ((live >> jj) & 1ull) && t0 + jj <= (half ? pos1 : pos0);
        };
        if constexpr (kScaled)
          tc::tile_step<T, kHd>(qf, ring, ring + tc::kKeys * tc::kLd, st,
                                sl2, interior, lane, ok,
                                tc::KeyScales{sk_t, sv_t});
        else
          tc::tile_step<T, kHd>(qf, ring, ring + tc::kKeys * tc::kLd, st,
                                sl2, interior, lane, ok);
      }
    }
  }

  st.finish();
  const size_t prow = (size_t)a.B * a.C * a.H;   // partial rows
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    if (split) {
      if (r < rows) {
        const size_t pr = (size_t)s * prow + orow(r);
        tc::store_partial<kHd>(st, half, a.part + pr * 2,
                               a.part + 2 * (size_t)a.splits * prow + pr * hd,
                               hd, lane);
      }
    } else if (r < cols * G) {  // padding columns write zeros
      tc::store_row<T, kHd>(st, half, out + orow(r) * hd, hd, lane,
                            r >= rows);
    }
  }
}

// Fold the splits of every [B, C, H] row in split order and normalise:
// column c of row b reads the splits that hold its slots (s * pps * P <=
// pos + c); a padding column, an idle row, or a total l of 0 writes zeros.
__global__ void __launch_bounds__(256) rpa_mixed_merge_kernel(Args a) {
  const int rows = a.B * a.C * a.H;
  int r, d;
  if (!tc::merge_thread(rows, a.hd, r, d)) return;
  const int b = r / (a.C * a.H);
  const int c = r / a.H - b * a.C;
  const int key = a.pos[b] + c;              // the column's last slot
  const int n_live = c < a.qlen[b] && key >= 0
                         ? min(a.splits, key / (a.pps * a.P) + 1)
                         : 0;
  const float2 o =
      tc::merge_split_stats(a.part, a.splits, rows, r, a.hd, d, n_live);
  *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.out) +
                               (size_t)r * a.hd + d) =
      tc::pack2<__nv_bfloat16>(o.x, o.y);
}

// rpa_mixed_tc (then rpa_mixed_merge with more than one split): bf16 q
// over bf16, int8, packed int4, fp8 e4m3 or e5m2 pages (kv dtype codes 1
// to 5), hd <= 128, rows of q and pages in `vec`-byte pieces.
typedef void (*TcFn)(Args, int);
template <typename TKV>
void pick_mixed_tc(int hd, TcFn& fn, size_t& smem) {
  if (hd > 64) {
    fn = &rpa_mixed_tc_kernel<128, TKV>;
    smem = mixed_smem<128, TKV>();
  } else {
    fn = &rpa_mixed_tc_kernel<64, TKV>;
    smem = mixed_smem<64, TKV>();
  }
}

int launch_mixed_tc(Args a, int kv_dtype, int vec, cudaStream_t stream) {
  TcFn fn = nullptr;
  size_t smem = 0;
  if (kv_dtype == 1) pick_mixed_tc<__nv_bfloat16>(a.hd, fn, smem);
  if (kv_dtype == 2) pick_mixed_tc<int8_t>(a.hd, fn, smem);
  if (kv_dtype == 3) pick_mixed_tc<uint8_t>(a.hd, fn, smem);
  if (kv_dtype == 4) pick_mixed_tc<__nv_fp8_e4m3>(a.hd, fn, smem);
  if (kv_dtype == 5) pick_mixed_tc<__nv_fp8_e5m2>(a.hd, fn, smem);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  a.q_cols = kMixRows / (a.H / a.KV);
  const int n_q = (a.C + a.q_cols - 1) / a.q_cols;
  const dim3 grid(a.KV * n_q, a.B, a.splits);
  fn<<<grid, kThreads, smem, stream>>>(a, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.part == nullptr) return (int)e;
  const unsigned blocks = tc::merge_blocks((size_t)a.B * a.C * a.H, a.hd);
  rpa_mixed_merge_kernel<<<blocks, 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

typedef void (*KernelFn)(Args);
typedef void (*SplitFn)(Args, int);

template <typename TQ, typename TKV>
SplitFn pick_split_d(int hd) {
  return hd <= 128 ? &rpa_split_kernel<TQ, TKV, 4>
                   : &rpa_split_kernel<TQ, TKV, 8>;
}

template <typename TQ>
SplitFn pick_split_kv(int kv_dtype, int hd) {
  if (kv_dtype == 0) return pick_split_d<TQ, float>(hd);
  if (kv_dtype == 1) return pick_split_d<TQ, __nv_bfloat16>(hd);
  if (kv_dtype == 2) return pick_split_d<TQ, int8_t>(hd);
  if (kv_dtype == 3) return pick_split_d<TQ, uint8_t>(hd);
  if (kv_dtype == 4) return pick_split_d<TQ, __nv_fp8_e4m3>(hd);
  if (kv_dtype == 5) return pick_split_d<TQ, __nv_fp8_e5m2>(hd);
  return nullptr;
}

// rpa_split then rpa_merge on one stream: f32/bf16 queries over any pool.
int launch_split(const Args& a, int q_dtype, int kv_dtype,
                 cudaStream_t stream) {
  const int G = a.H / a.KV;
  const int n_hg = (G + kSplitHeads - 1) / kSplitHeads;
  SplitFn fn = q_dtype == 0   ? pick_split_kv<float>(kv_dtype, a.hd)
               : q_dtype == 1 ? pick_split_kv<__nv_bfloat16>(kv_dtype, a.hd)
                              : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  KernelFn merge = q_dtype == 0 ? &rpa_merge_kernel<float>
                                : &rpa_merge_kernel<__nv_bfloat16>;
  const int elem = kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1;
  // the widest piece that divides a slot row's bytes and both pools'
  // alignment (16, 8, 4, 2; an int8/int4 row of odd hd goes a byte at a
  // time)
  const uintptr_t any =
      (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)(a.hd * elem);
  int vec = 1;
  for (int v = 16; v >= 2; v >>= 1)
    if (any % v == 0) {
      vec = v;
      break;
    }
  const size_t smem = split_smem_bytes(a.hd, elem, a.pps);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fn<<<dim3(a.KV * n_hg, a.B, a.splits), kThreads, smem, stream>>>(a, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int outs = a.B * a.H * a.hd;
  merge<<<(outs + 255) / 256, 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// kv dtype codes: 0 = float32, 1 = bfloat16, 2 = int8, 3 = packed int4,
// 4 = fp8 e4m3, 5 = fp8 e5m2 (rpa_cta for the mixed pairs rpa_mixed_tc
// does not take)
template <typename TQ>
KernelFn pick_mixed_kv(int kv_dtype) {
  switch (kv_dtype) {
    case 0: return &rpa_mixed_kernel<TQ, float>;
    case 1: return &rpa_mixed_kernel<TQ, __nv_bfloat16>;
    case 2: return &rpa_mixed_kernel<TQ, int8_t>;
    case 3: return &rpa_mixed_kernel<TQ, uint8_t>;
    case 4: return &rpa_mixed_kernel<TQ, __nv_fp8_e4m3>;
    case 5: return &rpa_mixed_kernel<TQ, __nv_fp8_e5m2>;
  }
  return nullptr;
}

// q dtype codes: 0 = float32, 1 = bfloat16
int launch_mixed_cta(const Args& a, int q_dtype, int kv_dtype, dim3 grid,
                     cudaStream_t stream) {
  KernelFn fn = q_dtype == 0   ? pick_mixed_kv<float>(kv_dtype)
                : q_dtype == 1 ? pick_mixed_kv<__nv_bfloat16>(kv_dtype)
                               : nullptr;
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

// quantized pages (codes 2, 3) need both scale arrays; packed int4 pages an
// even P; f32, bf16 and fp8 pages take none
bool pool_ok(int kv_dtype, const float* sk, const float* sv, int P) {
  if (kv_dtype < 2 || kv_dtype > 3) return true;
  return sk != nullptr && sv != nullptr && (kv_dtype != 3 || P % 2 == 0);
}

}  // namespace

extern "C" {

// Shape limits the wrapper checks before launching.
int rpa_max_group() { return kRows; }
int rpa_max_head_dim() { return kMaxHd; }

// Decode: q/out [B, 1, H, hd]; sk/sv null unless the pages are quantized;
// P counts real tokens per page. Every pool runs rpa_split over `splits`
// splits of `pps` table columns (splits * pps >= max_pages) and rpa_merge,
// with `part` f32 scratch of B * KV * splits * G * (hd + 2) floats.
// Returns cudaGetLastError() of the launches.
int rpa_decode(const void* q, const void* k, const void* v, const float* sk,
               const float* sv, const int* table, const int* pos, void* out,
               int B, int H, int KV, int hd, int P, int N, int max_pages,
               float scale, int q_dtype, int kv_dtype, int pps, int splits,
               float* part, void* stream) {
  if (!shape_ok(H, KV, hd) || !pool_ok(kv_dtype, sk, sv, P))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a{q, k, v, sk, sv, table, pos, nullptr, out,
         B, 1, H, KV, hd, P, N, max_pages, 1, scale, pps, splits, part};
  if (part == nullptr || pps < 1 || splits < 1 ||
      (long long)pps * splits < max_pages || splits > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_split(a, q_dtype, kv_dtype, static_cast<cudaStream_t>(stream));
}

// Mixed: q/out [B, C, H, hd], q_len [B]; scales and P as rpa_decode.
// With tc set (bf16 q over bf16, int8 or packed int4 pages, hd <= 128, q
// and page rows and pointers 4-byte aligned, else an error) it runs
// rpa_mixed_tc over `splits` splits of `pps` table columns (splits * pps
// >= max_pages) and, with splits > 1, rpa_mixed_merge, with `part` f32
// scratch of splits * B * C * H * (hd + 2) floats; without tc, rpa_cta,
// which ignores the three. Returns
// cudaGetLastError() of the launches.
int rpa_mixed(const void* q, const void* k, const void* v, const float* sk,
              const float* sv, const int* table, const int* pos,
              const int* q_len, void* out, int B, int C, int H, int KV,
              int hd, int P, int N, int max_pages, float scale, int q_dtype,
              int kv_dtype, int tc, int pps, int splits, float* part,
              void* stream) {
  if (!shape_ok(H, KV, hd) || !pool_ok(kv_dtype, sk, sv, P))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || C == 0) return 0;
  if (tc) {
    const int elem = kv_dtype == 1 ? 2 : 1;    // bytes a page element
                                               // (bf16 2; int8, int4, fp8 1)
    const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                          (uintptr_t)(hd * 2) | (uintptr_t)(hd * elem);
    int vec = 0;
    for (int w = 16; w >= 4 && vec == 0; w >>= 1)
      if (any % w == 0) vec = w;
    if (q_dtype != 1 || kv_dtype < 1 || hd > 128 || vec == 0 || pps < 1 ||
        splits < 1 || splits > 65535 || (long long)pps * splits < max_pages ||
        (splits > 1) != (part != nullptr))
      return (int)cudaErrorInvalidValue;
    Args a{q, k, v, sk, sv, table, pos, q_len, out,
           B, C, H, KV, hd, P, N, max_pages, 0, scale, pps, splits, part};
    return launch_mixed_tc(a, kv_dtype, vec,
                           static_cast<cudaStream_t>(stream));
  }
  const int q_cols = kRows / (H / KV);
  Args a{q, k, v, sk, sv, table, pos, q_len, out,
         B, C, H, KV, hd, P, N, max_pages, q_cols, scale};
  const int tiles = (C + q_cols - 1) / q_cols;
  return launch_mixed_cta(a, q_dtype, kv_dtype, dim3(KV, B, tiles),
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
