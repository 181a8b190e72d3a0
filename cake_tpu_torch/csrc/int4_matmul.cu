// Decode-shaped matmul over nibble-packed int4 weights for Hopper (sm_90a).
//
// Replaces the TPU kernel in cake_tpu/ops/int4_matmul.py:
//   int4_matmul  <- _int4_kernel  (via int4_matmul)
// It computes x [M, In] @ W [In, Out] for M <= 64 rows, where W is stored as
// packed bytes [In/2, Out] in the group-halves layout with f32 group scales
// [G, Out], G = In / g: inside group gi, packed row gi*g/2 + j holds input
// row gi*g + j in its low nibble and input row gi*g + j + g/2 in its high
// nibble, each as value + 8. The sum runs in f32 and the output [M, Out] is
// written in x's dtype:
//   out[m, o] = sum_gi scale[gi, o] * sum_k x[m, gi*g + k] * w4[gi*g + k, o]
//
// What bounds it on this card: bytes. At M = 8 a [4096, 14336] weight is
// 29.4 MB of packed bytes and 1.8 MB of scales for 0.94 GFLOP: 30 flops a
// byte, far below the ~295 where the tensor cores would be the limit; at
// M = 64 it is 240, close to it. Every weight byte is needed exactly once,
// so the kernel is a weight stream, the dequantized weight never exists in
// device memory, and a byte must leave HBM once and be converted once
// whatever M is.
//
// Two bodies, one launch each:
//
// int4_tc_kernel, for bf16 and f16 x of two rows or more (the tensor-core
// body). It computes out^T = W^T x^T on mma.sync.m16n8k16 with f32
// accumulate: the weight is the A operand (m16 = 16 output columns), x the
// B operand (n8 = 8 rows of M), so a CTA covers every row of M and
// converts each weight byte once.
//   * a CTA owns kTcCols = 256 output columns: 256 contiguous bytes of each
//     packed row. The bytes of one group (g/2 rows), the group's x (M rows
//     of g elements) and its scales are one stage of a cp.async ring in
//     shared memory, up to four stages deep. Staged x rows past M are never
//     written: product column n reads only x row n, and rows past M are
//     never stored;
//   * the order of k inside a group is free as long as x uses the same.
//     A k16 step covers packed rows j0 .. j0 + 7: its k 0..7 are their low
//     nibbles (input rows j0 + i), its k 8..15 their high nibbles (rows
//     j0 + g/2 + i). So x is staged as it lies, and one ldmatrix row is
//     eight neighbouring x values. A thread's A register holds the same
//     nibble of two neighbouring packed rows of one column: a byte permute
//     puts the two bytes side by side, a mask drops each nibble into the
//     mantissa of 128.0 (bf16 0x4300 | v; f16 1024.0, 0x6400 | v), and one
//     packed subtract of 136.0 (f16: 1032.0) leaves v - 8 exactly;
//   * the columns a warp owns are reordered so that one 32-bit shared load
//     feeds four m16 tiles: row r of tile t is column TM * r + t of the
//     warp's 16 * TM. The same order makes a thread's scales and outputs
//     TM neighbouring columns (kWordLoads = false takes the natural order
//     and byte loads instead);
//   * a group's eight k16 steps run into a fresh f32 fragment, which is
//     multiplied by the scales of its two columns and added to the
//     accumulator: the scale is applied once per group, on the fragments;
//   * M picks the tile: NT = ceil(M / 8) n-tiles (1, 2, 4 or 8); up to 32
//     rows, 4 warps of TM = 4 m16 tiles; past 32, 8 warps of TM = 2.
//
// int4_matmul_kernel, for f32 x (tensor cores would round x to tf32), for
// one row (where an H100 runs it faster) and for g not a multiple of 16:
// CUDA cores. A thread reads a 32-bit word of a staged packed row,
// four bytes = four columns; a byte permute drops each nibble into the
// mantissa of 2^23, and subtracting 2^23 + 8 leaves the signed weight as an
// exact f32. Four k-lanes take every fourth packed row of a group, x of the
// group rides the ring as f32 [g][MT], M is tiled by MT = 1, 2, 4 or 8 in
// registers (M > 8: ceil(M / 8) blocks per column range).
//
// Both bodies cut the group axis into `splits` contiguous ranges (output
// tiles alone are too few CTAs at decode shapes: 56 at Out = 14336, 16 at
// 4096). The ranges of one output tile are one thread-block cluster
// (splits <= 16: past the portable 8, which would leave a 4096-column
// weight 128 CTAs), launched with cudaLaunchKernelEx: each rank leaves its
// f32 partial in its shared memory, and rank r sums the r-th share of the
// tile over the ranks' shared memory (distributed shared memory) in rank
// order and writes the output. One launch, no scratch in device memory,
// no float atomics: the same inputs give the same bits, and the launch
// captures into a CUDA graph.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tc_attention.cuh"

namespace cg = cooperative_groups;

namespace {

// ops/int4_matmul.py gates on the same limits (MAX_KERNEL_M, MAX_GROUP,
// OUT_MULTIPLE) and plans with the same tiles (COLS_PER_CTA, M_TILE,
// MAX_SPLITS); the launcher refuses a shape or plan beyond them
constexpr int kMaxM = 64;
constexpr int kMaxGroup = 256;
constexpr int kChunk = 16;                         // bytes per cp.async
constexpr int kMaxSplits = 16;                     // Hopper's largest cluster
constexpr int kStages = 4;                         // groups in a ring
constexpr size_t kSmemLimit = 232448;              // a block's 227 KB

// ---- the CUDA-core body ----------------------------------------------------

constexpr int kThreads = 256;
constexpr int kColThreads = 64;                    // threads across columns
constexpr int kKLanes = kThreads / kColThreads;    // 4 row lanes per group
constexpr int kColsPerThread = 4;                  // one 32-bit word
constexpr int kColsPerBlock = kColThreads * kColsPerThread;   // 256
constexpr int kTileBytes = kColsPerBlock;          // of one packed row
constexpr int kChunksPerRow = kTileBytes / kChunk;
constexpr int kMTile = 8;                          // largest M tile

// ---- the tensor-core body --------------------------------------------------

constexpr int kTcCols = 256;                       // output columns a CTA owns
constexpr int kTcLd = kTcCols + 16;                // bytes between packed rows
constexpr int kXPad = 8;                           // elements after an x row
constexpr int kRedPad = 4;                         // floats after a partial row
// one 32-bit shared load feeds four m16 tiles (false: natural column order,
// one byte load a tile)
constexpr bool kWordLoads = true;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

// Four f32 values rounded to T and stored at dst (16 bytes for f32, 8 for
// the 2-byte types; dst is aligned to that).
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 v) {
  uint2 u;
  u.x = tc::pack2<T>(v.x, v.y);
  u.y = tc::pack2<T>(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) = u;
}

struct Args {
  const void* x;          // [M, In]
  const uint8_t* packed;  // [In/2, Out]
  const float* scale;     // [G, Out]
  void* out;              // [M, Out]
  int M, In, Out, g;
  int groups_per_split;   // groups of a range; rank r starts at r * this
};

// The ranks of a cluster (each a range of the group axis) meet here. Each
// rank's f32 partial of the CTA's tile, `rows` x `cols` floats at row
// stride `ld`, lies in its shared memory at `red`; rank r sums the r-th
// share of the tile's float4s over the ranks in rank order, and writes
// them as output rows row0 + m, columns col0 + c.
template <typename T>
__device__ __forceinline__ void reduce_over_cluster(const float* red, int ld,
                                                    int rows, int cols,
                                                    int row0, int col0,
                                                    const Args& a) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();            // every rank's partial is in place
  const int s = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int q4 = cols / 4;
  const int n = rows * q4;
  const int per = (n + s - 1) / s;
  const int end = min(n, (rank + 1) * per);
  T* out = static_cast<T*>(a.out);
  for (int e = rank * per + (int)threadIdx.x; e < end; e += (int)blockDim.x) {
    const int m = e / q4;
    const int c = (e - m * q4) * 4;
    if (col0 + c >= a.Out) continue;
    // four ranks' values are loaded before they are added: a loop of
    // load then add would wait out one remote-load latency a rank (and
    // all sixteen at once would cost a CUDA-core CTA a third of its SM)
    const float* src = red + m * ld + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q0 = 0; q0 < s; q0 += 4) {
      float4 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q0 + q < s)
          v[q] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(src, q0 + q));
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q0 + q < s) {
          acc.x += v[q].x;
          acc.y += v[q].y;
          acc.z += v[q].z;
          acc.w += v[q].w;
        }
    }
    store4(out + (size_t)(row0 + m) * a.Out + col0 + c, acc);
  }
  cluster.sync();            // no rank leaves while another reads its partial
}

// ---- the CUDA-core body ----------------------------------------------------

// Shared memory of one block, in bytes: the ring of packed groups
// [kStages][g/2][kTileBytes], then the ring of x groups [kStages][g][MT] f32;
// the front is reused at the end for the k-lanes' sums
// [kKLanes][MT][kColsPerBlock] f32. At g = 128 and MT = 8 that is 64 KB +
// 16 KB (two blocks on an SM), at g = kMaxGroup 160 KB.
__host__ __device__ inline size_t weight_ring_bytes(int g) {
  return (size_t)kStages * (g / 2) * kTileBytes;
}
size_t core_smem_bytes(int g, int mt) {
  const size_t ring =
      weight_ring_bytes(g) + (size_t)kStages * g * mt * sizeof(float);
  const size_t red = (size_t)kKLanes * mt * kColsPerBlock * sizeof(float);
  return ring > red ? ring : red;
}

// Byte c of `nibbles` (a value 0..15) as the f32 value - 8: the byte lands
// in the low mantissa bits of 0x4B000000 = 2^23, giving 2^23 + value.
__device__ __forceinline__ float nibble_to_weight(uint32_t nibbles, int c) {
  return __uint_as_float(__byte_perm(nibbles, 0x4B000000u, 0x7440u + c)) -
         8388616.0f;
}

// Start the copy of group gi's bytes for this block's columns into one
// stage of the ring: g/2 rows of kTileBytes, in 16-byte pieces (whole
// pieces lie inside or outside the weight: Out is a multiple of kChunk).
__device__ __forceinline__ void start_group_copy(const Args& a, int gi,
                                                 int col0, uint8_t* stage,
                                                 int tid) {
  const int h = a.g / 2;
  const uint8_t* src = a.packed + (size_t)gi * h * a.Out + col0;
  for (int id = tid; id < h * kChunksPerRow; id += kThreads) {
    const int row = id / kChunksPerRow;
    const int c = (id % kChunksPerRow) * kChunk;
    if (col0 + c < a.Out)
      __pipeline_memcpy_async(stage + row * kTileBytes + c,
                              src + (size_t)row * a.Out + c, kChunk);
  }
}

// This thread's share of group gi's x, as f32 (rows past M read as 0): at
// most MT elements, since g <= kMaxGroup = kThreads.
template <typename T, int MT>
__device__ __forceinline__ void load_x(const Args& a, int gi, int m0, int tid,
                                       float (&xr)[MT]) {
  const T* x = static_cast<const T*>(a.x);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int idx = tid + i * kThreads;
    xr[i] = 0.f;
    if (idx < a.g * MT) {
      const int m = idx / a.g;
      const int k = idx - m * a.g;
      if (m0 + m < a.M)
        xr[i] = to_f(x[(size_t)(m0 + m) * a.In + (size_t)gi * a.g + k]);
    }
  }
}

template <int MT>
__device__ __forceinline__ void store_x(const Args& a, float* stage, int tid,
                                        const float (&xr)[MT]) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < a.g * MT) {
      const int m = idx / a.g;
      const int k = idx - m * a.g;
      stage[k * MT + m] = xr[i];
    }
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads) int4_matmul_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int ct = tid % kColThreads;
  const int kl = tid / kColThreads;
  const int m0 = blockIdx.x * MT;
  const int col0 = blockIdx.y * kColsPerBlock;
  const int col = col0 + ct * kColsPerThread;
  const bool live = col < a.Out;
  const int g = a.g;
  const int h = g / 2;
  const int g_begin = blockIdx.z * a.groups_per_split;
  const int n_groups = min(a.In / g - g_begin, a.groups_per_split);
  const size_t w_stage = (size_t)h * kTileBytes;     // bytes
  const int x_stage = g * MT;                        // floats
  uint8_t* ws = smem;
  float* xs = reinterpret_cast<float*>(smem + weight_ring_bytes(g));

  float acc[MT][kColsPerThread];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) acc[m][c] = 0.f;

  // fill the ring: groups 0 .. kStages - 2 of this block's range (one
  // commit per stage, empty past the range, so the wait below counts alike)
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_groups) {
      float xr[MT];
      load_x<T, MT>(a, g_begin + s, m0, tid, xr);
      store_x<MT>(a, xs + s * x_stage, tid, xr);
      start_group_copy(a, g_begin + s, col0, ws + s * w_stage, tid);
    }
    __pipeline_commit();
  }

  for (int i = 0; i < n_groups; ++i) {
    const int nxt = i + kStages - 1;
    // group nxt's x and group i's scales leave for their registers before
    // the wait, so their latency hides behind it
    float xr[MT];
    if (nxt < n_groups) load_x<T, MT>(a, g_begin + nxt, m0, tid, xr);
    float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live)
      s4 = __ldg(reinterpret_cast<const float4*>(
          a.scale + (size_t)(g_begin + i) * a.Out + col));
    // all but the newest kStages - 2 copies are done: group i has landed
    __pipeline_wait_prior(kStages - 2);
    __syncthreads();   // ... for every thread; and group i - 1 is consumed
    if (nxt < n_groups) {
      const int st = nxt % kStages;        // the stage group i - 1 held
      store_x<MT>(a, xs + st * x_stage, tid, xr);
      start_group_copy(a, g_begin + nxt, col0, ws + st * w_stage, tid);
    }
    __pipeline_commit();
    if (!live) continue;

    const uint8_t* wsg = ws + (i % kStages) * w_stage + ct * kColsPerThread;
    const float* xsg = xs + (i % kStages) * x_stage;
    float part[MT][kColsPerThread];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) part[m][c] = 0.f;

#pragma unroll 4
    for (int j = kl; j < h; j += kKLanes) {
      const uint32_t w =
          *reinterpret_cast<const uint32_t*>(wsg + j * kTileBytes);
      const uint32_t lo = w & 0x0F0F0F0Fu;
      const uint32_t hi = (w >> 4) & 0x0F0F0F0Fu;
      float wl[kColsPerThread], wh[kColsPerThread];
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) {
        wl[c] = nibble_to_weight(lo, c);
        wh[c] = nibble_to_weight(hi, c);
      }
      const float* xl = xsg + j * MT;          // input row j of the group
      const float* xh = xsg + (j + h) * MT;    // input row j + g/2
      float xa[MT], xb[MT];
      if constexpr (MT % 4 == 0) {
#pragma unroll
        for (int q = 0; q < MT / 4; ++q) {
          const float4 va = reinterpret_cast<const float4*>(xl)[q];
          const float4 vb = reinterpret_cast<const float4*>(xh)[q];
          xa[4 * q + 0] = va.x; xa[4 * q + 1] = va.y;
          xa[4 * q + 2] = va.z; xa[4 * q + 3] = va.w;
          xb[4 * q + 0] = vb.x; xb[4 * q + 1] = vb.y;
          xb[4 * q + 2] = vb.z; xb[4 * q + 3] = vb.w;
        }
      } else {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          xa[m] = xl[m];
          xb[m] = xh[m];
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < kColsPerThread; ++c)
          part[m][c] = fmaf(xa[m], wl[c], fmaf(xb[m], wh[c], part[m][c]));
    }
    const float s[kColsPerThread] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c)
        acc[m][c] = fmaf(part[m][c], s[c], acc[m][c]);
  }

  // the k-lanes' sums meet in shared memory, added in lane order into
  // lane 0's rows; then the cluster's ranks meet over those
  __pipeline_wait_prior(0);
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [kKLanes][MT][kColsPerBlock]
  auto red_at = [&](int l, int m) {
    return red + ((size_t)l * MT + m) * kColsPerBlock + ct * kColsPerThread;
  };
#pragma unroll
  for (int m = 0; m < MT; ++m)
    *reinterpret_cast<float4*>(red_at(kl, m)) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  if (kl == 0) {
#pragma unroll
    for (int l = 1; l < kKLanes; ++l)
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 v = *reinterpret_cast<const float4*>(red_at(l, m));
        acc[m][0] += v.x;
        acc[m][1] += v.y;
        acc[m][2] += v.z;
        acc[m][3] += v.w;
      }
#pragma unroll
    for (int m = 0; m < MT; ++m)
      *reinterpret_cast<float4*>(red_at(0, m)) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  reduce_over_cluster<T>(red, kColsPerBlock, min(MT, a.M - m0),
                         kColsPerBlock, m0, col0, a);
}

// ---- the tensor-core body --------------------------------------------------

// The tile of a body picked by M: NT n-tiles of 8 rows; W warps of TM m16
// tiles (16 * TM columns each), W * 16 * TM = kTcCols. Past 32 rows a
// thread holds 128 f32 of fragments, so the warps take half the columns.
template <int NT> struct TcTile {
  static constexpr int W = NT == 8 ? 8 : 4;
  static constexpr int TM = NT == 8 ? 2 : 4;
  static constexpr int kThreads = 32 * W;
  static_assert(W * 16 * TM == kTcCols, "a CTA owns kTcCols columns");
};

// Shared memory of one stage of the tensor-core ring: the packed bytes
// [g/2][kTcLd], x [NT * 8][g + kXPad] (2-byte elements) and the group's
// scales [kTcCols] f32. Rows kTcLd = 272 bytes apart put the four packed
// rows a warp's load touches in distinct banks; x rows (g + 8) * 2 bytes
// apart do the same for the eight rows of an ldmatrix.
size_t tc_stage_bytes(int g, int nt) {
  return (size_t)(g / 2) * kTcLd + (size_t)nt * 8 * (g + kXPad) * 2 +
         kTcCols * sizeof(float);
}
size_t tc_red_bytes(int nt) {
  return (size_t)nt * 8 * (kTcCols + kRedPad) * sizeof(float);
}

// The ring's depth: kStages, or fewer when four stages do not fit (g = 256
// at NT = 8: three).
int tc_stages(int g, int nt) {
  const size_t fit = kSmemLimit / tc_stage_bytes(g, nt);
  return fit < (size_t)kStages ? (int)fit : kStages;
}
size_t tc_smem_bytes(int g, int nt, int stages) {
  const size_t ring = stages * tc_stage_bytes(g, nt);
  const size_t red = tc_red_bytes(nt);
  return ring > red ? ring : red;
}

// cp.async.wait_group stages - 2: the group consumed next has landed
__device__ __forceinline__ void wait_ring(int stages) {
  if (stages >= 4)
    __pipeline_wait_prior(2);
  else if (stages == 3)
    __pipeline_wait_prior(1);
  else
    __pipeline_wait_prior(0);
}

// The A register of one nibble of two neighbouring packed rows of a column:
// `pair` holds the two bytes at bits 0..7 and 16..23 (the nibble wanted in
// the low four bits of each); the mask puts each nibble v in the mantissa
// of 128.0 (bf16) or 1024.0 (f16), and the subtract of 136.0 (0x4308) or
// 1032.0 (0x6408) leaves v - 8 exactly. The constants are bit patterns: a
// conversion instruction (cvt) per register would cost more than the rest.
template <typename T>
__device__ __forceinline__ uint32_t nibbles_to_pair(uint32_t pair) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    uint32_t v = (pair & 0x000F000Fu) | 0x43004300u;
    const uint32_t bias = 0x43084308u;
    __nv_bfloat162 r =
        __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                *reinterpret_cast<const __nv_bfloat162*>(&bias));
    return *reinterpret_cast<uint32_t*>(&r);
  } else {
    uint32_t v = (pair & 0x000F000Fu) | 0x64006400u;
    const uint32_t bias = 0x64086408u;
    __half2 r = __hsub2(*reinterpret_cast<__half2*>(&v),
                        *reinterpret_cast<const __half2*>(&bias));
    return *reinterpret_cast<uint32_t*>(&r);
  }
}

// TM bytes of a staged packed row at p, zero-extended
template <int TM>
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* p) {
  if constexpr (TM == 4)
    return *reinterpret_cast<const uint32_t*>(p);
  else
    return *reinterpret_cast<const uint16_t*>(p);
}

// Column (within the warp's 16 * TM) of row r of m16 tile t.
template <int TM>
__device__ __forceinline__ int tc_col(int t, int r) {
  return kWordLoads ? TM * r + t : 16 * t + r;
}

// The staged scales of row r of the warp's TM m16 tiles: in word order TM
// neighbouring columns, read in one vector load.
template <int TM>
__device__ __forceinline__ void stage_scales(const float* ss, int r,
                                             float (&s)[TM]) {
  if constexpr (kWordLoads && TM == 4) {
    const float4 v = *reinterpret_cast<const float4*>(ss + TM * r);
    s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
  } else if constexpr (kWordLoads && TM == 2) {
    const float2 v = *reinterpret_cast<const float2*>(ss + TM * r);
    s[0] = v.x; s[1] = v.y;
  } else {
#pragma unroll
    for (int t = 0; t < TM; ++t) s[t] = ss[tc_col<TM>(t, r)];
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(TcTile<NT>::kThreads)
int4_tc_kernel(Args a, int stages) {
  constexpr int W = TcTile<NT>::W;
  constexpr int TM = TcTile<NT>::TM;
  constexpr int kRows = NT * 8;                   // x rows staged
  constexpr int kNThreads = TcTile<NT>::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int col0 = blockIdx.x * kTcCols;
  const int wcol = warp * 16 * TM;                // the warp's first column
  const int g = a.g;
  const int h = g / 2;
  const int xld = g + kXPad;
  const int g_begin = blockIdx.z * a.groups_per_split;
  const int n_groups = min(a.In / g - g_begin, a.groups_per_split);
  const size_t w_stage = (size_t)h * kTcLd;       // bytes
  const size_t x_stage = (size_t)kRows * xld;     // elements
  uint8_t* ws = smem;
  T* xs = reinterpret_cast<T*>(smem + stages * w_stage);
  float* ss = reinterpret_cast<float*>(xs + stages * x_stage);
  const T* x = static_cast<const T*>(a.x);

  // group gi's packed bytes, x and scales into ring stage st, in 16-byte
  // pieces (the scales ride the ring too: read straight from device memory
  // at the end of a group, their latency would stall every group); pieces
  // past Out are zero-filled unread
  auto start_group = [&](int gi, int st) {
    constexpr int kPieces = kTcCols / kChunk;
    const uint8_t* src = a.packed + (size_t)gi * h * a.Out + col0;
    uint8_t* dst = ws + st * w_stage;
    for (int id = tid; id < h * kPieces; id += kNThreads) {
      const int row = id / kPieces;
      const int c = (id - row * kPieces) * kChunk;
      const bool ok = col0 + c < a.Out;
      tc::cp_async(dst + row * kTcLd + c,
                   ok ? src + (size_t)row * a.Out + c : a.packed, kChunk, ok);
    }
    constexpr int kElems = kChunk / (int)sizeof(T);
    const int xp = g / kElems;                    // pieces of an x row
    T* xd = xs + st * x_stage;
    const T* xsrc = x + (size_t)gi * g;
    for (int id = tid; id < a.M * xp; id += kNThreads) {
      const int m = id / xp;
      const int c = (id - m * xp) * kElems;
      tc::cp_async(xd + m * xld + c, xsrc + (size_t)m * a.In + c, kChunk,
                   true);
    }
    const float* ssrc = a.scale + (size_t)gi * a.Out + col0;
    for (int c = tid * 4; c < kTcCols; c += kNThreads * 4) {
      const bool ok = col0 + c < a.Out;
      tc::cp_async(ss + st * kTcCols + c, ok ? ssrc + c : a.scale, kChunk,
                   ok);
    }
  };

  float acc[TM][NT][4];
#pragma unroll
  for (int t = 0; t < TM; ++t)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[t][n][0] = acc[t][n][1] = acc[t][n][2] = acc[t][n][3] = 0.f;

  // fill the ring: groups 0 .. stages - 2 of this CTA's range (one commit
  // per stage, empty past the range, so the wait below counts alike)
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_groups) start_group(g_begin + s, s);
    tc::cp_commit();
  }

  for (int i = 0; i < n_groups; ++i) {
    wait_ring(stages);
    __syncthreads();    // group i landed for every thread; i - 1 consumed
    const int nxt = i + stages - 1;
    if (nxt < n_groups) start_group(g_begin + nxt, nxt % stages);
    tc::cp_commit();

    const int st = i % stages;
    const uint8_t* wsg = ws + st * w_stage + wcol;
    const T* xsg = xs + st * x_stage;
    float part[TM][NT][4];
#pragma unroll
    for (int t = 0; t < TM; ++t)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        part[t][n][0] = part[t][n][1] = part[t][n][2] = part[t][n][3] = 0.f;

#pragma unroll 2
    for (int s = 0; s < h / 8; ++s) {
      // packed rows j and j + 1 of step s: this thread's k pair
      const uint8_t* r0 = wsg + (s * 8 + 2 * tig) * kTcLd;
      const uint8_t* r1 = r0 + kTcLd;
      uint32_t af[TM][4];
      if constexpr (kWordLoads) {
        const uint32_t w00 = load_bytes<TM>(r0 + TM * gid);
        const uint32_t w01 = load_bytes<TM>(r0 + TM * (gid + 8));
        const uint32_t w10 = load_bytes<TM>(r1 + TM * gid);
        const uint32_t w11 = load_bytes<TM>(r1 + TM * (gid + 8));
#pragma unroll
        for (int t = 0; t < TM; ++t) {
          const uint32_t sel = (uint32_t)t | ((uint32_t)(t + 4) << 8);
          const uint32_t p0 = __byte_perm(w00, w10, sel);   // row gid
          const uint32_t p1 = __byte_perm(w01, w11, sel);   // row gid + 8
          af[t][0] = nibbles_to_pair<T>(p0);
          af[t][1] = nibbles_to_pair<T>(p1);
          af[t][2] = nibbles_to_pair<T>(p0 >> 4);
          af[t][3] = nibbles_to_pair<T>(p1 >> 4);
        }
      } else {
#pragma unroll
        for (int t = 0; t < TM; ++t) {
          const int cl = tc_col<TM>(t, gid);
          const int ch = tc_col<TM>(t, gid + 8);
          const uint32_t p0 = (uint32_t)r0[cl] | ((uint32_t)r1[cl] << 16);
          const uint32_t p1 = (uint32_t)r0[ch] | ((uint32_t)r1[ch] << 16);
          af[t][0] = nibbles_to_pair<T>(p0);
          af[t][1] = nibbles_to_pair<T>(p1);
          af[t][2] = nibbles_to_pair<T>(p0 >> 4);
          af[t][3] = nibbles_to_pair<T>(p1 >> 4);
        }
      }
      // B: k 0..7 are x columns 8s .. 8s + 7 (low nibbles), k 8..15 are
      // columns h + 8s .. (high nibbles); lanes 8i .. 8i + 7 address
      // matrix i's eight rows
      const int kcol = ((lane >> 3) & 1) ? h + s * 8 : s * 8;
      if constexpr (NT == 1) {
        uint32_t b[2];
        tc::ldsm_x2(b, xsg + (lane & 7) * xld + kcol);
#pragma unroll
        for (int t = 0; t < TM; ++t) tc::mma16816<T>(part[t][0], af[t], b[0], b[1]);
      } else {
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t b[4];
          tc::ldsm_x4(b, xsg + ((n + (lane >> 4)) * 8 + (lane & 7)) * xld +
                             kcol);
#pragma unroll
          for (int t = 0; t < TM; ++t) {
            tc::mma16816<T>(part[t][n], af[t], b[0], b[1]);
            tc::mma16816<T>(part[t][n + 1], af[t], b[2], b[3]);
          }
        }
      }
    }
    // the group's sums times its scales: C rows gid (c0, c1) and gid + 8
    // (c2, c3) of each m16 tile
    float s_lo[TM], s_hi[TM];
    stage_scales<TM>(ss + st * kTcCols + wcol, gid, s_lo);
    stage_scales<TM>(ss + st * kTcCols + wcol, gid + 8, s_hi);
#pragma unroll
    for (int t = 0; t < TM; ++t)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[t][n][0] = fmaf(part[t][n][0], s_lo[t], acc[t][n][0]);
        acc[t][n][1] = fmaf(part[t][n][1], s_lo[t], acc[t][n][1]);
        acc[t][n][2] = fmaf(part[t][n][2], s_hi[t], acc[t][n][2]);
        acc[t][n][3] = fmaf(part[t][n][3], s_hi[t], acc[t][n][3]);
      }
  }

  // the CTA's f32 partial [kRows][kTcCols] in natural column order, over
  // the ring; then the cluster's ranks meet over it
  __pipeline_wait_prior(0);
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  constexpr int kRedLd = kTcCols + kRedPad;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = n * 8 + 2 * tig + (e & 1);
      const int r = gid + 8 * (e >> 1);
      float* row = red + m * kRedLd + wcol;
      if constexpr (kWordLoads && TM == 4) {
        *reinterpret_cast<float4*>(row + TM * r) = make_float4(
            acc[0][n][e], acc[1][n][e], acc[2][n][e], acc[3][n][e]);
      } else if constexpr (kWordLoads && TM == 2) {
        *reinterpret_cast<float2*>(row + TM * r) =
            make_float2(acc[0][n][e], acc[1][n][e]);
      } else {
#pragma unroll
        for (int t = 0; t < TM; ++t) row[tc_col<TM>(t, r)] = acc[t][n][e];
      }
    }
  reduce_over_cluster<T>(red, kRedLd, a.M, kTcCols, 0, col0, a);
}

// ---- the launcher ----------------------------------------------------------

typedef void (*CoreFn)(Args);
typedef void (*TcFn)(Args, int);

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16
template <typename T>
CoreFn pick_core_t(int mt) {
  switch (mt) {
    case 1: return int4_matmul_kernel<T, 1>;
    case 2: return int4_matmul_kernel<T, 2>;
    case 4: return int4_matmul_kernel<T, 4>;
    case 8: return int4_matmul_kernel<T, 8>;
  }
  return nullptr;
}
CoreFn pick_core(int dtype, int mt) {
  switch (dtype) {
    case 0: return pick_core_t<float>(mt);
    case 1: return pick_core_t<__nv_bfloat16>(mt);
    case 2: return pick_core_t<__half>(mt);
  }
  return nullptr;
}
template <typename T>
TcFn pick_tc_t(int nt) {
  switch (nt) {
    case 1: return int4_tc_kernel<T, 1>;
    case 2: return int4_tc_kernel<T, 2>;
    case 4: return int4_tc_kernel<T, 4>;
    case 8: return int4_tc_kernel<T, 8>;
  }
  return nullptr;
}
TcFn pick_tc(int dtype, int nt) {
  switch (dtype) {
    case 1: return pick_tc_t<__nv_bfloat16>(nt);
    case 2: return pick_tc_t<__half>(nt);
  }
  return nullptr;
}

// Prepare a kernel once per function and size, not per launch: allow
// clusters past the portable 8 CTAs (Hopper takes 16), and raise its
// dynamic shared memory limit.
cudaError_t prepare(const void* fn, size_t smem) {
  constexpr int kSlots = 32;                 // the file has 20 kernels
  static const void* fns[kSlots] = {};
  static size_t allowed[kSlots] = {};
  int i = 0;
  while (i < kSlots && fns[i] != nullptr && fns[i] != fn) ++i;
  if (i == kSlots) return cudaErrorInvalidValue;
  if (fns[i] == fn && allowed[i] >= smem) return cudaSuccess;
  cudaError_t e = cudaSuccess;
  if (fns[i] == nullptr)
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) {
    fns[i] = fn;
    allowed[i] = smem;
  }
  return e;
}

// One launch of `fn` over `grid` whose z ranks (the ranges of the group
// axis) form one cluster per output tile.
template <typename... Params, typename... Actual>
cudaError_t launch_cluster(void (*fn)(Params...), dim3 grid, int threads,
                           size_t smem, cudaStream_t stream,
                           Actual... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fn, args...);
}

bool shape_ok(int M, int In, int Out, int g) {
  return M >= 1 && M <= kMaxM && g >= 2 && g % 2 == 0 && g <= kMaxGroup &&
         In >= g && In % g == 0 && Out >= kChunk && Out % kChunk == 0;
}

}  // namespace

extern "C" {

// x [M, In] in dtype, packed [In/2, Out] uint8, scale [In/g, Out] f32, out
// [M, Out] in dtype. `splits` ranges of the group axis (a cluster of at
// most kMaxSplits CTAs per output tile, every range non-empty); `tc` 1 runs
// the tensor-core body (bf16/f16 x, g a multiple of 16), 0 the CUDA-core
// body. Returns cudaGetLastError() of the launch.
int int4_matmul(const void* x, const void* packed, const void* scale,
                void* out, int M, int In, int Out, int g, int splits,
                int dtype, int tc, void* stream_ptr) {
  if (!shape_ok(M, In, Out, g)) return (int)cudaErrorInvalidValue;
  const int G = In / g;
  if (splits < 1 || splits > G || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const int per = (G + splits - 1) / splits;
  if ((splits - 1) * per >= G) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args a{x, static_cast<const uint8_t*>(packed),
         static_cast<const float*>(scale), out, M, In, Out, g, per};
  if (tc) {
    if (g % 16 != 0) return (int)cudaErrorInvalidValue;
    const int nt = M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : 8;
    TcFn fn = pick_tc(dtype, nt);
    if (fn == nullptr) return (int)cudaErrorInvalidValue;
    const int stages = tc_stages(g, nt);
    if (stages < 2) return (int)cudaErrorInvalidValue;
    const size_t smem = tc_smem_bytes(g, nt, stages);
    cudaError_t e = prepare((const void*)fn, smem);
    if (e != cudaSuccess) return (int)e;
    const int threads =
        nt == 8 ? TcTile<8>::kThreads : TcTile<1>::kThreads;
    return (int)launch_cluster(
        fn, dim3((Out + kTcCols - 1) / kTcCols, 1, splits), threads, smem, stream,
        a, stages);
  }
  const int mt = M == 1 ? 1 : M == 2 ? 2 : M <= 4 ? 4 : kMTile;
  CoreFn fn = pick_core(dtype, mt);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = core_smem_bytes(g, mt);
  cudaError_t e = prepare((const void*)fn, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_cluster(
      fn, dim3((M + mt - 1) / mt, (Out + kColsPerBlock - 1) / kColsPerBlock,
           splits),
      kThreads, smem, stream, a);
}

}  // extern "C"
