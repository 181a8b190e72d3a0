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
// What bounds it on this card: bytes. At M = 1 a [4096, 14336] weight is
// 29.4 MB of packed bytes and 1.8 MB of scales for 0.12 GFLOP: four flops a
// byte, far below the ~295 where arithmetic would be the limit. Every
// weight byte is needed exactly once, so the kernel is a weight stream and
// the dequantized weight must never exist in device memory.
//
// What the design does about it (right first; tensor-core tiles for M > 8
// and 16-column threads come later):
//   * a block owns 256 neighbouring output columns: 256 contiguous bytes of
//     every packed row (packed rows have Out contiguous). The bytes of one
//     group, g/2 rows by 256 bytes, are one stage of a ring of kStages in
//     shared memory, filled by cp.async in 16-byte pieces. Three groups are
//     in flight while the fourth is consumed, 48 KB a block at g = 128, so
//     the bytes in flight do not depend on the registers a thread has left;
//   * a thread reads its 32-bit word of a staged row, four bytes = four
//     columns, and each byte yields input rows j (low nibble) and j + g/2
//     (high) of the group;
//   * a nibble becomes f32 without an integer conversion: a byte permute
//     drops the stored value + 8 into the mantissa of 2^23, and subtracting
//     2^23 + 8 leaves the signed weight exactly. x times such a weight
//     is exact in f32 for bf16 x, so only the order of the f32 sum differs
//     from any other way of computing the same function;
//   * the four k-lanes of a block (kThreads / kColThreads) take every fourth
//     packed row of the group, so four times as many threads work on one
//     column range; their sums meet in shared memory at the end, in lane
//     order;
//   * x of each group rides the same ring as f32, [g][MT] with the M tile
//     innermost, so one broadcast 16-byte read feeds four rows of M. A
//     thread keeps MT x 4 accumulators in registers; M is tiled by MT = 1,
//     2, 4 or 8 (the smallest that covers M, so M = 1 does no padded work),
//     and M > 8 runs ceil(M / 8) blocks per column range, neighbours in the
//     grid so that they meet in the L2 cache;
//   * the scale is applied once per group to the group's partial sums;
//   * output tiles alone are too few blocks at decode shapes (16 for a
//     4096-column weight), so the TPU's sequential group axis is cut into
//     `splits` contiguous ranges across blockIdx.z. With splits > 1 each
//     block writes an f32 partial [splits, M, Out] and a second kernel sums
//     the ranges in order: no float atomics, so the same inputs give the
//     same bits on every run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 64;                    // threads across columns
constexpr int kKLanes = kThreads / kColThreads;    // 4 row lanes per group
constexpr int kColsPerThread = 4;                  // one 32-bit word
constexpr int kColsPerBlock = kColThreads * kColsPerThread;   // 256
constexpr int kTileBytes = kColsPerBlock;          // of one packed row
constexpr int kChunk = 16;                         // bytes per cp.async
constexpr int kChunksPerRow = kTileBytes / kChunk;
constexpr int kStages = 4;                         // groups in the ring
constexpr int kMTile = 8;                          // largest M tile
// ops/int4_matmul.py gates on the same limits: MAX_KERNEL_M, MAX_GROUP,
// M_TILE, COLS_PER_BLOCK, and Out a multiple of kChunk
constexpr int kMaxM = 64;
constexpr int kMaxGroup = 256;

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

struct Args {
  const void* x;          // [M, In]
  const uint8_t* packed;  // [In/2, Out]
  const float* scale;     // [G, Out]
  void* out;              // [M, Out]
  float* partial;         // [splits, M, Out] when splits > 1
  int M, In, Out, g;
  int splits;             // ranges of the group axis (gridDim.z)
  int groups_per_split;
};

// Shared memory of one block, in bytes: the ring of packed groups
// [kStages][g/2][kTileBytes], then the ring of x groups [kStages][g][MT] f32;
// the front is reused at the end for the k-lanes' sums
// [kKLanes - 1][MT][kColsPerBlock] f32. At g = 128 and MT = 8 that is 64 KB
// + 16 KB (two blocks on an SM), at g = kMaxGroup 160 KB, inside the 227 KB
// a block may ask for.
__host__ __device__ inline size_t weight_ring_bytes(int g) {
  return (size_t)kStages * (g / 2) * kTileBytes;
}
size_t smem_bytes(int g, int mt) {
  const size_t ring =
      weight_ring_bytes(g) + (size_t)kStages * g * mt * sizeof(float);
  const size_t red =
      (size_t)(kKLanes - 1) * mt * kColsPerBlock * sizeof(float);
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

  // the k-lanes' sums meet in shared memory, added in lane order
  __pipeline_wait_prior(0);
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [kKLanes-1][MT][kColsPerBlock]
  if (kl > 0) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
      *reinterpret_cast<float4*>(
          red + ((size_t)(kl - 1) * MT + m) * kColsPerBlock +
          ct * kColsPerThread) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();
  if (kl != 0 || !live) return;
#pragma unroll
  for (int l = 0; l < kKLanes - 1; ++l)
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(
          red + ((size_t)l * MT + m) * kColsPerBlock + ct * kColsPerThread);
      acc[m][0] += v.x;
      acc[m][1] += v.y;
      acc[m][2] += v.z;
      acc[m][3] += v.w;
    }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int row = m0 + m;
    if (row >= a.M) continue;
    if (a.splits == 1) {
      T* o = static_cast<T*>(a.out) + (size_t)row * a.Out + col;
#pragma unroll
      for (int c = 0; c < kColsPerThread; ++c) o[c] = from_f<T>(acc[m][c]);
    } else {
      *reinterpret_cast<float4*>(
          a.partial + ((size_t)blockIdx.z * a.M + row) * a.Out + col) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    }
  }
}

// Second pass when the group axis was split: out[i] = sum over the ranges,
// in range order, of partial[range][i], cast to the output dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads)
int4_reduce_kernel(const float* partial, T* out, int n, int splits) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(size_t)k * n + i];
  out[i] = from_f<T>(s);
}

typedef void (*KernelFn)(Args);

template <typename T>
KernelFn pick_tile(int mt) {
  switch (mt) {
    case 1: return int4_matmul_kernel<T, 1>;
    case 2: return int4_matmul_kernel<T, 2>;
    case 4: return int4_matmul_kernel<T, 4>;
    case 8: return int4_matmul_kernel<T, 8>;
  }
  return nullptr;
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16
KernelFn pick(int dtype, int mt) {
  switch (dtype) {
    case 0: return pick_tile<float>(mt);
    case 1: return pick_tile<__nv_bfloat16>(mt);
    case 2: return pick_tile<__half>(mt);
  }
  return nullptr;
}

template <typename T>
void launch_reduce(const Args& a, cudaStream_t stream) {
  const int n = a.M * a.Out;
  int4_reduce_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(a.partial, static_cast<T*>(a.out), n,
                                    a.splits);
}

bool shape_ok(int M, int In, int Out, int g) {
  return M >= 1 && M <= kMaxM && g >= 2 && g % 2 == 0 && g <= kMaxGroup &&
         In >= g && In % g == 0 && Out >= kChunk && Out % kChunk == 0;
}

}  // namespace

extern "C" {

// x [M, In] in dtype, packed [In/2, Out] uint8, scale [In/g, Out] f32, out
// [M, Out] in dtype; partial [splits, M, Out] f32 scratch when splits > 1
// (else unused). Returns cudaGetLastError() of the launches.
int int4_matmul(const void* x, const void* packed, const void* scale,
                void* out, void* partial, int M, int In, int Out, int g,
                int splits, int dtype, void* stream_ptr) {
  if (!shape_ok(M, In, Out, g)) return (int)cudaErrorInvalidValue;
  const int G = In / g;
  if (splits < 1 || splits > G || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int per = (G + splits - 1) / splits;
  if ((splits - 1) * per >= G) return (int)cudaErrorInvalidValue;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const int mt = M == 1 ? 1 : M == 2 ? 2 : M <= 4 ? 4 : kMTile;
  KernelFn fn = pick(dtype, mt);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const int col_blocks = (Out + kColsPerBlock - 1) / kColsPerBlock;
  if (col_blocks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Args a{x, static_cast<const uint8_t*>(packed),
         static_cast<const float*>(scale), out,
         static_cast<float*>(partial), M, In, Out, g, splits, per};
  const size_t smem = smem_bytes(g, mt);
  if (smem > 48 * 1024) {
    // raise the kernel's limit once per function and size, not per launch
    static size_t allowed[3][kMTile + 1] = {};
    if (smem > allowed[dtype][mt]) {
      cudaError_t attr = cudaFuncSetAttribute(
          (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (attr != cudaSuccess) return (int)attr;
      allowed[dtype][mt] = smem;
    }
  }
  fn<<<dim3((M + mt - 1) / mt, col_blocks, splits), kThreads, smem,
       stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  switch (dtype) {
    case 0: launch_reduce<float>(a, stream); break;
    case 1: launch_reduce<__nv_bfloat16>(a, stream); break;
    case 2: launch_reduce<__half>(a, stream); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
