// Fused k-means assignment + per-centroid partial sums, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   map_oxidize_tpu/ops/kmeans_kernel.py, `_build` (the pl.pallas_call),
//   wrapped by `fused_assign_sum`.
// Same function: for every point p the nearest centroid by the score
// -2 p.c + |c|^2 (the lowest index on ties, as jnp.argmin), then for every
// centroid the sum of its points and their count, written as one (k, d+1)
// f32 array: the sums, then a counts column.  Rows carry an optional f32
// weight w (a weight multiplies the row; 0 drops it).
//
// Numerics per mode, as the reference's:
//   highest  plain f32 FMA (no TF32, no tensor cores);
//   bf16     both operands of the score product rounded to bf16, products
//            accumulated in f32; the sums add the bf16-rounded points in f32.
//   |c|^2 stays f32 from the f32 centroids in both modes.
//
// What bounds it on an H100: 2*n*k*d score FLOPs against one read of the
// points.  On the CUDA cores (67 TFLOP/s f32) that is compute-bound at the
// shapes the fit runs (n=2^22, d=64: 2.06 ms at k=256, 16.4 ms at k=2048).
// In bf16 mode the bound is the tensor cores' rate or the 0.54 GB read
// (0.16 ms at k=256); this kernel does not use the tensor cores, so it sits
// far above that bound (wgmma is later work).
//
// Design.  The TPU runs the Pallas grid in order and carries the (k, d+1)
// accumulator in VMEM from step to step.  Hopper blocks run in parallel and
// in no order, so:
//   * a persistent grid of G blocks walks row tiles b, b+G, b+2G, ...; each
//     block keeps its own (k, d+1) partial, in shared memory when it fits
//     (k=256, d=64: 66.5 KB), else in its own slice of a global scratch
//     (k=2048: 532 KB);
//   * inside a block, each output element (c, j) is owned by exactly one
//     thread, which adds the tile's rows in row order;
//   * a second kernel adds the G partials in block order.
// No float atomics anywhere, so a result is bitwise the same run to run.
// Scores: a 128-point x 128-centroid tile per step from shared memory, an
// 8 x 8 register tile per thread, a running (min, index) per row across
// centroid chunks, then a shuffle reduction over the 16 threads of a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BM = 128;             // points per tile
constexpr int BN = 128;             // centroids per chunk
constexpr int THREADS = 256;        // 16 x 16 threads, 8 x 8 scores each
constexpr int LDP = BM + 4;         // shared row pitch; keeps float4 alignment
constexpr int LDC = BN + 4;
constexpr size_t SMEM_LIMIT = 232448;  // opt-in dynamic shared memory, sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// |c|^2 per centroid: each square rounded, then summed in index order.
__global__ void centroid_norms(const float* __restrict__ c, int k, int d,
                               float* __restrict__ cn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  float s = 0.f;
  for (int t = 0; t < d; ++t) {
    const float x = c[(size_t)i * d + t];
    s = __fadd_rn(s, __fmul_rn(x, x));
  }
  cn[i] = s;
}

template <typename PT, bool BF16>
__global__ void __launch_bounds__(THREADS)
assign_sum_partial(const PT* __restrict__ p, const float* __restrict__ w,
                   const float* __restrict__ c, const float* __restrict__ cn,
                   int n, int d, int k, int acc_in_smem,
                   float* __restrict__ partials) {
  extern __shared__ __align__(16) float smem[];
  float* ps = smem;                // [d][LDP] points tile, transposed
  float* cs = ps + d * LDP;        // [d][LDC] centroid chunk, transposed
  float* cns = cs + d * LDC;       // [BN] |c|^2 of the chunk
  float* ws = cns + BN;            // [BM] row weights, 0 past n
  int* cid = reinterpret_cast<int*>(ws + BM);  // [BM] assignments
  const int W = d + 1;
  float* acc = acc_in_smem ? reinterpret_cast<float*>(cid + BM)
                           : partials + (size_t)blockIdx.x * k * W;
  const int tid = threadIdx.x;
  const int tx = tid & 15;         // centroid columns tx*4.., 64+tx*4..
  const int ty = tid >> 4;         // point rows ty*4.., 64+ty*4..
  const int n_tiles = (n + BM - 1) / BM;
  const int groups = THREADS / W > 0 ? THREADS / W : 1;

  for (int i = tid; i < k * W; i += THREADS) acc[i] = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * BM;
    __syncthreads();  // the previous tile's accumulation is done with ps/cid
    for (int i = tid; i < BM * d; i += THREADS) {
      const int r = i / d, t = i - r * d;
      const float x =
          row0 + r < n ? to_f32(p[(size_t)(row0 + r) * d + t]) : 0.f;
      ps[t * LDP + r] = BF16 ? round_bf16(x) : x;
    }
    for (int r = tid; r < BM; r += THREADS)
      ws[r] = row0 + r < n ? (w != nullptr ? w[row0 + r] : 1.f) : 0.f;

    float best[8];
    int arg[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      best[i] = INFINITY;
      arg[i] = 0;
    }

    for (int c0 = 0; c0 < k; c0 += BN) {
      __syncthreads();  // ps is ready; the previous chunk is no longer read
      for (int i = tid; i < BN * d; i += THREADS) {
        const int j = i / d, t = i - j * d;
        const float x = c0 + j < k ? c[(size_t)(c0 + j) * d + t] : 0.f;
        cs[t * LDC + j] = BF16 ? round_bf16(x) : x;
      }
      for (int j = tid; j < BN; j += THREADS)
        cns[j] = c0 + j < k ? cn[c0 + j] : INFINITY;  // pad never wins
      __syncthreads();

      float s[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      for (int t = 0; t < d; ++t) {
        const float4 a0 = *reinterpret_cast<const float4*>(ps + t * LDP + ty * 4);
        const float4 a1 =
            *reinterpret_cast<const float4*>(ps + t * LDP + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(cs + t * LDC + tx * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(cs + t * LDC + 64 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
      // this thread's columns in increasing centroid order: a strict < keeps
      // the first minimum.  -2*s is exact, so one rounding, as -2.0*dot + cn.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx * 4 + j + (j < 4 ? 0 : 60);
        const float norm = cns[col];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v = fmaf(-2.f, s[i][j], norm);
          if (v < best[i]) {
            best[i] = v;
            arg[i] = c0 + col;
          }
        }
      }
    }
    // the 16 threads sharing a row are 16 lanes of one warp: reduce over them,
    // the lower index winning a tie
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg[i], off);
        if (ob < best[i] || (ob == best[i] && oa < arg[i])) {
          best[i] = ob;
          arg[i] = oa;
        }
      }
    }
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        cid[ty * 4 + i + (i < 4 ? 0 : 60)] = arg[i];
    }
    __syncthreads();

    // (centroid c, column j) belongs to thread (c % groups, j): one writer
    // per element, rows added in order
    for (int e = tid; e < groups * W; e += THREADS) {
      const int g = e / W, j = e - g * W;
      for (int r = 0; r < BM; ++r) {
        const float wr = ws[r];
        const int cc = cid[r];
        if (wr == 0.f || cc % groups != g) continue;
        acc[(size_t)cc * W + j] += j < d ? ps[j * LDP + r] * wr : wr;
      }
    }
  }
  if (acc_in_smem) {
    __syncthreads();
    float* out = partials + (size_t)blockIdx.x * k * W;
    for (int i = tid; i < k * W; i += THREADS) out[i] = acc[i];
  }
}

// out[e] = sum over blocks b, in block order, of partials[b][e]
__global__ void sum_partials(const float* __restrict__ partials, int blocks,
                             int kw, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kw) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partials[(size_t)b * kw + e];
  out[e] = s;
}

template <typename PT, bool BF16>
cudaError_t launch_partial(const void* p, const float* w, const float* c,
                           const float* cn, int n, int d, int k, int grid,
                           float* partials, cudaStream_t stream) {
  const size_t base = sizeof(float) * ((size_t)d * (LDP + LDC) + BN + BM) +
                      sizeof(int) * BM;
  const size_t acc = sizeof(float) * (size_t)k * (d + 1);
  const int in_smem = base + acc <= SMEM_LIMIT;
  const size_t bytes = in_smem ? base + acc : base;
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;  // d too wide
  cudaError_t err = cudaFuncSetAttribute(
      assign_sum_partial<PT, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  assign_sum_partial<PT, BF16><<<grid, THREADS, bytes, stream>>>(
      static_cast<const PT*>(p), w, c, cn, n, d, k, in_smem, partials);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// p: (n, d) f32, or bf16 when p_bf16 (bf16 mode only); w: (n,) f32 or null;
// c: (k, d) f32.  Scratch: cn (k,) f32, partials (grid, k, d+1) f32.
// out: (k, d+1) f32.  Launches on `stream` and does not synchronise.
// Returns the first CUDA error (0 = launched).
int moxt_kmeans_assign_sum(int device, const void* p, int p_bf16,
                           int bf16_mode, const float* w, const float* c,
                           int n, int d, int k, int grid, float* cn,
                           float* partials, float* out, void* stream) {
  if (n < 0 || d <= 0 || k <= 0 || grid <= 0 || (p_bf16 && !bf16_mode))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  centroid_norms<<<(k + 255) / 256, 256, 0, s>>>(c, k, d, cn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p_bf16)
    err = launch_partial<__nv_bfloat16, true>(p, w, c, cn, n, d, k, grid,
                                              partials, s);
  else if (bf16_mode)
    err = launch_partial<float, true>(p, w, c, cn, n, d, k, grid, partials, s);
  else
    err = launch_partial<float, false>(p, w, c, cn, n, d, k, grid, partials, s);
  if (err != cudaSuccess) return err;
  const int kw = k * (d + 1);
  sum_partials<<<(kw + 255) / 256, 256, 0, s>>>(partials, grid, kw, out);
  return cudaGetLastError();
}

const char* moxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
