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
//   highest  plain f32 FMA on the CUDA cores (no TF32, no tensor cores);
//   bf16     both operands of the score product rounded to bf16, products
//            accumulated in f32; the sums add the bf16-rounded points in f32.
//   |c|^2 stays f32 from the f32 centroids in both modes.
//
// What bounds it on an H100: 2*n*k*d score operations against one read of
// the points.  In `highest` that is compute-bound on the CUDA cores
// (67 TFLOP/s f32; n=2^22, d=64: 2.06 ms at k=256, 16.4 ms at k=2048).  In
// `bf16` the bound is the 0.54 GB read of bf16 points at k=256 (0.16 ms) and
// the tensor cores' rate (989 TFLOP/s) at k=2048 (1.1 ms).
//
// Design.  The TPU runs the Pallas grid in order and carries the (k, d+1)
// accumulator in VMEM from step to step.  Hopper blocks run in parallel and
// in no order, so a persistent grid (one 512-thread block, 16 warps, per
// SM) walks 128-row tiles b, b+G, b+2G, ..., and a second kernel adds the
// G block partials in block order.  Inside a block:
//   * a prep kernel writes the centroids once per call, zero-padded to a
//     whole 256-centroid chunk and to the compute width (pre-rounded to
//     bf16 in bf16 mode), and |c|^2 (+inf on pad rows, so a pad never wins);
//   * the centroids stay resident in shared memory when they fit (k=256,
//     d=64: 68 KB f32, 36 KB bf16), loaded once per block; else
//     256-centroid chunks stream through two buffers;
//   * point tiles and chunks arrive by cp.async 16-byte copies (zero-fill
//     past n and in the padding), double- or triple-buffered: the next tile
//     is in flight while this one computes.  Rows that are not whole
//     16-byte units, and f32 points in bf16 mode, take an element path;
//   * shared rows have an odd number of 16-byte units, so the 8 rows read
//     by a quarter warp (or one ldmatrix phase) fall in 8 distinct bank
//     groups: no conflicts;
//   * scores, highest: f32 FMA, each thread an 8 x 8 register tile (rows
//     ty+16i, centroids tx+32j); bf16: mma.sync m16n8k16 on the tensor
//     cores, each warp a 32 x 64 tile from ldmatrix operands.  Both keep a
//     strict < over increasing centroid per row, then reduce over the
//     lanes of a row by shuffles and over the 4 warps of a row in shared
//     memory, the lower index winning ties;
//   * sums: warp w owns the centroids c with c % 16 == w.  For each 32-row
//     group a ballot gives the warp its rows, which it adds in row order,
//     the lanes covering the d+1 columns in one coalesced pass.  Every
//     output element has one writer and adds its rows in row order.  The
//     partial lives in shared memory when it fits, else in the block's own
//     slice of global scratch.  In bf16 mode, with three point buffers, a
//     tile's sums are added while the next tile is scored, so the warps
//     with the most rows do not hold the others at a barrier.
// No float atomics anywhere, so a result is bitwise the same run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

// Named after this file, so that a profiler trace shows every kernel here
// as kmeans_assign_sum::<kernel>.
namespace kmeans_assign_sum {

constexpr int BM = 128;        // points per tile
constexpr int BN = 256;        // centroids per chunk
constexpr int THREADS = 512;   // 16 warps: 4 (rows) x 4 (centroids)
constexpr int NWARPS = THREADS / 32;
constexpr size_t SMEM_LIMIT = 232448;  // opt-in dynamic shared memory, sm_90
constexpr int MAX_DEVICES = 64;

// --- cp.async ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// --- layout -----------------------------------------------------------------

// Shared-memory layout of one launch; computed on the host, passed by value.
// Shared tiles hold f32 in `highest` and bf16 in `bf16` mode.
struct Layout {
  int d, dc;             // point width; compute width (zero-padded: d
                         // rounded up to 4 f32, or to 16 bf16 for the mma)
  int p_units, p_pitch;  // 16-byte units of a shared point row / its pitch
  int p_copy_units;      // units copied by cp.async; 0: element path
  int p_lanes_lg;        // log2 of lanes per row in a cp.async pass
  int c_units, c_pitch;  // the same for a centroid row (always cp.async)
  int c_lanes_lg;
  int k, k_pad, n_chunks;
  int resident, acc_smem, pbufs, cbufs;
  unsigned off_c, off_p, off_w, off_red, off_cid, off_acc, smem;
};

int units_pitch(int units) { return units | 1; }  // odd: no bank conflicts
int lanes_lg(int units) {
  int lg = 0;
  while (lg < 5 && (1 << lg) < units) ++lg;
  return lg;
}
unsigned align_up(size_t x, size_t a) {
  return static_cast<unsigned>((x + a - 1) / a * a);
}

// Picks the first arrangement that fits, in order of preference: resident
// centroids, then the partial in shared memory, then (bf16 mode) three
// point buffers (the sums of a tile wait for the next tile) over two,
// then two centroid buffers over one, then one point buffer.
bool make_layout(int d, int k, int p_bf16, int bf16_mode, Layout* L) {
  Layout l{};
  const int es = bf16_mode ? 2 : 4;  // bytes of a shared element
  l.d = d;
  l.dc = bf16_mode ? (d + 15) / 16 * 16 : (d + 3) / 4 * 4;
  l.p_units = l.dc * es / 16;
  l.p_pitch = units_pitch(l.p_units);
  // rows of the input type in whole 16-byte units copy as they are
  const bool same_type = bf16_mode == p_bf16;
  l.p_copy_units = same_type && (d * es) % 16 == 0 ? d * es / 16 : 0;
  l.p_lanes_lg = lanes_lg(l.p_units);
  l.c_units = l.p_units;
  l.c_pitch = l.p_pitch;
  l.c_lanes_lg = l.p_lanes_lg;
  l.k = k;
  l.k_pad = (k + BN - 1) / BN * BN;
  l.n_chunks = l.k_pad / BN;
  const int options[10][4] = {  // resident, acc_smem, pbufs, cbufs
      {1, 1, 3, 1}, {1, 1, 2, 1}, {1, 0, 3, 1}, {1, 0, 2, 1}, {0, 1, 3, 2},
      {0, 1, 2, 2}, {0, 0, 3, 2}, {0, 0, 2, 2}, {0, 0, 2, 1}, {0, 0, 1, 1}};
  for (const auto& o : options) {
    if (o[2] == 3 && !bf16_mode) continue;  // highest adds its sums in place
    l.resident = o[0];
    l.acc_smem = o[1];
    l.pbufs = o[2];
    l.cbufs = o[3];
    size_t off = 0;
    l.off_c = 0;
    off += (size_t)(l.resident ? l.k_pad : BN) * l.c_pitch * 16 * l.cbufs;
    l.off_p = align_up(off, 16);
    off = l.off_p + (size_t)BM * l.p_pitch * 16 * l.pbufs;
    l.off_w = align_up(off, 16);
    off = l.off_w + sizeof(float) * BM * l.pbufs;
    l.off_red = align_up(off, 16);
    off = l.off_red + (sizeof(float) + sizeof(int)) * 4 * BM;
    l.off_cid = align_up(off, 16);
    off = l.off_cid + sizeof(int) * BM;
    l.off_acc = align_up(off, 16);
    if (l.acc_smem) off = l.off_acc + sizeof(float) * (size_t)k * (d + 1);
    if (off <= SMEM_LIMIT) {
      l.smem = static_cast<unsigned>(off);
      *L = l;
      return true;
    }
  }
  return false;
}

// --- prep: padded centroids and |c|^2 ----------------------------------------

__device__ __forceinline__ void store(float* q, float x) { *q = x; }
__device__ __forceinline__ void store(__nv_bfloat16* q, float x) {
  *q = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(__nv_bfloat16* q, __nv_bfloat16 x) {
  *q = x;
}

// cpad (k_pad, dc) of the shared type ST: c (rounded to bf16 in bf16 mode),
// zero past (k, d); cn (k_pad,): |c|^2 of the f32 centroids (each square
// rounded, summed in index order), +inf past k.
template <typename ST>
__global__ void prep_centroids(const float* __restrict__ c, int k, int d,
                               int dc, ST* __restrict__ cpad,
                               float* __restrict__ cn) {
  const int row = blockIdx.x;
  for (int t = threadIdx.x; t < dc; t += blockDim.x)
    store(cpad + (size_t)row * dc + t,
          row < k && t < d ? c[(size_t)row * d + t] : 0.f);
  if (threadIdx.x == 0) {
    float s = 0.f;
    if (row < k) {
      for (int t = 0; t < d; ++t) {
        const float x = c[(size_t)row * d + t];
        s = __fadd_rn(s, __fmul_rn(x, x));
      }
    } else {
      s = INFINITY;  // a pad centroid never wins
    }
    cn[row] = s;
  }
}

// --- scores ------------------------------------------------------------------

__device__ __forceinline__ float load1(const float* q) { return *q; }
__device__ __forceinline__ float load1(const __nv_bfloat16* q) {
  return __bfloat162float(*q);
}

// running first-index minimum: a strict < as the centroids increase
__device__ __forceinline__ void take_min(float v, int col, float& best,
                                         int& arg) {
  if (v < best) {
    best = v;
    arg = col;
  }
}
// the lower index wins a tie: for values met in no particular order
__device__ __forceinline__ void merge_min(float v, int col, float& best,
                                          int& arg) {
  if (v < best || (v == best && col < arg)) {
    best = v;
    arg = col;
  }
}

// highest: f32 FMA on the CUDA cores.  Thread (ty, tx) holds the 8 x 8
// scores of rows ty + 16 i and chunk centroids tx + 32 j, summed over t in
// order; warps are 4 ty x 8 tx, so a quarter warp reads 8 distinct rows.
__device__ __forceinline__ void scores_fma(const float* pt, int pp,
                                           const float* cb, int cp, int dc,
                                           const float* __restrict__ cn,
                                           int col0, float* best, int* arg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = (warp >> 2) * 4 + (lane >> 3);
  const int tx = (warp & 3) * 8 + (lane & 7);
  float sc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
  for (int t = 0; t < dc; t += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float4*>(pt + (ty + 16 * i) * pp + t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(cb + (tx + 32 * j) * cp + t);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sc[i][j] = fmaf(a[i].w, b.w,
                        fmaf(a[i].z, b.z,
                             fmaf(a[i].y, b.y, fmaf(a[i].x, b.x, sc[i][j]))));
    }
  }
  // -2*s is exact, so one rounding, as -2.0*dot + cn
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = col0 + tx + 32 * j;
    const float norm = __ldg(cn + col);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      take_min(fmaf(-2.f, sc[i][j], norm), col, best[i], arg[i]);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* q) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(q));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: the tensor cores, mma.sync m16n8k16 (bf16 in, f32 accumulate).
// Warp (wr, wc) = (warp / 4, warp % 4) computes rows wr*32 .. +32 against
// chunk centroids wc*64 .. +64: 2 x 8 tiles of 16 x 8.  The accumulator
// fragment of a tile gives lane l rows l/4 and l/4 + 8, columns 2(l%4) and
// 2(l%4)+1 (SM80_16x8x16_F32BF16BF16F32_TN in CUTLASS), so each thread
// holds 4 rows (mt, h) and 16 columns that increase with (nt, e).
__device__ __forceinline__ void scores_mma(const char* pt, int p_pitch,
                                           const char* cb, int c_pitch,
                                           int dc,
                                           const float* __restrict__ cn,
                                           int col0, float* best, int* arg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  // ldmatrix row addresses: A, lanes 0-15 rows 0-15 at k 0, lanes 16-31
  // the same rows at k 8; B, lanes 0-7 / 8-15 / 16-23 / 24-31 centroids
  // 0-7 at k 0 / 0-7 at k 8 / 8-15 at k 0 / 8-15 at k 8
  const char* pa = pt + (size_t)(wr * 32 + (lane & 15)) * p_pitch * 16 +
                   (lane >> 4) * 16;
  const char* pb =
      cb + (size_t)(wc * 64 + (lane & 7) + ((lane >> 4) << 3)) * c_pitch * 16 +
      ((lane >> 3) & 1) * 16;
  for (int kk = 0; kk < dc; kk += 16) {
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], pa + (size_t)mt * 16 * p_pitch * 16 + kk * 2);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      ldmatrix_x4(b, pb + (size_t)np * 16 * c_pitch * 16 + kk * 2);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = col0 + wc * 64 + nt * 8 + 2 * (lane & 3);
    const float2 norm = __ldg(reinterpret_cast<const float2*>(cn + col));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        take_min(fmaf(-2.f, acc[mt][nt][2 * h], norm.x), col,
                 best[2 * mt + h], arg[2 * mt + h]);
        take_min(fmaf(-2.f, acc[mt][nt][2 * h + 1], norm.y), col + 1,
                 best[2 * mt + h], arg[2 * mt + h]);
      }
  }
}

// --- the assign + sum kernel -------------------------------------------------

// Copies `rows` rows of `units` 16-byte units from global (row stride
// `gstride` bytes) into shared (pitch `pitch` units); units at or past
// `copy_units` and rows at or past `valid_rows` are zero-filled.  Lanes
// split into 2^lg lanes per row.
__device__ __forceinline__ void copy_rows_async(char* dst, int pitch,
                                                const char* src,
                                                size_t gstride, int rows,
                                                int valid_rows, int units,
                                                int copy_units, int lg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = 32 >> lg;
  const int q0 = lane & ((1 << lg) - 1);
  for (int r = warp * per_warp + (lane >> lg); r < rows;
       r += NWARPS * per_warp) {
    const bool ok = r < valid_rows;
    const char* g = src + (ok ? (size_t)r * gstride : 0);
    char* s = dst + (size_t)r * pitch * 16;
    for (int q = q0; q < units; q += 1 << lg)
      cp_async16(s + q * 16, g + (q < copy_units ? q * 16 : 0),
                 ok && q < copy_units);
  }
}

// arow[j] += row[j] * w for j < d, arow[d] += w, the lanes over j: every
// load of the row issues before its stores, so a partial in global memory
// costs one memory round trip per row and not one per 32 columns
template <typename ST>
__device__ __forceinline__ void add_row_ilp(const ST* row, float* arow,
                                            float w, int d, int W) {
  const int lane = threadIdx.x & 31;
  for (int j0 = lane; j0 < W; j0 += 96) {
    float x[3], a[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int j = j0 + 32 * q;
      if (j < W) {
        x[q] = j < d ? __fmul_rn(load1(row + j), w) : w;
        a[q] = arow[j];
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (j0 + 32 * q < W) arow[j0 + 32 * q] = a[q] + x[q];
  }
}

// PT: the points' type in global memory; BF16: the mode.  Shared tiles are
// f32 in highest mode and bf16 in bf16 mode.
template <typename PT, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
assign_sum_partial(const PT* __restrict__ p, const float* __restrict__ w,
                   const void* __restrict__ cpad,
                   const float* __restrict__ cn, int n, const Layout L,
                   float* __restrict__ partials) {
  using ST = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int R = BF16 ? 4 : 8;  // rows of the block tile per thread
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = L.d, W = d + 1;
  float* red_v = reinterpret_cast<float*>(smem + L.off_red);  // [4][BM]
  int* red_i = reinterpret_cast<int*>(red_v + 4 * BM);        // [4][BM]
  int* cid = reinterpret_cast<int*>(smem + L.off_cid);        // [BM]
  float* acc = L.acc_smem ? reinterpret_cast<float*>(smem + L.off_acc)
                          : partials + (size_t)blockIdx.x * L.k * W;
  const size_t c_chunk = (size_t)BN * L.c_pitch * 16;  // bytes of a chunk
  const size_t c_row = (size_t)L.dc * sizeof(ST);      // bytes of a cpad row
  const size_t p_tile = (size_t)BM * L.p_pitch * 16;
  const int pp = L.p_pitch * 16 / (int)sizeof(ST);  // pitch in elements
  const int n_tiles = (n + BM - 1) / BM;
  const int my_tiles =
      blockIdx.x < n_tiles ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int steps = my_tiles * L.n_chunks;
  const bool defer = BF16 && L.pbufs == 3;
  // 32-row groups of the previous tile added per chunk step when deferred
  const int gps = (BM / 32 + L.n_chunks - 1) / L.n_chunks;

  for (int i = tid; i < L.k * W; i += THREADS) acc[i] = 0.f;

  // loads for step s: the point tile (and its weights) when s starts a
  // tile, the centroid chunk when streaming.  `early` issues the parts
  // whose buffer is not the one step s-1 reads (double-buffered), the
  // others go after step s-1 is done with their buffer.
  auto issue = [&](int s, bool early) {
    const int ti = s / L.n_chunks, ch = s - ti * L.n_chunks;
    if (ch == 0 && (L.pbufs == 2 || (BF16 && L.pbufs == 3)) == early) {
      const int row0 = (blockIdx.x + ti * gridDim.x) * BM;
      const int valid = n - row0;
      char* dst = smem + L.off_p + (ti % L.pbufs) * p_tile;
      if (L.p_copy_units) {
        copy_rows_async(dst, L.p_pitch,
                        reinterpret_cast<const char*>(p + (size_t)row0 * d),
                        (size_t)d * sizeof(PT), BM, valid, L.p_units,
                        L.p_copy_units, L.p_lanes_lg);
      } else {  // element by element, converted to the shared type
        for (int r = warp; r < BM; r += NWARPS) {
          ST* srow = reinterpret_cast<ST*>(dst) + r * pp;
          const PT* grow = p + (size_t)(row0 + r) * d;
          for (int t = lane; t < L.dc; t += 32) {
            if (r < valid && t < d)
              store(srow + t, grow[t]);
            else
              store(srow + t, 0.f);
          }
        }
      }
      float* ws = reinterpret_cast<float*>(smem + L.off_w) +
                  (ti % L.pbufs) * BM;
      for (int r = tid; r < BM; r += THREADS) {
        if (w != nullptr)
          cp_async4(ws + r, w + (r < valid ? row0 + r : 0), r < valid);
        else
          ws[r] = r < valid ? 1.f : 0.f;
      }
    }
    if (!L.resident && (L.cbufs == 2) == early) {
      copy_rows_async(smem + L.off_c + (s % L.cbufs) * c_chunk, L.c_pitch,
                      static_cast<const char*>(cpad) + (size_t)ch * BN * c_row,
                      c_row, BN, BN, L.c_units, L.c_units, L.c_lanes_lg);
    }
    cp_async_commit();
  };

  // warp `warp` adds the rows of 32-row groups [g0, g1) of tile tj that went
  // to its centroids (c % 16 == warp), in row order, lanes over the d+1
  // columns (the last adds the weight)
  auto accumulate = [&](int tj, int g0, int g1) {
    const char* pt = smem + L.off_p + (tj % L.pbufs) * p_tile;
    const float* ws = reinterpret_cast<const float*>(smem + L.off_w) +
                      (tj % L.pbufs) * BM;
    const ST* prows = reinterpret_cast<const ST*>(pt);
    for (int g = g0 * 32; g < g1 * 32; g += 32) {
      const int cc = cid[g + lane];
      const float wr = ws[g + lane];
      unsigned mine = __ballot_sync(
          0xffffffffu, wr != 0.f && (cc & (NWARPS - 1)) == warp);
      while (mine) {
        const int b = __ffs(mine) - 1;
        mine &= mine - 1;
        const int c2 = __shfl_sync(0xffffffffu, cc, b);
        const float w2 = __shfl_sync(0xffffffffu, wr, b);
        const ST* prow = prows + (g + b) * pp;
        float* arow = acc + (size_t)c2 * W;
        if (!L.acc_smem) {
          add_row_ilp(prow, arow, w2, d, W);
        } else {
          for (int j = lane; j < d; j += 32)
            arow[j] += __fmul_rn(load1(prow + j), w2);
          if (lane == 0) arow[d] += w2;
        }
      }
    }
  };

  if (L.resident && steps > 0)
    copy_rows_async(smem + L.off_c, L.c_pitch,
                    static_cast<const char*>(cpad), c_row, L.k_pad, L.k_pad,
                    L.c_units, L.c_units, L.c_lanes_lg);
  if (steps > 0) {
    issue(0, true);
    issue(0, false);
  }

  float best[R];
  int arg[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    best[i] = INFINITY;
    arg[i] = 0;
  }
  for (int s = 0, ti = 0, ch = 0; s < steps; ++s) {
    cp_async_wait_all();
    __syncthreads();  // step s's data landed; step s-1 is done everywhere
    if (s + 1 < steps) issue(s + 1, true);
    // with three point buffers (bf16 mode) the sums of a tile are added
    // while the next tile is scored, spread over its first chunks: warps
    // that finish their rows early go on to the scores, instead of waiting
    // at a barrier for the others
    if (defer && ti > 0 && ch * gps < BM / 32)
      accumulate(ti - 1, ch * gps, min(BM / 32, (ch + 1) * gps));

    const char* pt = smem + L.off_p + (ti % L.pbufs) * p_tile;
    const char* cb = smem + L.off_c +
                     (L.resident ? ch * c_chunk : (s % L.cbufs) * c_chunk);
    if constexpr (BF16)
      scores_mma(pt, L.p_pitch, cb, L.c_pitch, L.dc, cn, ch * BN, best, arg);
    else
      scores_fma(reinterpret_cast<const float*>(pt), pp,
                 reinterpret_cast<const float*>(cb), L.c_pitch * 4, L.dc, cn,
                 ch * BN, best, arg);

    if (ch == L.n_chunks - 1) {
      // over the lanes of a row in this warp (8 for the FMA tile, the quad
      // for the mma fragment), then over the 4 warps of a row
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int off = BF16 ? 2 : 4; off > 0; off >>= 1)
          merge_min(__shfl_xor_sync(0xffffffffu, best[i], off),
                    __shfl_xor_sync(0xffffffffu, arg[i], off), best[i],
                    arg[i]);
        int row;
        bool writer;
        if constexpr (BF16) {
          row = (warp >> 2) * 32 + (i >> 1) * 16 + (i & 1) * 8 + (lane >> 2);
          writer = (lane & 3) == 0;
        } else {
          row = (warp >> 2) * 4 + (lane >> 3) + 16 * i;
          writer = (lane & 7) == 0;
        }
        if (writer) {
          red_v[(warp & 3) * BM + row] = best[i];
          red_i[(warp & 3) * BM + row] = arg[i];
        }
        best[i] = INFINITY;
        arg[i] = 0;
      }
      __syncthreads();
      for (int r = tid; r < BM; r += THREADS) {
        float bv = red_v[r];
        int bi = red_i[r];
        for (int g = 1; g < 4; ++g)
          merge_min(red_v[g * BM + r], red_i[g * BM + r], bv, bi);
        cid[r] = bi;
      }
      if (!defer) {
        // the same sums as `accumulate`, written out: through the lambda or
        // a shared function, ptxas scheduled the highest kernel's FMA loop
        // measurably slower
        __syncthreads();
        const float* ws = reinterpret_cast<const float*>(smem + L.off_w) +
                          (ti % L.pbufs) * BM;
        const ST* prows = reinterpret_cast<const ST*>(pt);
        for (int g = 0; g < BM; g += 32) {
          const int cc = cid[g + lane];
          const float wr = ws[g + lane];
          unsigned mine = __ballot_sync(
              0xffffffffu, wr != 0.f && (cc & (NWARPS - 1)) == warp);
          while (mine) {
            const int b = __ffs(mine) - 1;
            mine &= mine - 1;
            const int c2 = __shfl_sync(0xffffffffu, cc, b);
            const float w2 = __shfl_sync(0xffffffffu, wr, b);
            const ST* prow = prows + (g + b) * pp;
            float* arow = acc + (size_t)c2 * W;
            if (!BF16 && !L.acc_smem) {
              add_row_ilp(prow, arow, w2, d, W);
            } else {
              for (int j = lane; j < d; j += 32)
                arow[j] += __fmul_rn(load1(prow + j), w2);
              if (lane == 0) arow[d] += w2;
            }
          }
        }
      }
    }

    if (s + 1 < steps && (L.pbufs == 1 || (!L.resident && L.cbufs == 1))) {
      __syncthreads();  // step s no longer reads the single buffers
      issue(s + 1, false);
    }
    if (++ch == L.n_chunks) {
      ch = 0;
      ++ti;
    }
  }
  if (defer && steps > 0) {
    __syncthreads();  // the last tile's assignments are in cid
    accumulate(my_tiles - 1, 0, BM / 32);
  }
  if (L.acc_smem) {
    __syncthreads();
    float* out = partials + (size_t)blockIdx.x * L.k * W;
    for (int i = tid; i < L.k * W; i += THREADS) out[i] = acc[i];
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

// Shared bytes already granted to a kernel, per device: the attribute is
// set once per kernel and size, not on every launch.
template <typename PT, bool BF16>
cudaError_t allow_smem(int device, unsigned bytes) {
  static unsigned granted[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (bytes <= granted[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      assign_sum_partial<PT, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted[device] = bytes;
  return err;
}

template <typename PT, bool BF16>
cudaError_t occupancy(int device, const Layout& L, int* blocks_per_sm) {
  cudaError_t err = allow_smem<PT, BF16>(device, L.smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, assign_sum_partial<PT, BF16>, THREADS, L.smem);
}

template <typename PT, bool BF16>
cudaError_t launch_partial(int device, const void* p, const float* w,
                           const void* cpad, const float* cn, int n,
                           const Layout& L, int grid, float* partials,
                           cudaStream_t stream) {
  cudaError_t err = allow_smem<PT, BF16>(device, L.smem);
  if (err != cudaSuccess) return err;
  assign_sum_partial<PT, BF16><<<grid, THREADS, L.smem, stream>>>(
      static_cast<const PT*>(p), w, cpad, cn, n, L, partials);
  return cudaGetLastError();
}

// scratch: cn (k_pad f32), cpad (k_pad x dc of the shared type), partials
// (grid x k x d+1 f32), each 256-byte aligned
size_t cpad_bytes(const Layout& L, int bf16_mode) {
  return align_up((size_t)L.k_pad * L.dc * (bf16_mode ? 2 : 4), 256);
}
size_t scratch_bytes(const Layout& L, int bf16_mode, int grid) {
  return align_up(sizeof(float) * L.k_pad, 256) + cpad_bytes(L, bf16_mode) +
         sizeof(float) * (size_t)grid * L.k * (L.d + 1);
}

}  // namespace kmeans_assign_sum

using namespace kmeans_assign_sum;

extern "C" {

// The launch plan for (n, d, k) on `device`: out[0] grid, out[1] blocks
// per SM, out[2] shared bytes per block, out[3] centroids resident,
// out[4] partial in shared memory, out[5] scratch bytes, out[6] k_pad (the
// centroid rows scored per point).  Returns a CUDA
// error (0 = ok; cudaErrorInvalidValue when d is too wide for shared
// memory).
int moxt_kmeans_plan(int device, int p_bf16, int bf16_mode, int n, int d,
                     int k, long long* out) {
  if (n < 0 || d <= 0 || k <= 0 || (p_bf16 && !bf16_mode))
    return cudaErrorInvalidValue;
  Layout L;
  if (!make_layout(d, k, p_bf16, bf16_mode, &L)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int sms = 0, bps = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (p_bf16)
    err = occupancy<__nv_bfloat16, true>(device, L, &bps);
  else if (bf16_mode)
    err = occupancy<float, true>(device, L, &bps);
  else
    err = occupancy<float, false>(device, L, &bps);
  if (err != cudaSuccess) return err;
  if (bps < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = ((long long)n + BM - 1) / BM;
  const long long slots = (long long)sms * bps;
  const long long grid = tiles < 1 ? 1 : (tiles < slots ? tiles : slots);
  out[0] = grid;
  out[1] = bps;
  out[2] = L.smem;
  out[3] = L.resident;
  out[4] = L.acc_smem;
  out[5] = (long long)scratch_bytes(L, bf16_mode, (int)grid);
  out[6] = L.k_pad;
  return 0;
}

// p: (n, d) f32, or bf16 when p_bf16 (bf16 mode only); w: (n,) f32 or null;
// c: (k, d) f32; grid from moxt_kmeans_plan; scratch of the plan's bytes,
// 256-byte aligned.  out: (k, d+1) f32.  Launches on `stream` and does not
// synchronise.  Returns the first CUDA error (0 = launched).
int moxt_kmeans_assign_sum(int device, const void* p, int p_bf16,
                           int bf16_mode, const float* w, const float* c,
                           int n, int d, int k, int grid, void* scratch,
                           float* out, void* stream) {
  if (n < 0 || d <= 0 || k <= 0 || grid <= 0 || (p_bf16 && !bf16_mode))
    return cudaErrorInvalidValue;
  Layout L;
  if (!make_layout(d, k, p_bf16, bf16_mode, &L)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  float* cn = reinterpret_cast<float*>(base);
  char* cpad = base + align_up(sizeof(float) * L.k_pad, 256);
  float* partials =
      reinterpret_cast<float*>(cpad + cpad_bytes(L, bf16_mode));
  if (bf16_mode)
    prep_centroids<<<L.k_pad, 128, 0, s>>>(
        c, k, d, L.dc, reinterpret_cast<__nv_bfloat16*>(cpad), cn);
  else
    prep_centroids<<<L.k_pad, 128, 0, s>>>(
        c, k, d, L.dc, reinterpret_cast<float*>(cpad), cn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p_bf16)
    err = launch_partial<__nv_bfloat16, true>(device, p, w, cpad, cn, n, L,
                                              grid, partials, s);
  else if (bf16_mode)
    err = launch_partial<float, true>(device, p, w, cpad, cn, n, L, grid,
                                      partials, s);
  else
    err = launch_partial<float, false>(device, p, w, cpad, cn, n, L, grid,
                                       partials, s);
  if (err != cudaSuccess) return err;
  const int kw = k * (d + 1);
  sum_partials<<<(kw + 255) / 256, 256, 0, s>>>(partials, grid, kw, out);
  return cudaGetLastError();
}

const char* moxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
