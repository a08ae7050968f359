// Tokenize, hash and compact one padded byte chunk, for Hopper (sm_90a).
//
// Replaces the XLA programs of the JAX package's device mapper:
//   map_oxidize_tpu/ops/device_tokenize.py, `tokenize_hash` (:85) followed
//   by `_compact_tokens` (:124).
// Same function, bit for bit.  In: chunk[n] bytes (ASCII spaces pad it).
// Out: for every token, in order, its two 32-bit polynomial hashes and its
// start offset, as dense rows t_hi[max_tokens], t_lo[max_tokens] (u32,
// SENTINEL past the last token) and t_start[max_tokens] (int32, INT32_MAX
// past it), and n_tokens, the number of token ends.  A token is a maximal
// run of bytes that are not ' ' \t \n \r \v \f; bytes A-Z are lowered.
//
// The hash.  The JAX formulation takes S[i] = sum_{j<=i} (b_j+1) * Pinv^j
// (u32) and at a token [s, e] h = P^e * (S[e] - S[s-1]), which is
//   h = sum_{j=s..e} (b_j+1) * P^(e-j)   (mod 2^32),
// because P * Pinv = 1 mod 2^32: Horner's rule, h <- h*P + (b+1) over the
// token's bytes.  Each byte is the affine map x -> a*x + c on u32 (a = P,
// c = b+1 for a token byte; a = c = 0 for a space, which resets h), maps
// compose associatively, and the hash at an end byte is the composition of
// all maps up to it, applied to 0.  So the kernel needs no power tables
// (they would be 16 bytes read per input byte) and no gather of S[s-1]:
// a scan over
//   state = (a1, c1, a2, c2, ends, last_start)
// with (a, c) composed per hash, `ends` the count of token ends and
// `last_start` the last token start (the JAX cummax), carried across
// bytes, threads and tiles.  At an end byte the state gives the row: slot
// = ends before it, h1 = c1, h2 = c2, start = last_start.  The SENTINEL
// guard (h1 = h2 = 0xFFFFFFFF -> h2 - 1) is the JAX one.
//
// What bounds it on an H100: bytes.  The chunk is read once and the padded
// rows written once: n + 12 * max_tokens bytes (max_tokens = n/2 + 1 in
// the device mapper; 32 MiB chunk: ~235 MB, ~70 us at 3.35 TB/s); the
// arithmetic is a few u32 multiply-adds per byte.
//
// Design, three launches on the caller's stream:
//   1. tile_reduce: each 256-thread block owns a 4096-byte tile; each
//      thread composes the maps of its 16 bytes (one 16-byte load, plus
//      the bytes before and after for the start and end flags: the 1-byte
//      halo), the block scans the 256 thread states (warp shuffles, then
//      the 8 warp totals) and writes the tile's total state;
//   2. tile_scan: one 1024-thread block scans the tile totals in order
//      into each tile's carry (exclusive prefix) and writes n_tokens;
//   3. tile_scatter: each block recomputes its thread states, scans them
//      again, starts each thread from (tile carry + threads before it),
//      walks the thread's 16 bytes and writes a row at every token end;
//      then the grid fills the padding rows [n_tokens, max_tokens).
// The chunk is read twice (pass 1 and pass 3) rather than keeping per-byte
// state between passes, which would cost more than the 1 byte it saves.
// Rows of one thread are consecutive slots, so the writes are scattered
// but dense over the output.  No atomics: the output is deterministic.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

// Named after this file, so that a profiler trace shows every kernel here
// as tokenize_compact::<kernel>.
namespace tokenize_compact {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int BYTES_PER_THREAD = 16;
constexpr int TILE = THREADS * BYTES_PER_THREAD;  // bytes per block
constexpr int SCAN_THREADS = 1024;
constexpr uint32_t P1 = 0x01000193u;
constexpr uint32_t P2 = 0x85EBCA6Bu;
constexpr uint32_t SENTINEL = 0xFFFFFFFFu;
constexpr int INT32_MAX_ = 0x7FFFFFFF;

struct State {
  uint32_t a1, c1, a2, c2;  // the composed affine maps of both hashes
  int ends;                 // token ends
  int last;                 // last token start, -1 if none
};

__device__ __forceinline__ State identity() {
  State s;
  s.a1 = 1u; s.c1 = 0u; s.a2 = 1u; s.c2 = 0u; s.ends = 0; s.last = -1;
  return s;
}

// L then R: R o L.
__device__ __forceinline__ State combine(const State& L, const State& R) {
  State o;
  o.a1 = R.a1 * L.a1;
  o.c1 = R.a1 * L.c1 + R.c1;
  o.a2 = R.a2 * L.a2;
  o.c2 = R.a2 * L.c2 + R.c2;
  o.ends = L.ends + R.ends;
  o.last = R.last >= 0 ? R.last : L.last;
  return o;
}

__device__ __forceinline__ bool is_space(uint32_t b) {
  return b == 32u || (b >= 9u && b <= 13u);
}

__device__ __forceinline__ State shfl_up(const State& s, int d) {
  State o;
  o.a1 = __shfl_up_sync(0xffffffffu, s.a1, d);
  o.c1 = __shfl_up_sync(0xffffffffu, s.c1, d);
  o.a2 = __shfl_up_sync(0xffffffffu, s.a2, d);
  o.c2 = __shfl_up_sync(0xffffffffu, s.c2, d);
  o.ends = __shfl_up_sync(0xffffffffu, s.ends, d);
  o.last = __shfl_up_sync(0xffffffffu, s.last, d);
  return o;
}

__device__ __forceinline__ State warp_inclusive(State s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    State o = shfl_up(s, d);
    if (lane >= d) s = combine(o, s);
  }
  return s;
}

// Exclusive scan of one state per thread, in thread order, over a block of
// NW warps (NW <= 32); `smem` holds NW + 1 states.  Returns the states of
// the threads before this one, and the block's total in *total.
template <int NW>
__device__ State block_exclusive(State s, State* smem, State* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const State inc = warp_inclusive(s);
  State excl = shfl_up(inc, 1);
  if (lane == 0) excl = identity();
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const State w = lane < NW ? smem[lane] : identity();
    const State winc = warp_inclusive(w);
    State wexcl = shfl_up(winc, 1);
    if (lane == 0) wexcl = identity();
    if (lane < NW) smem[lane] = wexcl;
    if (lane == NW - 1) smem[NW] = winc;
  }
  __syncthreads();
  const State r = combine(smem[warp], excl);
  *total = smem[NW];
  __syncthreads();  // smem is reused by the caller's next scan
  return r;
}

// The 16 bytes of this thread starting at i0, plus the byte before and the
// byte after (out of range: a space).  Bytes past n are marked by valid.
struct Window {
  uint8_t b[BYTES_PER_THREAD + 2];
  int valid;  // bytes of the thread inside the chunk
};

__device__ __forceinline__ Window load_window(const uint8_t* chunk,
                                              long long n, long long i0) {
  Window w;
  w.b[0] = i0 > 0 && i0 - 1 < n ? chunk[i0 - 1] : 32;
  const long long left = n - i0;
  w.valid = left <= 0 ? 0
                      : (left < BYTES_PER_THREAD ? (int)left
                                                 : BYTES_PER_THREAD);
  if (w.valid == BYTES_PER_THREAD) {
    // i0 is a multiple of 16 and the chunk 16-byte aligned (checked)
    const uint4 v = *reinterpret_cast<const uint4*>(chunk + i0);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < BYTES_PER_THREAD; ++k)
      w.b[k + 1] = (uint8_t)(words[k >> 2] >> (8 * (k & 3)));
  } else {
#pragma unroll
    for (int k = 0; k < BYTES_PER_THREAD; ++k)
      w.b[k + 1] = k < w.valid ? chunk[i0 + k] : 32;
  }
  w.b[BYTES_PER_THREAD + 1] =
      i0 + BYTES_PER_THREAD < n ? chunk[i0 + BYTES_PER_THREAD] : 32;
  return w;
}

// The map of byte k of the window (1 <= k <= 16), with its flags.
__device__ __forceinline__ State byte_state(const Window& w, int k,
                                            long long pos, bool* end) {
  uint32_t b = w.b[k];
  if (b >= 65u && b <= 90u) b += 32u;  // ascii lower
  const bool nsp = !is_space(b);
  const bool prev_nsp = !is_space(w.b[k - 1]);
  const bool next_nsp = !is_space(w.b[k + 1]);
  State s;
  const uint32_t c = (b + 1u) & 0x1FFu;
  s.a1 = nsp ? P1 : 0u;
  s.c1 = nsp ? c : 0u;
  s.a2 = nsp ? P2 : 0u;
  s.c2 = nsp ? c : 0u;
  *end = nsp && !next_nsp;
  s.ends = *end ? 1 : 0;
  s.last = nsp && !prev_nsp ? (int)pos : -1;
  return s;
}

// The composed state of a thread's bytes.
__device__ __forceinline__ State thread_state(const Window& w, long long i0) {
  State s = identity();
  // unrolled, so the window stays in registers (constant indices)
#pragma unroll
  for (int k = 0; k < BYTES_PER_THREAD; ++k) {
    if (k < w.valid) {
      bool end;
      s = combine(s, byte_state(w, k + 1, i0 + k, &end));
    }
  }
  return s;
}

__global__ void __launch_bounds__(THREADS)
    tile_reduce(const uint8_t* __restrict__ chunk, long long n,
                State* __restrict__ tile_total) {
  __shared__ State smem[NWARPS + 1];
  const long long i0 =
      (long long)blockIdx.x * TILE + (long long)threadIdx.x * BYTES_PER_THREAD;
  const Window w = load_window(chunk, n, i0);
  State total;
  block_exclusive<NWARPS>(thread_state(w, i0), smem, &total);
  if (threadIdx.x == 0) tile_total[blockIdx.x] = total;
}

__global__ void __launch_bounds__(SCAN_THREADS)
    tile_scan(const State* __restrict__ tile_total, int tiles,
              State* __restrict__ tile_carry, int* __restrict__ n_tokens) {
  __shared__ State smem[SCAN_THREADS / 32 + 1];
  const int per = (tiles + SCAN_THREADS - 1) / SCAN_THREADS;
  const int t0 = threadIdx.x * per;
  const int t1 = min(t0 + per, tiles);
  State s = identity();
  for (int t = t0; t < t1; ++t) s = combine(s, tile_total[t]);
  State total;
  State carry = block_exclusive<SCAN_THREADS / 32>(s, smem, &total);
  for (int t = t0; t < t1; ++t) {
    tile_carry[t] = carry;
    carry = combine(carry, tile_total[t]);
  }
  if (threadIdx.x == 0) *n_tokens = total.ends;
}

__global__ void __launch_bounds__(THREADS)
    tile_scatter(const uint8_t* __restrict__ chunk, long long n,
                 const State* __restrict__ tile_carry, int max_tokens,
                 const int* __restrict__ n_tokens,
                 uint32_t* __restrict__ t_hi, uint32_t* __restrict__ t_lo,
                 int* __restrict__ t_start) {
  __shared__ State smem[NWARPS + 1];
  const long long i0 =
      (long long)blockIdx.x * TILE + (long long)threadIdx.x * BYTES_PER_THREAD;
  const Window w = load_window(chunk, n, i0);
  State total;
  const State before =
      block_exclusive<NWARPS>(thread_state(w, i0), smem, &total);
  State s = combine(tile_carry[blockIdx.x], before);
#pragma unroll
  for (int k = 0; k < BYTES_PER_THREAD; ++k) {
    if (k >= w.valid) break;
    bool end;
    s = combine(s, byte_state(w, k + 1, i0 + k, &end));
    if (end) {
      const int slot = s.ends - 1;
      if (slot < max_tokens) {
        const uint32_t h1 = s.c1;
        uint32_t h2 = s.c2;
        if (h1 == SENTINEL && h2 == SENTINEL) h2 = SENTINEL - 1u;
        t_hi[slot] = h1;
        t_lo[slot] = h2;
        t_start[slot] = s.last;
      }
    }
  }
  // the padding rows, over the whole grid
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long j = *n_tokens + (long long)blockIdx.x * THREADS + threadIdx.x;
       j < max_tokens; j += stride) {
    t_hi[j] = SENTINEL;
    t_lo[j] = SENTINEL;
    t_start[j] = INT32_MAX_;
  }
}

long long tiles_of(long long n) { return (n + TILE - 1) / TILE; }

}  // namespace tokenize_compact

extern "C" {

// Bytes of device scratch the launch needs for an n-byte chunk (the tile
// totals and carries), 256-byte aligned.
long long moxt_tokenize_compact_scratch(long long n) {
  const long long t = tokenize_compact::tiles_of(n < 1 ? 1 : n);
  const long long half =
      (t * (long long)sizeof(tokenize_compact::State) + 255) / 256 * 256;
  return 2 * half;
}

// chunk: n bytes on `device`, 16-byte aligned; scratch of
// moxt_tokenize_compact_scratch(n) bytes; t_hi, t_lo, t_start: max_tokens
// each; n_tokens: one int.  Launches on `stream` and does not
// synchronise.  Returns the first CUDA error (0 = launched).
int moxt_tokenize_compact(int device, const void* chunk, long long n,
                          long long max_tokens, void* scratch, void* t_hi,
                          void* t_lo, void* t_start, void* n_tokens,
                          void* stream) {
  using namespace tokenize_compact;
  if (n < 0 || n >= 0x7FFFFFFFLL || max_tokens < 1 ||
      max_tokens > 0x7FFFFFFFLL ||
      (reinterpret_cast<uintptr_t>(chunk) & 15u) != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = tiles_of(n < 1 ? 1 : n);
  if (tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  State* totals = reinterpret_cast<State*>(base);
  State* carries = reinterpret_cast<State*>(
      base + moxt_tokenize_compact_scratch(n) / 2);
  const uint8_t* bytes = static_cast<const uint8_t*>(chunk);
  tile_reduce<<<(unsigned)tiles, THREADS, 0, s>>>(bytes, n, totals);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_scan<<<1, SCAN_THREADS, 0, s>>>(totals, (int)tiles, carries,
                                      static_cast<int*>(n_tokens));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_scatter<<<(unsigned)tiles, THREADS, 0, s>>>(
      bytes, n, carries, (int)max_tokens, static_cast<const int*>(n_tokens),
      static_cast<uint32_t*>(t_hi), static_cast<uint32_t*>(t_lo),
      static_cast<int*>(t_start));
  return cudaGetLastError();
}

const char* moxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
