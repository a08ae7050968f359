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
// token's bytes, reset to 0 by a space.  A run of m bytes is the map
// x -> a*x + c on u32 with a = P^m if the run holds no space and a = 0
// otherwise, and c the Horner value of its bytes after its last space.
// Maps compose associatively, so a scan carries
//   state = (a1, c1, a2, c2, ends, last_start)
// across threads and tiles: `ends` the count of token ends (a row's slot),
// `last_start` the last token start (the JAX cummax).  A token that began
// before a thread and ends at its byte k hashes to P^(k+1) * h_in + c_local,
// h_in the carried c.  The SENTINEL guard (h1 = h2 = 0xFFFFFFFF -> h2 - 1)
// is the JAX one.
//
// What bounds it on an H100: bytes.  The chunk is read once and the padded
// rows written once: n + 12 * max_tokens bytes (max_tokens = n/2 + 1 in
// the device mapper; 32 MiB chunk: ~235 MB, ~70 us at 3.35 TB/s, of which
// the padding rows are most).  The integer work is a few operations per
// byte.
//
// Design: one launch, scan_tiles, a persistent grid (a memset on the stream
// zeroes its scratch first, so nothing synchronises with the host).  Each
// 256-thread block claims 8 KiB tiles in order from an atomic ticket, and
// per tile:
//   - each thread loads its 32 bytes with two 16-byte loads, classifies and
//     lowers them four at a time with byte-wise integer compares into a
//     32-bit non-space mask, and takes its start and end masks from shifts
//     of it (the 1-byte halo comes from the neighbouring lanes, and from
//     device memory at a warp's edges);
//   - a scan of the end counts gives each thread its rows' slots in the
//     tile; one Horner walk over the bytes stages each row (local hashes,
//     start) in shared memory and yields the thread's map;
//   - the block scans the thread states, and the tile joins the
//     chunk-wide scan by decoupled look-back (Merrill and Garland): it
//     writes its aggregate, then warp 0 reads the records of the 32 tiles
//     before it at a time until it meets an inclusive prefix, and writes
//     its own;
//   - the one row per thread whose token came in from before takes the
//     carried hash and start, and the tile's rows go to their contiguous
//     slots in each plane with 16-byte stores.
// The padding rows [n_tokens, max_tokens) are written tile by tile: once a
// tile knows the token ends up to its start and its end, the rows between
// the two bounds that the remaining bytes allow (m bytes end at most
// ceil(m/2) tokens) are padding, whatever comes later.  The block writes
// them while its next tile looks back: no second launch waits for
// n_tokens.  The ticket only orders which block takes which tile: no
// atomics touch data, and the output is the same bits on every run.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

// Named after this file, so that a profiler trace shows every kernel here
// as tokenize_compact::<kernel>.
namespace tokenize_compact {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int BYTES_PER_THREAD = 32;  // one bit of a u32 mask per byte
constexpr int WORDS = BYTES_PER_THREAD / 4;
constexpr int TILE = THREADS * BYTES_PER_THREAD;  // bytes per tile
// a token end at byte k < TILE-1 needs a space at k+1, so a tile ends at
// most TILE/2 tokens
constexpr int TILE_ROWS = TILE / 2;
constexpr int ROW_SMEM = 3 * TILE_ROWS * 4;  // the staged rows, 3 planes
constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr uint32_t P1 = 0x01000193u;
constexpr uint32_t P2 = 0x85EBCA6Bu;
constexpr uint32_t SENTINEL = 0xFFFFFFFFu;
constexpr uint32_t INT32_MAX_ = 0x7FFFFFFFu;

__host__ __device__ constexpr uint32_t pow_u32(uint32_t p, uint32_t e) {
  uint32_t r = 1u;
  while (e) {
    if (e & 1u) r *= p;
    p *= p;
    e >>= 1;
  }
  return r;
}

// the map of a thread's bytes when none is a space
constexpr uint32_t P1_THREAD = pow_u32(P1, BYTES_PER_THREAD);
constexpr uint32_t P2_THREAD = pow_u32(P2, BYTES_PER_THREAD);
// and of a tile's
constexpr uint32_t P1_TILE = pow_u32(P1, TILE);
constexpr uint32_t P2_TILE = pow_u32(P2, TILE);

struct State {
  uint32_t a1, c1, a2, c2;  // the composed maps of both hashes
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

__device__ __forceinline__ State shfl_up(const State& s, int d) {
  State o;
  o.a1 = __shfl_up_sync(FULL, s.a1, d);
  o.c1 = __shfl_up_sync(FULL, s.c1, d);
  o.a2 = __shfl_up_sync(FULL, s.a2, d);
  o.c2 = __shfl_up_sync(FULL, s.c2, d);
  o.ends = __shfl_up_sync(FULL, s.ends, d);
  o.last = __shfl_up_sync(FULL, s.last, d);
  return o;
}

__device__ __forceinline__ State shfl_down(const State& s, int d) {
  State o;
  o.a1 = __shfl_down_sync(FULL, s.a1, d);
  o.c1 = __shfl_down_sync(FULL, s.c1, d);
  o.a2 = __shfl_down_sync(FULL, s.a2, d);
  o.c2 = __shfl_down_sync(FULL, s.c2, d);
  o.ends = __shfl_down_sync(FULL, s.ends, d);
  o.last = __shfl_down_sync(FULL, s.last, d);
  return o;
}

__device__ __forceinline__ State shfl_idx(const State& s, int src) {
  State o;
  o.a1 = __shfl_sync(FULL, s.a1, src);
  o.c1 = __shfl_sync(FULL, s.c1, src);
  o.a2 = __shfl_sync(FULL, s.a2, src);
  o.c2 = __shfl_sync(FULL, s.c2, src);
  o.ends = __shfl_sync(FULL, s.ends, src);
  o.last = __shfl_sync(FULL, s.last, src);
  return o;
}

__device__ __forceinline__ State warp_inclusive(State s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const State o = shfl_up(s, d);
    if (lane >= d) s = combine(o, s);
  }
  return s;
}

// The block's scratch in static shared memory (the rows are dynamic).
struct Shared {
  State warp_state[NWARPS];
  State tile_total;
  int warp_ends[NWARPS];
  State tile_prefix;  // the tile's exclusive prefix, from look-back
  long long pad_lo, pad_hi;  // padding rows the tile's bytes rule out
  int tile;  // the tile the block takes next
};

// Exclusive scan of one count per thread over the block; the block's total
// lands in *total.  One barrier: each warp adds up the warp totals before
// it.
__device__ __forceinline__ int block_exclusive_ends(int v, Shared& sh,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) sh.warp_ends[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int i = 0; i < NWARPS; ++i) {
    const int x = sh.warp_ends[i];
    before += i < warp ? x : 0;
    all += x;
  }
  *total = all;
  return before + inc - v;
}

// Exclusive scan of one state per thread, in thread order, over the block:
// the states of the threads before this one; the block's total in *total.
__device__ __forceinline__ State block_exclusive(State s, Shared& sh,
                                                 State* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const State inc = warp_inclusive(s);
  State excl = shfl_up(inc, 1);
  if (lane == 0) excl = identity();
  if (lane == 31) sh.warp_state[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const State w = lane < NWARPS ? sh.warp_state[lane] : identity();
    const State winc = warp_inclusive(w);
    State wexcl = shfl_up(winc, 1);
    if (lane == 0) wexcl = identity();
    if (lane < NWARPS) sh.warp_state[lane] = wexcl;
    if (lane == NWARPS - 1) sh.tile_total = winc;
  }
  __syncthreads();
  *total = sh.tile_total;
  return combine(sh.warp_state[warp], excl);
}

// --- the tile records in device memory --------------------------------------
//
// Each tile writes two records, once each: its aggregate, then its
// inclusive prefix.  A record is 16 bytes, two 64-bit words that each carry
// a written bit:
//   word 0: c1 << 32 | ends << 2 | whole << 1 | 1
//   word 1: c2 << 32 | (last + 1) << 1 | 1
// (ends < 2^30 and last < 2^31 - 1, as n < 2^31), with `whole` (no space in
// the span) standing for a = P^bytes, and a = 0 otherwise.  An aligned 64-bit access is single-copy atomic (a 16-byte
// access is two of them, in no set order), so a reader that finds both
// bits set holds the whole record.  No fence is needed: no other data
// rides on a record.

__device__ __forceinline__ void store_record(ulonglong2* p, const State& s) {
  const unsigned long long w0 = (unsigned long long)s.c1 << 32 |
                                (unsigned long long)s.ends << 2 |
                                (s.a1 != 0u ? 2ull : 0ull) | 1ull;
  const unsigned long long w1 =
      (unsigned long long)s.c2 << 32 |
      (unsigned long long)(uint32_t)(s.last + 1) << 1 | 1ull;
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};"
               :: "l"(p), "l"(w0), "l"(w1) : "memory");
}

__device__ __forceinline__ ulonglong2 load_record(const ulonglong2* p) {
  ulonglong2 r;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(r.x), "=l"(r.y) : "l"(p) : "memory");
  return r;
}

__device__ __forceinline__ bool written(const ulonglong2& r) {
  return (r.x & r.y & 1ull) != 0ull;
}

// The state in a record that spans `tiles` whole tiles.
__device__ __forceinline__ State unpack(const ulonglong2& r, uint32_t tiles) {
  State s;
  s.c1 = (uint32_t)(r.x >> 32);
  s.c2 = (uint32_t)(r.y >> 32);
  s.ends = (int)((uint32_t)r.x >> 2);
  s.last = (int)((uint32_t)r.y >> 1) - 1;
  const bool whole = (r.x >> 1) & 1ull;
  s.a1 = whole ? pow_u32(P1_TILE, tiles) : 0u;
  s.a2 = whole ? pow_u32(P2_TILE, tiles) : 0u;
  return s;
}

// Warp 0: the exclusive prefix of tile t > 0.  Each step reads the records
// of the 32 tiles before the window's end (lane i: tile end - i), waits
// until each has written one, and composes the aggregates back to the
// nearest inclusive prefix; with none in the window it moves 32 tiles
// back.  Tile 0 writes only its prefix, so the walk ends.
__device__ State look_back(int t, const ulonglong2* agg,
                           const ulonglong2* pre) {
  const int lane = threadIdx.x & 31;
  State acc = identity();  // the tiles after the window, up to t - 1
  for (int end = t - 1;; end -= 32) {
    const int idx = end - lane;
    bool prefix = false;
    State s = identity();
    if (idx >= 0) {
      ulonglong2 p, a;
      for (;;) {
        p = load_record(pre + idx);
        a = load_record(agg + idx);
        if (written(p) || written(a)) break;
        __nanosleep(32);
      }
      prefix = written(p);
      s = prefix ? unpack(p, idx + 1) : unpack(a, 1);
    }
    const uint32_t prefixes = __ballot_sync(FULL, prefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    if (lane > stop) s = identity();
    // in tile order: a higher lane's tile comes first
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const State o = shfl_down(s, d);
      if (lane + d < 32) s = combine(o, s);
    }
    acc = combine(shfl_idx(s, 0), acc);
    if (prefixes) return acc;
  }
}

// --- bytes ------------------------------------------------------------------

// Bit 7 of each byte of w: set where the byte lies in [lo, hi] (both
// below 0x80).  Each byte of w | 0x80808080 is at least 0x80, so no borrow
// crosses a byte; bytes from 0x80 up are outside.
__device__ __forceinline__ uint32_t in_range4(uint32_t w, uint32_t lo,
                                              uint32_t hi) {
  const uint32_t h = w | 0x80808080u;
  return (h - lo * 0x01010101u) & ~(h - (hi + 1u) * 0x01010101u) & ~w &
         0x80808080u;
}

// 4 bits, one per byte of w: set where the byte is not a space
// (' ' or \t..\r).
__device__ __forceinline__ uint32_t nonspace4(uint32_t w) {
  const uint32_t sp = in_range4(w, 0x20u, 0x20u) | in_range4(w, 9u, 13u);
  // gather bit 7 of each byte into bits 28..31 (no carries reach them)
  return ~(((sp >> 7) * 0x10204080u) >> 28) & 0xFu;
}

// ascii lower of each byte of w
__device__ __forceinline__ uint32_t lower4(uint32_t w) {
  return w | (in_range4(w, 0x41u, 0x5Au) >> 2);
}

__device__ __forceinline__ bool is_space(uint32_t b) {
  return b == 32u || (b >= 9u && b <= 13u);
}

// The 32 bytes of a thread at i0 (16-byte aligned); bytes past n read as
// spaces.
__device__ __forceinline__ void load_bytes(const uint8_t* chunk, long long n,
                                           long long i0, uint32_t (&w)[WORDS]) {
  if (i0 + BYTES_PER_THREAD <= n) {
    const uint4* p = reinterpret_cast<const uint4*>(chunk + i0);
    const uint4 u = __ldg(p), v = __ldg(p + 1);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    w[4] = v.x; w[5] = v.y; w[6] = v.z; w[7] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < WORDS; ++q) {
      uint32_t x = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const long long i = i0 + 4 * q + b;
        x |= (i < n ? (uint32_t)chunk[i] : 32u) << (8 * b);
      }
      w[q] = x;
    }
  }
}

// --- stores -----------------------------------------------------------------

// p[0, count) = value(0 .. count-1), by `nth` threads of ids `tid`: 16-byte
// stores where p is 16-byte aligned, scalar stores at the head and the
// tail (each under 4 rows, so nth >= 4).
template <typename F>
__device__ __forceinline__ void store_run(uint32_t* p, int count, int tid,
                                          int nth, F value) {
  if (count <= 0) return;
  const int head =
      min(count, (int)(((16u - ((uint32_t)(uintptr_t)p & 15u)) & 15u) >> 2));
  if (tid < head) p[tid] = value(tid);
  const int body = (count - head) >> 2;
  uint4* v = reinterpret_cast<uint4*>(p + head);
  for (int i = tid; i < body; i += nth) {
    const int r = head + 4 * i;
    v[i] = make_uint4(value(r), value(r + 1), value(r + 2), value(r + 3));
  }
  const int tail = head + 4 * body + tid;
  if (tail < count) p[tail] = value(tail);
}

// the padding rows [from, to)
__device__ __forceinline__ void fill_rows(uint32_t* t_hi, uint32_t* t_lo,
                                          uint32_t* t_start, long long from,
                                          long long to, int tid, int nth) {
  const int count = (int)(to - from);
  store_run(t_hi + from, count, tid, nth, [](int) { return SENTINEL; });
  store_run(t_lo + from, count, tid, nth, [](int) { return SENTINEL; });
  store_run(t_start + from, count, tid, nth, [](int) { return INT32_MAX_; });
}

// Padding rows a tile leaves to be written: a range of its own and its
// slice of the rows past any chunk's reach.
struct Pending {
  long long lo, hi, slice_lo, slice_hi;
};

__device__ __forceinline__ void fill_pending(uint32_t* t_hi, uint32_t* t_lo,
                                             uint32_t* t_start,
                                             const Pending& p, int tid,
                                             int nth) {
  fill_rows(t_hi, t_lo, t_start, p.lo, p.hi, tid, nth);
  fill_rows(t_hi, t_lo, t_start, p.slice_lo, p.slice_hi, tid, nth);
}

// the whole of a tile's bytes into L2, ahead of the block that takes it
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(p), "r"(bytes) : "memory");
}

// A row slot from which every row is padding, given the token ends so far
// and the bytes still to come (m bytes end at most ceil(m/2) tokens).
__device__ __forceinline__ long long pad_bound(long long ends,
                                               long long bytes_left,
                                               long long max_tokens) {
  return min(max_tokens, ends + (bytes_left > 0 ? (bytes_left + 1) / 2 : 0));
}

// --- the kernels ------------------------------------------------------------

__device__ __forceinline__ void process_tile(
    int t, const uint8_t* __restrict__ chunk, long long n, int tiles,
    long long max_tokens, uint32_t* ticket, ulonglong2* agg, ulonglong2* pre,
    uint32_t* t_hi, uint32_t* t_lo, uint32_t* t_start,
    int* n_tokens, uint32_t* rows, Shared& sh, Pending& pending) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)t * TILE;
  const long long i0 = base + (long long)threadIdx.x * BYTES_PER_THREAD;
  if (threadIdx.x == 0) {
    // the tile a block will likely take one round of the grid later
    const long long ahead = base + (long long)gridDim.x * TILE;
    const long long bytes = min((long long)TILE, n - ahead) & ~15LL;
    if (bytes > 0) prefetch_l2(chunk + ahead, (uint32_t)bytes);
  }
  uint32_t w[WORDS];
  load_bytes(chunk, n, i0, w);

  // the 1-byte halo: from the neighbouring lanes, and at a warp's edges
  // from device memory (lines its neighbours load)
  uint32_t prev = __shfl_up_sync(FULL, w[WORDS - 1] >> 24, 1);
  uint32_t next = __shfl_down_sync(FULL, w[0] & 0xFFu, 1);
  if (lane == 0) prev = i0 > 0 && i0 - 1 < n ? chunk[i0 - 1] : 32u;
  if (lane == 31)
    next = i0 + BYTES_PER_THREAD < n ? chunk[i0 + BYTES_PER_THREAD] : 32u;

  // bit k: byte k is not a space / starts a token / ends a token
  uint32_t nsp = 0u;
#pragma unroll
  for (int q = 0; q < WORDS; ++q) {
    nsp |= nonspace4(w[q]) << (4 * q);
    w[q] = lower4(w[q]);
  }
  const uint32_t starts = nsp & ~((nsp << 1) | (is_space(prev) ? 0u : 1u));
  const uint32_t ends = nsp & ~((nsp >> 1) | (is_space(next) ? 0u : 1u) << 31);
  const int n_ends = __popc(ends);
  int tile_ends;
  int slot = block_exclusive_ends(n_ends, sh, &tile_ends);

  // one Horner walk: at each token end a row of the local hashes and the
  // last start seen; the first row's token may have come in from before
  // (no start at or before its end), and is fixed up below
  uint32_t* row = rows + slot;  // plane 0; the planes lie TILE_ROWS apart
  const int first_end = __ffs(ends) - 1;
  const bool carried =
      ends != 0u && (starts & (FULL >> (31 - first_end))) == 0u;
  const int carried_slot = slot;
  uint32_t c1 = 0u, c2 = 0u, begun = 0u;
#pragma unroll
  for (int k = 0; k < BYTES_PER_THREAD; ++k) {
    const uint32_t bit = 1u << k;
    const uint32_t v = ((w[k >> 2] >> (8 * (k & 3))) & 0xFFu) + 1u;
    c1 = nsp & bit ? c1 * P1 + v : 0u;
    c2 = nsp & bit ? c2 * P2 + v : 0u;
    if (starts & bit) begun = (uint32_t)i0 + k;
    if (ends & bit) {
      row[0] = c1;
      row[TILE_ROWS] = c2;
      row[2 * TILE_ROWS] = begun;
      ++row;
    }
  }

  State s;
  const bool whole = nsp == FULL;
  s.a1 = whole ? P1_THREAD : 0u;
  s.c1 = c1;
  s.a2 = whole ? P2_THREAD : 0u;
  s.c2 = c2;
  s.ends = n_ends;
  s.last = starts ? (int)(i0 + 31 - __clz(starts)) : -1;
  State total;
  const State before = block_exclusive(s, sh, &total);

  // warp 0 joins the chunk-wide scan; meanwhile the other warps write the
  // padding the block's previous tile left
  if (warp == 0) {
    State excl = identity();
    if (t == 0) {
      if (lane == 0) store_record(pre, total);
    } else {
      if (lane == 0) store_record(agg + t, total);
      excl = look_back(t, agg, pre);
      if (lane == 0) store_record(pre + t, combine(excl, total));
    }
    if (lane == 0) {
      sh.tile_prefix = excl;
      if (t == tiles - 1) *n_tokens = excl.ends + total.ends;
      // the padding rows that the bytes up to this tile's end rule out
      sh.pad_hi = pad_bound(excl.ends, n - base, max_tokens);
      sh.pad_lo = pad_bound(excl.ends + total.ends, n - base - TILE,
                            max_tokens);
    }
  } else {
    fill_pending(t_hi, t_lo, t_start, pending, threadIdx.x - 32,
                 THREADS - 32);
  }
  __syncthreads();

  uint32_t* rows_hi = rows;
  uint32_t* rows_lo = rows + TILE_ROWS;
  uint32_t* rows_st = rows + 2 * TILE_ROWS;
  if (carried) {
    const State x = combine(sh.tile_prefix, before);
    rows_hi[carried_slot] += pow_u32(P1, first_end + 1) * x.c1;
    rows_lo[carried_slot] += pow_u32(P2, first_end + 1) * x.c2;
    rows_st[carried_slot] = (uint32_t)x.last;
  }
  __syncthreads();

  if (warp > 0) {
    // the tile's rows to their slots, past max_tokens dropped; its share
    // of the padding is written while the block's next tile looks back
    const int tid = threadIdx.x - 32, nth = THREADS - 32;
    const long long row0 = sh.tile_prefix.ends;
    const int count = (int)min((long long)tile_ends, max_tokens - row0);
    store_run(t_hi + row0, count, tid, nth,
              [&](int i) { return rows_hi[i]; });
    store_run(t_lo + row0, count, tid, nth, [&](int i) {
      const uint32_t lo = rows_lo[i];
      return rows_hi[i] == SENTINEL && lo == SENTINEL ? SENTINEL - 1u : lo;
    });
    store_run(t_start + row0, count, tid, nth,
              [&](int i) { return rows_st[i]; });
    // rows no chunk of n bytes can reach: a slice per tile
    const long long reach = pad_bound(0, n, max_tokens);
    const long long span = max_tokens - reach;
    pending = {sh.pad_lo, sh.pad_hi, reach + span * t / tiles,
               reach + span * (t + 1) / tiles};
  } else if (threadIdx.x == 0) {
    sh.tile = (int)atomicAdd(ticket, 1u);
  }
  __syncthreads();  // the rows and sh are the next tile's
}

__global__ void __launch_bounds__(THREADS, 4)
    scan_tiles(const uint8_t* __restrict__ chunk, long long n, int tiles,
               long long max_tokens, uint32_t* ticket, ulonglong2* agg,
               ulonglong2* pre, uint32_t* t_hi, uint32_t* t_lo,
               uint32_t* t_start, int* n_tokens) {
  extern __shared__ uint4 dynamic_smem[];
  __shared__ Shared sh;
  uint32_t* rows = reinterpret_cast<uint32_t*>(dynamic_smem);
  Pending pending = {0, 0, 0, 0};
  if (threadIdx.x == 0) sh.tile = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  for (int t = sh.tile; t < tiles; t = sh.tile)
    process_tile(t, chunk, n, tiles, max_tokens, ticket, agg, pre,
                 t_hi, t_lo, t_start, n_tokens, rows, sh, pending);
  if (threadIdx.x >= 32)
    fill_pending(t_hi, t_lo, t_start, pending, threadIdx.x - 32,
                 THREADS - 32);
}

long long tiles_of(long long n) { return (n + TILE - 1) / TILE; }

// the ticket (16 bytes), then each tile's aggregate and inclusive prefix
// records: all zero until written
long long scratch_used(long long tiles) { return 16 + 2 * 16 * tiles; }

// The persistent grid's blocks on `device`: as many as fit on its SMs at
// once.  Worked out once per device, with the dynamic shared memory the
// kernel is allowed there; 0 until then.
constexpr int MAX_DEVICES = 64;
std::atomic<int> grid_blocks[MAX_DEVICES];

cudaError_t resident_blocks(int device, int* blocks) {
  if (device >= 0 && device < MAX_DEVICES) {
    *blocks = grid_blocks[device].load(std::memory_order_relaxed);
    if (*blocks > 0) return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      scan_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, ROW_SMEM);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_tiles,
                                                      THREADS, ROW_SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (device >= 0 && device < MAX_DEVICES)
    grid_blocks[device].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace tokenize_compact

extern "C" {

// The launch's layout, for callers that place data on its edges: threads
// per block, bytes per thread (a tile is their product) and dynamic shared
// bytes per block (the staged rows).
void moxt_tokenize_compact_layout(int* threads, int* bytes_per_thread,
                                  int* dynamic_smem) {
  using namespace tokenize_compact;
  *threads = THREADS;
  *bytes_per_thread = BYTES_PER_THREAD;
  *dynamic_smem = ROW_SMEM;
}

// Bytes of device scratch the launch needs for an n-byte chunk (the ticket
// and the tiles' records), 256-byte aligned.
long long moxt_tokenize_compact_scratch(long long n) {
  using namespace tokenize_compact;
  return (scratch_used(tiles_of(n < 1 ? 1 : n)) + 255) / 256 * 256;
}

// chunk: n bytes on `device`, 16-byte aligned; scratch of
// moxt_tokenize_compact_scratch(n) bytes; t_hi, t_lo, t_start: max_tokens
// each, 4-byte aligned; n_tokens: one int.  Launches on `stream` and does
// not synchronise.  Returns the first CUDA error (0 = launched).
int moxt_tokenize_compact(int device, const void* chunk, long long n,
                          long long max_tokens, void* scratch, void* t_hi,
                          void* t_lo, void* t_start, void* n_tokens,
                          void* stream) {
  using namespace tokenize_compact;
  if (n < 0 || n >= 0x7FFFFFFFLL || max_tokens < 1 ||
      max_tokens > 0x7FFFFFFFLL ||
      (reinterpret_cast<uintptr_t>(chunk) & 15u) != 0 ||
      ((reinterpret_cast<uintptr_t>(t_hi) | reinterpret_cast<uintptr_t>(t_lo) |
        reinterpret_cast<uintptr_t>(t_start)) & 3u) != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = tiles_of(n < 1 ? 1 : n);
  char* base = static_cast<char*>(scratch);
  ulonglong2* agg = reinterpret_cast<ulonglong2*>(base + 16);
  int blocks = 0;
  err = resident_blocks(device, &blocks);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(scratch, 0, scratch_used(tiles), s);
  if (err != cudaSuccess) return err;
  const long long grid = tiles < blocks ? tiles : blocks;
  scan_tiles<<<(unsigned)grid, THREADS, ROW_SMEM, s>>>(
      static_cast<const uint8_t*>(chunk), n, (int)tiles, max_tokens,
      reinterpret_cast<uint32_t*>(base), agg, agg + tiles,
      static_cast<uint32_t*>(t_hi), static_cast<uint32_t*>(t_lo),
      static_cast<uint32_t*>(t_start), static_cast<int*>(n_tokens));
  return cudaGetLastError();
}

const char* moxt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
