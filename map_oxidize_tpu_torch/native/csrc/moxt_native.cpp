// Native map hot loop: tokenize + hash + in-chunk combine in one pass.
//
// This is the TPU-native framework's equivalent of the reference's compiled
// map path (the Rust `count_words`, the reference's src/main.rs:94-101, which
// allocates a lowercased String per token and upserts a std HashMap).  The
// design here is shaped by two measured facts about the build machine:
//
//   * one host core — map throughput is single-thread throughput;
//   * host->TPU link ~26-37 MB/s — raw text can never be shipped to the chip
//     at a competitive rate, so the host loop IS the map phase and must run
//     at hundreds of MB/s.
//
// Structure (per chunk):
//
//   pass 1  SIMD sweep: ASCII-lowercase into a scratch buffer and emit a
//           whitespace bitmap (1 bit/byte).  AVX-512BW when available.
//   pass 2  walk the bitmap with tzcnt to extract token runs; hash each
//           token (moxt64, below); upsert into an open-addressed table whose
//           slots hold the first 16 key bytes INLINE — the common repeat-hit
//           compares two registers instead of chasing an arena pointer.
//
// Chunk outputs are columnar (hash, count) arrays; token strings go to a
// persistent hash->bytes dictionary (per mapper state, across chunks) that
// Python drains as a delta after each chunk — so steady-state chunks hand
// back ~no strings at all.
//
// Semantics contract (tests enforce bit-identity with the Python fallback):
//   * token boundaries == Python bytes.split(): runs of {' ','\t','\n','\r',
//     '\v','\f'} separate tokens, no empty tokens;
//   * lowercase == Python bytes.lower(): only bytes 'A'..'Z' change;
//   * hash == ops/hashing.py moxt64_bytes (spec below);
//   * n-gram keys (n>=2) are tokens joined by a single ' ' (workloads/
//     bigram.py), hashed over the joined bytes;
//   * equal 64-bit hashes with different key bytes abort with error=1 — full
//     collision detection, same guarantee HashDictionary.add gives.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <immintrin.h>

namespace {

// ---------------------------------------------------------------------------
// moxt64: the canonical 64-bit key hash (mirrored by ops/hashing.moxt64_bytes)
//
//   h = len * K3
//   for each 16-byte block (zero-padded past the end; >=1 round always):
//       h = fold128((w0 ^ K1 ^ h) * (w1 ^ K2 ^ rotl(h, 32)))
//   where fold128 xors the high and low halves of the 128-bit product
//   (wyhash-style — a plain 64-bit multiply only propagates differences
//   upward and measurably collided on structured bigram keys).
//   splitmix64 finalizer; h == 2^64-1 (the device padding SENTINEL64) is
//   remapped to 2^64-2 so no real key can masquerade as padding.
// ---------------------------------------------------------------------------

constexpr uint64_t kM1 = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t kM2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t kM3 = 0x165667B19E3779F9ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t moxt64_finish(uint64_t h) {
  h ^= h >> 30;
  h *= 0xBF58476D1CE4E5B9ULL;
  h ^= h >> 27;
  h *= 0x94D049BB133111EBULL;
  h ^= h >> 31;
  if (h == ~0ULL) h = ~0ULL - 1;  // SENTINEL64 guard
  return h;
}

inline uint64_t moxt64_round(uint64_t h, uint64_t w0, uint64_t w1) {
  unsigned __int128 m = (unsigned __int128)(w0 ^ kM1 ^ h) *
                        (w1 ^ kM2 ^ rotl64(h, 32));
  return (uint64_t)m ^ (uint64_t)(m >> 64);
}

// Load up to 16 bytes from p[0..n) into (w0, w1), zero-padded.
inline void load16_masked(const uint8_t* p, int64_t n, uint64_t* w0,
                          uint64_t* w1) {
#if defined(__AVX512BW__) && defined(__AVX512VL__)
  __mmask16 m = (n >= 16) ? (__mmask16)0xFFFF : (__mmask16)((1u << n) - 1);
  __m128i v = _mm_maskz_loadu_epi8(m, p);
  *w0 = (uint64_t)_mm_extract_epi64(v, 0);
  *w1 = (uint64_t)_mm_extract_epi64(v, 1);
#else
  uint8_t buf[16] = {0};
  memcpy(buf, p, n >= 16 ? 16 : (size_t)n);
  memcpy(w0, buf, 8);
  memcpy(w1, buf + 8, 8);
#endif
}

// Generic-length hash (n-gram keys, long tokens).
inline uint64_t moxt64(const uint8_t* p, int64_t n) {
  uint64_t h = (uint64_t)n * kM3;
  int64_t i = 0;
  do {
    uint64_t w0, w1;
    int64_t rem = n - i;
    if (rem >= 16) {
      memcpy(&w0, p + i, 8);
      memcpy(&w1, p + i + 8, 8);
    } else {
      load16_masked(p + i, rem, &w0, &w1);
    }
    h = moxt64_round(h, w0, w1);
    i += 16;
  } while (i < n);
  return moxt64_finish(h);
}

// ---------------------------------------------------------------------------
// Pass 1: lowercase + whitespace bitmap
// ---------------------------------------------------------------------------

inline bool is_ascii_space(uint8_t c) {
  return c == ' ' || (c >= '\t' && c <= '\r');
}

// low[0..n) = lowercased src with every whitespace byte normalized to ' ';
// ws bit i set iff src[i] is ASCII whitespace.  The normalization makes an
// n-gram window whose tokens are separated by single whitespace bytes (the
// overwhelmingly common case) ALREADY be the joined key "tok1 tok2..." as a
// contiguous span of `low` — the n-gram scans then hash it in place instead
// of memcpy-joining every window into scratch (measured 284 -> ~500+ MB/s
// on the bigram hash-only map).  Only token spans and (for contiguous
// windows) their single-byte separators are ever read back from `low`.
// ws has (n+63)/64 + 2 words: tail bits of the last real word are SET, the
// first pad word is ALL-ONES (a token ending exactly at a 64-aligned n still
// finds its end bit), and the second pad word is ZERO (a next-clear scan
// always lands; callers stop at start >= n).
void preprocess(const uint8_t* src, int64_t n, uint8_t* low, uint64_t* ws) {
  int64_t nwords = (n + 63) >> 6;
  int64_t i = 0;
#if defined(__AVX512BW__)
  const __m512i v9 = _mm512_set1_epi8(0x09), vd = _mm512_set1_epi8(0x0D);
  const __m512i vsp = _mm512_set1_epi8(0x20);
  const __m512i vA = _mm512_set1_epi8('A'), vZ = _mm512_set1_epi8('Z');
  const __m512i v32 = _mm512_set1_epi8(0x20);
  for (; i + 64 <= n; i += 64) {
    __m512i v = _mm512_loadu_si512(src + i);
    __mmask64 sp = _mm512_cmpeq_epi8_mask(v, vsp) |
                   (_mm512_cmpge_epu8_mask(v, v9) &
                    _mm512_cmple_epu8_mask(v, vd));
    __mmask64 up = _mm512_cmpge_epu8_mask(v, vA) &
                   _mm512_cmple_epu8_mask(v, vZ);
    _mm512_storeu_si512(
        low + i,
        _mm512_mask_blend_epi8(sp, _mm512_mask_add_epi8(v, up, v, v32), vsp));
    ws[i >> 6] = (uint64_t)sp;
  }
  if (i < n) {
    int64_t rem = n - i;
    __mmask64 lm = (rem >= 64) ? ~0ULL : ((~0ULL) >> (64 - rem));
    __m512i v = _mm512_maskz_loadu_epi8(lm, src + i);
    __mmask64 sp = _mm512_cmpeq_epi8_mask(v, vsp) |
                   (_mm512_cmpge_epu8_mask(v, v9) &
                    _mm512_cmple_epu8_mask(v, vd));
    __mmask64 up = _mm512_cmpge_epu8_mask(v, vA) &
                   _mm512_cmple_epu8_mask(v, vZ);
    _mm512_mask_storeu_epi8(
        low + i, lm,
        _mm512_mask_blend_epi8(sp, _mm512_mask_add_epi8(v, up, v, v32), vsp));
    // bytes past n count as whitespace so the final token terminates
    ws[i >> 6] = (uint64_t)sp | ~lm;
  }
#else
  for (int64_t w = 0; w < nwords; w++) ws[w] = 0;
  for (; i < n; i++) {
    uint8_t c = src[i];
    if (c >= 'A' && c <= 'Z') c += 32;
    if (is_ascii_space(src[i])) {
      c = ' ';
      ws[i >> 6] |= 1ULL << (i & 63);
    }
    low[i] = c;
  }
  if (n & 63) ws[nwords - 1] |= (~0ULL) << (n & 63);
#endif
  ws[nwords] = ~0ULL;    // next_set landing spot when n is 64-aligned
  ws[nwords + 1] = 0;    // next_clear landing spot past n
}

// First set bit at position >= pos.  Only called with a token start < n, and
// tail bits past n are set, so this always terminates within real words.
inline int64_t next_set(const uint64_t* ws, int64_t pos) {
  int64_t w = pos >> 6;
  uint64_t cur = ws[w] & (~0ULL << (pos & 63));
  while (cur == 0) cur = ws[++w];
  return (w << 6) + __builtin_ctzll(cur);
}

// First clear bit at position >= pos; the all-zero pad word bounds the scan.
inline int64_t next_clear(const uint64_t* ws, int64_t pos) {
  int64_t w = pos >> 6;
  uint64_t cur = ~ws[w] & (~0ULL << (pos & 63));
  while (cur == 0) cur = ~ws[++w];
  return (w << 6) + __builtin_ctzll(cur);
}

// ---------------------------------------------------------------------------
// Arena + open-addressed tables
// ---------------------------------------------------------------------------

struct Arena {
  uint8_t* data = nullptr;
  int64_t size = 0;
  int64_t cap = 0;

  int64_t append(const uint8_t* p, int64_t n) {
    if (size + n > cap) {
      int64_t nc = cap ? cap * 2 : 1 << 16;
      while (nc < size + n) nc *= 2;
      data = static_cast<uint8_t*>(realloc(data, nc));
      cap = nc;
    }
    memcpy(data + size, p, n);
    int64_t at = size;
    size += n;
    return at;
  }
  void reset() { size = 0; }
  void destroy() { free(data); }
};

// One slot: first 16 key bytes inline so the hot repeat-hit path compares
// registers, not arena memory.  `epoch` makes per-chunk clearing free.
// `aref` is 64-bit: the persistent dictionary arena can exceed 4 GiB of
// cumulative key bytes on wide-key-space jobs (e.g. huge bigram corpora).
struct Slot {
  uint64_t hash;
  uint64_t w0, w1;   // first 16 key bytes (zero-padded)
  int64_t aref;      // arena offset of the full key bytes
  uint32_t count;
  uint32_t len;
  uint32_t epoch;
  uint32_t pad_;
};

struct Table {
  Slot* slots = nullptr;
  int64_t cap = 0;    // power of two
  int64_t n = 0;      // live entries in the current epoch
  uint32_t epoch = 1;

  void init(int64_t c) {
    cap = c;
    slots = static_cast<Slot*>(calloc(c, sizeof(Slot)));
    n = 0;
    epoch = 1;
  }
  void destroy() { free(slots); }

  void new_epoch() {
    epoch++;
    n = 0;
    if (epoch == 0) {  // u32 wrap: hard-clear once every 4B chunks
      memset(slots, 0, cap * sizeof(Slot));
      epoch = 1;
    }
  }

  void grow() {
    Table bigger;
    bigger.init(cap * 2);
    bigger.epoch = epoch;
    for (int64_t i = 0; i < cap; i++) {
      const Slot& s = slots[i];
      if (s.epoch != epoch || s.count == 0) continue;
      int64_t j = s.hash & (bigger.cap - 1);
      while (bigger.slots[j].epoch == epoch && bigger.slots[j].count)
        j = (j + 1) & (bigger.cap - 1);
      bigger.slots[j] = s;
    }
    bigger.n = n;
    destroy();
    *this = bigger;
  }
};

// Upsert outcome
enum { UP_OK = 0, UP_COLLISION = 1 };

// ---------------------------------------------------------------------------
// Mapper state (exposed as an opaque handle)
// ---------------------------------------------------------------------------

// Unicode tokenizer tables (set once via moxt_set_unicode; generated on the
// Python side from str.lower()/str.isspace() so parity with the Python
// fallback holds by construction, not by re-implementing Unicode here).
struct UnicodeTables {
  // whitespace: bitmap over codepoints 0..0x3000 inclusive (str.isspace()'s
  // entire set fits — max member is U+3000 IDEOGRAPHIC SPACE)
  uint64_t ws_bits[(0x3001 + 63) / 64] = {0};
  // lowercase: open-addressed cp -> (offset, len) into utf8 blob
  uint32_t* map_cp = nullptr;   // keys (+1 so 0 means empty slot)
  uint32_t* map_off = nullptr;
  uint8_t* map_len = nullptr;
  int64_t map_cap = 0;          // power of two
  uint8_t* blob = nullptr;
  int64_t blob_n = 0;

  // Final_Sigma context sets (str.lower() is context-sensitive for U+03A3
  // only): full-range bitmaps, 0x110000 bits = 136 KiB each
  uint64_t* cased_bits = nullptr;
  uint64_t* ign_bits = nullptr;

  bool is_ws(uint32_t cp) const {
    return cp <= 0x3000 && (ws_bits[cp >> 6] >> (cp & 63)) & 1;
  }
  bool is_cased(uint32_t cp) const {
    return cp <= 0x10FFFF && (cased_bits[cp >> 6] >> (cp & 63)) & 1;
  }
  bool is_ignorable(uint32_t cp) const {
    return cp <= 0x10FFFF && (ign_bits[cp >> 6] >> (cp & 63)) & 1;
  }
  // returns len of the lowercase expansion written to *out, or 0 = identity
  int lower(uint32_t cp, const uint8_t** out) const {
    if (!map_cap) return 0;
    int64_t j = (cp * 0x9E3779B1u) & (map_cap - 1);
    while (map_cp[j]) {
      if (map_cp[j] == cp + 1) {
        *out = blob + map_off[j];
        return map_len[j];
      }
      j = (j + 1) & (map_cap - 1);
    }
    return 0;
  }
  void destroy() {
    free(map_cp);
    free(map_off);
    free(map_len);
    free(blob);
    free(cased_bits);
    free(ign_bits);
  }
};

struct MoxtState {
  int32_t ngram = 1;
  Table chunk;        // per-chunk (hash -> count); epoch-cleared
  Table doc;          // per-DOC distinct set (docs mode): starts tiny so
                      // the per-token probe stays L1-resident — a ~12-term
                      // doc probed through the 3MB chunk table cost ~26
                      // ns/token of cache misses (round-4 decomposition,
                      // benchmarks/RESULTS.md); grows only when one doc
                      // exceeds half its capacity
  Arena chunk_arena;  // key bytes for the current chunk (reset per chunk)
  Table dict;         // persistent hash -> bytes across chunks
  Arena dict_arena;   // persistent key bytes (append-only, insert order)
  // unicode mode: transform buffer + tables (null tables = ascii mode)
  bool unicode = false;
  UnicodeTables utab;
  uint8_t* utrans = nullptr;
  int64_t utrans_cap = 0;
  // dictionary append log (insert order == dict_arena order)
  uint64_t* log_h = nullptr;
  uint32_t* log_len = nullptr;
  int64_t log_n = 0, log_cap = 0;
  int64_t pending_from = 0;        // log cursor for delta reads
  int64_t pending_bytes_from = 0;  // dict_arena cursor for delta reads
  // scratch buffers (sized to the largest chunk seen)
  uint8_t* low = nullptr;
  uint64_t* ws = nullptr;
  int64_t scratch_cap = 0;
  // n-gram scratch
  uint8_t* key = nullptr;
  int64_t key_cap = 0;
  // last-chunk stats
  int64_t n_tokens = 0;
  int32_t error = 0;
  // inverted-index mode: (term hash, doc id) pair emission buffers
  uint64_t* pair_h = nullptr;
  int64_t* pair_doc = nullptr;
  int64_t pair_n = 0, pair_cap = 0;
  // hash-only mode: raw n-gram hash emission buffer (no tables, no strings)
  uint64_t* hx_h = nullptr;
  int64_t hx_n = 0, hx_cap = 0;
  // hll mode: 2^p max-rank registers folded in-scan (distinct workload)
  uint8_t* hll_regs = nullptr;
  int32_t hll_p = 0;  // current allocation's p; 0 = unallocated
  // hash->bytes resolver: open-addressed query set + found-key storage.
  // q_ref[j] == -1 means wanted-but-unseen; >= 0 is the resolve_arena
  // offset of the first matching key's bytes.
  uint64_t* q_h = nullptr;
  int64_t* q_ref = nullptr;
  uint32_t* q_len = nullptr;
  int64_t q_cap = 0, q_n = 0;
  int64_t q_distinct = 0;       // distinct queried hashes (dup inputs merge)
  int64_t* found = nullptr;     // q-table slots in discovery order
  int64_t found_n = 0, found_cap = 0;
  Arena res_arena;

  void hx_push(uint64_t h) {
    if (hx_n == hx_cap) {
      hx_cap = hx_cap ? hx_cap * 2 : 1 << 16;
      hx_h = static_cast<uint64_t*>(realloc(hx_h, hx_cap * 8));
    }
    hx_h[hx_n++] = h;
  }

  void pair_push(uint64_t h, int64_t doc) {
    if (pair_n == pair_cap) {
      pair_cap = pair_cap ? pair_cap * 2 : 1 << 14;
      pair_h = static_cast<uint64_t*>(realloc(pair_h, pair_cap * 8));
      pair_doc = static_cast<int64_t*>(realloc(pair_doc, pair_cap * 8));
    }
    pair_h[pair_n] = h;
    pair_doc[pair_n] = doc;
    pair_n++;
  }

  void log_push(uint64_t h, uint32_t len) {
    if (log_n == log_cap) {
      log_cap = log_cap ? log_cap * 2 : 1 << 12;
      log_h = static_cast<uint64_t*>(realloc(log_h, log_cap * 8));
      log_len = static_cast<uint32_t*>(realloc(log_len, log_cap * 4));
    }
    log_h[log_n] = h;
    log_len[log_n] = len;
    log_n++;
  }
};

// Insert one key into the persistent dictionary if novel, logging it for
// the Python-side delta drain.  Detects cross-chunk 64-bit collisions.
inline int dict_upsert(MoxtState* st, uint64_t h, uint64_t w0, uint64_t w1,
                       uint32_t len, const uint8_t* bytes) {
  Table& d = st->dict;
  if (d.n * 2 >= d.cap) d.grow();
  int64_t j = h & (d.cap - 1);
  for (;;) {
    Slot& t = d.slots[j];
    if (t.count == 0) {
      t.hash = h;
      t.w0 = w0;
      t.w1 = w1;
      t.count = 1;
      t.len = len;
      t.aref = st->dict_arena.append(bytes, len);
      t.epoch = 1;
      d.n++;
      st->log_push(h, len);
      return UP_OK;
    }
    if (t.hash == h) {
      if (t.len != len || t.w0 != w0 || t.w1 != w1 ||
          (len > 16 &&
           memcmp(st->dict_arena.data + t.aref, bytes, len) != 0))
        return UP_COLLISION;
      return UP_OK;  // already known
    }
    j = (j + 1) & (d.cap - 1);
  }
}

// Insert the chunk table's live entries into the persistent dictionary
// (novel keys only), logging them for the Python-side delta drain.
inline int dict_absorb(MoxtState* st) {
  const Table& c = st->chunk;
  for (int64_t i = 0; i < c.cap; i++) {
    const Slot& s = c.slots[i];
    if (s.epoch != c.epoch || s.count == 0) continue;
    if (dict_upsert(st, s.hash, s.w0, s.w1, s.len,
                    st->chunk_arena.data + s.aref) != UP_OK)
      return UP_COLLISION;
  }
  return UP_OK;
}

// Upsert one key (bytes at p, length len, first-16 words w0/w1, hash h) into
// the chunk table.
inline int chunk_upsert(MoxtState* st, const uint8_t* p, uint32_t len,
                        uint64_t w0, uint64_t w1, uint64_t h) {
  Table& t = st->chunk;
  if (t.n * 2 >= t.cap) t.grow();
  int64_t mask = t.cap - 1;
  int64_t j = h & mask;
  for (;;) {
    Slot& s = t.slots[j];
    if (s.epoch != t.epoch || s.count == 0) {
      s.hash = h;
      s.w0 = w0;
      s.w1 = w1;
      s.count = 1;
      s.len = len;
      s.aref = st->chunk_arena.append(p, len);
      s.epoch = t.epoch;
      t.n++;
      return UP_OK;
    }
    if (s.hash == h) {
      if (s.len == len && s.w0 == w0 && s.w1 == w1 &&
          (len <= 16 ||
           memcmp(st->chunk_arena.data + s.aref, p, len) == 0)) {
        s.count++;
        return UP_OK;
      }
      return UP_COLLISION;
    }
    j = (j + 1) & mask;
  }
}

// Decode one UTF-8 codepoint at src[i..n): writes (cp, len); returns false
// on invalid input (stray continuation, truncation, overlong, surrogate,
// out of range) — the strict checks CPython's utf-8 decoder applies.
inline bool decode_cp(const uint8_t* src, int64_t n, int64_t i, uint32_t* cp,
                      int* len) {
  uint8_t c = src[i];
  if (c < 0x80) {
    *cp = c;
    *len = 1;
    return true;
  }
  uint32_t v;
  int l;
  if ((c & 0xE0) == 0xC0) {
    l = 2;
    v = c & 0x1F;
  } else if ((c & 0xF0) == 0xE0) {
    l = 3;
    v = c & 0x0F;
  } else if ((c & 0xF8) == 0xF0) {
    l = 4;
    v = c & 0x07;
  } else {
    return false;
  }
  if (i + l > n) return false;
  for (int k = 1; k < l; k++) {
    uint8_t cc = src[i + k];
    if ((cc & 0xC0) != 0x80) return false;
    v = (v << 6) | (cc & 0x3F);
  }
  if ((l == 2 && v < 0x80) || (l == 3 && v < 0x800) ||
      (l == 4 && v < 0x10000) || v > 0x10FFFF ||
      (v >= 0xD800 && v <= 0xDFFF))
    return false;
  *cp = v;
  *len = l;
  return true;
}

// UTF-8 transform for unicode mode: decode, map every Unicode-whitespace
// codepoint to one ASCII space and every cased codepoint to its lowercase
// expansion, copy everything else verbatim.  The output feeds the unchanged
// ASCII pipeline (its space-split + A-Z lowercase are no-ops on this
// normalized stream), which is exactly Python's
// ``chunk.decode('utf-8').lower().split()`` followed by utf-8 re-encoding.
// U+03A3 GREEK CAPITAL SIGMA follows CPython's Final_Sigma rule: lowercase
// to final form U+03C2 when the nearest non-case-ignorable neighbor before
// it is cased and the nearest after it is not (or absent); the cased /
// case-ignorable sets come from the Python-derived tables.
// Returns the output length, or -1 on invalid UTF-8 (the Python fallback
// raises UnicodeDecodeError on the same input).
int64_t transform_unicode(MoxtState* st, const uint8_t* src, int64_t n) {
  // worst-case growth is 1.5x (e.g. U+0130 -> "i" U+0307); 2x is safe slack
  int64_t need = 2 * n + 16;
  if (need > st->utrans_cap) {
    free(st->utrans);
    st->utrans = static_cast<uint8_t*>(malloc(need));
    st->utrans_cap = need;
  }
  const UnicodeTables& u = st->utab;
  uint8_t* out = st->utrans;
  int64_t w = 0;
  int64_t i = 0;
  // Final_Sigma backward state: whether the nearest preceding
  // non-case-ignorable codepoint was cased (O(1) as we stream forward)
  bool prev_cased = false;
  while (i < n) {
    uint8_t c = src[i];
    if (c < 0x80) {
      // ASCII fast path (also covers the \x1c..\x1f separators that
      // bytes.split() ignores but str.split() treats as whitespace)
      if (c == ' ' || (c >= 0x09 && c <= 0x0D) || (c >= 0x1C && c <= 0x1F)) {
        out[w++] = ' ';
        prev_cased = false;
      } else {
        bool up = (c >= 'A' && c <= 'Z');
        out[w++] = up ? c + 32 : c;
        if (!u.is_ignorable(c)) prev_cased = u.is_cased(c);
      }
      i++;
      continue;
    }
    uint32_t cp;
    int len;
    if (!decode_cp(src, n, i, &cp, &len)) return -1;
    if (u.is_ws(cp)) {
      out[w++] = ' ';
      prev_cased = false;
    } else if (cp == 0x3A3) {  // capital sigma: context-sensitive
      bool final_sigma = prev_cased;
      if (final_sigma) {
        // forward scan: first non-case-ignorable codepoint must not be cased
        int64_t j = i + len;
        while (j < n) {
          uint32_t cj;
          int lj;
          if (!decode_cp(src, n, j, &cj, &lj)) return -1;
          if (!u.is_ignorable(cj)) {
            final_sigma = !u.is_cased(cj);
            break;
          }
          j += lj;
        }
      }
      // U+03C2 / U+03C3, both 2-byte
      out[w++] = 0xCF;
      out[w++] = final_sigma ? 0x82 : 0x83;
      prev_cased = true;  // sigma is cased, not ignorable
    } else {
      const uint8_t* rep;
      int rl = u.lower(cp, &rep);
      if (rl) {
        memcpy(out + w, rep, rl);
        w += rl;
      } else {
        memcpy(out + w, src + i, len);
        w += len;
      }
      if (!u.is_ignorable(cp)) prev_cased = u.is_cased(cp);
    }
    i += len;
  }
  return w;
}

// Shared n-gram scan: tokenize (ascii or unicode-transformed), join each
// window of `ngram` tokens with single spaces into the key scratch, and
// hand (key bytes, len, hash) to `emit`.  Emit returns UP_OK or an error
// code, which aborts the scan.  This is the table-free core that both the
// hash-only mapper and the hash->bytes resolver run; the classic
// moxt_map keeps its fused upsert loop (measured: the chunk-table upsert
// is the part worth fusing, and hash-only mode exists precisely to skip it).
template <class Emit>
inline int32_t scan_ngrams(MoxtState* st, const uint8_t* data, int64_t len,
                           Emit&& emit) {
  st->n_tokens = 0;
  if (len <= 0) return 0;
  if (st->unicode) {
    int64_t tn = transform_unicode(st, data, len);
    if (tn < 0) return 3;
    data = st->utrans;
    len = tn;
    if (len <= 0) return 0;
  }
  if (len > st->scratch_cap) {
    free(st->low);
    free(st->ws);
    st->low = static_cast<uint8_t*>(malloc(len + 64));
    st->ws = static_cast<uint64_t*>(malloc((((len + 63) >> 6) + 2) * 8));
    st->scratch_cap = len;
  }
  preprocess(data, len, st->low, st->ws);
  const uint8_t* low = st->low;
  const uint64_t* ws = st->ws;
  const int32_t ngram = st->ngram;
  if (ngram > 16) return 2;

  struct Span {
    int64_t at;
    uint32_t len;
  };
  Span ring[16];
  int32_t filled = 0;
  int64_t n_tokens = 0;
  int64_t pos = 0;
  int rc = UP_OK;
  if (ngram == 2) {
    // dedicated bigram loop: two span scalars instead of the ring (the
    // memmove + per-window loops of the general path cost ~25% of the
    // scan at bigram shapes)
    int64_t pat = -1;
    uint32_t plen = 0;
    while (rc == UP_OK) {
      int64_t start = next_clear(ws, pos);
      if (start >= len) break;
      int64_t end = next_set(ws, start);
      pos = end + 1;
      n_tokens++;
      uint32_t tlen = (uint32_t)(end - start);
      if (pat >= 0) {
        int64_t klen;
        const uint8_t* kp;
        if (start == pat + (int64_t)plen + 1) {
          kp = low + pat;  // separator normalized to ' ' by preprocess
          klen = end - pat;
        } else {
          klen = (int64_t)plen + 1 + tlen;
          if (klen > st->key_cap) {
            int64_t nc = st->key_cap ? st->key_cap : 1 << 12;
            while (nc < klen) nc *= 2;
            st->key = static_cast<uint8_t*>(realloc(st->key, nc));
            st->key_cap = nc;
          }
          memcpy(st->key, low + pat, plen);
          st->key[plen] = ' ';
          memcpy(st->key + plen + 1, low + start, tlen);
          kp = st->key;
        }
        uint64_t h;
        if (klen <= 16) {
          uint64_t w0, w1;
          load16_masked(kp, klen, &w0, &w1);
          h = moxt64_finish(moxt64_round((uint64_t)klen * kM3, w0, w1));
        } else {
          h = moxt64(kp, klen);
        }
        rc = emit(kp, (uint32_t)klen, h);
      }
      pat = start;
      plen = tlen;
    }
    st->n_tokens = n_tokens;
    return rc == UP_OK ? 0 : rc;
  }
  while (rc == UP_OK) {
    int64_t start = next_clear(ws, pos);
    if (start >= len) break;
    int64_t end = next_set(ws, start);
    pos = end + 1;
    n_tokens++;
    if (ngram == 1) {
      uint32_t tlen = (uint32_t)(end - start);
      uint64_t h;
      if (tlen <= 16) {
        uint64_t w0, w1;
        load16_masked(low + start, tlen, &w0, &w1);
        h = moxt64_finish(moxt64_round((uint64_t)tlen * kM3, w0, w1));
      } else {
        h = moxt64(low + start, tlen);
      }
      rc = emit(low + start, tlen, h);
      continue;
    }
    if (filled == ngram) {
      memmove(ring, ring + 1, (ngram - 1) * sizeof(Span));
      filled--;
    }
    ring[filled].at = start;
    ring[filled].len = (uint32_t)(end - start);
    filled++;
    if (filled < ngram) continue;
    int64_t klen = ngram - 1;
    bool contig = true;
    for (int32_t k = 0; k < ngram; k++) {
      klen += ring[k].len;
      if (k && ring[k].at != ring[k - 1].at + (int64_t)ring[k - 1].len + 1)
        contig = false;
    }
    const uint8_t* kp;
    if (contig) {
      // single-byte separators: preprocess normalized them to ' ', so the
      // joined key already sits contiguously in `low` — no copy, and the
      // hash over these bytes is byte-identical to the scratch join's
      kp = low + ring[0].at;
    } else {
      if (klen > st->key_cap) {
        int64_t nc = st->key_cap ? st->key_cap : 1 << 12;
        while (nc < klen) nc *= 2;
        st->key = static_cast<uint8_t*>(realloc(st->key, nc));
        st->key_cap = nc;
      }
      int64_t w = 0;
      for (int32_t k = 0; k < ngram; k++) {
        if (k) st->key[w++] = ' ';
        memcpy(st->key + w, low + ring[k].at, ring[k].len);
        w += ring[k].len;
      }
      kp = st->key;
    }
    uint64_t h;
    if (klen <= 16) {  // == moxt64(kp, klen), skipping the general loop
      uint64_t w0, w1;
      load16_masked(kp, klen, &w0, &w1);
      h = moxt64_finish(moxt64_round((uint64_t)klen * kM3, w0, w1));
    } else {
      h = moxt64(kp, klen);
    }
    rc = emit(kp, (uint32_t)klen, h);
  }
  st->n_tokens = n_tokens;
  return rc == UP_OK ? 0 : rc;
}

}  // namespace

extern "C" {

// Install the unicode tables (whitespace codepoints; lowercase map as
// parallel arrays cp / blob-offset, with offs[n_map] = total blob bytes;
// cased / case-ignorable codepoint lists for the Final_Sigma rule).
// Must be called before the first unicode-mode moxt_map.
int32_t moxt_set_unicode(MoxtState* st, const uint32_t* ws_cps, int64_t n_ws,
                         const uint32_t* map_cps, const int64_t* map_offs,
                         const uint8_t* map_bytes, int64_t n_map,
                         const uint32_t* cased_cps, int64_t n_cased,
                         const uint32_t* ign_cps, int64_t n_ign) {
  if (!st) return 2;
  UnicodeTables& u = st->utab;
  // idempotent re-call: release any previous tables and clear the ws bitmap
  // (a second call used to leak the old tables and OR new ws bits in)
  u.destroy();
  u = UnicodeTables();
  for (int64_t i = 0; i < n_ws; i++) {
    uint32_t cp = ws_cps[i];
    if (cp > 0x3000) return 2;  // table contract: isspace() max is U+3000
    u.ws_bits[cp >> 6] |= 1ULL << (cp & 63);
  }
  constexpr int64_t kBitWords = (0x110000 + 63) / 64;
  u.cased_bits = static_cast<uint64_t*>(calloc(kBitWords, 8));
  u.ign_bits = static_cast<uint64_t*>(calloc(kBitWords, 8));
  if (!u.cased_bits || !u.ign_bits) return 4;
  for (int64_t i = 0; i < n_cased; i++) {
    uint32_t cp = cased_cps[i];
    if (cp > 0x10FFFF) return 2;
    u.cased_bits[cp >> 6] |= 1ULL << (cp & 63);
  }
  for (int64_t i = 0; i < n_ign; i++) {
    uint32_t cp = ign_cps[i];
    if (cp > 0x10FFFF) return 2;
    u.ign_bits[cp >> 6] |= 1ULL << (cp & 63);
  }
  int64_t cap = 1;
  while (cap < 4 * n_map) cap <<= 1;
  u.map_cap = cap;
  u.map_cp = static_cast<uint32_t*>(calloc(cap, 4));
  u.map_off = static_cast<uint32_t*>(malloc(cap * 4));
  u.map_len = static_cast<uint8_t*>(malloc(cap));
  u.blob_n = map_offs[n_map];
  u.blob = static_cast<uint8_t*>(malloc(u.blob_n ? u.blob_n : 1));
  if (!u.map_cp || !u.map_off || !u.map_len || !u.blob) return 4;
  memcpy(u.blob, map_bytes, u.blob_n);
  for (int64_t i = 0; i < n_map; i++) {
    uint32_t cp = map_cps[i];
    int64_t j = (cp * 0x9E3779B1u) & (cap - 1);
    while (u.map_cp[j]) j = (j + 1) & (cap - 1);
    u.map_cp[j] = cp + 1;
    u.map_off[j] = (uint32_t)map_offs[i];
    u.map_len[j] = (uint8_t)(map_offs[i + 1] - map_offs[i]);
  }
  st->unicode = true;
  return 0;
}

MoxtState* moxt_new(int32_t ngram) {
  if (ngram < 1) return nullptr;
  MoxtState* st = new MoxtState();
  st->ngram = ngram;
  st->chunk.init(1 << 16);
  st->doc.init(1 << 8);
  st->dict.init(1 << 16);
  return st;
}

void moxt_free(MoxtState* st) {
  if (!st) return;
  st->chunk.destroy();
  st->doc.destroy();
  st->dict.destroy();
  st->chunk_arena.destroy();
  st->dict_arena.destroy();
  st->utab.destroy();
  free(st->utrans);
  free(st->log_h);
  free(st->log_len);
  free(st->low);
  free(st->ws);
  free(st->key);
  free(st->pair_h);
  free(st->pair_doc);
  free(st->hx_h);
  free(st->hll_regs);
  free(st->q_h);
  free(st->q_ref);
  free(st->q_len);
  free(st->found);
  st->res_arena.destroy();
  delete st;
}

// Map one chunk.  Returns 0 ok, 1 = 64-bit hash collision (job must abort;
// the Python paths raise on the same condition), 2 = bad state, 3 = invalid
// UTF-8 in unicode mode (the Python fallback raises UnicodeDecodeError).
int32_t moxt_map(MoxtState* st, const uint8_t* data, int64_t len) {
  if (!st || st->error == 2) return 2;
  st->error = 0;
  st->n_tokens = 0;
  st->chunk.new_epoch();
  st->chunk_arena.reset();
  if (len <= 0) return 0;
  if (st->unicode) {
    int64_t tn = transform_unicode(st, data, len);
    if (tn < 0) {
      st->error = 3;
      return 3;
    }
    data = st->utrans;
    len = tn;
    if (len <= 0) return 0;
  }

  if (len > st->scratch_cap) {
    free(st->low);
    free(st->ws);
    st->low = static_cast<uint8_t*>(malloc(len + 64));
    st->ws = static_cast<uint64_t*>(malloc((((len + 63) >> 6) + 2) * 8));
    st->scratch_cap = len;
  }
  preprocess(data, len, st->low, st->ws);
  const uint8_t* low = st->low;
  const uint64_t* ws = st->ws;
  const int32_t ngram = st->ngram;

  int64_t n_tokens = 0;
  int rc = UP_OK;

  if (ngram == 1) {
    int64_t pos = 0;
    while (rc == UP_OK) {
      int64_t start = next_clear(ws, pos);
      if (start >= len) break;
      int64_t end = next_set(ws, start);
      uint32_t tlen = (uint32_t)(end - start);
      n_tokens++;
      uint64_t w0, w1, h;
      if (tlen <= 16) {
        load16_masked(low + start, tlen, &w0, &w1);
        h = moxt64_finish(moxt64_round((uint64_t)tlen * kM3, w0, w1));
      } else {
        load16_masked(low + start, 16, &w0, &w1);
        h = moxt64(low + start, tlen);
      }
      rc = chunk_upsert(st, low + start, tlen, w0, w1, h);
      pos = end + 1;
    }
  } else {
    // ring of the last `ngram` token spans in the lowercased buffer
    struct Span {
      int64_t at;
      uint32_t len;
    };
    Span ring[16];  // ngram capped at 16 by moxt_new callers (validated below)
    if (ngram > 16) {
      st->error = 2;
      return 2;
    }
    int32_t filled = 0;
    int64_t pos = 0;
    while (rc == UP_OK) {
      int64_t start = next_clear(ws, pos);
      if (start >= len) break;
      int64_t end = next_set(ws, start);
      pos = end + 1;
      n_tokens++;
      if (filled == ngram) {
        memmove(ring, ring + 1, (ngram - 1) * sizeof(Span));
        filled--;
      }
      ring[filled].at = start;
      ring[filled].len = (uint32_t)(end - start);
      filled++;
      if (filled < ngram) continue;
      // join with single spaces — in place when the separators are single
      // whitespace bytes (normalized to ' ' by preprocess), scratch otherwise
      int64_t klen = ngram - 1;
      bool contig = true;
      for (int32_t k = 0; k < ngram; k++) {
        klen += ring[k].len;
        if (k && ring[k].at != ring[k - 1].at + (int64_t)ring[k - 1].len + 1)
          contig = false;
      }
      const uint8_t* kp;
      if (contig) {
        kp = low + ring[0].at;
      } else {
        if (klen > st->key_cap) {
          int64_t nc = st->key_cap ? st->key_cap : 1 << 12;
          while (nc < klen) nc *= 2;
          st->key = static_cast<uint8_t*>(realloc(st->key, nc));
          st->key_cap = nc;
        }
        int64_t w = 0;
        for (int32_t k = 0; k < ngram; k++) {
          if (k) st->key[w++] = ' ';
          memcpy(st->key + w, low + ring[k].at, ring[k].len);
          w += ring[k].len;
        }
        kp = st->key;
      }
      uint64_t w0, w1, h;
      load16_masked(kp, klen >= 16 ? 16 : klen, &w0, &w1);
      if (klen <= 16) {  // == moxt64(kp, klen) without the general loop
        h = moxt64_finish(moxt64_round((uint64_t)klen * kM3, w0, w1));
      } else {
        h = moxt64(kp, klen);
      }
      rc = chunk_upsert(st, kp, (uint32_t)klen, w0, w1, h);
    }
  }

  st->n_tokens = n_tokens;
  if (rc != UP_OK) {
    st->error = 1;
    return 1;
  }
  if (dict_absorb(st) != UP_OK) {
    st->error = 1;
    return 1;
  }
  return 0;
}

int64_t moxt_chunk_unique(MoxtState* st) { return st->chunk.n; }
int64_t moxt_chunk_tokens(MoxtState* st) { return st->n_tokens; }

// Inverted-index map: emit one (term hash, doc id) pair per DISTINCT term
// per document, where a document is one line and its id is the absolute
// byte offset of its first byte (base_doc + in-chunk offset) — unique,
// monotone in document order, and derivable per chunk with no global line
// counter.  Per-doc distinctness reuses the epoch trick on the dedicated
// st->doc table (NOT st->chunk): it gets a fresh epoch per document, so
// "new this epoch" == "first time in this doc".  Dictionary entries are
// inserted inline (the doc table only holds the current doc).
// BASELINE.json config #4; generalizes the reference's per-chunk HashMap
// (main.rs:94-101) to per-document key sets.
// flags for moxt_map_docs_ex: which per-fresh-pair stores to run.  The
// default (both) is the production path; the reduced forms exist to
// DECOMPOSE the doc-mode scan cost (benchmarks/RESULTS.md round 4) and to
// serve a future hash-only index mode (strings recovered by rescan).
static const int32_t kDocsPairs = 1;
static const int32_t kDocsDict = 2;

int32_t moxt_map_docs_ex(MoxtState* st, const uint8_t* data, int64_t len,
                         int64_t base_doc, int32_t flags);

int32_t moxt_map_docs(MoxtState* st, const uint8_t* data, int64_t len,
                      int64_t base_doc) {
  return moxt_map_docs_ex(st, data, len, base_doc, kDocsPairs | kDocsDict);
}

int32_t moxt_map_docs_ex(MoxtState* st, const uint8_t* data, int64_t len,
                         int64_t base_doc, int32_t flags) {
  if (!st || st->error == 2) return 2;
  // unicode transform would shift byte offsets and break doc identity; the
  // driver keeps unicode inverted-index on the Python path
  if (st->ngram != 1 || st->unicode) { st->error = 2; return 2; }
  st->error = 0;
  st->n_tokens = 0;
  st->pair_n = 0;
  st->chunk_arena.reset();
  if (len <= 0) return 0;

  if (len > st->scratch_cap) {
    free(st->low);
    free(st->ws);
    st->low = static_cast<uint8_t*>(malloc(len + 64));
    st->ws = static_cast<uint64_t*>(malloc((((len + 63) >> 6) + 2) * 8));
    st->scratch_cap = len;
  }
  preprocess(data, len, st->low, st->ws);
  const uint8_t* low = st->low;
  const uint64_t* ws = st->ws;

  int64_t n_tokens = 0;
  int64_t pos = 0;
  int64_t line_start = 0;   // in-chunk offset of the current doc's first byte
  int64_t scanned = 0;      // newline search frontier
  st->doc.new_epoch();
  while (true) {
    int64_t start = next_clear(ws, pos);
    if (start >= len) break;
    // advance the current doc: last newline in [scanned, start) starts it
    for (int64_t g = start - 1; g >= scanned; g--) {
      if (data[g] == '\n') {
        line_start = g + 1;
        st->doc.new_epoch();  // fresh per-doc distinct set
        break;
      }
    }
    scanned = start;
    int64_t end = next_set(ws, start);
    uint32_t tlen = (uint32_t)(end - start);
    n_tokens++;
    uint64_t w0, w1, h;
    if (tlen <= 16) {
      load16_masked(low + start, tlen, &w0, &w1);
      h = moxt64_finish(moxt64_round((uint64_t)tlen * kM3, w0, w1));
    } else {
      load16_masked(low + start, 16, &w0, &w1);
      h = moxt64(low + start, tlen);
    }
    // "new this doc" -> emit the pair and make sure the dict knows the term
    Table& t = st->doc;
    if (t.n * 2 >= t.cap) t.grow();
    int64_t mask = t.cap - 1;
    int64_t j = h & mask;
    bool fresh = false;
    for (;;) {
      Slot& s = t.slots[j];
      if (s.epoch != t.epoch || s.count == 0) {
        s.hash = h;
        s.w0 = w0;
        s.w1 = w1;
        s.count = 1;
        s.len = tlen;
        s.aref = st->chunk_arena.append(low + start, tlen);
        s.epoch = t.epoch;
        t.n++;
        fresh = true;
        break;
      }
      if (s.hash == h) {
        if (s.len == tlen && s.w0 == w0 && s.w1 == w1 &&
            (tlen <= 16 ||
             memcmp(st->chunk_arena.data + s.aref, low + start, tlen) == 0))
          break;  // seen in this doc already: no pair
        st->error = 1;
        return 1;
      }
      j = (j + 1) & mask;
    }
    if (fresh) {
      if (flags & kDocsPairs) st->pair_push(h, base_doc + line_start);
      if ((flags & kDocsDict) &&
          dict_upsert(st, h, w0, w1, tlen, low + start) != UP_OK) {
        st->error = 1;
        return 1;
      }
    }
    pos = end + 1;
  }
  st->n_tokens = n_tokens;
  return 0;
}

int64_t moxt_pairs_n(MoxtState* st) { return st->pair_n; }

void moxt_pairs_read(MoxtState* st, uint64_t* hashes, int64_t* docs) {
  memcpy(hashes, st->pair_h, st->pair_n * 8);
  memcpy(docs, st->pair_doc, st->pair_n * 8);
}

// Copy the chunk's compacted (hash, count) columns into caller buffers of
// size moxt_chunk_unique().
void moxt_chunk_read(MoxtState* st, uint64_t* hashes, int32_t* counts) {
  const Table& t = st->chunk;
  int64_t out = 0;
  for (int64_t i = 0; i < t.cap; i++) {
    const Slot& s = t.slots[i];
    if (s.epoch != t.epoch || s.count == 0) continue;
    hashes[out] = s.hash;
    counts[out] = (int32_t)s.count;
    out++;
  }
}

// ---------------------------------------------------------------------------
// Memory-mapped input: the zero-copy host read path.  The
// reference buffers the whole corpus line-by-line through a BufReader
// (the reference's src/main.rs:36-51); mmap lets the scan read page-cache
// pages in place — no kernel->user copy at all on a warm corpus.
// ---------------------------------------------------------------------------

struct MoxtFile {
  uint8_t* data;
  int64_t size;
};

MoxtFile* moxt_file_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat sb;
  if (fstat(fd, &sb) != 0) {
    close(fd);
    return nullptr;
  }
  MoxtFile* f = new MoxtFile();
  f->size = sb.st_size;
  f->data = nullptr;
  if (f->size > 0) {
    // plain mmap, NO madvise: MADV_SEQUENTIAL(+HUGEPAGE) measured 3-4%
    // SLOWER on the warm 10GB scan in every same-session A/B pair
    // (round 5, benchmarks/RESULTS.md) — the drop-behind eviction costs
    // more than the readahead buys when the corpus is page-cache
    // resident, and file-backed THP did not engage on this kernel.
    void* p = mmap(nullptr, f->size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
      close(fd);
      delete f;
      return nullptr;
    }
    madvise(p, f->size, MADV_SEQUENTIAL);
    f->data = static_cast<uint8_t*>(p);
  }
  close(fd);  // the mapping keeps the file alive
  return f;
}

void moxt_file_close(MoxtFile* f) {
  if (!f) return;
  if (f->data) munmap(f->data, f->size);
  delete f;
}

int64_t moxt_file_size(MoxtFile* f) { return f ? f->size : -1; }

// Chunk-cut policy for streaming map ranges: cut at the last newline in the
// window (falling back to the last ASCII whitespace, then a hard cut — same
// bounded-carry policy as the Python splitter).  Shared by every
// non-doc-mode range mapper so resume offsets stay identical across them.
static int64_t range_cut(MoxtState* st, MoxtFile* f, int64_t off,
                         int64_t want) {
  int64_t len = f->size - off;
  if (len > want) {
    len = want;
    const uint8_t* p = f->data + off;
    int64_t cut = -1;
    for (int64_t i = len - 1; i >= 0; i--) {
      if (p[i] == '\n') { cut = i; break; }
    }
    if (cut < 0) {
      for (int64_t i = len - 1; i >= 0; i--) {
        if (is_ascii_space(p[i])) { cut = i; break; }
      }
    }
    if (cut >= 0) {
      len = cut + 1;
    } else if (st->unicode) {
      // hard cut on a whitespace-free window: in unicode mode an arbitrary
      // byte cut can split a multi-byte sequence and abort valid input as
      // invalid UTF-8 — back off (<= 3 bytes) to the last complete codepoint
      // (ascii mode's hard cut merely splits one token, which is fine)
      int64_t c = len;
      int back = 0;
      while (c > 0 && back < 4 && (p[c - 1] & 0xC0) == 0x80) {
        c--;
        back++;
      }
      if (c > 0) {
        uint8_t lead = p[c - 1];
        int need = lead < 0x80 ? 1
                   : (lead & 0xE0) == 0xC0 ? 2
                   : (lead & 0xF0) == 0xE0 ? 3
                   : (lead & 0xF8) == 0xF0 ? 4
                                           : 1;
        if (c - 1 + need > len && c - 1 > 0) len = c - 1;
        // c-1 == 0 with an incomplete lead: the window IS one truncated
        // sequence — leave len alone and let the decoder report it
      }
    }
  }
  return len;
}

// Map one chunk straight from the mapping: [off, off + consumed).  Returns
// bytes consumed, 0 at EOF, -rc on a map error.
int64_t moxt_map_range(MoxtState* st, MoxtFile* f, int64_t off, int64_t want) {
  if (!st || !f || off < 0 || off >= f->size || want <= 0) return 0;
  int64_t len = range_cut(st, f, off, want);
  int32_t rc = moxt_map(st, f->data + off, len);
  if (rc != 0) return -(int64_t)rc;
  return len;
}

// mmap-range variant of moxt_map_docs; doc ids = absolute file offsets
// because base_doc == off.  Cut policy differs from moxt_map_range on
// purpose: doc identity requires every chunk to START at a line start, so a
// window with no newline EXTENDS forward to the next one (a single document
// longer than the window is carried whole — doc-mode residency is
// O(longest line), which the workload inherently requires) instead of
// falling back to a whitespace cut.
int64_t moxt_map_range_docs(MoxtState* st, MoxtFile* f, int64_t off,
                            int64_t want) {
  if (!st || !f || off < 0 || off >= f->size || want <= 0) return 0;
  int64_t len = f->size - off;
  if (len > want) {
    const uint8_t* p = f->data + off;
    int64_t cut = -1;
    for (int64_t i = want - 1; i >= 0; i--) {
      if (p[i] == '\n') { cut = i; break; }
    }
    if (cut < 0) {
      // no newline in the window: extend to the next one (or EOF)
      for (int64_t i = want; i < len; i++) {
        if (p[i] == '\n') { cut = i; break; }
      }
    }
    len = (cut >= 0) ? cut + 1 : len;
  }
  int32_t rc = moxt_map_docs(st, f->data + off, len, off);
  if (rc != 0) return -(int64_t)rc;
  return len;
}

// Dictionary delta since the last drain: entry count and total bytes.
void moxt_dict_pending(MoxtState* st, int64_t* n, int64_t* nbytes) {
  *n = st->log_n - st->pending_from;
  *nbytes = st->dict_arena.size - st->pending_bytes_from;
}

// Drain the delta into caller buffers (hashes[n], lens[n], bytes[nbytes],
// concatenated in insert order) and advance the cursor.
void moxt_dict_read(MoxtState* st, uint64_t* hashes, int32_t* lens,
                    uint8_t* bytes) {
  int64_t n = st->log_n - st->pending_from;
  for (int64_t i = 0; i < n; i++) {
    hashes[i] = st->log_h[st->pending_from + i];
    lens[i] = (int32_t)st->log_len[st->pending_from + i];
  }
  memcpy(bytes, st->dict_arena.data + st->pending_bytes_from,
         st->dict_arena.size - st->pending_bytes_from);
  st->pending_from = st->log_n;
  st->pending_bytes_from = st->dict_arena.size;
}

// ---------------------------------------------------------------------------
// Hash-only map + hash->bytes resolver.
//
// Wide-key workloads routed to the host collect-reduce engine need neither
// per-chunk combining nor key strings during the map: the one final sort
// dedups, and strings matter only for the <= k winners (resolved by one
// extra scan) or a requested full text output.  Dropping the tables removes
// the map loop's DRAM misses — the chunk/dict tables for millions of
// distinct bigrams exceed cache, costing ~2 misses per pair — and drops the
// per-chunk dictionary drain entirely.  Measured on the build host:
// 21 MB/s (fused upsert map) -> see benchmarks/RESULTS.md for the
// hash-only number.
// ---------------------------------------------------------------------------

// Emit one hash per n-gram window into the hash buffer.  0 ok, 3 bad UTF-8.
int32_t moxt_map_hashes(MoxtState* st, const uint8_t* data, int64_t len) {
  if (!st || st->error == 2) return 2;
  st->error = 0;
  st->hx_n = 0;
  int32_t rc = scan_ngrams(st, data, len,
                           [st](const uint8_t*, uint32_t, uint64_t h) {
                             st->hx_push(h);
                             return (int)UP_OK;
                           });
  if (rc) st->error = rc;
  return rc;
}

int64_t moxt_hashes_n(MoxtState* st) { return st->hx_n; }

void moxt_hashes_read(MoxtState* st, uint64_t* out) {
  memcpy(out, st->hx_h, st->hx_n * 8);
}

// mmap-range variant; same cut policy as moxt_map_range.
int64_t moxt_map_range_hashes(MoxtState* st, MoxtFile* f, int64_t off,
                              int64_t want) {
  if (!st || !f || off < 0 || off >= f->size || want <= 0) return 0;
  int64_t len = range_cut(st, f, off, want);
  int32_t rc = moxt_map_hashes(st, f->data + off, len);
  if (rc != 0) return -(int64_t)rc;
  return len;
}

// ---------------------------------------------------------------------------
// HLL-fold map (distinct workload).
//
// bucket = top-p hash bits, rank = leading-zero count of the remaining
// 64-p bits + 1; registers keep the per-bucket max.  Folding in-scan
// replaces the hash emission buffer entirely: ~2^p bytes of L1-resident
// registers instead of 8 bytes/token of DRAM stores plus a 34M-row NumPy
// bincount on the Python side (round-4 verdict: that extraction held
// distinct to ~170 MB/s against the 544-589 MB/s hash-only scan).
// rank matches workloads/distinct.py hll_registers: for the masked
// remainder w, frexp gives 64-p+1-exp = clz64(w)-p+1; w==0 -> 64-p+1.
// ---------------------------------------------------------------------------

// Fold one chunk into the registers.  0 ok, 3 bad UTF-8, 2 bad state/p.
int32_t moxt_map_hll(MoxtState* st, const uint8_t* data, int64_t len,
                     int32_t p) {
  if (!st || st->error == 2) return 2;
  if (p < 4 || p > 24) return 2;
  st->error = 0;
  int64_t m = (int64_t)1 << p;
  if (st->hll_p != p) {
    free(st->hll_regs);
    st->hll_regs = static_cast<uint8_t*>(malloc(m));
    if (!st->hll_regs) {
      st->hll_p = 0;
      return 2;
    }
    st->hll_p = p;
  }
  memset(st->hll_regs, 0, m);
  uint8_t* regs = st->hll_regs;
  const int32_t shift = 64 - p;
  const uint64_t mask = (~0ULL) >> p;
  int32_t rc = scan_ngrams(
      st, data, len,
      [regs, p, shift, mask](const uint8_t*, uint32_t, uint64_t h) {
        uint64_t b = h >> shift;
        uint64_t w = h & mask;
        uint8_t rank = w ? (uint8_t)(__builtin_clzll(w) - p + 1)
                         : (uint8_t)(shift + 1);
        if (rank > regs[b]) regs[b] = rank;
        return (int)UP_OK;
      });
  if (rc) st->error = rc;
  return rc;
}

// Read back the 2^p registers of the last moxt_map_hll call.
void moxt_hll_read(MoxtState* st, uint8_t* out) {
  if (st->hll_p) memcpy(out, st->hll_regs, (int64_t)1 << st->hll_p);
}

// mmap-range variant; same cut policy (same resume offsets) as
// moxt_map_range_hashes.
int64_t moxt_map_range_hll(MoxtState* st, MoxtFile* f, int64_t off,
                           int64_t want, int32_t p) {
  if (!st || !f || off < 0 || off >= f->size || want <= 0) return 0;
  int64_t len = range_cut(st, f, off, want);
  int32_t rc = moxt_map_hll(st, f->data + off, len, p);
  if (rc != 0) return -(int64_t)rc;
  return len;
}

// Load the query set (the hashes whose key bytes the caller wants back).
// Resets any previous resolve state.
int32_t moxt_resolve_begin(MoxtState* st, const uint64_t* hashes, int64_t n) {
  if (!st) return 2;
  free(st->q_h);
  free(st->q_ref);
  free(st->q_len);
  free(st->found);
  st->found = nullptr;
  st->found_n = st->found_cap = 0;
  st->res_arena.reset();
  int64_t cap = 64;
  while (cap < 4 * n) cap <<= 1;
  st->q_cap = cap;
  st->q_n = n;
  st->q_h = static_cast<uint64_t*>(malloc(cap * 8));
  st->q_ref = static_cast<int64_t*>(malloc(cap * 8));
  st->q_len = static_cast<uint32_t*>(malloc(cap * 4));
  if (!st->q_h || !st->q_ref || !st->q_len) return 2;
  // q_ref: -2 = empty slot, -1 = wanted/unseen, >=0 = found at arena offset
  for (int64_t i = 0; i < cap; i++) st->q_ref[i] = -2;
  st->q_distinct = 0;
  for (int64_t i = 0; i < n; i++) {
    uint64_t h = hashes[i];
    int64_t j = h & (cap - 1);
    while (st->q_ref[j] != -2) {
      if (st->q_h[j] == h) break;  // duplicate query hash: one slot
      j = (j + 1) & (cap - 1);
    }
    st->q_h[j] = h;
    if (st->q_ref[j] == -2) {
      st->q_ref[j] = -1;
      st->q_distinct++;
    }
  }
  return 0;
}

// Queried-but-unseen count.  When it hits zero the caller may stop scanning
// early: every requested key's bytes are recorded.  The collision byte-check
// then covers occurrences up to the stop point rather than the whole corpus
// (the full-scan guarantee remains available by just not stopping).
int64_t moxt_resolve_remaining(MoxtState* st) {
  if (!st) return -1;
  return st->q_distinct - st->found_n;
}

// Scan one chunk; record bytes for the first occurrence of each queried
// hash.  Later occurrences byte-compare against the recorded key, so a
// 64-bit collision involving any QUERIED key is detected (rc 1) — the same
// guarantee level the dictionary paths give, scoped to the keys that
// actually surface.  rc 3 = invalid UTF-8 (unicode mode).
int32_t moxt_resolve_chunk(MoxtState* st, const uint8_t* data, int64_t len) {
  if (!st) return 2;
  if (st->q_n == 0) return 0;
  uint64_t* qh = st->q_h;
  int64_t* qref = st->q_ref;
  uint32_t* qlen = st->q_len;
  const int64_t mask = st->q_cap - 1;
  return scan_ngrams(
      st, data, len,
      [st, qh, qref, qlen, mask](const uint8_t* key, uint32_t klen,
                                 uint64_t h) {
        int64_t j = h & mask;
        while (qref[j] != -2) {
          if (qh[j] == h) {
            if (qref[j] == -1) {
              qref[j] = st->res_arena.append(key, klen);
              qlen[j] = klen;
              if (st->found_n == st->found_cap) {
                st->found_cap = st->found_cap ? st->found_cap * 2 : 256;
                st->found = static_cast<int64_t*>(
                    realloc(st->found, st->found_cap * 8));
              }
              st->found[st->found_n++] = j;
            } else if (qlen[j] != klen ||
                       memcmp(st->res_arena.data + qref[j], key, klen) != 0) {
              return (int)UP_COLLISION;
            }
            break;
          }
          j = (j + 1) & mask;
        }
        return (int)UP_OK;
      });
}

// mmap-range resolve with the SAME cut policy as the map ranges: a pair
// counted under the map chunking exists within some map chunk, so scanning
// identical windows guarantees the resolver sees every counted key.
int64_t moxt_resolve_range(MoxtState* st, MoxtFile* f, int64_t off,
                           int64_t want) {
  if (!st || !f || off < 0 || off >= f->size || want <= 0) return 0;
  int64_t len = range_cut(st, f, off, want);
  int32_t rc = moxt_resolve_chunk(st, f->data + off, len);
  if (rc != 0) return -(int64_t)rc;
  return len;
}

// ---------------------------------------------------------------------------
// Host radix sort for the collect paths.  numpy's stable u64 sort measures
// ~4 s on 30M keys (one pass of the inverted-index finalize); an LSD radix
// with 11-bit digits and a fused histogram pass does the same work in a
// handful of streaming passes.  Stability is inherent to LSD scatter, which
// the index relies on (doc order per term is feed order).
// ---------------------------------------------------------------------------

static const int kRadixBits = 11;
static const int64_t kRadixSize = 1 << kRadixBits;   // 2048 buckets
static const int kRadixPasses = (64 + kRadixBits - 1) / kRadixBits;  // 6

// Sort keys ascending, docs riding along (docs may be null).  Returns 0,
// or -1 on allocation failure.  In-place on the caller's arrays.
int32_t moxt_sort_kd(uint64_t* keys, int64_t* docs, int64_t n) {
  if (n <= 1) return 0;
  int64_t* hist =
      static_cast<int64_t*>(calloc(kRadixPasses * kRadixSize, 8));
  if (!hist) return -1;
  // one read pass builds every pass's histogram
  for (int64_t i = 0; i < n; i++) {
    uint64_t k = keys[i];
    for (int p = 0; p < kRadixPasses; p++)
      hist[p * kRadixSize + ((k >> (p * kRadixBits)) & (kRadixSize - 1))]++;
  }
  // prefix-sum each pass's histogram, skipping constant-digit passes
  bool skip[kRadixPasses];
  for (int p = 0; p < kRadixPasses; p++) {
    int64_t* h = hist + p * kRadixSize;
    int64_t nonzero = 0;
    for (int64_t b = 0; b < kRadixSize && nonzero <= 1; b++)
      if (h[b]) nonzero++;
    skip[p] = nonzero <= 1;
    if (skip[p]) continue;
    int64_t sum = 0;
    for (int64_t b = 0; b < kRadixSize; b++) {
      int64_t c = h[b];
      h[b] = sum;
      sum += c;
    }
  }
  if (docs) {
    // interleave (key, doc) into 16-byte records so each scatter is ONE
    // contiguous 16B write — two separate scatter streams double the
    // random-write cache misses
    struct KD {
      uint64_t k;
      int64_t d;
    };
    KD* a = static_cast<KD*>(malloc(n * sizeof(KD)));
    KD* b = static_cast<KD*>(malloc(n * sizeof(KD)));
    if (!a || !b) {
      free(a);
      free(b);
      free(hist);
      return -1;
    }
    for (int64_t i = 0; i < n; i++) a[i] = KD{keys[i], docs[i]};
    KD* src = a;
    KD* dst = b;
    for (int p = 0; p < kRadixPasses; p++) {
      if (skip[p]) continue;
      int64_t* h = hist + p * kRadixSize;
      const int shift = p * kRadixBits;
      for (int64_t i = 0; i < n; i++)
        dst[h[(src[i].k >> shift) & (kRadixSize - 1)]++] = src[i];
      KD* sw = src;
      src = dst;
      dst = sw;
    }
    for (int64_t i = 0; i < n; i++) {
      keys[i] = src[i].k;
      docs[i] = src[i].d;
    }
    free(a);
    free(b);
    free(hist);
    return 0;
  }
  uint64_t* tk = static_cast<uint64_t*>(malloc(n * 8));
  if (!tk) {
    free(hist);
    return -1;
  }
  uint64_t* src_k = keys;
  uint64_t* dst_k = tk;
  for (int p = 0; p < kRadixPasses; p++) {
    if (skip[p]) continue;
    int64_t* h = hist + p * kRadixSize;
    const int shift = p * kRadixBits;
    for (int64_t i = 0; i < n; i++) {
      int64_t pos = h[(src_k[i] >> shift) & (kRadixSize - 1)]++;
      dst_k[pos] = src_k[i];
    }
    uint64_t* sw = src_k;
    src_k = dst_k;
    dst_k = sw;
  }
  if (src_k != keys) {
    memcpy(keys, src_k, n * 8);
  }
  free(tk);
  free(hist);
  return 0;
}

// Blocks variant of the keys-only LSD sort: reads the staged feed blocks
// in place (histogram AND first scatter), writing the sorted result into
// `out` (caller-allocated, n == sum(lens)); `tmp` is ping-pong scratch of
// the same size.  The engine's staged feed arrives as many blocks; a
// separate O(n) concatenation before moxt_sort_kd cost ~0.3 s at 34M rows
// (bigram 256MB) — here the first scatter IS the concatenation.
// 16-bit digits for the keys-only blocks sort: 4 passes instead of 6.
// Measured A/B at the bigram shape (34M keys, 6.4M distinct, Zipf
// duplicates): ~10% faster than 11-bit despite the 64k-bucket scatter's
// extra TLB pressure — fewer full-array passes win.  The KD (16-byte
// record) sort and the fused count's in-cache LSD keep 11-bit digits
// (their cache economics differ and were not re-measured).
static const int kLsdBits = 16;
static const int64_t kLsdSize = 1 << kLsdBits;
static const int kLsdPasses = (64 + kLsdBits - 1) / kLsdBits;  // 4

int32_t moxt_sort_u64_blocks(uint64_t* const* blocks, const int64_t* lens,
                             int32_t nblocks, uint64_t* out, uint64_t* tmp,
                             int64_t n) {
  if (n <= 0) return 0;
  int64_t* hist =
      static_cast<int64_t*>(calloc(kLsdPasses * kLsdSize, 8));
  if (!hist) return -1;
  for (int32_t b = 0; b < nblocks; b++) {
    const uint64_t* blk = blocks[b];
    const int64_t ln = lens[b];
    for (int64_t i = 0; i < ln; i++) {
      uint64_t k = blk[i];
      for (int p = 0; p < kLsdPasses; p++)
        hist[p * kLsdSize + ((k >> (p * kLsdBits)) & (kLsdSize - 1))]++;
    }
  }
  bool skip[kLsdPasses];
  int live = 0;
  for (int p = 0; p < kLsdPasses; p++) {
    int64_t* h = hist + p * kLsdSize;
    int64_t nonzero = 0;
    for (int64_t bb = 0; bb < kLsdSize && nonzero <= 1; bb++)
      if (h[bb]) nonzero++;
    skip[p] = nonzero <= 1;
    if (skip[p]) continue;
    live++;
    int64_t sum = 0;
    for (int64_t bb = 0; bb < kLsdSize; bb++) {
      int64_t c = h[bb];
      h[bb] = sum;
      sum += c;
    }
  }
  if (live == 0) {  // every digit constant: blocks are already the result
    int64_t o = 0;
    for (int32_t b = 0; b < nblocks; b++) {
      memcpy(out + o, blocks[b], lens[b] * 8);
      o += lens[b];
    }
    free(hist);
    return 0;
  }
  // destinations alternate starting so the FINAL pass lands in `out`
  uint64_t* dst = (live % 2) ? out : tmp;
  uint64_t* src = nullptr;
  bool first = true;
  for (int p = 0; p < kLsdPasses; p++) {
    if (skip[p]) continue;
    int64_t* h = hist + p * kLsdSize;
    const int shift = p * kLsdBits;
    if (first) {
      for (int32_t b = 0; b < nblocks; b++) {
        const uint64_t* blk = blocks[b];
        const int64_t ln = lens[b];
        for (int64_t i = 0; i < ln; i++)
          dst[h[(blk[i] >> shift) & (kLsdSize - 1)]++] = blk[i];
      }
      first = false;
    } else {
      for (int64_t i = 0; i < n; i++)
        dst[h[(src[i] >> shift) & (kLsdSize - 1)]++] = src[i];
    }
    src = dst;
    dst = (dst == out) ? tmp : out;
  }
  free(hist);
  return 0;
}

// Fused unique+count for u64 hash keys — the hash-only count reduce.
//
// A full LSD sort streams every row through DRAM 6+ times and the caller
// still has to boundary-scan and gather.  Counting needs neither the
// sorted ROWS nor a second scan: MSD-partition by the top 11 bits (one
// histogram read + one scatter), then each bucket (~n/2048 rows — L2-
// resident for uniform hashes) LSD-sorts entirely in cache and emits its
// (unique, count) runs directly.  DRAM traffic drops from ~13 row-passes
// (sort + bounds + gather) to ~4, and the output is globally ascending
// (bucket = key prefix) so callers keep the sorted-keys contract.
// Duplicate-heavy keys (Zipf) can swell one bucket past cache; scratch is
// sized to the measured max bucket, and an oversized bucket just runs its
// LSD passes from DRAM — correctness is unaffected.
//
// keys: read-only.  out_keys/out_counts: caller-allocated, capacity n
// (worst case all-unique); out_keys doubles as the partition buffer —
// the emission cursor m trails the bucket read cursor (m uniques <= rows
// consumed), so compacting runs into the same buffer never overwrites an
// unread row.  Returns the number of uniques, or -1 on allocation
// failure.  Counts would truncate past 2^31 occurrences of one key; the
// Python wrapper refuses n >= 2^31 so a run can never reach that.
int64_t moxt_count_u64(const uint64_t* keys, int64_t n, uint64_t* out_keys,
                       int32_t* out_counts) {
  if (n <= 0) return 0;
  const int kTopBits = 11;
  const int64_t kTop = 1 << kTopBits;
  const int kLowPasses = 5;  // remaining 53 bits in 11-bit digits
  int64_t* bh = static_cast<int64_t*>(calloc(kTop, 8));
  if (!bh) return -1;
  for (int64_t i = 0; i < n; i++) bh[keys[i] >> (64 - kTopBits)]++;
  int64_t maxb = 0, sum = 0;
  int64_t* off = static_cast<int64_t*>(malloc(kTop * 8));
  if (!off) {
    free(bh);
    return -1;
  }
  for (int64_t b = 0; b < kTop; b++) {
    off[b] = sum;
    sum += bh[b];
    if (bh[b] > maxb) maxb = bh[b];
  }
  uint64_t* part = out_keys;
  uint64_t* s1 = static_cast<uint64_t*>(malloc(maxb * 8));
  uint64_t* s2 = static_cast<uint64_t*>(malloc(maxb * 8));
  int64_t* lh = static_cast<int64_t*>(malloc(kLowPasses * kRadixSize * 8));
  if (!s1 || !s2 || !lh) {
    free(bh);
    free(off);
    free(s1);
    free(s2);
    free(lh);
    return -1;
  }
  for (int64_t i = 0; i < n; i++)
    part[off[keys[i] >> (64 - kTopBits)]++] = keys[i];
  int64_t m = 0;
  int64_t start = 0;
  for (int64_t b = 0; b < kTop; b++) {
    const int64_t cnt = bh[b];
    if (!cnt) continue;
    uint64_t* bucket = part + start;
    start += cnt;
    // fused per-bucket histograms: one cache-resident read for all passes
    memset(lh, 0, kLowPasses * kRadixSize * 8);
    for (int64_t i = 0; i < cnt; i++) {
      uint64_t k = bucket[i];
      for (int p = 0; p < kLowPasses; p++)
        lh[p * kRadixSize + ((k >> (p * kRadixBits)) & (kRadixSize - 1))]++;
    }
    uint64_t* src = bucket;
    for (int p = 0; p < kLowPasses; p++) {
      int64_t* h = lh + p * kRadixSize;
      int64_t nonzero = 0;
      for (int64_t d = 0; d < kRadixSize && nonzero <= 1; d++)
        if (h[d]) nonzero++;
      if (nonzero <= 1) continue;  // constant digit: pass is a no-op
      int64_t s = 0;
      for (int64_t d = 0; d < kRadixSize; d++) {
        int64_t c = h[d];
        h[d] = s;
        s += c;
      }
      uint64_t* dst = (src == s1) ? s2 : s1;
      const int shift = p * kRadixBits;
      for (int64_t i = 0; i < cnt; i++)
        dst[h[(src[i] >> shift) & (kRadixSize - 1)]++] = src[i];
      src = dst;
    }
    // emit (unique, count) runs; bucket order makes output ascending
    uint64_t run = src[0];
    int64_t rc = 1;
    for (int64_t i = 1; i < cnt; i++) {
      if (src[i] == run) {
        rc++;
      } else {
        out_keys[m] = run;
        out_counts[m++] = static_cast<int32_t>(rc);
        run = src[i];
        rc = 1;
      }
    }
    out_keys[m] = run;
    out_counts[m++] = static_cast<int32_t>(rc);
  }
  free(bh);
  free(off);
  free(s1);
  free(s2);
  free(lh);
  return m;
}

// Group (key, doc) rows by key against a known distinct-key set — the
// inverted-index finalize when distinct terms << rows (a natural-language
// vocabulary: ~27k terms over 30M pairs at 256MB).  The term dictionary
// the map phase already built names every distinct key, so ordering needs
// no sort at all: an L2-resident open-addressed hash -> dense-id table,
// one counting pass, one scatter pass.  Two streaming passes replace the
// radix sort's six, and the scatter preserves feed order per term — the
// same ascending-doc stability contract the sort path relies on.
//
// uniq: the distinct keys (ascending, duplicates rejected), m entries.
// out_offsets (m+1) and out_docs (n) are caller-allocated; term j's docs
// land at out_docs[out_offsets[j] : out_offsets[j+1]].
// Returns 0 ok; -1 allocation failure; 1 contract violation (duplicate
// uniq entry, or a key absent from uniq) — caller falls back to sorting.
int32_t moxt_group_by_key(const uint64_t* keys, const int64_t* docs,
                          int64_t n, const uint64_t* uniq, int64_t m,
                          int64_t* out_offsets, int64_t* out_docs) {
  if (n < 0 || m <= 0 || m > (int64_t)1 << 31) return 1;
  for (int64_t j = 0; j <= m; j++) out_offsets[j] = 0;
  if (n == 0) return 0;
  int64_t cap = 64;
  while (cap < 2 * m) cap <<= 1;
  uint64_t* th = static_cast<uint64_t*>(malloc(cap * 8));
  int32_t* tid = static_cast<int32_t*>(malloc(cap * 4));
  uint32_t* ids = static_cast<uint32_t*>(malloc(n * 4));
  int64_t* cur = static_cast<int64_t*>(malloc(m * 8));
  if (!th || !tid || !ids || !cur) {
    free(th);
    free(tid);
    free(ids);
    free(cur);
    return -1;
  }
  for (int64_t s = 0; s < cap; s++) tid[s] = -1;
  int32_t rc = 0;
  for (int64_t j = 0; j < m && !rc; j++) {
    uint64_t h = uniq[j];
    int64_t s = h & (cap - 1);  // keys are wyhash-mixed; low bits uniform
    while (tid[s] != -1) {
      if (th[s] == h) {
        rc = 1;  // duplicate uniq entry: ids would be ambiguous
        break;
      }
      s = (s + 1) & (cap - 1);
    }
    th[s] = h;
    tid[s] = static_cast<int32_t>(j);
  }
  // counting pass: dense id per row (cached for the scatter), counts into
  // out_offsets[1..m]
  for (int64_t i = 0; i < n && !rc; i++) {
    uint64_t h = keys[i];
    int64_t s = h & (cap - 1);
    for (;;) {
      if (tid[s] < 0) {
        rc = 1;  // key not in uniq: the dictionary missed it
        break;
      }
      if (th[s] == h) {
        ids[i] = static_cast<uint32_t>(tid[s]);
        out_offsets[tid[s] + 1]++;
        break;
      }
      s = (s + 1) & (cap - 1);
    }
  }
  if (!rc) {
    for (int64_t j = 0; j < m; j++) out_offsets[j + 1] += out_offsets[j];
    memcpy(cur, out_offsets, m * 8);
    for (int64_t i = 0; i < n; i++) out_docs[cur[ids[i]]++] = docs[i];
  }
  free(th);
  free(tid);
  free(ids);
  free(cur);
  return rc;
}

// Found-entry drain: count + total bytes, then parallel columns.
int64_t moxt_resolve_found(MoxtState* st, int64_t* nbytes) {
  if (nbytes) *nbytes = st->res_arena.size;
  return st->found_n;
}

void moxt_resolve_read(MoxtState* st, uint64_t* hashes, int32_t* lens,
                       uint8_t* bytes) {
  for (int64_t i = 0; i < st->found_n; i++) {
    int64_t j = st->found[i];
    hashes[i] = st->q_h[j];
    lens[i] = (int32_t)st->q_len[j];
  }
  memcpy(bytes, st->res_arena.data, st->res_arena.size);
}

}  // extern "C"
