// The device map's hash -> token-bytes dictionary (runtime/device_dict.py).
//
// The card reports each chunk's unique keys as 64-bit hashes (hi/lo planes)
// with the offset of one occurrence of each in the chunk (its "rep").  One
// call per chunk does, for every key:
//
//   * scan the key at its rep exactly as ops/device_tokenize.py ngram_at
//     does: a token runs to the next of the six ASCII whitespace bytes
//     {' ', '\t', '\n', '\v', '\f', '\r'} or the chunk's end; an n-gram's
//     member tokens are joined by ONE space whatever whitespace lies between
//     them; only 'A'..'Z' are lowercased (bytes.lower());
//   * probe a persistent open-addressing table of hash -> entry;
//   * a new hash: append the key's bytes to the arena and insert;
//   * a known hash: compare the stored bytes with this occurrence's.  Two
//     different keys under one hash is a 64-bit collision: the call stops
//     and reports it, and the caller raises.  No key skips this check.
//
// Slot (32 bytes): the hash, the key's first 16 bytes zero-padded (w0, w1)
// and a reference: the entry's arena offset in the high 40 bits, its length
// capped at 2^24 - 1 in the low 24.  A key of at most 16 bytes (nearly every
// word) is compared inside its slot, with no arena read.  Arena entry, in
// insertion order: u64 hash, u64 length, the bytes; the arena starts with 8
// bytes of padding so that no live reference is 0 (0 marks an empty slot).
//
// Not thread-safe: one dictionary per job thread.  ctypes releases the GIL
// around every call.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include <sys/mman.h>

namespace {

constexpr uint64_t kLenBits = 24;
constexpr uint64_t kLenCap = (uint64_t{1} << kLenBits) - 1;
constexpr int64_t kPrefetch = 16;  // keys ahead whose slot and rep to fetch
constexpr size_t kHuge = size_t{2} << 20;  // the table's alignment

enum : int64_t { kCollision = -1, kNoMemory = -2 };

struct Slot {
  uint64_t h;
  uint64_t w0;
  uint64_t w1;
  uint64_t ref;  // arena offset << 24 | min(length, 2^24 - 1); 0 = empty
};

inline bool is_ws(uint8_t c) { return c == ' ' || uint8_t(c - '\t') < 5; }

inline uint8_t lower(uint8_t c) {
  return uint8_t(c - 'A') < 26 ? uint8_t(c | 0x20) : c;
}

struct Dict {
  Slot* slots = nullptr;
  uint64_t cap = 0;  // a power of two
  int shift = 64;
  int64_t n = 0;
  int64_t nbytes = 0;  // the keys' bytes, summed
  std::vector<uint8_t> arena;
  std::vector<uint8_t> key;  // scratch: the key being checked

  Dict() : arena(8, 0) {}
  ~Dict() { std::free(slots); }

  uint64_t index(uint64_t h) const {
    return (h * 0x9E3779B97F4A7C15ull) >> shift;
  }

  // A table of new_cap empty slots, the live ones moved in.  It is aligned
  // to 2 MiB and asks for huge pages: a probe lands anywhere in tens of MB,
  // and with 4 KiB pages most probes also miss the TLB.
  bool alloc(uint64_t new_cap) {
    size_t bytes = (new_cap * sizeof(Slot) + kHuge - 1) & ~(kHuge - 1);
    Slot* s = static_cast<Slot*>(std::aligned_alloc(kHuge, bytes));
    if (s == nullptr) return false;
    madvise(s, bytes, MADV_HUGEPAGE);  // a hint; no error matters
    std::memset(s, 0, bytes);
    Slot* old = slots;
    uint64_t old_cap = cap;
    slots = s;
    cap = new_cap;
    shift = 64 - __builtin_ctzll(new_cap);
    for (uint64_t i = 0; i < old_cap; i++) {
      if (old[i].ref == 0) continue;
      uint64_t j = index(old[i].h);
      while (slots[j].ref != 0) j = (j + 1) & (cap - 1);
      slots[j] = old[i];
    }
    std::free(old);
    return true;
  }

  // the entry's bytes and length from its arena header
  const uint8_t* bytes_of(const Slot& s, uint64_t* len) const {
    const uint8_t* e = arena.data() + (s.ref >> kLenBits);
    std::memcpy(len, e + 8, 8);
    return e + 16;
  }

  // 1: inserted, 0: known with equal bytes, kCollision (the slot's offset in
  // *where), kNoMemory.  The load stays at most 3/5.
  int64_t upsert(uint64_t h, const uint8_t* k, uint64_t len, int64_t* where) {
    if (uint64_t(n + 1) * 5 > cap * 3 && !alloc(cap ? cap * 2 : 1 << 16))
      return kNoMemory;
    uint64_t w[2] = {0, 0};
    std::memcpy(w, k, len < 16 ? len : 16);
    uint64_t j = index(h);
    for (;;) {
      Slot& s = slots[j];
      if (s.ref == 0) break;
      if (s.h == h) {
        uint64_t slen = s.ref & kLenCap;
        bool same = slen == (len < kLenCap ? len : kLenCap) && s.w0 == w[0] &&
                    s.w1 == w[1];
        if (same && len > 16) {
          const uint8_t* stored = bytes_of(s, &slen);
          same = slen == len && std::memcmp(stored, k, len) == 0;
        }
        if (same) return 0;
        *where = int64_t(s.ref >> kLenBits);
        return kCollision;
      }
      j = (j + 1) & (cap - 1);
    }
    uint64_t off = arena.size();
    try {
      arena.resize(off + 16 + len);
    } catch (const std::bad_alloc&) {
      return kNoMemory;
    }
    uint8_t* e = arena.data() + off;
    std::memcpy(e, &h, 8);
    std::memcpy(e + 8, &len, 8);
    if (len) std::memcpy(e + 16, k, len);
    slots[j] = Slot{h, w[0], w[1],
                    off << kLenBits | (len < kLenCap ? len : kLenCap)};
    n++;
    nbytes += int64_t(len);
    return 1;
  }

  // the key at rep, lowercased, into the scratch buffer
  void scan(const uint8_t* c, uint64_t L, uint64_t r, int ngram) {
    key.clear();
    uint64_t e = r < L ? r : L;
    for (int m = 0; m < ngram; m++) {
      uint64_t b = e;
      if (m) {
        while (b < L && is_ws(c[b])) b++;
        key.push_back(' ');
      }
      e = b;
      while (e < L && !is_ws(c[e])) e++;
      size_t at = key.size();
      key.resize(at + (e - b));
      uint8_t* out = key.data() + at;
      for (uint64_t i = b; i < e; i++) *out++ = lower(c[i]);
    }
  }
};

}  // namespace

extern "C" {

void* dd_new() {
  Dict* d = new (std::nothrow) Dict();
  if (d != nullptr && !d->alloc(1 << 16)) {
    delete d;
    return nullptr;
  }
  return d;
}

void dd_free(void* p) { delete static_cast<Dict*>(p); }

int64_t dd_len(void* p) { return static_cast<Dict*>(p)->n; }

int64_t dd_bytes(void* p) { return static_cast<Dict*>(p)->nbytes; }

// One chunk's keys: hi[i] << 32 | lo[i] is key i's hash and rep[i] the offset
// of one of its occurrences in chunk[0, chunk_len).  Returns the number of
// keys new to the dictionary, kCollision with info = {the key's index, the
// stored key's arena offset, the key's rep, the hash}, or kNoMemory.
int64_t dd_add_chunk(void* p, const uint8_t* chunk, int64_t chunk_len,
                     const uint32_t* hi, const uint32_t* lo,
                     const uint32_t* rep, int64_t nu, int32_t ngram,
                     int64_t* info) {
  Dict* d = static_cast<Dict*>(p);
  const uint64_t L = uint64_t(chunk_len);
  int64_t added = 0;
  try {
    for (int64_t i = 0; i < nu; i++) {
      if (i + kPrefetch < nu) {
        int64_t a = i + kPrefetch;
        uint64_t ha = uint64_t(hi[a]) << 32 | lo[a];
        __builtin_prefetch(&d->slots[d->index(ha)]);
        if (rep[a] < L) __builtin_prefetch(chunk + rep[a]);
      }
      uint64_t h = uint64_t(hi[i]) << 32 | lo[i];
      d->scan(chunk, L, rep[i], ngram);
      int64_t where = 0;
      int64_t rc = d->upsert(h, d->key.data(), d->key.size(), &where);
      if (rc == kCollision) {
        info[0] = i;
        info[1] = where;
        info[2] = rep[i];
        info[3] = int64_t(h);
        return kCollision;
      }
      if (rc == kNoMemory) return kNoMemory;
      added += rc;
    }
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  return added;
}

// Checked insert of columns (a restored snapshot, another dictionary): key i
// is blob[sum(lens[:i]), + lens[i]) under hashes[i].  Returns the number of
// new keys, kCollision with info = {i, the stored key's arena offset}, or
// kNoMemory.
int64_t dd_add_arrays(void* p, const uint64_t* hashes, const int64_t* lens,
                      const uint8_t* blob, int64_t n, int64_t* info) {
  Dict* d = static_cast<Dict*>(p);
  int64_t added = 0;
  uint64_t off = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t where = 0;
    int64_t rc = d->upsert(hashes[i], blob + off, uint64_t(lens[i]), &where);
    if (rc == kCollision) {
      info[0] = i;
      info[1] = where;
      return kCollision;
    }
    if (rc == kNoMemory) return kNoMemory;
    added += rc;
    off += uint64_t(lens[i]);
  }
  return added;
}

// Every entry in insertion order: hashes[dd_len], lens[dd_len], and the keys'
// bytes back to back in blob[dd_bytes], or with sep >= 0 each key followed
// by the byte sep, in blob[dd_bytes + dd_len].
void dd_export(void* p, uint64_t* hashes, int64_t* lens, uint8_t* blob,
               int32_t sep) {
  const Dict* d = static_cast<Dict*>(p);
  const uint8_t* e = d->arena.data() + 8;
  for (int64_t i = 0; i < d->n; i++) {
    uint64_t len;
    std::memcpy(&hashes[i], e, 8);
    std::memcpy(&len, e + 8, 8);
    lens[i] = int64_t(len);
    std::memcpy(blob, e + 16, len);
    blob += len;
    if (sep >= 0) *blob++ = uint8_t(sep);
    e += 16 + len;
  }
}

// The bytes of the key under h (valid until the next insert) and their
// length in *len, or null when h is absent.
const uint8_t* dd_find(void* p, uint64_t h, int64_t* len) {
  const Dict* d = static_cast<Dict*>(p);
  uint64_t j = d->index(h);
  for (;;) {
    const Slot& s = d->slots[j];
    if (s.ref == 0) return nullptr;
    if (s.h == h) {
      uint64_t n;
      const uint8_t* b = d->bytes_of(s, &n);
      *len = int64_t(n);
      return b;
    }
    j = (j + 1) & (d->cap - 1);
  }
}

}  // extern "C"
