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
// The job's final_result.txt comes from here too (dd_write_counts): each
// readback row's key is found by its hash in the table, the rows are sorted
// by key bytes and formatted "{word} {count}\n" into blocks of a few MiB,
// each written to the caller's file descriptor in one call.
//
// Not thread-safe: one dictionary per job thread.  ctypes releases the GIL
// around every call.

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include <sys/mman.h>
#include <unistd.h>

namespace {

constexpr uint64_t kLenBits = 24;
constexpr uint64_t kLenCap = (uint64_t{1} << kLenBits) - 1;
constexpr int64_t kPrefetch = 16;  // keys ahead whose slot and rep to fetch
constexpr size_t kHuge = size_t{2} << 20;  // the table's alignment

constexpr size_t kBlock = size_t{4} << 20;  // bytes a write
// past a row's key: " ", a signed 64-bit count (20), "\n"; and the 16-byte
// copy of a short key
constexpr size_t kRowSlack = 64;

enum : int64_t {
  kCollision = -1,
  kNoMemory = -2,
  kMissing = -3,
  kDuplicate = -4,
  kIoError = -5,
};

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

  // the slot of h, or null
  const Slot* find(uint64_t h) const {
    uint64_t j = index(h);
    for (;;) {
      const Slot& s = slots[j];
      if (s.ref == 0) return nullptr;
      if (s.h == h) return &s;
      j = (j + 1) & (cap - 1);
    }
  }

  // the bytes and length of the entry at ref, from its arena header
  const uint8_t* key_at(uint64_t ref, uint64_t* len) const {
    const uint8_t* e = arena.data() + (ref >> kLenBits);
    std::memcpy(len, e + 8, 8);
    return e + 16;
  }

  // the key's length, read from the arena only past the reference's cap
  uint64_t len_of(uint64_t ref) const {
    uint64_t len = ref & kLenCap;
    if (len == kLenCap) key_at(ref, &len);
    return len;
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
          const uint8_t* stored = key_at(s.ref, &slen);
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

// One row of the write: the key's first 16 bytes zero-padded and read big-
// endian (so that their unsigned order is the bytes' order), the slot's
// reference and the count.
struct Row {
  uint64_t k0;
  uint64_t k1;
  uint64_t ref;
  int64_t val;
};

// Python's bytes order: unsigned lexicographic, the shorter key first on a
// common prefix.  Zero padding keeps the 16-byte prefixes in that order, so
// only equal prefixes read the keys.
struct RowLess {
  const Dict* d;
  bool operator()(const Row& a, const Row& b) const {
    if (a.k0 != b.k0) return a.k0 < b.k0;
    if (a.k1 != b.k1) return a.k1 < b.k1;
    return compare(a, b) < 0;
  }
  int compare(const Row& a, const Row& b) const {
    uint64_t la, lb;
    const uint8_t* pa = d->key_at(a.ref, &la);
    const uint8_t* pb = d->key_at(b.ref, &lb);
    int c = std::memcmp(pa, pb, la < lb ? la : lb);
    if (c != 0) return c;
    return la < lb ? -1 : la > lb;
  }
};

constexpr char kDigits[] =
    "0001020304050607080910111213141516171819"
    "2021222324252627282930313233343536373839"
    "4041424344454647484950515253545556575859"
    "6061626364656667686970717273747576777879"
    "8081828384858687888990919293949596979899";

// v in decimal, as Python's str(int(v)); returns the end
uint8_t* format_i64(int64_t v, uint8_t* out) {
  uint64_t u = uint64_t(v);
  if (v < 0) {
    *out++ = '-';
    u = 0 - u;
  }
  uint8_t tmp[20];
  int i = 20;
  while (u >= 100) {
    i -= 2;
    std::memcpy(tmp + i, kDigits + 2 * (u % 100), 2);
    u /= 100;
  }
  if (u >= 10) {
    i -= 2;
    std::memcpy(tmp + i, kDigits + 2 * u, 2);
  } else {
    tmp[--i] = uint8_t('0' + u);
  }
  std::memcpy(out, tmp + i, size_t(20 - i));
  return out + (20 - i);
}

// all of [p, p + n) to fd: 0, or the errno of the failed write
int write_all(int fd, const uint8_t* p, size_t n) {
  while (n > 0) {
    ssize_t w = ::write(fd, p, n);
    if (w < 0) {
      if (errno == EINTR) continue;
      return errno;
    }
    p += w;
    n -= size_t(w);
  }
  return 0;
}

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
  const Slot* s = d->find(h);
  if (s == nullptr) return nullptr;
  uint64_t n;
  const uint8_t* b = d->key_at(s->ref, &n);
  *len = int64_t(n);
  return b;
}

// The readback's rows as final_result.txt's bytes, written to fd: key i is
// the word under hashes[i], its count vals[i]; the rows sorted by word, each
// "{word} {count}\n", written in blocks of kBlock bytes.  Returns the rows
// written, or kMissing with info[0] = the index of a hash not in the table,
// kDuplicate with info[0] = the distinct words among the n rows, kIoError
// with info[0] = the write's errno, or kNoMemory.
int64_t dd_write_counts(void* p, const uint64_t* hashes, const int64_t* vals,
                        int64_t n, int32_t fd, int64_t* info) {
  const Dict* d = static_cast<Dict*>(p);
  try {
    std::vector<Row> rows(size_t(n > 0 ? n : 0));
    for (int64_t i = 0; i < n; i++) {
      if (i + kPrefetch < n)
        __builtin_prefetch(&d->slots[d->index(hashes[i + kPrefetch])]);
      const Slot* s = d->find(hashes[i]);
      if (s == nullptr) {
        info[0] = i;
        return kMissing;
      }
      rows[i] = Row{__builtin_bswap64(s->w0), __builtin_bswap64(s->w1),
                    s->ref, vals[i]};
    }
    RowLess less{d};
    std::sort(rows.begin(), rows.end(), less);
    int64_t dups = 0;
    for (int64_t i = 1; i < n; i++) {
      const Row& a = rows[i - 1];
      const Row& b = rows[i];
      dups += a.k0 == b.k0 && a.k1 == b.k1 && less.compare(a, b) == 0;
    }
    if (dups) {
      info[0] = n - dups;
      return kDuplicate;
    }
    std::vector<uint8_t> buf(kBlock + kRowSlack);
    uint8_t* out = buf.data();
    uint8_t* const full = buf.data() + kBlock;
    for (const Row& r : rows) {
      uint64_t len = d->len_of(r.ref);
      if (out + len > full) {
        int err = write_all(fd, buf.data(), size_t(out - buf.data()));
        out = buf.data();
        if (err == 0 && len > kBlock) {  // a key past a block goes alone
          uint64_t ignored;
          err = write_all(fd, d->key_at(r.ref, &ignored), len);
          len = 0;
        }
        if (err != 0) {
          info[0] = err;
          return kIoError;
        }
      }
      if (len <= 16) {  // the key is in the row; the copy past it is slack
        uint64_t w[2] = {__builtin_bswap64(r.k0), __builtin_bswap64(r.k1)};
        std::memcpy(out, w, 16);
      } else {
        uint64_t ignored;
        std::memcpy(out, d->key_at(r.ref, &ignored), len);
      }
      out += len;
      *out++ = ' ';
      out = format_i64(r.val, out);
      *out++ = '\n';
    }
    int err = write_all(fd, buf.data(), size_t(out - buf.data()));
    if (err != 0) {
      info[0] = err;
      return kIoError;
    }
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
  return n;
}

}  // extern "C"
