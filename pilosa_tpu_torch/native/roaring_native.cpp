// Native roaring codec + CSV parser — the host-IO hot path of the port.
//
// A copy of pilosa_tpu/native/roaring_native.cpp, built and loaded by
// pilosa_tpu_torch/native/__init__.py (the port never loads the JAX
// package's library).  What stays hot on the *host* is file IO around
// the device: decoding roaring snapshots on fragment open (reference
// format: roaring/roaring.go:507-660), re-encoding on snapshot, op-log
// replay with per-record FNV-1a checksums, and CSV bit parsing and
// formatting on bulk import and export (reference: ctl/import.go,
// ctl/export.go).  Python falls back to pilosa_tpu_torch/ops/roaring.py
// when the library is unavailable, and the two are kept byte-identical
// by parity tests.
//
// Build: g++ -O3 -mpopcnt -std=c++17 -shared -fPIC.
// ABI: plain C functions over caller-owned buffers + one opaque handle
// for decode results (ctypes-friendly; no pybind11 dependency).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kCookie = 12346;
constexpr int64_t kHeaderSize = 8;
constexpr int64_t kArrayMaxSize = 4096;
constexpr int64_t kContainerBits = 1 << 16;
constexpr int64_t kContainerWords = kContainerBits / 64;  // 1024
constexpr int64_t kOpSize = 13;

uint32_t fnv1a32(const uint8_t* data, int64_t n) {
  uint32_t h = 0x811C9DC5u;
  for (int64_t i = 0; i < n; i++) {
    h ^= data[i];
    h *= 0x01000193u;
  }
  return h;
}

uint16_t rd16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}
uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

void wr32(uint8_t* p, uint32_t v) { std::memcpy(p, &v, 4); }
void wr64(uint8_t* p, uint64_t v) { std::memcpy(p, &v, 8); }

struct Bitmap {
  // ordered: iteration yields sorted keys, matching the Python codec
  std::map<uint64_t, std::vector<uint64_t>> containers;
  int64_t ops = 0;
  std::string error;
};

void set_err(Bitmap* bm, const char* msg) { bm->error = msg; }

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

// Parse a roaring file (containers + op-log).  Returns a handle; check
// ptpu_error() before using it.  (reference: roaring/roaring.go:567-660)
void* ptpu_decode(const uint8_t* data, int64_t len) {
  auto* bm = new Bitmap();
  if (len < kHeaderSize) {
    set_err(bm, "data too small");
    return bm;
  }
  uint32_t cookie = rd32(data);
  uint32_t key_n = rd32(data + 4);
  if (cookie != kCookie) {
    set_err(bm, "invalid roaring file");
    return bm;
  }
  if (kHeaderSize + (int64_t)key_n * 16 > len) {
    bm->error = "header claims " + std::to_string(key_n) +
                " containers but file is " + std::to_string(len) + " bytes";
    return bm;
  }
  const uint8_t* headers = data + kHeaderSize;
  const uint8_t* offsets = headers + (int64_t)key_n * 12;
  int64_t ops_offset = kHeaderSize + (int64_t)key_n * 16;
  for (uint32_t i = 0; i < key_n; i++) {
    uint64_t key = rd64(headers + (int64_t)i * 12);
    int64_t n = (int64_t)rd32(headers + (int64_t)i * 12 + 8) + 1;
    uint32_t offset = rd32(offsets + (int64_t)i * 4);
    if ((int64_t)offset >= len) {
      set_err(bm, "offset out of bounds");
      return bm;
    }
    int64_t payload = (n <= kArrayMaxSize) ? n * 4 : kContainerWords * 8;
    if ((int64_t)offset + payload > len) {
      set_err(bm, "container payload out of bounds");
      return bm;
    }
    std::vector<uint64_t> words(kContainerWords, 0);
    if (n <= kArrayMaxSize) {
      const uint8_t* vals = data + offset;
      for (int64_t j = 0; j < n; j++) {
        uint32_t v = rd32(vals + j * 4);
        if (v >= kContainerBits) {
          set_err(bm, "array value out of range");
          return bm;
        }
        words[v >> 6] |= (uint64_t)1 << (v & 63);
      }
    } else {
      std::memcpy(words.data(), data + offset, kContainerWords * 8);
    }
    bm->containers[key] = std::move(words);
    int64_t end = (int64_t)offset + payload;
    if (end > ops_offset) ops_offset = end;
  }

  // op-log replay (reference: roaring/roaring.go:622-646)
  int64_t pos = ops_offset;
  while (pos < len) {
    if (len - pos < kOpSize) {
      set_err(bm, "op data out of bounds");
      return bm;
    }
    uint8_t typ = data[pos];
    uint64_t value = rd64(data + pos + 1);
    uint32_t chk = rd32(data + pos + 9);
    if (chk != fnv1a32(data + pos, 9)) {
      set_err(bm, "checksum mismatch");
      return bm;
    }
    uint64_t key = value >> 16;
    uint64_t off = value & 0xFFFF;
    auto it = bm->containers.find(key);
    if (it == bm->containers.end()) {
      it = bm->containers.emplace(key, std::vector<uint64_t>(kContainerWords, 0))
               .first;
    }
    uint64_t mask = (uint64_t)1 << (off & 63);
    if (typ == 0) {
      it->second[off >> 6] |= mask;
    } else if (typ == 1) {
      it->second[off >> 6] &= ~mask;
    } else {
      set_err(bm, "invalid op type");
      return bm;
    }
    pos += kOpSize;
    bm->ops++;
  }
  return bm;
}

const char* ptpu_error(void* h) {
  auto* bm = static_cast<Bitmap*>(h);
  return bm->error.empty() ? nullptr : bm->error.c_str();
}

// ---------------------------------------------------------------------------
// tiered decode: array containers stay as sorted value vectors (pay-per-bit;
// a tall-sparse file has one array container per row), bitmap containers as
// word vectors.  Mirrors ops/roaring.decode_tiered.
// ---------------------------------------------------------------------------

// Tiered decode result.  Containers UNTOUCHED by the op-log are kept as
// offsets into the caller's input buffer (typically an mmap of the data
// file) and only memcpy'd once, straight into the caller's numpy
// arrays at extract time; op-touched containers materialize
// copy-on-write.  Post-snapshot files carry at most a few thousand ops,
// so this keeps peak native heap at O(touched) instead of O(file).
// The input pointer must stay valid until ptpu_t_extract — the Python
// wrapper performs decode+extract in one call while holding the mmap.
struct Tiered {
  const uint8_t* input = nullptr;
  std::map<uint64_t, int64_t> word_offs;    // key -> input offset
  std::map<uint64_t, std::vector<uint64_t>> words;  // op-touched
  struct ArrRef { int64_t off; int64_t n; };
  std::map<uint64_t, ArrRef> array_offs;    // key -> input run
  std::map<uint64_t, std::vector<uint32_t>> arrays;  // op-touched
  int64_t ops = 0;
  int64_t total_vals = 0;
  std::string error;

  void materialize_words(uint64_t key) {
    auto it = word_offs.find(key);
    if (it == word_offs.end()) return;
    std::vector<uint64_t> w(kContainerWords);
    std::memcpy(w.data(), input + it->second, kContainerWords * 8);
    words[key] = std::move(w);
    word_offs.erase(it);
  }

  void materialize_array(uint64_t key) {
    auto it = array_offs.find(key);
    if (it == array_offs.end()) return;
    std::vector<uint32_t> vals((size_t)it->second.n);
    std::memcpy(vals.data(), input + it->second.off, (size_t)it->second.n * 4);
    arrays[key] = std::move(vals);
    array_offs.erase(it);
  }
};

void* ptpu_decode_tiered(const uint8_t* data, int64_t len) {
  auto* t = new Tiered();
  t->input = data;
  if (len < kHeaderSize) {
    t->error = "data too small";
    return t;
  }
  uint32_t cookie = rd32(data);
  uint32_t key_n = rd32(data + 4);
  if (cookie != kCookie) {
    t->error = "invalid roaring file";
    return t;
  }
  if (kHeaderSize + (int64_t)key_n * 16 > len) {
    t->error = "header claims " + std::to_string(key_n) +
               " containers but file is " + std::to_string(len) + " bytes";
    return t;
  }
  const uint8_t* headers = data + kHeaderSize;
  const uint8_t* offsets = headers + (int64_t)key_n * 12;
  int64_t ops_offset = kHeaderSize + (int64_t)key_n * 16;
  for (uint32_t i = 0; i < key_n; i++) {
    uint64_t key = rd64(headers + (int64_t)i * 12);
    int64_t n = (int64_t)rd32(headers + (int64_t)i * 12 + 8) + 1;
    uint32_t offset = rd32(offsets + (int64_t)i * 4);
    if ((int64_t)offset >= len) {
      t->error = "offset out of bounds";
      return t;
    }
    int64_t payload = (n <= kArrayMaxSize) ? n * 4 : kContainerWords * 8;
    if ((int64_t)offset + payload > len) {
      t->error = "container payload out of bounds";
      return t;
    }
    if (n <= kArrayMaxSize) {
      // Validate in place; store only the input run.
      uint32_t prev = 0;
      for (int64_t j = 0; j < n; j++) {
        uint32_t v = rd32(data + offset + j * 4);
        if (v >= kContainerBits) {
          t->error = "array value out of range";
          return t;
        }
        if (j > 0 && v <= prev) {
          t->error = "array container is not sorted/unique";
          return t;
        }
        prev = v;
      }
      t->total_vals += n;
      t->array_offs[key] = Tiered::ArrRef{(int64_t)offset, n};
    } else {
      t->word_offs[key] = (int64_t)offset;
    }
    int64_t end = (int64_t)offset + payload;
    if (end > ops_offset) ops_offset = end;
  }

  // op-log replay over tiered forms
  int64_t pos = ops_offset;
  while (pos < len) {
    if (len - pos < kOpSize) {
      t->error = "op data out of bounds";
      return t;
    }
    uint8_t typ = data[pos];
    uint64_t value = rd64(data + pos + 1);
    uint32_t chk = rd32(data + pos + 9);
    if (chk != fnv1a32(data + pos, 9)) {
      t->error = "checksum mismatch";
      return t;
    }
    if (typ > 1) {
      t->error = "invalid op type";
      return t;
    }
    uint64_t key = value >> 16;
    uint32_t low = (uint32_t)(value & 0xFFFF);
    // Copy-on-write: an op touching an offset-tier container
    // materializes it first.
    t->materialize_words(key);
    auto wit = t->words.find(key);
    if (wit != t->words.end()) {
      uint64_t mask = (uint64_t)1 << (low & 63);
      if (typ == 0)
        wit->second[low >> 6] |= mask;
      else
        wit->second[low >> 6] &= ~mask;
    } else {
      t->materialize_array(key);
      auto& vals = t->arrays[key];  // creates empty on first touch
      auto it = std::lower_bound(vals.begin(), vals.end(), low);
      bool present = it != vals.end() && *it == low;
      if (typ == 0 && !present) {
        vals.insert(it, low);
        t->total_vals++;
      } else if (typ == 1 && present) {
        vals.erase(it);
        t->total_vals--;
      }
    }
    pos += kOpSize;
    t->ops++;
  }
  return t;
}

const char* ptpu_t_error(void* h) {
  auto* t = static_cast<Tiered*>(h);
  return t->error.empty() ? nullptr : t->error.c_str();
}

int64_t ptpu_t_ops(void* h) { return static_cast<Tiered*>(h)->ops; }

void ptpu_t_counts(void* h, int64_t* n_words, int64_t* n_arrays,
                   int64_t* total_vals) {
  auto* t = static_cast<Tiered*>(h);
  *n_words = (int64_t)(t->words.size() + t->word_offs.size());
  *n_arrays = (int64_t)(t->arrays.size() + t->array_offs.size());
  *total_vals = t->total_vals;
}

// Fill wkeys[nw], wwords[nw*1024], akeys[na], alens[na], avals[total].
void ptpu_t_extract(void* h, uint64_t* wkeys, uint64_t* wwords, uint64_t* akeys,
                    int64_t* alens, uint32_t* avals) {
  // Two-way sorted merge of the offset tier (copied straight from the
  // caller's input buffer — its single copy) and the op-touched tier.
  auto* t = static_cast<Tiered*>(h);
  int64_t i = 0;
  auto wo = t->word_offs.begin();
  auto wm = t->words.begin();
  while (wo != t->word_offs.end() || wm != t->words.end()) {
    bool take_off =
        wm == t->words.end() ||
        (wo != t->word_offs.end() && wo->first < wm->first);
    if (take_off) {
      wkeys[i] = wo->first;
      std::memcpy(wwords + i * kContainerWords, t->input + wo->second,
                  kContainerWords * 8);
      ++wo;
    } else {
      wkeys[i] = wm->first;
      std::memcpy(wwords + i * kContainerWords, wm->second.data(),
                  kContainerWords * 8);
      ++wm;
    }
    i++;
  }
  int64_t j = 0, at = 0;
  auto ao = t->array_offs.begin();
  auto am = t->arrays.begin();
  while (ao != t->array_offs.end() || am != t->arrays.end()) {
    bool take_off =
        am == t->arrays.end() ||
        (ao != t->array_offs.end() && ao->first < am->first);
    if (take_off) {
      akeys[j] = ao->first;
      alens[j] = ao->second.n;
      std::memcpy(avals + at, t->input + ao->second.off, ao->second.n * 4);
      at += ao->second.n;
      ++ao;
    } else {
      akeys[j] = am->first;
      alens[j] = (int64_t)am->second.size();
      std::memcpy(avals + at, am->second.data(), am->second.size() * 4);
      at += (int64_t)am->second.size();
      ++am;
    }
    j++;
  }
}

void ptpu_t_free(void* h) { delete static_cast<Tiered*>(h); }

int64_t ptpu_nkeys(void* h) {
  return (int64_t)static_cast<Bitmap*>(h)->containers.size();
}

int64_t ptpu_ops(void* h) { return static_cast<Bitmap*>(h)->ops; }

// Fill keys[nkeys] and words[nkeys*1024] (sorted by key).
void ptpu_extract(void* h, uint64_t* keys, uint64_t* words) {
  auto* bm = static_cast<Bitmap*>(h);
  int64_t i = 0;
  for (const auto& [key, w] : bm->containers) {
    keys[i] = key;
    std::memcpy(words + i * kContainerWords, w.data(), kContainerWords * 8);
    i++;
  }
}

void ptpu_free(void* h) { delete static_cast<Bitmap*>(h); }

// ---------------------------------------------------------------------------
// encode
// ---------------------------------------------------------------------------

// keys must be sorted ascending; words is nkeys*1024 u64.  Empty
// containers are dropped, n<=4096 written as sorted u32 arrays
// (reference: roaring/roaring.go:507-565).  Two-phase: size, then fill.
int64_t ptpu_encode_size(const uint64_t* keys, const uint64_t* words,
                         int64_t nkeys) {
  (void)keys;
  int64_t n_used = 0, payload = 0;
  for (int64_t i = 0; i < nkeys; i++) {
    const uint64_t* w = words + i * kContainerWords;
    int64_t n = 0;
    for (int64_t j = 0; j < kContainerWords; j++) n += __builtin_popcountll(w[j]);
    if (n == 0) continue;
    n_used++;
    payload += (n <= kArrayMaxSize) ? n * 4 : kContainerWords * 8;
  }
  return kHeaderSize + n_used * 16 + payload;
}

int64_t ptpu_encode(const uint64_t* keys, const uint64_t* words, int64_t nkeys,
                    uint8_t* out, int64_t cap) {
  // first pass: counts
  std::vector<int64_t> ns;
  std::vector<int64_t> used;
  ns.reserve(nkeys);
  for (int64_t i = 0; i < nkeys; i++) {
    const uint64_t* w = words + i * kContainerWords;
    int64_t n = 0;
    for (int64_t j = 0; j < kContainerWords; j++) n += __builtin_popcountll(w[j]);
    if (n == 0) continue;
    used.push_back(i);
    ns.push_back(n);
  }
  int64_t n_used = (int64_t)used.size();
  int64_t header_len = kHeaderSize + n_used * 12;
  int64_t offsets_at = header_len;
  int64_t total = header_len + n_used * 4;
  for (int64_t n : ns) total += (n <= kArrayMaxSize) ? n * 4 : kContainerWords * 8;
  if (total > cap) return -1;

  wr32(out, kCookie);
  wr32(out + 4, (uint32_t)n_used);
  int64_t payload_at = offsets_at + n_used * 4;
  for (int64_t i = 0; i < n_used; i++) {
    wr64(out + kHeaderSize + i * 12, keys[used[i]]);
    wr32(out + kHeaderSize + i * 12 + 8, (uint32_t)(ns[i] - 1));
    wr32(out + offsets_at + i * 4, (uint32_t)payload_at);
    const uint64_t* w = words + used[i] * kContainerWords;
    if (ns[i] <= kArrayMaxSize) {
      uint8_t* p = out + payload_at;
      for (int64_t j = 0; j < kContainerWords; j++) {
        uint64_t word = w[j];
        while (word) {
          int bit = __builtin_ctzll(word);
          wr32(p, (uint32_t)(j * 64 + bit));
          p += 4;
          word &= word - 1;
        }
      }
      payload_at += ns[i] * 4;
    } else {
      std::memcpy(out + payload_at, w, kContainerWords * 8);
      payload_at += kContainerWords * 8;
    }
  }
  return total;
}

// One 13-byte op-log record (reference: roaring/roaring.go:1746-1762).
void ptpu_encode_op(uint8_t typ, uint64_t value, uint8_t* out13) {
  out13[0] = typ;
  wr64(out13 + 1, value);
  wr32(out13 + 9, fnv1a32(out13, 9));
}

// ---------------------------------------------------------------------------
// CSV bit parsing (import hot path; reference: ctl/import.go:95-175)
// ---------------------------------------------------------------------------

// Parse "row,col\n" records into rows[]/cols[].  Blank lines and \r\n
// tolerated.  Returns the record count, or:
//   -1  malformed number / structure (caller falls back to Python csv)
//   -2  a record has a third field (timestamps need Python's datetime)
//   -3  capacity exceeded
int64_t ptpu_parse_csv(const uint8_t* buf, int64_t len, uint64_t* rows,
                       uint64_t* cols, int64_t cap) {
  int64_t n = 0;
  int64_t i = 0;
  while (i < len) {
    // skip blank lines
    if (buf[i] == '\n' || buf[i] == '\r') {
      i++;
      continue;
    }
    uint64_t row = 0, col = 0;
    bool any = false;
    while (i < len && buf[i] >= '0' && buf[i] <= '9') {
      uint64_t d = buf[i] - '0';
      if (row > (UINT64_MAX - d) / 10) return -1;  // overflow: loud fallback
      row = row * 10 + d;
      i++;
      any = true;
    }
    if (!any || i >= len || buf[i] != ',') return -1;
    i++;
    any = false;
    while (i < len && buf[i] >= '0' && buf[i] <= '9') {
      uint64_t d = buf[i] - '0';
      if (col > (UINT64_MAX - d) / 10) return -1;
      col = col * 10 + d;
      i++;
      any = true;
    }
    if (!any) return -1;
    if (i < len && buf[i] == ',') return -2;  // timestamp column
    while (i < len && buf[i] == '\r') i++;
    if (i < len && buf[i] != '\n') return -1;
    if (n >= cap) return -3;
    rows[n] = row;
    cols[n] = col;
    n++;
    i++;  // consume '\n' (or past EOF)
  }
  return n;
}

// ---------------------------------------------------------------------------
// CSV bit formatting (export hot path; reference: fragment.go:487-502 feeds
// ctl/export.go via buffered container iterators)
// ---------------------------------------------------------------------------

static inline int64_t fmt_u64(uint64_t v, uint8_t* out) {
  uint8_t tmp[20];
  int64_t n = 0;
  do {
    tmp[n++] = '0' + (v % 10);
    v /= 10;
  } while (v);
  for (int64_t i = 0; i < n; i++) out[i] = tmp[n - 1 - i];
  return n;
}

// Format n records as "row,col\n" into out (capacity cap bytes).
// Returns bytes written, or -3 if out ran out of space.
int64_t ptpu_format_csv(const uint64_t* rows, const uint64_t* cols, int64_t n,
                        uint8_t* out, int64_t cap) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; i++) {
    if (w + 43 > cap) return -3;  // 20 + ',' + 20 + '\n' worst case
    w += fmt_u64(rows[i], out + w);
    out[w++] = ',';
    w += fmt_u64(cols[i], out + w);
    out[w++] = '\n';
  }
  return w;
}

}  // extern "C"
