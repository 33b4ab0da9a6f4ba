// A zstd frame decoder (RFC 8878), decode only: the C++ twin of
// common/zstd.py's plain Python decoder, giving the same bytes.
//
// Built with g++ at first use (ops/_build.py::build_host) and called
// through ctypes.  Two entry points, both over a caller-owned buffer:
//
//   int64_t zstd_content_bound(src, n, &frames)
//       an upper bound of the bytes that every frame of src decodes to
//       (the content sizes where the frames state them, else the block
//       sizes), without decoding;
//   int64_t zstd_decompress(src, n, dst, cap, &frames)
//       decodes every frame of src (skippable frames are passed over)
//       into dst and returns the bytes written.
//
// Negative returns: -1 corrupt or truncated input, -2 dst too small,
// -3 the frame names a dictionary, -4 content checksum mismatch, -5 not
// a zstd frame, -6 out of memory.

#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr int64_t kMaxBlock = 1 << 17;

enum Error : int64_t {
  kCorrupt = -1,
  kDstSmall = -2,
  kDictionary = -3,
  kChecksum = -4,
  kNotZstd = -5,
  kNoMemory = -6,
};

struct Fail {
  int64_t code;
};

[[noreturn]] void fail(int64_t code) { throw Fail{code}; }
inline void check(bool ok) {
  if (!ok) fail(kCorrupt);
}

inline int highbit(uint32_t x) { return 31 - __builtin_clz(x); }

inline uint64_t load_le(const uint8_t* p, int64_t avail) {
  uint64_t v = 0;
  if (avail >= 8) {
    std::memcpy(&v, p, 8);
  } else if (avail > 0) {
    std::memcpy(&v, p, static_cast<size_t>(avail));
  }
  return v;
}

// A backward bitstream: read from the last bit toward the first; reads
// past the start give zero bits and drive pos negative.
struct Backward {
  const uint8_t* data;
  int64_t size;
  int64_t pos;

  Backward(const uint8_t* d, int64_t n) : data(d), size(n) {
    check(n > 0 && d[n - 1] != 0);
    pos = n * 8 - 8 + highbit(d[n - 1]);
  }

  inline uint64_t peek(int n) const {  // the n bits below pos
    int64_t low = pos - n;
    if (low >= 0) {
      int64_t byte = low >> 3;
      uint64_t w = load_le(data + byte, size - byte);
      return (w >> (low & 7)) & ((uint64_t(1) << n) - 1);
    }
    if (pos <= 0) return 0;
    uint64_t w = load_le(data, size);
    w &= (uint64_t(1) << pos) - 1;
    return (w << (-low)) & ((uint64_t(1) << n) - 1);
  }

  inline uint64_t read(int n) {
    if (n == 0) return 0;
    uint64_t v = peek(n);
    pos -= n;
    return v;
  }
};

struct Fse {
  int log = 0;
  std::vector<uint8_t> symbol;
  std::vector<uint8_t> nbits;
  std::vector<int32_t> base;

  void rle(uint8_t s) {
    log = 0;
    symbol.assign(1, s);
    nbits.assign(1, 0);
    base.assign(1, 0);
  }

  void build(const int16_t* freqs, int nsym, int accuracy) {
    log = accuracy;
    int size = 1 << accuracy;
    symbol.assign(size, 0);
    nbits.assign(size, 0);
    base.assign(size, 0);
    std::vector<uint32_t> state(nsym, 0);
    int high = size;
    for (int s = 0; s < nsym; ++s) {
      if (freqs[s] == -1) {
        symbol[--high] = static_cast<uint8_t>(s);
        state[s] = 1;
      }
    }
    int step = (size >> 1) + (size >> 3) + 3;
    int mask = size - 1;
    int pos = 0;
    for (int s = 0; s < nsym; ++s) {
      if (freqs[s] <= 0) continue;
      state[s] = freqs[s];
      for (int i = 0; i < freqs[s]; ++i) {
        symbol[pos] = static_cast<uint8_t>(s);
        do {
          pos = (pos + step) & mask;
        } while (pos >= high);
      }
    }
    check(pos == 0);
    for (int i = 0; i < size; ++i) {
      uint32_t next = state[symbol[i]]++;
      nbits[i] = static_cast<uint8_t>(accuracy - highbit(next));
      base[i] = static_cast<int32_t>((next << nbits[i]) - size);
    }
  }
};

// Parse an FSE table description at data[pos:end); returns the position
// after it.
int64_t read_fse(const uint8_t* data, int64_t pos, int64_t end, int max_log,
                 int max_symbol, Fse* out) {
  int64_t bit = pos * 8;
  const int64_t end_bit = end * 8;
  auto read = [&](int n) -> uint32_t {
    check(bit + n <= end_bit);
    int64_t byte = bit >> 3;
    uint64_t w = load_le(data + byte, end - byte);
    uint32_t v = static_cast<uint32_t>((w >> (bit & 7)) &
                                       ((uint64_t(1) << n) - 1));
    bit += n;
    return v;
  };
  int log = static_cast<int>(read(4)) + 5;
  check(log <= max_log);
  int remaining = 1 << log;
  int16_t freqs[256];
  int nsym = 0;
  while (remaining > 0 && nsym <= max_symbol) {
    int nb = highbit(remaining + 1) + 1;
    int value = static_cast<int>(read(nb));
    int lower = (1 << (nb - 1)) - 1;
    int threshold = (1 << nb) - 1 - (remaining + 1);
    if ((value & lower) < threshold) {
      bit -= 1;
      value &= lower;
    } else if (value > lower) {
      value -= threshold;
    }
    int prob = value - 1;
    remaining -= prob < 0 ? -prob : prob;
    freqs[nsym++] = static_cast<int16_t>(prob);
    if (prob == 0) {
      for (;;) {
        int repeat = static_cast<int>(read(2));
        for (int i = 0; i < repeat; ++i) {
          check(nsym < 256);
          freqs[nsym++] = 0;
        }
        if (repeat != 3) break;
      }
    }
  }
  check(remaining == 0 && nsym <= max_symbol + 1);
  out->build(freqs, nsym, log);
  return (bit + 7) >> 3;
}

struct Huffman {
  int log = 0;
  std::vector<uint8_t> symbol;
  std::vector<uint8_t> nbits;

  void build(const uint8_t* weights, int n) {
    uint32_t total = 0;
    for (int i = 0; i < n; ++i) {
      check(weights[i] <= 12);
      if (weights[i]) total += 1u << (weights[i] - 1);
    }
    check(total > 0);
    log = highbit(total) + 1;
    check(log <= 11);
    uint32_t rest = (1u << log) - total;
    check((rest & (rest - 1)) == 0);
    uint8_t all[256];
    std::memcpy(all, weights, n);
    check(n < 256);
    all[n] = static_cast<uint8_t>(highbit(rest) + 1);
    int nsym = n + 1;
    int size = 1 << log;
    symbol.assign(size, 0);
    nbits.assign(size, 0);
    int pos = 0;
    for (int w = 1; w <= log; ++w) {
      int span = 1 << (w - 1);
      uint8_t nb = static_cast<uint8_t>(log + 1 - w);
      for (int s = 0; s < nsym; ++s) {
        if (all[s] != w) continue;
        check(pos + span <= size);
        std::memset(&symbol[pos], s, span);
        std::memset(&nbits[pos], nb, span);
        pos += span;
      }
    }
    check(pos == size);
  }

  void decode(const uint8_t* stream, int64_t n, uint8_t* out,
              int64_t count) const {
    Backward bits(stream, n);
    const uint8_t* sym = symbol.data();
    const uint8_t* nb = nbits.data();
    for (int64_t i = 0; i < count; ++i) {
      uint32_t idx = static_cast<uint32_t>(bits.peek(log));
      out[i] = sym[idx];
      bits.pos -= nb[idx];
    }
    check(bits.pos == 0);
  }
};

// Returns the position after the tree description at data[pos:end).
int64_t read_huffman(const uint8_t* data, int64_t pos, int64_t end,
                     Huffman* out) {
  check(pos < end);
  int header = data[pos++];
  uint8_t weights[256];
  int n = 0;
  if (header >= 128) {
    n = header - 127;
    int64_t bytes = (n + 1) / 2;
    check(pos + bytes <= end);
    for (int i = 0; i < n; ++i) {
      uint8_t b = data[pos + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    out->build(weights, n);
    return pos + bytes;
  }
  int64_t stop = pos + header;
  check(stop <= end);
  Fse table;
  int64_t start = read_fse(data, pos, stop, 6, 255, &table);
  Backward bits(data + start, stop - start);
  uint32_t s1 = static_cast<uint32_t>(bits.read(table.log));
  uint32_t s2 = static_cast<uint32_t>(bits.read(table.log));
  for (;;) {
    check(n < 255);
    weights[n++] = table.symbol[s1];
    s1 = table.base[s1] + static_cast<uint32_t>(bits.read(table.nbits[s1]));
    if (bits.pos < 0) {
      check(n < 255);
      weights[n++] = table.symbol[s2];
      break;
    }
    check(n < 255);
    weights[n++] = table.symbol[s2];
    s2 = table.base[s2] + static_cast<uint32_t>(bits.read(table.nbits[s2]));
    if (bits.pos < 0) {
      check(n < 255);
      weights[n++] = table.symbol[s1];
      break;
    }
  }
  out->build(weights, n);
  return stop;
}

const uint32_t kLLBase[36] = {
    0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
    12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Defaults {
  Fse ll, of, ml;
  Defaults() {
    ll.build(kLLDefault, 36, 6);
    of.build(kOFDefault, 29, 5);
    ml.build(kMLDefault, 53, 6);
  }
};

const Defaults& defaults() {
  static const Defaults d;
  return d;
}

struct FrameState {
  Huffman huffman;
  bool has_huffman = false;
  Fse tables[3];  // LL, OF, ML
  bool has_table[3] = {false, false, false};
  uint64_t reps[3] = {1, 4, 8};
};

struct Out {
  uint8_t* dst;
  int64_t cap;
  int64_t len;
  void put(const uint8_t* src, int64_t n) {
    if (len + n > cap) fail(kDstSmall);
    std::memcpy(dst + len, src, static_cast<size_t>(n));
    len += n;
  }
  void fill(uint8_t b, int64_t n) {
    if (len + n > cap) fail(kDstSmall);
    std::memset(dst + len, b, static_cast<size_t>(n));
    len += n;
  }
};

// Decode the literals section at block[0:n) into lit; returns its size.
int64_t literals(const uint8_t* block, int64_t n, FrameState* st,
                 std::vector<uint8_t>* lit) {
  check(n > 0);
  int b0 = block[0];
  int kind = b0 & 3;
  int fmt = (b0 >> 2) & 3;
  if (kind == 0 || kind == 1) {
    int64_t size, head;
    if (fmt == 0 || fmt == 2) {
      size = b0 >> 3;
      head = 1;
    } else if (fmt == 1) {
      check(n >= 2);
      size = (b0 >> 4) + (block[1] << 4);
      head = 2;
    } else {
      check(n >= 3);
      size = (b0 >> 4) + (block[1] << 4) + (int64_t(block[2]) << 12);
      head = 3;
    }
    lit->resize(size);
    if (kind == 0) {
      check(head + size <= n);
      if (size) std::memcpy(lit->data(), block + head, size);
      return head + size;
    }
    check(head < n);
    if (size) std::memset(lit->data(), block[head], size);
    return head + 1;
  }
  static const int kHead[4] = {3, 3, 4, 5};
  static const int kBits[4] = {10, 10, 14, 18};
  int head = kHead[fmt], bits = kBits[fmt];
  check(head <= n);
  uint64_t value = 0;
  for (int i = 0; i < head; ++i) value |= uint64_t(block[i]) << (8 * i);
  int64_t regen = (value >> 4) & ((uint64_t(1) << bits) - 1);
  int64_t comp = value >> (4 + bits);
  check(head + comp <= n && regen <= kMaxBlock);
  const uint8_t* body = block + head;
  int64_t start = 0;
  if (kind == 2) {
    start = read_huffman(body, 0, comp, &st->huffman);
    st->has_huffman = true;
  } else {
    check(st->has_huffman);
  }
  lit->resize(regen);
  if (fmt == 0) {
    st->huffman.decode(body + start, comp - start, lit->data(), regen);
  } else {
    check(start + 6 <= comp);
    int64_t s1 = body[start] | (body[start + 1] << 8);
    int64_t s2 = body[start + 2] | (body[start + 3] << 8);
    int64_t s3 = body[start + 4] | (body[start + 5] << 8);
    int64_t p = start + 6;
    int64_t bounds[5] = {p, p + s1, p + s1 + s2, p + s1 + s2 + s3, comp};
    check(bounds[3] <= comp);
    int64_t quarter = (regen + 3) / 4;
    int64_t counts[4] = {quarter, quarter, quarter, regen - 3 * quarter};
    check(counts[3] >= 0);
    int64_t at = 0;
    for (int i = 0; i < 4; ++i) {
      st->huffman.decode(body + bounds[i], bounds[i + 1] - bounds[i],
                         lit->data() + at, counts[i]);
      at += counts[i];
    }
  }
  return head + comp;
}

void sequences(const uint8_t* block, int64_t n, int64_t pos, FrameState* st,
               const std::vector<uint8_t>& lit, Out* out, int64_t frame_start,
               int64_t window) {
  check(pos < n);
  int b0 = block[pos];
  int64_t count;
  if (b0 == 0) {
    check(pos + 1 == n);
    count = 0;
  } else if (b0 < 128) {
    count = b0;
    pos += 1;
  } else if (b0 < 255) {
    check(pos + 1 < n);
    count = ((b0 - 128) << 8) + block[pos + 1];
    pos += 2;
  } else {
    check(pos + 2 < n);
    count = block[pos + 1] + (block[pos + 2] << 8) + 0x7F00;
    pos += 3;
  }
  int64_t lp = 0;
  const int64_t nlit = static_cast<int64_t>(lit.size());
  if (count > 0) {
    check(pos < n);
    int modes = block[pos++];
    check((modes & 3) == 0);
    const Defaults& d = defaults();
    const Fse* def[3] = {&d.ll, &d.of, &d.ml};
    static const int kMaxLog[3] = {9, 8, 9};
    static const int kMaxSym[3] = {35, 31, 52};
    static const int kShift[3] = {6, 4, 2};
    for (int i = 0; i < 3; ++i) {
      int mode = (modes >> kShift[i]) & 3;
      if (mode == 0) {
        st->tables[i] = *def[i];
      } else if (mode == 1) {
        check(pos < n && block[pos] <= kMaxSym[i]);
        st->tables[i].rle(block[pos++]);
      } else if (mode == 2) {
        pos = read_fse(block, pos, n, kMaxLog[i], kMaxSym[i], &st->tables[i]);
      } else {
        check(st->has_table[i]);
      }
      st->has_table[i] = true;
    }
    const Fse& ll = st->tables[0];
    const Fse& of = st->tables[1];
    const Fse& ml = st->tables[2];
    Backward bits(block + pos, n - pos);
    uint32_t ll_s = static_cast<uint32_t>(bits.read(ll.log));
    uint32_t of_s = static_cast<uint32_t>(bits.read(of.log));
    uint32_t ml_s = static_cast<uint32_t>(bits.read(ml.log));
    uint64_t* reps = st->reps;
    for (int64_t k = 0; k < count; ++k) {
      int of_code = of.symbol[of_s];
      int ml_code = ml.symbol[ml_s];
      int ll_code = ll.symbol[ll_s];
      check(of_code <= 31 && ml_code <= 52 && ll_code <= 35);
      uint64_t ofv = (uint64_t(1) << of_code) + bits.read(of_code);
      int64_t match = kMLBase[ml_code] + bits.read(kMLBits[ml_code]);
      int64_t litlen = kLLBase[ll_code] + bits.read(kLLBits[ll_code]);
      if (k + 1 < count) {
        ll_s = ll.base[ll_s] + static_cast<uint32_t>(bits.read(ll.nbits[ll_s]));
        ml_s = ml.base[ml_s] + static_cast<uint32_t>(bits.read(ml.nbits[ml_s]));
        of_s = of.base[of_s] + static_cast<uint32_t>(bits.read(of.nbits[of_s]));
      }
      check(bits.pos >= 0);
      check(lp + litlen <= nlit);
      out->put(lit.data() + lp, litlen);
      lp += litlen;
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        reps[2] = reps[1];
        reps[1] = reps[0];
        reps[0] = offset;
      } else {
        uint64_t idx = litlen ? ofv - 1 : ofv;
        if (idx == 0) {
          offset = reps[0];
        } else if (idx == 3) {
          offset = reps[0] - 1;
          check(offset != 0);
          reps[2] = reps[1];
          reps[1] = reps[0];
          reps[0] = offset;
        } else if (idx == 1) {
          offset = reps[1];
          reps[1] = reps[0];
          reps[0] = offset;
        } else {
          offset = reps[2];
          reps[2] = reps[1];
          reps[1] = reps[0];
          reps[0] = offset;
        }
      }
      int64_t produced = out->len - frame_start;
      check(offset <= static_cast<uint64_t>(produced) &&
            offset <= static_cast<uint64_t>(window));
      if (out->len + match > out->cap) fail(kDstSmall);
      uint8_t* dst = out->dst + out->len;
      const uint8_t* src = dst - offset;
      if (offset >= static_cast<uint64_t>(match)) {
        std::memcpy(dst, src, static_cast<size_t>(match));
      } else {
        for (int64_t i = 0; i < match; ++i) dst[i] = src[i];
      }
      out->len += match;
    }
    check(bits.pos == 0);
  }
  if (lp < nlit) out->put(lit.data() + lp, nlit - lp);
}

// ---- xxhash64 -------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t round1(uint64_t acc, uint64_t lane) {
  acc += lane * P2;
  return rotl(acc, 31) * P1;
}
inline uint64_t merge(uint64_t acc, uint64_t v) {
  acc ^= round1(0, v);
  return acc * P1 + P4;
}
inline uint64_t le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint32_t le32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

uint64_t xxh64(const uint8_t* p, int64_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round1(v1, le64(p));
      v2 = round1(v2, le64(p + 8));
      v3 = round1(v3, le64(p + 16));
      v4 = round1(v4, le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(h, v1);
    h = merge(h, v2);
    h = merge(h, v3);
    h = merge(h, v4);
  } else {
    h = P5;
  }
  h += static_cast<uint64_t>(n);
  while (p + 8 <= end) {
    h = rotl(h ^ round1(0, le64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h = rotl(h ^ (*p * P5), 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ---- frames ---------------------------------------------------------

struct Header {
  int64_t size;  // -1 when the frame does not state it
  int64_t window;
  bool checksum;
  int64_t pos;  // the first block
};

Header frame_header(const uint8_t* src, int64_t n, int64_t pos) {
  check(pos < n);
  int fhd = src[pos++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
  int dict_flag = fhd & 3;
  check((fhd & 8) == 0);
  Header h{-1, -1, ((fhd >> 2) & 1) != 0, 0};
  if (!single) {
    check(pos < n);
    int wd = src[pos++];
    int log = 10 + (wd >> 3);
    check(log <= 41);
    h.window = (int64_t(1) << log) + ((int64_t(1) << log) >> 3) * (wd & 7);
  }
  static const int kDict[4] = {0, 1, 2, 4};
  int dsize = kDict[dict_flag];
  if (dsize) {
    check(pos + dsize <= n);
    uint32_t id = 0;
    for (int i = 0; i < dsize; ++i) id |= uint32_t(src[pos + i]) << (8 * i);
    if (id) fail(kDictionary);
    pos += dsize;
  }
  static const int kFcs[4] = {0, 2, 4, 8};
  int fsize = kFcs[fcs_flag];
  if (fcs_flag == 0 && single) fsize = 1;
  if (fsize) {
    check(pos + fsize <= n);
    uint64_t size = 0;
    for (int i = 0; i < fsize; ++i) size |= uint64_t(src[pos + i]) << (8 * i);
    if (fsize == 2) size += 256;
    check(size < (uint64_t(1) << 62));
    h.size = static_cast<int64_t>(size);
    pos += fsize;
  }
  if (h.window < 0) h.window = h.size;
  h.pos = pos;
  return h;
}

// An upper bound of the frame's content; returns the position after it.
int64_t frame_bound(const uint8_t* src, int64_t n, int64_t pos,
                    int64_t* bound) {
  Header h = frame_header(src, n, pos);
  pos = h.pos;
  int64_t max_block = h.window > 0 && h.window < kMaxBlock ? h.window
                                                           : kMaxBlock;
  int64_t total = 0;
  for (;;) {
    check(pos + 3 <= n);
    uint32_t head = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
    pos += 3;
    int last = head & 1, kind = (head >> 1) & 3;
    int64_t bsize = head >> 3;
    check(kind != 3);
    if (kind == 1) {
      check(pos < n);
      total += bsize;
      pos += 1;
    } else {
      check(pos + bsize <= n);
      total += kind == 0 ? bsize : max_block;
      pos += bsize;
    }
    if (last) break;
  }
  if (h.checksum) pos += 4;
  check(pos <= n);
  *bound += h.size >= 0 ? h.size : total;
  return pos;
}

int64_t decode_frame(const uint8_t* src, int64_t n, int64_t pos, Out* out) {
  Header h = frame_header(src, n, pos);
  pos = h.pos;
  int64_t start = out->len;
  int64_t max_block = h.window > 0 && h.window < kMaxBlock ? h.window
                                                           : kMaxBlock;
  int64_t window = h.window > 0 ? h.window : (int64_t(1) << 62);
  FrameState st;
  std::vector<uint8_t> lit;
  lit.reserve(kMaxBlock);
  for (;;) {
    check(pos + 3 <= n);
    uint32_t head = src[pos] | (src[pos + 1] << 8) | (src[pos + 2] << 16);
    pos += 3;
    int last = head & 1, kind = (head >> 1) & 3;
    int64_t bsize = head >> 3;
    check(kind != 3 && bsize <= max_block);
    if (kind == 1) {
      check(pos < n);
      out->fill(src[pos], bsize);
      pos += 1;
    } else {
      check(pos + bsize <= n);
      if (kind == 0) {
        out->put(src + pos, bsize);
      } else {
        int64_t before = out->len;
        int64_t lpos = literals(src + pos, bsize, &st, &lit);
        sequences(src + pos, bsize, lpos, &st, lit, out, start, window);
        check(out->len - before <= kMaxBlock);
      }
      pos += bsize;
    }
    if (last) break;
  }
  check(h.size < 0 || out->len - start == h.size);
  if (h.checksum) {
    check(pos + 4 <= n);
    uint32_t want = le32(src + pos);
    uint32_t got = static_cast<uint32_t>(
        xxh64(out->dst + start, out->len - start));
    if (want != got) fail(kChecksum);
    pos += 4;
  }
  return pos;
}

// Walk every frame: decode when out is set, else add to the bound.
int64_t walk(const uint8_t* src, int64_t n, Out* out, int64_t* bound,
             int64_t* frames) {
  int64_t pos = 0;
  int64_t count = 0;
  while (pos < n) {
    check(pos + 4 <= n);
    uint32_t magic = le32(src + pos);
    pos += 4;
    if ((magic & 0xFFFFFFF0u) == kSkippableMagic) {
      check(pos + 4 <= n);
      pos += 4 + static_cast<int64_t>(le32(src + pos));
      check(pos <= n);
      continue;
    }
    if (magic != kMagic) fail(kNotZstd);
    pos = out ? decode_frame(src, n, pos, out)
              : frame_bound(src, n, pos, bound);
    ++count;
  }
  check(count > 0);
  *frames = count;
  return 0;
}

}  // namespace

extern "C" {

int64_t zstd_content_bound(const uint8_t* src, int64_t n, int64_t* frames) {
  try {
    int64_t bound = 0;
    walk(src, n, nullptr, &bound, frames);
    return bound;
  } catch (const Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

int64_t zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap, int64_t* frames) {
  try {
    Out out{dst, cap, 0};
    int64_t unused = 0;
    walk(src, n, &out, &unused, frames);
    return out.len;
  } catch (const Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return kNoMemory;
  }
}

}  // extern "C"
