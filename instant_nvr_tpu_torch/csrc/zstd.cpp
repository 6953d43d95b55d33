// Host zstd decoder (RFC 8878), CRC32C and XXH64 for the port's reader of
// the JAX package's orbax checkpoints (train/orbax_format.py).
//
// Orbax writes every array as a zarr v2 chunk compressed with zstd, inside
// tensorstore's OCDBT key-value store, whose manifests and B-tree nodes are
// zstd frames too and end in a CRC32C.  The card's machine has no zstd
// module, so the port decodes here:
//   - frames: magic, the frame header (window descriptor, single segment,
//     frame content size, the content-checksum flag; a dictionary ID other
//     than 0 is refused, naming it), concatenated frames and skippable
//     frames;
//   - blocks: raw, RLE and compressed, up to min(window, 128 KiB) each;
//   - literals: raw, RLE, Huffman-coded with 1 or 4 streams, and treeless
//     (the previous block's table, kept across raw-literal blocks);
//   - Huffman weights, direct or FSE-coded, with the derived last weight;
//   - sequences: predefined, RLE, FSE-coded and repeat table modes for the
//     literal-length, match-length and offset codes, the three repeat
//     offsets with their literal-length-0 rule, and matches that reach into
//     earlier blocks of the frame and overlap their own output;
//   - the XXH64 content checksum, verified when the flag is set.
// Every read of the input and every write of the output is bounds-checked;
// malformed input throws, and the C interface returns the message, which
// the Python side raises as ValueError naming the file.
//
// C interface (ctypes, train/orbax_format.py); every call is reentrant:
//   zstd_content_size(src, n, err, errlen) -> total content size stated by
//       every frame, -1 if a frame does not state it, -2 on error
//   zstd_decompress(src, n, dst, cap, err, errlen) -> bytes written, -1 on
//       error, -2 if the output would exceed cap
//   crc32c(data, n)        -> CRC-32C (Castagnoli) of the bytes
//   xxh64(data, n, seed)   -> XXH64 of the bytes
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

struct OutOfRoom : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Corrupt(msg); }

uint64_t load_le(const uint8_t* p, int nbytes) {
  uint64_t v = 0;
  for (int i = 0; i < nbytes; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---------------------------------------------------------------- hashes

// slicing-by-8 tables of the reflected Castagnoli polynomial
struct Crc32cTables {
  uint32_t t[8][256];
  Crc32cTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (int i = 0; i < 256; ++i) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

const Crc32cTables& crc_tables() {
  static const Crc32cTables tables;  // built once, thread-safe
  return tables;
}

uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

const uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
               P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
               P5 = 0x27D4EB2F165667C5ull;

uint64_t xxh_round(uint64_t acc, uint64_t lane) {
  acc += lane * P2;
  acc = rotl64(acc, 31);
  return acc * P1;
}

uint64_t xxh_merge(uint64_t h, uint64_t v) {
  h ^= xxh_round(0, v);
  return h * P1 + P4;
}

uint64_t xxh64_impl(const uint8_t* p, uint64_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xxh_round(v1, load_le(p, 8));
      v2 = xxh_round(v2, load_le(p + 8, 8));
      v3 = xxh_round(v3, load_le(p + 16, 8));
      v4 = xxh_round(v4, load_le(p + 24, 8));
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += n;
  for (; end - p >= 8; p += 8) {
    h ^= xxh_round(0, load_le(p, 8));
    h = rotl64(h, 27) * P1 + P4;
  }
  if (end - p >= 4) {
    h ^= load_le(p, 4) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) {
    h ^= *p * P5;
    h = rotl64(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- bit readers

// A bitstream read backwards from its end, as FSE and Huffman streams are:
// the last byte's highest set bit marks the start, and bits are taken from
// the top down.  `pos` counts the bits left; a read may look past the
// start (the bits there are 0) only where the format allows it.
struct BackBits {
  const uint8_t* p = nullptr;
  int64_t n = 0;
  int64_t pos = 0;

  BackBits(const uint8_t* src, int64_t size, const char* what) : p(src), n(size) {
    if (size <= 0) fail(std::string(what) + ": empty bitstream");
    uint8_t last = src[size - 1];
    if (!last) fail(std::string(what) + ": bitstream's last byte is 0");
    pos = (size - 1) * 8 + highbit(last);
  }

  // bits [bit, bit + 57) of the stream, 0 beyond its end
  uint64_t window(int64_t bit) const {
    int64_t byte = bit >> 3;
    int avail = int(std::min<int64_t>(8, n - byte));
    uint64_t v = load_le(p + byte, avail);
    return v >> (bit & 7);
  }

  // the next k bits (k <= 56) without consuming them
  uint64_t peek(int k) const {
    if (k == 0 || pos <= 0) return 0;
    uint64_t mask = (uint64_t(1) << k) - 1;
    if (pos >= k) return window(pos - k) & mask;
    return (window(0) & ((uint64_t(1) << pos) - 1)) << (k - pos);
  }

  // consume k bits; past the start only when `padded`
  uint64_t read(int k, bool padded, const char* what) {
    uint64_t v = peek(k);
    pos -= k;
    if (pos < 0 && !padded) fail(std::string(what) + ": bitstream overread");
    return v;
  }
};

// A forward little-endian bitstream over a header (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  int64_t n;
  int64_t bit = 0;

  uint32_t read(int k, const char* what) {
    if (bit + k > n * 8) fail(std::string(what) + ": truncated table description");
    uint64_t v = 0;
    for (int i = 0; i < k; ++i, ++bit) v |= uint64_t((p[bit >> 3] >> (bit & 7)) & 1) << i;
    return uint32_t(v);
  }
  uint32_t peek(int k) const {
    uint64_t v = 0;
    for (int i = 0; i < k && bit + i < n * 8; ++i)
      v |= uint64_t((p[(bit + i) >> 3] >> ((bit + i) & 7)) & 1) << i;
    return uint32_t(v);
  }
};

// ---------------------------------------------------------------- FSE

struct FseCell {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;   // next state = base + read(nbits)
};

struct FseTable {
  int log = 0;
  std::vector<FseCell> cells;
  bool defined = false;

  void build(const int16_t* norm, int nsym, int accuracy_log, const char* what) {
    int size = 1 << accuracy_log;
    cells.assign(size, FseCell{0, 0, 0});
    std::vector<uint16_t> next(nsym);
    int high = size - 1;
    int total = 0;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] == -1) {
        cells[high--].symbol = uint16_t(s);
        next[s] = 1;
        total += 1;
      } else {
        next[s] = uint16_t(norm[s]);
        total += norm[s];
      }
    }
    if (total != size) fail(std::string(what) + ": probabilities do not sum to the table size");
    int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, position = 0;
    for (int s = 0; s < nsym; ++s)
      for (int i = 0; i < norm[s]; ++i) {
        cells[position].symbol = uint16_t(s);
        do position = (position + step) & mask;
        while (position > high);
      }
    if (position != 0) fail(std::string(what) + ": FSE table spread does not close");
    for (int u = 0; u < size; ++u) {
      int s = cells[u].symbol;
      uint32_t ns = next[s]++;
      int nb = accuracy_log - highbit(ns);
      cells[u].nbits = uint8_t(nb);
      cells[u].base = uint16_t((ns << nb) - size);
    }
    log = accuracy_log;
    defined = true;
  }

  // a single-symbol table (RLE mode)
  void rle(int symbol) {
    cells.assign(1, FseCell{uint16_t(symbol), 0, 0});
    log = 0;
    defined = true;
  }
};

// Read an FSE table description at p (at most n bytes); returns the bytes
// it took.  `max_log` bounds the accuracy log, `max_sym` the symbols.
int64_t read_fse_table(FseTable& t, const uint8_t* p, int64_t n, int max_log,
                       int max_sym, const char* what) {
  FwdBits bits{p, n};
  int log = int(bits.read(4, what)) + 5;
  if (log > max_log)
    fail(std::string(what) + ": accuracy log " + std::to_string(log) + " above " +
         std::to_string(max_log));
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int16_t norm[256] = {0};
  int sym = 0;
  while (remaining > 1) {
    if (sym > max_sym) fail(std::string(what) + ": too many symbols in FSE table");
    int max = (2 * threshold - 1) - remaining;
    int value;
    uint32_t low = bits.peek(nbits - 1) & (threshold - 1);
    if (int(low) < max) {
      value = int(bits.read(nbits - 1, what));
    } else {
      value = int(bits.read(nbits, what)) & (2 * threshold - 1);
      if (value >= threshold) value -= max;
    }
    int proba = value - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[sym++] = int16_t(proba);
    if (proba == 0) {
      for (;;) {
        int rep = int(bits.read(2, what));
        for (int i = 0; i < rep; ++i) {
          if (sym > max_sym) fail(std::string(what) + ": zero run past the last symbol");
          norm[sym++] = 0;
        }
        if (rep != 3) break;
      }
    }
    while (remaining < threshold && threshold > 1) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail(std::string(what) + ": FSE probabilities overflow the table");
  t.build(norm, sym, log, what);
  return (bits.bit + 7) >> 3;
}

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22,  23,  24,  25,   26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37,  39,  41,  43,   47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// ---------------------------------------------------------------- Huffman

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol;  // indexed by the next max_bits bits
  std::vector<uint8_t> nbits;
  bool defined = false;
};

// Read a Huffman tree description at p (at most n bytes) into t; returns
// the bytes it took.
int64_t read_huffman_tree(HufTable& t, const uint8_t* p, int64_t n) {
  const char* what = "Huffman tree";
  if (n < 1) fail("Huffman tree: truncated");
  int header = p[0];
  uint8_t weights[256];
  int nw = 0;
  int64_t used;
  if (header < 128) {
    if (header == 0 || 1 + header > n) fail("Huffman tree: truncated FSE-coded weights");
    FseTable ft;
    int64_t tl = read_fse_table(ft, p + 1, header, 6, 255, "Huffman weights");
    if (tl >= header) fail("Huffman tree: FSE weights have no bitstream");
    BackBits bits(p + 1 + tl, header - tl, what);
    int s1 = int(bits.read(ft.log, false, what));
    int s2 = int(bits.read(ft.log, false, what));
    for (;;) {
      if (nw > 254) fail("Huffman tree: more than 255 weights");
      weights[nw++] = uint8_t(ft.cells[s1].symbol);
      s1 = ft.cells[s1].base + int(bits.read(ft.cells[s1].nbits, true, what));
      if (bits.pos < 0) {
        weights[nw++] = uint8_t(ft.cells[s2].symbol);
        break;
      }
      if (nw > 254) fail("Huffman tree: more than 255 weights");
      weights[nw++] = uint8_t(ft.cells[s2].symbol);
      s2 = ft.cells[s2].base + int(bits.read(ft.cells[s2].nbits, true, what));
      if (bits.pos < 0) {
        weights[nw++] = uint8_t(ft.cells[s1].symbol);
        break;
      }
    }
    if (nw > 255) fail("Huffman tree: more than 255 weights");
    used = 1 + header;
  } else {
    nw = header - 127;
    int64_t nb = (nw + 1) / 2;
    if (1 + nb > n) fail("Huffman tree: truncated direct weights");
    for (int i = 0; i < nw; ++i) weights[i] = (i & 1) ? (p[1 + i / 2] & 15) : (p[1 + i / 2] >> 4);
    used = 1 + nb;
  }
  uint32_t sum = 0;
  for (int i = 0; i < nw; ++i) {
    if (weights[i] > 11) fail("Huffman tree: weight above 11");
    if (weights[i]) sum += 1u << (weights[i] - 1);
  }
  if (sum == 0) fail("Huffman tree: all weights are 0");
  int max_bits = highbit(sum) + 1;
  if (max_bits > 11) fail("Huffman tree: codes longer than 11 bits");
  uint32_t rest = (1u << max_bits) - sum;
  if (rest & (rest - 1)) fail("Huffman tree: weights do not complete a power of two");
  weights[nw++] = uint8_t(highbit(rest) + 1);
  // code lengths, then the table: longest codes first, by symbol in a rank
  uint8_t bitsof[256];
  int rank_count[13] = {0};
  for (int s = 0; s < nw; ++s) {
    bitsof[s] = weights[s] ? uint8_t(max_bits + 1 - weights[s]) : 0;
    rank_count[bitsof[s]]++;
  }
  int size = 1 << max_bits;
  t.symbol.assign(size, 0);
  t.nbits.assign(size, 0);
  uint32_t rank_idx[13] = {0};
  rank_idx[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) rank_idx[b - 1] = rank_idx[b] + rank_count[b] * (1u << (max_bits - b));
  if (rank_idx[0] != uint32_t(size)) fail("Huffman tree: code lengths do not fill the table");
  for (int s = 0; s < nw; ++s) {
    int b = bitsof[s];
    if (!b) continue;
    uint32_t code = rank_idx[b], len = 1u << (max_bits - b);
    std::memset(&t.symbol[code], s, len);
    std::memset(&t.nbits[code], b, len);
    rank_idx[b] += len;
  }
  t.max_bits = max_bits;
  t.defined = true;
  return used;
}

void huffman_stream(const HufTable& t, const uint8_t* p, int64_t n, uint8_t* out, int64_t count) {
  const char* what = "Huffman literals";
  BackBits bits(p, n, what);
  for (int64_t i = 0; i < count; ++i) {
    uint32_t idx = uint32_t(bits.peek(t.max_bits));
    out[i] = t.symbol[idx];
    bits.pos -= t.nbits[idx];
    if (bits.pos < 0) fail("Huffman literals: bitstream overread");
  }
  if (bits.pos != 0) fail("Huffman literals: bitstream not fully consumed");
}

// ---------------------------------------------------------------- frames

struct Frame {
  uint8_t* dst;          // the whole output buffer
  int64_t cap;
  int64_t frame_start;   // where this frame's output begins
  int64_t out;           // write position
  uint64_t rep[3] = {1, 4, 8};
  HufTable huf;
  FseTable ll, of, ml;
  std::vector<uint8_t> lit;
  int64_t block_max = 0;

  void room(int64_t k) {
    if (k > cap - out) throw OutOfRoom("decoded data exceed the output buffer");
  }
};

// Decode the literals section at p (n bytes of block left); returns the
// bytes it took, with the literals in f.lit.
int64_t read_literals(Frame& f, const uint8_t* p, int64_t n) {
  if (n < 1) fail("literals: truncated section header");
  int type = p[0] & 3, sf = (p[0] >> 2) & 3;
  if (type < 2) {  // raw or RLE
    int64_t hs, regen;
    if ((sf & 1) == 0) {
      hs = 1;
      regen = p[0] >> 3;
    } else if (sf == 1) {
      hs = 2;
      if (n < 2) fail("literals: truncated section header");
      regen = (p[0] >> 4) + (int64_t(p[1]) << 4);
    } else {
      hs = 3;
      if (n < 3) fail("literals: truncated section header");
      regen = (p[0] >> 4) + (int64_t(p[1]) << 4) + (int64_t(p[2]) << 12);
    }
    if (regen > f.block_max) fail("literals: more literals than a block holds");
    f.lit.resize(regen);
    if (type == 0) {
      if (hs + regen > n) fail("literals: raw literals truncated");
      if (regen) std::memcpy(f.lit.data(), p + hs, regen);
      return hs + regen;
    }
    if (hs + 1 > n) fail("literals: RLE byte missing");
    std::memset(f.lit.data(), p[hs], regen);
    return hs + 1;
  }
  int64_t hs, regen, csize;
  int streams;
  if (sf < 2) {
    hs = 3;
    if (n < 3) fail("literals: truncated section header");
    uint64_t v = load_le(p, 3);
    regen = (v >> 4) & 0x3FF;
    csize = (v >> 14) & 0x3FF;
    streams = sf == 0 ? 1 : 4;
  } else if (sf == 2) {
    hs = 4;
    if (n < 4) fail("literals: truncated section header");
    uint64_t v = load_le(p, 4);
    regen = (v >> 4) & 0x3FFF;
    csize = (v >> 18) & 0x3FFF;
    streams = 4;
  } else {
    hs = 5;
    if (n < 5) fail("literals: truncated section header");
    uint64_t v = load_le(p, 5);
    regen = (v >> 4) & 0x3FFFF;
    csize = (v >> 22) & 0x3FFFF;
    streams = 4;
  }
  if (regen > f.block_max) fail("literals: more literals than a block holds");
  if (hs + csize > n) fail("literals: compressed literals truncated");
  const uint8_t* q = p + hs;
  int64_t left = csize;
  if (type == 2) {
    int64_t tl = read_huffman_tree(f.huf, q, left);
    q += tl;
    left -= tl;
  } else if (!f.huf.defined) {
    fail("literals: treeless literals with no previous Huffman table");
  }
  f.lit.resize(regen);
  if (streams == 1) {
    huffman_stream(f.huf, q, left, f.lit.data(), regen);
  } else {
    if (left < 6) fail("literals: jump table truncated");
    int64_t s1 = load_le(q, 2), s2 = load_le(q + 2, 2), s3 = load_le(q + 4, 2);
    int64_t s4 = left - 6 - s1 - s2 - s3;
    if (s4 < 1) fail("literals: jump table exceeds the literals");
    int64_t per = (regen + 3) / 4, last = regen - 3 * per;
    if (last < 0) fail("literals: too few literals for 4 streams");
    const uint8_t* s = q + 6;
    uint8_t* o = f.lit.data();
    huffman_stream(f.huf, s, s1, o, per);
    huffman_stream(f.huf, s + s1, s2, o + per, per);
    huffman_stream(f.huf, s + s1 + s2, s3, o + 2 * per, per);
    huffman_stream(f.huf, s + s1 + s2 + s3, s4, o + 3 * per, last);
  }
  return hs + csize;
}

int64_t read_seq_table(FseTable& t, int mode, const int16_t* dflt, int ndflt, int dlog, int max_log,
                       int max_sym, const uint8_t* p, int64_t n, const char* what) {
  switch (mode) {
    case 0:
      t.build(dflt, ndflt, dlog, what);
      return 0;
    case 1:
      if (n < 1) fail(std::string(what) + ": RLE symbol missing");
      if (p[0] > max_sym) fail(std::string(what) + ": RLE symbol out of range");
      t.rle(p[0]);
      return 1;
    case 2:
      return read_fse_table(t, p, n, max_log, max_sym, what);
    default:
      if (!t.defined) fail(std::string(what) + ": repeat mode with no previous table");
      return 0;
  }
}

void copy_literals(Frame& f, const uint8_t* src, int64_t k) {
  f.room(k);
  if (k) std::memcpy(f.dst + f.out, src, k);
  f.out += k;
}

void execute(Frame& f, const uint8_t* p, int64_t n) {
  int64_t block_start = f.out;
  int64_t used = read_literals(f, p, n);
  p += used;
  n -= used;
  if (n < 1) fail("sequences: section header missing");
  int64_t nseq;
  int b0 = p[0];
  int64_t hs;
  if (b0 < 128) {
    nseq = b0;
    hs = 1;
  } else if (b0 < 255) {
    if (n < 2) fail("sequences: truncated section header");
    nseq = (int64_t(b0 - 128) << 8) + p[1];
    hs = 2;
  } else {
    if (n < 3) fail("sequences: truncated section header");
    nseq = p[1] + (int64_t(p[2]) << 8) + 0x7F00;
    hs = 3;
  }
  p += hs;
  n -= hs;
  const uint8_t* lit = f.lit.data();
  int64_t nlit = int64_t(f.lit.size());
  if (nseq == 0) {
    if (n != 0) fail("sequences: bytes after an empty sequences section");
    copy_literals(f, lit, nlit);
    return;
  }
  if (n < 1) fail("sequences: compression modes missing");
  int modes = p[0];
  if (modes & 3) fail("sequences: reserved bits of the compression modes set");
  p += 1;
  n -= 1;
  int64_t k = read_seq_table(f.ll, (modes >> 6) & 3, kLLDefault, 36, 6, 9, 35, p, n, "literal lengths");
  p += k;
  n -= k;
  k = read_seq_table(f.of, (modes >> 4) & 3, kOFDefault, 29, 5, 8, 31, p, n, "offsets");
  p += k;
  n -= k;
  k = read_seq_table(f.ml, (modes >> 2) & 3, kMLDefault, 53, 6, 9, 52, p, n, "match lengths");
  p += k;
  n -= k;
  const char* what = "sequences";
  BackBits bits(p, n, what);
  uint32_t sll = uint32_t(bits.read(f.ll.log, false, what));
  uint32_t sof = uint32_t(bits.read(f.of.log, false, what));
  uint32_t sml = uint32_t(bits.read(f.ml.log, false, what));
  int64_t litpos = 0;
  for (int64_t i = 0; i < nseq; ++i) {
    int llc = f.ll.cells[sll].symbol, ofc = f.of.cells[sof].symbol, mlc = f.ml.cells[sml].symbol;
    if (ofc > 31) fail("sequences: offset code above 31");
    uint64_t ofv = (uint64_t(1) << ofc) + bits.read(ofc, false, what);
    uint64_t ml = kMLBase[mlc] + bits.read(kMLBits[mlc], false, what);
    uint64_t ll = kLLBase[llc] + bits.read(kLLBits[llc], false, what);
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      f.rep[2] = f.rep[1];
      f.rep[1] = f.rep[0];
      f.rep[0] = offset;
    } else {
      int idx = int(ofv) + (ll == 0 ? 1 : 0);  // 1..4; 4 is rep[0] - 1
      if (idx == 1) {
        offset = f.rep[0];
      } else {
        offset = idx == 4 ? f.rep[0] - 1 : f.rep[idx - 1];
        if (offset == 0) fail("sequences: repeat offset of 0");
        if (idx != 2) f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      sll = f.ll.cells[sll].base + uint32_t(bits.read(f.ll.cells[sll].nbits, false, what));
      sml = f.ml.cells[sml].base + uint32_t(bits.read(f.ml.cells[sml].nbits, false, what));
      sof = f.of.cells[sof].base + uint32_t(bits.read(f.of.cells[sof].nbits, false, what));
    }
    if (int64_t(ll) > nlit - litpos) fail("sequences: literal length beyond the literals");
    copy_literals(f, lit + litpos, int64_t(ll));
    litpos += int64_t(ll);
    if (offset > uint64_t(f.out - f.frame_start)) fail("sequences: match offset before the frame's start");
    f.room(int64_t(ml));
    uint8_t* d = f.dst + f.out;
    const uint8_t* s = d - offset;
    if (offset >= ml) {
      std::memcpy(d, s, ml);
    } else {
      for (uint64_t j = 0; j < ml; ++j) d[j] = s[j];
    }
    f.out += int64_t(ml);
    if (f.out - block_start > f.block_max) fail("sequences: block decodes to more than its maximum size");
  }
  if (bits.pos != 0) fail("sequences: bitstream not fully consumed");
  copy_literals(f, lit + litpos, nlit - litpos);
  if (f.out - block_start > f.block_max) fail("block decodes to more than its maximum size");
}

struct FrameHeader {
  int64_t header_size;
  int64_t content_size;  // -1 when not stated
  uint64_t window;
  bool checksum;
};

FrameHeader read_frame_header(const uint8_t* p, int64_t n) {
  if (n < 5) fail("frame header truncated");
  int fhd = p[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
  if (fhd & 8) fail("frame header's reserved bit is set");
  int64_t pos = 5;
  FrameHeader h{0, -1, 0, bool((fhd >> 2) & 1)};
  if (!single) {
    if (pos + 1 > n) fail("frame header truncated");
    int wd = p[pos++];
    int wlog = 10 + (wd >> 3);
    if (wlog > 41) fail("window size too large");
    uint64_t base = uint64_t(1) << wlog;
    h.window = base + (base / 8) * (wd & 7);
  }
  const int dict_bytes[4] = {0, 1, 2, 4};
  int db = dict_bytes[dict_flag];
  if (pos + db > n) fail("frame header truncated");
  uint64_t dict_id = load_le(p + pos, db);
  pos += db;
  if (dict_id != 0)
    fail("frame needs dictionary " + std::to_string(dict_id) + "; dictionaries are not supported");
  const int fcs_bytes[4] = {0, 2, 4, 8};
  int fb = fcs_flag == 0 ? (single ? 1 : 0) : fcs_bytes[fcs_flag];
  if (pos + fb > n) fail("frame header truncated");
  if (fb) {
    uint64_t v = load_le(p + pos, fb);
    if (fb == 2) v += 256;
    if (v > uint64_t(INT64_MAX)) fail("frame content size too large");
    h.content_size = int64_t(v);
  }
  pos += fb;
  if (single) h.window = uint64_t(h.content_size);
  h.header_size = pos;
  return h;
}

const uint32_t kMagic = 0xFD2FB528u;

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

int64_t decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  int64_t ip = 0, out = 0;
  if (n == 0) fail("no zstd frame");
  while (ip < n) {
    if (n - ip < 4) fail("trailing bytes after the last frame");
    uint32_t magic = uint32_t(load_le(src + ip, 4));
    if (skippable(magic)) {
      if (n - ip < 8) fail("skippable frame truncated");
      uint64_t sz = load_le(src + ip + 4, 4);
      if (sz > uint64_t(n - ip - 8)) fail("skippable frame truncated");
      ip += 8 + int64_t(sz);
      continue;
    }
    if (magic != kMagic) fail("not a zstd frame (bad magic number)");
    FrameHeader h = read_frame_header(src + ip, n - ip);
    ip += h.header_size;
    if (h.content_size > cap - out) throw OutOfRoom("frame content size exceeds the output buffer");
    Frame f;
    f.dst = dst;
    f.cap = cap;
    f.frame_start = out;
    f.out = out;
    f.block_max = int64_t(std::min<uint64_t>(h.window, 128 * 1024));
    for (bool last = false; !last;) {
      if (n - ip < 3) fail("block header truncated");
      uint32_t bh = uint32_t(load_le(src + ip, 3));
      ip += 3;
      last = bh & 1;
      int type = (bh >> 1) & 3;
      int64_t size = bh >> 3;
      if (type == 3) fail("reserved block type");
      if (type == 1) {
        if (size > f.block_max) fail("RLE block larger than the block maximum");
        if (n - ip < 1) fail("RLE block truncated");
        f.room(size);
        std::memset(dst + f.out, src[ip], size);
        f.out += size;
        ip += 1;
        continue;
      }
      if (size > f.block_max) fail("block larger than the block maximum");
      if (size > n - ip) fail("block truncated");
      if (type == 0) {
        f.room(size);
        if (size) std::memcpy(dst + f.out, src + ip, size);
        f.out += size;
      } else {
        execute(f, src + ip, size);
      }
      ip += size;
    }
    if (h.content_size >= 0 && f.out - out != h.content_size)
      fail("frame decodes to " + std::to_string(f.out - out) + " bytes, its header states " +
           std::to_string(h.content_size));
    if (h.checksum) {
      if (n - ip < 4) fail("content checksum truncated");
      uint32_t want = uint32_t(load_le(src + ip, 4));
      uint32_t got = uint32_t(xxh64_impl(dst + out, uint64_t(f.out - out), 0));
      if (want != got) fail("content checksum mismatch");
      ip += 4;
    }
    out = f.out;
  }
  return out;
}

int64_t content_size(const uint8_t* src, int64_t n) {
  int64_t ip = 0, total = 0;
  bool known = true;
  if (n == 0) fail("no zstd frame");
  while (ip < n) {
    if (n - ip < 4) fail("trailing bytes after the last frame");
    uint32_t magic = uint32_t(load_le(src + ip, 4));
    if (skippable(magic)) {
      if (n - ip < 8) fail("skippable frame truncated");
      uint64_t sz = load_le(src + ip + 4, 4);
      if (sz > uint64_t(n - ip - 8)) fail("skippable frame truncated");
      ip += 8 + int64_t(sz);
      continue;
    }
    if (magic != kMagic) fail("not a zstd frame (bad magic number)");
    FrameHeader h = read_frame_header(src + ip, n - ip);
    if (h.content_size < 0) known = false;
    else if (h.content_size > INT64_MAX - total) fail("frame content sizes overflow");
    else total += h.content_size;
    ip += h.header_size;
    for (bool last = false; !last;) {  // walk the blocks to the next frame
      if (n - ip < 3) fail("block header truncated");
      uint32_t bh = uint32_t(load_le(src + ip, 3));
      ip += 3;
      last = bh & 1;
      int type = (bh >> 1) & 3;
      int64_t size = type == 1 ? 1 : int64_t(bh >> 3);
      if (type == 3) fail("reserved block type");
      if (size > n - ip) fail("block truncated");
      ip += size;
    }
    if (h.checksum) {
      if (n - ip < 4) fail("content checksum truncated");
      ip += 4;
    }
  }
  return known ? total : -1;
}

void set_error(char* err, int64_t errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg);
}

}  // namespace

extern "C" {

int64_t zstd_content_size(const uint8_t* src, int64_t n, char* err, int64_t errlen) {
  try {
    return content_size(src, n);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -2;
  }
}

int64_t zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, char* err,
                        int64_t errlen) {
  try {
    return decompress(src, n, dst, cap);
  } catch (const OutOfRoom& e) {
    set_error(err, errlen, e.what());
    return -2;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

uint32_t crc32c(const uint8_t* p, int64_t n) {
  const auto& t = crc_tables().t;
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; n -= 8, p += 8) {
    uint32_t lo = c ^ uint32_t(load_le(p, 4));
    uint32_t hi = uint32_t(load_le(p + 4, 4));
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^
        t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
        t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
        t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
  }
  for (; n > 0; --n, ++p) c = (c >> 8) ^ t[0][(c ^ *p) & 0xFF];
  return ~c;
}

uint64_t xxh64(const uint8_t* p, int64_t n, uint64_t seed) { return xxh64_impl(p, uint64_t(n), seed); }

}  // extern "C"
