// Host image decoding for the port's data layer: a baseline JPEG decoder
// that gives libjpeg-turbo's pixels, and the PNG row unfilter.
//
// The JAX package reads images with imageio (PIL on libjpeg-turbo); the
// card's machine has neither, so the port decodes here, with libjpeg-turbo's
// arithmetic step for step:
//   - Huffman sequential coding (SOF0/SOF1), 8-bit samples, 1 or 3
//     components, interleaved or single-component scans, restart markers;
//   - dequantisation and the integer "islow" IDCT of jidctint.c, with its
//     wrapping range-limit table;
//   - the "fancy" triangle upsampling of jdsample.c for h2v1, h1v2 and h2v2
//     chroma (its plain replication where the chroma is 2 samples wide or
//     less), the context rows replicated at the top and bottom edges;
//   - the fixed-point YCbCr -> RGB tables of jdcolor.c.
// Anything else (progressive, arithmetic, lossless, hierarchical, 12-bit,
// CMYK, RGB-coded or Adobe-transformed data, other sampling factors,
// truncated or corrupt data) is refused with a message; the Python side
// raises it as ValueError naming the file.
//
// C interface (ctypes, datasets/jpeg.py); every call is reentrant:
//   jpeg_header(data, n, dims[3] = {H, W, C}, err, errlen) -> 0 | -1
//   jpeg_decode(data, n, out (H*W*C bytes), err, errlen)   -> 0 | -1
//   png_unfilter(rows, H, rowbytes, bpp, out)               -> 0 | bad row+1
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Refusal : std::runtime_error {
  using std::runtime_error::runtime_error;
};

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valptr[17];     // index in vals of the first code of each length
  int32_t mincode[17];
  uint8_t fast_len[512];  // 9-bit lookahead: code length (0: longer)
  uint8_t fast_val[512];
};

struct Component {
  int id, h, v, tq;
  int bw, bh;                   // blocks per row / column (MCU-padded)
  int dw, dh;                   // downsampled width / height in samples
  std::vector<int16_t> coef;    // bw * bh blocks of 64, natural order
  uint16_t quant[64];           // latched at the component's first scan
  bool latched = false;
  std::vector<uint8_t> plane;   // bw*8 x bh*8 samples after the IDCT
  int stride = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}

  // libjpeg's jpeg_fill_bit_buffer: 0xFF 0x00 is a data 0xFF (runs of fill
  // 0xFF before it skipped); any other marker ends the data, and zero bits
  // are supplied after it -- counted in pad_, so running into them is an
  // error (truncated or corrupt data) instead of libjpeg's warning.
  void fill() {
    while (bits_ <= 56) {
      uint32_t b = 0;
      if (!at_marker_ && pos_ < n_) {
        b = d_[pos_];
        if (b == 0xFF) {
          size_t q = pos_ + 1;
          while (q < n_ && d_[q] == 0xFF) q++;
          if (q < n_ && d_[q] == 0x00) {
            pos_ = q + 1;
          } else {
            at_marker_ = true;
            b = 0;
            pad_ += 8;
          }
        } else {
          pos_++;
        }
      } else {
        pad_ += 8;
      }
      acc_ |= uint64_t(b) << (56 - bits_);
      bits_ += 8;
    }
  }
  uint32_t get(int s) {
    if (s == 0) return 0;
    if (bits_ < s) fill();
    uint32_t v = uint32_t(acc_ >> (64 - s));
    acc_ <<= s;
    bits_ -= s;
    return v;
  }
  int decode(const Huffman& t) {
    if (bits_ < 16) fill();
    uint32_t look = uint32_t(acc_ >> (64 - 9));
    int len = t.fast_len[look];
    if (len) {
      acc_ <<= len;
      bits_ -= len;
      return t.fast_val[look];
    }
    uint32_t peek = uint32_t(acc_ >> 48);
    for (int l = 10; l <= 16; l++) {
      int32_t code = int32_t(peek >> (16 - l));
      if (code <= t.maxcode[l]) {
        acc_ <<= l;
        bits_ -= l;
        return t.vals[t.valptr[l] + code - t.mincode[l]];
      }
    }
    throw Refusal("corrupt data: invalid Huffman code");
  }
  // true once bits past the end of the entropy data have been consumed
  bool overrun() const { return bits_ < pad_; }
  // drop the buffered bits (restart or end of scan); the position is left
  // at the marker that ended the data, if the reader reached it
  size_t reset() {
    acc_ = 0;
    bits_ = 0;
    pad_ = 0;
    at_marker_ = false;
    return pos_;
  }
  void seek(size_t pos) { pos_ = pos; }

 private:
  const uint8_t* d_;
  size_t n_, pos_;
  uint64_t acc_ = 0;
  int bits_ = 0, pad_ = 0;
  bool at_marker_ = false;
};

inline int extend(uint32_t v, int s) {
  return s == 0 ? 0 : (v < (1u << (s - 1)) ? int(v) - (1 << s) + 1 : int(v));
}

// jidctint.c (jpeg_idct_islow), with libjpeg-turbo's 1024-entry range-limit
// table: outputs are taken mod 1024 before the clamp, as there.
const int CONST_BITS = 13, PASS1_BITS = 2;
const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
              F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
              F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

struct RangeLimit {
  uint8_t post_idct[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      // index = (x + 128) & 1023 in libjpeg's post-IDCT table terms:
      // x in [0, 127] -> x + 128; [128, 511] -> 255; [512, 895] -> 0;
      // [896, 1023] -> x - 896
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      post_idct[i] = uint8_t(v);
    }
  }
};
const RangeLimit kRange;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// The islow butterfly on one column or row: in[0..7] -> the eight sums of
// output positions 0..7 before their descale (both passes share it).
inline void islow_butterfly(const int64_t* in, int64_t* out) {
  // even part
  int64_t z2 = in[2], z3 = in[6];
  int64_t z1 = (z2 + z3) * F0_541;
  int64_t tmp2 = z1 + z3 * -F1_847;
  int64_t tmp3 = z1 + z2 * F0_765;
  int64_t tmp0 = (in[0] + in[4]) * (1 << CONST_BITS);
  int64_t tmp1 = (in[0] - in[4]) * (1 << CONST_BITS);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  // odd part
  tmp0 = in[7];
  tmp1 = in[5];
  tmp2 = in[3];
  tmp3 = in[1];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3;
  int64_t z5 = (z3 + z4) * F1_175;
  tmp0 *= F0_298;
  tmp1 *= F2_053;
  tmp2 *= F3_072;
  tmp3 *= F1_501;
  z1 *= -F0_899;
  z2 *= -F2_562;
  z3 *= -F1_961;
  z4 *= -F0_390;
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  out[0] = tmp10 + tmp3;
  out[7] = tmp10 - tmp3;
  out[1] = tmp11 + tmp2;
  out[6] = tmp11 - tmp2;
  out[2] = tmp12 + tmp1;
  out[5] = tmp12 - tmp1;
  out[3] = tmp13 + tmp0;
  out[4] = tmp13 - tmp0;
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  int64_t v[8], sums[8];
  // pass 1: columns, dequantised (ISLOW_MULT_TYPE is a short in
  // libjpeg-turbo's SIMD builds), scaled up by 2^PASS1_BITS
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    for (int k = 0; k < 8; k++) v[k] = int64_t(int(ip[8 * k]) * int(int16_t(q[8 * k + c])));
    if (!(v[1] | v[2] | v[3] | v[4] | v[5] | v[6] | v[7])) {     // AC terms all zero
      for (int k = 0; k < 8; k++) ws[8 * k + c] = int(v[0] * (1 << PASS1_BITS));
      continue;
    }
    islow_butterfly(v, sums);
    for (int k = 0; k < 8; k++) ws[8 * k + c] = int(descale(sums[k], CONST_BITS - PASS1_BITS));
  }
  // pass 2: rows, descaled by 8 and 2^PASS1_BITS, through the range table
  const uint8_t* rl = kRange.post_idct;
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    for (int k = 0; k < 8; k++) v[k] = w[k];
    if (!(v[1] | v[2] | v[3] | v[4] | v[5] | v[6] | v[7])) {
      uint8_t dc = rl[int(descale(v[0], PASS1_BITS + 3)) & 1023];
      for (int k = 0; k < 8; k++) o[k] = dc;
      continue;
    }
    islow_butterfly(v, sums);
    for (int k = 0; k < 8; k++)
      o[k] = rl[int(descale(sums[k], CONST_BITS + PASS1_BITS + 3)) & 1023];
  }
}

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  int H = 0, W = 0, C = 0;

  void header() { parse(false); }
  void decode(uint8_t* out) {
    parse(true);
    if (!frame_) throw Refusal("no frame header (SOF0/SOF1) and scan");
    for (auto& c : comps_) {
      if (!c.latched) throw Refusal("truncated data: a component was never scanned");
    }
    for (size_t i = 0; i < comps_.size(); i++) {
      if (!done_[i]) throw Refusal("truncated data: a scan is missing");
    }
    inverse_dct();
    if (C == 1) {
      const Component& c = comps_[0];
      for (int y = 0; y < H; y++) memcpy(out + size_t(y) * W, &c.plane[size_t(y) * c.stride], W);
      return;
    }
    std::vector<uint8_t> full[3];
    for (int i = 0; i < 3; i++) full[i] = upsample(comps_[i]);
    ycc_to_rgb(full, out);
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  std::vector<Component> comps_;
  std::vector<bool> done_;
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  int restart_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  bool jfif_ = false, adobe_ = false, frame_ = false;
  int adobe_transform_ = -1;

  uint8_t byte() {
    if (pos_ >= n_) throw Refusal("truncated data");
    return d_[pos_++];
  }
  int u16() {
    int a = byte();
    return (a << 8) | byte();
  }

  void parse(bool decode) {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) throw Refusal("not a JPEG file (no SOI marker)");
    pos_ = 2;
    for (;;) {
      if (pos_ >= n_) throw Refusal("truncated data: no EOI marker");
      if (d_[pos_] != 0xFF) throw Refusal("corrupt data: marker expected");
      while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
      int m = byte();
      if (m == 0xD9) return;                       // EOI
      if (m >= 0xD0 && m <= 0xD7) throw Refusal("corrupt data: restart marker outside a scan");
      if (m == 0x01 || m == 0x00) throw Refusal("corrupt data: bad marker");
      size_t len = size_t(u16());
      if (len < 2 || pos_ + len - 2 > n_) throw Refusal("truncated data in a marker segment");
      size_t end = pos_ + len - 2;
      switch (m) {
        case 0xC0:
        case 0xC1:
          sof(end);
          break;
        case 0xC2:
        case 0xC6:
        case 0xCA:
        case 0xCE:
          throw Refusal("progressive JPEG is not supported (baseline sequential only)");
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          throw Refusal("lossless JPEG is not supported (baseline sequential only)");
        case 0xC5:
        case 0xDE:
          throw Refusal("hierarchical JPEG is not supported (baseline sequential only)");
        case 0xC9:
        case 0xCC:
        case 0xCD:
          throw Refusal("arithmetic-coded JPEG is not supported (Huffman only)");
        case 0xC4: dht(end); break;
        case 0xDB: dqt(end); break;
        case 0xDD:
          if (len != 4) throw Refusal("corrupt data: bad DRI length");
          restart_ = u16();
          break;
        case 0xDA:
          if (!frame_) throw Refusal("corrupt data: scan before frame header");
          colour_space();
          if (!decode) return;
          sos(end);
          continue;                                  // pos_ is past the scan
        case 0xDC: throw Refusal("DNL marker is not supported");
        case 0xE0:
          if (len >= 16 && memcmp(d_ + pos_, "JFIF\0", 5) == 0) jfif_ = true;
          break;
        case 0xEE:
          if (len >= 14 && memcmp(d_ + pos_, "Adobe", 5) == 0) {
            adobe_ = true;
            adobe_transform_ = d_[pos_ + 11];
          }
          break;
        default:
          if (!((m >= 0xE0 && m <= 0xEF) || m == 0xFE))
            throw Refusal("corrupt data: unknown marker");
      }
      pos_ = end;
    }
  }

  void sof(size_t end) {
    if (frame_) throw Refusal("corrupt data: second frame header");
    frame_ = true;
    int p = byte();
    H = u16();
    W = u16();
    int nf = byte();
    if (p != 8) throw Refusal(std::to_string(p) + "-bit samples are not supported (8-bit only)");
    if (H == 0) throw Refusal("a height of 0 (DNL) is not supported");
    if (W == 0) throw Refusal("corrupt data: width 0");
    if (nf == 4) throw Refusal("CMYK/YCCK JPEG is not supported (gray or YCbCr only)");
    if (nf != 1 && nf != 3) throw Refusal(std::to_string(nf) + " components are not supported");
    if (pos_ + 3 * size_t(nf) != end) throw Refusal("corrupt data: bad frame header length");
    comps_.resize(nf);
    done_.assign(nf, false);
    for (auto& c : comps_) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw Refusal("corrupt data: bad component sampling or table");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    if (nf == 1) {                 // a single component is never subsampled
      comps_[0].h = comps_[0].v = hmax_ = vmax_ = 1;
    }
    for (auto& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v || hmax_ / c.h > 2 || vmax_ / c.v > 2)
        throw Refusal("sampling factors " + sampling() +
                      " are not supported (4:4:4, 4:2:2, 4:2:0, 4:4:0 only)");
    }
    if (int64_t(W) * H > (int64_t(1) << 28)) throw Refusal("image too large");
    C = nf;
    mcux_ = (W + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (H + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comps_) {
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.dw = int((int64_t(W) * c.h + hmax_ - 1) / hmax_);
      c.dh = int((int64_t(H) * c.v + vmax_ - 1) / vmax_);
    }
  }

  // jdapimin.c's default_decompress_parms, decided at the first scan as
  // there: JFIF means YCbCr; else an Adobe marker's transform (0 RGB, 1
  // YCbCr); else component ids 'R','G','B' mean RGB
  void colour_space() const {
    if (C == 3) {
      bool rgb;
      if (jfif_) rgb = false;
      else if (adobe_) {
        if (adobe_transform_ != 1)
          throw Refusal("Adobe-transformed JPEG (transform " + std::to_string(adobe_transform_) +
                        ") is not supported (YCbCr only)");
        rgb = false;
      } else {
        rgb = comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
      }
      if (rgb) throw Refusal("RGB-coded JPEG is not supported (YCbCr only)");
    }
  }

  std::string sampling() const {
    std::string s;
    for (auto& c : comps_) s += (s.empty() ? "" : ",") + std::to_string(c.h) + "x" + std::to_string(c.v);
    return s;
  }

  void dqt(size_t end) {
    while (pos_ < end) {
      int pq = byte();
      int prec = pq >> 4, t = pq & 15;
      if (prec > 1 || t > 3) throw Refusal("corrupt data: bad quantisation table");
      for (int i = 0; i < 64; i++) qt_[t][kNatural[i]] = uint16_t(prec ? u16() : byte());
      qt_defined_[t] = true;
    }
    if (pos_ != end) throw Refusal("corrupt data: bad DQT length");
  }

  void dht(size_t end) {
    while (pos_ < end) {
      int tc = byte();
      int cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) throw Refusal("corrupt data: bad Huffman table");
      Huffman& h = cls ? ac_[t] : dc_[t];
      int counts[17] = {0}, total = 0;
      for (int l = 1; l <= 16; l++) total += counts[l] = byte();
      if (total > 256 || pos_ + total > end) throw Refusal("corrupt data: bad Huffman table");
      for (int i = 0; i < total; i++) h.vals[i] = byte();
      memset(h.fast_len, 0, sizeof h.fast_len);
      int32_t code = 0, k = 0;
      for (int l = 1; l <= 16; l++) {
        // jdhuff.c's check, made before any entry of the table is written:
        // the codes of each length fit in l bits, and none is all ones
        if (code + counts[l] >= (1 << l)) throw Refusal("corrupt data: bad Huffman table");
        h.valptr[l] = k;
        h.mincode[l] = code;
        for (int i = 0; i < counts[l]; i++, k++, code++) {
          if (l <= 9) {
            int shift = 9 - l;
            for (int j = 0; j < (1 << shift); j++) {
              h.fast_len[(code << shift) | j] = uint8_t(l);
              h.fast_val[(code << shift) | j] = h.vals[k];
            }
          }
        }
        h.maxcode[l] = counts[l] ? code - 1 : -1;
        code <<= 1;
      }
      h.maxcode[17] = 0x7fffffff;
      h.defined = true;
    }
    if (pos_ != end) throw Refusal("corrupt data: bad DHT length");
  }

  void sos(size_t end) {
    int ns = byte();
    if (ns < 1 || ns > C || pos_ + 2 * size_t(ns) + 3 != end)
      throw Refusal("corrupt data: bad scan header");
    std::vector<int> ids(ns);
    std::vector<int> td(ns), ta(ns);
    for (int i = 0; i < ns; i++) {
      int cid = byte(), t = byte();
      int ci = -1;
      for (int j = 0; j < C; j++)
        if (comps_[j].id == cid) ci = j;
      if (ci < 0) throw Refusal("corrupt data: scan names an unknown component");
      for (int j = 0; j < i; j++)
        if (ids[j] == ci) throw Refusal("corrupt data: component twice in a scan");
      ids[i] = ci;
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3 || !dc_[td[i]].defined || !ac_[ta[i]].defined)
        throw Refusal("corrupt data: scan uses an undefined Huffman table");
    }
    int ss = byte(), se = byte(), a = byte();
    if (ss != 0 || se != 63 || a != 0) throw Refusal("corrupt data: not a sequential scan");
    int blocks_in_mcu = 0;
    for (int ci : ids) {
      Component& c = comps_[ci];
      if (done_[ci]) throw Refusal("corrupt data: component scanned twice");
      if (!c.latched) {
        if (!qt_defined_[c.tq]) throw Refusal("corrupt data: undefined quantisation table");
        memcpy(c.quant, qt_[c.tq], sizeof c.quant);
        c.latched = true;
        c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      }
      blocks_in_mcu += c.h * c.v;
    }
    if (ns > 1 && blocks_in_mcu > 10) throw Refusal("corrupt data: too many blocks in an MCU");

    BitReader br(d_, n_, pos_);
    int pred[4] = {0, 0, 0, 0};
    int64_t units_x, units_y;
    if (ns == 1) {            // non-interleaved: one block per MCU
      const Component& c = comps_[ids[0]];
      units_x = (c.dw + 7) / 8;
      units_y = (c.dh + 7) / 8;
    } else {
      units_x = mcux_;
      units_y = mcuy_;
    }
    int64_t total = units_x * units_y, left = restart_;
    int next_rst = 0;
    for (int64_t u = 0; u < total; u++) {
      if (restart_ && left == 0) {
        size_t p = br.reset();
        while (p < n_ && d_[p] == 0xFF) p++;
        if (p >= n_ || d_[p] != 0xD0 + next_rst || d_[p - 1] != 0xFF)
          throw Refusal("corrupt or truncated data: restart marker missing");
        br.seek(p + 1);
        next_rst = (next_rst + 1) & 7;
        left = restart_;
        for (int& x : pred) x = 0;
      }
      int64_t ux = u % units_x, uy = u / units_x;
      for (int i = 0; i < ns; i++) {
        Component& c = comps_[ids[i]];
        int bh = ns == 1 ? 1 : c.v, bwid = ns == 1 ? 1 : c.h;
        for (int by = 0; by < bh; by++) {
          for (int bx = 0; bx < bwid; bx++) {
            int64_t row = uy * bh + by, col = ux * bwid + bx;
            int16_t* blk = &c.coef[(size_t(row) * c.bw + size_t(col)) * 64];
            int s = br.decode(dc_[td[i]]);
            if (s > 11) throw Refusal("corrupt data: bad DC coefficient");
            int diff = extend(br.get(s), s);
            pred[i] = int(uint32_t(pred[i]) + uint32_t(diff));
            blk[0] = int16_t(pred[i]);
            for (int k = 1; k < 64;) {
              int rs = br.decode(ac_[ta[i]]);
              int r = rs >> 4, sz = rs & 15;
              if (sz) {
                k += r;
                if (k > 63 || sz > 10) throw Refusal("corrupt data: bad AC coefficient");
                blk[kNatural[k]] = int16_t(extend(br.get(sz), sz));
                k++;
              } else {
                if (r != 15) break;
                k += 16;
              }
            }
          }
        }
      }
      if (br.overrun()) throw Refusal("truncated or corrupt data: entropy data ends inside the image");
      left--;
    }
    for (int ci : ids) done_[ci] = true;
    pos_ = br.reset();
    // past the scan: the next marker
    if (pos_ < n_ && d_[pos_] != 0xFF) throw Refusal("corrupt data: extraneous bytes after a scan");
  }

  void inverse_dct() {
    for (auto& c : comps_) {
      c.stride = c.bw * 8;
      c.plane.assign(size_t(c.stride) * c.bh * 8, 0);
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], c.quant,
                     &c.plane[size_t(by) * 8 * c.stride + size_t(bx) * 8], c.stride);
      std::vector<int16_t>().swap(c.coef);
    }
  }

  // jdsample.c: the component at full size, W x H
  std::vector<uint8_t> upsample(const Component& c) const {
    std::vector<uint8_t> out(size_t(W) * H);
    const int rh = hmax_ / c.h, rv = vmax_ / c.v, dw = c.dw, dh = c.dh;
    auto in = [&](int y) { return &c.plane[size_t(y < 0 ? 0 : (y >= dh ? dh - 1 : y)) * c.stride]; };
    std::vector<uint8_t> row(size_t(dw) * 2 + 2);
    for (int y = 0; y < H; y++) {
      uint8_t* o = &out[size_t(y) * W];
      if (rh == 1 && rv == 1) {
        memcpy(o, in(y), W);
      } else if (rh == 2 && rv == 1) {
        const uint8_t* p = in(y);
        if (dw > 2) {               // h2v1_fancy_upsample
          uint8_t* q = row.data();
          int v = p[0];
          *q++ = uint8_t(v);
          *q++ = uint8_t((v * 3 + p[1] + 2) >> 2);
          for (int x = 1; x < dw - 1; x++) {
            v = p[x] * 3;
            *q++ = uint8_t((v + p[x - 1] + 1) >> 2);
            *q++ = uint8_t((v + p[x + 1] + 2) >> 2);
          }
          v = p[dw - 1];
          *q++ = uint8_t((v * 3 + p[dw - 2] + 1) >> 2);
          *q++ = uint8_t(v);
          memcpy(o, row.data(), W);
        } else {
          for (int x = 0; x < W; x++) o[x] = p[x >> 1];
        }
      } else if (rh == 1 && rv == 2) {     // h1v2_fancy_upsample
        int r = y >> 1;
        const uint8_t* p0 = in(r);
        const uint8_t* p1 = in((y & 1) ? r + 1 : r - 1);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; x++) o[x] = uint8_t((p0[x] * 3 + p1[x] + bias) >> 2);
      } else {                             // rh == 2 && rv == 2
        int r = y >> 1;
        const uint8_t* p0 = in(r);
        if (dw > 2) {                      // h2v2_fancy_upsample
          const uint8_t* p1 = in((y & 1) ? r + 1 : r - 1);
          uint8_t* q = row.data();
          int thiscol = p0[0] * 3 + p1[0], nextcol = p0[1] * 3 + p1[1], lastcol;
          *q++ = uint8_t((thiscol * 4 + 8) >> 4);
          *q++ = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
          for (int x = 2; x < dw; x++) {
            nextcol = p0[x] * 3 + p1[x];
            *q++ = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
            *q++ = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
            lastcol = thiscol;
            thiscol = nextcol;
          }
          *q++ = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
          *q++ = uint8_t((thiscol * 4 + 7) >> 4);
          memcpy(o, row.data(), W);
        } else {                           // h2v2_upsample
          for (int x = 0; x < W; x++) o[x] = p0[x >> 1];
        }
      }
    }
    return out;
  }

  // jdcolor.c's ycc_rgb_convert with build_ycc_rgb_table's tables
  void ycc_to_rgb(const std::vector<uint8_t>* full, uint8_t* out) const {
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
    auto fix = [](double x) { return int64_t(x * (1L << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = int((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = int((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    size_t n = size_t(W) * H;
    const uint8_t *Y = full[0].data(), *Cb = full[1].data(), *Cr = full[2].data();
    for (size_t i = 0; i < n; i++) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      out[3 * i + 0] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

void set_error(char* err, int64_t errlen, const char* msg) {
  if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", msg);
}

}  // namespace

extern "C" {

int jpeg_header(const uint8_t* data, int64_t n, int64_t* dims, char* err, int64_t errlen) {
  try {
    Decoder dec(data, size_t(n));
    dec.header();
    if (!dec.W) throw Refusal("no frame header (SOF0/SOF1) and scan");
    dims[0] = dec.H;
    dims[1] = dec.W;
    dims[2] = dec.C;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* err, int64_t errlen) {
  try {
    Decoder dec(data, size_t(n));
    dec.decode(out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// PNG row filters (None, Sub, Up, Average, Paeth) undone in place of the
// reader's numpy loop: rows is H x (1 + rowbytes), each row led by its
// filter byte; out is H x rowbytes.  Returns 0, or the 1-based row of an
// unknown filter.
int64_t png_unfilter(const uint8_t* rows, int64_t H, int64_t rowbytes, int64_t bpp, uint8_t* out) {
  for (int64_t r = 0; r < H; r++) {
    const uint8_t* src = rows + r * (rowbytes + 1);
    int f = src[0];
    src++;
    uint8_t* o = out + r * rowbytes;
    const uint8_t* up = r ? out + (r - 1) * rowbytes : nullptr;
    switch (f) {
      case 0:
        memcpy(o, src, size_t(rowbytes));
        break;
      case 1:
        for (int64_t x = 0; x < rowbytes; x++) o[x] = uint8_t(src[x] + (x >= bpp ? o[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < rowbytes; x++) o[x] = uint8_t(src[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < rowbytes; x++) {
          int a = x >= bpp ? o[x - bpp] : 0, b = up ? up[x] : 0;
          o[x] = uint8_t(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < rowbytes; x++) {
          int a = x >= bpp ? o[x - bpp] : 0, b = up ? up[x] : 0;
          int c = (x >= bpp && up) ? up[x - bpp] : 0;
          int p = a + b - c, pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p,
              pc = p > c ? p - c : c - p;
          o[x] = uint8_t(src[x] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c)));
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}

}  // extern "C"
