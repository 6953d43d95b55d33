// MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile video encoder, intra
// frames only: the host side of the port's video writer
// (instant_nvr_tpu_torch/eval/video.py), so that bullet time and the
// novel-view orbit yield an mp4 on a machine without ffmpeg, as the JAX
// package's cv2.VideoWriter fallback (fourcc mp4v) does.
//
// Every frame is one I-VOP:
//   RGB -> YCbCr (ITU-R BT.601, studio range) with 4:2:0 chroma (2x2 means),
//   the frame padded to whole 16x16 macroblocks by repeating its last row
//   and column (the VOL's width and height crop it again);
//   an 8x8 forward DCT (double precision, orthonormal: DC = 8 x mean);
//   H.263 quantisation (quant_type 0) at a fixed vop_quant: the DC by the
//   standard's dc_scaler, the AC as |level| = |c| / (2 quant) (with a
//   level of 1 from 1.5 quant up);
//   intra DC prediction (the gradient rule over the left, above-left and
//   above blocks, 1024 outside the VOP) with the DC-size VLCs
//   (Tables B-13, B-14), intra_dc_vlc_thr 0, ac_pred_flag 0;
//   the intra TCOEF VLCs (Table B-16) for (last, run, level), escape mode 3
//   (fixed-length last, run and 12-bit level) for anything outside them.
// The headers (visual object sequence, visual object, video object layer
// with vop_time_increment_resolution = fps) are written apart: the MP4
// writer puts them in the esds box.
//
// Every write goes through BitWriter, which checks its capacity; every
// input is checked by the entry points (sizes 16..4096, fps 1..65535,
// quant 1..31).  Returns are byte counts, or -1 for a bad argument and -2
// for a full output buffer.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

class BitWriter {
 public:
  BitWriter(uint8_t* out, long long cap) : out_(out), cap_(cap) {}

  // the low n bits of v, most significant first; n <= 32
  void put(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) {
      acc_ = (uint8_t)((acc_ << 1) | ((v >> i) & 1u));
      if (++nacc_ == 8) flush_byte();
    }
  }
  // next_start_code(): a 0, then 1s to the byte boundary (0x7F if aligned)
  void stuff() {
    put(0, 1);
    while (nacc_ != 0) put(1, 1);
  }
  void start_code(uint8_t code) {
    put(0x000001u, 24);
    put(code, 8);
  }
  bool aligned() const { return nacc_ == 0; }
  bool full() const { return full_; }
  long long size() const { return len_; }

 private:
  void flush_byte() {
    if (len_ < cap_) {
      out_[len_++] = acc_;
    } else {
      full_ = true;
    }
    acc_ = 0;
    nacc_ = 0;
  }
  uint8_t* out_;
  long long cap_;
  long long len_ = 0;
  uint8_t acc_ = 0;
  int nacc_ = 0;
  bool full_ = false;
};

// Table B-16, intra TCOEF: the (code, length) of each event, in the
// standard's order: last = 0 with run 0 (levels 1..27), run 1 (1..10),
// run 2 (1..5), run 3 (1..4), runs 4-7 (1..3), runs 8-9 (1..2), runs 10-14
// (1); then last = 1 with run 0 (1..8), run 1 (1..3), runs 2-6 (1..2),
// runs 7-20 (1).  The sign bit follows each code.  Entry 102 is ESCAPE.
constexpr uint16_t kIntraVlc[103][2] = {
    {2, 2},   {6, 3},   {15, 4},  {13, 5},  {12, 5},  {21, 6},  {19, 6},  {18, 6},
    {23, 7},  {31, 8},  {30, 8},  {29, 8},  {37, 9},  {36, 9},  {35, 9},  {33, 9},
    {33, 10}, {32, 10}, {15, 10}, {14, 10}, {7, 11},  {6, 11},  {32, 11}, {33, 11},
    {80, 12}, {81, 12}, {82, 12}, {14, 4},  {20, 6},  {22, 7},  {28, 8},  {32, 9},
    {31, 9},  {13, 10}, {34, 11}, {83, 12}, {85, 12}, {11, 5},  {21, 7},  {30, 9},
    {12, 10}, {86, 12}, {17, 6},  {27, 8},  {29, 9},  {11, 10}, {16, 6},  {34, 9},
    {10, 10}, {13, 6},  {28, 9},  {8, 10},  {18, 7},  {27, 9},  {84, 12}, {20, 7},
    {26, 9},  {87, 12}, {25, 8},  {9, 10},  {24, 8},  {35, 11}, {23, 8},  {25, 9},
    {24, 9},  {7, 10},  {88, 12}, {7, 4},   {12, 6},  {22, 8},  {23, 9},  {6, 10},
    {5, 11},  {4, 11},  {89, 12}, {15, 6},  {22, 9},  {5, 10},  {14, 6},  {4, 10},
    {17, 7},  {36, 11}, {16, 7},  {37, 11}, {19, 7},  {90, 12}, {21, 8},  {91, 12},
    {20, 8},  {19, 8},  {26, 8},  {21, 9},  {20, 9},  {19, 9},  {18, 9},  {17, 9},
    {38, 11}, {39, 11}, {92, 12}, {93, 12}, {94, 12}, {95, 12}, {3, 7}};
// the largest level of each run that the table holds, by last
constexpr int kMaxRun[2] = {14, 20};
constexpr int kMaxLevel0[15] = {27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1};
constexpr int kMaxLevel1[21] = {8, 3, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};

// Tables B-13 and B-14: dct_dc_size for luminance and chrominance, (code, length)
constexpr uint8_t kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3},  {1, 3},  {1, 4}, {1, 5},
                                   {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
constexpr uint8_t kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3},  {1, 4},  {1, 5}, {1, 6},
                                     {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};
// Table B-6, MCBPC of an I-VOP macroblock (type 3, no dquant) by cbpc
constexpr uint8_t kMcbpc[4][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}};
// Table B-8, CBPY of an intra macroblock by cbpy
constexpr uint8_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4},  {3, 5}, {7, 4}, {2, 6}, {11, 4},
                                  {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};

constexpr int kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                             12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                             35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                             58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// index into kIntraVlc of (last, run, level > 0), or -1 outside the table
struct VlcIndex {
  int at[2][64][28];
  VlcIndex() {
    std::memset(at, -1, sizeof(at));
    int i = 0;
    for (int last = 0; last < 2; ++last) {
      for (int run = 0; run <= kMaxRun[last]; ++run) {
        const int top = last ? kMaxLevel1[run] : kMaxLevel0[run];
        for (int level = 1; level <= top; ++level) at[last][run][level] = i++;
      }
    }
  }
};
const VlcIndex kIndex;

double kCos[8][8];  // kCos[u][x] = C(u) / 2 * cos((2x + 1) u pi / 16)
struct CosInit {
  CosInit() {
    for (int u = 0; u < 8; ++u) {
      for (int x = 0; x < 8; ++x) {
        kCos[u][x] = (u ? 0.5 : 0.5 / std::sqrt(2.0)) * std::cos((2 * x + 1) * u * M_PI / 16.0);
      }
    }
  }
} const kCosInit;

void fdct(const double in[64], double out[64]) {
  double tmp[64];
  for (int y = 0; y < 8; ++y) {
    for (int u = 0; u < 8; ++u) {
      double s = 0;
      for (int x = 0; x < 8; ++x) s += kCos[u][x] * in[y * 8 + x];
      tmp[y * 8 + u] = s;
    }
  }
  for (int v = 0; v < 8; ++v) {
    for (int u = 0; u < 8; ++u) {
      double s = 0;
      for (int y = 0; y < 8; ++y) s += kCos[v][y] * tmp[y * 8 + u];
      out[v * 8 + u] = s;
    }
  }
}

int dc_scaler(int quant, bool luma) {
  if (luma) {
    if (quant <= 4) return 8;
    if (quant <= 8) return 2 * quant;
    if (quant <= 24) return quant + 8;
    return 2 * quant - 16;
  }
  if (quant <= 4) return 8;
  if (quant <= 24) return (quant + 13) / 2;
  return quant - 6;
}

int bit_length(unsigned v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

int time_increment_bits(int fps) { return fps > 1 ? bit_length((unsigned)(fps - 1)) : 1; }

// The reconstructed DCs (QF x dc_scaler) of one plane's blocks, for the
// prediction; 1024 outside the plane.
class DcPlane {
 public:
  DcPlane(int bw, int bh) : bw_(bw), bh_(bh), v_((size_t)bw * bh, 1024) {}
  int at(int bx, int by) const {
    return (bx < 0 || by < 0 || bx >= bw_ || by >= bh_) ? 1024 : v_[(size_t)by * bw_ + bx];
  }
  void set(int bx, int by, int v) { v_[(size_t)by * bw_ + bx] = v; }

 private:
  int bw_, bh_;
  std::vector<int> v_;
};

struct Block {
  int dc_diff;   // quantised DC less its prediction
  int n;         // AC events
  int run[63], level[63];
};

// One 8x8 block of plane samples (0..255) -> its DC difference and AC events.
void code_block(const double px[64], int quant, bool luma, DcPlane& dcs, int bx, int by,
                Block* b) {
  double c[64];
  fdct(px, c);
  const int scaler = dc_scaler(quant, luma);
  const int qdc = (int)std::lround(c[0] / scaler);
  const int fa = dcs.at(bx - 1, by), fb = dcs.at(bx - 1, by - 1), fc = dcs.at(bx, by - 1);
  const int pred = std::abs(fa - fb) < std::abs(fb - fc) ? fc : fa;
  b->dc_diff = qdc - (pred + scaler / 2) / scaler;
  dcs.set(bx, by, qdc * scaler);
  b->n = 0;
  int run = 0;
  for (int i = 1; i < 64; ++i) {
    const double a = std::fabs(c[kZigzag[i]]);
    int level = (int)(a / (2.0 * quant));
    if (level == 0 && a >= 1.5 * quant) level = 1;
    if (level > 2047) level = 2047;
    if (level == 0) {
      ++run;
      continue;
    }
    b->run[b->n] = run;
    b->level[b->n] = c[kZigzag[i]] < 0 ? -level : level;
    ++b->n;
    run = 0;
  }
}

void put_block(BitWriter& bw, const Block& b, bool luma) {
  const int size = bit_length((unsigned)std::abs(b.dc_diff));
  const uint8_t* vlc = luma ? kDcLum[size] : kDcChrom[size];
  bw.put(vlc[0], vlc[1]);
  if (size) {
    // a negative difference is sent as its ones' complement in `size` bits
    bw.put((uint32_t)(b.dc_diff > 0 ? b.dc_diff : b.dc_diff + (1 << size) - 1), size);
    if (size > 8) bw.put(1, 1);   // marker_bit
  }
  for (int e = 0; e < b.n; ++e) {
    const int last = e == b.n - 1;
    const int level = std::abs(b.level[e]);
    const int i = level <= 27 ? kIndex.at[last][b.run[e]][level] : -1;
    if (i >= 0) {
      bw.put(kIntraVlc[i][0], kIntraVlc[i][1]);
      bw.put(b.level[e] < 0, 1);
    } else {  // escape mode 3
      bw.put(kIntraVlc[102][0], kIntraVlc[102][1]);
      bw.put(3, 2);
      bw.put(last, 1);
      bw.put(b.run[e], 6);
      bw.put(1, 1);
      bw.put((uint32_t)b.level[e] & 0xfffu, 12);
      bw.put(1, 1);
    }
  }
}

bool valid_args(int width, int height, int fps) {
  return width >= 16 && width <= 4096 && height >= 16 && height <= 4096 && fps >= 1 &&
         fps <= 65535;
}

}  // namespace

// The bytes an I-VOP of a width x height frame can take at most.
extern "C" long long mp4v_frame_capacity(int width, int height) {
  if (!valid_args(width, height, 1)) return -1;
  const long long mbs = (long long)((width + 15) / 16) * ((height + 15) / 16);
  // per block at most 12 + 12 + 1 DC bits and 63 x 30 escape bits
  return mbs * (6 * 240 + 4) + 64;
}

// The visual object sequence, visual object and video object layer
// headers for a width x height stream at fps frames a second.
extern "C" long long mp4v_headers(int width, int height, int fps, uint8_t* out, long long cap) {
  if (!valid_args(width, height, fps) || !out || cap < 0) return -1;
  BitWriter bw(out, cap);
  bw.start_code(0xB0);       // visual_object_sequence_start_code
  bw.put(0x01, 8);           // profile_and_level_indication: Simple Profile
  bw.start_code(0xB5);       // visual_object_start_code
  bw.put(1, 1);              // is_visual_object_identifier
  bw.put(1, 4);              // visual_object_verid
  bw.put(1, 3);              // visual_object_priority
  bw.put(1, 4);              // visual_object_type: video
  bw.put(0, 1);              // video_signal_type
  bw.stuff();
  bw.start_code(0x00);       // video_object_start_code
  bw.start_code(0x20);       // video_object_layer_start_code
  bw.put(0, 1);              // random_accessible_vol
  bw.put(1, 8);              // video_object_type_indication: Simple Object
  bw.put(1, 1);              // is_object_layer_identifier
  bw.put(1, 4);              // video_object_layer_verid
  bw.put(1, 3);              // video_object_layer_priority
  bw.put(1, 4);              // aspect_ratio_info: square pixels
  bw.put(1, 1);              // vol_control_parameters
  bw.put(1, 2);              // chroma_format: 4:2:0
  bw.put(1, 1);              // low_delay
  bw.put(0, 1);              // vbv_parameters
  bw.put(0, 2);              // video_object_layer_shape: rectangular
  bw.put(1, 1);              // marker_bit
  bw.put((uint32_t)fps, 16); // vop_time_increment_resolution
  bw.put(1, 1);              // marker_bit
  bw.put(0, 1);              // fixed_vop_rate
  bw.put(1, 1);              // marker_bit
  bw.put((uint32_t)width, 13);
  bw.put(1, 1);              // marker_bit
  bw.put((uint32_t)height, 13);
  bw.put(1, 1);              // marker_bit
  bw.put(0, 1);              // interlaced
  bw.put(1, 1);              // obmc_disable
  bw.put(0, 1);              // sprite_enable
  bw.put(0, 1);              // not_8_bit
  bw.put(0, 1);              // quant_type: H.263
  bw.put(1, 1);              // complexity_estimation_disable
  bw.put(1, 1);              // resync_marker_disable
  bw.put(0, 1);              // data_partitioned
  bw.put(0, 1);              // scalability
  bw.stuff();
  return bw.full() ? -2 : bw.size();
}

// Frame `index` (shown at index / fps seconds) as one I-VOP: rgb is
// (height, width, 3) uint8, row-major.
extern "C" long long mp4v_encode_frame(const uint8_t* rgb, int width, int height, int fps,
                                       long long index, int quant, uint8_t* out, long long cap) {
  if (!valid_args(width, height, fps) || !rgb || !out || cap < 0 || index < 0 || quant < 1 ||
      quant > 31) {
    return -1;
  }
  const int mbw = (width + 15) / 16, mbh = (height + 15) / 16;
  const int pw = mbw * 16, ph = mbh * 16;
  // planes of the padded frame: Y (ph x pw), Cb and Cr (ph/2 x pw/2)
  std::vector<double> Y((size_t)pw * ph), Cb((size_t)pw * ph / 4), Cr((size_t)pw * ph / 4);
  std::vector<double> cb_full((size_t)pw * ph), cr_full((size_t)pw * ph);
  for (int y = 0; y < ph; ++y) {
    const int sy = y < height ? y : height - 1;
    for (int x = 0; x < pw; ++x) {
      const int sx = x < width ? x : width - 1;
      const uint8_t* p = rgb + ((size_t)sy * width + sx) * 3;
      const double r = p[0], g = p[1], b = p[2];
      const size_t i = (size_t)y * pw + x;
      Y[i] = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0;
      cb_full[i] = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0;
      cr_full[i] = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0;
    }
  }
  auto clip_round = [](double v) { return v < 0 ? 0.0 : (v > 255 ? 255.0 : std::nearbyint(v)); };
  for (auto& v : Y) v = clip_round(v);
  for (int y = 0; y < ph / 2; ++y) {
    for (int x = 0; x < pw / 2; ++x) {
      const size_t a = (size_t)(2 * y) * pw + 2 * x, b = a + pw;
      const size_t o = (size_t)y * (pw / 2) + x;
      Cb[o] = clip_round((cb_full[a] + cb_full[a + 1] + cb_full[b] + cb_full[b + 1]) / 4.0);
      Cr[o] = clip_round((cr_full[a] + cr_full[a + 1] + cr_full[b] + cr_full[b + 1]) / 4.0);
    }
  }

  BitWriter bw(out, cap);
  bw.start_code(0xB6);                               // vop_start_code
  bw.put(0, 2);                                      // vop_coding_type: I
  const long long secs = index / fps, prev = index ? (index - 1) / fps : 0;
  for (long long s = prev; s < secs; ++s) bw.put(1, 1);   // modulo_time_base
  bw.put(0, 1);
  bw.put(1, 1);                                      // marker_bit
  bw.put((uint32_t)(index % fps), time_increment_bits(fps));
  bw.put(1, 1);                                      // marker_bit
  bw.put(1, 1);                                      // vop_coded
  bw.put(0, 3);                                      // intra_dc_vlc_thr
  bw.put((uint32_t)quant, 5);                        // vop_quant

  DcPlane dy(2 * mbw, 2 * mbh), dcb(mbw, mbh), dcr(mbw, mbh);
  Block blocks[6];
  double px[64];
  for (int my = 0; my < mbh && !bw.full(); ++my) {
    for (int mx = 0; mx < mbw; ++mx) {
      for (int k = 0; k < 4; ++k) {
        const int bx = 2 * mx + (k & 1), by = 2 * my + (k >> 1);
        for (int y = 0; y < 8; ++y) {
          for (int x = 0; x < 8; ++x) px[y * 8 + x] = Y[(size_t)(by * 8 + y) * pw + bx * 8 + x];
        }
        code_block(px, quant, true, dy, bx, by, &blocks[k]);
      }
      for (int k = 0; k < 2; ++k) {
        const std::vector<double>& plane = k ? Cr : Cb;
        for (int y = 0; y < 8; ++y) {
          for (int x = 0; x < 8; ++x) {
            px[y * 8 + x] = plane[(size_t)(my * 8 + y) * (pw / 2) + mx * 8 + x];
          }
        }
        code_block(px, quant, false, k ? dcr : dcb, mx, my, &blocks[4 + k]);
      }
      int cbp = 0;   // bit 5 - k: block k has AC events
      for (int k = 0; k < 6; ++k) cbp |= (blocks[k].n > 0) << (5 - k);
      bw.put(kMcbpc[cbp & 3][0], kMcbpc[cbp & 3][1]);
      bw.put(0, 1);                                  // ac_pred_flag
      bw.put(kCbpy[cbp >> 2][0], kCbpy[cbp >> 2][1]);
      for (int k = 0; k < 6; ++k) put_block(bw, blocks[k], k < 4);
    }
  }
  bw.stuff();
  return bw.full() ? -2 : bw.size();
}
