// A baseline JPEG decoder for the port's dataset loaders.
//
// It decodes what the Mip-NeRF 360 captures hold: sequential Huffman-coded
// JPEG (SOF0 and SOF1) with 8-bit samples, one (grey) or three (YCbCr or
// RGB) components, sampling factors up to 2x2, restart intervals, and scans
// that interleave the components or carry one each.  It refuses
// progressive, lossless, hierarchical and arithmetic-coded files, 12-bit
// samples and four-component (CMYK, YCCK) images.
//
// The output is meant to equal, byte for byte, what libjpeg-turbo gives
// with its default decompression settings (the decoder behind PIL, and so
// behind imageio.v2.imread): the accurate integer IDCT of jidctint.c
// (jpeg_idct_islow) with the range-limit table of jdmaster.c, the fancy
// (triangle) upsampling of jdsample.c (h2v1_fancy_upsample,
// h2v2_fancy_upsample, h1v2_fancy_upsample; plain replication where a
// component is at most two samples wide), with the edge rows replicated as
// jdmainct.c does, and the fixed-point YCbCr -> RGB tables of jdcolor.c.
//
// Plain C interface for ctypes:
//   int jpeg_header(data, size, &width, &height, &channels, err, err_len)
//   int jpeg_decode(data, size, out, out_size, err, err_len)
// Each returns 0, or 1 with a message in ``err``.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// The zigzag position -> natural (row-major) index, with 16 entries past
// the end that a corrupt run length can reach, all 63 (jutils.c).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];  // the largest code of each length, -1 if none
  int32_t valoff[17];   // vals index of a code of length l: code + valoff[l]
  // Codes of up to kLook bits: (length << 8) | value, 0 where longer.
  static const int kLook = 9;
  uint16_t look[1 << kLook];

  void build(const uint8_t* counts, const uint8_t* values, int n) {
    std::memcpy(vals, values, n);
    std::memset(look, 0, sizeof(look));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valoff[l] = k - code;
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
        if (l <= kLook) {
          int shift = kLook - l;
          for (int j = 0; j < (1 << shift); ++j)
            look[(code << shift) | j] = (uint16_t)((l << 8) | values[k]);
        }
      }
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      if (code > (1 << l)) throw Error{"bad Huffman table"};
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;          // Huffman tables of the current scan
  int bw = 0, bh = 0;          // blocks in the padded MCU grid
  int cw = 0, ch = 0;          // samples, as downsampled (jdinput.c)
  bool latched = false;        // quantisation table taken at its first scan
  int32_t quant[64];           // natural order
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  std::vector<uint8_t> pix;    // (bh * 8) x (bw * 8) samples
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}

  // The next ``k`` bits (k <= 16), most significant first.
  int peek(int k) {
    if (cnt_ < k) fill();
    return (int)(acc_ >> (64 - k));
  }
  void skip(int k) {
    acc_ <<= k;
    cnt_ -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  // A ``k``-bit magnitude category made signed (HUFF_EXTEND).
  int receive_extend(int k) {
    if (k == 0) return 0;
    int v = get(k);
    return v < (1 << (k - 1)) ? v - (1 << k) + 1 : v;
  }
  int decode(const Huffman& t) {
    if (cnt_ < 16) fill();
    int look = (int)(acc_ >> (64 - Huffman::kLook));
    int e = t.look[look];
    if (e) {
      skip(e >> 8);
      return e & 0xff;
    }
    int code = get(Huffman::kLook);
    int l = Huffman::kLook;
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      if (++l > 16) throw Error{"corrupt Huffman code"};
    }
    return t.vals[code + t.valoff[l]];
  }
  // Drop the bits left in the buffer and read the restart marker that
  // must follow.
  void restart() {
    acc_ = 0;
    cnt_ = 0;
    marker_ = false;
    while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
    if (pos_ >= n_ || d_[pos_] < 0xD0 || d_[pos_] > 0xD7) throw Error{"missing restart marker"};
    ++pos_;
  }
  // The position of the marker that ends the entropy-coded segment.
  size_t marker_pos() {
    size_t p = pos_;
    while (p + 1 < n_) {
      if (d_[p] == 0xFF && d_[p + 1] != 0 && d_[p + 1] != 0xFF && (d_[p + 1] < 0xD0 || d_[p + 1] > 0xD7))
        return p;
      ++p;
    }
    return n_;
  }

 private:
  // Bytes into the accumulator, stuffed 0xFF 0x00 read as 0xFF; at a
  // marker, zeros (as libjpeg does when data ends early).
  void fill() {
    while (cnt_ <= 56) {
      uint32_t b = 0;
      if (!marker_ && pos_ < n_) {
        b = d_[pos_];
        if (b == 0xFF) {
          size_t p = pos_ + 1;
          while (p < n_ && d_[p] == 0xFF) ++p;
          if (p < n_ && d_[p] == 0x00) {
            pos_ = p + 1;
          } else {
            marker_ = true;  // pos_ stays on the marker
            b = 0;
          }
        } else {
          ++pos_;
        }
      }
      acc_ |= (uint64_t)b << (56 - cnt_);
      cnt_ += 8;
    }
  }

  const uint8_t* d_;
  size_t n_, pos_;
  uint64_t acc_ = 0;
  int cnt_ = 0;
  bool marker_ = false;
};

// jdmaster.c's prepare_range_limit_table, the post-IDCT part: indexed by
// the descaled value & 1023 (RANGE_MASK), the level shift included.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int x = 0; x < 1024; ++x) {
      if (x < 128) t[x] = (uint8_t)(x + 128);
      else if (x < 512) t[x] = 255;
      else if (x < 896) t[x] = 0;
      else t[x] = (uint8_t)(x - 896);
    }
  }
};
const RangeLimit kRange;

// jidctint.c, jpeg_idct_islow.
const int kConstBits = 13, kPass1Bits = 2;
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int32_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = (int)(((int64_t)ip[0] * qp[0]) * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = kConstBits - kPass1Bits;
    wp[0] = (int)descale(tmp10 + tmp3, s);
    wp[56] = (int)descale(tmp10 - tmp3, s);
    wp[8] = (int)descale(tmp11 + tmp2, s);
    wp[48] = (int)descale(tmp11 - tmp2, s);
    wp[16] = (int)descale(tmp12 + tmp1, s);
    wp[40] = (int)descale(tmp12 - tmp1, s);
    wp[24] = (int)descale(tmp13 + tmp0, s);
    wp[32] = (int)descale(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    const int s = kConstBits + kPass1Bits + 3;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
      uint8_t dc = kRange.t[(int)descale(wp[0], kPass1Bits + 3) & 1023];
      for (int k = 0; k < 8; ++k) op[k] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = kRange.t[(int)descale(tmp10 + tmp3, s) & 1023];
    op[7] = kRange.t[(int)descale(tmp10 - tmp3, s) & 1023];
    op[1] = kRange.t[(int)descale(tmp11 + tmp2, s) & 1023];
    op[6] = kRange.t[(int)descale(tmp11 - tmp2, s) & 1023];
    op[2] = kRange.t[(int)descale(tmp12 + tmp1, s) & 1023];
    op[5] = kRange.t[(int)descale(tmp12 - tmp1, s) & 1023];
    op[3] = kRange.t[(int)descale(tmp13 + tmp0, s) & 1023];
    op[4] = kRange.t[(int)descale(tmp13 - tmp0, s) & 1023];
  }
}

// jdcolor.c's tables (SCALEBITS 16).
struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    const int64_t half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  // Reads the markers up to the first scan: the frame and the colour space.
  void header() {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) throw Error{"not a JPEG file (no SOI marker)"};
    pos_ = 2;
    while (!frame_) {
      int m = next_marker();
      if (m == 0xD9) throw Error{"no frame before the end of the image"};
      if (m == 0xDA) throw Error{"a scan before the frame header"};
      segment(m);
    }
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int channels() const { return (int)comps_.size(); }

  void decode(uint8_t* out) {
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) {
        scan();
        continue;
      }
      segment(m);
    }
    if (!scans_) throw Error{"no scan in the file"};
    for (Component& c : comps_) inverse_dct(c);
    output(out);
  }

 private:
  int byte() {
    if (pos_ >= n_) throw Error{"unexpected end of file"};
    return d_[pos_++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker() {
    // Skip anything up to a 0xFF, then fill bytes.
    while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
    while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
    if (pos_ >= n_) throw Error{"unexpected end of file (no EOI marker)"};
    return d_[pos_++];
  }

  void segment(int m) {
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) return;  // no length
    size_t start = pos_;
    int len = word();
    if (len < 2) throw Error{"bad marker segment length"};
    if (start + len > n_) throw Error{"unexpected end of file in a marker segment"};
    size_t end = start + len;
    switch (m) {
      case 0xC0:
      case 0xC1:
        frame(end);
        break;
      case 0xC2:
      case 0xC6:
      case 0xCA:
      case 0xCE:
        throw Error{"progressive JPEG is not supported"};
      case 0xC3:
      case 0xC7:
      case 0xCB:
      case 0xCF:
        throw Error{"lossless JPEG is not supported"};
      case 0xC5:
        throw Error{"hierarchical JPEG is not supported"};
      case 0xC9:
      case 0xCC:
      case 0xCD:
        throw Error{"arithmetic-coded JPEG is not supported"};
      case 0xC4:
        huffman_tables(end);
        break;
      case 0xDB:
        quant_tables(end);
        break;
      case 0xDD:
        if (len != 4) throw Error{"bad DRI segment"};
        restart_interval_ = word();
        break;
      case 0xE0:
        if (len >= 16 && std::memcmp(d_ + pos_, "JFIF\0", 5) == 0) jfif_ = true;
        break;
      case 0xEE:
        if (len >= 14 && std::memcmp(d_ + pos_, "Adobe", 5) == 0) {
          adobe_ = true;
          adobe_transform_ = d_[pos_ + 11];
        }
        break;
      default:
        break;  // APPn, COM, DNL and the rest carry nothing the decode needs
    }
    pos_ = end;
  }

  void frame(size_t end) {
    if (frame_) throw Error{"a second frame header"};
    frame_ = true;
    int precision = byte();
    if (precision != 8) throw Error{std::to_string(precision) + "-bit samples are not supported (8-bit only)"};
    height_ = word();
    width_ = word();
    int nf = byte();
    if (height_ == 0 || width_ == 0) throw Error{"a zero image size (DNL) is not supported"};
    if (nf == 4) throw Error{"four-component (CMYK or YCCK) JPEG is not supported"};
    if (nf != 1 && nf != 3) throw Error{std::to_string(nf) + "-component JPEG is not supported"};
    if (pos_ + 3 * nf > end) throw Error{"bad frame header"};
    comps_.resize(nf);
    hmax_ = vmax_ = 1;
    for (Component& c : comps_) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2) throw Error{"sampling factors above 2 are not supported"};
      if (c.tq > 3) throw Error{"bad quantisation table index"};
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (Component& c : comps_) {
      c.cw = (width_ * c.h + hmax_ - 1) / hmax_;
      c.ch = (height_ * c.v + vmax_ - 1) / vmax_;
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
  }

  void huffman_tables(size_t end) {
    while (pos_ < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Error{"bad Huffman table index"};
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = (uint8_t)byte();
      if (total > 256 || pos_ + total > end) throw Error{"bad Huffman table"};
      (tc ? ac_ : dc_)[th].build(counts, d_ + pos_, total);
      pos_ += total;
    }
  }

  void quant_tables(size_t end) {
    while (pos_ < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) throw Error{"bad quantisation table"};
      for (int i = 0; i < 64; ++i) quant_[tq][kNatural[i]] = pq ? word() : byte();
      quant_defined_[tq] = true;
    }
  }

  void scan() {
    if (!frame_) throw Error{"a scan before the frame header"};
    size_t start = pos_;
    int len = word();
    int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) throw Error{"bad scan header"};
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = byte(), t = byte();
      Component* c = nullptr;
      for (Component& k : comps_)
        if (k.id == id) c = &k;
      if (c == nullptr) throw Error{"a scan names an unknown component"};
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc_[c->td].defined || !ac_[c->ta].defined)
        throw Error{"a scan uses an undefined Huffman table"};
      if (!c->latched) {
        if (!quant_defined_[c->tq]) throw Error{"a component uses an undefined quantisation table"};
        // libjpeg keeps the multipliers as short (ISLOW_MULT_TYPE).
        for (int i = 0; i < 64; ++i) c->quant[i] = (int16_t)quant_[c->tq][i];
        c->latched = true;
      }
      sc.push_back(c);
    }
    int ss = byte(), se = byte(), a = byte();
    if (ss != 0 || se != 63 || a != 0) throw Error{"progressive JPEG is not supported"};
    pos_ = start + len;
    ++scans_;

    BitReader br(d_, n_, pos_);
    std::vector<int> pred(ns, 0);
    auto block = [&](int k, int bx, int by) {
      Component& c = *sc[k];
      int16_t* blk = c.coef.data() + ((size_t)by * c.bw + bx) * 64;
      int t = br.decode(dc_[c.td]);
      if (t > 16) throw Error{"corrupt DC coefficient"};
      pred[k] += br.receive_extend(t);
      blk[0] = (int16_t)pred[k];
      const Huffman& ac = ac_[c.ta];
      for (int i = 1; i < 64;) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          i += r;
          int v = br.receive_extend(s);
          blk[kNatural[i]] = (int16_t)v;
          ++i;
        } else {
          if (r != 15) break;
          i += 16;
        }
      }
    };
    int n_mcu, mcu_w;
    if (ns == 1) {  // one component: an MCU is one block of its own grid
      mcu_w = (sc[0]->cw + 7) / 8;
      n_mcu = mcu_w * ((sc[0]->ch + 7) / 8);
    } else {
      mcu_w = mcux_;
      n_mcu = mcux_ * mcuy_;
    }
    for (int m = 0; m < n_mcu; ++m) {
      if (restart_interval_ && m > 0 && m % restart_interval_ == 0) {
        br.restart();
        std::fill(pred.begin(), pred.end(), 0);
      }
      int mx = m % mcu_w, my = m / mcu_w;
      if (ns == 1) {
        block(0, mx, my);
        continue;
      }
      for (int k = 0; k < ns; ++k) {
        const Component& c = *sc[k];
        for (int v = 0; v < c.v; ++v)
          for (int h = 0; h < c.h; ++h) block(k, mx * c.h + h, my * c.v + v);
      }
    }
    pos_ = br.marker_pos();
  }

  void inverse_dct(Component& c) {
    const int stride = c.bw * 8;
    c.pix.assign((size_t)stride * c.bh * 8, 0);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, c.quant,
                   c.pix.data() + (size_t)by * 8 * stride + bx * 8, stride);
    std::vector<int16_t>().swap(c.coef);
  }

  // One component at the image's size, upsampled as jdsample.c does.
  std::vector<uint8_t> full_size(const Component& c) {
    const int rh = hmax_ / c.h, rv = vmax_ / c.v;
    const int stride = c.bw * 8, cw = c.cw, ch = c.ch;
    const int ow = cw * rh;  // at least width_
    std::vector<uint8_t> out((size_t)ow * ch * rv);
    auto in = [&](int y) { return c.pix.data() + (size_t)std::min(std::max(y, 0), ch - 1) * stride; };
    if (rh == 1 && rv == 1) {
      for (int y = 0; y < ch; ++y) std::memcpy(&out[(size_t)y * ow], in(y), cw);
    } else if (rh == 2 && rv == 1) {
      for (int y = 0; y < ch; ++y) {
        const uint8_t* ip = in(y);
        uint8_t* op = &out[(size_t)y * ow];
        if (cw > 2) {  // h2v1_fancy_upsample
          op[0] = ip[0];
          op[1] = (uint8_t)((ip[0] * 3 + ip[1] + 2) >> 2);
          for (int x = 1; x < cw - 1; ++x) {
            int v = ip[x] * 3;
            op[2 * x] = (uint8_t)((v + ip[x - 1] + 1) >> 2);
            op[2 * x + 1] = (uint8_t)((v + ip[x + 1] + 2) >> 2);
          }
          op[2 * cw - 2] = (uint8_t)((ip[cw - 1] * 3 + ip[cw - 2] + 1) >> 2);
          op[2 * cw - 1] = ip[cw - 1];
        } else {  // h2v1_upsample
          for (int x = 0; x < cw; ++x) op[2 * x] = op[2 * x + 1] = ip[x];
        }
      }
    } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < ch; ++y) {
        for (int v = 0; v < 2; ++v) {
          const uint8_t* i0 = in(y);
          const uint8_t* i1 = in(v == 0 ? y - 1 : y + 1);
          const int bias = v == 0 ? 1 : 2;
          uint8_t* op = &out[(size_t)(2 * y + v) * ow];
          for (int x = 0; x < cw; ++x) op[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
        }
      }
    } else {  // rh == 2 && rv == 2
      for (int y = 0; y < ch; ++y) {
        for (int v = 0; v < 2; ++v) {
          const uint8_t* i0 = in(y);
          const uint8_t* i1 = in(v == 0 ? y - 1 : y + 1);
          uint8_t* op = &out[(size_t)(2 * y + v) * ow];
          if (cw > 2) {  // h2v2_fancy_upsample
            int this_sum = i0[0] * 3 + i1[0];
            int next_sum = i0[1] * 3 + i1[1];
            op[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
            op[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
            int last_sum = this_sum;
            this_sum = next_sum;
            for (int x = 1; x < cw - 1; ++x) {
              next_sum = i0[x + 1] * 3 + i1[x + 1];
              op[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
              op[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
              last_sum = this_sum;
              this_sum = next_sum;
            }
            op[2 * cw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
            op[2 * cw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
          } else {  // h2v2_upsample
            for (int x = 0; x < cw; ++x) op[2 * x] = op[2 * x + 1] = i0[x];
          }
        }
      }
    }
    return out;
  }

  void output(uint8_t* out) {
    const size_t w = width_, h = height_;
    if (comps_.size() == 1) {
      std::vector<uint8_t> y = full_size(comps_[0]);
      const size_t ow = (size_t)comps_[0].cw * (hmax_ / comps_[0].h);
      for (size_t r = 0; r < h; ++r) std::memcpy(out + r * w, &y[r * ow], w);
      return;
    }
    std::vector<uint8_t> p[3];
    size_t ow[3];
    for (int k = 0; k < 3; ++k) {
      p[k] = full_size(comps_[k]);
      ow[k] = (size_t)comps_[k].cw * (hmax_ / comps_[k].h);
    }
    // jdapimin.c's default_decompress_parms for three components.
    bool rgb;
    if (jfif_) rgb = false;
    else if (adobe_) rgb = adobe_transform_ == 0;
    else rgb = comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
    for (size_t r = 0; r < h; ++r) {
      const uint8_t *y = &p[0][r * ow[0]], *cb = &p[1][r * ow[1]], *cr = &p[2][r * ow[2]];
      uint8_t* op = out + r * w * 3;
      for (size_t x = 0; x < w; ++x) {
        if (rgb) {
          op[3 * x] = y[x];
          op[3 * x + 1] = cb[x];
          op[3 * x + 2] = cr[x];
          continue;
        }
        int yy = y[x], b = cb[x], rr = cr[x];
        op[3 * x] = clamp255(yy + kColor.cr_r[rr]);
        op[3 * x + 1] = clamp255(yy + (int)((kColor.cb_g[b] + kColor.cr_g[rr]) >> 16));
        op[3 * x + 2] = clamp255(yy + kColor.cb_b[b]);
      }
    }
  }

  const uint8_t* d_;
  size_t n_, pos_ = 0;
  bool frame_ = false, jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0, scans_ = 0;
  std::vector<Component> comps_;
  Huffman dc_[4], ac_[4];
  int32_t quant_[4][64];
  bool quant_defined_[4] = {false, false, false, false};
};

void set_error(char* err, int err_len, const std::string& msg) {
  if (err && err_len > 0) std::snprintf(err, (size_t)err_len, "%s", msg.c_str());
}

}  // namespace

extern "C" {

int jpeg_header(const uint8_t* data, int64_t size, int* width, int* height, int* channels, char* err,
                int err_len) {
  try {
    Decoder dec(data, (size_t)size);
    dec.header();
    *width = dec.width();
    *height = dec.height();
    *channels = dec.channels();
    return 0;
  } catch (const Error& e) {
    set_error(err, err_len, e.msg);
  } catch (const std::exception& e) {
    set_error(err, err_len, e.what());
  }
  return 1;
}

// ``out`` holds height x width x channels bytes (``out_size``).
int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t out_size, char* err, int err_len) {
  try {
    Decoder dec(data, (size_t)size);
    dec.header();
    if ((int64_t)dec.width() * dec.height() * dec.channels() != out_size) throw Error{"output buffer size"};
    dec.decode(out);
    return 0;
  } catch (const Error& e) {
    set_error(err, err_len, e.msg);
  } catch (const std::exception& e) {
    set_error(err, err_len, e.what());
  }
  return 1;
}

}  // extern "C"
