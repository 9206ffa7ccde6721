// Baseline JPEG codec of the port's host library (C ABI, loaded via ctypes).
//
// Decoder: sequential Huffman JPEG (SOF0 / SOF1), 8-bit samples, 1 or 3
// components, any integral sampling factors (4:4:4, 4:2:2, 4:2:0, 4:4:0),
// interleaved or one scan per component, restart markers. It decodes as
// libjpeg(-turbo) does with its default settings, so its output equals
// theirs bit for bit:
//   - the "islow" integer inverse DCT (jidctint.c: 13-bit constants, two
//     passes, PASS1_BITS = 2) and its post-IDCT range-limit table;
//   - fancy (triangle) upsampling of subsampled chroma (jdsample.c's h2v1,
//     h1v2 and h2v2 fancy routines, edges clamped; plain replication where
//     the component is at most 2 samples wide, as libjpeg chooses);
//   - libjpeg's fixed-point YCbCr -> RGB tables (jdcolor.c, 16 fraction bits).
// Progressive, lossless, hierarchical and arithmetic-coded files are
// refused with an error that names the mode.
//
// Encoder: baseline 4:4:4 or 4:2:0, the Annex K tables scaled by libjpeg's
// quality formula, float DCT. It makes test and fixture photos where no
// other encoder is installed.
//
// API style: jpeg_probe reads the frame header; jpeg_decode fills a
// caller-allocated (H, W, 3) buffer; jpeg_encode writes into a caller buffer
// and returns the byte count. Errors return nonzero (or -1) and leave a
// message for jpeg_last_error.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace rjpeg {

static thread_local std::string g_error;

// zigzag index -> natural (row-major) index; 16 extra entries absorb a
// corrupt run length past 63, as libjpeg's jpeg_natural_order does.
static const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

[[noreturn]] static void fail(const std::string& m) { throw Error{m}; }

// ---------------------------------------------------------------------------
// Huffman tables
// ---------------------------------------------------------------------------
struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint16_t look[512];  // 9-bit lookahead: (length << 8) | value, 0 = slow path

  void build() {
    int code = 0, k = 0;
    int32_t huffcode[257];
    uint8_t huffsize[257];
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) huffsize[k++] = (uint8_t)l;
    int n = k;
    k = 0;
    int si = n ? huffsize[0] : 0;
    while (k < n) {
      while (k < n && huffsize[k] == si) huffcode[k++] = code++;
      if (code >= (1 << si)) fail("bad Huffman table");
      code <<= 1;
      ++si;
    }
    k = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = k - huffcode[k];
        k += bits[l];
        maxcode[l] = huffcode[k - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    memset(look, 0, sizeof look);
    for (int i = 0; i < n; ++i) {
      int l = huffsize[i];
      if (l > 9) continue;
      int base = huffcode[i] << (9 - l);
      for (int j = 0; j < (1 << (9 - l)); ++j)
        look[base + j] = (uint16_t)((l << 8) | vals[i]);
    }
    defined = true;
  }
};

// ---------------------------------------------------------------------------
// Entropy-coded segment reader: 0xFF00 unstuffing; a marker stops the
// reader, which then feeds zero bits (as libjpeg does).
// ---------------------------------------------------------------------------
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;
  int past_end = 0;  // zero bytes fed because the data ended (not at a marker)

  BitReader(const uint8_t* b, const uint8_t* e) : p(b), end(e) {}

  // the scan consumed bits that the file does not hold
  bool truncated() const { return past_end * 8 > cnt; }

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!at_marker && p >= end) {
        ++past_end;
      } else if (!at_marker) {
        if (*p == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;
          if (q < end && *q == 0x00) {
            b = 0xFF;
            p = q + 1;
          } else {
            at_marker = true;
            p = q - 1;  // the 0xFF right before the marker code
          }
        } else {
          b = *p++;
        }
      }
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }

  int bits(int n) {
    if (n == 0) return 0;
    if (cnt < n) fill();
    int v = (int)(buf >> (64 - n));
    buf <<= n;
    cnt -= n;
    return v;
  }

  int decode(const HuffTable& t) {
    if (cnt < 16) fill();
    uint16_t e = t.look[buf >> (64 - 9)];
    if (e) {
      int l = e >> 8;
      buf <<= l;
      cnt -= l;
      return e & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      int32_t code = (int32_t)(buf >> (64 - l));
      if (code <= t.maxcode[l]) {
        buf <<= l;
        cnt -= l;
        return t.vals[code + t.valoffset[l]];
      }
    }
    fail("corrupt Huffman code");
  }

  // Drop buffered bits and move p to the next marker's 0xFF.
  void to_marker() {
    buf = 0;
    cnt = 0;
    if (at_marker) {
      at_marker = false;
      return;
    }
    while (p < end) {
      if (p[0] == 0xFF && p + 1 < end && p[1] != 0x00 && p[1] != 0xFF) return;
      ++p;
    }
  }
};

static inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ---------------------------------------------------------------------------
// libjpeg's islow inverse DCT (jidctint.c) and range limit
// ---------------------------------------------------------------------------
static const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                     F0_899 = 7373, F1_175 = 9633, F1_501 = 12299, F1_847 = 15137,
                     F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;

struct RangeLimit {
  uint8_t t[1024];  // post-IDCT value & 1023 -> sample (jdmaster.c's table)
  RangeLimit() {
    for (int x = 0; x < 1024; ++x) {
      if (x < 128) t[x] = (uint8_t)(128 + x);
      else if (x < 512) t[x] = 255;
      else if (x < 896) t[x] = 0;
      else t[x] = (uint8_t)(x - 896);
    }
  }
};
static const RangeLimit kLimit;

static inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

static void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int dc = (int)in[0] * (int)qt[0] * 4;  // LEFT_SHIFT(.., PASS1_BITS)
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * qt[16], z3 = (int64_t)in[48] * qt[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = (int64_t)in[0] * qt[0];
    z3 = (int64_t)in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qt[56];
    tmp1 = (int64_t)in[40] * qt[40];
    tmp2 = (int64_t)in[24] * qt[24];
    tmp3 = (int64_t)in[8] * qt[8];
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
    w[0] = (int)descale(tmp10 + tmp3, 11);
    w[56] = (int)descale(tmp10 - tmp3, 11);
    w[8] = (int)descale(tmp11 + tmp2, 11);
    w[48] = (int)descale(tmp11 - tmp2, 11);
    w[16] = (int)descale(tmp12 + tmp1, 11);
    w[40] = (int)descale(tmp12 - tmp1, 11);
    w[24] = (int)descale(tmp13 + tmp0, 11);
    w[32] = (int)descale(tmp13 - tmp0, 11);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t v = kLimit.t[(int)descale(w[0], 5) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * 8192, tmp1 = ((int64_t)w[0] - w[4]) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
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
    o[0] = kLimit.t[(int)descale(tmp10 + tmp3, 18) & 1023];
    o[7] = kLimit.t[(int)descale(tmp10 - tmp3, 18) & 1023];
    o[1] = kLimit.t[(int)descale(tmp11 + tmp2, 18) & 1023];
    o[6] = kLimit.t[(int)descale(tmp11 - tmp2, 18) & 1023];
    o[2] = kLimit.t[(int)descale(tmp12 + tmp1, 18) & 1023];
    o[5] = kLimit.t[(int)descale(tmp12 - tmp1, 18) & 1023];
    o[3] = kLimit.t[(int)descale(tmp13 + tmp0, 18) & 1023];
    o[4] = kLimit.t[(int)descale(tmp13 - tmp0, 18) & 1023];
  }
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------
struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  bool latched = false;
  uint16_t q[64];                // dequantisation table, natural order
  int wblocks = 0, hblocks = 0;  // blocks with image data (libjpeg width_in_blocks)
  int bw = 0, bh = 0;            // allocated blocks (whole MCUs)
  int dw = 0, dh = 0;            // downsampled_width / downsampled_height
  std::vector<int16_t> coef;     // bw * bh blocks of 64
  int pred = 0;
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  bool have_frame = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  int mcux = 0, mcuy = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  std::vector<Component> comps;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8() {
    if (pos >= n) fail("unexpected end of JPEG data");
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // next marker code, skipping fill bytes (and, leniently, garbage)
  int next_marker() {
    for (;;) {
      int c = u8();
      if (c != 0xFF) continue;
      while ((c = u8()) == 0xFF) {
      }
      if (c != 0) return c;
    }
  }

  static std::string mode_name(int m) {
    switch (m) {
      case 0xC2: return "progressive JPEG";
      case 0xC3: return "lossless JPEG";
      case 0xC5: case 0xC6: case 0xC7: return "hierarchical (differential) JPEG";
      case 0xC9: return "arithmetic-coded sequential JPEG";
      case 0xCA: return "arithmetic-coded progressive JPEG";
      case 0xCB: return "arithmetic-coded lossless JPEG";
      case 0xCD: case 0xCE: case 0xCF: return "arithmetic-coded hierarchical JPEG";
      default: return "JPEG";
    }
  }

  void read_dqt(int len) {
    size_t end = pos + len;
    while (pos < end) {
      int pq = u8();
      int t = pq & 15, prec = pq >> 4;
      if (t > 3) fail("bad DQT table index");
      for (int k = 0; k < 64; ++k) qt[t][kNatural[k]] = (uint16_t)(prec ? u16() : u8());
      qt_defined[t] = true;
    }
  }

  void read_dht(int len) {
    size_t end = pos + len;
    while (pos < end) {
      int tc = u8();
      int cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) fail("bad DHT table index");
      HuffTable& h = cls ? ac[t] : dc[t];
      int total = 0;
      h.bits[0] = 0;
      for (int l = 1; l <= 16; ++l) {
        h.bits[l] = (uint8_t)u8();
        total += h.bits[l];
      }
      if (total > 256) fail("bad DHT table size");
      for (int i = 0; i < total; ++i) h.vals[i] = (uint8_t)u8();
      h.build();
    }
  }

  void read_sof(int len) {
    size_t end = pos + len;
    if (have_frame) fail("more than one frame header");
    int prec = u8();
    if (prec != 8) fail(std::to_string(prec) + "-bit JPEG samples are not supported");
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) fail("JPEG with a DNL height is not supported");
    if (width == 0) fail("JPEG frame of width 0");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + "-component JPEG is not supported (1 or 3)");
    comps.resize(ncomp);
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) fail("bad JPEG component");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    pos = end;
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v) fail("non-integral JPEG sampling factors");
      c.wblocks = (int)(((long)width * c.h + 8L * hmax - 1) / (8L * hmax));
      c.hblocks = (int)(((long)height * c.v + 8L * vmax - 1) / (8L * vmax));
      c.dw = (int)(((long)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((long)height * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    have_frame = true;
  }

  void decode_block(BitReader& br, Component& c, int bx, int by) {
    int16_t* blk = c.coef.data() + ((size_t)by * c.bw + bx) * 64;
    const HuffTable& d = dc[c.td];
    const HuffTable& a = ac[c.ta];
    int s = br.decode(d);
    int diff = s ? extend(br.bits(s), s) : 0;
    c.pred += diff;
    blk[0] = (int16_t)c.pred;
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(a);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(br.bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void read_sos(int len) {
    if (!have_frame) fail("scan before the frame header");
    size_t end = pos + len;
    int ns = u8();
    if (ns < 1 || ns > 4) fail("bad JPEG scan");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail("scan names an unknown component");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].defined || !ac[found->ta].defined)
        fail("scan uses an undefined Huffman table");
      if (!found->latched) {
        if (!qt_defined[found->tq]) fail("component uses an undefined quantisation table");
        memcpy(found->q, qt[found->tq], sizeof found->q);
        found->latched = true;
      }
      sc.push_back(found);
    }
    int ss = u8(), se = u8(), ahl = u8();
    if (ss != 0 || se != 63 || ahl != 0) fail("progressive JPEG scan");
    pos = end;
    for (auto* c : sc) c->pred = 0;

    BitReader br(data + pos, data + n);
    long total, per_row;
    if (ns == 1) {
      per_row = sc[0]->wblocks;
      total = per_row * sc[0]->hblocks;
    } else {
      per_row = mcux;
      total = (long)mcux * mcuy;
    }
    int rst = 0;
    for (long m = 0; m < total; ++m) {
      if (restart_interval && m && m % restart_interval == 0) {
        br.to_marker();
        const uint8_t* p = br.p;
        if (!(p + 1 < data + n && p[0] == 0xFF && p[1] == 0xD0 + rst))
          fail("missing restart marker");
        br.p = p + 2;
        rst = (rst + 1) & 7;
        for (auto* c : sc) c->pred = 0;
      }
      long my = m / per_row, mx = m % per_row;
      if (ns == 1) {
        decode_block(br, *sc[0], (int)mx, (int)my);
      } else {
        for (auto* c : sc)
          for (int v = 0; v < c->v; ++v)
            for (int h = 0; h < c->h; ++h)
              decode_block(br, *c, (int)(mx * c->h + h), (int)(my * c->v + v));
      }
    }
    if (br.truncated()) fail("truncated JPEG: the data ends inside a scan");
    br.to_marker();
    pos = (size_t)(br.p - data);
  }

  void parse(bool header_only) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RST
      if (m == 0x01) continue;              // TEM
      int len = u16() - 2;
      if (len < 0 || pos + (size_t)len > n) fail("truncated JPEG marker segment");
      if (m == 0xC0 || m == 0xC1) {
        read_sof(len);
        if (header_only) return;
      } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        fail(mode_name(m) + " is not supported (baseline sequential Huffman only)");
      } else if (m == 0xCC) {
        fail(mode_name(0xC9) + " is not supported (baseline sequential Huffman only)");
      } else if (m == 0xC4) {
        read_dht(len);
      } else if (m == 0xDB) {
        read_dqt(len);
      } else if (m == 0xDD) {
        restart_interval = u16();
        pos += len - 2;
      } else if (m == 0xDA) {
        read_sos(len);
      } else if (m == 0xE0 && len >= 5 && memcmp(data + pos, "JFIF\0", 5) == 0) {
        saw_jfif = true;
        pos += len;
      } else if (m == 0xEE && len >= 12 && memcmp(data + pos, "Adobe", 5) == 0) {
        saw_adobe = true;
        adobe_transform = data[pos + 11];
        pos += len;
      } else {
        pos += len;  // APPn, COM, DNL and others
      }
      if (pos >= n) break;
    }
    if (!have_frame) fail("JPEG without a baseline frame header");
  }

  // libjpeg's default colour space guess (jdapimin.c default_decompress_parms)
  bool is_rgb() const {
    if (ncomp != 3) return false;
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }

  // the component's samples, upsampled to the image size (libjpeg jdsample.c)
  std::vector<uint8_t> plane(const Component& c) const {
    const int pw = c.bw * 8;
    std::vector<uint8_t> raw((size_t)pw * c.bh * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, c.q,
                   raw.data() + (size_t)by * 8 * pw + bx * 8, pw);
    const int hx = hmax / c.h, vx = vmax / c.v;
    if (hx == 1 && vx == 1) {
      std::vector<uint8_t> out((size_t)width * height);
      for (int y = 0; y < height; ++y) memcpy(&out[(size_t)y * width], &raw[(size_t)y * pw], width);
      return out;
    }
    std::vector<uint8_t> out((size_t)width * height);
    auto at = [&](int y, int x) -> int { return raw[(size_t)y * pw + x]; };
    auto clampr = [&](int y) { return y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y); };
    auto clampc = [&](int x) { return x < 0 ? 0 : (x >= c.dw ? c.dw - 1 : x); };
    const bool fancy_h = c.dw > 2;
    if (hx == 2 && vx == 1 && fancy_h) {  // h2v1_fancy_upsample
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x) {
          int i = x >> 1, v3 = at(y, i) * 3;
          out[(size_t)y * width + x] = (x & 1) ? (uint8_t)((v3 + at(y, clampc(i + 1)) + 2) >> 2)
                                               : (uint8_t)((v3 + at(y, clampc(i - 1)) + 1) >> 2);
        }
    } else if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < height; ++y) {
        int k = y >> 1, nb = (y & 1) ? clampr(k + 1) : clampr(k - 1), bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; ++x)
          out[(size_t)y * width + x] = (uint8_t)((at(k, x) * 3 + at(nb, x) + bias) >> 2);
      }
    } else if (hx == 2 && vx == 2 && fancy_h) {  // h2v2_fancy_upsample
      std::vector<int> cs(c.dw);
      for (int y = 0; y < height; ++y) {
        int k = y >> 1, nb = (y & 1) ? clampr(k + 1) : clampr(k - 1);
        for (int i = 0; i < c.dw; ++i) cs[i] = at(k, i) * 3 + at(nb, i);
        for (int x = 0; x < width; ++x) {
          int i = x >> 1;
          out[(size_t)y * width + x] = (x & 1) ? (uint8_t)((cs[i] * 3 + cs[clampc(i + 1)] + 7) >> 4)
                                               : (uint8_t)((cs[i] * 3 + cs[clampc(i - 1)] + 8) >> 4);
        }
      }
    } else {  // replication (h2v1 / h2v2 at most 2 wide, int_upsample)
      for (int y = 0; y < height; ++y)
        for (int x = 0; x < width; ++x) out[(size_t)y * width + x] = raw[(size_t)(y / vx) * pw + x / hx];
    }
    return out;
  }

  void to_rgb(uint8_t* rgb) const {
    const size_t np = (size_t)width * height;
    if (ncomp == 1) {
      std::vector<uint8_t> g = plane(comps[0]);
      for (size_t i = 0; i < np; ++i) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
      return;
    }
    std::vector<uint8_t> p0 = plane(comps[0]), p1 = plane(comps[1]), p2 = plane(comps[2]);
    if (is_rgb()) {
      for (size_t i = 0; i < np; ++i) {
        rgb[3 * i] = p0[i];
        rgb[3 * i + 1] = p1[i];
        rgb[3 * i + 2] = p2[i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table: SCALEBITS 16, FIX(x) = x * 65536 + 0.5
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t half = (int64_t)1 << 15;
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((91881 * x + half) >> 16);
      cb_b[i] = (int)((116130 * x + half) >> 16);
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + half;
    }
    auto clamp = [](int v) -> uint8_t { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < np; ++i) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      rgb[3 * i] = clamp(y + cr_r[cr]);
      rgb[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
      rgb[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------
static const uint8_t kLumQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const uint8_t kChromQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

static const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];  // 0 = symbol absent
  void build(const uint8_t* bits, const uint8_t* vals) {
    memset(size, 0, sizeof size);
    int code_v = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i) {
        code[vals[k]] = (uint16_t)code_v++;
        size[vals[k++]] = (uint8_t)l;
      }
      code_v <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int cnt = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) {
      acc = (acc << 1) | ((v >> i) & 1);
      if (++cnt == 8) {
        out.push_back((uint8_t)acc);
        if (acc == 0xFF) out.push_back(0);
        acc = 0;
        cnt = 0;
      }
    }
  }
  void flush() {  // pad with one bits
    while (cnt) put(1, 1);
  }
};

static void put_marker_segment(std::vector<uint8_t>& o, int marker, const std::vector<uint8_t>& body) {
  o.push_back(0xFF);
  o.push_back((uint8_t)marker);
  int len = (int)body.size() + 2;
  o.push_back((uint8_t)(len >> 8));
  o.push_back((uint8_t)len);
  o.insert(o.end(), body.begin(), body.end());
}

static void encode(const uint8_t* rgb, int w, int h, int quality, int sub420,
                   std::vector<uint8_t>& o) {
  if (w < 1 || h < 1 || w > 65535 || h > 65535) fail("bad image size for JPEG");
  quality = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;  // jcparam.c
  uint16_t q[2][64];
  for (int i = 0; i < 64; ++i) {
    const uint8_t base[2] = {kLumQ[i], kChromQ[i]};
    for (int t = 0; t < 2; ++t) {
      long v = ((long)base[t] * scale + 50) / 100;
      q[t][i] = (uint16_t)(v < 1 ? 1 : (v > 255 ? 255 : v));
    }
  }
  const int ms = sub420 ? 16 : 8;
  const int mx = (w + ms - 1) / ms, my = (h + ms - 1) / ms;
  const int pw = mx * ms, ph = my * ms;
  // full-resolution Y, Cb, Cr over the padded frame (edges replicated)
  std::vector<float> Y((size_t)pw * ph), Cb((size_t)pw * ph), Cr((size_t)pw * ph);
  for (int y = 0; y < ph; ++y)
    for (int x = 0; x < pw; ++x) {
      const uint8_t* px = rgb + ((size_t)(y < h ? y : h - 1) * w + (x < w ? x : w - 1)) * 3;
      float r = px[0], g = px[1], b = px[2];
      size_t i = (size_t)y * pw + x;
      Y[i] = 0.299f * r + 0.587f * g + 0.114f * b - 128.0f;
      Cb[i] = -0.168736f * r - 0.331264f * g + 0.5f * b;
      Cr[i] = 0.5f * r - 0.418688f * g - 0.081312f * b;
    }
  int cw = pw, ch = ph;
  if (sub420) {
    cw = pw / 2;
    ch = ph / 2;
    for (int y = 0; y < ch; ++y)
      for (int x = 0; x < cw; ++x) {
        size_t a = (size_t)(2 * y) * pw + 2 * x, b = a + pw, d = (size_t)y * cw + x;
        Cb[d] = 0.25f * (Cb[a] + Cb[a + 1] + Cb[b] + Cb[b + 1]);
        Cr[d] = 0.25f * (Cr[a] + Cr[a + 1] + Cr[b] + Cr[b + 1]);
      }
  }
  float cosv[8][8];
  for (int u = 0; u < 8; ++u)
    for (int x = 0; x < 8; ++x)
      cosv[u][x] = (float)((u == 0 ? std::sqrt(0.125) : 0.5) * std::cos((2 * x + 1) * u * M_PI / 16));

  std::vector<uint8_t> b;
  o.insert(o.end(), {0xFF, 0xD8});
  put_marker_segment(o, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  b.clear();
  for (int t = 0; t < 2; ++t) {
    b.push_back((uint8_t)t);
    for (int k = 0; k < 64; ++k) b.push_back((uint8_t)q[t][kNatural[k]]);
  }
  put_marker_segment(o, 0xDB, b);
  b = {8, (uint8_t)(h >> 8), (uint8_t)h, (uint8_t)(w >> 8), (uint8_t)w, 3,
       1, (uint8_t)(sub420 ? 0x22 : 0x11), 0, 2, 0x11, 1, 3, 0x11, 1};
  put_marker_segment(o, 0xC0, b);
  const uint8_t* tb[4][2] = {{kDcLumBits, kDcVals}, {kAcLumBits, kAcLumVals},
                             {kDcChromBits, kDcVals}, {kAcChromBits, kAcChromVals}};
  const uint8_t tc[4] = {0x00, 0x10, 0x01, 0x11};
  b.clear();
  for (int t = 0; t < 4; ++t) {
    b.push_back(tc[t]);
    int total = 0;
    for (int l = 1; l <= 16; ++l) {
      b.push_back(tb[t][0][l]);
      total += tb[t][0][l];
    }
    b.insert(b.end(), tb[t][1], tb[t][1] + total);
  }
  put_marker_segment(o, 0xC4, b);
  put_marker_segment(o, 0xDA, {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});

  EncTable dct[2], act[2];
  dct[0].build(kDcLumBits, kDcVals);
  act[0].build(kAcLumBits, kAcLumVals);
  dct[1].build(kDcChromBits, kDcVals);
  act[1].build(kAcChromBits, kAcChromVals);
  BitWriter bw(o);
  int pred[3] = {0, 0, 0};
  auto emit = [&](int t, int sym) {
    if (!(t < 2 ? dct[t].size[sym] : act[t - 2].size[sym])) fail("Huffman symbol without a code");
    if (t < 2) bw.put(dct[t].code[sym], dct[t].size[sym]);
    else bw.put(act[t - 2].code[sym], act[t - 2].size[sym]);
  };
  auto block = [&](const std::vector<float>& plane, int stride, int x0, int y0, int tab, int* dcp) {
    float tmp[64], f[64];
    for (int y = 0; y < 8; ++y)
      for (int u = 0; u < 8; ++u) {
        float s = 0;
        for (int x = 0; x < 8; ++x) s += cosv[u][x] * plane[(size_t)(y0 + y) * stride + x0 + x];
        tmp[y * 8 + u] = s;
      }
    for (int v = 0; v < 8; ++v)
      for (int u = 0; u < 8; ++u) {
        float s = 0;
        for (int y = 0; y < 8; ++y) s += cosv[v][y] * tmp[y * 8 + u];
        f[v * 8 + u] = s;
      }
    int zz[64];
    for (int k = 0; k < 64; ++k) zz[k] = (int)std::lround(f[kNatural[k]] / q[tab][kNatural[k]]);
    int diff = zz[0] - *dcp;
    *dcp = zz[0];
    auto magnitude = [](int v, int* bits) {
      int a = v < 0 ? -v : v, s = 0;
      while (a) {
        ++s;
        a >>= 1;
      }
      *bits = v < 0 ? v + (1 << s) - 1 : v;
      return s;
    };
    int bits, s = magnitude(diff, &bits);
    emit(tab, s);
    if (s) bw.put((uint32_t)bits, s);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      if (zz[k] == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        emit(2 + tab, 0xF0);
        run -= 16;
      }
      s = magnitude(zz[k], &bits);
      if (s > 10) fail("JPEG coefficient out of range");
      emit(2 + tab, (run << 4) | s);
      bw.put((uint32_t)bits, s);
      run = 0;
    }
    if (run) emit(2 + tab, 0x00);
  };
  for (int m = 0; m < mx * my; ++m) {
    int bx = m % mx, by = m / mx;
    if (sub420) {
      for (int v = 0; v < 2; ++v)
        for (int u = 0; u < 2; ++u) block(Y, pw, bx * 16 + u * 8, by * 16 + v * 8, 0, &pred[0]);
      block(Cb, cw, bx * 8, by * 8, 1, &pred[1]);
      block(Cr, cw, bx * 8, by * 8, 1, &pred[2]);
    } else {
      block(Y, pw, bx * 8, by * 8, 0, &pred[0]);
      block(Cb, cw, bx * 8, by * 8, 1, &pred[1]);
      block(Cr, cw, bx * 8, by * 8, 1, &pred[2]);
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
}

}  // namespace rjpeg

extern "C" {

const char* jpeg_last_error() { return rjpeg::g_error.c_str(); }

// Frame header: out[0] = width, out[1] = height, out[2] = components.
int jpeg_probe(const unsigned char* data, long long n, long long* out) {
  try {
    rjpeg::Decoder d(data, (size_t)n);
    d.parse(true);
    out[0] = d.width;
    out[1] = d.height;
    out[2] = d.ncomp;
    return 0;
  } catch (const rjpeg::Error& e) {
    rjpeg::g_error = e.msg;
    return 1;
  }
}

// Decode into rgb (height * width * 3 bytes; greyscale is replicated).
int jpeg_decode(const unsigned char* data, long long n, unsigned char* rgb) {
  try {
    rjpeg::Decoder d(data, (size_t)n);
    d.parse(false);
    d.to_rgb(rgb);
    return 0;
  } catch (const rjpeg::Error& e) {
    rjpeg::g_error = e.msg;
    return 1;
  }
}

// Encode (h, w, 3) RGB as baseline JPEG (sub420: 0 = 4:4:4, 1 = 4:2:0)
// into out (cap bytes). Returns the byte count, or -1 (error or too small a
// buffer).
long long jpeg_encode(const unsigned char* rgb, int w, int h, int quality, int sub420,
                      unsigned char* out, long long cap) {
  try {
    std::vector<uint8_t> o;
    rjpeg::encode(rgb, w, h, quality, sub420, o);
    if ((long long)o.size() > cap) {
      rjpeg::g_error = "JPEG output larger than the buffer";
      return -1;
    }
    memcpy(out, o.data(), o.size());
    return (long long)o.size();
  } catch (const rjpeg::Error& e) {
    rjpeg::g_error = e.msg;
    return -1;
  }
}

}  // extern "C"
