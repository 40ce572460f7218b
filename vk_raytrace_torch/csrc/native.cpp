// Native host builders of the port (ctypes, built by runtime.py with g++).
//
// The port's own copy of the host loops it needs from the reference's native
// runtime, trimmed to what vk_raytrace_torch/runtime.py binds:
//   oct_encode_batch  octahedral unit-vector compression (compress.glsl)
//   smooth_normals    area-weighted vertex normals
//   pack_rgba8        RGBA8 vertex-colour packing
//   build_bvh8        binned-SAH build of 8-wide 256-byte rows (the wide
//                     back end's layout, ops/bvh8.py::WideScene)
//   build_bvh16       binned-SAH build of 16-wide planar 512-byte rows
//   build_bvh32       the same at width 32: 1024-byte rows
//   png_unfilter      PNG scanline reconstruction (filters 0-4), for the
//                     port's PNG decoder (utils/png.py)
//   jpeg_decode       Huffman JPEG (SOF0/SOF1/SOF2, 8 bit) to RGBA8,
//                     in libjpeg-turbo's integer arithmetic (utils/jpeg.py)
// The tables they produce must stay byte-identical to the reference's
// (tests/test_torch_scene.py).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Octahedral unit-vector compression (compress.glsl:111-139 semantics):
// 2x16-bit snorm, lower-hemisphere fold in integer space, round-half-even.
// ---------------------------------------------------------------------------
static inline int32_t round_even_i(float x) {
  return static_cast<int32_t>(std::nearbyintf(x));  // FE_TONEAREST = half-even
}

void oct_encode_batch(const float* vecs /* n*3 */, int64_t n, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float vx = vecs[i * 3 + 0];
    const float vy = vecs[i * 3 + 1];
    const float vz = vecs[i * 3 + 2];
    const float d = 32767.0f / (std::fabs(vx) + std::fabs(vy) + std::fabs(vz));
    int32_t x = round_even_i(vx * d);
    int32_t y = round_even_i(vy * d);
    if (vz < 0.0f) {
      const int32_t maskx = x >> 31;
      const int32_t masky = y >> 31;
      const int32_t tmp = 32767 + maskx + masky;
      const int32_t tmpx = x;
      x = (tmp - (y ^ masky)) ^ maskx;
      y = (tmp - (tmpx ^ maskx)) ^ masky;
    }
    uint32_t packed =
        (uint32_t(y + 32767) << 16) | uint32_t(x + 32767);
    if (packed == 0xFFFFFFFFu) packed = 0xFFFFFFFEu;
    out[i] = packed;
  }
}

// ---------------------------------------------------------------------------
// Area-weighted smooth vertex normals (nvh::GltfScene-style import helper).
// ---------------------------------------------------------------------------
void smooth_normals(const double* pos /* nv*3 */, int64_t nv,
                    const int64_t* idx /* nt*3 */, int64_t nt,
                    double* out /* nv*3 */) {
  std::memset(out, 0, sizeof(double) * size_t(nv) * 3);
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t a = idx[t * 3], b = idx[t * 3 + 1], c = idx[t * 3 + 2];
    const double* pa = pos + a * 3;
    const double* pb = pos + b * 3;
    const double* pc = pos + c * 3;
    const double e1x = pb[0] - pa[0], e1y = pb[1] - pa[1], e1z = pb[2] - pa[2];
    const double e2x = pc[0] - pa[0], e2y = pc[1] - pa[1], e2z = pc[2] - pa[2];
    const double nx = e1y * e2z - e1z * e2y;
    const double ny = e1z * e2x - e1x * e2z;
    const double nz = e1x * e2y - e1y * e2x;
    for (int64_t v : {a, b, c}) {
      out[v * 3 + 0] += nx;
      out[v * 3 + 1] += ny;
      out[v * 3 + 2] += nz;
    }
  }
  for (int64_t v = 0; v < nv; ++v) {
    double* o = out + v * 3;
    const double l = std::sqrt(o[0] * o[0] + o[1] * o[1] + o[2] * o[2]);
    if (l < 1e-20) {
      o[0] = 0.0; o[1] = 0.0; o[2] = 1.0;
    } else {
      o[0] /= l; o[1] /= l; o[2] /= l;
    }
  }
}

// ---------------------------------------------------------------------------
// RGBA8 vertex color packing (scene.cpp:219-242 style).
// ---------------------------------------------------------------------------
void pack_rgba8(const float* colors /* n*4 */, int64_t n, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t v = 0;
    for (int c = 0; c < 4; ++c) {
      float f = colors[i * 4 + c];
      f = f < 0.0f ? 0.0f : (f > 1.0f ? 1.0f : f);
      v |= uint32_t(std::lround(f * 255.0f)) << (8 * c);
    }
    out[i] = v;
  }
}

// ---------------------------------------------------------------------------
// PNG scanline reconstruction (PNG spec section 9): ``raw`` holds h rows of a
// filter-type byte and ``stride`` bytes; ``out`` receives h * stride bytes.
// ``bpp`` is the bytes per complete pixel. Returns 0, or 1 + the row of the
// first unknown filter type.
// ---------------------------------------------------------------------------
int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int64_t bpp,
                     uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* in = raw + y * (stride + 1);
    const uint8_t ft = in[0];
    ++in;
    uint8_t* cur = out + y * stride;
    const uint8_t* up = y > 0 ? cur - stride : nullptr;
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int pred;
      switch (ft) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return 1 + y;
      }
      cur[i] = uint8_t(in[i] + pred);
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG (ITU T.81) decoded to RGBA8 exactly as libjpeg-turbo decodes it with
// its defaults (JDCT_ISLOW, fancy upsampling) and Pillow converts it, 8-bit
// samples, 1, 3 or 4 components:
//   Huffman sequential / progressive     jdhuff.c decode_mcu; jdphuff.c
//     (SOF0, SOF1, SOF2)                 (every scan is read before the
//                                        output, so no block smoothing)
//   arithmetic sequential / progressive  jdarith.c: the QM decoder and its
//     (SOF9, SOF10)                      statistics model (T.81 Annexes D, F,
//                                        G), DAC conditioning; it fills the
//                                        same coefficients
//   lossless, Huffman (SOF3)             jdlhuff.c / jdpred.c: predictors
//                                        1-7, point transform, every
//                                        component sampled 1x1
//   the integer IDCT                     jidctint.c jpeg_idct_islow
//   the upsampling                       jdsample.c h2v1 / h1v2 / h2v2 fancy
//                                        (box below 3 columns), int_upsample
//   the colour conversion                jdcolor.c ycc_rgb_convert and
//                                        ycck_cmyk_convert tables; CMYK then
//                                        as Pillow reads it ("CMYK;I", every
//                                        channel inverted) and converts it
//                                        (cmyk2rgb: R = (255-K) - C(255-K)/255)
// Image edges follow libjpeg's context rows: the row above the first is the
// first, the rows below the last real one repeat it (jdmainct.c).
// ---------------------------------------------------------------------------
namespace jpeg {

enum Err : int64_t {
  kOk = 0, kTruncated = 1, kNoFrame = 2, kBadSof = 3, kBadTable = 4, kBadScan = 5,
  kSampling = 6, kSize = 7, kLosslessSampling = 8,
};

// T.81 Table D.2 as jaricom.c packs it: Qe << 16 | next index after an MPS
// << 8 | switch-MPS flag << 7 | next index after an LPS. Entry 113 is the
// fixed 0.5 bin of the sign and refinement decisions.
static const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171,
};

// jdarith.c arith_decode over the entropy-coded bytes from `pos`: a stuffed
// 0xFF 0x00 reads as 0xFF, a marker stops the input (zeros from there on;
// `mpos` is where it starts).
struct Arith {
  const uint8_t* d;
  int64_t n, pos;
  int64_t c = 0, a = 0;
  int ct = -16;
  bool marker = false, dead = false;
  int64_t mpos = 0;
  void restart(int64_t p) {
    pos = p;
    c = 0;
    a = 0;
    ct = -16;  // forces reading 2 initial bytes to fill C
    marker = dead = false;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (!marker && pos < n) {
          const int64_t p0 = pos;
          data = d[pos++];
          if (data == 0xFF) {
            do data = pos < n ? d[pos++] : 0xD9; while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              marker = true;
              mpos = p0;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // => a = 0x10000 after the loop
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = int(qe & 0xFF);
    qe >>= 8;
    const int nm = int(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// Zigzag index -> natural index; entries past 63 absorb a corrupt run
// (jutils.c jpeg_natural_order).
static const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool defined = false;
  int32_t mincode[17] = {}, maxcode[18] = {}, valptr[17] = {};
  uint8_t vals[256] = {};
};

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  bool latched = false;
  uint16_t quant[64] = {};  // natural order
  int64_t bw = 0, bh = 0;   // blocks allocated (whole MCUs)
  std::vector<int16_t> coef;
  std::vector<int32_t> samples;  // lossless frames: the undifferenced samples
  int dc = 0, ctx = 0;           // DC prediction; arithmetic DC context
};

struct Bits {
  const uint8_t* d;
  int64_t n, pos;
  uint64_t buf = 0;
  int cnt = 0;
  bool marker = false;  // stopped at a marker: zeros from here (jdhuff.c)
  void fill() {
    while (cnt <= 56) {
      int c = 0;
      if (!marker && pos < n) {
        c = d[pos];
        if (c == 0xFF) {
          const int next = pos + 1 < n ? d[pos + 1] : -1;
          if (next == 0x00) {
            pos += 2;
          } else {
            marker = true;
            c = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= uint64_t(c) << (56 - cnt);
      cnt += 8;
    }
  }
  int get(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    const int r = int(buf >> (64 - k));
    buf <<= k;
    cnt -= k;
    return r;
  }
  int bit() { return get(1); }
  void reset() { buf = 0; cnt = 0; }
};

static int decode_sym(Bits& b, const Huff& t) {
  int l = 1;
  int32_t code = b.bit();
  while (l <= 16 && code > t.maxcode[l]) {
    code = (code << 1) | b.bit();
    ++l;
  }
  if (l > 16) return 0;  // corrupt: libjpeg warns and returns 0
  return t.vals[(t.valptr[l] + code - t.mincode[l]) & 0xFF];
}

static inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x + (-1 << s) + 1 : x; }

// jidctint.c jpeg_idct_islow, with its range-limit table folded into
// ``limit`` (a wrap to [-512, 511], then a clamp of x + 128).
static inline uint8_t limit(int64_t x) {
  const int64_t s = ((x + 512) & 1023) - 512;
  return uint8_t(std::min<int64_t>(255, std::max<int64_t>(0, s + 128)));
}

static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int64_t stride) {
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  const int CB = 13, P1 = 2;
  auto descale = [](int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; };
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    auto dq = [&](int r) { return int64_t(in[r * 8 + c]) * int64_t(q[r * 8 + c]); };
    if (!in[8 + c] && !in[16 + c] && !in[24 + c] && !in[32 + c] && !in[40 + c] &&
        !in[48 + c] && !in[56 + c]) {
      const int dcval = int(dq(0) * (1 << P1));
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dcval;
      continue;
    }
    int64_t z2 = dq(2), z3 = dq(6);
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = dq(0);
    z3 = dq(4);
    int64_t tmp0 = (z2 + z3) * (1 << CB), tmp1 = (z2 - z3) * (1 << CB);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = dq(7);
    tmp1 = dq(5);
    tmp2 = dq(3);
    tmp3 = dq(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    ws[0 * 8 + c] = int(descale(t10 + tmp3, CB - P1));
    ws[7 * 8 + c] = int(descale(t10 - tmp3, CB - P1));
    ws[1 * 8 + c] = int(descale(t11 + tmp2, CB - P1));
    ws[6 * 8 + c] = int(descale(t11 - tmp2, CB - P1));
    ws[2 * 8 + c] = int(descale(t12 + tmp1, CB - P1));
    ws[5 * 8 + c] = int(descale(t12 - tmp1, CB - P1));
    ws[3 * 8 + c] = int(descale(t13 + tmp0, CB - P1));
    ws[4 * 8 + c] = int(descale(t13 - tmp0, CB - P1));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t dcval = limit(descale(w[0], P1 + 3));
      for (int c = 0; c < 8; ++c) o[c] = dcval;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << CB), tmp1 = (int64_t(w[0]) - w[4]) * (1 << CB);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int S = CB + P1 + 3;
    o[0] = limit(descale(t10 + tmp3, S));
    o[7] = limit(descale(t10 - tmp3, S));
    o[1] = limit(descale(t11 + tmp2, S));
    o[6] = limit(descale(t11 - tmp2, S));
    o[2] = limit(descale(t12 + tmp1, S));
    o[5] = limit(descale(t12 - tmp1, S));
    o[3] = limit(descale(t13 + tmp0, S));
    o[4] = limit(descale(t13 - tmp0, S));
  }
}

// One component's samples (dw x dh, row stride ``stride``) upsampled by
// (fx, fy) into ``out`` (W x H, the first W columns and H rows of the
// fx*dw x fy*dh result).
static int64_t upsample(const uint8_t* in, int64_t stride, int64_t dw, int64_t dh, int fx,
                        int fy, uint8_t* out, int64_t W, int64_t H) {
  auto px = [&](int64_t x, int64_t y) -> int {
    y = std::min(std::max<int64_t>(y, 0), dh - 1);
    x = std::min(std::max<int64_t>(x, 0), dw - 1);
    return in[y * stride + x];
  };
  const bool h2 = fx == 2 && dw > 2;
  for (int64_t y = 0; y < H; ++y) {
    const int64_t sy = y / fy;
    const bool up = (y % fy) == 0;  // the next-nearest row is above
    for (int64_t x = 0; x < W; ++x) {
      const int64_t sx = x / fx;
      const bool left = (x % fx) == 0;
      int v;
      if (fx == 1 && fy == 1) {
        v = px(sx, sy);
      } else if (fy == 2 && fx == 1) {  // h1v2_fancy_upsample (libjpeg-turbo)
        const int s = px(sx, sy) * 3 + px(sx, up ? sy - 1 : sy + 1);
        v = (s + (up ? 1 : 2)) >> 2;
      } else if (fy == 1 && h2) {  // h2v1_fancy_upsample
        const int c = px(sx, sy) * 3;
        v = left ? (c + px(sx - 1, sy) + 1) >> 2 : (c + px(sx + 1, sy) + 2) >> 2;
      } else if (fy == 2 && h2) {  // h2v2_fancy_upsample
        const int64_t ny = up ? sy - 1 : sy + 1;
        const int here = px(sx, sy) * 3 + px(sx, ny);
        const int other = px(left ? sx - 1 : sx + 1, sy) * 3 + px(left ? sx - 1 : sx + 1, ny);
        v = left ? (here * 3 + other + 8) >> 4 : (here * 3 + other + 7) >> 4;
      } else {  // box: h2v1 / h2v2 below 3 columns, int_upsample
        v = px(sx, sy);
      }
      out[y * W + x] = uint8_t(v);
    }
  }
  return kOk;
}

}  // namespace jpeg

extern "C" {

// Decode a JPEG of ``w`` x ``h`` pixels into ``out`` (h * w * 4 bytes, RGBA,
// alpha 255). ``ycc``: convert three components from YCbCr, four from YCCK
// (libjpeg's colour-space guess, made by the caller). Returns 0 or an error
// code (jpeg::Err); hierarchical and arithmetic lossless frames and 12-bit
// samples are refused by the caller before this.
int64_t jpeg_decode(const uint8_t* d, int64_t n, int64_t ycc, uint8_t* out, int64_t w,
                    int64_t h) {
  using namespace jpeg;
  uint16_t qt[4][64] = {};
  Huff dc[4], ac[4];
  uint8_t dac_l[4] = {0, 0, 0, 0}, dac_u[4] = {1, 1, 1, 1}, dac_k[4] = {5, 5, 5, 5};
  uint8_t dc_stats[4][64], ac_stats[4][256];
  std::vector<Comp> comps;
  int hmax = 1, vmax = 1;
  int64_t ri = 0, mcux = 0, mcuy = 0;
  bool frame = false, progressive = false, arith = false, lossless = false;
  int64_t pos = 2;
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kTruncated;
  for (;;) {
    while (pos < n && d[pos] != 0xFF) ++pos;  // garbage between segments
    while (pos < n && d[pos] == 0xFF) ++pos;  // fill bytes
    if (pos >= n) return frame ? kOk : kTruncated;
    const int m = d[pos++];
    if (m == 0xD9) break;
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // standalone markers
    if (pos + 2 > n) return kTruncated;
    const int64_t len = (int64_t(d[pos]) << 8) | d[pos + 1];
    if (len < 2 || pos + len > n) return kTruncated;
    const uint8_t* s = d + pos + 2;
    const int64_t sl = len - 2;
    pos += len;
    if (m == 0xDB) {  // DQT
      for (int64_t i = 0; i < sl;) {
        const int pq = s[i] >> 4, tq = s[i] & 15;
        ++i;
        if (tq > 3 || i + 64 * (pq + 1) > sl) return kBadTable;
        for (int k = 0; k < 64; ++k) {
          qt[tq][kNatural[k]] = pq ? uint16_t((s[i + 2 * k] << 8) | s[i + 2 * k + 1]) : s[i + k];
        }
        i += 64 * (pq + 1);
      }
    } else if (m == 0xC4) {  // DHT
      for (int64_t i = 0; i < sl;) {
        if (i + 17 > sl) return kBadTable;
        const int tc = s[i] >> 4, th = s[i] & 15;
        if (tc > 1 || th > 3) return kBadTable;
        Huff& t = tc ? ac[th] : dc[th];
        int total = 0;
        for (int l = 1; l <= 16; ++l) total += s[i + l];
        if (total > 256 || i + 17 + total > sl) return kBadTable;
        int32_t code = 0, k = 0;
        for (int l = 1; l <= 16; ++l) {
          const int cnt = s[i + l];
          t.valptr[l] = k;
          t.mincode[l] = code;
          code += cnt;
          k += cnt;
          t.maxcode[l] = cnt ? code - 1 : -1;
          code <<= 1;
        }
        t.maxcode[17] = 0x7FFFFFFF;
        std::memcpy(t.vals, s + i + 17, total);
        t.defined = true;
        i += 17 + total;
      }
    } else if (m == 0xCC) {  // DAC: arithmetic conditioning (jdmarker.c get_dac)
      for (int64_t i = 0; i + 1 < sl; i += 2) {
        const int idx = s[i], val = s[i + 1];
        if (idx >= 32) return kBadTable;
        if (idx >= 16) {
          if (val < 1 || val > 63) return kBadTable;
          dac_k[(idx - 16) & 3] = uint8_t(val);
        } else {
          dac_l[idx & 3] = uint8_t(val & 15);
          dac_u[idx & 3] = uint8_t(val >> 4);
          if (dac_l[idx & 3] > dac_u[idx & 3]) return kBadTable;
        }
      }
    } else if (m == 0xDD) {  // DRI
      if (sl < 2) return kBadTable;
      ri = (int64_t(s[0]) << 8) | s[1];
    } else if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 || m == 0xCA) {
      progressive = m == 0xC2 || m == 0xCA;
      arith = m == 0xC9 || m == 0xCA;
      lossless = m == 0xC3;
      if (sl < 6 || s[0] != 8) return kBadSof;
      const int64_t fh = (int64_t(s[1]) << 8) | s[2], fw = (int64_t(s[3]) << 8) | s[4];
      const int nc = s[5];
      if (fh != h || fw != w || (nc != 1 && nc != 3 && nc != 4) || sl < 6 + 3 * nc)
        return kBadSof;
      comps.assign(nc, Comp());
      for (int c = 0; c < nc; ++c) {
        comps[c].id = s[6 + 3 * c];
        comps[c].h = s[7 + 3 * c] >> 4;
        comps[c].v = s[7 + 3 * c] & 15;
        comps[c].tq = s[8 + 3 * c];
        if (comps[c].h < 1 || comps[c].h > 4 || comps[c].v < 1 || comps[c].v > 4 ||
            comps[c].tq > 3)
          return kBadSof;
        hmax = std::max(hmax, comps[c].h);
        vmax = std::max(vmax, comps[c].v);
      }
      if (lossless) {  // a sample per block
        if (hmax != 1 || vmax != 1) return kLosslessSampling;
        for (Comp& c : comps) c.samples.assign(size_t(w * h), 0);
      } else {
        mcux = (w + 8 * hmax - 1) / (8 * hmax);
        mcuy = (h + 8 * vmax - 1) / (8 * vmax);
        for (Comp& c : comps) {
          if (hmax % c.h || vmax % c.v) return kSampling;
          c.bw = mcux * c.h;
          c.bh = mcuy * c.v;
          c.coef.assign(size_t(c.bw * c.bh * 64), 0);
        }
      }
      frame = true;
    } else if (m == 0xDA) {  // SOS: one scan's entropy-coded data follows
      if (!frame || sl < 1) return kBadScan;
      const int ns = s[0];
      if (ns < 1 || ns > 4 || sl < 4 + 2 * ns) return kBadScan;
      std::vector<Comp*> sc;
      for (int j = 0; j < ns; ++j) {
        Comp* c = nullptr;
        for (Comp& k : comps)
          if (k.id == s[1 + 2 * j]) c = &k;
        if (!c) return kBadScan;
        c->td = s[2 + 2 * j] >> 4;
        c->ta = s[2 + 2 * j] & 15;
        if (c->td > 3 || c->ta > 3) return kBadTable;
        if (!c->latched) {  // jdinput.c latch_quant_tables
          std::memcpy(c->quant, qt[c->tq], sizeof(c->quant));
          c->latched = true;
        }
        c->dc = 0;
        c->ctx = 0;
        sc.push_back(c);
      }
      // The spectral band and successive approximation (sequential: 0-63,
      // no refinement; lossless: the predictor and the point transform);
      // what the scan codes and the tables it needs.
      const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ah = s[3 + 2 * ns] >> 4,
                al = s[3 + 2 * ns] & 15;
      enum Kind { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine, kLossless };
      Kind kind = lossless ? kLossless : kSeq;
      if (lossless && (ss < 1 || ss > 7 || al > 7)) return kBadScan;
      if (progressive) {
        if (ss == 0 && se != 0) return kBadScan;
        if (ss > 0 && (se < ss || se > 63 || ns != 1)) return kBadScan;
        kind = ss == 0 ? (ah ? kDcRefine : kDcFirst) : (ah ? kAcRefine : kAcFirst);
      }
      for (Comp* c : sc) {
        if (arith) break;
        const bool need_dc = kind == kSeq || kind == kDcFirst || kind == kLossless;
        const bool need_ac = kind == kSeq || kind == kAcFirst || kind == kAcRefine;
        if ((need_dc && !dc[c->td].defined) || (need_ac && !ac[c->ta].defined)) return kBadTable;
      }
      int64_t eobrun = 0;
      // One block of the scan (jdhuff.c decode_mcu, jdphuff.c decode_mcu_DC_first,
      // _DC_refine, _AC_first, _AC_refine).
      auto block = [&](Bits& b, Comp* c, int16_t* blk) {
        if (kind == kSeq || kind == kDcFirst) {
          int t = decode_sym(b, dc[c->td]);
          if (t) t = extend(b.get(t), t);
          c->dc += t;
          blk[0] = int16_t(kind == kSeq ? c->dc : c->dc * (1 << al));
          if (kind == kDcFirst) return;
          for (int k = 1; k < 64; ++k) {
            int rs = decode_sym(b, ac[c->ta]);
            const int r = rs >> 4;
            rs &= 15;
            if (rs) {
              k += r;
              blk[kNatural[std::min(k, 79)]] = int16_t(extend(b.get(rs), rs));
            } else {
              if (r != 15) break;
              k += 15;
            }
          }
        } else if (kind == kDcRefine) {
          if (b.get(1)) blk[0] = int16_t(blk[0] | (1 << al));
        } else if (kind == kAcFirst) {
          if (eobrun > 0) {
            --eobrun;
            return;
          }
          for (int k = ss; k <= se; ++k) {
            int rs = decode_sym(b, ac[c->ta]);
            const int r = rs >> 4;
            rs &= 15;
            if (rs) {
              k += r;
              blk[kNatural[std::min(k, 79)]] = int16_t(extend(b.get(rs), rs) * (1 << al));
            } else if (r == 15) {
              k += 15;
            } else {
              eobrun = int64_t(1) << r;
              if (r) eobrun += b.get(r);
              --eobrun;
              break;
            }
          }
        } else {  // kAcRefine
          const int p1 = 1 << al, m1 = -1 * (1 << al);
          auto correct = [&](int16_t& v) {
            if (b.get(1) && (v & p1) == 0) v = int16_t(v >= 0 ? v + p1 : v + m1);
          };
          int k = ss;
          if (eobrun == 0) {
            for (; k <= se; ++k) {
              int rs = decode_sym(b, ac[c->ta]);
              int r = rs >> 4;
              rs &= 15;
              int v = 0;
              if (rs) {
                v = b.get(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = int64_t(1) << r;
                if (r) eobrun += b.get(r);
                break;
              }
              // Past the nonzero coefficients (a correction bit each) and r
              // zero ones, to the position of the new coefficient.
              do {
                int16_t& cur = blk[kNatural[k]];
                if (cur != 0) {
                  correct(cur);
                } else if (--r < 0) {
                  break;
                }
                ++k;
              } while (k <= se);
              if (v) blk[kNatural[std::min(k, 79)]] = int16_t(v);
            }
          }
          if (eobrun > 0) {
            for (; k <= se; ++k) {
              int16_t& cur = blk[kNatural[k]];
              if (cur != 0) correct(cur);
            }
            --eobrun;
          }
        }
      };
      // The same blocks, arithmetic-coded (jdarith.c decode_mcu,
      // decode_mcu_DC_first, _DC_refine, _AC_first, _AC_refine). A decision
      // past the spectral end or a magnitude past 15 bits marks the rest of
      // the restart interval dead, as libjpeg does (ct = -1).
      uint8_t fixed_bin = 113;
      auto ablock = [&](Arith& ar, Comp* c, int16_t* blk) {
        if (ar.dead) return;
        if (kind == kSeq || kind == kDcFirst) {
          uint8_t* S = dc_stats[c->td];
          int st = c->ctx;
          if (ar.decode(S + st) == 0) {
            c->ctx = 0;
          } else {
            const int sign = ar.decode(S + st + 1);
            st += 2 + sign;
            int mm = ar.decode(S + st);
            if (mm != 0) {
              st = 20;
              while (ar.decode(S + st)) {
                if ((mm <<= 1) == 0x8000) {
                  ar.dead = true;
                  return;
                }
                st += 1;
              }
            }
            if (mm < ((1 << dac_l[c->td]) >> 1))
              c->ctx = 0;
            else if (mm > ((1 << dac_u[c->td]) >> 1))
              c->ctx = 12 + sign * 4;
            else
              c->ctx = 4 + sign * 4;
            int v = mm;
            st += 14;
            while (mm >>= 1)
              if (ar.decode(S + st)) v |= mm;
            v += 1;
            if (sign) v = -v;
            c->dc = (c->dc + v) & 0xFFFF;
          }
          blk[0] = int16_t(uint16_t(kind == kSeq ? c->dc : c->dc << al));
          if (kind == kDcFirst) return;
        }
        if (kind == kDcRefine) {
          if (ar.decode(&fixed_bin)) blk[0] = int16_t(blk[0] | (1 << al));
          return;
        }
        uint8_t* S = ac_stats[c->ta];
        const int k0 = kind == kSeq ? 1 : ss, k1 = kind == kSeq ? 63 : se;
        if (kind == kAcRefine) {
          const int p1 = 1 << al, m1 = -1 * (1 << al);
          int kex = k1;
          for (; kex > 0; --kex)
            if (blk[kNatural[kex]]) break;
          for (int k = k0; k <= k1; ++k) {
            int st = 3 * (k - 1);
            if (k > kex && ar.decode(S + st)) break;  // end of band
            for (;;) {
              int16_t& coef = blk[kNatural[k]];
              if (coef) {  // previously nonzero: a correction bit
                if (ar.decode(S + st + 2)) coef = int16_t(coef < 0 ? coef + m1 : coef + p1);
                break;
              }
              if (ar.decode(S + st + 1)) {  // newly nonzero
                coef = int16_t(ar.decode(&fixed_bin) ? m1 : p1);
                break;
              }
              st += 3;
              if (++k > k1) {
                ar.dead = true;
                return;
              }
            }
          }
          return;
        }
        for (int k = k0; k <= k1; ++k) {
          int st = 3 * (k - 1);
          if (ar.decode(S + st)) break;  // end of block
          while (ar.decode(S + st + 1) == 0) {
            st += 3;
            if (++k > k1) {
              ar.dead = true;
              return;
            }
          }
          const int sign = ar.decode(&fixed_bin);
          st += 2;
          int mm = ar.decode(S + st);
          if (mm != 0 && ar.decode(S + st)) {
            mm <<= 1;
            st = k <= dac_k[c->ta] ? 189 : 217;
            while (ar.decode(S + st)) {
              if ((mm <<= 1) == 0x8000) {
                ar.dead = true;
                return;
              }
              st += 1;
            }
          }
          int v = mm;
          st += 14;
          while (mm >>= 1)
            if (ar.decode(S + st)) v |= mm;
          v += 1;
          if (sign) v = -v;
          blk[kNatural[k]] = int16_t(kind == kSeq ? v : int(unsigned(v) << al));
        }
      };
      // The statistics a scan starts (and each restart interval restarts)
      // from: the DC bins of DC scans, the AC bins of AC scans.
      auto reset_stats = [&]() {
        for (Comp* c : sc) {
          if (kind == kSeq || kind == kDcFirst) std::memset(dc_stats[c->td], 0, 64);
          if (kind == kSeq || kind == kAcFirst || kind == kAcRefine)
            std::memset(ac_stats[c->ta], 0, 256);
          c->dc = 0;
          c->ctx = 0;
        }
      };
      // A one-component scan codes that component's own blocks, row by row
      // (not whole MCUs); an interleaved scan codes whole MCUs. A lossless
      // scan's block is one sample.
      int64_t nx = mcux, ny = mcuy;
      if (lossless) {
        nx = w;
        ny = h;
      } else if (ns == 1) {
        const Comp& c = *sc[0];
        nx = ((w * c.h + hmax - 1) / hmax + 7) / 8;
        ny = ((h * c.v + vmax - 1) / vmax + 7) / 8;
      }
      Bits b{d, n, pos};
      Arith ar{d, n, pos};
      if (arith) reset_stats();
      int64_t todo = ri;
      // Lossless prediction state: the first sample of an interval takes
      // 2^(7 - Pt), the rest of its first line the left neighbour.
      bool first_sample = true;
      int64_t first_line = 0;
      for (int64_t my = 0; my < ny; ++my) {
        for (int64_t mx = 0; mx < nx; ++mx) {
          if (ri && todo == 0) {  // jdhuff.c / jdarith.c process_restart
            int64_t p = arith ? (ar.marker ? ar.mpos : ar.pos) : b.pos;
            while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] >= 0xD0 && d[p + 1] <= 0xD7)) ++p;
            p += 2;
            if (arith) {
              ar.restart(p);
              reset_stats();
            } else {
              b.reset();
              b.marker = false;
              b.pos = p;
            }
            for (Comp* c : sc) c->dc = 0;
            eobrun = 0;
            todo = ri;
            first_sample = true;
            first_line = my;
          }
          for (Comp* c : sc) {
            if (kind == kLossless) {  // jdlhuff.c decode_mcus, jdpred.c
              const int t = decode_sym(b, dc[c->td]);
              const int diff = t == 16 ? 32768 : (t ? extend(b.get(t), t) : 0);
              int32_t* px = c->samples.data();
              const int64_t i = my * w + mx;
              int pred;
              if (first_sample) {
                pred = 1 << (7 - al);
              } else if (my == first_line) {
                pred = px[i - 1];
              } else if (mx == 0) {
                pred = px[i - w];
              } else {
                const int ra = px[i - 1], rb = px[i - w], rc = px[i - w - 1];
                switch (ss) {
                  case 1: pred = ra; break;
                  case 2: pred = rb; break;
                  case 3: pred = rc; break;
                  case 4: pred = ra + rb - rc; break;
                  case 5: pred = ra + ((rb - rc) >> 1); break;
                  case 6: pred = rb + ((ra - rc) >> 1); break;
                  default: pred = (ra + rb) >> 1; break;
                }
              }
              px[i] = (pred + diff) & 0xFFFF;
              continue;
            }
            const int bh = ns == 1 ? 1 : c->v, bwn = ns == 1 ? 1 : c->h;
            for (int by = 0; by < bh; ++by) {
              for (int bx = 0; bx < bwn; ++bx) {
                const int64_t gx = ns == 1 ? mx : mx * c->h + bx;
                const int64_t gy = ns == 1 ? my : my * c->v + by;
                int16_t* blk = c->coef.data() + (gy * c->bw + gx) * 64;
                if (arith) ablock(ar, c, blk);
                else block(b, c, blk);
              }
            }
          }
          first_sample = false;
          if (ri) --todo;
        }
      }
      // Resume the segment walk at the marker that ends the scan.
      pos = arith ? (ar.marker ? ar.mpos : ar.pos) : b.pos;
      while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0x00 &&
                              !(d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)))
        ++pos;
      if (lossless)
        for (Comp* c : sc)
          for (int32_t& v : c->samples) v = uint8_t(v << al);  // the point transform
    } else if ((m >= 0xC5 && m <= 0xCF && m != 0xC8 && m != 0xCC)) {
      return kBadSof;  // another frame type: the caller names it first
    }
    // APPn, COM, DNL and the rest: skipped.
  }
  if (!frame) return kNoFrame;
  // IDCT, upsampling and colour conversion.
  const int nc = int(comps.size());
  std::vector<std::vector<uint8_t>> planes(nc);
  for (int ci = 0; ci < nc; ++ci) {
    Comp& c = comps[ci];
    if (lossless) {
      planes[ci].assign(c.samples.begin(), c.samples.end());
      continue;
    }
    const int64_t stride = c.bw * 8;
    std::vector<uint8_t> plane(size_t(stride * c.bh * 8));
    for (int64_t by = 0; by < c.bh; ++by)
      for (int64_t bx = 0; bx < c.bw; ++bx)
        idct_islow(c.coef.data() + (by * c.bw + bx) * 64, c.quant,
                   plane.data() + by * 8 * stride + bx * 8, stride);
    const int64_t dw = (w * c.h + hmax - 1) / hmax, dh = (h * c.v + vmax - 1) / vmax;
    planes[ci].resize(size_t(w * h));
    upsample(plane.data(), stride, dw, dh, hmax / c.h, vmax / c.v, planes[ci].data(), w, h);
  }
  const int64_t SB = 16, HALF = int64_t(1) << (SB - 1);
  auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {  // jdcolor.c build_ycc_rgb_table
    const int64_t x = i - 128;
    cr_r[i] = int((fix(1.40200) * x + HALF) >> SB);
    cb_b[i] = int((fix(1.77200) * x + HALF) >> SB);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + HALF;
  }
  auto clamp = [](int v) { return uint8_t(std::min(255, std::max(0, v))); };
  for (int64_t i = 0; i < w * h; ++i) {
    uint8_t* o = out + 4 * i;
    if (nc == 1) {
      o[0] = o[1] = o[2] = planes[0][i];
    } else if (nc == 4) {
      int cmyk[4] = {planes[0][i], planes[1][i], planes[2][i], planes[3][i]};
      if (ycc) {  // jdcolor.c ycck_cmyk_convert
        const int y = cmyk[0], cb = cmyk[1], cr = cmyk[2];
        cmyk[0] = clamp(255 - (y + cr_r[cr]));
        cmyk[1] = clamp(255 - (y + int((cb_g[cb] + cr_g[cr]) >> SB)));
        cmyk[2] = clamp(255 - (y + cb_b[cb]));
      }
      // Pillow: "CMYK;I" inverts every channel, then cmyk2rgb.
      const int nk = cmyk[3];  // 255 - (255 - K)
      for (int k = 0; k < 3; ++k) {
        const int tmp = (255 - cmyk[k]) * nk + 128;
        o[k] = clamp(nk - (((tmp >> 8) + tmp) >> 8));
      }
    } else if (!ycc) {
      o[0] = planes[0][i];
      o[1] = planes[1][i];
      o[2] = planes[2][i];
    } else {
      const int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
      o[0] = clamp(y + cr_r[cr]);
      o[1] = clamp(y + int((cb_g[cb] + cr_g[cr]) >> SB));
      o[2] = clamp(y + cb_b[cb]);
    }
    o[3] = 255;
  }
  return kOk;
}

}  // extern "C"

// Shared binned-SAH pieces (bounding boxes, build context, splitter).

namespace wbvh {

constexpr float kInvalid = 3.0e38f;
constexpr int kBins = 16;

struct BBox {
  float mn[3], mx[3];
  void reset() {
    mn[0] = mn[1] = mn[2] = kInvalid;
    mx[0] = mx[1] = mx[2] = -kInvalid;
  }
  void grow(const BBox& b) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], b.mn[k]);
      mx[k] = std::max(mx[k], b.mx[k]);
    }
  }
  void grow(const float* p) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], p[k]);
      mx[k] = std::max(mx[k], p[k]);
    }
  }
  float area() const {
    const float dx = std::max(0.0f, mx[0] - mn[0]);
    const float dy = std::max(0.0f, mx[1] - mn[1]);
    const float dz = std::max(0.0f, mx[2] - mn[2]);
    return 2.0f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Ctx {
  const float* pos;        // (V, 3)
  const int32_t* idx;      // (T, 3)
  const float* uv;         // (V, 2)
  const int32_t* tri_ids;  // (T,) or nullptr
  const int32_t* flags;    // (T,)
  int64_t n_tris;
  std::vector<BBox> tbox;
  std::vector<float> cent;  // (T, 3)
  std::vector<int32_t> prim;
  const int32_t* frag = nullptr;  // fragment -> triangle map (presplitting);
                                  // null when prim entries ARE triangle ids
  float* rows;
  int64_t max_rows;
  int64_t n_rows = 0;
  bool overflow = false;
};

// Binned-SAH split of prim[lo, hi) -> mid, evaluated on all three axes.
// Falls back to a median split on degenerate centroid distributions. Both
// sides non-empty.
inline int64_t split_range(Ctx& c, int64_t lo, int64_t hi) {
  BBox cb;
  cb.reset();
  for (int64_t i = lo; i < hi; ++i) cb.grow(&c.cent[size_t(c.prim[size_t(i)]) * 3]);
  const int64_t median = lo + (hi - lo) / 2;

  float best = kInvalid;
  int best_axis = -1;
  int best_split = -1;
  for (int axis = 0; axis < 3; ++axis) {
    const float ext = cb.mx[axis] - cb.mn[axis];
    if (ext <= 1e-20f) continue;
    BBox bb[kBins];
    int64_t bc[kBins] = {0};
    for (int b = 0; b < kBins; ++b) bb[b].reset();
    const float scale = kBins / ext;
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t p = c.prim[size_t(i)];
      int b = int((c.cent[size_t(p) * 3 + axis] - cb.mn[axis]) * scale);
      b = std::min(std::max(b, 0), kBins - 1);
      bb[b].grow(c.tbox[size_t(p)]);
      ++bc[b];
    }
    // Suffix sweep then prefix sweep for SAH cost at each of kBins-1 splits.
    float rarea[kBins];
    int64_t rcount[kBins];
    BBox acc;
    acc.reset();
    int64_t cnt = 0;
    for (int b = kBins - 1; b > 0; --b) {
      acc.grow(bb[b]);
      cnt += bc[b];
      rarea[b] = acc.area();
      rcount[b] = cnt;
    }
    acc.reset();
    cnt = 0;
    for (int b = 0; b < kBins - 1; ++b) {
      acc.grow(bb[b]);
      cnt += bc[b];
      if (cnt == 0 || rcount[b + 1] == 0) continue;
      const float cost =
          acc.area() * float(cnt) + rarea[b + 1] * float(rcount[b + 1]);
      if (cost < best) { best = cost; best_axis = axis; best_split = b; }
    }
  }
  if (best_axis < 0) {  // degenerate: all centroids coincide on every axis
    std::nth_element(c.prim.begin() + lo, c.prim.begin() + median,
                     c.prim.begin() + hi);
    return median;
  }
  const int axis = best_axis;
  const float scale = kBins / (cb.mx[axis] - cb.mn[axis]);
  auto bin_of = [&](int32_t p) {
    int b = int((c.cent[size_t(p) * 3 + axis] - cb.mn[axis]) * scale);
    return std::min(std::max(b, 0), kBins - 1);
  };
  auto it = std::partition(c.prim.begin() + lo, c.prim.begin() + hi,
                           [&](int32_t p) { return bin_of(p) <= best_split; });
  int64_t mid = it - c.prim.begin();
  if (mid == lo || mid == hi) {  // numeric edge: force median
    auto key = [&](int32_t a, int32_t b2) {
      return c.cent[size_t(a) * 3 + axis] < c.cent[size_t(b2) * 3 + axis];
    };
    std::nth_element(c.prim.begin() + lo, c.prim.begin() + median,
                     c.prim.begin() + hi, key);
    mid = median;
  }
  return mid;
}

}  // namespace wbvh

// ---------------------------------------------------------------------------
// 8-wide builder: top-down binned SAH emitting the wide back end's 256-byte
// rows (ops/bvh8.py::WideScene, read by csrc/traverse_wide.cu).
//
// Row layout:
//   interior: lanes [6c..6c+5] = child c AABB (min.xyz, max.xyz),
//             lanes [48+c]     = child ref (>=0 interior row id;
//                                <0 => -(leaf_row*4 + count-1 + 1));
//             empty slots: inverted AABB (+3e38/-3e38), ref 0.
//   leaf:     4 x 16-lane packed triangles: p0 p1 p2 (9), uv0 uv1 uv2 (6),
//             lane 15 = original_tri_id*4 + (flags & 3).
// Shares the binned-SAH splitter with the planar builders below.
// ---------------------------------------------------------------------------

namespace w8 {

using wbvh::BBox;
using wbvh::Ctx;
using wbvh::kInvalid;
constexpr int kLeafMax = 4;

inline int64_t alloc_row(Ctx& c) {
  if (c.n_rows >= c.max_rows) {
    c.overflow = true;
    return 0;
  }
  std::memset(c.rows + c.n_rows * 64, 0, 64 * sizeof(float));
  return c.n_rows++;
}

inline float make_leaf(Ctx& c, int64_t lo, int64_t hi) {
  const int64_t row = alloc_row(c);
  float* r = c.rows + row * 64;
  const int cnt = int(hi - lo);
  for (int j = 0; j < cnt; ++j) {
    const int32_t p = c.prim[size_t(lo + j)];
    float* e = r + j * 16;
    for (int v = 0; v < 3; ++v) {
      const int32_t vi = c.idx[p * 3 + v];
      e[v * 3 + 0] = c.pos[vi * 3 + 0];
      e[v * 3 + 1] = c.pos[vi * 3 + 1];
      e[v * 3 + 2] = c.pos[vi * 3 + 2];
      e[9 + v * 2 + 0] = c.uv[vi * 2 + 0];
      e[9 + v * 2 + 1] = c.uv[vi * 2 + 1];
    }
    const int64_t orig = c.tri_ids ? c.tri_ids[p] : p;
    e[15] = float(orig * 4 + (c.flags[p] & 3));
  }
  const int64_t leaf_code = row * 4 + (cnt - 1);
  return float(-(leaf_code + 1));
}

float build_node(Ctx& c, int64_t lo, int64_t hi, BBox& out, bool force_interior);

// Split [lo, hi) into up to 8 parts (the part of largest bounds area x count
// first) and emit one interior row over them.
inline float make_interior(Ctx& c, int64_t lo, int64_t hi) {
  int64_t parts[9];  // part i = [parts[i], parts[i+1])
  int n_parts = 1;
  parts[0] = lo;
  parts[1] = hi;
  float metric[8];
  auto part_metric = [&](int64_t a, int64_t b) {
    if (b - a <= kLeafMax) return -1.0f;
    BBox bx;
    bx.reset();
    for (int64_t i = a; i < b; ++i) bx.grow(c.tbox[size_t(c.prim[size_t(i)])]);
    return bx.area() * float(b - a);
  };
  metric[0] = part_metric(lo, hi);
  while (n_parts < 8) {
    int pick = -1;
    float best = 0.0f;
    for (int i = 0; i < n_parts; ++i) {
      if (metric[i] > best) { best = metric[i]; pick = i; }
    }
    if (pick < 0) break;
    const int64_t mid = wbvh::split_range(c, parts[pick], parts[pick + 1]);
    for (int i = n_parts; i > pick; --i) {
      parts[i + 1] = parts[i];
      metric[i] = metric[i - 1];
    }
    parts[pick + 1] = mid;
    metric[pick] = part_metric(parts[pick], mid);
    metric[pick + 1] = part_metric(mid, parts[pick + 2]);
    ++n_parts;
  }

  const int64_t row = alloc_row(c);
  for (int i = 0; i < n_parts && !c.overflow; ++i) {
    BBox box;
    const float ref = build_node(c, parts[i], parts[i + 1], box, false);
    float* r = c.rows + row * 64;
    r[i * 6 + 0] = box.mn[0];
    r[i * 6 + 1] = box.mn[1];
    r[i * 6 + 2] = box.mn[2];
    r[i * 6 + 3] = box.mx[0];
    r[i * 6 + 4] = box.mx[1];
    r[i * 6 + 5] = box.mx[2];
    r[48 + i] = ref;
  }
  float* r = c.rows + row * 64;
  for (int i = n_parts; i < 8; ++i) {
    r[i * 6 + 0] = r[i * 6 + 1] = r[i * 6 + 2] = kInvalid;
    r[i * 6 + 3] = r[i * 6 + 4] = r[i * 6 + 5] = -kInvalid;
    r[48 + i] = 0.0f;
  }
  return float(row);
}

float build_node(Ctx& c, int64_t lo, int64_t hi, BBox& out, bool force_interior) {
  out.reset();
  for (int64_t i = lo; i < hi; ++i) out.grow(c.tbox[size_t(c.prim[size_t(i)])]);
  if (c.overflow) return 0.0f;
  if (!force_interior && hi - lo <= kLeafMax) return make_leaf(c, lo, hi);
  return make_interior(c, lo, hi);
}

}  // namespace w8

extern "C" {

// Returns the number of rows written, or -1 if max_rows was insufficient.
// Row 0 is always the interior root.
int64_t build_bvh8(const float* positions, const int32_t* indices, const float* uv,
                   const int32_t* tri_ids, const int32_t* tri_flags, int64_t n_tris,
                   float* rows_out, int64_t max_rows) {
  if (n_tris < 1 || max_rows < 2) return -1;
  wbvh::Ctx c;
  c.pos = positions;
  c.idx = indices;
  c.uv = uv;
  c.tri_ids = tri_ids;
  c.flags = tri_flags;
  c.n_tris = n_tris;
  c.rows = rows_out;
  c.max_rows = max_rows;
  c.tbox.resize(size_t(n_tris));
  c.cent.resize(size_t(n_tris) * 3);
  c.prim.resize(size_t(n_tris));
  for (int64_t t = 0; t < n_tris; ++t) {
    wbvh::BBox& b = c.tbox[size_t(t)];
    b.reset();
    for (int v = 0; v < 3; ++v) b.grow(positions + size_t(indices[t * 3 + v]) * 3);
    for (int k = 0; k < 3; ++k) c.cent[size_t(t) * 3 + k] = 0.5f * (b.mn[k] + b.mx[k]);
    c.prim[size_t(t)] = int32_t(t);
  }
  wbvh::BBox root_box;
  const float root = w8::build_node(c, 0, n_tris, root_box, /*force_interior=*/true);
  if (c.overflow || root != 0.0f) return -1;
  return c.n_rows;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// W-wide planar BVH builder (W = 16 or 32): rows of W*8 f32 lanes in the
// layout csrc/traverse.cu reads (ops/traverse_fused.py). At W = 32 every
// 16 and 8 below doubles: leaves hold 16 triangles, refs -(row*16+cnt-1+1).
//
// Row layout at W = 16 (128 f32 lanes):
//   interior: [c]=bmin.x(c) [16+c]=bmin.y [32+c]=bmin.z
//             [48+c]=bmax.x [64+c]=bmax.y [80+c]=bmax.z
//             [96+c]=child ref (>=0 interior row; <0 => -(leaf_row*8+cnt-1+1))
//             [112..127]=0; empty slots carry inverted AABBs.
//   leaf:     [a*8 + t] = attribute a of triangle t (t<8): p0 p1 p2 (attrs
//             0..8), uv0 uv1 uv2 (9..14), attr 15 = orig_id*4 + flags.
// Also computes the exact per-tree stack bound
// need(node) = (nkids-1) + max(child needs).
// ---------------------------------------------------------------------------


namespace wplanar {

using wbvh::BBox;
using wbvh::Ctx;
using wbvh::kInvalid;

// Width-templated: kWidth children per interior row, kWidth/2 triangles per
// leaf row.
template <int kWidth>
inline int64_t alloc_row(Ctx& c) {
  constexpr int kLanes = kWidth * 8;
  if (c.n_rows >= c.max_rows) {
    c.overflow = true;
    return 0;
  }
  std::memset(c.rows + c.n_rows * kLanes, 0, kLanes * sizeof(float));
  return c.n_rows++;
}

// Unique triangles of prim[lo, hi): with presplitting several fragments of
// one triangle can land in the same leaf range; the leaf stores the tri once.
template <int kWidth>
inline int unique_tris(const Ctx& c, int64_t lo, int64_t hi, int32_t* out,
                       int cap) {
  int n = 0;
  for (int64_t i = lo; i < hi; ++i) {
    const int32_t p = c.prim[size_t(i)];
    const int32_t tri = c.frag ? c.frag[p] : p;
    bool seen = false;
    for (int j = 0; j < n; ++j)
      if (out[j] == tri) { seen = true; break; }
    if (seen) continue;
    if (n >= cap) return cap + 1;  // too many: caller must split further
    out[n++] = tri;
  }
  return n;
}

template <int kWidth>
inline float make_leaf(Ctx& c, int64_t lo, int64_t hi) {
  constexpr int kLanes = kWidth * 8;
  constexpr int kLeafMax = kWidth / 2;
  const int64_t row = alloc_row<kWidth>(c);
  float* r = c.rows + row * kLanes;
  int32_t tris[kLeafMax];
  const int cnt = unique_tris<kWidth>(c, lo, hi, tris, kLeafMax);
  for (int j = 0; j < cnt; ++j) {
    const int32_t p = tris[j];
    for (int v = 0; v < 3; ++v) {
      const int32_t vi = c.idx[p * 3 + v];
      r[(v * 3 + 0) * kLeafMax + j] = c.pos[vi * 3 + 0];
      r[(v * 3 + 1) * kLeafMax + j] = c.pos[vi * 3 + 1];
      r[(v * 3 + 2) * kLeafMax + j] = c.pos[vi * 3 + 2];
      r[(9 + v * 2 + 0) * kLeafMax + j] = c.uv[vi * 2 + 0];
      r[(9 + v * 2 + 1) * kLeafMax + j] = c.uv[vi * 2 + 1];
    }
    const int64_t orig = c.tri_ids ? c.tri_ids[p] : p;
    r[15 * kLeafMax + j] = float(orig * 4 + (c.flags[p] & 3));
  }
  const int64_t leaf_code = row * kLeafMax + (cnt - 1);
  return float(-(leaf_code + 1));
}

template <int kWidth>
float build_node(Ctx& c, int64_t lo, int64_t hi, BBox& out, int32_t& need,
                 bool force_interior);

template <int kWidth>
inline float make_interior(Ctx& c, int64_t lo, int64_t hi, int32_t& need) {
  constexpr int kLanes = kWidth * 8;
  constexpr int kLeafMax = kWidth / 2;
  int64_t parts[kWidth + 1];
  float metric[kWidth];  // SAH pick priority: bounds area x count
  int n_parts = 1;
  parts[0] = lo;
  parts[1] = hi;
  // Split the partition with the largest area*count (SAH subtree cost),
  // not the largest count — big flat pieces get cut before dense small
  // ones, which tightens sibling bounds.
  auto part_metric = [&](int64_t a, int64_t b) {
    if (b - a <= kLeafMax) return -1.0f;  // leaf-sized: never split
    BBox bx;
    bx.reset();
    for (int64_t i = a; i < b; ++i) bx.grow(c.tbox[size_t(c.prim[size_t(i)])]);
    return bx.area() * float(b - a);
  };
  metric[0] = part_metric(lo, hi);
  while (n_parts < kWidth) {
    int pick = -1;
    float best = 0.0f;
    for (int i = 0; i < n_parts; ++i) {
      if (metric[i] > best) { best = metric[i]; pick = i; }
    }
    if (pick < 0) break;
    const int64_t mid = wbvh::split_range(c, parts[pick], parts[pick + 1]);
    for (int i = n_parts; i > pick; --i) {
      parts[i + 1] = parts[i];
      metric[i] = metric[i - 1];
    }
    parts[pick + 1] = mid;
    metric[pick] = part_metric(parts[pick], mid);
    metric[pick + 1] = part_metric(mid, parts[pick + 2]);
    ++n_parts;
  }

  const int64_t row = alloc_row<kWidth>(c);
  int32_t kid_need = 0;
  for (int i = 0; i < n_parts && !c.overflow; ++i) {
    BBox box;
    int32_t nd = 0;
    const float ref = build_node<kWidth>(c, parts[i], parts[i + 1], box, nd, false);
    kid_need = std::max(kid_need, nd);
    float* r = c.rows + row * kLanes;
    r[0 * kWidth + i] = box.mn[0];
    r[1 * kWidth + i] = box.mn[1];
    r[2 * kWidth + i] = box.mn[2];
    r[3 * kWidth + i] = box.mx[0];
    r[4 * kWidth + i] = box.mx[1];
    r[5 * kWidth + i] = box.mx[2];
    r[6 * kWidth + i] = ref;
  }
  float* r = c.rows + row * kLanes;
  for (int i = n_parts; i < kWidth; ++i) {
    r[0 * kWidth + i] = r[1 * kWidth + i] = r[2 * kWidth + i] = kInvalid;
    r[3 * kWidth + i] = r[4 * kWidth + i] = r[5 * kWidth + i] = -kInvalid;
    r[6 * kWidth + i] = 0.0f;
  }
  need = (n_parts - 1) + kid_need;
  return float(row);
}

template <int kWidth>
float build_node(Ctx& c, int64_t lo, int64_t hi, BBox& out, int32_t& need,
                 bool force_interior) {
  out.reset();
  for (int64_t i = lo; i < hi; ++i) out.grow(c.tbox[size_t(c.prim[size_t(i)])]);
  if (c.overflow) return 0.0f;
  constexpr int kLeafMax = kWidth / 2;
  if (!force_interior) {
    if (hi - lo <= kLeafMax) {
      need = 0;
      return make_leaf<kWidth>(c, lo, hi);
    }
    // Presplit fragments of one triangle dedup at leaf emission, so a
    // larger fragment range can still be a single-row leaf.
    if (c.frag && hi - lo <= 3 * kLeafMax) {
      int32_t tmp[kLeafMax];
      if (unique_tris<kWidth>(c, lo, hi, tmp, kLeafMax) <= kLeafMax) {
        need = 0;
        return make_leaf<kWidth>(c, lo, hi);
      }
    }
  }
  return make_interior<kWidth>(c, lo, hi, need);
}

// Clip triangle `tri` against the half-space {x[axis] <= mid} (below) or
// {x[axis] >= mid} (!below); returns the clipped polygon's bbox intersected
// with the parent fragment box. Invalid (reset) bbox if the clip is empty.
inline wbvh::BBox clip_tri_box(const float* pos, const int32_t* idx,
                               int32_t tri, const wbvh::BBox& pb, int axis,
                               float mid, bool below) {
  float p[3][3];
  for (int v = 0; v < 3; ++v)
    for (int k = 0; k < 3; ++k)
      p[v][k] = pos[size_t(idx[tri * 3 + v]) * 3 + k];
  wbvh::BBox out;
  out.reset();
  int n_emit = 0;
  for (int i = 0; i < 3; ++i) {
    const float* a = p[i];
    const float* b = p[(i + 1) % 3];
    const float da = below ? mid - a[axis] : a[axis] - mid;
    const float db = below ? mid - b[axis] : b[axis] - mid;
    if (da >= 0.0f) { out.grow(a); ++n_emit; }
    if ((da >= 0.0f) != (db >= 0.0f)) {
      const float t = da / (da - db);
      float q[3];
      for (int k = 0; k < 3; ++k) q[k] = a[k] + t * (b[k] - a[k]);
      out.grow(q);
      ++n_emit;
    }
  }
  if (n_emit < 3) { out.reset(); return out; }
  for (int k = 0; k < 3; ++k) {
    out.mn[k] = std::max(out.mn[k], pb.mn[k]);
    out.mx[k] = std::min(out.mx[k], pb.mx[k]);
    if (out.mn[k] > out.mx[k]) { out.reset(); return out; }
  }
  return out;
}

template <int kWidth>
int64_t build_planar(const float* positions, const int32_t* indices,
                     const float* uv, const int32_t* tri_ids,
                     const int32_t* tri_flags, int64_t n_tris,
                     float* rows_out, int64_t max_rows,
                     int32_t* stack_depth_out, float presplit) {
  if (n_tris < 1 || max_rows < 2) return -1;
  wbvh::Ctx c;
  c.pos = positions;
  c.idx = indices;
  c.uv = uv;
  c.tri_ids = tri_ids;
  c.flags = tri_flags;
  c.n_tris = n_tris;
  c.rows = rows_out;
  c.max_rows = max_rows;
  std::vector<wbvh::BBox> tbox(static_cast<size_t>(n_tris));
  for (int64_t t = 0; t < n_tris; ++t) {
    wbvh::BBox& b = tbox[size_t(t)];
    b.reset();
    for (int v = 0; v < 3; ++v) b.grow(positions + size_t(indices[t * 3 + v]) * 3);
  }

  // SBVH-style presplitting: big flat triangles (architectural floors,
  // walls) get their bounds split at the longest-axis midpoint with a true
  // polygon clip, so sibling subtree bounds stop overlapping them. Budget
  // is `presplit * n_tris` extra fragments, spent largest-box-first.
  std::vector<int32_t> frag_tri;
  int64_t budget = presplit > 0.0f ? int64_t(presplit * float(n_tris)) : 0;
  if (budget > 0) {
    frag_tri.resize(size_t(n_tris));
    std::priority_queue<std::pair<float, int64_t>> heap;
    for (int64_t t = 0; t < n_tris; ++t) {
      frag_tri[size_t(t)] = int32_t(t);
      const float a = tbox[size_t(t)].area();
      if (a > 0.0f) heap.push({a, t});
    }
    while (budget > 0 && !heap.empty()) {
      const int64_t f = heap.top().second;
      heap.pop();
      const wbvh::BBox pb = tbox[size_t(f)];
      int axis = 0;
      float ext = -1.0f;
      for (int k = 0; k < 3; ++k) {
        const float e = pb.mx[k] - pb.mn[k];
        if (e > ext) { ext = e; axis = k; }
      }
      if (ext <= 1e-12f) continue;
      const float mid = 0.5f * (pb.mn[axis] + pb.mx[axis]);
      const int32_t tri = frag_tri[size_t(f)];
      const wbvh::BBox bl =
          clip_tri_box(positions, indices, tri, pb, axis, mid, true);
      const wbvh::BBox br =
          clip_tri_box(positions, indices, tri, pb, axis, mid, false);
      if (bl.mn[0] > bl.mx[0] || br.mn[0] > br.mx[0]) continue;
      tbox[size_t(f)] = bl;
      tbox.push_back(br);
      frag_tri.push_back(tri);
      heap.push({bl.area(), f});
      heap.push({br.area(), int64_t(tbox.size()) - 1});
      --budget;
    }
  }

  const int64_t n_prims = int64_t(tbox.size());
  c.tbox = std::move(tbox);
  c.frag = frag_tri.empty() ? nullptr : frag_tri.data();
  c.cent.resize(size_t(n_prims) * 3);
  c.prim.resize(size_t(n_prims));
  for (int64_t t = 0; t < n_prims; ++t) {
    const wbvh::BBox& b = c.tbox[size_t(t)];
    for (int k = 0; k < 3; ++k)
      c.cent[size_t(t) * 3 + k] = 0.5f * (b.mn[k] + b.mx[k]);
    c.prim[size_t(t)] = int32_t(t);
  }
  wbvh::BBox root_box;
  int32_t need = 1;
  const float root =
      build_node<kWidth>(c, 0, n_prims, root_box, need, /*force_interior=*/true);
  if (c.overflow || root != 0.0f) return -1;
  if (stack_depth_out) *stack_depth_out = std::max(need, 1);
  return c.n_rows;
}

}  // namespace wplanar

extern "C" {

// Returns rows written (row 0 = root) or -1 on overflow; *stack_depth_out
// receives the exact worst-case traversal stack need of this tree.
// `presplit` > 0 spends that fraction of n_tris as extra clipped fragments
// on the largest triangle bounds (SBVH-style; duplicates dedup in leaves).
int64_t build_bvh16(const float* positions, const int32_t* indices,
                    const float* uv, const int32_t* tri_ids,
                    const int32_t* tri_flags, int64_t n_tris,
                    float* rows_out, int64_t max_rows,
                    int32_t* stack_depth_out, float presplit) {
  return wplanar::build_planar<16>(positions, indices, uv, tri_ids, tri_flags,
                                   n_tris, rows_out, max_rows, stack_depth_out,
                                   presplit);
}

// 32-wide variant: 1024-byte rows, leaves of up to 16 triangles.
int64_t build_bvh32(const float* positions, const int32_t* indices,
                    const float* uv, const int32_t* tri_ids,
                    const int32_t* tri_flags, int64_t n_tris,
                    float* rows_out, int64_t max_rows,
                    int32_t* stack_depth_out, float presplit) {
  return wplanar::build_planar<32>(positions, indices, uv, tri_ids, tri_flags,
                                   n_tris, rows_out, max_rows, stack_depth_out,
                                   presplit);
}

}  // extern "C"
