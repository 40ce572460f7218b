// Fused shading stage of one pooled-wavefront bounce: one CUDA thread per
// lane, everything between the bounce's two traversals in one launch.
//
// Replaces the TPU kernel vk_raytrace_tpu/integrator/shade_fused.py
// (_make_kernel, launched by shade_bounce_fused) together with the XLA
// prologue around it (_tex_index_weights, _positioned_light,
// _env_sample_xi, _env_sample_mixture): the bounce's RNG draws, the shade
// row and footprint tap reads, the uv transform and ray-cone LOD, the
// punctual light and environment NEE samples, the miss radiance with its
// MIS weight, then shade-state reconstruction, material resolve, NEE
// evaluation with MIS, the glTF PBR BSDF sample, absorption, the
// Russian-roulette continuation probability and the next ray.
//
// Two entries share the body (shade_body):
//
// * vkrt_shade_stage, the main path: the whole stage. Per lane it reads
//   the hit (t, u, v, tri, and inst in an instanced scene) and the lane
//   state (origin, direction, radiance, throughput, absorption, seed,
//   bsdf_pdf, tdist), and from the scene's tables where they lie: the shade
//   row (T, 128) f32, the footprint tap rows (H*W, 4) i32, the env rows
//   (h*w, 16) f32, the light rows (L, 16) f32, the instance rows (I, 12) f32
//   twice, and the sun disk's per-scene constants (SunLane). It writes each
//   epilogue tensor directly (StageArgs).
// * vkrt_shade, the body alone on inputs the torch prologue gathered
//   (integrator/shade_fused.py::shade_inputs): srow (R, 128) f32, taps
//   (R, 16) i32, aux (R, 48 or 72) f32 (layout at shade_fused.aux_width);
//   out_vec (R, 24) f32 and the masks alive, visible. Off the main path; it
//   keeps the every-branch gate on gathered rows. Its blocks stage their
//   lanes' inputs in shared memory (shade_kernel, below).
//
// What bounds it on this card: by the byte and operation counts, device
// memory. A lane of the stage reads ~400 bytes of its 512-byte shade row,
// 4 taps of 16 bytes, 1-3 env rows of 64 bytes and ~120 bytes of state, and
// writes ~110, against ~1,800 float operations, several of them IEEE
// divisions, square roots and libdevice transcendentals. The shade row is
// the largest read and the atrium's table (111 MB) does not stay in the
// 50 MB L2; each thread of the stage reads its own row through the
// read-only cache (staging each warp's 32 gathered rows in shared memory
// with cp.async measured slower on the H100: the lanes read ~80 scalars of
// their rows, and the kernel runs ~6x its byte bound, more issue- than
// load-bound). The other gathers are per-thread __ldg too. The branches
// that are uniform per call
// (texture flags, anisotropy, full MIS, sun disk, mip LOD) are bits of
// `flags`; the instanced layout is a template parameter.
//
// Numerics follow the plain torch version (shade_inputs + _shade_plain)
// operation by operation: -fmad=false, IEEE division and square root,
// libdevice expf/logf/log2f/powf/sinf/cosf/acosf/asinf/atan2f, NaN-
// propagating clamps like torch.clamp, floor division and remainder like
// torch's on int64, float-to-int truncation like .long(), dot products
// summed x, y, z in that order, and a division by a Python number as the
// product with its reciprocal on the card, as torch computes it there.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// Pointers and sizes of one stage launch; the field order is
// shade_fused._StageArgs's. At namespace scope: vkrt_shade_stage, which
// takes it, has external (C) linkage.
struct StageArgs {
  // the hit, (R,): t, u, v f32; tri i64 (-1 on miss); inst i64 (instanced)
  const float* t;
  const float* u;
  const float* v;
  const int64_t* tri;
  const int64_t* inst;
  // the lane state: (R, 3) f32 x5, seed (R,) i64 holding a u32, bsdf_pdf
  // and tdist (R,) f32 (the path length before this hit), active (R,) u8 or
  // null (every lane live)
  const float* origin;
  const float* direction;
  const float* radiance;
  const float* throughput;
  const float* absorption;
  const int64_t* seed;
  const float* bsdf_pdf;
  const float* tdist;
  const uint8_t* active;
  // the scene's tables
  const float* shade_rows;   // (T, 128)
  const int32_t* tap_rows;   // (n_tap, 4)
  const float* env_rows;     // (env_h * env_w, 16)
  const float* lights;       // (L, 16), LightLane
  const float* sun;          // (kSunLanes,), SunLane
  const float* o2w;          // (I, 12)
  const float* w2o;          // (I, 12)
  int64_t n_tap, atlas_w;
  int64_t env_h, env_w;
  int64_t n_lights;
  // per-call scalars, rounded to float32 as torch rounds the Python floats
  float spread;        // pixel spread (mip LOD)
  float hdr_mult;
  float p_select;      // P(pick the lights)
  float p_light_n;     // full MIS: P(pick lights) / n_lights
  float p_env;         // 1 - P(pick lights) (0 without lights)
  float env_step;      // pi / env_h
  int64_t n;
  int flags;
  // outputs: (R, 3) f32 x7, (R,) f32 x4 (tdist_out: tdist plus the hit's t),
  // masks u8, seed i64
  float* new_origin;
  float* new_dir;
  float* radiance_out;
  float* throughput_out;
  float* absorption_out;
  float* nee;
  float* light_dir;
  float* light_dist;
  float* rr_pcont;
  float* pdf_b;
  float* tdist_out;
  uint8_t* alive;
  uint8_t* visible;
  uint8_t* miss;
  int64_t* seed_out;
};

namespace {

constexpr float kPi = (float)3.14159265358979;
constexpr float kInvPi = (float)(1.0 / 3.14159265358979);
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979);
constexpr float kInv255 = (float)(1.0 / 255.0);
constexpr float kF04 = 0.04f;
constexpr float kF096 = 1.0f - 0.04f;
// Python's math.pi and the constants the plain version forms from it.
constexpr float kMathPi = (float)3.141592653589793;
constexpr float kMathTwoPi = (float)(2.0 * 3.141592653589793);
constexpr float kMathInvPi = (float)(1.0 / 3.141592653589793);
constexpr float kHalfInvPi = (float)(0.5 / 3.141592653589793);

// material row offsets inside the merged row (40 + shade.py::_OFFS)
constexpr int kMat = 40;
constexpr int kUvT = kMat + 0;
constexpr int kTexBase = kMat + 6;  // 4 textures x 8 lanes; lane 0 = id
constexpr int kEmissive = kMat + 38;
constexpr int kNormalScale = kMat + 41;
constexpr int kIor = kMat + 42;
constexpr int kRough = kMat + 43;
constexpr int kMetal = kMat + 44;
constexpr int kBaseFactor = kMat + 45;
constexpr int kTransmission = kMat + 49;
constexpr int kUnlit = kMat + 51;
constexpr int kAniso = kMat + 52;
constexpr int kAnisoDir = kMat + 53;
constexpr int kAttenColor = kMat + 56;
constexpr int kAttenDist = kMat + 59;
constexpr int kThickness = kMat + 60;
constexpr int kCcF = kMat + 61;
constexpr int kCcRough = kMat + 63;

enum Flag {
  kBaseTex = 1, kMrTex = 2, kNormalTex = 4, kEmissiveTex = 8, kAnisotropy = 16, kFullMis = 32,
  kInstanced = 64,
  // the stage entry only
  kSunDisk = 128, kMip = 256,
};

// Light rows (shade_fused.light_rows): position3 direction3 color3
// intensity range inner_cone_cos outer_cone_cos type, padded to 16.
enum LightLane {
  kLPos = 0, kLDir = 3, kLColor = 6, kLIntensity = 9, kLRange = 10, kLInner = 11, kLOuter = 12,
  kLType = 13, kLightW = 16,
};
constexpr int kLightDirectional = 0, kLightSpot = 2;  // schema.py LIGHT_*

// The sun disk's constants, packed in the field order of
// ops/sunsky.py::SunDisk (shade_fused.sun_lanes); booleans as 0 / 1.
enum SunLane {
  kSYUp = 0, kSHh = 1, kSDir0 = 2, kSRadius = 5, kSRadiusC = 6, kSDiskOk = 7, kSSsDen = 8,
  kSIntensity = 9, kSDiskScale = 10, kSColorUp = 11, kSColorDown = 14, kSRgbScale = 17,
  kSHorBlur = 20, kSHorBlurC = 21, kSSat = 22, kSOneMinusSat = 23, kSTweak = 24, kSDark = 27,
  kSPresent = 28, kSAxis = 29, kSCosTheta = 32, kSQ = 33, kSOneMinusQ = 34, kSOneMinusCos = 35,
  kSCosLo = 36, kSInvSolid = 37, kSConeT = 38, kSConeB = 41, kSunLanes = 44,
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 splat(float s) { return V3{s, s, s}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return V3{a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return V3{s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator-(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 normalize(V3 v) {
  const float l = sqrtf(dot(v, v));
  return V3{v.x / l, v.y / l, v.z / l};
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// torch.clamp semantics: NaN in, NaN out.
__device__ __forceinline__ float cmax(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ float cmin(float x, float hi) { return x != x ? x : fminf(x, hi); }
__device__ __forceinline__ float clip(float x, float lo, float hi) { return cmin(cmax(x, lo), hi); }
// torch.maximum / torch.minimum semantics: NaN if either is NaN.
__device__ __forceinline__ float nmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// torch's // and remainder on int64 (floor division; b > 0 here).
__device__ __forceinline__ int64_t floordiv(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int64_t floormod(int64_t a, int64_t b) {
  const int64_t r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) { return a > b ? a : b; }
__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }
// .long() of a float: truncation toward zero.
__device__ __forceinline__ int64_t trunc64(float x) { return (int64_t)x; }

// x / b for a Python number b: torch multiplies by b's float reciprocal on
// the card and divides on the CPU (the host build of this file).
__device__ __forceinline__ float div_scalar(float x, float b) {
#ifdef __CUDA_ARCH__
  return x * (1.0f / b);
#else
  return x / b;
#endif
}

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x2 * x2 * x;
}

__device__ __forceinline__ float srgb(float c) {
  c = cmax(c, 0.0f);
  const float out = expf(2.2f * logf(cmax(c, 1e-30f)));
  return c <= 0.0f ? 0.0f : out;
}

__device__ __forceinline__ float smoothstep01(float t) { return t * t * (3.0f - 2.0f * t); }

// Octahedral decode of one packed normal from its u16 halves, unnormalised.
__device__ __forceinline__ V3 oct3(float lo, float hi) {
  int x = (int)lo - 32767;
  int y = (int)hi - 32767;
  const int maskx = x >> 31;
  const int masky = y >> 31;
  const int tmp0 = 32767 + maskx + masky;
  const int ymask = y ^ masky;
  const int tmp1 = tmp0 - (x ^ maskx);
  const int z = tmp1 - ymask;
  const int xf = (tmp0 - ymask) ^ maskx;
  const int yf = tmp1 ^ masky;
  if (z < 0) {
    x = xf;
    y = yf;
  }
  const float s = 1.0f / 32768.0f;
  return V3{(float)x * s, (float)y * s, (float)z * s};
}

__device__ __forceinline__ float bary(float w, float u, float v, float a0, float a1, float a2) {
  return w * a0 + u * a1 + v * a2;
}

// A lane's shade row (or instance rows) in device memory, read through the
// read-only cache: the stage's reader.
struct Row {
  const float* p;
  __device__ __forceinline__ float operator[](int k) const { return __ldg(p + k); }
};

// A lane's record in shared memory, read as it lies: the body alone's reader
// (shade_kernel stages each block's rows there). The body and its helpers
// take the reader as a template parameter RowT, so that the stage keeps
// Row's __ldg, which must never see a shared-memory address.
struct SharedRow {
  const float* p;
  __device__ __forceinline__ float operator[](int k) const { return p[k]; }
};

template <class RowT>
__device__ __forceinline__ V3 ld3(const RowT& r, int k) { return V3{r[k], r[k + 1], r[k + 2]}; }
__device__ __forceinline__ V3 ldg3(const float* p) {
  return V3{__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// Per-vertex normalise of 3 oct-packed directions, interpolate, normalise.
template <class RowT>
__device__ __forceinline__ V3 vertex_dir(const RowT& row, int lo, int hi, float w, float u,
                                         float v) {
  V3 p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    V3 q = oct3(row[lo + k], row[hi + k]);
    const float n = sqrtf(q.x * q.x + q.y * q.y + q.z * q.z);
    p[k] = V3{q.x / n, q.y / n, q.z / n};
  }
  return normalize(V3{bary(w, u, v, p[0].x, p[1].x, p[2].x), bary(w, u, v, p[0].y, p[1].y, p[2].y),
                      bary(w, u, v, p[0].z, p[1].z, p[2].z)});
}

__device__ __forceinline__ float4 texel(int c) {
  return make_float4((float)(c & 0xFF) * kInv255, (float)((c >> 8) & 0xFF) * kInv255,
                     (float)((c >> 16) & 0xFF) * kInv255, (float)((c >> 24) & 0xFF) * kInv255);
}

__device__ __forceinline__ float lerp1(float a, float b, float g) { return a + (b - a) * g; }

// What the body reads besides the shade row.
struct LaneIn {
  V3 d, origin;
  float hit_u, hit_v, hit_t;
  bool active, miss;
  V3 ldir, lcontrib, envmiss;
  float ldist, lpdf;
  bool use_light;
  V3 radiance, throughput, absorption;
  float draws[6];  // probability r1 r2 u_trans u_reflect u_lobe
  float gxy[8];    // per texture gx, gy
  int32_t taps[16];  // per texture c00 c10 c01 c11 (RGBA8)
};

struct LaneOut {
  V3 new_origin, new_dir, radiance, throughput, absorption, nee, ldir;
  float ldist, rr_pcont, pdf_b;
  bool alive, visible;
};

// Bilinear blend of texture k's footprint row; 1 where the material has no
// texture in that slot.
template <class RowT>
__device__ __forceinline__ float4 tap(const LaneIn& L, const RowT& row, int k, bool is_srgb) {
  const float gx = L.gxy[2 * k], gy = L.gxy[2 * k + 1];
  const float4 c00 = texel(L.taps[4 * k]), c10 = texel(L.taps[4 * k + 1]);
  const float4 c01 = texel(L.taps[4 * k + 2]), c11 = texel(L.taps[4 * k + 3]);
  float4 o;
  o.x = lerp1(lerp1(c00.x, c10.x, gx), lerp1(c01.x, c11.x, gx), gy);
  o.y = lerp1(lerp1(c00.y, c10.y, gx), lerp1(c01.y, c11.y, gx), gy);
  o.z = lerp1(lerp1(c00.z, c10.z, gx), lerp1(c01.z, c11.z, gx), gy);
  o.w = lerp1(lerp1(c00.w, c10.w, gx), lerp1(c01.w, c11.w, gx), gy);
  if (is_srgb) {
    o.x = srgb(o.x);
    o.y = srgb(o.y);
    o.z = srgb(o.z);
  }
  if (row[kTexBase + 8 * k] < 0.0f) o = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  return o;
}

struct Mat {
  V3 albedo, f0;
  float metallic, roughness, transmission, ior, anisotropy, clearcoat, cc_rough;
  bool thinwalled;
};

__device__ __forceinline__ float v_ggx(float ndotl, float ndotv, float alpha) {
  const float a2 = alpha * alpha;
  const float ggxv = ndotl * sqrtf(ndotv * ndotv * (1.0f - a2) + a2);
  const float ggxl = ndotv * sqrtf(ndotl * ndotl * (1.0f - a2) + a2);
  const float ggx = ggxv + ggxl;
  return ggx > 0.0f ? 0.5f / cmax(ggx, 1e-12f) : 0.0f;
}

__device__ __forceinline__ float v_ggx_aniso(float ndotl, float ndotv, float bdotv, float tdotv,
                                             float tdotl, float bdotl, float at, float ab) {
  float a = at * tdotv, b = ab * bdotv;
  const float ggxv = ndotl * sqrtf(a * a + b * b + ndotv * ndotv);
  a = at * tdotl;
  b = ab * bdotl;
  const float ggxl = ndotv * sqrtf(a * a + b * b + ndotl * ndotl);
  return clip(0.5f / cmax(ggxv + ggxl, 1e-12f), 0.0f, 1.0f);
}

__device__ __forceinline__ float d_ggx(float ndoth, float alpha) {
  const float a2 = alpha * alpha;
  const float f = ndoth * ndoth * (a2 - 1.0f) + 1.0f;
  return a2 / cmax(kPi * f * f, 1e-12f);
}

__device__ __forceinline__ float d_ggx_aniso(float ndoth, float tdoth, float bdoth, float at,
                                             float ab) {
  const float a2 = at * ab;
  const float x = ab * tdoth, y = at * bdoth, z = a2 * ndoth;
  const float w2 = a2 / cmax(x * x + y * y + z * z, 1e-20f);
  return a2 * w2 * w2 * kInvPi;  // a product, as in the plain version
}

__device__ __forceinline__ float sdiv(float num, float den) {
  const float eps = 1e-9f;
  const float safe = fabsf(den) < eps ? (den < 0.0f ? -eps : eps) : den;
  return num / safe;
}

__device__ __forceinline__ V3 reflect(V3 i, V3 n) { return i - (2.0f * dot(n, i)) * n; }

__device__ __forceinline__ V3 refract(V3 i, V3 n, float eta) {
  const float cosi = dot(n, i);
  const float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
  const float s = eta * cosi + sqrtf(cmax(k, 0.0f));
  const V3 out = eta * i - s * n;
  return k < 0.0f ? splat(0.0f) : out;
}

__device__ __forceinline__ V3 from_local(float x, float y, float z, V3 t, V3 b, V3 n) {
  return x * t + y * b + z * n;
}

__device__ __forceinline__ float offset1(float p, float n) {
  const int of_i = (int)(256.0f * n);
  const unsigned bits = (unsigned)__float_as_int(p) + (unsigned)(p < 0.0f ? -of_i : of_i);
  const float p_i = __int_as_float((int)bits);
  return fabsf(p) < (1.0f / 32.0f) ? p + (1.0f / 65536.0f) * n : p_i;
}

__device__ __forceinline__ V3 schlick(V3 f0, V3 f90m, float vdoth) {
  const float p = pow5(clip(1.0f - vdoth, 0.0f, 1.0f));
  return f0 + f90m * p;
}

__device__ __forceinline__ V3 f90_minus_f0(V3 f0) {
  const float f90 = clip(nmax(nmax(f0.x, f0.y), f0.z) * 50.0f, 0.0f, 1.0f);
  return splat(f90) - f0;
}

// Isotropic or anisotropic GGX (pdf, f) before the validity mask.
__device__ __forceinline__ void spec_lobe(int flags, const Mat& m, V3 f0, V3 f90m, V3 v, V3 l,
                                          V3 h, V3 t, V3 b, float ndotl_c, float ndotv,
                                          float ndoth_u, float ldoth_u, float vdoth_u,
                                          float& pdf, V3& f) {
  const float ndoth = clip(ndoth_u, 0.0f, 1.0f);
  const float ldoth = clip(ldoth_u, 0.0f, 1.0f);
  const float vdoth = clip(vdoth_u, 0.0f, 1.0f);
  pdf = d_ggx(ndoth, m.roughness) * ndoth / cmax(4.0f * ldoth, 1e-9f);
  const V3 fres = schlick(f0, f90m, vdoth);
  f = fres * v_ggx(ndotl_c, ndotv, m.roughness) * d_ggx(ndoth, cmax(m.roughness, 0.001f));
  if (flags & kAnisotropy) {
    const float tdotv = clip(dot(t, v), 0.0f, 1.0f);
    const float bdotv = clip(dot(b, v), 0.0f, 1.0f);
    const float tdotl = dot(t, l), bdotl = dot(b, l);
    const float tdoth = dot(t, h), bdoth = dot(b, h);
    const float aniso = m.anisotropy;
    const float at = cmax(m.roughness * (1.0f + aniso), 0.001f);
    const float ab = cmax(m.roughness * (1.0f - aniso), 0.001f);
    const float pdf_a = sdiv(d_ggx_aniso(ndoth_u, tdoth, bdoth, at, ab), 4.0f * ldoth_u);
    const float at2 = cmax(m.roughness * (1.0f + aniso), 0.00001f);
    const float ab2 = cmax(m.roughness * (1.0f - aniso), 0.00001f);
    const V3 f_a = fres * v_ggx_aniso(ndotl_c, ndotv, bdotv, tdotv, tdotl, bdotl, at2, ab2) *
                   d_ggx_aniso(ndoth_u, tdoth, bdoth, at2, ab2);
    if (aniso > 0.0f) {
      pdf = pdf_a;
      f = f_a;
    }
  }
}

// Clearcoat (pdf, f) before the validity mask.
__device__ __forceinline__ void clearcoat_lobe(const Mat& m, float ndotl_c, float ndotv,
                                               float ndoth_u, float ldoth_u, float vdoth_u,
                                               float& pdf, float& f) {
  const float ccf = kF04 + kF096 * pow5(clip(1.0f - vdoth_u, 0.0f, 1.0f));
  const float cca = m.cc_rough * m.cc_rough;
  const float g_c = v_ggx(ndotl_c, ndotv, cca);
  const float d_c = d_ggx(ndoth_u, cmax(cca, 0.001f));
  pdf = d_c * ndoth_u / cmax(4.0f * ldoth_u, 1e-9f);
  f = ccf * d_c * g_c * m.clearcoat;
}

// PbrEval (pbr_gltf.glsl:365-434).
__device__ void pbr_eval(int flags, const Mat& m, V3 v, V3 n, V3 l, V3 t, V3 b, float eta, V3& f,
                         float& pdf) {
  const float ndotl = dot(n, l);
  V3 h = ndotl < 0.0f ? normalize(l * (1.0f / eta) + v) : normalize(l + v);
  if (dot(n, h) < 0.0f) h = -h;
  const float diffuse_ratio = 0.5f * (1.0f - m.metallic);
  const float spec_ratio = 1.0f - diffuse_ratio;
  const float psr = 1.0f / (1.0f + m.clearcoat);
  const float tw = (1.0f - m.metallic) * m.transmission;
  const V3 f90m = f90_minus_f0(m.f0);

  const float ndotv_r = dot(n, v);
  const bool valid_d = (ndotl >= 0.0f) && (ndotv_r >= 0.0f);
  const float ndotl_c = clip(ndotl, 0.001f, 1.0f);
  const float pd = valid_d ? ndotl_c * kInvPi : 0.0f;
  const V3 fd = valid_d ? (1.0f - m.metallic) * (m.albedo * kInvPi) : splat(0.0f);

  const bool valid = ndotl >= 0.0f;
  const float ndotv = clip(fabsf(ndotv_r), 0.001f, 1.0f);
  const float ndoth_u = dot(n, h), vdoth_u = dot(v, h), ldoth_u = dot(l, h);
  float pc, fc;
  clearcoat_lobe(m, ndotl_c, ndotv, ndoth_u, ldoth_u, vdoth_u, pc, fc);
  pc = valid ? pc : 0.0f;
  fc = valid ? fc : 0.0f;
  float ps;
  V3 fs;
  spec_lobe(flags, m, m.f0, f90m, v, l, h, t, b, ndotl_c, ndotv, ndoth_u, ldoth_u, vdoth_u, ps,
            fs);
  ps = valid ? ps : 0.0f;
  fs = sel(valid, fs, splat(0.0f));

  const bool refl = ndotl > 0.0f;
  const V3 brdf = refl ? fd + splat(fc) + fs : splat(0.0f);
  const float brdf_pdf =
      refl ? pd * diffuse_ratio + pc * (1.0f - psr) * spec_ratio + ps * psr * spec_ratio : 0.0f;
  const float bsdf_pdf = fabsf(ndotl);
  f = brdf + (m.albedo - brdf) * tw;
  pdf = brdf_pdf + (bsdf_pdf - brdf_pdf) * tw;
}

__device__ __forceinline__ V3 ggx_dir(float alpha, float r1, float r2, V3 t, V3 b, V3 n) {
  const float a = cmax(alpha, 0.001f);
  const float phi = r1 * kTwoPi;
  const float cos_t = sqrtf((1.0f - r2) / (1.0f + (a * a - 1.0f) * r2));
  const float sin_t = clip(sqrtf(1.0f - cos_t * cos_t), 0.0f, 1.0f);
  return from_local(sin_t * cosf(phi), sin_t * sinf(phi), cos_t, t, b, n);
}

// PbrSample (pbr_gltf.glsl:439-554) from the pre-drawn variates.
__device__ void pbr_sample(int flags, const Mat& m, V3 v, V3 n, V3 normal, V3 t, V3 b, float eta,
                           const float* draws, V3& f_out, V3& l_out, float& pdf_out) {
  const float probability = draws[0], r1 = draws[1], r2 = draws[2];
  const float u_trans = draws[3], u_reflect = draws[4], u_lobe = draws[5];
  const float diffuse_ratio = 0.5f * (1.0f - m.metallic);
  const float tw = (1.0f - m.metallic) * m.transmission;

  // transmission; the two GGX lobes share (r1, r2)
  float r0 = (1.0f - m.ior) / (1.0f + m.ior);
  r0 = r0 * r0;
  const V3 h_t = ggx_dir(m.roughness, r1, r2, t, b, n);
  const float vdoth = dot(v, h_t);
  float f_refl = r0 + (1.0f - r0) * pow5(clip(1.0f - vdoth, 0.0f, 1.0f));
  float disc = 1.0f - eta * eta * (1.0f - vdoth * vdoth);
  if (m.thinwalled && dot(n, normal) < 0.0f) {
    f_refl = 0.0f;
    disc = 0.0f;
  }
  const float eta_t = m.thinwalled ? 1.0f : eta;
  const bool do_reflect = (disc < 0.0f) || (u_reflect < f_refl);
  const V3 l_refl = normalize(reflect(-v, h_t));
  V3 l_refr = normalize(refract(-v, h_t, eta_t));
  if (dot(l_refr, l_refr) < 0.5f) l_refr = -v;
  const V3 l_trans = do_reflect ? l_refl : l_refr;
  const float pdf_trans = fabsf(dot(n, l_trans));

  // diffuse: cosine hemisphere
  const float rs = sqrtf(r1);
  const float phi_d = kTwoPi * r2;
  const float dx = rs * cosf(phi_d);
  const float dy = rs * sinf(phi_d);
  const float dz = sqrtf(cmax(1.0f - dx * dx - dy * dy, 0.0f));
  const V3 l_diff = from_local(dx, dy, dz, t, b, n);
  const float ndotl_d = dot(n, l_diff);
  const float ndotv_r = dot(n, v);
  const bool valid_d = (ndotl_d >= 0.0f) && (ndotv_r >= 0.0f);
  float pdf_d = valid_d ? clip(ndotl_d, 0.001f, 1.0f) * kInvPi : 0.0f;
  const V3 f_d = valid_d ? (1.0f - m.metallic) * (m.albedo * kInvPi) : splat(0.0f);
  pdf_d = pdf_d * diffuse_ratio;

  // specular / clearcoat
  const float psr = 1.0f / (1.0f + m.clearcoat);
  const float spec_ratio = 1.0f - diffuse_ratio;
  const bool use_primary = u_lobe < psr;
  const V3 h_s = ggx_dir(use_primary ? m.roughness : m.cc_rough, r1, r2, t, b, n);
  const V3 l_spec = reflect(-v, h_s);
  const float ndotl_s = dot(n, l_spec);
  const bool valid_s = ndotl_s >= 0.0f;
  const float ndotl_c = clip(ndotl_s, 0.001f, 1.0f);
  const float ndotv = clip(fabsf(ndotv_r), 0.001f, 1.0f);
  const float ndoth_u = dot(n, h_s), ldoth_u = dot(l_spec, h_s), vdoth_u = dot(v, h_s);
  float pdf_su, pdf_cu, f_cu;
  V3 f_su;
  spec_lobe(flags, m, m.f0, f90_minus_f0(m.f0), v, l_spec, h_s, t, b, ndotl_c, ndotv, ndoth_u,
            ldoth_u, vdoth_u, pdf_su, f_su);
  const float pdf_s = (valid_s ? pdf_su : 0.0f) * psr * spec_ratio;
  const V3 f_s = sel(valid_s, f_su, splat(0.0f));
  clearcoat_lobe(m, ndotl_c, ndotv, ndoth_u, ldoth_u, vdoth_u, pdf_cu, f_cu);
  const float pdf_c = (valid_s ? pdf_cu : 0.0f) * (1.0f - psr) * spec_ratio;
  const float f_c = valid_s ? f_cu : 0.0f;
  const V3 f_sc = use_primary ? f_s : splat(f_c);
  const float pdf_sc = use_primary ? pdf_s : pdf_c;

  const bool pick_diffuse = probability < diffuse_ratio;
  const V3 l_brdf = pick_diffuse ? l_diff : l_spec;
  const V3 f_brdf = (pick_diffuse ? f_d : f_sc) * (1.0f - tw);
  const float pdf_brdf = (pick_diffuse ? pdf_d : pdf_sc) * (1.0f - tw);

  const bool pick_trans = u_trans < tw;
  l_out = pick_trans ? l_trans : l_brdf;
  f_out = pick_trans ? m.albedo : f_brdf;
  pdf_out = pick_trans ? pdf_trans : pdf_brdf;
  if (flags & kFullMis) pbr_eval(flags, m, v, n, l_out, t, b, eta, f_out, pdf_out);
}

// The 3x3 block of a row-major 3x4 matrix m times v, and its transpose
// times v; sums over j in order 0, 1, 2.
template <class RowT>
__device__ __forceinline__ V3 m3v(const RowT& m, V3 v) {
  return V3{m[0] * v.x + m[1] * v.y + m[2] * v.z, m[4] * v.x + m[5] * v.y + m[6] * v.z,
            m[8] * v.x + m[9] * v.y + m[10] * v.z};
}

template <class RowT>
__device__ __forceinline__ V3 m3t_v(const RowT& m, V3 v) {
  return V3{m[0] * v.x + m[4] * v.y + m[8] * v.z, m[1] * v.x + m[5] * v.y + m[9] * v.z,
            m[2] * v.x + m[6] * v.y + m[10] * v.z};
}

// The hit position w*p0 + u*p1 + v*p2, in world space under INST.
template <bool INST, class RowT>
__device__ __forceinline__ V3 hit_position(const RowT& row, float hit_u, float hit_v,
                                           const RowT& o2w) {
  const float w_b = 1.0f - hit_u - hit_v;
  V3 position = w_b * ld3(row, 0) + hit_u * ld3(row, 3) + hit_v * ld3(row, 6);
  if (INST) position = m3v(o2w, position) + V3{o2w[3], o2w[7], o2w[11]};
  return position;
}

// The body: shade state, material, integrator clauses, NEE evaluation and
// the BSDF sample of one lane (the TPU kernel's body). INST: the hit is in
// object space; o2w / w2o are the instance's 3x4 rows. RowT reads the row
// and the instance rows (Row in device memory, SharedRow in shared memory).
template <bool INST, class RowT>
__device__ __forceinline__ LaneOut shade_body(int flags, const RowT& row, const LaneIn& L,
                                              const RowT& o2w, const RowT& w2o) {
  const V3 d = L.d;
  const float hit_u = L.hit_u, hit_v = L.hit_v, hit_t = L.hit_t;
  const bool miss = L.miss;

  // ---- shade state (shade_state.glsl:63-145) ------------------------------
  const float w_b = 1.0f - hit_u - hit_v;
  const V3 p0 = ld3(row, 0), p1 = ld3(row, 3), p2 = ld3(row, 6);
  const V3 position = hit_position<INST>(row, hit_u, hit_v, o2w);
  V3 normal = vertex_dir(row, 9, 12, w_b, hit_u, hit_v);
  V3 geom_normal = normalize(cross(p1 - p0, p2 - p0));
  V3 tangent = vertex_dir(row, 15, 18, w_b, hit_u, hit_v);
  if (INST) {
    // Object space to world: normals by w2o transposed (the inverse
    // transpose of o2w), the tangent by o2w.
    normal = normalize(m3t_v(w2o, normal));
    geom_normal = normalize(m3t_v(w2o, geom_normal));
    tangent = normalize(m3v(o2w, tangent));
  }
  const float handed = row[21];
  tangent = normalize(tangent - dot(tangent, normal) * normal);
  V3 bitangent = cross(normal, tangent) * handed;
  V3 vcol;
  {
    int lo[3], hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = (int)row[28 + k];
      hi[k] = (int)row[31 + k];
    }
    vcol.x = bary(w_b, hit_u, hit_v, (float)(lo[0] & 0xFF) * kInv255,
                  (float)(lo[1] & 0xFF) * kInv255, (float)(lo[2] & 0xFF) * kInv255);
    vcol.y = bary(w_b, hit_u, hit_v, (float)(lo[0] >> 8) * kInv255, (float)(lo[1] >> 8) * kInv255,
                  (float)(lo[2] >> 8) * kInv255);
    vcol.z = bary(w_b, hit_u, hit_v, (float)(hi[0] & 0xFF) * kInv255,
                  (float)(hi[1] & 0xFF) * kInv255, (float)(hi[2] & 0xFF) * kInv255);
  }
  if (dot(normal, geom_normal) <= 0.0f) normal = -normal;

  // ---- material resolve (gltf_material.glsl:105-193) ----------------------
  V3 ffnormal = dot(normal, d) <= 0.0f ? normal : -normal;
  if (flags & kNormalTex) {
    const float nscale = row[kNormalScale];
    const float4 tn = tap(L, row, 2, false);
    V3 nvec = normalize(V3{tn.x * 2.0f - 1.0f, tn.y * 2.0f - 1.0f, tn.z * 2.0f - 1.0f});
    nvec = nvec * V3{nscale, nscale, 1.0f};
    const V3 mapped = normalize(nvec.x * tangent + nvec.y * bitangent + nvec.z * normal);
    const bool has_nmap = row[kTexBase + 16] >= 0.0f;
    if (has_nmap) normal = mapped;
    ffnormal = dot(normal, d) <= 0.0f ? normal : -normal;
    // make_coordinate_system(ffnormal) (common.glsl:80-92)
    const float fx = ffnormal.x, fy = ffnormal.y, fz = ffnormal.z;
    V3 t2 = fabsf(fz) > 0.99999f ? V3{-fx * fy, 1.0f - fy * fy, -fy * fz}
                                 : V3{-fx * fz, -fy * fz, 1.0f - fz * fz};
    t2 = normalize(t2);
    const V3 b2 = cross(t2, ffnormal);
    if (has_nmap) {
      tangent = t2;
      bitangent = b2;
    }
  }
  V3 emission = ld3(row, kEmissive);
  if (flags & kEmissiveTex) {
    const float4 te = tap(L, row, 3, true);
    emission = emission * V3{te.x, te.y, te.z};
  }
  Mat m;
  m.ior = row[kIor];
  float ds = (m.ior - 1.0f) / (m.ior + 1.0f);
  const float dielectric_spec = ds * ds;
  const float4 mr = (flags & kMrTex) ? tap(L, row, 1, false) : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  float roughness = mr.y * row[kRough];
  m.metallic = mr.z * row[kMetal];
  const float4 bt = (flags & kBaseTex) ? tap(L, row, 0, true) : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  const V3 base = V3{row[kBaseFactor] * bt.x, row[kBaseFactor + 1] * bt.y,
                     row[kBaseFactor + 2] * bt.z};
  m.f0 = splat(dielectric_spec * (1.0f - m.metallic)) + base * m.metallic;
  m.albedo = base * vcol;
  m.roughness = cmax(roughness, 0.001f);
  const float eta = dot(normal, ffnormal) > 0.0f ? 1.0f / m.ior : m.ior;
  const bool unlit = row[kUnlit] == 1.0f;
  m.anisotropy = row[kAniso];
  if (flags & kAnisotropy) {
    const V3 adir = ld3(row, kAnisoDir);
    const V3 t_rot = normalize(adir.x * tangent + adir.y * bitangent + adir.z * normal);
    const V3 b_rot = normalize(cross(normal, t_rot));
    if (m.anisotropy > 0.0f) {
      tangent = t_rot;
      bitangent = b_rot;
    }
  }
  m.transmission = row[kTransmission];
  m.thinwalled = row[kThickness] == 0.0f;
  m.clearcoat = row[kCcF];
  m.cc_rough = cmax(row[kCcRough], 0.001f);

  // ---- integrator clauses (pathtrace.glsl:258-296) ------------------------
  V3 radiance = L.radiance, throughput = L.throughput, absorption = L.absorption;
  bool alive = L.active && !miss;
  const bool unlit_l = alive && unlit;
  radiance = radiance + (unlit_l ? m.albedo * throughput : splat(0.0f));
  alive = alive && !unlit_l;
  if (dot(normal, ffnormal) > 0.0f) absorption = splat(0.0f);
  radiance = radiance + (alive ? emission * throughput : splat(0.0f));
  const float tc = cmin(hit_t, 1e30f);
  throughput = throughput * (alive ? V3{expf(-absorption.x * tc), expf(-absorption.y * tc),
                                        expf(-absorption.z * tc)}
                                   : splat(1.0f));

  // ---- NEE eval (pathtrace.glsl:97-188) -----------------------------------
  const V3 v = -d;
  const V3 ldir = L.ldir, lcontrib = L.lcontrib;
  const float ldist = L.ldist, lpdf = L.lpdf;
  V3 f_l;
  float pdf_l;
  pbr_eval(flags, m, v, ffnormal, ldir, tangent, bitangent, eta, f_l, pdf_l);
  const float t2mis = lpdf * lpdf;
  const float ph = t2mis / (pdf_l * pdf_l + t2mis);
  const float mis = L.use_light ? 1.0f : cmax(ph, 0.0f);
  const float cos_l = fabsf(dot(ldir, ffnormal));
  const float lpdf_c = cmax(lpdf, 1e-9f);
  V3 nee = V3{mis * f_l.x * cos_l * lcontrib.x / lpdf_c, mis * f_l.y * cos_l * lcontrib.y / lpdf_c,
              mis * f_l.z * cos_l * lcontrib.z / lpdf_c};
  const bool visible = alive && (dot(ldir, ffnormal) > 0.0f);
  nee = nee * throughput;
  radiance = radiance + (miss ? L.envmiss * throughput : splat(0.0f));

  // ---- BSDF sample (pbr_gltf.glsl:439-554) --------------------------------
  V3 f_b, l_b;
  float pdf_b;
  pbr_sample(flags, m, v, ffnormal, normal, tangent, bitangent, eta, L.draws, f_b, l_b, pdf_b);
  const bool entering = dot(ffnormal, l_b) < 0.0f;
  if (alive && entering) {
    const float dist = cmax(row[kAttenDist], 1e-9f);
    const V3 ac = ld3(row, kAttenColor);
    absorption = V3{-logf(clip(ac.x, 1e-6f, 1.0f)) / dist, -logf(clip(ac.y, 1e-6f, 1.0f)) / dist,
                    -logf(clip(ac.z, 1e-6f, 1.0f)) / dist};
  }
  const bool pdf_ok = pdf_b > 0.0f;
  if (alive && pdf_ok) {
    const float c = fabsf(dot(ffnormal, l_b));
    const float pb = cmax(pdf_b, 1e-20f);
    throughput = V3{throughput.x * f_b.x * c / pb, throughput.y * f_b.y * c / pb,
                    throughput.z * f_b.z * c / pb};
  }
  alive = alive && pdf_ok;
  const float max_thr = nmax(nmax(throughput.x, throughput.y), throughput.z);
  LaneOut o;
  o.rr_pcont = cmin(max_thr * eta * eta + 0.001f, 0.95f);
  const V3 off_n = dot(l_b, ffnormal) > 0.0f ? ffnormal : -ffnormal;
  o.new_origin = alive ? V3{offset1(position.x, off_n.x), offset1(position.y, off_n.y),
                            offset1(position.z, off_n.z)}
                       : L.origin;
  o.new_dir = alive ? l_b : d;
  o.radiance = radiance;
  o.throughput = throughput;
  o.absorption = absorption;
  o.nee = nee;
  o.ldir = ldir;
  o.ldist = ldist;
  o.pdf_b = pdf_b;
  o.alive = alive;
  o.visible = visible;
  return o;
}

// ---------------------------------------------------------------------------
// The body alone on gathered inputs (vkrt_shade).
//
// A block's lanes are one contiguous range of srow, aux and taps, so each
// lane's inputs can be copied whole into shared memory before the body runs
// (the stage cannot: its rows are gathered by triangle). Read in place, each
// of a lane's ~200 scalar loads would touch 32 lines 512 bytes apart a warp
// instruction. Each thread asks the Tensor Memory Accelerator for its own
// lane's three runs (the shade row's first kRowWords words, which are all
// the body reads of it; aux; the taps as their int bits) as 1-D bulk copies
// into the lane's record, completing on the block's mbarrier: the copies
// take no registers and no issue slots, so the block's wait overlaps the
// other resident blocks' bodies. A record is a whole number of 16-byte
// pieces (the copies' granule), an odd number of them, so that lane i's word
// k lies in bank (4 * i * pieces + k) mod 32: a warp's reads of one word meet
// each bank at most 4 times, the least that 16-byte records allow. The
// outputs go into the lane's own record once its body is done and leave
// coalesced. What bounds it then is the body's arithmetic at the occupancy
// the records leave: 44 / 50 KB a block of 64 lanes, 5 / 4 blocks an SM
// (single-level / instanced). Copying with the threads themselves (16-byte
// loads, 4-byte stores into records of odd length: no bank conflict at all)
// measured slower on the H100: the copy's instructions and waits did not
// overlap the bodies. Copying only the seven runs of the row that the body
// reads (more lanes an SM, three times the copies) measured 16% slower
// single-level and 5% faster instanced.
// ---------------------------------------------------------------------------

constexpr int kAuxInst = 48;                 // first instance lane of aux
constexpr int kBodyLanes = 64;               // lanes (threads) a block
constexpr int kRowWords = kCcRough + 1;      // 104: the row's words the body reads
constexpr int kOutWords = 24;                // out_vec's words a lane
static_assert(kRowWords % 4 == 0, "the staged row is whole 16-byte pieces");

template <bool INST>
struct BodyRecord {
  static constexpr int kAux = INST ? kAuxInst + 24 : kAuxInst;  // aux words
  static constexpr int kTaps = kRowWords + kAux;                // the first tap word
  static constexpr int kBytes = (kTaps + 16) * 4;               // copied a lane
  static constexpr int kWords = ((kTaps + 16) / 4 | 1) * 4;     // an odd number of pieces
  static_assert(kWords % 8 == 4 && kWords > kOutWords, "odd pieces that hold the outputs");
};

// The shared-memory address of p, for the bulk copy and barrier operands.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
#ifdef __CUDA_ARCH__
  return (uint32_t)__cvta_generic_to_shared(p);
#else
  return 0;
#endif
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on mbarrier `bar`. The
// host build copies at once.
__device__ __forceinline__ void bulk_load(float* dst, const void* src, int bytes, uint64_t* bar) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
#else
  memcpy(dst, src, bytes);
  (void)bar;
#endif
}

// Copies the block's m lanes' inputs into their records: thread i < m asks
// for lane i's three runs and arrives expecting their bytes, every other
// thread arrives; then every thread waits for the barrier's phase 0.
template <bool INST>
__device__ __forceinline__ void stage_body_inputs(float* smem, uint64_t* bar, const float* srow,
                                                  const float* aux, const int32_t* taps,
                                                  int m) {
  using B = BodyRecord<INST>;
  const int i = threadIdx.x;
#ifdef __CUDA_ARCH__
  if (i == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"((int)blockDim.x)
                 : "memory");
    // the initialised barrier visible to the bulk copies' async proxy
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (i < m)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
                 "r"(B::kBytes)
                 : "memory");
  else
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
#endif
  if (i < m) {
    float* rec = smem + i * B::kWords;
    bulk_load(rec, srow + (int64_t)i * 128, kRowWords * 4, bar);
    bulk_load(rec + kRowWords, aux + (int64_t)i * B::kAux, B::kAux * 4, bar);
    bulk_load(rec + B::kTaps, taps + (int64_t)i * 16, 64, bar);
  }
#ifdef __CUDA_ARCH__
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.b32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
#endif
}

template <bool INST>
__global__ void __launch_bounds__(kBodyLanes) shade_kernel(const float* __restrict__ srow,
                                                           const int32_t* __restrict__ taps,
                                                           const float* __restrict__ aux,
                                                           int64_t n, int flags,
                                                           float* __restrict__ out_vec,
                                                           uint8_t* __restrict__ alive_out,
                                                           uint8_t* __restrict__ visible_out) {
  using B = BodyRecord<INST>;
  extern __shared__ float smem[];
  __shared__ uint64_t bar;
  const int64_t base = (int64_t)blockIdx.x * blockDim.x;
  const int m = (int)imin(n - base, (int64_t)blockDim.x);  // the block's lanes
  stage_body_inputs<INST>(smem, &bar, srow + base * 128, aux + base * B::kAux, taps + base * 16,
                          m);

  const int i = threadIdx.x;
  float* rec = smem + i * B::kWords;
  if (i < m) {
    const SharedRow row{rec}, a{rec + kRowWords};
    LaneIn L;
    L.d = ld3(a, 10);
    L.hit_u = a[13];
    L.hit_v = a[14];
    L.hit_t = a[15];
    L.active = a[16] > 0.5f;
    L.miss = a[17] > 0.5f;
    L.origin = ld3(a, 18);
    L.ldir = ld3(a, 21);
    L.lcontrib = ld3(a, 24);
    L.ldist = a[27];
    L.lpdf = a[28];
    L.use_light = a[29] > 0.5f;
    L.envmiss = ld3(a, 30);
    L.radiance = ld3(a, 33);
    L.throughput = ld3(a, 36);
    L.absorption = ld3(a, 39);
#pragma unroll
    for (int k = 0; k < 6; ++k) L.draws[k] = a[42 + k];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(flags & (1 << k))) continue;  // kBaseTex .. kEmissiveTex
      L.gxy[2 * k] = a[2 * k];
      L.gxy[2 * k + 1] = a[2 * k + 1];
#pragma unroll
      for (int c = 0; c < 4; ++c) L.taps[4 * k + c] = __float_as_int(rec[B::kTaps + 4 * k + c]);
    }
    const LaneOut o = shade_body<INST>(flags, row, L, SharedRow{rec + kRowWords + kAuxInst},
                                       SharedRow{rec + kRowWords + kAuxInst + 12});
    // The outputs into the lane's own record: its body reads it no more.
    const V3 vecs[6] = {o.new_origin, o.new_dir, o.radiance, o.throughput, o.absorption, o.nee};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      rec[3 * k] = vecs[k].x;
      rec[3 * k + 1] = vecs[k].y;
      rec[3 * k + 2] = vecs[k].z;
    }
    rec[18] = o.ldir.x;
    rec[19] = o.ldir.y;
    rec[20] = o.ldir.z;
    rec[21] = o.ldist;
    rec[22] = o.rr_pcont;
    rec[23] = o.pdf_b;
    alive_out[base + i] = o.alive ? 1 : 0;
    visible_out[base + i] = o.visible ? 1 : 0;
  }
  __syncthreads();
  float* out = out_vec + base * kOutWords;
  for (int q = threadIdx.x; q < m * kOutWords; q += blockDim.x)
    out[q] = smem[q / kOutWords * B::kWords + q % kOutWords];
}

// Shared-memory bytes of a shade_kernel<INST> block.
template <bool INST>
constexpr size_t body_smem() {
  return (size_t)kBodyLanes * BodyRecord<INST>::kWords * sizeof(float);
}

template <bool INST>
cudaError_t launch_body(const float* srow, const int32_t* taps, const float* aux, int64_t n,
                        int flags, float* out_vec, uint8_t* alive, uint8_t* visible,
                        cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      shade_kernel<INST>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)body_smem<INST>());
  if (e != cudaSuccess) return e;
  const int64_t blocks = (n + kBodyLanes - 1) / kBodyLanes;
  shade_kernel<INST><<<(unsigned)blocks, kBodyLanes, body_smem<INST>(), s>>>(
      srow, taps, aux, n, flags, out_vec, alive, visible);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The whole stage (vkrt_shade_stage).
// ---------------------------------------------------------------------------

// ops/rng.py::rand: one PCG-RXS-M-XS step, bits -> [0, 1).
__device__ __forceinline__ float rand1(uint32_t& state) {
  const uint32_t prev = state * 747796405u + 2891336453u;
  const uint32_t shift = (prev >> 28) + 4u;
  const uint32_t word = ((prev >> shift) ^ prev) * 277803737u;
  state = prev;
  const uint32_t bits = (word >> 22) ^ word;
  return (float)(bits >> 9) * (1.0f / 8388608.0f);
}

// integrator/shade.py::_mip_lanes: the nearest mip level's placement.
__device__ __forceinline__ void mip_lanes(const Row& row, int o, float lod, int64_t& ox,
                                          int64_t& oy, int64_t& w, int64_t& h) {
  const int64_t w0 = imax(trunc64(row[o + 3]), 1);
  const int64_t h0 = imax(trunc64(row[o + 4]), 1);
  const int64_t ox0 = trunc64(row[o + 1]);
  const int64_t oy0 = trunc64(row[o + 2]);
  const int64_t mx = trunc64(row[o + 6]);
  const int64_t my = trunc64(row[o + 7]);
  const float wf = (float)w0, hf = (float)h0;
  const int64_t n_lvl = trunc64(floorf(log2f(cmax(nmin(wf, hf), 1.0f)) + 1e-4f));
  const float t00 = row[kUvT], t01 = row[kUvT + 1], t10 = row[kUvT + 2], t11 = row[kUvT + 3];
  const float det = fabsf(t00 * t11 - t01 * t10);
  const float lam = lod + 0.5f * log2f(wf * hf) + 0.5f * log2f(cmax(det, 1e-20f));
  int64_t lvl = imin(imax(trunc64(rintf(lam)), 0), n_lvl);
  if (!(mx >= 0)) lvl = 0;
  if (lvl == 0) {
    ox = ox0;
    oy = oy0;
    w = w0;
    h = h0;
  } else {
    ox = mx + w0 - (w0 >> imax(lvl - 1, 0));
    oy = my;
    w = imax(w0 >> lvl, 1);
    h = imax(h0 >> lvl, 1);
  }
}

// integrator/shade.py::_axis_base: one bilinear axis as (base texel,
// weight) per wrap mode (0 REPEAT, 1 CLAMP, 2 MIRROR).
__device__ __forceinline__ void axis_base(float p, int64_t size, int64_t mode, int64_t& b,
                                          float& g) {
  const float sf = (float)size;
  const int64_t i0 = trunc64(floorf(p));
  const float f = p - (float)i0;
  if (mode == 0) {
    b = floormod(i0, size);
    g = f;
  } else if (mode == 1) {
    const float pc = nmin(cmax(p, 0.0f), sf - 1.0f);
    b = imin(imax(trunc64(floorf(pc)), 0), imax(size - 2, 0));
    g = pc - (float)b;
  } else {
    const int64_t m2 = floormod(i0, 2 * size);
    const bool asc = m2 < size;
    const int64_t xw = asc ? m2 : 2 * size - 1 - m2;
    b = asc ? xw : imax(xw - 1, 0);
    g = asc ? f : (xw > 0 ? 1.0f - f : 0.0f);
  }
}

// shade_fused.py::_tex_index_weights: texture k's footprint row and weights.
__device__ __forceinline__ int64_t tex_index(const Row& row, int k, float uv_x, float uv_y,
                                             bool mip, float lod, const StageArgs& a, float& gx,
                                             float& gy) {
  const int o = kTexBase + 8 * k;
  int64_t ox, oy, w, h;
  if (mip) {
    mip_lanes(row, o, lod, ox, oy, w, h);
  } else {
    ox = trunc64(row[o + 1]);
    oy = trunc64(row[o + 2]);
    w = imax(trunc64(row[o + 3]), 1);
    h = imax(trunc64(row[o + 4]), 1);
  }
  const int64_t wrap = trunc64(row[o + 5]);
  const float px = uv_x * (float)w - 0.5f;
  const float py = uv_y * (float)h - 0.5f;
  int64_t bx, by;
  axis_base(px, w, floordiv(wrap, 3), bx, gx);
  axis_base(py, h, floormod(wrap, 3), by, gy);
  return imin(imax((oy + by) * a.atlas_w + (ox + bx), 0), a.n_tap - 1);
}

// ops/math.py::spherical_uv.
__device__ __forceinline__ void spherical_uv(V3 v, float& u, float& w) {
  const float gamma = asinf(-clip(v.y, -1.0f, 1.0f));
  const float theta = atan2f(v.z, v.x);
  u = theta * kHalfInvPi + 0.5f;
  w = div_scalar(gamma, kMathPi) + 0.5f;
}

// ops/env.py::_bilinear_packed: U wraps, V clamps.
__device__ __forceinline__ V3 env_bilinear(const StageArgs& a, float u, float v) {
  const float px = u * (float)a.env_w - 0.5f;
  const float py = v * (float)a.env_h - 0.5f;
  const int64_t x0 = trunc64(floorf(px));
  const int64_t y0 = trunc64(floorf(py));
  const float fx = px - (float)x0;
  float fy = py - (float)y0;
  const float* r =
      a.env_rows + (imin(imax(y0, 0), a.env_h - 1) * a.env_w + floormod(x0, a.env_w)) * 16;
  const V3 c00 = ldg3(r), c10 = ldg3(r + 3), c01 = ldg3(r + 6), c11 = ldg3(r + 9);
  if (y0 < 0) fy = 0.0f;
  const V3 top = c00 + (c10 - c00) * fx;
  const V3 bot = c01 + (c11 - c01) * fx;
  return top + (bot - top) * fy;
}

// ops/env.py::environment_pdf without the sun cone.
__device__ __forceinline__ float env_alias_pdf(const StageArgs& a, V3 d) {
  float u, v;
  spherical_uv(d, u, v);
  const int64_t x = imin(imax(trunc64(u * (float)a.env_w), 0), a.env_w - 1);
  const int64_t y = imin(imax(trunc64(v * (float)a.env_h), 0), a.env_h - 1);
  return __ldg(a.env_rows + (y * a.env_w + x) * 16 + 14);
}

__device__ __forceinline__ V3 sun3(const float* s, int k) { return ldg3(s + k); }

// ops/sunsky.py::sun_disk_at from the packed constants.
__device__ V3 sun_disk_at(const float* s, V3 dir) {
  V3 d = __ldg(s + kSYUp) != 0.0f ? V3{dir.x, dir.z, dir.y} : dir;
  const float hh = __ldg(s + kSHh);
  if (hh != 0.0f) {
    const V3 b{d.x, d.y, d.z - hh};
    const float l = sqrtf(dot(b, b));
    d = V3{b.x / l, b.y / l, b.z / l};
  }
  const float downness = d.z;
  const float cosang = clip(dot(d, sun3(s, kSDir0)), -1.0f, 1.0f);
  const float sun_angle = acosf(cosang);
  const bool in_disk = (sun_angle < __ldg(s + kSRadius)) && __ldg(s + kSDiskOk) != 0.0f;
  const float sf = (1.0f - sun_angle / __ldg(s + kSRadiusC)) * 10.0f;
  const float t = clip((sf - 8.5f) / __ldg(s + kSSsDen), 0.0f, 1.0f);
  const float disk_term =
      smoothstep01(t) * 100.0f * __ldg(s + kSIntensity) * __ldg(s + kSDiskScale);
  const V3 color = downness > 0.0f ? sun3(s, kSColorUp) : sun3(s, kSColorDown);
  V3 delta = in_disk ? color * disk_term : splat(0.0f);
  delta = delta * sun3(s, kSRgbScale);
  const float hor_blur = __ldg(s + kSHorBlur);
  const float dness = smoothstep01(clip(-downness / __ldg(s + kSHorBlurC), 0.0f, 1.0f));
  const float h_scale = downness <= 0.0f ? (hor_blur > 0.0f ? 1.0f - dness : 0.0f) : 1.0f;
  delta = delta * h_scale;
  // _color_tweak
  const float inten = 0.2126f * delta.x + 0.7152f * delta.y + 0.0722f * delta.z;
  const float sat = __ldg(s + kSSat), oms = __ldg(s + kSOneMinusSat);
  const V3 desat = delta * sat + splat(inten * oms);
  delta = (sat <= 0.0f ? splat(inten) : desat) * sun3(s, kSTweak);
  delta = delta * kMathPi;
  return __ldg(s + kSDark) != 0.0f ? splat(0.0f) : delta;
}

// ops/env.py::environment_pdf, with the sun cone's mixture under kSunDisk.
__device__ __forceinline__ float env_pdf(const StageArgs& a, V3 d) {
  float pdf = env_alias_pdf(a, d);
  if (a.flags & kSunDisk) {
    const float* s = a.sun;
    const float p_cone =
        dot(d, sun3(s, kSAxis)) >= __ldg(s + kSCosLo) ? __ldg(s + kSInvSolid) : 0.0f;
    pdf = __ldg(s + kSOneMinusQ) * pdf + __ldg(s + kSQ) * p_cone;
  }
  return pdf;
}

// ops/env.py::environment_sample: (radiance, dir, pdf), no hdr multiplier.
__device__ void env_sample_alias(const StageArgs& a, float xi0, float xi1, float xi2, V3& rad,
                                 V3& dir, float& pdf) {
  const int64_t size = a.env_h * a.env_w;
  const int64_t idx = imin(trunc64(xi0 * (float)size), size - 1);
  const float* arow = a.env_rows + idx * 16;
  const float q = __ldg(arow + 12);
  const int64_t alias = trunc64(__ldg(arow + 13));
  const bool take_self = xi1 < q;
  const int64_t env_idx = take_self ? idx : alias;
  const float xi_y = take_self ? xi1 / cmax(q, 1e-12f) : (xi1 - q) / cmax(1.0f - q, 1e-12f);
  pdf = take_self ? __ldg(arow + 14) : __ldg(arow + 15);
  const float px = (float)floormod(env_idx, a.env_w);
  const float py = (float)floordiv(env_idx, a.env_w);
  const float u = div_scalar(px + xi_y, (float)a.env_w);
  const float phi = u * kMathTwoPi - kMathPi;
  const float theta0 = py * a.env_step;
  const float cos_theta = cosf(theta0) * (1.0f - xi2) + cosf(theta0 + a.env_step) * xi2;
  const float theta = acosf(clip(cos_theta, -1.0f, 1.0f));
  const float sin_theta = sinf(theta);
  const float v = theta * kMathInvPi;
  dir = V3{cosf(phi) * sin_theta, cos_theta, sinf(phi) * sin_theta};
  rad = env_bilinear(a, u, v);
}

// ops/env.py::sample_env_mixture: the alias sample or the sun cone.
__device__ void env_sample_mixture(const StageArgs& a, float u_mix, float xi0, float xi1,
                                   float xi2, V3& rad, V3& dir, float& pdf) {
  const float* s = a.sun;
  const float q = __ldg(s + kSQ);
  const V3 axis = sun3(s, kSAxis);
  const bool take_cone = u_mix < q;
  float p_alias_at;
  if (take_cone) {
    const float cz = 1.0f - xi1 * __ldg(s + kSOneMinusCos);
    const float sz = sqrtf(cmax(1.0f - cz * cz, 0.0f));
    const float phi = xi2 * kMathTwoPi;
    const float ca = sz * cosf(phi), sb = sz * sinf(phi);
    const V3 c = sun3(s, kSConeT) * ca + sun3(s, kSConeB) * sb + axis * cz;
    dir = normalize(c);
    p_alias_at = env_alias_pdf(a, dir);
    float u, v;
    spherical_uv(dir, u, v);
    rad = env_bilinear(a, u, v);
  } else {
    env_sample_alias(a, xi0, xi1, xi2, rad, dir, p_alias_at);
  }
  const float p_cone_at =
      dot(dir, axis) >= __ldg(s + kSCosLo) ? __ldg(s + kSInvSolid) : 0.0f;
  pdf = __ldg(s + kSOneMinusQ) * p_alias_at + q * p_cone_at;
  rad = rad + sun_disk_at(s, dir);
}

// ops/lights.py::sample_light at `position`: (intensity, dir, dist).
__device__ void sample_light(const StageArgs& a, int64_t li, V3 position, V3& intensity,
                             V3& ldir, float& ldist) {
  const float* l = a.lights + li * kLightW;
  const int64_t ltype = trunc64(__ldg(l + kLType));
  const bool is_dir = ltype == kLightDirectional;
  const V3 ldirection = ldg3(l + kLDir);
  const V3 ptl = is_dir ? -ldirection : ldg3(l + kLPos) - position;
  float dist = sqrtf(cmax(dot(ptl, ptl), 1e-20f));
  float r_att = 1.0f;
  if (is_dir) {
    dist = 1e32f;
  } else {
    // range_attenuation
    const float range = __ldg(l + kLRange);
    const float d2 = cmax(dist * dist, 1e-12f);
    const float win = clip(1.0f - powf(dist / cmax(range, 1e-9f), 4.0f), 0.0f, 1.0f);
    r_att = range <= 0.0f ? 1.0f / d2 : win / d2;
  }
  float s_att = 1.0f;
  if (ltype == kLightSpot) {
    // spot_attenuation
    const float outer = __ldg(l + kLOuter), inner = __ldg(l + kLInner);
    const float actual_cos = dot(normalize(ldirection), normalize(-ptl));
    const float ramp = smoothstep01(clip((actual_cos - outer) / (inner - outer), 0.0f, 1.0f));
    const float full = actual_cos < inner ? ramp : 1.0f;
    s_att = actual_cos > outer ? full : 0.0f;
  }
  const float k = r_att * s_att * __ldg(l + kLIntensity);
  intensity = k * ldg3(l + kLColor);
  ldir = normalize(ptl);
  ldist = dist;
}

// The stage for one lane: draws, row, path length and LOD, taps, light and
// env samples, miss radiance with MIS, then the body.
template <bool INST>
__device__ __forceinline__ void stage_lane(const StageArgs& a, int64_t i, int64_t tri,
                                           const Row& row) {
  const int flags = a.flags;
  const bool active = a.active == nullptr || a.active[i] != 0;
  const bool miss = active && tri < 0;
  Row o2w{nullptr}, w2o{nullptr};
  if (INST) {
    const int64_t ii = imax(a.inst[i], 0);
    o2w = Row{a.o2w + ii * 12};
    w2o = Row{a.w2o + ii * 12};
  }

  // ---- RNG draws, in the unfused stage's order ----------------------------
  uint32_t state = (uint32_t)a.seed[i];
  LaneIn L;
  const float u_sel = rand1(state);
  const float u_li = rand1(state);
  const float u_mix = (flags & kSunDisk) ? rand1(state) : 0.0f;
  const float xi0 = rand1(state), xi1 = rand1(state), xi2 = rand1(state);
#pragma unroll
  for (int k = 0; k < 6; ++k) L.draws[k] = rand1(state);

  // ---- the uv transform ---------------------------------------------------
  const float hu = a.u[i], hv = a.v[i], ht = a.t[i];
  const float wb = 1.0f - hu - hv;
  const float su = bary(wb, hu, hv, row[22], row[24], row[26]);
  const float sv = bary(wb, hu, hv, row[23], row[25], row[27]);
  const float uv_x = su * row[kUvT] + sv * row[kUvT + 2] + row[kUvT + 4];
  const float uv_y = su * row[kUvT + 1] + sv * row[kUvT + 3] + row[kUvT + 5];

  // ---- the path length and the ray-cone LOD (path.py::cone_lod) ----------
  const float tdist = a.tdist[i] + (tri >= 0 ? cmin(ht, 1e30f) : 0.0f);
  a.tdist_out[i] = tdist;
  float lod = 0.0f;
  if (flags & kMip) {
    const V3 p0 = ld3(row, 0);
    V3 e1 = ld3(row, 3) - p0, e2 = ld3(row, 6) - p0;
    if (INST) {
      e1 = m3v(o2w, e1);
      e2 = m3v(o2w, e2);
    }
    const V3 c = cross(e1, e2);
    const float area_w = sqrtf(dot(c, c));
    const float u1x = row[24] - row[22], u1y = row[25] - row[23];
    const float u2x = row[26] - row[22], u2y = row[27] - row[23];
    const float area_uv = fabsf(u1x * u2y - u1y * u2x);
    const float uv_density = 0.5f * log2f(cmax(area_uv, 1e-20f) / cmax(area_w, 1e-20f));
    lod = uv_density + log2f(cmax(a.spread * tdist, 1e-20f));
  }

  // ---- the four footprint taps --------------------------------------------
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!(flags & (1 << k))) continue;  // kBaseTex .. kEmissiveTex
    const int64_t flat =
        tex_index(row, k, uv_x, uv_y, (flags & kMip) != 0, lod, a, L.gxy[2 * k], L.gxy[2 * k + 1]);
    const int4 tr = __ldg(reinterpret_cast<const int4*>(a.tap_rows) + flat);
    L.taps[4 * k] = tr.x;
    L.taps[4 * k + 1] = tr.y;
    L.taps[4 * k + 2] = tr.z;
    L.taps[4 * k + 3] = tr.w;
  }

  // ---- light or environment NEE sample (the other is never read) ---------
  L.use_light = a.n_lights > 0 && u_sel <= a.p_select;
  if (L.use_light) {
    const int64_t n_l = imax(a.n_lights, 1);
    const int64_t li = imin(trunc64(u_li * (float)n_l), n_l - 1);
    const V3 position = hit_position<INST>(row, hu, hv, o2w);
    sample_light(a, li, position, L.lcontrib, L.ldir, L.ldist);
    L.lpdf = (flags & kFullMis) ? a.p_light_n : 1.0f;  // nee_strategy_pdf
  } else {
    V3 e_rad;
    float e_pdf;
    if (flags & kSunDisk)
      env_sample_mixture(a, u_mix, xi0, xi1, xi2, e_rad, L.ldir, e_pdf);
    else
      env_sample_alias(a, xi0, xi1, xi2, e_rad, L.ldir, e_pdf);
    L.lcontrib = e_rad * a.hdr_mult;
    L.ldist = 1e32f;
    L.lpdf = (flags & kFullMis) ? a.p_env * e_pdf : e_pdf;
  }

  // ---- the lane state; the environment on a miss --------------------------
  const float* o = a.origin + i * 3;
  const float* dd = a.direction + i * 3;
  L.d = V3{dd[0], dd[1], dd[2]};
  L.origin = V3{o[0], o[1], o[2]};
  L.radiance = ldg3(a.radiance + i * 3);
  L.throughput = ldg3(a.throughput + i * 3);
  L.absorption = ldg3(a.absorption + i * 3);
  L.hit_u = hu;
  L.hit_v = hv;
  L.hit_t = ht;
  L.active = active;
  L.miss = miss;
  L.envmiss = splat(0.0f);
  if (miss) {  // env_radiance (and env_bsdf_mis_weight): read only on a miss
    float u, v;
    spherical_uv(L.d, u, v);
    V3 env = env_bilinear(a, u, v);
    if (flags & kSunDisk) env = env + sun_disk_at(a.sun, L.d);
    env = env * a.hdr_mult;
    if (flags & kFullMis) {
      const float bp = a.bsdf_pdf[i];
      const float pdf_env = env_pdf(a, L.d) * a.p_env;
      const float t = bp * bp;
      const float w_env = bp > 0.0f ? cmax(t / (pdf_env * pdf_env + t), 0.0f) : 1.0f;
      env = env * w_env;
    }
    L.envmiss = env;
  }

  const LaneOut r = shade_body<INST>(flags, row, L, o2w, w2o);
  const V3 vec3s[7] = {r.new_origin, r.new_dir, r.radiance, r.throughput, r.absorption, r.nee,
                       r.ldir};
  float* outs[7] = {a.new_origin, a.new_dir, a.radiance_out, a.throughput_out, a.absorption_out,
                    a.nee, a.light_dir};
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    outs[k][3 * i] = vec3s[k].x;
    outs[k][3 * i + 1] = vec3s[k].y;
    outs[k][3 * i + 2] = vec3s[k].z;
  }
  a.light_dist[i] = r.ldist;
  a.rr_pcont[i] = r.rr_pcont;
  a.pdf_b[i] = r.pdf_b;
  a.alive[i] = r.alive ? 1 : 0;
  a.visible[i] = r.visible ? 1 : 0;
  a.miss[i] = miss ? 1 : 0;
  a.seed_out[i] = (int64_t)state;
}

constexpr int kStageThreads = 128;

template <bool INST>
__global__ void __launch_bounds__(kStageThreads) shade_stage_kernel(const StageArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int64_t tri = a.tri[i];
  stage_lane<INST>(a, i, tri, Row{a.shade_rows + imax(tri, 0) * 128});
}

template <bool INST>
cudaError_t launch_stage(const StageArgs& a, cudaStream_t s) {
  const int64_t blocks = (a.n + kStageThreads - 1) / kStageThreads;
  shade_stage_kernel<INST><<<(unsigned)blocks, kStageThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// flags: bit 0 base texture, 1 metallic-roughness, 2 normal map, 3 emissive,
// 4 anisotropy, 5 full MIS, 6 instanced (aux of 72 lanes, else 48).
// srow, taps and aux must be 16-byte aligned: cudaErrorInvalidValue, and no
// launch, otherwise. Returns cudaGetLastError() after the launch.
int vkrt_shade(const float* srow, const int32_t* taps, const float* aux, int64_t n, int flags,
               float* out_vec, uint8_t* alive, uint8_t* visible, void* stream) {
  if (n <= 0) return 0;
  if (((uintptr_t)srow | (uintptr_t)taps | (uintptr_t)aux) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (flags & kInstanced)
    return (int)launch_body<true>(srow, taps, aux, n, flags, out_vec, alive, visible, s);
  return (int)launch_body<false>(srow, taps, aux, n, flags, out_vec, alive, visible, s);
}

// Dynamic shared-memory bytes of a vkrt_shade block (instanced or not).
int vkrt_shade_body_smem(int instanced) {
  return (int)(instanced ? body_smem<true>() : body_smem<false>());
}

// vkrt_shade blocks (instanced or not) that reside on one SM, or -1.
int vkrt_shade_body_occupancy(int instanced) {
  int blocks = 0;
  const cudaError_t e =
      instanced
          ? cudaFuncSetAttribute(shade_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)body_smem<true>())
          : cudaFuncSetAttribute(shade_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)body_smem<false>());
  if (e != cudaSuccess) return -1;
  const cudaError_t o =
      instanced ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, shade_kernel<true>,
                                                                kBodyLanes, body_smem<true>())
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, shade_kernel<false>,
                                                                kBodyLanes, body_smem<false>());
  return o == cudaSuccess ? blocks : -1;
}

// The whole stage; flags as vkrt_shade's, and bit 7 the sun disk, 8 the mip
// LOD. Returns cudaGetLastError() after the launch.
int vkrt_shade_stage(const StageArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (a->flags & kInstanced) return (int)launch_stage<true>(*a, s);
  return (int)launch_stage<false>(*a, s);
}

// sizeof(StageArgs), for the wrapper's check of its ctypes layout.
int vkrt_shade_stage_args_size() { return (int)sizeof(StageArgs); }

}  // extern "C"
