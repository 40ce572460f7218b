// Fused shading stage of one pooled-wavefront bounce: one CUDA thread per
// lane, everything between the bounce's two traversals in one launch.
//
// Replaces the TPU kernel vk_raytrace_tpu/integrator/shade_fused.py
// (_make_kernel, launched by shade_bounce_fused): shade-state
// reconstruction, material resolve from 4 footprint texture taps, NEE
// evaluation with MIS, the glTF PBR BSDF sample, absorption, the
// Russian-roulette continuation probability and the next ray.
//
// Inputs per lane (gathered by the torch prologue,
// integrator/shade_fused.py::shade_inputs):
//   srow (R, 128) f32  merged shade+material row (integrator/shade.py)
//   taps (R, 16)  i32  4 textures x RGBA8 words (c00 c10 c01 c11)
//   aux  (R, 48)  f32  gxy 8 | uv 2 | dir3 u v t active miss | origin 3 |
//                      ldir3 lcontrib3 ldist lpdf use_light envmiss3 |
//                      radiance3 throughput3 absorption3 |
//                      prob r1 r2 u_trans u_reflect u_lobe
//        (R, 72)       the same, then the lane's instance rows in an
//                      instanced scene: object-to-world 3x4, then
//                      world-to-object 3x4, row-major (the TPU kernel's
//                      instanced variant, shade_fused.py:64-72, 367-400)
// Outputs: out_vec (R, 24) f32 = new_origin3 new_dir3 radiance3
//   throughput3 absorption3 nee3 ldir3 ldist rr_pcont pdf_b, and the masks
//   alive, visible (R,) u8.
//
// What bounds it on this card: device memory. A lane reads 768 bytes and
// writes 98 and does a few thousand float operations, well under the
// card's ratio of operations to bytes. This first version reads its
// inputs with plain per-thread loads (served by L1 after the first touch
// of a row) and keeps every intermediate in registers; the static flags
// are a kernel argument whose branches are uniform across the grid, except
// the instanced layout, a template parameter (the instanced variant reads
// 24 more aux lanes, 96 bytes per lane, and brings the hit to world space
// before Gram-Schmidt; the single-level kernel compiles without it).
//
// Numerics follow the plain torch version (_shade_plain) operation by
// operation: -fmad=false, IEEE division and square root, libdevice
// expf/logf/sinf/cosf, NaN-propagating clamps like torch.clamp, and dot
// products summed x, y, z in that order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPi = (float)3.14159265358979;
constexpr float kInvPi = (float)(1.0 / 3.14159265358979);
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979);
constexpr float kInv255 = (float)(1.0 / 255.0);
constexpr float kF04 = 0.04f;
constexpr float kF096 = 1.0f - 0.04f;

// material row offsets inside the merged row (40 + shade.py::_OFFS)
constexpr int kMat = 40;
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
// torch.maximum semantics: NaN if either is NaN.
__device__ __forceinline__ float nmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
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

// Per-vertex normalise of 3 oct-packed directions, interpolate, normalise.
__device__ __forceinline__ V3 vertex_dir(const float* row, int lo, int hi, float w, float u,
                                         float v) {
  V3 p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    V3 q = oct3(__ldg(row + lo + k), __ldg(row + hi + k));
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

// Bilinear blend of texture k's footprint row; 1 where the material has no
// texture in that slot.
__device__ __forceinline__ float4 tap(const int32_t* trow, const float* row, const float* aux,
                                      int k, bool is_srgb) {
  const float gx = __ldg(aux + 2 * k), gy = __ldg(aux + 2 * k + 1);
  const float4 c00 = texel(__ldg(trow + 4 * k)), c10 = texel(__ldg(trow + 4 * k + 1));
  const float4 c01 = texel(__ldg(trow + 4 * k + 2)), c11 = texel(__ldg(trow + 4 * k + 3));
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
  if (__ldg(row + kTexBase + 8 * k) < 0.0f) o = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
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
  return a2 * w2 * w2 * kInvPi;  // a product, as torch divides by a scalar on the card
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
  const float probability = __ldg(draws + 0), r1 = __ldg(draws + 1), r2 = __ldg(draws + 2);
  const float u_trans = __ldg(draws + 3), u_reflect = __ldg(draws + 4), u_lobe = __ldg(draws + 5);
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

__device__ __forceinline__ V3 ld3(const float* p) { return V3{__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }

constexpr int kAuxInst = 48;  // first instance lane of aux

// The 3x3 block of a row-major 3x4 matrix m times v, and its transpose
// times v; sums over j in order 0, 1, 2.
__device__ __forceinline__ V3 m3v(const float* m, V3 v) {
  return V3{__ldg(m) * v.x + __ldg(m + 1) * v.y + __ldg(m + 2) * v.z,
            __ldg(m + 4) * v.x + __ldg(m + 5) * v.y + __ldg(m + 6) * v.z,
            __ldg(m + 8) * v.x + __ldg(m + 9) * v.y + __ldg(m + 10) * v.z};
}

__device__ __forceinline__ V3 m3t_v(const float* m, V3 v) {
  return V3{__ldg(m) * v.x + __ldg(m + 4) * v.y + __ldg(m + 8) * v.z,
            __ldg(m + 1) * v.x + __ldg(m + 5) * v.y + __ldg(m + 9) * v.z,
            __ldg(m + 2) * v.x + __ldg(m + 6) * v.y + __ldg(m + 10) * v.z};
}

// INST: an instanced scene (72-lane aux with the instance rows); a template
// parameter, so the single-level kernel is compiled without the transform.
template <bool INST>
__global__ void __launch_bounds__(128) shade_kernel(const float* __restrict__ srow,
                                                    const int32_t* __restrict__ taps,
                                                    const float* __restrict__ aux, int64_t n,
                                                    int flags, float* __restrict__ out_vec,
                                                    uint8_t* __restrict__ alive_out,
                                                    uint8_t* __restrict__ visible_out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* row = srow + i * 128;
  const int32_t* trow = taps + i * 16;
  const float* a = aux + i * (INST ? kAuxInst + 24 : kAuxInst);

  const V3 d = ld3(a + 10);
  const float hit_u = __ldg(a + 13), hit_v = __ldg(a + 14), hit_t = __ldg(a + 15);
  const bool active = __ldg(a + 16) > 0.5f;
  const bool miss = __ldg(a + 17) > 0.5f;

  // ---- shade state (shade_state.glsl:63-145) ------------------------------
  const float w_b = 1.0f - hit_u - hit_v;
  const V3 p0 = ld3(row + 0), p1 = ld3(row + 3), p2 = ld3(row + 6);
  V3 position = w_b * p0 + hit_u * p1 + hit_v * p2;
  V3 normal = vertex_dir(row, 9, 12, w_b, hit_u, hit_v);
  V3 geom_normal = normalize(cross(p1 - p0, p2 - p0));
  V3 tangent = vertex_dir(row, 15, 18, w_b, hit_u, hit_v);
  if (INST) {
    // Object space to world: position by o2w, normals by w2o transposed
    // (the inverse transpose of o2w), the tangent by o2w.
    const float* o2w = a + kAuxInst;
    const float* w2o = a + kAuxInst + 12;
    position = m3v(o2w, position) + V3{__ldg(o2w + 3), __ldg(o2w + 7), __ldg(o2w + 11)};
    normal = normalize(m3t_v(w2o, normal));
    geom_normal = normalize(m3t_v(w2o, geom_normal));
    tangent = normalize(m3v(o2w, tangent));
  }
  const float handed = __ldg(row + 21);
  tangent = normalize(tangent - dot(tangent, normal) * normal);
  V3 bitangent = cross(normal, tangent) * handed;
  V3 vcol;
  {
    int lo[3], hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = (int)__ldg(row + 28 + k);
      hi[k] = (int)__ldg(row + 31 + k);
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
    const float nscale = __ldg(row + kNormalScale);
    const float4 tn = tap(trow, row, a, 2, false);
    V3 nvec = normalize(V3{tn.x * 2.0f - 1.0f, tn.y * 2.0f - 1.0f, tn.z * 2.0f - 1.0f});
    nvec = nvec * V3{nscale, nscale, 1.0f};
    const V3 mapped = normalize(nvec.x * tangent + nvec.y * bitangent + nvec.z * normal);
    const bool has_nmap = __ldg(row + kTexBase + 16) >= 0.0f;
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
  V3 emission = ld3(row + kEmissive);
  if (flags & kEmissiveTex) {
    const float4 te = tap(trow, row, a, 3, true);
    emission = emission * V3{te.x, te.y, te.z};
  }
  Mat m;
  m.ior = __ldg(row + kIor);
  float ds = (m.ior - 1.0f) / (m.ior + 1.0f);
  const float dielectric_spec = ds * ds;
  const float4 mr =
      (flags & kMrTex) ? tap(trow, row, a, 1, false) : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  float roughness = mr.y * __ldg(row + kRough);
  m.metallic = mr.z * __ldg(row + kMetal);
  const float4 bt =
      (flags & kBaseTex) ? tap(trow, row, a, 0, true) : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  const V3 base = V3{__ldg(row + kBaseFactor) * bt.x, __ldg(row + kBaseFactor + 1) * bt.y,
                     __ldg(row + kBaseFactor + 2) * bt.z};
  m.f0 = splat(dielectric_spec * (1.0f - m.metallic)) + base * m.metallic;
  m.albedo = base * vcol;
  m.roughness = cmax(roughness, 0.001f);
  const float eta = dot(normal, ffnormal) > 0.0f ? 1.0f / m.ior : m.ior;
  const bool unlit = __ldg(row + kUnlit) == 1.0f;
  m.anisotropy = __ldg(row + kAniso);
  if (flags & kAnisotropy) {
    const V3 adir = ld3(row + kAnisoDir);
    const V3 t_rot = normalize(adir.x * tangent + adir.y * bitangent + adir.z * normal);
    const V3 b_rot = normalize(cross(normal, t_rot));
    if (m.anisotropy > 0.0f) {
      tangent = t_rot;
      bitangent = b_rot;
    }
  }
  m.transmission = __ldg(row + kTransmission);
  m.thinwalled = __ldg(row + kThickness) == 0.0f;
  m.clearcoat = __ldg(row + kCcF);
  m.cc_rough = cmax(__ldg(row + kCcRough), 0.001f);

  // ---- integrator clauses (pathtrace.glsl:258-296) ------------------------
  V3 radiance = ld3(a + 33), throughput = ld3(a + 36), absorption = ld3(a + 39);
  bool alive = active && !miss;
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
  const V3 ldir = ld3(a + 21), lcontrib = ld3(a + 24);
  const float ldist = __ldg(a + 27), lpdf = __ldg(a + 28);
  const bool use_light = __ldg(a + 29) > 0.5f;
  const V3 envmiss = ld3(a + 30);
  V3 f_l;
  float pdf_l;
  pbr_eval(flags, m, v, ffnormal, ldir, tangent, bitangent, eta, f_l, pdf_l);
  const float t2mis = lpdf * lpdf;
  const float ph = t2mis / (pdf_l * pdf_l + t2mis);
  const float mis = use_light ? 1.0f : cmax(ph, 0.0f);
  const float cos_l = fabsf(dot(ldir, ffnormal));
  const float lpdf_c = cmax(lpdf, 1e-9f);
  V3 nee = V3{mis * f_l.x * cos_l * lcontrib.x / lpdf_c, mis * f_l.y * cos_l * lcontrib.y / lpdf_c,
              mis * f_l.z * cos_l * lcontrib.z / lpdf_c};
  const bool visible = alive && (dot(ldir, ffnormal) > 0.0f);
  nee = nee * throughput;
  radiance = radiance + (miss ? envmiss * throughput : splat(0.0f));

  // ---- BSDF sample (pbr_gltf.glsl:439-554) --------------------------------
  V3 f_b, l_b;
  float pdf_b;
  pbr_sample(flags, m, v, ffnormal, normal, tangent, bitangent, eta, a + 42, f_b, l_b, pdf_b);
  const bool entering = dot(ffnormal, l_b) < 0.0f;
  if (alive && entering) {
    const float dist = cmax(__ldg(row + kAttenDist), 1e-9f);
    const V3 ac = ld3(row + kAttenColor);
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
  const float rr_pcont = cmin(max_thr * eta * eta + 0.001f, 0.95f);
  const V3 off_n = dot(l_b, ffnormal) > 0.0f ? ffnormal : -ffnormal;
  const V3 new_origin =
      alive ? V3{offset1(position.x, off_n.x), offset1(position.y, off_n.y),
                 offset1(position.z, off_n.z)}
            : ld3(a + 18);
  const V3 new_dir = alive ? l_b : d;

  float* o = out_vec + i * 24;
  const V3 vecs[6] = {new_origin, new_dir, radiance, throughput, absorption, nee};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    o[3 * k] = vecs[k].x;
    o[3 * k + 1] = vecs[k].y;
    o[3 * k + 2] = vecs[k].z;
  }
  o[18] = ldir.x;
  o[19] = ldir.y;
  o[20] = ldir.z;
  o[21] = ldist;
  o[22] = rr_pcont;
  o[23] = pdf_b;
  alive_out[i] = alive ? 1 : 0;
  visible_out[i] = visible ? 1 : 0;
}

}  // namespace

extern "C" {

// flags: bit 0 base texture, 1 metallic-roughness, 2 normal map, 3 emissive,
// 4 anisotropy, 5 full MIS, 6 instanced (aux of 72 lanes, else 48).
// Returns cudaGetLastError() after the launch.
int vkrt_shade(const float* srow, const int32_t* taps, const float* aux, int64_t n, int flags,
               float* out_vec, uint8_t* alive, uint8_t* visible, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (flags & kInstanced)
    shade_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(srow, taps, aux, n, flags, out_vec,
                                                            alive, visible);
  else
    shade_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(srow, taps, aux, n, flags,
                                                             out_vec, alive, visible);
  return (int)cudaGetLastError();
}

}  // extern "C"
