// BVH traversal over 16-wide planar rows: one CUDA thread per ray, looping
// to termination with a full-depth stack in local memory.
//
// Replaces the TPU step kernel vk_raytrace_tpu/ops/traverse_fused.py
// (_make_step_kernel, launched once per traversal step by _step). That
// kernel advanced every ray by ONE node per launch and kept the traversal
// state in device memory between launches; here the whole traversal of a
// ray runs inside one launch, so the state stays in registers and local
// memory and none of the step driver (row gather, phase compaction, short
// stack with overflow re-run) exists.
//
// What bounds it on the card: dependent 512-byte row reads (each node's
// row address comes from the previous row) and divergence between rays of
// a warp, not arithmetic. The design answers with 16-byte vector loads of
// the rows, a small in-register child sort, and rows visited near-first so
// t pruning cuts the subtrees early.
//
// Row layout (width W = 16, 128 floats = 32 float4 per row):
//   interior: [bmin.x x16 | bmin.y | bmin.z | bmax.x | bmax.y | bmax.z |
//              child ref x16 | unused x16]; empty slots have bmin > bmax.
//   leaf:     attribute-planar, attr a of triangle t at lane a*8 + t:
//              a 0..8 = p0 p1 p2, a 9..14 = uv0 uv1 uv2, a 15 = orig*4+flags
//              (flags bit0 double-sided, bit1 alpha-tested).
// A child ref >= 0 is an interior row; a leaf ref is negative:
// vleaf = -ref-1, row = vleaf >> 3, count = (vleaf & 7) + 1.
//
// Per-lane roots (the TPU kernel's mode d, called from ops/tlas.py): with a
// non-null root0 each ray starts at its own interior row root0[r] of a
// concatenated per-mesh table (the instance's BLAS root) and skips the root
// union-box test; refs in such a table are absolute rows, so nothing else
// changes. The two-level round loop stays on the host side.
//
// Numerics follow the plain torch twin (ops/traverse_fused.py
// _traverse_plain) operation by operation, with explicitly rounded
// intrinsics, -fmad=false and IEEE division, so t/u/v agree with the twin
// to within a few ulp and child order and leaf tie-breaks are the twin's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kW = 16;           // children per interior row
constexpr int kLT = kW / 2;      // triangles per leaf row
constexpr int kRowF4 = kW * 2;   // float4 per row (W*8 floats)
constexpr int kTerm = -(1 << 30);
constexpr float kInf = 1e32f;

enum Mode { kClosest = 0, kAny = 1, kCandidate = 2 };

__device__ __forceinline__ float guard_inv(float c) {
  float g = fabsf(c) < 1e-20f ? (c < 0.0f ? -1e-20f : 1e-20f) : c;
  return __fdiv_rn(1.0f, g);
}

__device__ __forceinline__ float f4get(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// Slab test of the ray against box [lo, hi]; returns (tn, tf).
__device__ __forceinline__ void slab(float ox, float oy, float oz, float ix,
                                     float iy, float iz, float bxm, float bym,
                                     float bzm, float bxM, float byM, float bzM,
                                     float& tn, float& tf) {
  float lx = __fmul_rn(__fsub_rn(bxm, ox), ix);
  float hx = __fmul_rn(__fsub_rn(bxM, ox), ix);
  float ly = __fmul_rn(__fsub_rn(bym, oy), iy);
  float hy = __fmul_rn(__fsub_rn(byM, oy), iy);
  float lz = __fmul_rn(__fsub_rn(bzm, oz), iz);
  float hz = __fmul_rn(__fsub_rn(bzM, oz), iz);
  tn = fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)), fminf(lz, hz));
  tf = fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)), fmaxf(lz, hz));
}

// Tournament min over the leaf's 8 lanes in the reference's fold order
// (pairs (i, i+4), then (i, i+2), then (0, 1)); a lane keeps its own entry
// unless the partner's t is strictly smaller.
template <int NP>
__device__ __forceinline__ void minfold(float (&t)[kLT], float (&p)[NP][kLT]) {
#pragma unroll
  for (int k = kLT / 2; k >= 1; k >>= 1) {
#pragma unroll
    for (int i = 0; i < k; ++i) {
      if (t[i + k] < t[i]) {
        t[i] = t[i + k];
#pragma unroll
        for (int q = 0; q < NP; ++q) p[q][i] = p[q][i + k];
      }
    }
  }
}

template <int MODE, bool CULL, int MAXD>
__global__ void __launch_bounds__(128)
traverse_kernel(const float4* __restrict__ rows, const float* __restrict__ origin,
                const float* __restrict__ direction, const float* __restrict__ t_max,
                const uint8_t* __restrict__ active, const int32_t* __restrict__ root0,
                int64_t n_rays,
                float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                float* __restrict__ out_u, float* __restrict__ out_v,
                int32_t* __restrict__ out_steps, float* __restrict__ out_uvu,
                float* __restrict__ out_uvv) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;

  const float ox = origin[3 * r], oy = origin[3 * r + 1], oz = origin[3 * r + 2];
  const float dx = direction[3 * r], dy = direction[3 * r + 1], dz = direction[3 * r + 2];
  const float ix = guard_inv(dx), iy = guard_inv(dy), iz = guard_inv(dz);
  const float tmax = t_max[r];

  // Opaque slot; candidate slot (nearest alpha-flagged hit) in mode c.
  float t_best = tmax, u_best = 0.0f, v_best = 0.0f;
  int tri_best = -1;
  float c_t = tmax, c_u = 0.0f, c_v = 0.0f, c_uvu = 0.0f, c_uvv = 0.0f;
  int c_tri = -1;
  int steps = 0;

  // Ray setup: the lane must be active, and without per-lane roots the
  // union box of the root's valid children must be hit within (0, t_max).
  int cur = 0;
  if (root0 != nullptr) {
    cur = (active != nullptr && !active[r]) ? kTerm : root0[r];
  } else {
    float rmin[3] = {3.0e38f, 3.0e38f, 3.0e38f};
    float rmax[3] = {-3.0e38f, -3.0e38f, -3.0e38f};
#pragma unroll
    for (int g = 0; g < kW / 4; ++g) {
      const float4 bxm = rows[0 * 4 + g], bym = rows[1 * 4 + g], bzm = rows[2 * 4 + g];
      const float4 bxM = rows[3 * 4 + g], byM = rows[4 * 4 + g], bzM = rows[5 * 4 + g];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (f4get(bxm, k) <= f4get(bxM, k)) {
          rmin[0] = fminf(rmin[0], f4get(bxm, k));
          rmin[1] = fminf(rmin[1], f4get(bym, k));
          rmin[2] = fminf(rmin[2], f4get(bzm, k));
          rmax[0] = fmaxf(rmax[0], f4get(bxM, k));
          rmax[1] = fmaxf(rmax[1], f4get(byM, k));
          rmax[2] = fmaxf(rmax[2], f4get(bzM, k));
        }
      }
    }
    float tn0, tf0;
    slab(ox, oy, oz, ix, iy, iz, rmin[0], rmin[1], rmin[2], rmax[0], rmax[1],
         rmax[2], tn0, tf0);
    const bool hit_root = (tn0 <= tf0) && (tf0 >= 0.0f) && (tn0 < tmax);
    if (!hit_root || (active != nullptr && !active[r])) cur = kTerm;
  }

  int stack[MAXD];
  int depth = 0;

  while (cur != kTerm) {
    ++steps;
    const float t_prune = MODE == kCandidate ? fminf(t_best, c_t) : t_best;
    if (cur >= 0) {
      // ---- interior: 16-way slab test, stable insertion sort of hits ----
      const float4* row = rows + (int64_t)cur * kRowF4;
      float key[kW];
      int ref[kW];
      int n = 0;
#pragma unroll
      for (int g = 0; g < kW / 4; ++g) {
        const float4 bxm = row[0 * 4 + g], bym = row[1 * 4 + g], bzm = row[2 * 4 + g];
        const float4 bxM = row[3 * 4 + g], byM = row[4 * 4 + g], bzM = row[5 * 4 + g];
        const float4 rf = row[6 * 4 + g];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float tn, tf;
          slab(ox, oy, oz, ix, iy, iz, f4get(bxm, k), f4get(bym, k), f4get(bzm, k),
               f4get(bxM, k), f4get(byM, k), f4get(bzM, k), tn, tf);
          const bool hit = (f4get(bxm, k) <= f4get(bxM, k)) && (tn <= tf) &&
                           (tf >= 0.0f) && (tn < t_prune);
          if (hit) {
            // Insert after every key <= tn: ascending and stable.
            int j = n;
            while (j > 0 && key[j - 1] > tn) {
              key[j] = key[j - 1];
              ref[j] = ref[j - 1];
              --j;
            }
            key[j] = tn;
            ref[j] = (int)f4get(rf, k);
            ++n;
          }
        }
      }
      if (n > 0) {
        // Push far-to-near; descend into the nearest.
        for (int k = n - 1; k >= 1; --k) {
          if (depth < MAXD) stack[depth] = ref[k];
          ++depth;
        }
        cur = ref[0];
        continue;
      }
    } else {
      // ---- leaf: up to 8 triangles, Moller-Trumbore, tournament min ----
      const int vleaf = -cur - 1;
      const int cnt = (vleaf & (kLT - 1)) + 1;
      const float4* row = rows + (int64_t)(vleaf >> 3) * kRowF4;
      float tt_o[kLT];
      float pay_o[3][kLT];  // orig, u, v
      float tt_c[kLT];
      float pay_c[5][kLT];  // orig, u, v, uv.u, uv.v
#pragma unroll
      for (int g = 0; g < kLT / 4; ++g) {
        float4 a[16];
#pragma unroll
        for (int at = 0; at < 16; ++at) {
          const bool need = at <= 8 || at == 15 || MODE == kCandidate;
          if (need && g * 4 < cnt) a[at] = row[at * 2 + g];
          else a[at] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int lane = g * 4 + k;
          const float p0x = f4get(a[0], k), p0y = f4get(a[1], k), p0z = f4get(a[2], k);
          const float p1x = f4get(a[3], k), p1y = f4get(a[4], k), p1z = f4get(a[5], k);
          const float p2x = f4get(a[6], k), p2y = f4get(a[7], k), p2z = f4get(a[8], k);
          const int tmeta = (int)f4get(a[15], k);
          const int orig = tmeta >> 2;
          const int flags = tmeta & 3;
          const float e1x = __fsub_rn(p1x, p0x), e1y = __fsub_rn(p1y, p0y), e1z = __fsub_rn(p1z, p0z);
          const float e2x = __fsub_rn(p2x, p0x), e2y = __fsub_rn(p2y, p0y), e2z = __fsub_rn(p2z, p0z);
          const float pvx = __fsub_rn(__fmul_rn(dy, e2z), __fmul_rn(dz, e2y));
          const float pvy = __fsub_rn(__fmul_rn(dz, e2x), __fmul_rn(dx, e2z));
          const float pvz = __fsub_rn(__fmul_rn(dx, e2y), __fmul_rn(dy, e2x));
          const float det = __fadd_rn(__fadd_rn(__fmul_rn(e1x, pvx), __fmul_rn(e1y, pvy)),
                                      __fmul_rn(e1z, pvz));
          const bool det_ok = fabsf(det) > 1e-12f;
          const bool facing = CULL ? (((flags & 1) != 0) || (det > 1e-12f)) : det_ok;
          const float inv_det = __fdiv_rn(1.0f, det_ok ? det : 1.0f);
          const float tvx = __fsub_rn(ox, p0x), tvy = __fsub_rn(oy, p0y), tvz = __fsub_rn(oz, p0z);
          const float uu = __fmul_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(tvx, pvx), __fmul_rn(tvy, pvy)), __fmul_rn(tvz, pvz)),
              inv_det);
          const float qvx = __fsub_rn(__fmul_rn(tvy, e1z), __fmul_rn(tvz, e1y));
          const float qvy = __fsub_rn(__fmul_rn(tvz, e1x), __fmul_rn(tvx, e1z));
          const float qvz = __fsub_rn(__fmul_rn(tvx, e1y), __fmul_rn(tvy, e1x));
          const float vv = __fmul_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(dx, qvx), __fmul_rn(dy, qvy)), __fmul_rn(dz, qvz)),
              inv_det);
          const float tt = __fmul_rn(
              __fadd_rn(__fadd_rn(__fmul_rn(e2x, qvx), __fmul_rn(e2y, qvy)), __fmul_rn(e2z, qvz)),
              inv_det);
          const bool geo_ok = lane < cnt && det_ok && facing && uu >= 0.0f && vv >= 0.0f &&
                              __fadd_rn(uu, vv) <= 1.0f && tt > 0.0f;
          const bool is_alpha = (flags & 2) != 0;
          const bool opq = MODE == kCandidate ? (geo_ok && !is_alpha && tt < t_best)
                                              : (geo_ok && tt < t_best);
          tt_o[lane] = opq ? tt : kInf;
          pay_o[0][lane] = (float)orig;
          pay_o[1][lane] = uu;
          pay_o[2][lane] = vv;
          if (MODE == kCandidate) {
            const bool alp = geo_ok && is_alpha && tt < t_best && tt < c_t;
            const float wbar = __fsub_rn(__fsub_rn(1.0f, uu), vv);
            tt_c[lane] = alp ? tt : kInf;
            pay_c[0][lane] = (float)orig;
            pay_c[1][lane] = uu;
            pay_c[2][lane] = vv;
            pay_c[3][lane] = __fadd_rn(__fadd_rn(__fmul_rn(f4get(a[9], k), wbar),
                                                 __fmul_rn(f4get(a[11], k), uu)),
                                       __fmul_rn(f4get(a[13], k), vv));
            pay_c[4][lane] = __fadd_rn(__fadd_rn(__fmul_rn(f4get(a[10], k), wbar),
                                                 __fmul_rn(f4get(a[12], k), uu)),
                                       __fmul_rn(f4get(a[14], k), vv));
          }
        }
      }
      minfold<3>(tt_o, pay_o);
      const bool found = tt_o[0] < t_best;
      if (found) {
        t_best = tt_o[0];
        tri_best = (int)pay_o[0][0];
        u_best = pay_o[1][0];
        v_best = pay_o[2][0];
      }
      if (MODE == kCandidate) {
        minfold<5>(tt_c, pay_c);
        if (tt_c[0] < c_t) {
          c_t = tt_c[0];
          c_tri = (int)pay_c[0][0];
          c_u = pay_c[1][0];
          c_v = pay_c[2][0];
          c_uvu = pay_c[3][0];
          c_uvv = pay_c[4][0];
        }
      }
      if (MODE == kAny && found) break;
    }
    // Childless interior or finished leaf: pop. (depth never passes MAXD:
    // the wrapper refuses trees whose exact stack bound exceeds it.)
    if (depth > 0) {
      --depth;
      cur = depth < MAXD ? stack[depth] : kTerm;
    } else {
      cur = kTerm;
    }
  }

  if (MODE == kCandidate) {
    out_t[r] = c_tri >= 0 ? c_t : kInf;
    out_tri[r] = c_tri;
    out_u[r] = c_u;
    out_v[r] = c_v;
    out_uvu[r] = c_uvu;
    out_uvv[r] = c_uvv;
  } else {
    out_t[r] = tri_best >= 0 ? t_best : kInf;
    out_tri[r] = tri_best;
    out_u[r] = u_best;
    out_v[r] = v_best;
  }
  out_steps[r] = steps;
}

template <int MODE, bool CULL, int MAXD>
void launch(const float* rows, const float* o, const float* d, const float* tmax,
            const uint8_t* active, const int32_t* root0, int64_t n, float* t, int32_t* tri,
            float* u, float* v, int32_t* steps, float* uvu, float* uvv, cudaStream_t stream) {
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  traverse_kernel<MODE, CULL, MAXD><<<(unsigned)blocks, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(rows), o, d, tmax, active, root0, n, t, tri, u, v,
      steps, uvu, uvv);
}

template <int MAXD>
void dispatch(int mode, int cull, const float* rows, const float* o, const float* d,
              const float* tmax, const uint8_t* active, const int32_t* root0, int64_t n,
              float* t, int32_t* tri, float* u, float* v, int32_t* steps, float* uvu,
              float* uvv, cudaStream_t s) {
  if (mode == kClosest)
    launch<kClosest, true, MAXD>(rows, o, d, tmax, active, root0, n, t, tri, u, v, steps, uvu,
                                 uvv, s);
  else if (mode == kAny)
    launch<kAny, false, MAXD>(rows, o, d, tmax, active, root0, n, t, tri, u, v, steps, uvu,
                              uvv, s);
  else if (cull)
    launch<kCandidate, true, MAXD>(rows, o, d, tmax, active, root0, n, t, tri, u, v, steps,
                                   uvu, uvv, s);
  else
    launch<kCandidate, false, MAXD>(rows, o, d, tmax, active, root0, n, t, tri, u, v, steps,
                                    uvu, uvv, s);
}

}  // namespace

extern "C" {

// Largest stack depth any instantiation holds; the wrapper refuses trees
// whose exact stack bound exceeds it.
int vkrt_traverse_max_stack() { return 128; }

// mode: 0 closest hit (backface culling), 1 any hit (no culling, first
// accepted hit ends the ray), 2 nearest alpha candidate (culling per
// `cull`). `active` may be null; `root0` may be null (every ray starts at
// row 0 after the root union-box test) or hold each ray's interior root
// row. Returns cudaGetLastError() after launch.
int vkrt_traverse(int mode, int cull, const float* rows, int stack_depth,
                  const float* origin, const float* direction, const float* t_max,
                  const uint8_t* active, const int32_t* root0, int64_t n_rays, float* t,
                  int32_t* tri, float* u, float* v, int32_t* steps, float* uvu, float* uvv,
                  void* stream) {
  if (n_rays <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (stack_depth <= 64)
    dispatch<64>(mode, cull, rows, origin, direction, t_max, active, root0, n_rays, t, tri, u,
                 v, steps, uvu, uvv, s);
  else
    dispatch<128>(mode, cull, rows, origin, direction, t_max, active, root0, n_rays, t, tri,
                  u, v, steps, uvu, uvv, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
