// The wide back end's traversal over 8-wide rows: one CUDA thread per ray,
// looping to termination with a full-depth stack in local memory, the alpha
// test of alpha-flagged candidates run inside the traversal.
//
// Replaces the XLA body vk_raytrace_tpu/ops/traverse_wide.py::_traverse_wide
// (the reference's RayQuery analog, its `--renderer wide`). That body advanced
// every ray of a batch by one node per step of a phased while-loop, with the
// (R, D) stack in device memory, compaction of the live lanes between phases
// and a merge at the end; here each ray's whole traversal runs in one thread,
// so none of that exists.
//
// Row layout (64 floats = 16 float4 per row, 256 B; ops/bvh8.py::WideScene):
//   interior: lanes [6c .. 6c+5] child c's box (min xyz, max xyz; an empty
//             slot has min > max), lane 48+c its ref, lanes 56-63 zero;
//   leaf:     4 triangles of 16 lanes: p0 p1 p2 (0-8), uv0 uv1 uv2 (9-14),
//             orig_tri_id*4 + flags (15; bit0 double-sided, bit1 alpha).
// A child ref >= 0 is an interior row; a leaf ref is negative:
// vleaf = -ref-1, row = vleaf >> 2, count = (vleaf & 3) + 1.
//
// Per ray, as the reference's body computes it:
//   * the inverse direction with the +-1e-20 clamp;
//   * without per-lane roots, one slab test against the union of the root
//     row's valid child boxes; with them (root0, the two-level path) each
//     ray starts at its own interior row;
//   * an interior row: the 8 slab tests, then the children in near-to-far
//     order by the reference's 19-comparator network (_SORT8_NETWORK, not
//     stable on ties: tie order decides which alpha candidate draws first),
//     the nearest hit child visited next and the others pushed far to near;
//   * a leaf row: Moller-Trumbore over its triangles, back faces culled by
//     the double-sided flag in closest hit (any hit culls nothing); with an
//     alpha pack, each alpha-flagged candidate in front of the best hit draws
//     one PCG number, in triangle order k = 0..3, and stays a hit if the
//     number is <= its opacity (a nearest-neighbour atlas texel, or the mask
//     cutoff); then the best of the 4 by the reference's tournament;
//   * any hit ends at the first accepted hit.
// Outputs: t (1e32 on a miss), the original triangle id (-1), u, v, the
// nodes visited and the advanced seed.
//
// Numerics follow the plain torch version (ops/traverse_wide.py
// _traverse_wide_plain) operation by operation, with explicitly rounded
// intrinsics, -fmad=false and IEEE division, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTerm = -(1 << 30);
constexpr float kInf = 1e32f;
constexpr float kRootBig = 3.0e38f;
constexpr float kEpsDet = 1e-12f;
constexpr float kInv255 = 1.0f / 255.0f;
constexpr float kAlphaMask = 1.0f;  // models/schema.py ALPHA_MASK
constexpr long long kWrapRepeat = 0, kWrapClamp = 1;
// The stack: the reference caps its own at 64 entries; the host refuses a
// tree whose exact bound is deeper, so no push is ever dropped.
constexpr int kMaxStack = 64;
constexpr int kThreads = 128;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float guard_inv(float c) {
  const float g = fabsf(c) < 1e-20f ? (c < 0.0f ? -1e-20f : 1e-20f) : c;
  return __fdiv_rn(1.0f, g);
}

// Slab test of the ray against box [lo, hi]; returns (tn, tf).
__device__ __forceinline__ void slab(const Ray& y, float bxm, float bym, float bzm, float bxM,
                                     float byM, float bzM, float& tn, float& tf) {
  const float lx = __fmul_rn(__fsub_rn(bxm, y.ox), y.ix);
  const float hx = __fmul_rn(__fsub_rn(bxM, y.ox), y.ix);
  const float ly = __fmul_rn(__fsub_rn(bym, y.oy), y.iy);
  const float hy = __fmul_rn(__fsub_rn(byM, y.oy), y.iy);
  const float lz = __fmul_rn(__fsub_rn(bzm, y.oz), y.iz);
  const float hz = __fmul_rn(__fsub_rn(bzM, y.oz), y.iz);
  tn = fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)), fminf(lz, hz));
  tf = fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)), fmaxf(lz, hz));
}

// torch.remainder of integers: the sign of the divisor (size >= 1).
__device__ __forceinline__ long long floor_mod(long long c, long long size) {
  const long long m = c % size;
  return m < 0 ? m + size : m;
}

// ops/texture.py _wrap: REPEAT, CLAMP or MIRROR of an integer texel coord.
__device__ __forceinline__ long long wrap_coord(long long c, long long size, long long mode) {
  if (mode == kWrapRepeat) return floor_mod(c, size);
  if (mode == kWrapClamp) return c < 0 ? 0 : (c > size - 1 ? size - 1 : c);
  const long long period = 2 * size;
  const long long m = floor_mod(c, period);
  return m >= size ? period - 1 - m : m;
}

// traverse_alpha._alpha_opacity for one candidate: the triangle's AlphaPack
// row (a_factor, mode, cutoff, tex_id, uv transform 3x2, atlas x/y/w/h,
// wrap s/t) and the atlas texel its uv falls in.
__device__ __forceinline__ float opacity(const float* __restrict__ pack, int64_t n_pack,
                                         const uint8_t* __restrict__ plane, int64_t n_plane,
                                         int64_t atlas_w, int tri, float uvu, float uvv) {
  const int64_t row = tri < 0 ? 0 : (tri >= n_pack ? n_pack - 1 : tri);
  const float4* a = reinterpret_cast<const float4*>(pack + row * 16);
  const float4 a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];
  const float ut = __fadd_rn(__fadd_rn(__fmul_rn(uvu, a1.x), __fmul_rn(uvv, a1.z)), a2.x);
  const float vt = __fadd_rn(__fadd_rn(__fmul_rn(uvu, a1.y), __fmul_rn(uvv, a1.w)), a2.y);
  float alpha = a0.x;
  if (a0.w >= 0.0f) {  // textured: the atlas alpha texel times the factor
    const long long tw = (long long)a3.x < 1 ? 1 : (long long)a3.x;
    const long long th = (long long)a3.y < 1 ? 1 : (long long)a3.y;
    const long long xi = (long long)floorf(__fmul_rn(ut, (float)tw));
    const long long yi = (long long)floorf(__fmul_rn(vt, (float)th));
    const long long xw = wrap_coord(xi, tw, (long long)a3.z) + (long long)a2.z;
    const long long yw = wrap_coord(yi, th, (long long)a3.w) + (long long)a2.w;
    long long flat = yw * atlas_w + xw;
    flat = flat < 0 ? 0 : (flat > n_plane - 1 ? n_plane - 1 : flat);
    alpha = __fmul_rn(a0.x, __fmul_rn((float)plane[flat], kInv255));
  }
  return a0.y == kAlphaMask ? (alpha > a0.z ? 1.0f : 0.0f) : alpha;
}

// One PCG step (ops/rng.py rand): advances `seed`, returns a float in [0, 1).
__device__ __forceinline__ float rand01(uint32_t& seed) {
  const uint32_t prev = seed * 747796405u + 2891336453u;
  const uint32_t word = ((prev >> ((prev >> 28) + 4u)) ^ prev) * 277803737u;
  const uint32_t bits = (word >> 22) ^ word;
  seed = prev;
  return __fmul_rn((float)(bits >> 9), 1.0f / 8388608.0f);
}

// One comparator of the network: ascending by key, the ref riding along;
// equal keys stay where they are.
__device__ __forceinline__ void cswap(float (&k)[8], int (&r)[8], int i, int j) {
  if (k[i] > k[j]) {
    const float tk = k[i];
    k[i] = k[j];
    k[j] = tk;
    const int tr = r[i];
    r[i] = r[j];
    r[j] = tr;
  }
}

// Batcher's odd-even merge sort of 8 inputs: the reference's _SORT8_NETWORK,
// comparator for comparator.
__device__ __forceinline__ void sort8(float (&k)[8], int (&r)[8]) {
  cswap(k, r, 0, 1); cswap(k, r, 2, 3); cswap(k, r, 4, 5); cswap(k, r, 6, 7);
  cswap(k, r, 0, 2); cswap(k, r, 1, 3); cswap(k, r, 4, 6); cswap(k, r, 5, 7);
  cswap(k, r, 1, 2); cswap(k, r, 5, 6);
  cswap(k, r, 0, 4); cswap(k, r, 1, 5); cswap(k, r, 2, 6); cswap(k, r, 3, 7);
  cswap(k, r, 2, 4); cswap(k, r, 3, 5);
  cswap(k, r, 1, 2); cswap(k, r, 3, 4); cswap(k, r, 5, 6);
}

struct Alpha {
  const float* pack;
  int64_t n_pack;
  const uint8_t* plane;
  int64_t n_plane, atlas_w;
};

template <bool ANY, bool ALPHA>
__global__ void __launch_bounds__(kThreads)
wide_kernel(const float4* __restrict__ rows, int max_depth, const float* __restrict__ origin,
            const float* __restrict__ direction, const float* __restrict__ t_max,
            const uint8_t* __restrict__ active, const int32_t* __restrict__ root0,
            const int64_t* __restrict__ seed_in, Alpha al, int64_t n_rays,
            float* __restrict__ out_t, int32_t* __restrict__ out_tri, float* __restrict__ out_u,
            float* __restrict__ out_v, int32_t* __restrict__ out_steps,
            int64_t* __restrict__ out_seed) {
  constexpr bool kCull = !ANY;
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;

  Ray y;
  y.ox = origin[3 * r];
  y.oy = origin[3 * r + 1];
  y.oz = origin[3 * r + 2];
  y.dx = direction[3 * r];
  y.dy = direction[3 * r + 1];
  y.dz = direction[3 * r + 2];
  y.ix = guard_inv(y.dx);
  y.iy = guard_inv(y.dy);
  y.iz = guard_inv(y.dz);
  float t_best = t_max[r];
  uint32_t seed = seed_in != nullptr ? (uint32_t)seed_in[r] : 0u;

  int cur = 0;
  if (root0 != nullptr) {
    cur = root0[r];
  } else {
    // The union of the root row's valid child boxes, one slab test.
    const float* root = reinterpret_cast<const float*>(rows);
    float mn[3] = {kRootBig, kRootBig, kRootBig}, mx[3] = {-kRootBig, -kRootBig, -kRootBig};
    for (int c = 0; c < 8; ++c) {
      const float* b = root + c * 6;
      if (b[0] <= b[3]) {
        for (int a = 0; a < 3; ++a) {
          mn[a] = fminf(mn[a], b[a]);
          mx[a] = fmaxf(mx[a], b[3 + a]);
        }
      }
    }
    float tn0, tf0;
    slab(y, mn[0], mn[1], mn[2], mx[0], mx[1], mx[2], tn0, tf0);
    if (!((tn0 <= tf0) && (tf0 >= 0.0f) && (tn0 < t_best))) cur = kTerm;
  }
  if (active != nullptr && !active[r]) cur = kTerm;

  int stack[kMaxStack];
  int depth = 0, tri = -1, steps = 0;
  float u = 0.0f, v = 0.0f;
  while (cur != kTerm) {
    ++steps;
    bool need_pop;
    if (cur >= 0) {
      // ---- interior: 8 slab tests, near-to-far order, push the rest ----
      const float4* row = rows + (int64_t)cur * 16;
      float f[56];
#pragma unroll
      for (int q = 0; q < 14; ++q) {
        const float4 w = row[q];
        f[4 * q] = w.x;
        f[4 * q + 1] = w.y;
        f[4 * q + 2] = w.z;
        f[4 * q + 3] = w.w;
      }
      float key[8];
      int ref[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float* b = f + c * 6;
        float tn, tf;
        slab(y, b[0], b[1], b[2], b[3], b[4], b[5], tn, tf);
        const bool hit = b[0] <= b[3] && tn <= tf && tf >= 0.0f && tn < t_best;
        key[c] = hit ? tn : kInf;
        ref[c] = (int)f[48 + c];
      }
      sort8(key, ref);
      int n_valid = 0;
#pragma unroll
      for (int c = 0; c < 8; ++c) n_valid += key[c] < kInf ? 1 : 0;
      if (n_valid > 0) {
        // Sorted child n_valid-1-j goes to stack entry depth+j: the farthest
        // deepest, so pops come near first.
        for (int j = 0; j + 1 < n_valid; ++j) {
          if (depth + j < max_depth) stack[depth + j] = ref[n_valid - 1 - j];
        }
        depth = min(depth + n_valid - 1, max_depth);
        cur = ref[0];
        need_pop = false;
      } else {
        need_pop = true;
      }
    } else {
      // ---- leaf: up to 4 triangles, the alpha test, best of 4 ----------
      const int vleaf = -cur - 1;
      const int cnt = (vleaf & 3) + 1;
      const float4* row = rows + (int64_t)(vleaf >> 2) * 16;
      float tc[4], uc[4], vc[4];
      int oc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 a = row[4 * k], b = row[4 * k + 1], c = row[4 * k + 2],
                     d = row[4 * k + 3];
        const float p0x = a.x, p0y = a.y, p0z = a.z, p1x = a.w, p1y = b.x, p1z = b.y;
        const float p2x = b.z, p2y = b.w, p2z = c.x;
        const int meta = (int)d.w;
        const int orig = meta >> 2;
        const int flags = meta & 3;
        const float e1x = __fsub_rn(p1x, p0x), e1y = __fsub_rn(p1y, p0y),
                    e1z = __fsub_rn(p1z, p0z);
        const float e2x = __fsub_rn(p2x, p0x), e2y = __fsub_rn(p2y, p0y),
                    e2z = __fsub_rn(p2z, p0z);
        const float pvx = __fsub_rn(__fmul_rn(y.dy, e2z), __fmul_rn(y.dz, e2y));
        const float pvy = __fsub_rn(__fmul_rn(y.dz, e2x), __fmul_rn(y.dx, e2z));
        const float pvz = __fsub_rn(__fmul_rn(y.dx, e2y), __fmul_rn(y.dy, e2x));
        const float det = __fadd_rn(__fadd_rn(__fmul_rn(e1x, pvx), __fmul_rn(e1y, pvy)),
                                    __fmul_rn(e1z, pvz));
        const bool det_ok = fabsf(det) > kEpsDet;
        const bool facing = kCull ? (((flags & 1) != 0) || (det > kEpsDet)) : det_ok;
        const float inv_det = __fdiv_rn(1.0f, det_ok ? det : 1.0f);
        const float tvx = __fsub_rn(y.ox, p0x), tvy = __fsub_rn(y.oy, p0y),
                    tvz = __fsub_rn(y.oz, p0z);
        const float uu = __fmul_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(tvx, pvx), __fmul_rn(tvy, pvy)), __fmul_rn(tvz, pvz)),
            inv_det);
        const float qvx = __fsub_rn(__fmul_rn(tvy, e1z), __fmul_rn(tvz, e1y));
        const float qvy = __fsub_rn(__fmul_rn(tvz, e1x), __fmul_rn(tvx, e1z));
        const float qvz = __fsub_rn(__fmul_rn(tvx, e1y), __fmul_rn(tvy, e1x));
        const float vv = __fmul_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(y.dx, qvx), __fmul_rn(y.dy, qvy)), __fmul_rn(y.dz, qvz)),
            inv_det);
        const float tt = __fmul_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(e2x, qvx), __fmul_rn(e2y, qvy)), __fmul_rn(e2z, qvz)),
            inv_det);
        bool geo = k < cnt && det_ok && facing && uu >= 0.0f && vv >= 0.0f &&
                   __fadd_rn(uu, vv) <= 1.0f && tt > 0.0f && tt < t_best;
        if (ALPHA && geo && (flags & 2) != 0) {
          // The in-traversal alpha test: this candidate's texture uv, its
          // opacity and one draw.
          const float wbar = __fsub_rn(__fsub_rn(1.0f, uu), vv);
          const float uvu = __fadd_rn(__fadd_rn(__fmul_rn(c.y, wbar), __fmul_rn(c.w, uu)),
                                      __fmul_rn(d.y, vv));
          const float uvv = __fadd_rn(__fadd_rn(__fmul_rn(c.z, wbar), __fmul_rn(d.x, uu)),
                                      __fmul_rn(d.z, vv));
          const float op = opacity(al.pack, al.n_pack, al.plane, al.n_plane, al.atlas_w, orig,
                                   uvu, uvv);
          geo = rand01(seed) <= op;
        }
        tc[k] = geo ? tt : kInf;
        oc[k] = orig;
        uc[k] = uu;
        vc[k] = vv;
      }
      // The reference's tournament: (0, 1) and (2, 3), then their winners;
      // the later entry wins only where its t is strictly less.
      const int w01 = tc[1] < tc[0] ? 1 : 0;
      const int w23 = tc[3] < tc[2] ? 3 : 2;
      const int w = tc[w23] < tc[w01] ? w23 : w01;
      if (tc[w] < t_best) {
        t_best = tc[w];
        tri = oc[w];
        u = uc[w];
        v = vc[w];
        if (ANY) break;  // the first accepted hit occludes
      }
      need_pop = true;
    }
    if (need_pop) cur = depth > 0 ? stack[--depth] : kTerm;
  }
  out_t[r] = tri >= 0 ? t_best : kInf;
  out_tri[r] = tri;
  out_u[r] = u;
  out_v[r] = v;
  out_steps[r] = steps;
  out_seed[r] = (int64_t)seed;
}

template <bool ANY, bool ALPHA>
cudaError_t launch(const float* rows, int max_depth, const float* origin, const float* direction,
                   const float* t_max, const uint8_t* active, const int32_t* root0,
                   const int64_t* seed_in, Alpha al, int64_t n_rays, float* out_t,
                   int32_t* out_tri, float* out_u, float* out_v, int32_t* out_steps,
                   int64_t* out_seed, cudaStream_t stream) {
  const int64_t blocks = (n_rays + kThreads - 1) / kThreads;
  wide_kernel<ANY, ALPHA><<<(unsigned)blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(rows), max_depth, origin, direction, t_max, active, root0,
      seed_in, al, n_rays, out_t, out_tri, out_u, out_v, out_steps, out_seed);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Closest hit with culling (any_hit 0) or any hit without (any_hit 1) over
// 8-wide rows, one thread per ray. `active` (u8), `root0` (i32 interior rows)
// and `seed_in` (uint32 values in int64) may be null; `pack` null: no alpha
// test (every alpha-flagged triangle counts as opaque and nothing is drawn).
// Returns the launch's cudaError_t (invalid value for a stack bound past
// kMaxStack, which the wrapper refuses first).
int vkrt_traverse_wide(int any_hit, const float* rows, int stack_depth, const float* origin,
                       const float* direction, const float* t_max, const uint8_t* active,
                       const int32_t* root0, const int64_t* seed_in, const float* pack,
                       int64_t n_pack, const uint8_t* plane, int64_t n_plane, int64_t atlas_w,
                       int64_t n_rays, float* out_t, int32_t* out_tri, float* out_u,
                       float* out_v, int32_t* out_steps, int64_t* out_seed,
                       cudaStream_t stream) {
  if (stack_depth < 1 || stack_depth > kMaxStack || n_rays < 0) return cudaErrorInvalidValue;
  if (n_rays == 0) return cudaSuccess;
  const Alpha al{pack, n_pack, plane, n_plane, atlas_w};
  const int d = stack_depth;
  if (any_hit) {
    return pack ? launch<true, true>(rows, d, origin, direction, t_max, active, root0, seed_in,
                                     al, n_rays, out_t, out_tri, out_u, out_v, out_steps,
                                     out_seed, stream)
                : launch<true, false>(rows, d, origin, direction, t_max, active, root0, seed_in,
                                      al, n_rays, out_t, out_tri, out_u, out_v, out_steps,
                                      out_seed, stream);
  }
  return pack ? launch<false, true>(rows, d, origin, direction, t_max, active, root0, seed_in,
                                    al, n_rays, out_t, out_tri, out_u, out_v, out_steps,
                                    out_seed, stream)
              : launch<false, false>(rows, d, origin, direction, t_max, active, root0, seed_in,
                                     al, n_rays, out_t, out_tri, out_u, out_v, out_steps,
                                     out_seed, stream);
}

}  // extern "C"
