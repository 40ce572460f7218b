// BVH traversal over planar rows of width W = 16 or 32: one CUDA thread per
// ray, looping to termination with a full-depth stack in local memory.
//
// Replaces the TPU step kernel vk_raytrace_tpu/ops/traverse_fused.py
// (_make_step_kernel, launched once per traversal step by _step). That
// kernel advanced every ray by ONE node per launch and kept the traversal
// state in device memory between launches; here the whole traversal of a
// ray runs inside one launch, so the state stays in registers and local
// memory and none of the step driver (row gather, phase compaction, short
// stack with overflow re-run) exists.
//
// What bounds it on the card: dependent row reads (each node's row address
// comes from the previous row) and divergence between rays of a warp, not
// arithmetic. The design answers with 16-byte vector loads of the rows, a
// small in-register child sort, and rows visited near-first so t pruning
// cuts the subtrees early.
//
// Row layout (W*8 floats = W*2 float4 per row; W = 16: 512 B, W = 32: 1024 B):
//   interior: [bmin.x xW | bmin.y | bmin.z | bmax.x | bmax.y | bmax.z |
//              child ref xW | unused xW]; empty slots have bmin > bmax.
//   leaf:     attribute-planar, attr a of triangle t at lane a*(W/2) + t:
//              a 0..8 = p0 p1 p2, a 9..14 = uv0 uv1 uv2, a 15 = orig*4+flags
//              (flags bit0 double-sided, bit1 alpha-tested).
// A child ref >= 0 is an interior row; a leaf ref is negative:
// vleaf = -ref-1, row = vleaf / (W/2), count = vleaf % (W/2) + 1.
//
// Per-lane roots (the TPU kernel's mode d, called from ops/tlas.py): with a
// non-null root0 each ray starts at its own interior row root0[r] of a
// concatenated per-mesh table (the instance's BLAS root) and skips the root
// union-box test; refs in such a table are absolute rows, so nothing else
// changes. The two-level round loop stays on the host side.
//
// Three more entries share the per-node device functions:
//   vkrt_sort_children: the child order of an interior row alone (the
//     counterpart of the TPU kernel's bitonic network _bitonic, which the
//     reference unit-tests through its own pallas_call, tests/test_fused.py);
//   vkrt_traverse_capped: closest hit stopped after max_steps nodes, and its
//     no-gather variant, in which ray r reads row r at every step whatever
//     its node is and starts over at the root whenever its made-up nodes end
//     it, so every ray runs max_steps nodes (the timing variant of
//     scripts/stepbench.py: it shows what the dependent row gather costs; its
//     hits are wrong by design).
//
// Numerics follow the plain torch twin (ops/traverse_fused.py
// _traverse_plain) operation by operation, with explicitly rounded
// intrinsics, -fmad=false and IEEE division, so t/u/v agree with the twin
// to within a few ulp and child order and leaf tie-breaks are the twin's.
//
// One library per row width: the wrapper builds this file twice, with
// -DVKRT_WIDTH=16 and -DVKRT_WIDTH=32, in parallel (each holds 10 kernels).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef VKRT_WIDTH
#error "build with -DVKRT_WIDTH=16 or -DVKRT_WIDTH=32"
#endif

namespace {

constexpr int kWidth = VKRT_WIDTH;

constexpr int kTerm = -(1 << 30);
constexpr float kInf = 1e32f;

enum Mode { kClosest = 0, kAny = 1, kCandidate = 2 };

// Shape of a W-wide planar row.
template <int W>
struct Planar {
  static_assert(W == 16 || W == 32, "planar rows are 16 or 32 wide");
  static constexpr int kLT = W / 2;                 // triangles per leaf row
  static constexpr int kRowF4 = W * 2;              // float4 per row
  static constexpr int kG = W / 4;                  // float4 per interior lane group
  static constexpr int kLG = kLT / 4;               // float4 per leaf attribute
  static constexpr int kLeafShift = W == 16 ? 3 : 4;  // row = vleaf >> shift
  // Interior lane groups unrolled: all 4 at W = 16; none at W = 32, whose
  // 8 unrolled groups of 4 inlined insertions made the kernel 1.5x slower
  // and its build 2.6x longer on the H100.
  static constexpr int kUnrollG = W == 16 ? kG : 1;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ float guard_inv(float c) {
  float g = fabsf(c) < 1e-20f ? (c < 0.0f ? -1e-20f : 1e-20f) : c;
  return __fdiv_rn(1.0f, g);
}

__device__ __forceinline__ float f4get(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

__device__ __forceinline__ int i4get(const int4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// Slab test of the ray against box [lo, hi]; returns (tn, tf).
__device__ __forceinline__ void slab(const Ray& y, float bxm, float bym, float bzm, float bxM,
                                     float byM, float bzM, float& tn, float& tf) {
  float lx = __fmul_rn(__fsub_rn(bxm, y.ox), y.ix);
  float hx = __fmul_rn(__fsub_rn(bxM, y.ox), y.ix);
  float ly = __fmul_rn(__fsub_rn(bym, y.oy), y.iy);
  float hy = __fmul_rn(__fsub_rn(byM, y.oy), y.iy);
  float lz = __fmul_rn(__fsub_rn(bzm, y.oz), y.iz);
  float hz = __fmul_rn(__fsub_rn(bzM, y.oz), y.iz);
  tn = fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)), fminf(lz, hz));
  tf = fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)), fmaxf(lz, hz));
}

// Child order: stable ascending insertion of (k, r) into the n sorted
// entries of key/ref, after every key <= k. The TPU kernel sorts with a
// bitonic network, which is not stable; equal keys keep their row order here.
template <int W>
__device__ __forceinline__ void insert_child(float (&key)[W], int (&ref)[W], int n, float k,
                                             int r) {
  int j = n;
  while (j > 0 && key[j - 1] > k) {
    key[j] = key[j - 1];
    ref[j] = ref[j - 1];
    --j;
  }
  key[j] = k;
  ref[j] = r;
}

// Interior row: W-way slab test, the hit children in ascending entry order.
// Returns their number.
template <int W>
__device__ __forceinline__ int order_children(const float4* row, const Ray& y,
                                              float t_prune, float (&key)[W], int (&ref)[W]) {
  constexpr int G = Planar<W>::kG;
  int n = 0;
#pragma unroll(Planar<W>::kUnrollG)
  for (int g = 0; g < G; ++g) {
    const float4 bxm = row[0 * G + g], bym = row[1 * G + g];
    const float4 bzm = row[2 * G + g], bxM = row[3 * G + g];
    const float4 byM = row[4 * G + g], bzM = row[5 * G + g];
    const float4 rf = row[6 * G + g];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float tn, tf;
      slab(y, f4get(bxm, k), f4get(bym, k), f4get(bzm, k), f4get(bxM, k), f4get(byM, k),
           f4get(bzM, k), tn, tf);
      const bool hit = (f4get(bxm, k) <= f4get(bxM, k)) && (tn <= tf) && (tf >= 0.0f) &&
                       (tn < t_prune);
      if (hit) {
        insert_child<W>(key, ref, n, tn, (int)f4get(rf, k));
        ++n;
      }
    }
  }
  return n;
}

// Tournament min over 8 leaf slots in the reference's fold order (pairs
// (i, i+4), then (i, i+2), then (0, 1)); a slot keeps its own entry unless
// the partner's t is strictly smaller.
template <int NP>
__device__ __forceinline__ void minfold(float (&t)[8], float (&p)[NP][8]) {
#pragma unroll
  for (int k = 4; k >= 1; k >>= 1) {
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

// Leaf slots: opaque (t, orig, u, v) and, in mode c, the nearest
// alpha-flagged candidate (t, orig, u, v, uv.u, uv.v).
struct LeafSlots {
  float tt_o[8];
  float pay_o[3][8];
  float tt_c[8];
  float pay_c[5][8];
};

// The 4 triangles of leaf lane group g (lanes 4g..4g+3): Moller-Trumbore,
// written to slots s..s+3, or with FOLD folded into them: a slot takes the
// group's entry only where its t is strictly smaller. At W = 32 the fold is
// the first bracket (i, i+8) of the 16-lane tournament, so only 8 slots
// stay live.
template <int MODE, bool CULL, int W, bool FOLD>
__device__ __forceinline__ void leaf_group(const float4* row, int g, int s, int cnt,
                                           const Ray& y, float t_best, float c_t,
                                           LeafSlots& L) {
  constexpr int LG = Planar<W>::kLG;
  float4 a[16];
#pragma unroll
  for (int at = 0; at < 16; ++at) {
    const bool need = at <= 8 || at == 15 || MODE == kCandidate;
    if (need && g * 4 < cnt) a[at] = row[at * LG + g];
    else a[at] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int lane = g * 4 + k;
    const int slot = s + k;
    const float p0x = f4get(a[0], k), p0y = f4get(a[1], k), p0z = f4get(a[2], k);
    const float p1x = f4get(a[3], k), p1y = f4get(a[4], k), p1z = f4get(a[5], k);
    const float p2x = f4get(a[6], k), p2y = f4get(a[7], k), p2z = f4get(a[8], k);
    const int tmeta = (int)f4get(a[15], k);
    const int orig = tmeta >> 2;
    const int flags = tmeta & 3;
    const float e1x = __fsub_rn(p1x, p0x), e1y = __fsub_rn(p1y, p0y), e1z = __fsub_rn(p1z, p0z);
    const float e2x = __fsub_rn(p2x, p0x), e2y = __fsub_rn(p2y, p0y), e2z = __fsub_rn(p2z, p0z);
    const float pvx = __fsub_rn(__fmul_rn(y.dy, e2z), __fmul_rn(y.dz, e2y));
    const float pvy = __fsub_rn(__fmul_rn(y.dz, e2x), __fmul_rn(y.dx, e2z));
    const float pvz = __fsub_rn(__fmul_rn(y.dx, e2y), __fmul_rn(y.dy, e2x));
    const float det = __fadd_rn(__fadd_rn(__fmul_rn(e1x, pvx), __fmul_rn(e1y, pvy)),
                                __fmul_rn(e1z, pvz));
    const bool det_ok = fabsf(det) > 1e-12f;
    const bool facing = CULL ? (((flags & 1) != 0) || (det > 1e-12f)) : det_ok;
    const float inv_det = __fdiv_rn(1.0f, det_ok ? det : 1.0f);
    const float tvx = __fsub_rn(y.ox, p0x), tvy = __fsub_rn(y.oy, p0y), tvz = __fsub_rn(y.oz, p0z);
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
    const bool geo_ok = lane < cnt && det_ok && facing && uu >= 0.0f && vv >= 0.0f &&
                        __fadd_rn(uu, vv) <= 1.0f && tt > 0.0f;
    const bool is_alpha = (flags & 2) != 0;
    const bool opq = MODE == kCandidate ? (geo_ok && !is_alpha && tt < t_best)
                                        : (geo_ok && tt < t_best);
    const float to = opq ? tt : kInf;
    if (!FOLD || to < L.tt_o[slot]) {
      L.tt_o[slot] = to;
      L.pay_o[0][slot] = (float)orig;
      L.pay_o[1][slot] = uu;
      L.pay_o[2][slot] = vv;
    }
    if (MODE == kCandidate) {
      const bool alp = geo_ok && is_alpha && tt < t_best && tt < c_t;
      const float tc = alp ? tt : kInf;
      if (!FOLD || tc < L.tt_c[slot]) {
        const float wbar = __fsub_rn(__fsub_rn(1.0f, uu), vv);
        L.tt_c[slot] = tc;
        L.pay_c[0][slot] = (float)orig;
        L.pay_c[1][slot] = uu;
        L.pay_c[2][slot] = vv;
        L.pay_c[3][slot] = __fadd_rn(__fadd_rn(__fmul_rn(f4get(a[9], k), wbar),
                                               __fmul_rn(f4get(a[11], k), uu)),
                                     __fmul_rn(f4get(a[13], k), vv));
        L.pay_c[4][slot] = __fadd_rn(__fadd_rn(__fmul_rn(f4get(a[10], k), wbar),
                                               __fmul_rn(f4get(a[12], k), uu)),
                                     __fmul_rn(f4get(a[14], k), vv));
      }
    }
  }
}

// Leaf row: all W/2 triangles into 8 slots. W = 16: lane groups 0 and 1 fill
// slots 0-3 and 4-7. W = 32: groups 0 then 2 fold into slots 0-3, groups 1
// then 3 into slots 4-7, streaming the first fold bracket.
template <int MODE, bool CULL, int W>
__device__ __forceinline__ void leaf_tests(const float4* row, int cnt, const Ray& y,
                                           float t_best, float c_t, LeafSlots& L) {
  leaf_group<MODE, CULL, W, false>(row, 0, 0, cnt, y, t_best, c_t, L);
  if (W == 32) leaf_group<MODE, CULL, W, true>(row, 2, 0, cnt, y, t_best, c_t, L);
  leaf_group<MODE, CULL, W, false>(row, 1, 4, cnt, y, t_best, c_t, L);
  if (W == 32) leaf_group<MODE, CULL, W, true>(row, 3, 4, cnt, y, t_best, c_t, L);
}

// One ray from setup to its outputs. CAPPED (the capped entry only) stops
// after max_steps nodes and, with nogather, reads row r at every step
// instead of the node's row and starts over at the root where it would end.
template <int MODE, bool CULL, int MAXD, int W, bool CAPPED>
__global__ void __launch_bounds__(128)
traverse_kernel(const float4* __restrict__ rows, const float* __restrict__ origin,
                const float* __restrict__ direction, const float* __restrict__ t_max,
                const uint8_t* __restrict__ active, const int32_t* __restrict__ root0,
                int64_t n_rays, int max_steps, int nogather, float* __restrict__ out_t,
                int32_t* __restrict__ out_tri, float* __restrict__ out_u,
                float* __restrict__ out_v, int32_t* __restrict__ out_steps,
                float* __restrict__ out_uvu, float* __restrict__ out_uvv) {
  using P = Planar<W>;
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
  const float tmax = t_max[r];
  // The no-gather variant reads this ray's own row at every step (the
  // caller's table has a row for every ray).
  const bool own_row = CAPPED && nogather != 0;
  const float4* own = rows + r * P::kRowF4;

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
    for (int g = 0; g < P::kG; ++g) {
      const float4 bxm = rows[0 * P::kG + g], bym = rows[1 * P::kG + g];
      const float4 bzm = rows[2 * P::kG + g], bxM = rows[3 * P::kG + g];
      const float4 byM = rows[4 * P::kG + g], bzM = rows[5 * P::kG + g];
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
    slab(y, rmin[0], rmin[1], rmin[2], rmax[0], rmax[1], rmax[2], tn0, tf0);
    const bool hit_root = (tn0 <= tf0) && (tf0 >= 0.0f) && (tn0 < tmax);
    if (!hit_root || (active != nullptr && !active[r])) cur = kTerm;
  }

  int stack[MAXD];
  int depth = 0;

  while (true) {
    if (cur == kTerm) {
      // A no-gather ray never ends: it starts over at the root, as a TPU
      // lane keeps paying for every step of the scan.
      if (!own_row) break;
      cur = 0;
      depth = 0;
    }
    if (CAPPED && steps >= max_steps) break;
    ++steps;
    const float t_prune = MODE == kCandidate ? fminf(t_best, c_t) : t_best;
    if (cur >= 0) {
      // ---- interior: W-way slab test, stable insertion sort of hits ----
      float key[W];
      int ref[W];
      const float4* row = own_row ? own : rows + (int64_t)cur * P::kRowF4;
      const int n = order_children<W>(row, y, t_prune, key, ref);
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
      // ---- leaf: up to W/2 triangles, Moller-Trumbore, tournament min ----
      const int vleaf = -cur - 1;
      const int cnt = (vleaf & (P::kLT - 1)) + 1;
      const float4* row = own_row ? own : rows + (int64_t)(vleaf >> P::kLeafShift) * P::kRowF4;
      LeafSlots L;
      leaf_tests<MODE, CULL, W>(row, cnt, y, t_best, c_t, L);
      minfold<3>(L.tt_o, L.pay_o);
      const bool found = L.tt_o[0] < t_best;
      if (found) {
        t_best = L.tt_o[0];
        tri_best = (int)L.pay_o[0][0];
        u_best = L.pay_o[1][0];
        v_best = L.pay_o[2][0];
      }
      if (MODE == kCandidate) {
        minfold<5>(L.tt_c, L.pay_c);
        if (L.tt_c[0] < c_t) {
          c_t = L.tt_c[0];
          c_tri = (int)L.pay_c[0][0];
          c_u = L.pay_c[1][0];
          c_v = L.pay_c[2][0];
          c_uvu = L.pay_c[3][0];
          c_uvv = L.pay_c[4][0];
        }
      }
      if (MODE == kAny && found) break;
    }
    // Childless interior or finished leaf: pop. (depth never passes MAXD on
    // a real tree: the wrapper refuses trees whose exact stack bound exceeds
    // it. Only the no-gather variant's made-up nodes can push past it; those
    // pushes are dropped and their pops end the node's run, as in the twin.)
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

// The child order alone: row r's W keys (kInf for a miss) and refs, sorted
// ascending and stable by insert_child, the misses after the hits in their
// row order; out_count[r] = number of hits.
template <int W>
__global__ void __launch_bounds__(128)
sort_children_kernel(const float* __restrict__ keys, const int32_t* __restrict__ refs,
                     int64_t n, float* __restrict__ out_keys, int32_t* __restrict__ out_refs,
                     int32_t* __restrict__ out_count) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float4* kin = reinterpret_cast<const float4*>(keys + r * W);
  const int4* rin = reinterpret_cast<const int4*>(refs + r * W);
  float4 kv[W / 4];
  int4 rv[W / 4];
  float key[W];
  int ref[W];
  int cnt = 0;
#pragma unroll
  for (int g = 0; g < W / 4; ++g) {
    kv[g] = kin[g];
    rv[g] = rin[g];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (f4get(kv[g], k) < kInf) {
        insert_child<W>(key, ref, cnt, f4get(kv[g], k), i4get(rv[g], k));
        ++cnt;
      }
    }
  }
  int m = cnt;
#pragma unroll
  for (int g = 0; g < W / 4; ++g) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(f4get(kv[g], k) < kInf)) {
        key[m] = f4get(kv[g], k);
        ref[m] = i4get(rv[g], k);
        ++m;
      }
    }
  }
  float4* kout = reinterpret_cast<float4*>(out_keys + r * W);
  int4* rout = reinterpret_cast<int4*>(out_refs + r * W);
#pragma unroll
  for (int g = 0; g < W / 4; ++g) {
    kout[g] = make_float4(key[4 * g], key[4 * g + 1], key[4 * g + 2], key[4 * g + 3]);
    rout[g] = make_int4(ref[4 * g], ref[4 * g + 1], ref[4 * g + 2], ref[4 * g + 3]);
  }
  out_count[r] = cnt;
}

struct Args {
  const float* rows;
  const float* o;
  const float* d;
  const float* tmax;
  const uint8_t* active;
  const int32_t* root0;
  int64_t n;
  int max_steps;
  int nogather;
  float* t;
  int32_t* tri;
  float* u;
  float* v;
  int32_t* steps;
  float* uvu;
  float* uvv;
};

template <int MODE, bool CULL, int MAXD, int W, bool CAPPED>
void launch(const Args& a, cudaStream_t stream) {
  const int threads = 128;
  const int64_t blocks = (a.n + threads - 1) / threads;
  traverse_kernel<MODE, CULL, MAXD, W, CAPPED><<<(unsigned)blocks, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(a.rows), a.o, a.d, a.tmax, a.active, a.root0,
      a.n, a.max_steps, a.nogather, a.t, a.tri, a.u, a.v, a.steps, a.uvu, a.uvv);
}

template <int MAXD, int W = kWidth>
void dispatch(int mode, int cull, const Args& a, cudaStream_t s) {
  if (mode == kClosest)
    launch<kClosest, true, MAXD, W, false>(a, s);
  else if (mode == kAny)
    launch<kAny, false, MAXD, W, false>(a, s);
  else if (cull)
    launch<kCandidate, true, MAXD, W, false>(a, s);
  else
    launch<kCandidate, false, MAXD, W, false>(a, s);
}

}  // namespace

extern "C" {

// Largest stack depth any instantiation holds; the wrapper refuses trees
// whose exact stack bound exceeds it.
int vkrt_traverse_max_stack() { return 128; }

// mode: 0 closest hit (backface culling), 1 any hit (no culling, first
// accepted hit ends the ray), 2 nearest alpha candidate (culling per
// `cull`); width: this library's VKRT_WIDTH. `active` may be null; `root0`
// may be null (every ray starts at row 0 after the root union-box test) or
// hold each ray's interior root row. Returns cudaGetLastError() after launch.
int vkrt_traverse(int mode, int cull, int width, const float* rows, int stack_depth,
                  const float* origin, const float* direction, const float* t_max,
                  const uint8_t* active, const int32_t* root0, int64_t n_rays, float* t,
                  int32_t* tri, float* u, float* v, int32_t* steps, float* uvu, float* uvv,
                  void* stream) {
  if (width != kWidth) return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Args a{rows, origin, direction, t_max, active, root0, n_rays, 0, 0,
               t, tri, u, v, steps, uvu, uvv};
  if (stack_depth <= 64) dispatch<64>(mode, cull, a, s);
  else dispatch<128>(mode, cull, a, s);
  return (int)cudaGetLastError();
}

// Closest hit (backface culling, from the root) stopped after `max_steps`
// nodes per ray, with a 128-entry stack. With `nogather` != 0, ray r reads
// row r of the n_rows-row table (n_rows >= n_rays) at every step, whatever
// its node is, interprets it by the sign of its node ref, and starts over at
// the root where it would end, so every ray runs max_steps nodes: a timing
// variant whose hits are wrong by design. Returns cudaGetLastError() after
// launch.
int vkrt_traverse_capped(int width, const float* rows, int64_t n_rows, int stack_depth,
                         const float* origin, const float* direction, const float* t_max,
                         int64_t n_rays, int max_steps, int nogather, float* t, int32_t* tri,
                         float* u, float* v, int32_t* steps, void* stream) {
  if (width != kWidth || stack_depth > 128 || (nogather && n_rows < n_rays))
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Args a{rows, origin, direction, t_max, nullptr, nullptr, n_rays, max_steps, nogather,
               t, tri, u, v, steps, nullptr, nullptr};
  launch<kClosest, true, 128, kWidth, true>(a, s);
  return (int)cudaGetLastError();
}

// The child order of n rows of `width` (this library's VKRT_WIDTH) keys and
// refs: keys ascending and stable, each ref following its key, misses (keys
// not below 1e32) after the hits in row order; out_count = hits per row.
// Returns cudaGetLastError() after launch.
int vkrt_sort_children(const float* keys, const int32_t* refs, int64_t n, int width,
                       float* out_keys, int32_t* out_refs, int32_t* out_count, void* stream) {
  if (width != kWidth) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  sort_children_kernel<kWidth><<<blocks, threads, 0, s>>>(keys, refs, n, out_keys, out_refs,
                                                          out_count);
  return (int)cudaGetLastError();
}

}  // extern "C"
