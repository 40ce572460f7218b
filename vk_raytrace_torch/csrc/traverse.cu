// BVH traversal over planar rows of width W = 16 or 32. Modes a and b from
// the root (the main path's closest-hit and shadow rays), the capped entry
// and the round machines run in persistent warps with the stack in shared
// memory (vkrt_traverse_ab, vkrt_traverse_capped, vkrt_alpha_rounds,
// vkrt_opaque_machine, vkrt_alpha_machine: see "Modes a and b from the
// root", "The capped entry" and "The round machines" below); the per-round
// entries (vkrt_traverse) run trace<>, a thread per launched ray with a
// full-depth stack in local memory.
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
// changes.
//
// Seven more entries:
//   vkrt_traverse_ab: modes a and b from the root, persistent warps;
//   vkrt_root_prefilter: which rays the single-level alpha rounds need (the
//     per-child slab test against the root row; see "The alpha pass's root
//     prefilter" below), a thread a ray; vkrt_alpha_rounds runs the same
//     test at its ray intake, so the main path never launches it;
//   vkrt_alpha_rounds, vkrt_opaque_machine, vkrt_alpha_machine: the round
//     machines (see "The round machines" below), each a host loop of
//     traversal rounds run whole in one launch, in persistent warps on the
//     a/b entry's node code: the single-level alpha candidate rounds of
//     ops/traverse_alpha.py (each round from the alpha tree's root, then
//     the stochastic test), and the two-level opaque and alpha rounds of
//     ops/tlas.py (instance enumeration in entry order over the instance
//     table, the ray transform, the traversal of the instance's BLAS and,
//     for alpha, the stochastic test);
//   vkrt_sort_children: the child order of interior rows alone (the
//     counterpart of the TPU kernel's bitonic network _bitonic, which the
//     reference unit-tests through its own pallas_call, tests/test_fused.py),
//     a row per W lanes ranked in registers;
//   vkrt_traverse_capped: closest hit stopped after max_steps nodes, and its
//     no-gather variant, in which ray r reads row r at every step whatever
//     its node is and starts over at the root whenever its made-up nodes end
//     it, so every ray runs max_steps nodes (the timing variant of
//     scripts/stepbench.py: it shows what the dependent row gather costs; its
//     hits are wrong by design), on the persistent node loops of modes a/b.
//
// Numerics follow the plain torch twin (ops/traverse_fused.py
// _traverse_plain) operation by operation, with explicitly rounded
// intrinsics, -fmad=false and IEEE division, so t/u/v agree with the twin
// to within a few ulp and child order and leaf tie-breaks are the twin's.
//
// One library per row width: the wrapper builds this file twice, with
// -DVKRT_WIDTH=16 and -DVKRT_WIDTH=32, in parallel (26 kernels at width 16, 24 at 32).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "traverse_common.cuh"

#ifndef VKRT_WIDTH
#error "build with -DVKRT_WIDTH=16 or -DVKRT_WIDTH=32"
#endif

namespace {

constexpr int kWidth = VKRT_WIDTH;

constexpr int kTerm = -(1 << 30);

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

__device__ __forceinline__ float f4get(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// The no-gather variant's own row, the same row at every step, as a pointer
// the compiler must take as new at each step: the step's loads may then be
// neither hoisted out of the node loops nor shared between steps (with the
// plain pointer the compiler hoisted the row and its slab tests out of the
// interior loop: 0.133 ms at width 16, the node work gone; PERF.md), while
// within a step they issue together as any row's do.
__device__ __forceinline__ const float4* step_row(const float4* row) {
#ifdef __CUDA_ARCH__
  asm volatile("mov.b64 %0, %0;" : "+l"(row));
#endif
  return row;
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

// What one traversal gives back for its ray: mode c reports the nearest
// alpha candidate (with its texture uv), modes a and b the nearest hit; t is
// kInf where there is none.
struct TraceOut {
  float t, u, v, uvu, uvv;
  int tri, steps;
};

// One ray's traversal from node `cur` (kTerm: nothing to do) with window
// (0, tmax): the per-node code of the per-round entries (vkrt_traverse).
template <int MODE, bool CULL, int MAXD, int W>
__device__ __forceinline__ void trace(const float4* __restrict__ rows, const Ray& y, float tmax,
                                      int cur, TraceOut& out) {
  using P = Planar<W>;

  // Opaque slot; candidate slot (nearest alpha-flagged hit) in mode c.
  float t_best = tmax, u_best = 0.0f, v_best = 0.0f;
  int tri_best = -1;
  float c_t = tmax, c_u = 0.0f, c_v = 0.0f, c_uvu = 0.0f, c_uvv = 0.0f;
  int c_tri = -1;
  int steps = 0;

  int stack[MAXD];
  int depth = 0;

  while (cur != kTerm) {
    ++steps;
    const float t_prune = MODE == kCandidate ? fminf(t_best, c_t) : t_best;
    if (cur >= 0) {
      // ---- interior: W-way slab test, stable insertion sort of hits ----
      float key[W];
      int ref[W];
      const int n = order_children<W>(rows + (int64_t)cur * P::kRowF4, y, t_prune, key, ref);
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
      LeafSlots L;
      leaf_tests<MODE, CULL, W>(rows + (int64_t)(vleaf >> P::kLeafShift) * P::kRowF4, cnt, y,
                                t_best, c_t, L);
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
    out.t = c_tri >= 0 ? c_t : kInf;
    out.tri = c_tri;
    out.u = c_u;
    out.v = c_v;
    out.uvu = c_uvu;
    out.uvv = c_uvv;
  } else {
    out.t = tri_best >= 0 ? t_best : kInf;
    out.tri = tri_best;
    out.u = u_best;
    out.v = v_best;
  }
  out.steps = steps;
}

// The union box of the root row's valid children (rows from row 0).
template <int W>
__device__ __forceinline__ void root_union(const float4* __restrict__ rows, float (&rmin)[3],
                                           float (&rmax)[3]) {
  using P = Planar<W>;
  rmin[0] = rmin[1] = rmin[2] = 3.0e38f;
  rmax[0] = rmax[1] = rmax[2] = -3.0e38f;
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
}

// Ray setup from the tree's root: the union box hit within (0, tmax). A NaN
// plane distance (a NaN in the origin or the direction, or an infinite
// direction component against an infinite offset: a round's window start
// o + d * 0) makes the root a miss, as torch's NaN propagation does in the
// twin (_root_union_hit); fminf / fmaxf would drop it. Past the root no
// plane distance is NaN: a child's box is finite, so its distances are NaN
// only where the root's are.
__device__ __forceinline__ bool enters_root(const Ray& y, const float (&rmin)[3],
                                            const float (&rmax)[3], float tmax) {
  const float lx = __fmul_rn(__fsub_rn(rmin[0], y.ox), y.ix);
  const float hx = __fmul_rn(__fsub_rn(rmax[0], y.ox), y.ix);
  const float ly = __fmul_rn(__fsub_rn(rmin[1], y.oy), y.iy);
  const float hy = __fmul_rn(__fsub_rn(rmax[1], y.oy), y.iy);
  const float lz = __fmul_rn(__fsub_rn(rmin[2], y.oz), y.iz);
  const float hz = __fmul_rn(__fsub_rn(rmax[2], y.oz), y.iz);
  if (lx != lx || hx != hx || ly != ly || hy != hy || lz != lz || hz != hz) return false;
  const float tn0 = fmaxf(fmaxf(fminf(lx, hx), fminf(ly, hy)), fminf(lz, hz));
  const float tf0 = fminf(fminf(fmaxf(lx, hx), fmaxf(ly, hy)), fmaxf(lz, hz));
  return (tn0 <= tf0) && (tf0 >= 0.0f) && (tn0 < tmax);
}

// The persistent entries' copy of the root's union box in shared memory:
// thread 0 of the block writes it to s_root (min xyz, max xyz); the block
// syncs before reading it.
template <int W>
__device__ __forceinline__ void share_root_box(const float4* __restrict__ rows, float* s_root) {
  if (threadIdx.x == 0) {
    float rmin[3], rmax[3];
    root_union<W>(rows, rmin, rmax);
    for (int k = 0; k < 3; ++k) {
      s_root[k] = rmin[k];
      s_root[3 + k] = rmax[k];
    }
  }
}

// enters_root against the shared box.
__device__ __forceinline__ bool enters_shared_root(const Ray& y, const float* s_root,
                                                   float tmax) {
  const float rmin[3] = {s_root[0], s_root[1], s_root[2]};
  const float rmax[3] = {s_root[3], s_root[4], s_root[5]};
  return enters_root(y, rmin, rmax, tmax);
}

// One ray from setup to its outputs.
template <int MODE, bool CULL, int MAXD, int W>
__global__ void __launch_bounds__(128)
traverse_kernel(const float4* __restrict__ rows, const float* __restrict__ origin,
                const float* __restrict__ direction, const float* __restrict__ t_max,
                const uint8_t* __restrict__ active, const int32_t* __restrict__ root0,
                int64_t n_rays, float* __restrict__ out_t,
                int32_t* __restrict__ out_tri, float* __restrict__ out_u,
                float* __restrict__ out_v, int32_t* __restrict__ out_steps,
                float* __restrict__ out_uvu, float* __restrict__ out_uvv) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;

  const Ray y = load_ray(origin, direction, r);
  const float tmax = t_max[r];

  // Ray setup: the lane must be active, and without per-lane roots the
  // union box of the root's valid children must be hit within (0, t_max).
  int cur = 0;
  if (root0 != nullptr) {
    cur = (active != nullptr && !active[r]) ? kTerm : root0[r];
  } else {
    float rmin[3], rmax[3];
    root_union<W>(rows, rmin, rmax);
    if (!enters_root(y, rmin, rmax, tmax) || (active != nullptr && !active[r])) cur = kTerm;
  }

  TraceOut h;
  trace<MODE, CULL, MAXD, W>(rows, y, tmax, cur, h);
  out_t[r] = h.t;
  out_tri[r] = h.tri;
  out_u[r] = h.u;
  out_v[r] = h.v;
  if (MODE == kCandidate) {
    out_uvu[r] = h.uvu;
    out_uvv[r] = h.uvv;
  }
  out_steps[r] = h.steps;
}

// ---------------------------------------------------------------------------
// Modes a and b from the root (vkrt_traverse_ab): the main path's closest-hit
// and shadow rays. Each ray visits the same nodes in the same order as in
// trace<>, with the same float32 operations, so every output (steps
// included) is the same bit for bit; what changes is how the work executes:
//   * persistent warps (Aila & Laine, "Understanding the Efficiency of Ray
//     Traversal on GPUs", HPG 2009): as many blocks as reside on the card; a
//     warp takes rays from a global counter, one atomicAdd for all its idle
//     lanes, once kRefill of them are idle, so lanes whose rays ended (any
//     hit ends at the first hit) get new rays instead of waiting for the
//     warp's slowest ray; it steps interior nodes until every lane is at a
//     leaf or done, then leaves until every lane is at an interior node or
//     done, so a warp does not run both kinds of node in one step;
//   * the stack out of local memory: entries [0, kShStack) of each thread in
//     shared memory, laid out by thread (entry d of thread t at
//     d * blockDim.x + t, so the lanes of a warp hit 32 banks), deeper ones
//     in the thread's column of a global spill that the wrapper allocates
//     (exact: a ray keeps its whole stack, up to the tree's bound);
//   * an interior row skips the slab tests and loads of a lane group of 4
//     children with no valid child (most interior rows of the atrium's
//     16-wide tree hold fewer than 8 children);
//   * registers against warps: 96 a thread at width 16 (5 blocks of 128, 20
//     warps, an SM), 128 at width 32 (4 blocks); 64 for 32 warps spilled and
//     ran slower.
// The child order stays trace<>'s insertion into a key/ref list: ranking
// the W children in registers (each hit child's rank the number of hits j
// with key_j < key_i, or key_j == key_i and j < i) costs W * (W - 1)
// compares a row and ran 11-18% slower on the H100 (PERF.md). At width 16
// the list lies in shared memory, laid out by thread like the stack, which
// ran 9% faster than local memory; at width 32 its 256 B a thread would
// take 32 KB a block from the L1, which ran 5% slower, so it stays in local
// memory.
// Which ray a lane carries never changes that ray's result. (The per-round
// entries that run trace<> keep its per-node code as it was.)
// ---------------------------------------------------------------------------

constexpr int kAbThreads = 128;
constexpr int kAbMinBlocks = kWidth == 16 ? 5 : 4;  // __launch_bounds__: 96 / 128 registers
constexpr int kRefill = 8;  // a warp fetches rays once this many lanes idle
// The stack (traverse_common.cuh): kShStack entries a thread in shared memory
// (8 KB a block, beside the child list's 16 KB at width 16); the rays of the
// atrium reach depth 12 at either width.

// One thread's child list: entry j at key[j * stride], ref[j * stride].
struct ChildList {
  float* key;
  int* ref;
  int stride;
};

// Pop the next node (kTerm on an empty stack). lim: the tree's exact stack
// bound, which no real traversal passes; pushes past it are dropped and
// their pops end the ray, as in the twin. S: Stack, or the capped entry's
// RingStack.
template <class S = Stack>
__device__ __forceinline__ int pop(const S& st, int& depth, int lim) {
  if (depth == 0) return kTerm;
  --depth;
  return depth < lim ? st.get(depth) : kTerm;
}

// Interior row: order_children's hit children in ascending entry order (a
// stable insertion into the list, after every key <= the new one), a lane
// group with no valid child skipped; all but the nearest pushed
// far-to-near, as trace<> pushes them. Returns the nearest, or pops where
// no child is hit. WHOLE (the no-gather variant's own rows): every lane
// group's seven float4 read before its test, no group skipped (a read that
// waits on the group's bounds is a second round trip to memory a step).
template <int W, bool WHOLE = false, class S = Stack>
__device__ __forceinline__ int interior_step(const float4* __restrict__ row, const Ray& y,
                                             float t_prune, const ChildList& cl, const S& st,
                                             int& depth, int lim, int& deepest) {
  constexpr int G = Planar<W>::kG;
  float* const key = cl.key;
  int* const ref = cl.ref;
  const int ls = cl.stride;
  int n = 0;
#pragma unroll(Planar<W>::kUnrollG)
  for (int g = 0; g < G; ++g) {
    const float4 bxm = row[0 * G + g], bxM = row[3 * G + g];
    if (!WHOLE && !(bxm.x <= bxM.x || bxm.y <= bxM.y || bxm.z <= bxM.z || bxm.w <= bxM.w))
      continue;
    const float4 bym = row[1 * G + g], bzm = row[2 * G + g];
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
        int j = n;
        while (j > 0 && key[(j - 1) * ls] > tn) {
          key[j * ls] = key[(j - 1) * ls];
          ref[j * ls] = ref[(j - 1) * ls];
          --j;
        }
        key[j * ls] = tn;
        ref[j * ls] = (int)f4get(rf, k);
        ++n;
      }
    }
  }
  if (n == 0) return pop(st, depth, lim);
  for (int k = n - 1; k >= 1; --k) {
    if (depth < lim) st.put(depth, ref[k * ls]);
    ++depth;
  }
  deepest = max(deepest, depth);
  return ref[0];
}

// One lane's hits in a traversal: the nearest opaque hit (t starts at the
// window end) and, in mode c, the nearest alpha-flagged candidate (ct starts
// there too), as trace<> keeps them.
struct Hits {
  float t, u, v;
  int tri;
  float ct, cu, cv, cuvu, cuvv;
  int ctri;
};

// Leaf row `cur`: its triangles against both slots in trace<>'s order (the
// opaque tournament, then in mode c the candidate's). Returns the next node:
// kTerm at any hit's first hit, else a pop. OWN (the capped entry's
// no-gather variant): the triangles of row `own`, the leaf's count from
// `cur`.
template <int MODE, bool CULL, int W, bool OWN = false, class S = Stack>
__device__ __forceinline__ int leaf_step(const float4* __restrict__ rows, int cur, const Ray& y,
                                         Hits& h, const S& st, int& depth, int lim,
                                         const float4* own = nullptr) {
  using P = Planar<W>;
  const int vleaf = -cur - 1;
  const int cnt = (vleaf & (P::kLT - 1)) + 1;
  LeafSlots L;
  leaf_tests<MODE, CULL, W>(OWN ? step_row(own)
                                : rows + (int64_t)(vleaf >> P::kLeafShift) * P::kRowF4,
                            cnt, y, h.t, MODE == kCandidate ? h.ct : h.t, L);
  minfold<3>(L.tt_o, L.pay_o);
  const bool found = L.tt_o[0] < h.t;
  if (found) {
    h.t = L.tt_o[0];
    h.tri = (int)L.pay_o[0][0];
    h.u = L.pay_o[1][0];
    h.v = L.pay_o[2][0];
  }
  if (MODE == kCandidate) {
    minfold<5>(L.tt_c, L.pay_c);
    if (L.tt_c[0] < h.ct) {
      h.ct = L.tt_c[0];
      h.ctri = (int)L.pay_c[0][0];
      h.cu = L.pay_c[1][0];
      h.cv = L.pay_c[2][0];
      h.cuvu = L.pay_c[3][0];
      h.cuvv = L.pay_c[4][0];
    }
  }
  return MODE == kAny && found ? kTerm : pop(st, depth, lim);
}

// The no-gather variant's ray, where its made-up nodes end it: over at the
// root with an empty stack, as a TPU lane keeps paying for every step.
__device__ __forceinline__ void restart(int& cur, int& depth) {
  cur = 0;
  depth = 0;
}

// Interior rows until this lane is at a leaf or done (mode c prunes with
// the nearer of both slots, as trace<> does), one step counted for each.
// The capped entry's walk: CAPPED stops the lane at `cap` steps; OWN reads
// row `own` at every node, whatever the node, and restarts the ray where
// it would end (the no-gather variant).
template <int MODE, int W, bool CAPPED = false, bool OWN = false, class S = Stack>
__device__ __forceinline__ void interior_nodes(const float4* __restrict__ rows, int& cur,
                                               const Ray& y, const Hits& h, const ChildList& cl,
                                               const S& st, int& depth, int lim, int& deepest,
                                               int& steps, int cap = 0,
                                               const float4* own = nullptr) {
  while (cur >= 0) {
    if (CAPPED && steps >= cap) break;
    ++steps;
    const float4* row = OWN ? step_row(own) : rows + (int64_t)cur * Planar<W>::kRowF4;
    cur = interior_step<W, OWN>(row, y, MODE == kCandidate ? fminf(h.t, h.ct) : h.t, cl, st,
                                depth, lim, deepest);
    if (OWN && cur == kTerm) restart(cur, depth);
  }
}

// Leaves until this lane is at an interior row or done, one step counted
// for each (CAPPED, OWN: as interior_nodes).
template <int MODE, bool CULL, int W, bool CAPPED = false, bool OWN = false, class S = Stack>
__device__ __forceinline__ void leaf_nodes(const float4* __restrict__ rows, int& cur,
                                           const Ray& y, Hits& h, const S& st, int& depth,
                                           int lim, int& steps, int cap = 0,
                                           const float4* own = nullptr) {
  while (cur < 0 && cur != kTerm) {
    if (CAPPED && steps >= cap) break;
    ++steps;
    cur = leaf_step<MODE, CULL, W, OWN>(rows, cur, y, h, st, depth, lim, own);
    if (OWN && cur == kTerm) restart(cur, depth);
  }
}

template <int MODE, bool CULL, int W>
__global__ void __launch_bounds__(kAbThreads, kAbMinBlocks)
persistent_traverse_kernel(const float4* __restrict__ rows, const float* __restrict__ origin,
                           const float* __restrict__ direction, const float* __restrict__ t_max,
                           const uint8_t* __restrict__ active, int n_rays, int lim,
                           int* __restrict__ scratch, int64_t n_slots,
                           float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                           float* __restrict__ out_u, float* __restrict__ out_v,
                           int32_t* __restrict__ out_steps) {
  constexpr bool kListShared = W == 16;
  __shared__ int sh_stack[kShStack * kAbThreads];
  __shared__ float s_root[6];
  __shared__ float sh_key[kListShared ? W * kAbThreads : 1];
  __shared__ int sh_ref[kListShared ? W * kAbThreads : 1];
  float l_key[kListShared ? 1 : W];
  int l_ref[kListShared ? 1 : W];
  share_root_box<W>(rows, s_root);
  __syncthreads();

  const unsigned lanes = __ballot_sync(0xffffffffu, true);
  const int lane = threadIdx.x & 31;
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const Stack st{sh_stack + threadIdx.x, (int)blockDim.x, scratch + kScratchHead + slot, n_slots};
  const ChildList cl = kListShared
                           ? ChildList{sh_key + threadIdx.x, sh_ref + threadIdx.x, (int)blockDim.x}
                           : ChildList{l_key, l_ref, 1};

  Ray y;
  Hits h;
  int ray = -1, cur = kTerm, depth = 0, steps = 0, deepest = 0;
  bool more = true;  // the counter may still hold rays (the same in every lane)
  while (true) {
    const unsigned idle = __ballot_sync(lanes, cur == kTerm);
    if (!more && idle == lanes) break;
    const int64_t r = fetch<kRefill>(lanes, idle, lane, scratch, n_rays, more);
    if (r >= 0) {
      ray = (int)r;
      y = load_ray(origin, direction, r);
      h.t = t_max[r];
      h.tri = -1;
      h.u = h.v = 0.0f;
      steps = 0;
      depth = 0;
      const bool go = enters_shared_root(y, s_root, h.t) && (active == nullptr || active[r]);
      cur = go ? 0 : kTerm;
    }
    interior_nodes<MODE, W>(rows, cur, y, h, cl, st, depth, lim, deepest, steps);
    leaf_nodes<MODE, CULL, W>(rows, cur, y, h, st, depth, lim, steps);
    if (ray >= 0 && cur == kTerm) {
      out_t[ray] = h.tri >= 0 ? h.t : kInf;
      out_tri[ray] = h.tri;
      out_u[ray] = h.u;
      out_v[ray] = h.v;
      out_steps[ray] = steps;
      ray = -1;
    }
  }
  deepest = __reduce_max_sync(lanes, deepest);
  if (lane == 0) atomicMax(scratch + 1, deepest);
}

// ---------------------------------------------------------------------------
// The capped entry (vkrt_traverse_capped): the counterpart of the
// reference's stepbench kernel, scripts/stepbench.py (its `base`, 8 launches
// of the step kernel vk_raytrace_tpu/ops/traverse_fused.py:644, and its
// no-gather step, the pallas_call at :121). Mode a from the root, each ray
// stopped after max_steps nodes; NOGATHER: ray r reads row r of the table
// at every node, whatever the node is (its kind from the sign of the ref,
// a leaf's count from the ref), and starts over at the root with an empty
// stack where its made-up nodes end it, so every ray runs max_steps nodes
// (its hits are wrong by design: the reference's measure of what the
// dependent row gather costs).
//
// It runs on mode a's persistent node loops (fetch, interior_nodes,
// leaf_nodes; the stack and at width 16 the child list in shared memory,
// the root box in shared memory), so that the travbench attribution of
// modes a/b (full against capped against no-gather) compares one design.
// A lane counts its ray's steps; at the cap the ray ends, writes its
// outputs and frees the lane.
//
// The stack, as the twin's: the tree's exact bound (capped), or
// kCappedStack entries (no-gather: pushes past it are dropped and a pop
// past it ends the node's run). A ray that runs at most max_steps nodes
// pops at most one entry a node, so an entry pushed at depth d can only be
// overwritten by a push at d + kShStack or deeper, and read again after
// kShStack + 1 more pops: more nodes than the ray runs while max_steps <
// kShStack. Below that line the RING instantiations (width 16) keep the
// kShStack shared entries as a ring (entry d at d mod kShStack), exact with
// no spill; at or above it, and at width 32, the persistent entries' stack
// with its exact global spill. On the H100 the ring ran 3% (capped) and 2%
// (no-gather) faster at width 16 at 8 steps, with fewer register spills,
// and no faster than the spread at width 32 (PERF.md).
//
// What bounds the no-gather variant on this card: its own rows, a distinct
// row a ray (268 MB of them at width 16, 537 MB at 32), re-read at every
// step. Its kernels keep few enough blocks resident (kNogatherCarveout)
// that a lane's row stays in L1 between its steps: at the a/b entry's
// occupancy, with the default split of shared memory and L1, they ran 1.8x
// (width 16) and 5x (width 32) slower (PERF.md). Each step reads its row through
// step_row, as each step launch of the reference's does.
// ---------------------------------------------------------------------------

constexpr int kCappedStack = 128;  // traverse_fused.CAPPED_STACK

// One thread's stack as a ring of its kShStack shared entries (stride
// blockDim.x, laid out by thread as Stack's).
struct RingStack {
  int* sh;
  int stride;

  __device__ __forceinline__ void put(int d, int v) const { sh[(d & (kShStack - 1)) * stride] = v; }
  __device__ __forceinline__ int get(int d) const { return sh[(d & (kShStack - 1)) * stride]; }
};
static_assert((kShStack & (kShStack - 1)) == 0, "the ring indexes its entries by a mask");

// A thread's stack: its first shared entry `sh` (stride blockDim.x) and, for
// Stack, its first spill entry (stride n_slots).
template <class S>
__device__ __forceinline__ S thread_stack(int* sh, int stride, int* spill, int64_t n_slots);
template <>
__device__ __forceinline__ Stack thread_stack<Stack>(int* sh, int stride, int* spill,
                                                     int64_t n_slots) {
  return Stack{sh, stride, spill, n_slots};
}
template <>
__device__ __forceinline__ RingStack thread_stack<RingStack>(int* sh, int stride, int*, int64_t) {
  return RingStack{sh, stride};
}

template <int W, bool NOGATHER, bool RING>
__global__ void __launch_bounds__(kAbThreads, kAbMinBlocks)
capped_traverse_kernel(const float4* __restrict__ rows, const float* __restrict__ origin,
                       const float* __restrict__ direction, const float* __restrict__ t_max,
                       int n_rays, int max_steps, int lim, int* __restrict__ scratch,
                       int64_t n_slots, float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                       float* __restrict__ out_u, float* __restrict__ out_v,
                       int32_t* __restrict__ out_steps) {
  using S = typename std::conditional<RING, RingStack, Stack>::type;
  constexpr bool kListShared = W == 16;
  __shared__ int sh_stack[kShStack * kAbThreads];
  __shared__ float s_root[6];
  __shared__ float sh_key[kListShared ? W * kAbThreads : 1];
  __shared__ int sh_ref[kListShared ? W * kAbThreads : 1];
  float l_key[kListShared ? 1 : W];
  int l_ref[kListShared ? 1 : W];
  share_root_box<W>(rows, s_root);
  __syncthreads();

  const unsigned lanes = __ballot_sync(0xffffffffu, true);
  const int lane = threadIdx.x & 31;
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const S st = thread_stack<S>(sh_stack + threadIdx.x, (int)blockDim.x,
                               scratch + kScratchHead + slot, n_slots);
  const ChildList cl = kListShared
                           ? ChildList{sh_key + threadIdx.x, sh_ref + threadIdx.x, (int)blockDim.x}
                           : ChildList{l_key, l_ref, 1};

  Ray y;
  Hits h;
  const float4* own = nullptr;  // NOGATHER: the ray's own row
  int ray = -1, cur = kTerm, depth = 0, steps = 0, deepest = 0;
  bool more = true;  // the counter may still hold rays (the same in every lane)
  while (true) {
    const unsigned idle = __ballot_sync(lanes, ray < 0);
    if (!more && idle == lanes) break;
    const int64_t r = fetch<kRefill>(lanes, idle, lane, scratch, n_rays, more);
    if (r >= 0) {
      ray = (int)r;
      y = load_ray(origin, direction, r);
      h.t = t_max[r];
      h.tri = -1;
      h.u = h.v = 0.0f;
      steps = 0;
      depth = 0;
      // A no-gather ray that misses the root's box would start over at the
      // root at once.
      cur = NOGATHER || enters_shared_root(y, s_root, h.t) ? 0 : kTerm;
      if (NOGATHER) own = rows + r * Planar<W>::kRowF4;
    }
    interior_nodes<kClosest, W, true, NOGATHER>(rows, cur, y, h, cl, st, depth, lim, deepest,
                                                steps, max_steps, own);
    leaf_nodes<kClosest, true, W, true, NOGATHER>(rows, cur, y, h, st, depth, lim, steps,
                                                  max_steps, own);
    if (ray >= 0 && (cur == kTerm || steps >= max_steps)) {
      out_t[ray] = h.tri >= 0 ? h.t : kInf;
      out_tri[ray] = h.tri;
      out_u[ray] = h.u;
      out_v[ray] = h.v;
      out_steps[ray] = steps;
      ray = -1;
      cur = kTerm;
    }
  }
  deepest = __reduce_max_sync(lanes, deepest);
  if (lane == 0) atomicMax(scratch + 1, deepest);
}

// ---------------------------------------------------------------------------
// The round machines: each runs a host loop of rounds whole, one launch for
// every round of every ray. The TPU ran every round as one traversal of its
// step kernel (vk_raytrace_tpu/ops/traverse_fused.py:644) inside a
// device-side loop over the whole batch:
//   alpha_rounds_kernel: the single-level alpha candidate rounds
//     (ops/traverse_alpha.py _rounds_core; the reference's rounds reach the
//     step kernel through vk_raytrace_tpu/ops/traverse_alpha.py:128);
//   opaque_machine_kernel: the two-level opaque rounds, modes a and b with
//     per-lane roots (ops/tlas.py _two_level_pass; the reference's rounds at
//     vk_raytrace_tpu/ops/tlas.py:495-505);
//   alpha_machine_kernel: the two-level alpha rounds (ops/tlas.py
//     _two_level_alpha_pass; vk_raytrace_tpu/ops/tlas.py:695).
//
// What bounds them: the traversals (dependent BLAS row reads and divergence,
// as in vkrt_traverse), rays of one warp that need different numbers of
// rounds (1 to 64), and in the two-level machines the per-round instance
// scan. What a machine removes is the host loop: per round a live-lane
// gather, the window or transform, a launch, the alpha test or the candidate
// argmin over an (R, I) entry table as tens of small torch ops, the scatters
// and a host sync. A ray's state (window, best hit, seed, last instance)
// stays in registers across its rounds. The two-level machines hold the
// instance table (subset world box, world-to-object rows and BLAS root of
// each instance, 76 B) in shared memory up to kMaxInstances instances, where
// every thread of a warp reads the same instance at once; above, a table too
// large for a block's shared memory, they read it from global memory through
// the read-only path (GLOBAL instantiations, no dynamic shared memory), with
// the same arithmetic, so both give the same bits. The next candidate is the
// slab test recomputed against the table, so no per-ray entry table exists.
// The table, the enumeration and the ray transform live in
// traverse_common.cuh, which the wide back end's machine (traverse_wide.cu)
// shares.
//
// All three run in persistent warps, as vkrt_traverse_ab (their first
// design ran a thread per ray through trace<>, with a full-depth stack in
// local memory, which made a warp wait for its slowest ray's last round): a
// lane whose ray has ended takes a new one from the counter; a lane keeps
// its ray's state between rounds, and its round ends where the round's
// traversal does, inside the warp's interior and leaf loops
// (interior_nodes, leaf_nodes: the node code of the a/b entry, with mode
// c's candidate slot); before the warp's next node step the lane settles
// the round (the alpha test, the window advance) and starts its next round
// or writes its outputs; in the two-level machines a lane
// that needs its next instance waits until enough lanes of its warp do
// (scan_batch), so that their scans of the table run together. The stack,
// and at width 16 the child list, lie in shared memory (beside the instance
// table in the two-level machines; beside the root's union box in the
// single-level rounds, which start every round at the root).
// Every arithmetic step is the first design's, in its order, so every output
// is the same bit for bit; which lane carries a ray never changes its result.
// Each warp also counts its node steps, for the share of its lanes' steps
// that do work (scratch words 2 and 3, machine_counts below; the
// single-level rounds at width 16 only).
// ---------------------------------------------------------------------------

constexpr float kAlphaMask = 1.0f;  // models/schema.py ALPHA_MASK
constexpr int kWrapRepeat = 0, kWrapClamp = 1;  // ops/texture.py
// traverse_alpha._ADV_REL / _ADV_ABS, rounded to float32 from the Python
// doubles as torch rounds a scalar operand.
constexpr float kAdvMul = (float)(1.0 + 1e-4);
constexpr float kAdvAbs = (float)1e-5;
constexpr float kInv255 = (float)(1.0 / 255.0);

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

// traverse_alpha._alpha_accept for one candidate, operation for operation:
// the triangle's AlphaPack row (a_factor, mode, cutoff, tex_id, uv transform
// 3x2, atlas x/y/w/h, wrap s/t), the texel its uv falls in, and one PCG step
// (ops/rng.py rand), which advances `seed`. Returns whether it passes.
__device__ __forceinline__ bool alpha_accept(const float* __restrict__ pack, int64_t n_pack,
                                             const uint8_t* __restrict__ plane, int64_t n_plane,
                                             int64_t atlas_w, int tri, float uvu, float uvv,
                                             uint32_t& seed) {
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
  const float opacity = a0.y == kAlphaMask ? (alpha > a0.z ? 1.0f : 0.0f) : alpha;
  const uint32_t prev = seed * 747796405u + 2891336453u;
  const uint32_t word = ((prev >> ((prev >> 28) + 4u)) ^ prev) * 277803737u;
  const uint32_t bits = (word >> 22) ^ word;
  seed = prev;
  return __fmul_rn((float)(bits >> 9), 1.0f / 8388608.0f) <= opacity;
}

// Resident blocks of 128 an SM that __launch_bounds__ asks of the machines
// (registers: 65536 / (128 * blocks)); the instance table's shared memory may
// hold fewer. Measured on the H100 (chip_ab.py, PERF.md section 6): the
// opaque machine at 4 blocks (128 registers, no spill) ran 7% faster than at
// 5 (96, 358 B spill) at width 16; the alpha machine at 3 (168) 5% faster
// than at 4 (128) there; at width 32 fewer blocks ran slower.
constexpr int kOpaqueMinBlocks = 4;
constexpr int kAlphaMinBlocks = 3;
// A warp fetches rays once this many lanes idle (measured: 1-7% faster than
// at 8 on every machine case but the plaza's any-hit alpha pass, 1-2%
// slower; 4 as for the wide entries).
constexpr int kMachineRefill = 4;
// The single-level alpha rounds: resident blocks of 128 an SM, and the idle
// lanes at which a warp fetches rays. Measured on the H100 (chip_ab.py,
// PERF.md section 6): 3 blocks (164-168 registers; no spill at width 16)
// ran 7-10% faster than 4 (128, 584-1096 B spill) and 30-50% faster than
// 5; 2 ran as fast as 3 at width 16 and 5% slower at width 32; a refill
// at 8 idle lanes within 1% of 4.
constexpr int kRoundsMinBlocks = 3;
constexpr int kRoundsRefill = 4;
// The rounds' intake: a warp fetches again, before its node loops, while
// kRoundsRefill lanes are idle because their rays needed no round.
constexpr bool kRoundsRefetch = true;
// Instances of the table for each lane that waits for an instance scan
// (scan_batch below). Measured on the H100 (chip_ab.py, PERF.md section 6):
// with every lane scanning as soon as its round ended, the plaza's alpha
// machine (4,609 instances) ran 1.7x slower than the first design; with 32
// it ran 1.26x faster than the first design, and the bistro (166: 5 lanes)
// within 2% of 128 (1 lane); at 8 (20 lanes) the bistro's alpha machine
// ran 20% slower.
constexpr int kScanShare = 32;

// Lanes that wait for their next instance before the warp scans the table:
// the scan (next_instance) costs a warp the same for one lane as for all
// that run it together, so a larger table gathers more lanes first (one for
// every kScanShare instances, at most a warp); once no lane of the warp
// traverses, the waiting lanes scan whatever their number.
inline int scan_batch(int n_inst) {
  const int k = n_inst / kScanShare;
  return k < 1 ? 1 : (k > 32 ? 32 : k);
}

// The per-thread stack and child list of the machines: the stack's shared
// entries and, at width 16, the list in shared memory, laid out by thread.
template <int W>
struct NodeMem {
  static constexpr bool kListShared = W == 16;
  int stack[kShStack * kAbThreads];
  float key[kListShared ? W * kAbThreads : 1];
  int ref[kListShared ? W * kAbThreads : 1];
};

// The warp's counts after its node loops: the node steps of its lanes
// (busy) and the lane slots of the two loops (each runs as long as its
// slowest lane), from each lane's steps before the loops (s0) and between
// them (s1).
__device__ __forceinline__ void count_steps(unsigned lanes, int s0, int s1, int s2,
                                            unsigned& busy, unsigned& slots) {
  busy += (unsigned)(s2 - s0);
  slots += (unsigned)(__reduce_max_sync(lanes, s1 - s0) + __reduce_max_sync(lanes, s2 - s1));
}

// At the end: the deepest stack to scratch word 1, the warp's busy node
// steps and lane slots (the lanes' slots times the warp's lanes) added to
// words 2 and 3 (32-bit, wrapping).
__device__ __forceinline__ void machine_counts(unsigned lanes, int lane, int* scratch,
                                               int deepest, unsigned busy, unsigned slots) {
  deepest = __reduce_max_sync(lanes, deepest);
  busy = __reduce_add_sync(lanes, busy);
  if (lane == 0) {
    atomicMax(scratch + 1, deepest);
    atomicAdd(scratch + 2, (int)busy);
    atomicAdd(scratch + 3, (int)(slots * (unsigned)__popc(lanes)));
  }
}

// The two-level opaque rounds (tlas._two_level_pass) for every ray: the
// instances of the mask in (entry t, id) order, each traversed from its BLAS
// root in its own object space with t_max = the best hit so far, in mode a
// (closest, culling) or mode b (any, no culling: the first hit ends the ray).
// Every round consumes an instance, so a ray ends within n_inst rounds. A
// lane's ray keeps its world ray, window end tmax0, last instance (last_t,
// last_id) and the instance of its current round (cid, entered at nt, with
// the best t at the round's start t0); the round's traversal updates the best
// hit in place, and every hit lowers its t strictly. settle: scan_batch.
// GLOBAL: the instance table in global memory (n_inst > kMaxInstances).
template <bool ANY, int W, bool GLOBAL>
__global__ void __launch_bounds__(kAbThreads, kOpaqueMinBlocks)
opaque_machine_kernel(const float4* __restrict__ rows, int lim, const float* __restrict__ inst_box,
                      const float* __restrict__ inst_w2o, const int32_t* __restrict__ inst_root,
                      int n_inst, const float* __restrict__ origin,
                      const float* __restrict__ direction, const float* __restrict__ t_max,
                      const uint8_t* __restrict__ active, int n_rays, int settle,
                      int* __restrict__ scratch, int64_t n_slots, float* __restrict__ out_t,
                      int32_t* __restrict__ out_tri, float* __restrict__ out_u,
                      float* __restrict__ out_v, int32_t* __restrict__ out_inst,
                      int32_t* __restrict__ out_steps) {
  constexpr int MODE = ANY ? kAny : kClosest;
  using M = NodeMem<W>;
  extern __shared__ float smem[];
  __shared__ M mem;
  float l_key[M::kListShared ? 1 : W];
  int l_ref[M::kListShared ? 1 : W];
  const Instances<GLOBAL> it = load_instances<GLOBAL>(smem, inst_box, inst_w2o, inst_root, n_inst);

  const unsigned lanes = __ballot_sync(0xffffffffu, true);
  const int lane = threadIdx.x & 31;
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const Stack st{mem.stack + threadIdx.x, (int)blockDim.x, scratch + kScratchHead + slot, n_slots};
  const ChildList cl = M::kListShared ? ChildList{mem.key + threadIdx.x, mem.ref + threadIdx.x,
                                                  (int)blockDim.x}
                                      : ChildList{l_key, l_ref, 1};
  Ray w, y;
  Hits h;
  float tmax0 = 0.0f, last_t = kNeg, nt = kInf, t0 = 0.0f;
  int ray = -1, cur = kTerm, depth = 0, steps = 0, cid = -1, last_id = -1, ibest = 0;
  int deepest = 0;
  unsigned busy = 0, slots = 0;
  bool more = true, live = false;  // more: the counter may still hold rays (every lane)
  const auto finish = [&]() {
    out_t[ray] = h.t;
    out_tri[ray] = h.tri;
    out_u[ray] = h.u;
    out_v[ray] = h.v;
    out_inst[ray] = ibest;
    out_steps[ray] = steps;
    ray = -1;
  };
  while (true) {
    const unsigned idle = __ballot_sync(lanes, ray < 0);
    if (!more && idle == lanes) break;
    const int64_t r = fetch<kMachineRefill>(lanes, idle, lane, scratch, n_rays, more);
    if (r >= 0) {  // a new ray, before its first round
      ray = (int)r;
      w = load_ray(origin, direction, r);
      tmax0 = t_max[r];
      h.t = tmax0;
      h.tri = -1;
      h.u = h.v = 0.0f;
      steps = 0;
      last_t = kNeg;
      last_id = -1;
      ibest = 0;
      cid = -1;
      live = active == nullptr || active[r];
    }
    if (ray >= 0 && cur == kTerm) {  // between two rounds
      if (cid >= 0) {                // the round's tree is done
        if (h.t < t0) ibest = cid;
        ++steps;
        last_t = nt;
        last_id = cid;
        cid = -1;
      }
      if (!live || (ANY && h.tri >= 0)) finish();  // any hit: the first hit occludes
    }
    // The lanes that wait for their next instance scan the table together.
    const unsigned want = __ballot_sync(lanes, ray >= 0 && cur == kTerm);
    const unsigned moving = __ballot_sync(lanes, cur != kTerm);
    if (want != 0 && (moving == 0 || __popc(want) >= settle) && ((want >> lane) & 1u)) {
      cid = next_instance(it, n_inst, w, tmax0, h.t, last_t, last_id, nt);
      if (cid >= 0) {
        // The world origin itself goes into object space: o + d * 0 would
        // make a -0 coordinate +0.
        y = instance_ray(it, cid, w.ox, w.oy, w.oz, w);
        depth = 0;
        cur = it.root_at(cid);
        t0 = h.t;
      } else {
        finish();
      }
    }
    const int s0 = steps;
    interior_nodes<MODE, W>(rows, cur, y, h, cl, st, depth, lim, deepest, steps);
    const int s1 = steps;
    leaf_nodes<MODE, !ANY, W>(rows, cur, y, h, st, depth, lim, steps);
    count_steps(lanes, s0, s1, steps, busy, slots);
  }
  machine_counts(lanes, lane, scratch, deepest, busy, slots);
}

// The two-level alpha rounds (tlas._two_level_alpha_pass) for every ray: a
// live ray holds a candidate instance and a window start t_lo inside it. A
// round traverses the instance's alpha BLAS in candidate mode over (t_lo,
// t_best); the nearest alpha surface takes its stochastic test: pass records
// it and moves to the next instance, reject advances t_lo past it and stays
// (the next round starts at once), no surface moves on. A ray stops after
// max_rounds rounds (rejections and instance moves alike). Closest hit with
// culling or (ANY) any hit without: the first accepted surface occludes. A
// lane keeps its ray's best accepted surface apart from the round's
// traversal (h: the window's opaque and candidate slots). settle:
// scan_batch. GLOBAL: the instance table in global memory (n_inst >
// kMaxInstances).
template <bool ANY, int W, bool GLOBAL>
__global__ void __launch_bounds__(kAbThreads, kAlphaMinBlocks)
alpha_machine_kernel(const float4* __restrict__ rows, int lim, const float* __restrict__ inst_box,
                     const float* __restrict__ inst_w2o, const int32_t* __restrict__ inst_root,
                     int n_inst, const float* __restrict__ pack, int64_t n_pack,
                     const uint8_t* __restrict__ plane, int64_t n_plane, int64_t atlas_w,
                     const float* __restrict__ origin, const float* __restrict__ direction,
                     const float* __restrict__ t_max, const uint8_t* __restrict__ active,
                     const int64_t* __restrict__ seed_in, int n_rays, int max_rounds, int settle,
                     int* __restrict__ scratch, int64_t n_slots, float* __restrict__ out_t,
                     int32_t* __restrict__ out_tri, float* __restrict__ out_u,
                     float* __restrict__ out_v, int32_t* __restrict__ out_inst,
                     int64_t* __restrict__ out_seed, int32_t* __restrict__ out_steps) {
  using M = NodeMem<W>;
  extern __shared__ float smem[];
  __shared__ M mem;
  float l_key[M::kListShared ? 1 : W];
  int l_ref[M::kListShared ? 1 : W];
  const Instances<GLOBAL> it = load_instances<GLOBAL>(smem, inst_box, inst_w2o, inst_root, n_inst);

  const unsigned lanes = __ballot_sync(0xffffffffu, true);
  const int lane = threadIdx.x & 31;
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const Stack st{mem.stack + threadIdx.x, (int)blockDim.x, scratch + kScratchHead + slot, n_slots};
  const ChildList cl = M::kListShared ? ChildList{mem.key + threadIdx.x, mem.ref + threadIdx.x,
                                                  (int)blockDim.x}
                                      : ChildList{l_key, l_ref, 1};
  Ray w, y;
  Hits h;
  uint32_t seed = 0;
  float tmax0 = 0.0f, t_best = 0.0f, u = 0.0f, v = 0.0f, t_lo = 0.0f, last_t = kNeg, nt = kInf;
  int ray = -1, cur = kTerm, depth = 0, steps = 0, cid = -1, last_id = -1, ibest = 0, tri = -1;
  int round = 0, deepest = 0;
  unsigned busy = 0, slots = 0;
  bool more = true, live = false;  // more: the counter may still hold rays (every lane)
  const auto begin = [&]() {  // a round over instance cid from t_lo
    // The window start moved along the world ray, then into the instance's
    // object space.
    y = instance_ray(it, cid, __fadd_rn(w.ox, __fmul_rn(w.dx, t_lo)),
                     __fadd_rn(w.oy, __fmul_rn(w.dy, t_lo)),
                     __fadd_rn(w.oz, __fmul_rn(w.dz, t_lo)), w);
    h.t = h.ct = fmaxf(__fsub_rn(t_best, t_lo), 0.0f);
    h.tri = h.ctri = -1;
    h.u = h.v = h.cu = h.cv = h.cuvu = h.cuvv = 0.0f;
    depth = 0;
    cur = it.root_at(cid);
  };
  const auto finish = [&]() {
    out_t[ray] = t_best;
    out_tri[ray] = tri;
    out_u[ray] = u;
    out_v[ray] = v;
    out_inst[ray] = ibest;
    out_seed[ray] = (int64_t)seed;
    out_steps[ray] = steps;
    ray = -1;
    cid = -1;
  };
  while (true) {
    const unsigned idle = __ballot_sync(lanes, ray < 0);
    if (!more && idle == lanes) break;
    const int64_t r = fetch<kMachineRefill>(lanes, idle, lane, scratch, n_rays, more);
    if (r >= 0) {  // a new ray, before its first round
      ray = (int)r;
      w = load_ray(origin, direction, r);
      tmax0 = t_max[r];
      seed = (uint32_t)seed_in[r];
      t_best = tmax0;
      u = v = 0.0f;
      tri = -1;
      ibest = 0;
      steps = 0;
      last_t = kNeg;
      last_id = -1;
      t_lo = 0.0f;
      round = 0;
      cid = -1;
      live = active == nullptr || active[r];
    }
    if (ray >= 0 && cur == kTerm) {  // between two rounds
      if (cid >= 0) {                // the round's tree is done: its candidate's test
        const bool cand = h.ctri >= 0;
        const bool passed =
            cand && alpha_accept(pack, n_pack, plane, n_plane, atlas_w, h.ctri, h.cuvu, h.cuvv,
                                 seed);
        const float t_abs = __fadd_rn(t_lo, cand ? h.ct : kInf);
        if (passed) {
          t_best = t_abs;
          tri = h.ctri;
          u = h.cu;
          v = h.cv;
          ibest = cid;
        }
        ++steps;
        ++round;
        if (cand && !passed) {
          t_lo = __fadd_rn(__fmul_rn(t_abs, kAdvMul), kAdvAbs);
        } else {
          last_t = nt;
          last_id = cid;
          t_lo = 0.0f;
          cid = -1;
        }
      }
      // Any hit: the first accepted surface occludes.
      if (!live || round >= max_rounds || (ANY && tri >= 0)) finish();
      else if (cid >= 0) begin();  // a rejection: the same instance again
    }
    // The lanes that wait for their next instance scan the table together.
    const unsigned want = __ballot_sync(lanes, ray >= 0 && cur == kTerm);
    const unsigned moving = __ballot_sync(lanes, cur != kTerm);
    if (want != 0 && (moving == 0 || __popc(want) >= settle) && ((want >> lane) & 1u)) {
      cid = next_instance(it, n_inst, w, tmax0, t_best, last_t, last_id, nt);
      if (cid >= 0) begin();
      else finish();
    }
    const int s0 = steps;
    interior_nodes<kCandidate, W>(rows, cur, y, h, cl, st, depth, lim, deepest, steps);
    const int s1 = steps;
    leaf_nodes<kCandidate, !ANY, W>(rows, cur, y, h, st, depth, lim, steps);
    count_steps(lanes, s0, s1, steps, busy, slots);
  }
  machine_counts(lanes, lane, scratch, deepest, busy, slots);
}

// ---- The alpha pass's root prefilter ------------------------------------------
// Replaces the XLA body root_prefilter (vk_raytrace_tpu/ops/traverse_fused.py:575)
// with the line of _alpha_rounds around it (vk_raytrace_tpu/ops/
// traverse_alpha.py:175-183): ray r needs the alpha rounds where
//   active[r] & t_limit[r] > 0 & any_c(valid_c & tn_c <= tf_c & tf_c >= 0 & tn_c < t_limit[r])
// over the W children c of root row 0 (valid: bmin.x <= bmax.x, x alone, as
// _root_boxes tests), tn_c / tf_c the slab test with the guarded reciprocal.
// On the main path this line is the ray intake of vkrt_alpha_rounds (below),
// which loads each ray, its t_limit and its flag anyway: no launch, no host
// call and no need mask of its own. The standalone entry vkrt_root_prefilter
// (a thread a lane: it reads its flag, an inactive lane nothing else, then
// t_limit and its ray, and writes one byte) computes the mask alone; both
// run the same device functions. The root row's 6·W bounds are loaded once a
// block into shared memory. Bit for bit with torch on the card: sub then product
// rounded apart, IEEE reciprocal (guard_inv), and NaN as torch.minimum /
// maximum / amax / amin propagate it (min_nan / max_nan; fminf / fmaxf
// would drop it): any NaN among a child's six plane distances makes tn and
// tf NaN and the child a miss; -0.0 takes +1e-20 in guard_inv, as inv_dir's
// d < 0 does. The bounds are read as float4, four children at a time
// (with the NaN-propagating min / max, 6% less device time in the alpha
// rounds of a 1080p atrium frame than scalar reads and explicit NaN tests).

// torch.minimum / maximum: NaN if either operand is NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a || b != b ? a + b : fminf(a, b);
#endif
}
__device__ __forceinline__ float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return a != a || b != b ? a + b : fmaxf(a, b);
#endif
}

__device__ __forceinline__ bool root_child_hit(const Ray& y, float bxm, float bym, float bzm,
                                               float bxM, float byM, float bzM, float t_limit) {
  if (!(bxm <= bxM)) return false;
  const float lx = __fmul_rn(__fsub_rn(bxm, y.ox), y.ix);
  const float hx = __fmul_rn(__fsub_rn(bxM, y.ox), y.ix);
  const float ly = __fmul_rn(__fsub_rn(bym, y.oy), y.iy);
  const float hy = __fmul_rn(__fsub_rn(byM, y.oy), y.iy);
  const float lz = __fmul_rn(__fsub_rn(bzm, y.oz), y.iz);
  const float hz = __fmul_rn(__fsub_rn(bzM, y.oz), y.iz);
  const float tn = max_nan(max_nan(min_nan(lx, hx), min_nan(ly, hy)), min_nan(lz, hz));
  const float tf = min_nan(min_nan(max_nan(lx, hx), max_nan(ly, hy)), max_nan(lz, hz));
  return tn <= tf && tf >= 0.0f && tn < t_limit;
}

// The root row's child bounds (bmin x | y | z, bmax x | y | z, W each) into
// the block's shared s_box (6·W / 4 float4); the block syncs before reading them.
template <int W>
__device__ __forceinline__ void share_root_children(const float4* __restrict__ rows, float4* s_box) {
  for (int k = threadIdx.x; k < 6 * W / 4; k += blockDim.x) s_box[k] = rows[k];
}

// Whether ray y hits a root child within (0, t_limit) (t_limit > 0 tested
// by the caller): the children four at a time, each bound a float4 load.
template <int W>
__device__ __forceinline__ bool hits_root_child(const Ray& y, const float4* s_box, float t_limit) {
  constexpr int G = W / 4;
  for (int g = 0; g < G; ++g) {
    const float4 xm = s_box[g], ym = s_box[G + g], zm = s_box[2 * G + g];
    const float4 xM = s_box[3 * G + g], yM = s_box[4 * G + g], zM = s_box[5 * G + g];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (root_child_hit(y, f4get(xm, k), f4get(ym, k), f4get(zm, k), f4get(xM, k), f4get(yM, k),
                         f4get(zM, k), t_limit))
        return true;
  }
  return false;
}

template <int W>
__global__ void __launch_bounds__(256)
root_prefilter_kernel(const float* __restrict__ rows, const float* __restrict__ origin,
                      const float* __restrict__ direction, const float* __restrict__ t_limit,
                      const uint8_t* __restrict__ active, int64_t n,
                      uint8_t* __restrict__ need) {
  __shared__ float4 s_box[6 * W / 4];
  share_root_children<W>(reinterpret_cast<const float4*>(rows), s_box);
  __syncthreads();
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  bool hit = false;
  if (active == nullptr || active[r]) {
    const float tl = t_limit[r];
    if (tl > 0.0f) hit = hits_root_child<W>(load_ray(origin, direction, r), s_box, tl);
  }
  need[r] = hit ? 1 : 0;
}

// The single-level alpha rounds (traverse_alpha._rounds_core) for every ray:
// round after round, the candidate traversal of the alpha tree from its root
// over the window (t_lo, t_limit), then the stochastic test of the nearest
// candidate (with a null pack every candidate passes and nothing is drawn).
// Pass records it and ends the ray, reject advances t_lo just past it and
// starts the next round at once, no candidate ends the ray; so does the
// max_rounds-th round. A lane keeps its ray's state between rounds: the world
// origin (ox, oy, oz; the round's ray y shares its direction), the window end
// tlim and start t_lo, the round count, the best accepted surface and the
// seed; its round ends inside the warp's node loops and is settled (the test,
// the advance) after them, before the warp's next node step. `going`: a
// round is under way (cur == kTerm alone cannot tell a round that just ended
// from one that never entered the root). The warps count their node steps
// at width 16 (machine_counts; at width 32 scratch words 2 and 3 stay 0).
//
// The ray intake runs the alpha pass's need line (the root prefilter above)
// on each ray a lane fetches: a ray that is inactive, has t_limit <= 0 (or
// NaN) or hits no root child within (0, t_limit) is finished at once with
// the outputs of a ray that needs nothing (t = 1e32, tri = -1, u = v = 0,
// its seed, steps 0). So that such rays cost the warp no node step, a warp
// fetches again while kRoundsRefill of its lanes are idle and rays remain,
// before its node loops run (kRoundsRefetch). The block counts its rays
// fetched and the rays that needed the rounds in shared memory and
// adds them to scratch words 4 and 5 at the end.
template <bool CULL, int W>
__global__ void __launch_bounds__(kAbThreads, kRoundsMinBlocks)
alpha_rounds_kernel(const float4* __restrict__ rows, int lim, const float* __restrict__ origin,
                    const float* __restrict__ direction, const float* __restrict__ t_limit,
                    const uint8_t* __restrict__ active, const int64_t* __restrict__ seed_in,
                    const float* __restrict__ pack, int64_t n_pack,
                    const uint8_t* __restrict__ plane, int64_t n_plane, int64_t atlas_w,
                    int n_rays, int max_rounds, int* __restrict__ scratch, int64_t n_slots,
                    float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                    float* __restrict__ out_u, float* __restrict__ out_v,
                    int64_t* __restrict__ out_seed, int32_t* __restrict__ out_steps) {
  using M = NodeMem<W>;
  __shared__ M mem;
  __shared__ float s_root[6];
  __shared__ float4 s_box[6 * W / 4];
  __shared__ unsigned s_intake[2];  // rays fetched, rays that needed the rounds
  float l_key[M::kListShared ? 1 : W];
  int l_ref[M::kListShared ? 1 : W];
  share_root_box<W>(rows, s_root);
  share_root_children<W>(rows, s_box);
  for (int k = threadIdx.x; k < 2; k += blockDim.x) s_intake[k] = 0;
  __syncthreads();

  const unsigned lanes = __ballot_sync(0xffffffffu, true);
  const int lane = threadIdx.x & 31;
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const Stack st{mem.stack + threadIdx.x, (int)blockDim.x, scratch + kScratchHead + slot, n_slots};
  const ChildList cl = M::kListShared ? ChildList{mem.key + threadIdx.x, mem.ref + threadIdx.x,
                                                  (int)blockDim.x}
                                      : ChildList{l_key, l_ref, 1};
  Ray y;
  Hits h;
  int64_t seed0 = 0;
  uint32_t seed = 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, tlim = 0.0f, t_lo = 0.0f, t_best = kInf, u = 0.0f,
        v = 0.0f;
  int ray = -1, cur = kTerm, depth = 0, steps = 0, tri = -1, round = 0, deepest = 0;
  unsigned busy = 0, slots = 0;
  bool more = true, going = false, drew = false;  // more: the counter may hold rays (every lane)
  const auto begin = [&]() {  // a round from t_lo
    // The window start moved along the ray (o + d * t_lo, in torch's order;
    // the direction and its reciprocal stay), the window end clamped at 0 as
    // torch.clamp does it (NaN stays NaN, where fmaxf would give 0).
    y.ox = __fadd_rn(ox, __fmul_rn(y.dx, t_lo));
    y.oy = __fadd_rn(oy, __fmul_rn(y.dy, t_lo));
    y.oz = __fadd_rn(oz, __fmul_rn(y.dz, t_lo));
    const float left = __fsub_rn(tlim, t_lo);
    const float win = left < 0.0f ? 0.0f : left;
    h.t = h.ct = win;
    h.tri = h.ctri = -1;
    h.u = h.v = h.cu = h.cv = h.cuvu = h.cuvv = 0.0f;
    depth = 0;
    cur = enters_shared_root(y, s_root, win) ? 0 : kTerm;
    going = true;
  };
  const auto finish = [&]() {
    out_t[ray] = t_best;
    out_tri[ray] = tri;
    out_u[ray] = u;
    out_v[ray] = v;
    out_seed[ray] = drew ? (int64_t)seed : seed0;
    out_steps[ray] = steps;
    ray = -1;
    going = false;
  };
  // A new ray: the need line, then its first round. A ray that needs
  // nothing gets its outputs here and leaves the lane idle. (Setting the
  // lane's state only for a ray that runs rounds: 338 B of spill at width
  // 32, ptxas; setting it for every ray first: 360-380 B. Testing the
  // root's union box before the children measured 4% slower in a 1080p
  // atrium frame: most of its rays enter the alpha tree's box.)
  const auto take = [&](int64_t r) {
    const Ray yy = load_ray(origin, direction, r);
    const float tl = t_limit[r];
    if (!((active == nullptr || active[r]) && tl > 0.0f && max_rounds > 0 &&
          hits_root_child<W>(yy, s_box, tl))) {  // the outputs of a ray that needs nothing
      out_t[r] = kInf;
      out_tri[r] = -1;
      out_u[r] = 0.0f;
      out_v[r] = 0.0f;
      out_seed[r] = seed_in[r];
      out_steps[r] = 0;
      return false;
    }
    ray = (int)r;
    y = yy;
    ox = y.ox;
    oy = y.oy;
    oz = y.oz;
    tlim = tl;
    seed0 = seed_in[r];
    seed = (uint32_t)seed0;
    drew = false;
    t_lo = 0.0f;
    t_best = kInf;
    u = v = 0.0f;
    tri = -1;
    steps = 0;
    round = 0;
    begin();
    return true;
  };
  while (true) {
    unsigned idle = __ballot_sync(lanes, ray < 0);
    if (!more && idle == lanes) break;
    while (true) {  // the intake
      const int64_t r = fetch<kRoundsRefill>(lanes, idle, lane, scratch, n_rays, more);
      const bool need = r >= 0 && take(r);
      const unsigned got = __ballot_sync(lanes, r >= 0);
      const unsigned kept = __ballot_sync(lanes, need);
      if (got == 0) break;
      if (lane == 0) {
        atomicAdd(s_intake, (unsigned)__popc(got));
        atomicAdd(s_intake + 1, (unsigned)__popc(kept));
      }
      if (!kRoundsRefetch || kept == got) break;
      idle = __ballot_sync(lanes, ray < 0);
    }
    const int s0 = steps;
    interior_nodes<kCandidate, W>(rows, cur, y, h, cl, st, depth, lim, deepest, steps);
    const int s1 = steps;
    leaf_nodes<kCandidate, CULL, W>(rows, cur, y, h, st, depth, lim, steps);
    // The warps' step counts, at width 16 only: at width 32 they cost the
    // kernel 2% (chip_ab.py), at 16 under 2%.
    if (W == 16) count_steps(lanes, s0, s1, steps, busy, slots);
    if (going && cur == kTerm) {  // the round's tree is done: its candidate's test
      const bool cand = h.ctri >= 0;
      bool passed = cand;
      if (cand && pack != nullptr) {
        passed = alpha_accept(pack, n_pack, plane, n_plane, atlas_w, h.ctri, h.cuvu, h.cuvv, seed);
        drew = true;
      }
      const float t_abs = __fadd_rn(t_lo, cand ? h.ct : kInf);
      if (passed) {
        t_best = t_abs;
        tri = h.ctri;
        u = h.cu;
        v = h.cv;
      }
      ++round;
      if (cand && !passed && round < max_rounds) {
        t_lo = __fadd_rn(__fmul_rn(t_abs, kAdvMul), kAdvAbs);
        begin();
      } else {
        finish();
      }
    }
  }
  machine_counts(lanes, lane, scratch, deepest, busy, slots);
  __syncthreads();  // every warp has left its loop
  if (threadIdx.x == 0) {
    atomicAdd(scratch + 4, (int)s_intake[0]);
    atomicAdd(scratch + 5, (int)s_intake[1]);
  }
}

// The child order alone, one row per W lanes (a warp at W = 32, a half-warp
// at W = 16): lane i loads child i, so a row's keys and refs are one
// coalesced access each. A hit's rank is the number of hits before it in
// (key, slot) order, counted over the row's keys passed round the group with
// __shfl_sync; a miss (a key not below kInf, NaN included) follows the hits
// in row order, its rank counted from the group's __ballot_sync hit bits.
// Key and ref are stored at their rank: keys ascending and stable, the
// misses after the hits in their row order; out_count[r] = number of hits.
// Bound by its bytes; the W shuffles and compares per lane stay in registers.
template <int W>
__global__ void __launch_bounds__(256)
sort_children_kernel(const float* __restrict__ keys, const int32_t* __restrict__ refs,
                     int64_t n, float* __restrict__ out_keys, int32_t* __restrict__ out_refs,
                     int32_t* __restrict__ out_count) {
  static_assert(W == 16 || W == 32, "a row spans a half-warp or a warp");
  const int64_t row = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / W;
  const int lane = threadIdx.x & (W - 1);
  const bool valid = row < n;  // whole groups: blockDim is a multiple of W
  const float k = valid ? keys[row * W + lane] : kInf;
  const int32_t ref = valid ? refs[row * W + lane] : 0;
  const bool hit = k < kInf;
  const unsigned group = W == 32 ? 0xffffffffu : 0xffffu;
  const unsigned hits = (__ballot_sync(0xffffffffu, hit) >> (threadIdx.x & 31 & ~(W - 1))) & group;
  int before = 0;  // hits ahead of this lane's key in (key, slot) order
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float kj = __shfl_sync(0xffffffffu, k, j, W);
    before += (kj < k || (kj == k && j < lane)) ? 1 : 0;  // a miss kj is never below a hit
  }
  const int n_hits = __popc(hits);
  const int rank = hit ? before : n_hits + __popc(~hits & group & ((1u << lane) - 1u));
  if (valid) {
    out_keys[row * W + rank] = k;
    out_refs[row * W + rank] = ref;
    if (lane == 0) out_count[row] = n_hits;
  }
}

struct Args {
  const float* rows;
  const float* o;
  const float* d;
  const float* tmax;
  const uint8_t* active;
  const int32_t* root0;
  int64_t n;
  float* t;
  int32_t* tri;
  float* u;
  float* v;
  int32_t* steps;
  float* uvu;
  float* uvv;
};

template <int MODE, bool CULL, int MAXD, int W>
void launch(const Args& a, cudaStream_t stream) {
  const int threads = 128;
  const int64_t blocks = (a.n + threads - 1) / threads;
  traverse_kernel<MODE, CULL, MAXD, W><<<(unsigned)blocks, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(a.rows), a.o, a.d, a.tmax, a.active, a.root0, a.n, a.t,
      a.tri, a.u, a.v, a.steps, a.uvu, a.uvv);
}

template <int MAXD, int W = kWidth>
void dispatch(int mode, int cull, const Args& a, cudaStream_t s) {
  if (mode == kClosest)
    launch<kClosest, true, MAXD, W>(a, s);
  else if (mode == kAny)
    launch<kAny, false, MAXD, W>(a, s);
  else if (cull)
    launch<kCandidate, true, MAXD, W>(a, s);
  else
    launch<kCandidate, false, MAXD, W>(a, s);
}

// The largest instance table a machine holds in dynamic shared memory.
constexpr int kTableBytes = kMaxInstances * kInstWords * (int)sizeof(float);

// f(the opaque machine kernel of any_hit for n_inst instances, its dynamic
// shared memory): the instance table in shared memory up to kMaxInstances,
// the GLOBAL instantiation (none) above.
template <class F>
int64_t with_opaque(int any_hit, int n_inst, F f) {
  const bool global = n_inst > kMaxInstances;
  const size_t smem = global ? 0 : (size_t)n_inst * kInstWords * sizeof(float);
  if (any_hit)
    return global ? f(&opaque_machine_kernel<true, kWidth, true>, smem)
                  : f(&opaque_machine_kernel<true, kWidth, false>, smem);
  return global ? f(&opaque_machine_kernel<false, kWidth, true>, smem)
                : f(&opaque_machine_kernel<false, kWidth, false>, smem);
}

// The same for the alpha machine.
template <class F>
int64_t with_alpha(int any_hit, int n_inst, F f) {
  const bool global = n_inst > kMaxInstances;
  const size_t smem = global ? 0 : (size_t)n_inst * kInstWords * sizeof(float);
  if (any_hit)
    return global ? f(&alpha_machine_kernel<true, kWidth, true>, smem)
                  : f(&alpha_machine_kernel<true, kWidth, false>, smem);
  return global ? f(&alpha_machine_kernel<false, kWidth, true>, smem)
                : f(&alpha_machine_kernel<false, kWidth, false>, smem);
}

// The single-level alpha rounds kernel with (cull) or without backface culling.
inline auto rounds_kernel(int cull) -> decltype(&alpha_rounds_kernel<true, kWidth>) {
  return cull ? &alpha_rounds_kernel<true, kWidth> : &alpha_rounds_kernel<false, kWidth>;
}

// Let machine kernel k take the largest instance table in dynamic shared
// memory beside its static stack and child list (past the 48 KB a block
// that a kernel gets without asking).
template <class K>
bool prepare_machine(K k) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes) ==
         cudaSuccess;
}

// Blocks of machine kernel k with `smem` bytes of dynamic shared memory that
// reside on one SM, or -1.
template <class K>
int64_t machine_occupancy(K k, size_t smem) {
  int blocks = 0;
  if (!prepare_machine(k) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kAbThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

// The persistent grid's blocks: the rays' blocks of kAbThreads, at most the
// resident threads n_slots.
inline unsigned grid_blocks(int64_t n_rays, int64_t n_slots) {
  const int64_t need = (n_rays + kAbThreads - 1) / kAbThreads;
  return (unsigned)(need < n_slots / kAbThreads ? need : n_slots / kAbThreads);
}

// The persistent a/b kernel of `mode` (closest with culling, any without),
// or null for another mode.
template <int W = kWidth>
auto ab_kernel(int mode) -> decltype(&persistent_traverse_kernel<kClosest, true, W>) {
  if (mode == kClosest) return &persistent_traverse_kernel<kClosest, true, W>;
  if (mode == kAny) return &persistent_traverse_kernel<kAny, false, W>;
  return nullptr;
}

// Whether the capped kernel for this cap runs the ring: width 16 below
// kShStack steps.
constexpr bool kCappedRing = kWidth == 16;
bool capped_ring(int max_steps) { return kCappedRing && max_steps < kShStack; }

// The capped kernel for this cap and variant.
template <int W = kWidth>
auto capped_kernel(int max_steps, int nogather)
    -> decltype(&capped_traverse_kernel<W, false, false>) {
  const bool ring = capped_ring(max_steps);
  if (nogather)
    return ring ? &capped_traverse_kernel<W, true, kCappedRing>
                : &capped_traverse_kernel<W, true, false>;
  return ring ? &capped_traverse_kernel<W, false, kCappedRing>
              : &capped_traverse_kernel<W, false, false>;
}

// The no-gather kernels' shared memory carveout, which bounds their
// resident blocks: as many as keep their lanes' own rows in the L1 left
// beside their shared memory. Width 16: 25% of an SM's shared memory, two
// blocks (448 B a lane's row, 115 KB); width 32: the largest L1, one block
// (896 B a row). Measured on the H100 (chip_ab.py --capped, PERF.md): one,
// two, three and five blocks at width 16, one, three and four at width 32.
// Set before their occupancy is asked for and before each launch.
constexpr int kNogatherCarveout = kWidth == 16 ? 25 : cudaSharedmemCarveoutMaxL1;

template <class K>
cudaError_t prepare_capped(K k, int nogather) {
  return nogather ? cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         kNogatherCarveout)
                  : cudaSuccess;
}

}  // namespace

extern "C" {

// Blocks of the a/b kernel of `mode` (0 closest, 1 any) that reside on one
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -1.
int vkrt_traverse_ab_occupancy(int mode) {
  const auto k = ab_kernel(mode);
  int blocks = 0;
  if (k == nullptr ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kAbThreads, 0) != cudaSuccess)
    return -1;
  return blocks;
}

// Threads of the a/b kernel of `mode` that reside on the current device
// (the persistent grid), or -1.
int64_t vkrt_traverse_ab_slots(int mode) {
  const int blocks = vkrt_traverse_ab_occupancy(mode);
  int dev = 0, sms = 0;
  if (blocks <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return (int64_t)blocks * sms * kAbThreads;
}

// int32 words of a persistent entry's scratch (the a/b entry's and the
// machines') for a tree with this stack bound and n_slots resident threads:
// the head, then the stack entries past the shared ones, a column per thread.
int64_t vkrt_traverse_ab_words(int stack_depth, int64_t n_slots) {
  const int deep = stack_depth > kShStack ? stack_depth - kShStack : 0;
  return kScratchHead + (int64_t)deep * n_slots;
}

// Modes a (0: closest hit, backface culling) and b (1: any hit, no culling)
// from the tree's root on n_rays rays (< 2^31): the persistent kernel on
// min(n_slots, rays) threads. scratch: vkrt_traverse_ab_words(stack_depth,
// n_slots) int32 words; this entry zeroes its head on the stream, and the
// kernel leaves the deepest stack any ray reached in scratch[1]. `active`
// may be null. Outputs as vkrt_traverse. Returns the first CUDA error.
int vkrt_traverse_ab(int mode, int width, const float* rows, int stack_depth,
                     const float* origin, const float* direction, const float* t_max,
                     const uint8_t* active, int64_t n_rays, int* scratch, int64_t scratch_words,
                     int64_t n_slots, float* t, int32_t* tri, float* u, float* v, int32_t* steps,
                     void* stream) {
  const auto k = ab_kernel(mode);
  if (width != kWidth || k == nullptr || n_rays >= ((int64_t)1 << 31) || n_slots < kAbThreads ||
      scratch_words < vkrt_traverse_ab_words(stack_depth, n_slots))
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(scratch, 0, kScratchHead * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  k<<<grid_blocks(n_rays, n_slots), kAbThreads, 0, s>>>(
      reinterpret_cast<const float4*>(rows), origin, direction, t_max, active, (int)n_rays,
      stack_depth > 1 ? stack_depth : 1, scratch, n_slots, t, tri, u, v, steps);
  return (int)cudaGetLastError();
}

// Largest stack depth any instantiation holds; the wrapper refuses trees
// whose exact stack bound exceeds it.
int vkrt_traverse_max_stack() { return 128; }

// Stack entries a thread of the persistent entries holds in shared memory
// (kShStack); at width 16 the capped entry runs them as a ring below this
// many steps.
int vkrt_traverse_shared_stack() { return kShStack; }

// mode: 0 closest hit (backface culling), 1 any hit (no culling, first
// accepted hit ends the ray), 2 nearest alpha candidate (culling per
// `cull`); width: this library's VKRT_WIDTH. `active` may be null; `root0`
// may be null (every ray starts at row 0 after the root union-box test;
// modes 0 and 1 only with roots: from the root they run in vkrt_traverse_ab)
// or hold each ray's interior root row. Returns cudaGetLastError() after
// launch.
int vkrt_traverse(int mode, int cull, int width, const float* rows, int stack_depth,
                  const float* origin, const float* direction, const float* t_max,
                  const uint8_t* active, const int32_t* root0, int64_t n_rays, float* t,
                  int32_t* tri, float* u, float* v, int32_t* steps, float* uvu, float* uvv,
                  void* stream) {
  if (width != kWidth || (root0 == nullptr && mode != kCandidate))
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Args a{rows, origin, direction, t_max, active, root0, n_rays, t, tri, u, v, steps,
               uvu, uvv};
  if (stack_depth <= 64) dispatch<64>(mode, cull, a, s);
  else dispatch<128>(mode, cull, a, s);
  return (int)cudaGetLastError();
}

// Blocks of the capped kernel for `max_steps` (>= 0) and `nogather` that
// reside on one SM, or -1.
int vkrt_traverse_capped_occupancy(int max_steps, int nogather) {
  int blocks = 0;
  if (max_steps < 0) return -1;
  const auto k = capped_kernel(max_steps, nogather);
  if (prepare_capped(k, nogather) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kAbThreads, 0) != cudaSuccess)
    return -1;
  return blocks;
}

// Threads of that kernel that reside on the current device (its persistent
// grid), or -1.
int64_t vkrt_traverse_capped_slots(int max_steps, int nogather) {
  const int blocks = vkrt_traverse_capped_occupancy(max_steps, nogather);
  int dev = 0, sms = 0;
  if (blocks <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return (int64_t)blocks * sms * kAbThreads;
}

// int32 words of the capped entry's scratch: the head alone where it runs
// the ring, else the head and the spill to the tree's stack bound (to
// kCappedStack with nogather).
int64_t vkrt_traverse_capped_words(int stack_depth, int max_steps, int nogather,
                                   int64_t n_slots) {
  if (capped_ring(max_steps)) return kScratchHead;
  return vkrt_traverse_ab_words(nogather ? kCappedStack : stack_depth, n_slots);
}

// Closest hit (backface culling, from the root) on n_rays rays (< 2^31),
// each stopped after `max_steps` (>= 0) nodes, with the tree's exact stack
// bound (<= 128). With `nogather` != 0, ray r reads row r of the n_rows-row
// table (n_rows >= n_rays) at every node, whatever its node is, interprets
// it by the sign of its node ref, and starts over at the root where it
// would end, so every ray runs max_steps nodes, with a stack of 128 entries
// (pushes past it dropped): a timing variant whose hits are wrong by
// design. The persistent capped kernel on min(n_slots, rays) threads
// (vkrt_traverse_capped_slots); scratch: vkrt_traverse_capped_words int32
// words, whose head this entry zeroes on the stream; the kernel leaves the
// deepest stack any ray reached in scratch[1]. Outputs as
// vkrt_traverse_ab. Returns the first CUDA error.
int vkrt_traverse_capped(int width, const float* rows, int64_t n_rows, int stack_depth,
                         const float* origin, const float* direction, const float* t_max,
                         int64_t n_rays, int max_steps, int nogather, int* scratch,
                         int64_t scratch_words, int64_t n_slots, float* t, int32_t* tri,
                         float* u, float* v, int32_t* steps, void* stream) {
  if (width != kWidth || stack_depth > vkrt_traverse_max_stack() || max_steps < 0 ||
      (nogather && n_rows < n_rays) || n_rays >= ((int64_t)1 << 31) || n_slots < kAbThreads ||
      scratch_words < vkrt_traverse_capped_words(stack_depth, max_steps, nogather, n_slots))
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(scratch, 0, kScratchHead * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int lim = nogather ? kCappedStack : (stack_depth > 1 ? stack_depth : 1);
  const auto k = capped_kernel(max_steps, nogather);
  const cudaError_t e = prepare_capped(k, nogather);
  if (e != cudaSuccess) return (int)e;
  k<<<grid_blocks(n_rays, n_slots), kAbThreads, 0, s>>>(
      reinterpret_cast<const float4*>(rows), origin, direction, t_max, (int)n_rays, max_steps,
      lim, scratch, n_slots, t, tri, u, v, steps);
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
  const int threads = 256;
  const unsigned blocks = (unsigned)((n * kWidth + threads - 1) / threads);
  sort_children_kernel<kWidth><<<blocks, threads, 0, s>>>(keys, refs, n, out_keys, out_refs,
                                                          out_count);
  return (int)cudaGetLastError();
}

// Blocks that reside on one SM, or -1, of a round machine of `kind`: 0 the
// opaque machine, 1 the alpha machine, of closest hit (any_hit 0) or any hit
// (1) for n_inst instances (the instance table's shared memory counted); 2
// the single-level alpha rounds with culling (any_hit 0) or without (1),
// n_inst unused.
int vkrt_machine_occupancy(int kind, int any_hit, int n_inst) {
  if (kind == 2) {
    int blocks = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rounds_kernel(!any_hit),
                                                         kAbThreads, 0) == cudaSuccess
               ? blocks
               : -1;
  }
  const auto occ = [](auto k, size_t smem) { return machine_occupancy(k, smem); };
  return (int)(kind ? with_alpha(any_hit, n_inst, occ) : with_opaque(any_hit, n_inst, occ));
}

// Threads of that machine that reside on the current device (its persistent
// grid), or -1. Its scratch takes vkrt_traverse_ab_words(stack_depth, slots).
int64_t vkrt_machine_slots(int kind, int any_hit, int n_inst) {
  const int blocks = vkrt_machine_occupancy(kind, any_hit, n_inst);
  int dev = 0, sms = 0;
  if (blocks <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return (int64_t)blocks * sms * kAbThreads;
}

// The two-level alpha machine over n_rays world rays (< 2^31), to the end of
// each ray's rounds (at most max_rounds): closest hit with culling (cull 1,
// any_hit 0) or any hit without (cull 0, any_hit 1). rows: the alpha-subset
// BLAS table (this library's width) with its stack bound; per instance (in
// shared memory up to kMaxInstances, read from global memory above):
// inst_box (I, 6) the alpha-subset world box (min, max), inst_w2o (I, 3, 4)
// world to object, inst_root (I,) the BLAS root row, -1 outside the alpha
// mask; pack (n_pack, 16) the AlphaPack rows, plane the atlas alpha channel
// (n_plane bytes, rows atlas_w wide); seed (n_rays,) uint32 values in int64.
// Persistent warps on min(n_slots, rays) threads (vkrt_machine_slots with
// alpha 1 and this n_inst); scratch: vkrt_traverse_ab_words(stack_depth,
// n_slots) int32 words, whose head this entry zeroes on the stream; the
// kernel leaves the deepest stack in scratch[1] and its warps' busy node
// steps and node-loop lane slots in scratch[2] and [3]. Outputs per ray: t
// (t_max where no surface was accepted), tri (-1 then), u, v, inst, seed,
// steps (nodes + 1 a round). Returns the first CUDA error.
int vkrt_alpha_machine(int cull, int any_hit, int width, const float* rows, int stack_depth,
                       const float* inst_box, const float* inst_w2o, const int32_t* inst_root,
                       int n_inst, const float* pack, int64_t n_pack, const uint8_t* plane,
                       int64_t n_plane, int64_t atlas_w, const float* origin,
                       const float* direction, const float* t_max, const uint8_t* active,
                       const int64_t* seed, int64_t n_rays, int max_rounds, int* scratch,
                       int64_t scratch_words, int64_t n_slots, float* t, int32_t* tri, float* u,
                       float* v, int32_t* inst, int64_t* seed_out, int32_t* steps,
                       void* stream) {
  if (width != kWidth || stack_depth > vkrt_traverse_max_stack() || n_inst < 0 || n_pack < 1 ||
      n_plane < 1 || (cull != 0) == (any_hit != 0) || n_rays >= ((int64_t)1 << 31) ||
      n_slots < kAbThreads || scratch_words < vkrt_traverse_ab_words(stack_depth, n_slots))
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(scratch, 0, kScratchHead * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int lim = stack_depth > 1 ? stack_depth : 1;
  return (int)with_alpha(any_hit, n_inst, [&](auto k, size_t smem) -> int64_t {
    if (!prepare_machine(k)) return (int64_t)cudaGetLastError();
    k<<<grid_blocks(n_rays, n_slots), kAbThreads, smem, s>>>(
        reinterpret_cast<const float4*>(rows), lim, inst_box, inst_w2o, inst_root, n_inst, pack,
        n_pack, plane, n_plane, atlas_w, origin, direction, t_max, active, seed, (int)n_rays,
        max_rounds, scan_batch(n_inst), scratch, n_slots, t, tri, u, v, inst, seed_out, steps);
    return (int64_t)cudaGetLastError();
  });
}

// The single-level alpha rounds over n_rays rays (< 2^31), each to the end
// of its rounds (at most max_rounds), after the alpha pass's need line: a
// ray runs the rounds where it is active (every ray where active is null),
// t_limit > 0 and it hits a root child within (0, t_limit). rows, the alpha
// tree (this library's width) with its stack bound; t_limit (n_rays,) the
// window ends; seed (n_rays,) uint32 values in int64. pack (n_pack, 16) the
// AlphaPack rows and plane the atlas alpha channel (n_plane bytes, rows
// atlas_w wide), or a null pack: every candidate passes and no seed moves.
// cull: backface culling of the candidates. Persistent warps on
// min(n_slots, rays) threads (vkrt_machine_slots with kind 2 and any_hit =
// !cull); scratch: vkrt_traverse_ab_words(stack_depth, n_slots) int32 words,
// whose head this entry zeroes on the stream; the kernel leaves the deepest
// stack in scratch[1], at width 16 its warps' busy node steps and
// node-loop lane slots in scratch[2] and [3], and the rays it fetched and
// those that needed the rounds in scratch[4] and [5]. Outputs per ray: t
// (1e32 where no surface was accepted), tri (-1 then), u, v, seed (the input
// where nothing was drawn), steps (nodes over all rounds). Returns the first
// CUDA error.
int vkrt_alpha_rounds(int cull, int width, const float* rows, int stack_depth,
                      const float* origin, const float* direction, const float* t_limit,
                      const uint8_t* active, const int64_t* seed, const float* pack,
                      int64_t n_pack, const uint8_t* plane, int64_t n_plane, int64_t atlas_w,
                      int64_t n_rays, int max_rounds, int* scratch, int64_t scratch_words,
                      int64_t n_slots, float* t, int32_t* tri, float* u, float* v,
                      int64_t* seed_out, int32_t* steps, void* stream) {
  if (width != kWidth || stack_depth > vkrt_traverse_max_stack() ||
      (pack != nullptr && (n_pack < 1 || n_plane < 1)) || n_rays >= ((int64_t)1 << 31) ||
      n_slots < kAbThreads || scratch_words < vkrt_traverse_ab_words(stack_depth, n_slots))
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(scratch, 0, kScratchHead * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const auto k = rounds_kernel(cull);
  k<<<grid_blocks(n_rays, n_slots), kAbThreads, 0, s>>>(
      reinterpret_cast<const float4*>(rows), stack_depth > 1 ? stack_depth : 1, origin,
      direction, t_limit, active, seed, pack, n_pack, plane, n_plane, atlas_w, (int)n_rays,
      max_rounds, scratch, n_slots, t, tri, u, v, seed_out, steps);
  return (int)cudaGetLastError();
}

// The two-level opaque rounds over n_rays world rays (< 2^31), each to its
// last instance: closest hit with culling (cull 1, any_hit 0) or any hit
// without (cull 0, any_hit 1). rows: the BLAS table (this library's width)
// with its stack bound; per instance (in shared memory up to kMaxInstances,
// read from global memory above): inst_box (I, 6) the subset world box (min,
// max), inst_w2o (I, 3, 4) world to object, inst_root (I,) the BLAS root row,
// -1 outside the pass's mask; active may be null. Persistent warps and
// scratch as vkrt_alpha_machine's (vkrt_machine_slots with alpha 0). Outputs
// per ray: t (t_max where nothing was hit), tri (-1 then), u, v, inst, steps
// (nodes + 1 a round). Returns the first CUDA error.
int vkrt_opaque_machine(int cull, int any_hit, int width, const float* rows, int stack_depth,
                        const float* inst_box, const float* inst_w2o, const int32_t* inst_root,
                        int n_inst, const float* origin, const float* direction,
                        const float* t_max, const uint8_t* active, int64_t n_rays, int* scratch,
                        int64_t scratch_words, int64_t n_slots, float* t, int32_t* tri, float* u,
                        float* v, int32_t* inst, int32_t* steps, void* stream) {
  if (width != kWidth || stack_depth > vkrt_traverse_max_stack() || n_inst < 0 ||
      (cull != 0) == (any_hit != 0) || n_rays >= ((int64_t)1 << 31) || n_slots < kAbThreads ||
      scratch_words < vkrt_traverse_ab_words(stack_depth, n_slots))
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(scratch, 0, kScratchHead * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int lim = stack_depth > 1 ? stack_depth : 1;
  return (int)with_opaque(any_hit, n_inst, [&](auto k, size_t smem) -> int64_t {
    if (!prepare_machine(k)) return (int64_t)cudaGetLastError();
    k<<<grid_blocks(n_rays, n_slots), kAbThreads, smem, s>>>(
        reinterpret_cast<const float4*>(rows), lim, inst_box, inst_w2o, inst_root, n_inst,
        origin, direction, t_max, active, (int)n_rays, scan_batch(n_inst), scratch, n_slots, t,
        tri, u, v, inst, steps);
    return (int64_t)cudaGetLastError();
  });
}

// The alpha pass's need mask over n_rays rays (root_prefilter_kernel): a
// thread a ray, need[r] 1 or 0. `active` may be null (every ray). Returns
// cudaGetLastError() after the launch.
int vkrt_root_prefilter(int width, const float* rows, const float* origin,
                        const float* direction, const float* t_limit, const uint8_t* active,
                        int64_t n_rays, uint8_t* need, void* stream) {
  if (width != kWidth || n_rays < 0) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int64_t blocks = (n_rays + threads - 1) / threads;
  root_prefilter_kernel<kWidth><<<(unsigned)blocks, threads, 0, s>>>(
      rows, origin, direction, t_limit, active, n_rays, need);
  return (int)cudaGetLastError();
}

}  // extern "C"
