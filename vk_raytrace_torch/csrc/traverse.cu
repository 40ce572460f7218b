// BVH traversal over planar rows of width W = 16 or 32: one CUDA thread per
// ray, looping to termination. Modes a and b from the root (the main path's
// closest-hit and shadow rays) run in persistent warps with the stack in
// shared memory (vkrt_traverse_ab, see "Modes a and b from the root"
// below); every other entry runs trace<>, a thread per launched ray with a
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
// Six more entries:
//   vkrt_traverse_ab: modes a and b from the root, persistent warps;
//   vkrt_alpha_rounds, vkrt_opaque_machine, vkrt_alpha_machine: the round
//     machines (see "The round machines" below), each a host loop of
//     traversal rounds run whole, one thread per ray: the single-level alpha
//     candidate rounds of ops/traverse_alpha.py, and the two-level opaque and
//     alpha rounds of ops/tlas.py (instance enumeration in entry order over
//     the instance table held in shared memory, the ray transform, the
//     traversal of the instance's BLAS and, for alpha, the stochastic test),
//     all through the same per-node code as vkrt_traverse;
//   vkrt_sort_children: the child order of interior rows alone (the
//     counterpart of the TPU kernel's bitonic network _bitonic, which the
//     reference unit-tests through its own pallas_call, tests/test_fused.py),
//     a row per W lanes ranked in registers;
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
// -DVKRT_WIDTH=16 and -DVKRT_WIDTH=32, in parallel (each holds 24 kernels).

#include <cuda_runtime.h>
#include <stdint.h>

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
// (0, tmax): the per-node code of every entry. CAPPED (the capped entry
// only) stops after max_steps nodes and, with a non-null `own` (the
// no-gather variant), reads that row at every step instead of the node's
// row and starts over at the root where it would end.
template <int MODE, bool CULL, int MAXD, int W, bool CAPPED>
__device__ __forceinline__ void trace(const float4* __restrict__ rows, const Ray& y, float tmax,
                                      int cur, const float4* own, int max_steps, TraceOut& out) {
  using P = Planar<W>;
  const bool own_row = CAPPED && own != nullptr;

  // Opaque slot; candidate slot (nearest alpha-flagged hit) in mode c.
  float t_best = tmax, u_best = 0.0f, v_best = 0.0f;
  int tri_best = -1;
  float c_t = tmax, c_u = 0.0f, c_v = 0.0f, c_uvu = 0.0f, c_uvv = 0.0f;
  int c_tri = -1;
  int steps = 0;

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

// Ray setup from the tree's root: the union box hit within (0, tmax).
__device__ __forceinline__ bool enters_root(const Ray& y, const float (&rmin)[3],
                                            const float (&rmax)[3], float tmax) {
  float tn0, tf0;
  slab(y, rmin[0], rmin[1], rmin[2], rmax[0], rmax[1], rmax[2], tn0, tf0);
  return (tn0 <= tf0) && (tf0 >= 0.0f) && (tn0 < tmax);
}

// One ray from setup to its outputs.
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

  // The no-gather variant reads this ray's own row at every step (the
  // caller's table has a row for every ray).
  const float4* own = CAPPED && nogather != 0 ? rows + r * P::kRowF4 : nullptr;
  TraceOut h;
  trace<MODE, CULL, MAXD, W, CAPPED>(rows, y, tmax, cur, own, max_steps, h);
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
// Which ray a lane carries never changes that ray's result. (The entries
// that run trace<> keep its per-node code as it was.)
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
// their pops end the ray, as in the twin.
__device__ __forceinline__ int pop(const Stack& st, int& depth, int lim) {
  if (depth == 0) return kTerm;
  --depth;
  return depth < lim ? st.get(depth) : kTerm;
}

// Interior row: order_children's hit children in ascending entry order (a
// stable insertion into the list, after every key <= the new one), a lane
// group with no valid child skipped; all but the nearest pushed
// far-to-near, as trace<> pushes them. Returns the nearest, or pops where
// no child is hit.
template <int W>
__device__ __forceinline__ int interior_step(const float4* __restrict__ row, const Ray& y,
                                             float t_prune, const ChildList& cl, const Stack& st,
                                             int& depth, int lim, int& deepest) {
  constexpr int G = Planar<W>::kG;
  float* const key = cl.key;
  int* const ref = cl.ref;
  const int ls = cl.stride;
  int n = 0;
#pragma unroll(Planar<W>::kUnrollG)
  for (int g = 0; g < G; ++g) {
    const float4 bxm = row[0 * G + g], bxM = row[3 * G + g];
    if (!(bxm.x <= bxM.x || bxm.y <= bxM.y || bxm.z <= bxM.z || bxm.w <= bxM.w)) continue;
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

template <int MODE, bool CULL, int W>
__global__ void __launch_bounds__(kAbThreads, kAbMinBlocks)
persistent_traverse_kernel(const float4* __restrict__ rows, const float* __restrict__ origin,
                           const float* __restrict__ direction, const float* __restrict__ t_max,
                           const uint8_t* __restrict__ active, int n_rays, int lim,
                           int* __restrict__ scratch, int64_t n_slots,
                           float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                           float* __restrict__ out_u, float* __restrict__ out_v,
                           int32_t* __restrict__ out_steps) {
  using P = Planar<W>;
  constexpr bool kListShared = W == 16;
  __shared__ int sh_stack[kShStack * kAbThreads];
  __shared__ float s_root[6];
  __shared__ float sh_key[kListShared ? W * kAbThreads : 1];
  __shared__ int sh_ref[kListShared ? W * kAbThreads : 1];
  float l_key[kListShared ? 1 : W];
  int l_ref[kListShared ? 1 : W];
  if (threadIdx.x == 0) {
    float rmin[3], rmax[3];
    root_union<W>(rows, rmin, rmax);
    for (int k = 0; k < 3; ++k) {
      s_root[k] = rmin[k];
      s_root[3 + k] = rmax[k];
    }
  }
  __syncthreads();

  const unsigned lanes = __ballot_sync(0xffffffffu, true);
  const int lane = threadIdx.x & 31;
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const Stack st{sh_stack + threadIdx.x, (int)blockDim.x, scratch + kScratchHead + slot, n_slots};
  const ChildList cl = kListShared
                           ? ChildList{sh_key + threadIdx.x, sh_ref + threadIdx.x, (int)blockDim.x}
                           : ChildList{l_key, l_ref, 1};

  Ray y;
  int ray = -1, cur = kTerm, depth = 0, steps = 0, tri = -1, deepest = 0;
  float t_best = 0.0f, u = 0.0f, v = 0.0f;
  bool more = true;  // the counter may still hold rays (the same in every lane)
  while (true) {
    const unsigned idle = __ballot_sync(lanes, cur == kTerm);
    if (!more && idle == lanes) break;
    const int64_t r = fetch<kRefill>(lanes, idle, lane, scratch, n_rays, more);
    if (r >= 0) {
      ray = (int)r;
      y = load_ray(origin, direction, r);
      t_best = t_max[r];
      tri = -1;
      u = v = 0.0f;
      steps = 0;
      depth = 0;
      const float rmin[3] = {s_root[0], s_root[1], s_root[2]};
      const float rmax[3] = {s_root[3], s_root[4], s_root[5]};
      const bool go = enters_root(y, rmin, rmax, t_best) && (active == nullptr || active[r]);
      cur = go ? 0 : kTerm;
    }
    // Interior nodes until this lane is at a leaf or done.
    while (cur >= 0) {
      ++steps;
      cur = interior_step<W>(rows + (int64_t)cur * P::kRowF4, y, t_best, cl, st, depth, lim,
                             deepest);
    }
    // Leaves until this lane is at an interior node or done.
    while (cur < 0 && cur != kTerm) {
      ++steps;
      const int vleaf = -cur - 1;
      const int cnt = (vleaf & (P::kLT - 1)) + 1;
      LeafSlots L;
      leaf_tests<MODE, CULL, W>(rows + (int64_t)(vleaf >> P::kLeafShift) * P::kRowF4, cnt, y,
                                t_best, t_best, L);
      minfold<3>(L.tt_o, L.pay_o);
      const bool found = L.tt_o[0] < t_best;
      if (found) {
        t_best = L.tt_o[0];
        tri = (int)L.pay_o[0][0];
        u = L.pay_o[1][0];
        v = L.pay_o[2][0];
      }
      cur = MODE == kAny && found ? kTerm : pop(st, depth, lim);
    }
    if (ray >= 0 && cur == kTerm) {
      out_t[ray] = tri >= 0 ? t_best : kInf;
      out_tri[ray] = tri;
      out_u[ray] = u;
      out_v[ray] = v;
      out_steps[ray] = steps;
      ray = -1;
    }
  }
  deepest = __reduce_max_sync(lanes, deepest);
  if (lane == 0) atomicMax(scratch + 1, deepest);
}

// ---------------------------------------------------------------------------
// The round machines: each runs a host loop of rounds whole, one thread per
// ray for all of its rounds. The TPU ran every round as one traversal of its
// step kernel (vk_raytrace_tpu/ops/traverse_fused.py:644) inside a device-side
// loop over the whole batch:
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
// rounds, and in the two-level machines the per-round instance scan. What
// the design removes is the host loop: per round a live-lane gather, the
// window or transform, a launch, the alpha test or the candidate argmin over
// an (R, I) entry table as tens of small torch ops, the scatters and a host
// sync. A ray's state (window, best hit, seed, last instance) stays in
// registers across its rounds. The two-level machines hold the instance
// table (subset world box, world-to-object rows and BLAS root of each
// instance, 76 B) in shared memory up to kMaxInstances instances, where every
// thread of a warp reads the same instance at once; above, a table too large
// for a block's shared memory, they read it from global memory through the
// read-only path (GLOBAL instantiations, no dynamic shared memory), with the
// same arithmetic, so both give the same bits. The next candidate is the
// slab test recomputed against the table, so no per-ray entry table exists.
// The table, the enumeration and the ray transform live in traverse_common.cuh,
// which the wide back end's machine (traverse_wide.cu) shares.
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

// The single-level alpha rounds (traverse_alpha._rounds_core) for one ray:
// round after round, the candidate traversal of the alpha tree from its root
// over the window (t_lo, t_limit), then the stochastic test of the nearest
// candidate (with a null pack every candidate passes and nothing is drawn).
// Pass records it and stops, reject advances t_lo just past it and goes round
// again, no candidate stops. A ray stops after max_rounds rounds.
template <bool CULL, int MAXD, int W>
__global__ void __launch_bounds__(128)
alpha_rounds_kernel(const float4* __restrict__ rows, const float* __restrict__ origin,
                    const float* __restrict__ direction, const float* __restrict__ t_limit,
                    const uint8_t* __restrict__ active, const int64_t* __restrict__ seed_in,
                    const float* __restrict__ pack, int64_t n_pack,
                    const uint8_t* __restrict__ plane, int64_t n_plane, int64_t atlas_w,
                    int64_t n_rays, int max_rounds, float* __restrict__ out_t,
                    int32_t* __restrict__ out_tri, float* __restrict__ out_u,
                    float* __restrict__ out_v, int64_t* __restrict__ out_seed,
                    int32_t* __restrict__ out_steps) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;

  const Ray w = load_ray(origin, direction, r);
  const float tlim = t_limit[r];
  const int64_t seed0 = seed_in[r];
  uint32_t seed = (uint32_t)seed0;
  bool drew = false;
  float rmin[3], rmax[3];
  root_union<W>(rows, rmin, rmax);
  float t_lo = 0.0f, t = kInf, u = 0.0f, v = 0.0f;
  int tri = -1, steps = 0;
  bool live = active == nullptr || active[r];
  for (int round = 0; live && round < max_rounds; ++round) {
    // The window start moved along the ray (o + d * t_lo, in torch's order;
    // the direction and its reciprocal stay), the window end clamped at 0 as
    // torch.clamp does it (NaN stays NaN, where fmaxf would give 0).
    Ray y = w;
    y.ox = __fadd_rn(w.ox, __fmul_rn(w.dx, t_lo));
    y.oy = __fadd_rn(w.oy, __fmul_rn(w.dy, t_lo));
    y.oz = __fadd_rn(w.oz, __fmul_rn(w.dz, t_lo));
    const float left = __fsub_rn(tlim, t_lo);
    const float win = left < 0.0f ? 0.0f : left;
    TraceOut h;
    trace<kCandidate, CULL, MAXD, W, false>(rows, y, win,
                                            enters_root(y, rmin, rmax, win) ? 0 : kTerm, nullptr,
                                            0, h);
    const bool cand = h.tri >= 0;
    bool passed = cand;
    if (cand && pack != nullptr) {
      passed = alpha_accept(pack, n_pack, plane, n_plane, atlas_w, h.tri, h.uvu, h.uvv, seed);
      drew = true;
    }
    const float t_abs = __fadd_rn(t_lo, h.t);
    if (passed) {
      t = t_abs;
      tri = h.tri;
      u = h.u;
      v = h.v;
    }
    steps += h.steps;
    live = cand && !passed;
    if (live) t_lo = __fadd_rn(__fmul_rn(t_abs, kAdvMul), kAdvAbs);
  }
  out_t[r] = t;
  out_tri[r] = tri;
  out_u[r] = u;
  out_v[r] = v;
  out_seed[r] = drew ? (int64_t)seed : seed0;
  out_steps[r] = steps;
}

// The two-level opaque rounds (tlas._two_level_pass) for one ray: the
// instances of the mask in (entry t, id) order, each traversed from its BLAS
// root in its own object space with t_max = the best hit so far, in mode a
// (closest, culling) or mode b (any, no culling: the first hit ends the ray).
// Every round consumes an instance, so a ray ends within n_inst rounds.
// GLOBAL: the instance table in global memory (n_inst > kMaxInstances).
template <bool ANY, int MAXD, int W, bool GLOBAL>
__global__ void __launch_bounds__(128)
opaque_machine_kernel(const float4* __restrict__ rows, const float* __restrict__ inst_box,
                      const float* __restrict__ inst_w2o, const int32_t* __restrict__ inst_root,
                      int n_inst, const float* __restrict__ origin,
                      const float* __restrict__ direction, const float* __restrict__ t_max,
                      const uint8_t* __restrict__ active, int64_t n_rays,
                      float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                      float* __restrict__ out_u, float* __restrict__ out_v,
                      int32_t* __restrict__ out_inst, int32_t* __restrict__ out_steps) {
  extern __shared__ float smem[];
  const Instances<GLOBAL> it =
      load_instances<GLOBAL>(smem, inst_box, inst_w2o, inst_root, n_inst);
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;

  const Ray w = load_ray(origin, direction, r);
  const float tmax0 = t_max[r];
  float t_best = tmax0, u = 0.0f, v = 0.0f, last_t = kNeg, nt;
  int tri = -1, ibest = 0, steps = 0, last_id = -1;
  int cid = next_instance(it, n_inst, w, tmax0, t_best, last_t, last_id, nt);
  bool live = (active == nullptr || active[r]) && cid >= 0;
  while (live) {
    // The world origin itself goes into object space: o + d * 0 would make
    // a -0 coordinate +0.
    const Ray y = instance_ray(it, cid, w.ox, w.oy, w.oz, w);
    TraceOut h;
    trace<ANY ? kAny : kClosest, !ANY, MAXD, W, false>(rows, y, t_best, it.root_at(cid),
                                                       nullptr, 0, h);
    if (h.tri >= 0) {
      t_best = h.t;
      tri = h.tri;
      u = h.u;
      v = h.v;
      ibest = cid;
    }
    steps += h.steps + 1;
    last_t = nt;
    last_id = cid;
    cid = next_instance(it, n_inst, w, tmax0, t_best, last_t, last_id, nt);
    live = cid >= 0 && !(ANY && tri >= 0);  // any hit: the first hit occludes
  }
  out_t[r] = t_best;
  out_tri[r] = tri;
  out_u[r] = u;
  out_v[r] = v;
  out_inst[r] = ibest;
  out_steps[r] = steps;
}

// The two-level alpha rounds (tlas._two_level_alpha_pass) for one ray: a
// live ray holds a candidate instance and a window start t_lo inside it. A
// round traverses the instance's alpha BLAS in candidate mode over
// (t_lo, t_best); the nearest alpha surface takes its stochastic test: pass
// records it and moves to the next instance, reject advances t_lo past it and
// stays, no surface moves on. A ray stops after max_rounds rounds.
// GLOBAL: the instance table in global memory (n_inst > kMaxInstances).
template <bool CULL, bool ANY, int MAXD, int W, bool GLOBAL>
__global__ void __launch_bounds__(128)
alpha_machine_kernel(const float4* __restrict__ rows, const float* __restrict__ inst_box,
                     const float* __restrict__ inst_w2o, const int32_t* __restrict__ inst_root,
                     int n_inst, const float* __restrict__ pack, int64_t n_pack,
                     const uint8_t* __restrict__ plane, int64_t n_plane, int64_t atlas_w,
                     const float* __restrict__ origin, const float* __restrict__ direction,
                     const float* __restrict__ t_max, const uint8_t* __restrict__ active,
                     const int64_t* __restrict__ seed_in, int64_t n_rays, int max_rounds,
                     float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                     float* __restrict__ out_u, float* __restrict__ out_v,
                     int32_t* __restrict__ out_inst, int64_t* __restrict__ out_seed,
                     int32_t* __restrict__ out_steps) {
  extern __shared__ float smem[];
  const Instances<GLOBAL> it =
      load_instances<GLOBAL>(smem, inst_box, inst_w2o, inst_root, n_inst);
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;

  const Ray w = load_ray(origin, direction, r);
  const float tmax0 = t_max[r];
  uint32_t seed = (uint32_t)seed_in[r];
  float t_best = tmax0, u = 0.0f, v = 0.0f, last_t = kNeg, t_lo = 0.0f, nt;
  int tri = -1, ibest = 0, steps = 0, last_id = -1;
  int cid = next_instance(it, n_inst, w, tmax0, t_best, last_t, last_id, nt);
  bool live = (active == nullptr || active[r]) && cid >= 0;
  for (int round = 0; live && round < max_rounds; ++round) {
    // The window start moved along the world ray, then into the instance's
    // object space.
    const Ray y = instance_ray(it, cid, __fadd_rn(w.ox, __fmul_rn(w.dx, t_lo)),
                               __fadd_rn(w.oy, __fmul_rn(w.dy, t_lo)),
                               __fadd_rn(w.oz, __fmul_rn(w.dz, t_lo)), w);
    TraceOut h;
    trace<kCandidate, CULL, MAXD, W, false>(rows, y, fmaxf(__fsub_rn(t_best, t_lo), 0.0f),
                                            it.root_at(cid), nullptr, 0, h);
    const bool cand = h.tri >= 0;
    const bool passed =
        cand && alpha_accept(pack, n_pack, plane, n_plane, atlas_w, h.tri, h.uvu, h.uvv, seed);
    const float t_abs = __fadd_rn(t_lo, h.t);
    if (passed) {
      t_best = t_abs;
      tri = h.tri;
      u = h.u;
      v = h.v;
      ibest = cid;
    }
    steps += h.steps + 1;
    if (cand && !passed) {
      t_lo = __fadd_rn(__fmul_rn(t_abs, kAdvMul), kAdvAbs);
    } else {
      last_t = nt;
      last_id = cid;
      t_lo = 0.0f;
      cid = next_instance(it, n_inst, w, tmax0, t_best, last_t, last_id, nt);
    }
    live = cid >= 0 && !(ANY && tri >= 0);  // any hit: the first accepted surface occludes
  }
  out_t[r] = t_best;
  out_tri[r] = tri;
  out_u[r] = u;
  out_v[r] = v;
  out_inst[r] = ibest;
  out_seed[r] = (int64_t)seed;
  out_steps[r] = steps;
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

template <bool CULL, bool ANY, int MAXD>
void launch_machine(const float* rows, const float* box, const float* w2o, const int32_t* root,
                    int n_inst, const float* pack, int64_t n_pack, const uint8_t* plane,
                    int64_t n_plane, int64_t atlas_w, const float* o, const float* d,
                    const float* tmax, const uint8_t* active, const int64_t* seed, int64_t n,
                    int max_rounds, float* t, int32_t* tri, float* u, float* v, int32_t* inst,
                    int64_t* seed_out, int32_t* steps, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const auto* r4 = reinterpret_cast<const float4*>(rows);
  if (n_inst > kMaxInstances) {
    alpha_machine_kernel<CULL, ANY, MAXD, kWidth, true><<<blocks, threads, 0, stream>>>(
        r4, box, w2o, root, n_inst, pack, n_pack, plane, n_plane, atlas_w, o, d, tmax, active,
        seed, n, max_rounds, t, tri, u, v, inst, seed_out, steps);
    return;
  }
  const size_t smem = (size_t)n_inst * kInstWords * sizeof(float);
  alpha_machine_kernel<CULL, ANY, MAXD, kWidth, false><<<blocks, threads, smem, stream>>>(
      r4, box, w2o, root, n_inst, pack, n_pack, plane, n_plane, atlas_w, o, d, tmax, active,
      seed, n, max_rounds, t, tri, u, v, inst, seed_out, steps);
}

template <bool CULL, int MAXD>
void launch_rounds(const float* rows, const float* o, const float* d, const float* t_limit,
                   const uint8_t* active, const int64_t* seed, const float* pack, int64_t n_pack,
                   const uint8_t* plane, int64_t n_plane, int64_t atlas_w, int64_t n,
                   int max_rounds, float* t, int32_t* tri, float* u, float* v, int64_t* seed_out,
                   int32_t* steps, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  alpha_rounds_kernel<CULL, MAXD, kWidth><<<blocks, threads, 0, stream>>>(
      reinterpret_cast<const float4*>(rows), o, d, t_limit, active, seed, pack, n_pack, plane,
      n_plane, atlas_w, n, max_rounds, t, tri, u, v, seed_out, steps);
}

template <bool ANY, int MAXD>
void launch_opaque(const float* rows, const float* box, const float* w2o, const int32_t* root,
                   int n_inst, const float* o, const float* d, const float* tmax,
                   const uint8_t* active, int64_t n, float* t, int32_t* tri, float* u, float* v,
                   int32_t* inst, int32_t* steps, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const auto* r4 = reinterpret_cast<const float4*>(rows);
  if (n_inst > kMaxInstances) {
    opaque_machine_kernel<ANY, MAXD, kWidth, true><<<blocks, threads, 0, stream>>>(
        r4, box, w2o, root, n_inst, o, d, tmax, active, n, t, tri, u, v, inst, steps);
    return;
  }
  const size_t smem = (size_t)n_inst * kInstWords * sizeof(float);
  opaque_machine_kernel<ANY, MAXD, kWidth, false><<<blocks, threads, smem, stream>>>(
      r4, box, w2o, root, n_inst, o, d, tmax, active, n, t, tri, u, v, inst, steps);
}

// The persistent a/b kernel of `mode` (closest with culling, any without),
// or null for another mode.
template <int W = kWidth>
auto ab_kernel(int mode) -> decltype(&persistent_traverse_kernel<kClosest, true, W>) {
  if (mode == kClosest) return &persistent_traverse_kernel<kClosest, true, W>;
  if (mode == kAny) return &persistent_traverse_kernel<kAny, false, W>;
  return nullptr;
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

// int32 words of the a/b entry's scratch for a tree with this stack bound
// and n_slots resident threads: the head, then the stack entries past the
// shared ones, a column per thread.
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
  const int64_t need = (n_rays + kAbThreads - 1) / kAbThreads;
  const int64_t blocks = need < n_slots / kAbThreads ? need : n_slots / kAbThreads;
  k<<<(unsigned)blocks, kAbThreads, 0, s>>>(
      reinterpret_cast<const float4*>(rows), origin, direction, t_max, active, (int)n_rays,
      stack_depth > 1 ? stack_depth : 1, scratch, n_slots, t, tri, u, v, steps);
  return (int)cudaGetLastError();
}

// Largest stack depth any instantiation holds; the wrapper refuses trees
// whose exact stack bound exceeds it.
int vkrt_traverse_max_stack() { return 128; }

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
  const int threads = 256;
  const unsigned blocks = (unsigned)((n * kWidth + threads - 1) / threads);
  sort_children_kernel<kWidth><<<blocks, threads, 0, s>>>(keys, refs, n, out_keys, out_refs,
                                                          out_count);
  return (int)cudaGetLastError();
}

// The two-level alpha machine over n_rays world rays, to the end of each
// ray's rounds (at most max_rounds): closest hit with culling (cull 1,
// any_hit 0) or any hit without (cull 0, any_hit 1). rows: the alpha-subset
// BLAS table (this library's width) with its stack bound; per instance (in
// shared memory up to kMaxInstances, read from global memory above):
// inst_box (I, 6) the alpha-subset world box (min, max), inst_w2o (I, 3, 4)
// world to object, inst_root (I,) the BLAS root row, -1 outside the alpha
// mask; pack (n_pack, 16) the AlphaPack rows, plane the
// atlas alpha channel (n_plane bytes, rows atlas_w wide); seed (n_rays,)
// uint32 values in int64. Outputs per ray: t (t_max where no surface was
// accepted), tri (-1 then), u, v, inst, seed, steps. Returns
// cudaGetLastError() after launch.
int vkrt_alpha_machine(int cull, int any_hit, int width, const float* rows, int stack_depth,
                       const float* inst_box, const float* inst_w2o, const int32_t* inst_root,
                       int n_inst, const float* pack, int64_t n_pack, const uint8_t* plane,
                       int64_t n_plane, int64_t atlas_w, const float* origin,
                       const float* direction, const float* t_max, const uint8_t* active,
                       const int64_t* seed, int64_t n_rays, int max_rounds, float* t,
                       int32_t* tri, float* u, float* v, int32_t* inst, int64_t* seed_out,
                       int32_t* steps, void* stream) {
  if (width != kWidth || stack_depth > 128 || n_inst < 0 || n_pack < 1 || n_plane < 1 ||
      (cull != 0) == (any_hit != 0))
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define VKRT_MACHINE(C, A, D)                                                                  \
  launch_machine<C, A, D>(rows, inst_box, inst_w2o, inst_root, n_inst, pack, n_pack, plane,   \
                          n_plane, atlas_w, origin, direction, t_max, active, seed, n_rays,   \
                          max_rounds, t, tri, u, v, inst, seed_out, steps, s)
  if (cull && stack_depth <= 64) VKRT_MACHINE(true, false, 64);
  else if (cull) VKRT_MACHINE(true, false, 128);
  else if (stack_depth <= 64) VKRT_MACHINE(false, true, 64);
  else VKRT_MACHINE(false, true, 128);
#undef VKRT_MACHINE
  return (int)cudaGetLastError();
}

// The single-level alpha rounds over n_rays rays, each to the end of its
// rounds (at most max_rounds): rows, the alpha tree (this library's width)
// with its stack bound; t_limit (n_rays,) the window ends; active may be null;
// seed (n_rays,) uint32 values in int64. pack (n_pack, 16) the AlphaPack rows
// and plane the atlas alpha channel (n_plane bytes, rows atlas_w wide), or a
// null pack: every candidate passes and no seed moves. cull: backface culling
// of the candidates. Outputs per ray: t (1e32 where no surface was accepted),
// tri (-1 then), u, v, seed, steps (nodes over all rounds). Returns
// cudaGetLastError() after launch.
int vkrt_alpha_rounds(int cull, int width, const float* rows, int stack_depth,
                      const float* origin, const float* direction, const float* t_limit,
                      const uint8_t* active, const int64_t* seed, const float* pack,
                      int64_t n_pack, const uint8_t* plane, int64_t n_plane, int64_t atlas_w,
                      int64_t n_rays, int max_rounds, float* t, int32_t* tri, float* u, float* v,
                      int64_t* seed_out, int32_t* steps, void* stream) {
  if (width != kWidth || stack_depth > 128 || (pack != nullptr && (n_pack < 1 || n_plane < 1)))
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define VKRT_ROUNDS(C, D)                                                                      \
  launch_rounds<C, D>(rows, origin, direction, t_limit, active, seed, pack, n_pack, plane,    \
                      n_plane, atlas_w, n_rays, max_rounds, t, tri, u, v, seed_out, steps, s)
  if (cull && stack_depth <= 64) VKRT_ROUNDS(true, 64);
  else if (cull) VKRT_ROUNDS(true, 128);
  else if (stack_depth <= 64) VKRT_ROUNDS(false, 64);
  else VKRT_ROUNDS(false, 128);
#undef VKRT_ROUNDS
  return (int)cudaGetLastError();
}

// The two-level opaque rounds over n_rays world rays, each to its last
// instance: closest hit with culling (cull 1, any_hit 0) or any hit without
// (cull 0, any_hit 1). rows: the BLAS table (this library's width) with its
// stack bound; per instance (in shared memory up to kMaxInstances, read from
// global memory above): inst_box (I, 6) the subset world box (min, max),
// inst_w2o (I, 3, 4) world to object, inst_root (I,) the BLAS root row, -1
// outside the pass's mask; active may be null. Outputs per ray:
// t (t_max where nothing was hit), tri (-1 then), u, v, inst, steps. Returns
// cudaGetLastError() after launch.
int vkrt_opaque_machine(int cull, int any_hit, int width, const float* rows, int stack_depth,
                        const float* inst_box, const float* inst_w2o, const int32_t* inst_root,
                        int n_inst, const float* origin, const float* direction,
                        const float* t_max, const uint8_t* active, int64_t n_rays, float* t,
                        int32_t* tri, float* u, float* v, int32_t* inst, int32_t* steps,
                        void* stream) {
  if (width != kWidth || stack_depth > 128 || n_inst < 0 || (cull != 0) == (any_hit != 0))
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define VKRT_OPAQUE(A, D)                                                                      \
  launch_opaque<A, D>(rows, inst_box, inst_w2o, inst_root, n_inst, origin, direction, t_max,  \
                      active, n_rays, t, tri, u, v, inst, steps, s)
  if (!any_hit && stack_depth <= 64) VKRT_OPAQUE(false, 64);
  else if (!any_hit) VKRT_OPAQUE(false, 128);
  else if (stack_depth <= 64) VKRT_OPAQUE(true, 64);
  else VKRT_OPAQUE(true, 128);
#undef VKRT_OPAQUE
  return (int)cudaGetLastError();
}

}  // extern "C"
