// The wide back end's traversal over 8-wide rows, the alpha test of
// alpha-flagged candidates run inside the traversal: one tree
// (vkrt_traverse_wide) and the two-level rounds whole (vkrt_wide_machine).
//
// Replaces the XLA body vk_raytrace_tpu/ops/traverse_wide.py::_traverse_wide
// (the reference's RayQuery analog, its `--renderer wide`) and, for two
// levels, the XLA while-loops around it (vk_raytrace_tpu/ops/tlas.py
// _two_level_pass with the wide body, :432-590). That body advanced every ray
// of a batch by one node per step of a phased while-loop, with the (R, D)
// stack in device memory, compaction of the live lanes between phases and a
// merge at the end; here each ray's whole traversal, and each ray's every
// instance round, runs in one lane, so none of that exists.
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
//     row's valid child boxes; with them (root0) each ray starts at its own
//     interior row;
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
// The machine runs tlas._wide_rounds for each ray: the instances of the
// pass's mask in (entry t, id) order (traverse_common.cuh's next_instance
// over the instance table, in shared memory up to kMaxInstances instances and
// read from global memory above), each traversed from its mesh's 8-wide BLAS
// root in its own object space with t_max = the best hit so far, the seed
// carried across rounds, a node count of the round's nodes + 1 per round;
// any hit stops at the first accepted hit. Outputs as _wide_rounds: t_best
// (t_max where nothing was hit), tri, u, v, inst, seed, steps.
//
// What bounds them on the card: dependent row reads (each node's row address
// comes from the previous row) and divergence between the rays of a warp,
// not arithmetic or bytes (PERF.md). The design, as vkrt_traverse_ab's in
// traverse.cu:
//   * persistent warps: as many blocks as reside on the card; a warp takes
//     rays from a global counter, one atomicAdd for all its idle lanes, once
//     kRefill of them are idle, so lanes whose rays ended get new rays
//     instead of waiting for the warp's slowest ray (in the machine: its
//     slowest ray over all of its rounds); a warp steps interior rows until
//     every lane is at a leaf or done, then leaves, so it does not run both
//     kinds of node in one step;
//   * the stack in shared memory (traverse_common.cuh's Stack: kShStack
//     entries a thread laid out by thread, an exact global spill past them),
//     where the first design kept a 64-entry stack in local memory;
//   * rows read as float4 through the read-only path, a pair of children's
//     boxes from three float4, the child keys and refs and the network in
//     registers (constant indices only), the leaf tournament by selects;
//   * the root union box once a block, in shared memory;
//   * __launch_bounds__ at the blocks an SM holds (kWideMinBlocks,
//     kMachineMinBlocks).
// Which ray a lane carries never changes that ray's result.
//
// Numerics follow the plain torch versions (ops/traverse_wide.py
// _traverse_wide_plain, ops/tlas.py _wide_rounds) operation by operation,
// with explicitly rounded intrinsics, -fmad=false and IEEE division, so they
// agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "traverse_common.cuh"

namespace {

constexpr int kTerm = -(1 << 30);
constexpr float kRootBig = 3.0e38f;
constexpr float kEpsDet = 1e-12f;
constexpr float kInv255 = 1.0f / 255.0f;
constexpr float kAlphaMask = 1.0f;  // models/schema.py ALPHA_MASK
constexpr long long kWrapRepeat = 0, kWrapClamp = 1;
// The stack: the reference caps its own at 64 entries; the host refuses a
// tree whose exact bound is deeper, so no push is ever dropped.
constexpr int kMaxStack = 64;
constexpr int kThreads = 128;
// Resident blocks of 128 an SM that __launch_bounds__ asks for: 6 for the
// tree entry (80 registers), 6 for the machine (80), which also holds the
// world ray and its instance state. Measured on the H100 (chip_ab.py, PERF.md
// section 6): the tree entry at 8 blocks (64 registers, spilling) ran 5%
// slower than at 6, at 4 no faster; the machine at 5 or 4 blocks no faster
// than at 6; 8 shared stack entries instead of 16 changed nothing.
constexpr int kWideMinBlocks = 6, kMachineMinBlocks = 6;
// A warp fetches rays once this many lanes idle (vkrt_traverse_ab: 8).
// Measured on the H100 (chip_ab.py, PERF.md section 6): at 4 never slower
// than at 8, and 2% faster on the bistro's foliage; 16, or a fetch only
// when all 32 lanes idle, no faster.
constexpr int kRefill = 4;

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

struct Alpha {
  const float* pack;
  int64_t n_pack;
  const uint8_t* plane;
  int64_t n_plane, atlas_w;
};

// traverse_alpha._alpha_opacity for one candidate: the triangle's AlphaPack
// row (a_factor, mode, cutoff, tex_id, uv transform 3x2, atlas x/y/w/h,
// wrap s/t) and the atlas texel its uv falls in.
__device__ __forceinline__ float opacity(const Alpha& al, int tri, float uvu, float uvv) {
  const int64_t row = tri < 0 ? 0 : (tri >= al.n_pack ? al.n_pack - 1 : tri);
  const float4* a = reinterpret_cast<const float4*>(al.pack + row * 16);
  const float4 a0 = __ldg(a), a1 = __ldg(a + 1), a2 = __ldg(a + 2), a3 = __ldg(a + 3);
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
    long long flat = yw * al.atlas_w + xw;
    flat = flat < 0 ? 0 : (flat > al.n_plane - 1 ? al.n_plane - 1 : flat);
    alpha = __fmul_rn(a0.x, __fmul_rn((float)__ldg(al.plane + flat), kInv255));
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
  const bool s = k[i] > k[j];
  const float ki = k[i], kj = k[j];
  const int ri = r[i], rj = r[j];
  k[i] = s ? kj : ki;
  k[j] = s ? ki : kj;
  r[i] = s ? rj : ri;
  r[j] = s ? ri : rj;
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

// One lane's traversal of one tree: the (object-space) ray, its best hit so
// far, the node it is at (kTerm: done) and its stack depth.
struct Trav {
  Ray y;
  float t_best, u, v;
  int tri, steps, cur, depth;
  uint32_t seed;
};

// The union of the root row's valid child boxes (min xyz, max xyz).
__device__ __forceinline__ void root_union(const float4* __restrict__ rows, float (&box)[6]) {
  const float* root = reinterpret_cast<const float*>(rows);
  box[0] = box[1] = box[2] = kRootBig;
  box[3] = box[4] = box[5] = -kRootBig;
  for (int c = 0; c < 8; ++c) {
    const float* b = root + c * 6;
    if (b[0] <= b[3]) {
      for (int a = 0; a < 3; ++a) {
        box[a] = fminf(box[a], b[a]);
        box[3 + a] = fmaxf(box[3 + a], b[3 + a]);
      }
    }
  }
}

// Pop the next node, or kTerm on an empty stack.
__device__ __forceinline__ int pop(const Stack& st, int& depth) {
  return depth > 0 ? st.get(--depth) : kTerm;
}

// One child's slab test: its key (entry t, kInf where missed) and ref.
__device__ __forceinline__ void child(const Ray& y, float t_best, float bxm, float bym, float bzm,
                                      float bxM, float byM, float bzM, float rf, float& key,
                                      int& ref) {
  float tn, tf;
  slab(y, bxm, bym, bzm, bxM, byM, bzM, tn, tf);
  const bool hit = bxm <= bxM && tn <= tf && tf >= 0.0f && tn < t_best;
  key = hit ? tn : kInf;
  ref = (int)rf;
}

// An interior row: the 8 slab tests, the network's order, the nearest hit
// child next and the rest pushed far to near (sorted child k to stack entry
// depth + n_valid - 1 - k; entries past the tree's bound `lim` dropped and
// the depth clamped at it, as the plain version does, though the exact bound
// is never passed); a pop where no child is hit.
__device__ __forceinline__ void interior_step(const float4* __restrict__ rows, Trav& s,
                                              const Stack& st, int lim, int& deepest) {
  const float4* row = rows + (int64_t)s.cur * 16;
  float key[8];
  int ref[8];
  const float4 r0 = __ldg(row + 12), r1 = __ldg(row + 13);
  const float rf[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
  for (int p = 0; p < 4; ++p) {  // children 2p and 2p+1: float4 3p .. 3p+2
    const float4 a = __ldg(row + 3 * p), b = __ldg(row + 3 * p + 1), c = __ldg(row + 3 * p + 2);
    child(s.y, s.t_best, a.x, a.y, a.z, a.w, b.x, b.y, rf[2 * p], key[2 * p], ref[2 * p]);
    child(s.y, s.t_best, b.z, b.w, c.x, c.y, c.z, c.w, rf[2 * p + 1], key[2 * p + 1],
          ref[2 * p + 1]);
  }
  sort8(key, ref);
  int n_valid = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) n_valid += key[c] < kInf ? 1 : 0;
  if (n_valid == 0) {
    s.cur = pop(st, s.depth);
    return;
  }
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    const int d = s.depth + n_valid - 1 - k;
    if (k < n_valid && d < lim) st.put(d, ref[k]);
  }
  s.depth = min(s.depth + n_valid - 1, lim);
  deepest = max(deepest, s.depth);
  s.cur = ref[0];
}

// A leaf row: up to 4 triangles (all 4 computed, a triangle past the count
// never a hit, as in the plain version), the alpha test inline, the
// reference's tournament ((0, 1) and (2, 3), then their winners; the later
// entry wins only where its t is strictly less). Any hit ends the ray at its
// first accepted hit; otherwise a pop.
template <bool ANY, bool ALPHA>
__device__ __forceinline__ void leaf_step(const float4* __restrict__ rows, Trav& s,
                                          const Stack& st, const Alpha& al) {
  constexpr bool kCull = !ANY;
  const int vleaf = -s.cur - 1;
  const int cnt = (vleaf & 3) + 1;
  const float4* row = rows + (int64_t)(vleaf >> 2) * 16;
  const Ray& y = s.y;
  float tc[4], uc[4], vc[4];
  int oc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 a = __ldg(row + 4 * k), b = __ldg(row + 4 * k + 1), c = __ldg(row + 4 * k + 2),
                 d = __ldg(row + 4 * k + 3);
    const float p0x = a.x, p0y = a.y, p0z = a.z, p1x = a.w, p1y = b.x, p1z = b.y;
    const float p2x = b.z, p2y = b.w, p2z = c.x;
    const int meta = (int)d.w;
    const int orig = meta >> 2;
    const int flags = meta & 3;
    const float e1x = __fsub_rn(p1x, p0x), e1y = __fsub_rn(p1y, p0y), e1z = __fsub_rn(p1z, p0z);
    const float e2x = __fsub_rn(p2x, p0x), e2y = __fsub_rn(p2y, p0y), e2z = __fsub_rn(p2z, p0z);
    const float pvx = __fsub_rn(__fmul_rn(y.dy, e2z), __fmul_rn(y.dz, e2y));
    const float pvy = __fsub_rn(__fmul_rn(y.dz, e2x), __fmul_rn(y.dx, e2z));
    const float pvz = __fsub_rn(__fmul_rn(y.dx, e2y), __fmul_rn(y.dy, e2x));
    const float det = __fadd_rn(__fadd_rn(__fmul_rn(e1x, pvx), __fmul_rn(e1y, pvy)),
                                __fmul_rn(e1z, pvz));
    const bool det_ok = fabsf(det) > kEpsDet;
    const bool facing = kCull ? (((flags & 1) != 0) || (det > kEpsDet)) : det_ok;
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
    bool geo = k < cnt && det_ok && facing && uu >= 0.0f && vv >= 0.0f &&
               __fadd_rn(uu, vv) <= 1.0f && tt > 0.0f && tt < s.t_best;
    if (ALPHA && geo && (flags & 2) != 0) {
      // The in-traversal alpha test: this candidate's texture uv, its
      // opacity and one draw.
      const float wbar = __fsub_rn(__fsub_rn(1.0f, uu), vv);
      const float uvu =
          __fadd_rn(__fadd_rn(__fmul_rn(c.y, wbar), __fmul_rn(c.w, uu)), __fmul_rn(d.y, vv));
      const float uvv =
          __fadd_rn(__fadd_rn(__fmul_rn(c.z, wbar), __fmul_rn(d.x, uu)), __fmul_rn(d.z, vv));
      const float op = opacity(al, orig, uvu, uvv);
      geo = rand01(s.seed) <= op;
    }
    tc[k] = geo ? tt : kInf;
    oc[k] = orig;
    uc[k] = uu;
    vc[k] = vv;
  }
  const bool s01 = tc[1] < tc[0], s23 = tc[3] < tc[2];
  const float t01 = s01 ? tc[1] : tc[0], t23 = s23 ? tc[3] : tc[2];
  const bool s_w = t23 < t01;
  const float tw = s_w ? t23 : t01;
  bool found = false;
  if (tw < s.t_best) {
    s.t_best = tw;
    s.tri = s_w ? (s23 ? oc[3] : oc[2]) : (s01 ? oc[1] : oc[0]);
    s.u = s_w ? (s23 ? uc[3] : uc[2]) : (s01 ? uc[1] : uc[0]);
    s.v = s_w ? (s23 ? vc[3] : vc[2]) : (s01 ? vc[1] : vc[0]);
    found = true;
  }
  s.cur = ANY && found ? kTerm : pop(st, s.depth);  // the first accepted hit occludes
}

// A lane's nodes until it is done or must leave the loops: interior rows
// until it is at a leaf or done, then leaves until it is at an interior row
// or done (the warp runs one kind of node at a time).
template <bool ANY, bool ALPHA>
__device__ __forceinline__ void run_nodes(const float4* __restrict__ rows, Trav& s,
                                          const Stack& st, int lim, const Alpha& al,
                                          int& deepest) {
  while (s.cur >= 0) {
    ++s.steps;
    interior_step(rows, s, st, lim, deepest);
  }
  while (s.cur < 0 && s.cur != kTerm) {
    ++s.steps;
    leaf_step<ANY, ALPHA>(rows, s, st, al);
  }
}

template <bool ANY, bool ALPHA>
__global__ void __launch_bounds__(kThreads, kWideMinBlocks)
wide_kernel(const float4* __restrict__ rows, int lim, const float* __restrict__ origin,
            const float* __restrict__ direction, const float* __restrict__ t_max,
            const uint8_t* __restrict__ active, const int32_t* __restrict__ root0,
            const int64_t* __restrict__ seed_in, Alpha al, int n_rays, int* __restrict__ scratch,
            int64_t n_slots, float* __restrict__ out_t, int32_t* __restrict__ out_tri,
            float* __restrict__ out_u, float* __restrict__ out_v, int32_t* __restrict__ out_steps,
            int64_t* __restrict__ out_seed) {
  __shared__ int sh_stack[kShStack * kThreads];
  __shared__ float s_root[6];
  if (root0 == nullptr && threadIdx.x == 0) {
    float box[6];
    root_union(rows, box);
    for (int k = 0; k < 6; ++k) s_root[k] = box[k];
  }
  __syncthreads();

  const unsigned lanes = __ballot_sync(0xffffffffu, true);
  const int lane = threadIdx.x & 31;
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const Stack st{sh_stack + threadIdx.x, (int)blockDim.x, scratch + kScratchHead + slot, n_slots};
  Trav s;
  s.cur = kTerm;
  int64_t ray = -1;
  int deepest = 0;
  bool more = true;  // the counter may still hold rays (the same in every lane)
  while (true) {
    const unsigned idle = __ballot_sync(lanes, s.cur == kTerm);
    if (!more && idle == lanes) break;
    const int64_t r = fetch<kRefill>(lanes, idle, lane, scratch, n_rays, more);
    if (r >= 0) {
      ray = r;
      s.y = load_ray(origin, direction, r);
      s.t_best = t_max[r];
      s.seed = seed_in != nullptr ? (uint32_t)seed_in[r] : 0u;
      s.tri = -1;
      s.u = s.v = 0.0f;
      s.steps = 0;
      s.depth = 0;
      if (root0 != nullptr) {
        s.cur = root0[r];
      } else {
        float tn, tf;
        slab(s.y, s_root[0], s_root[1], s_root[2], s_root[3], s_root[4], s_root[5], tn, tf);
        s.cur = (tn <= tf) && (tf >= 0.0f) && (tn < s.t_best) ? 0 : kTerm;
      }
      if (active != nullptr && !active[r]) s.cur = kTerm;
    }
    run_nodes<ANY, ALPHA>(rows, s, st, lim, al, deepest);
    if (ray >= 0 && s.cur == kTerm) {
      out_t[ray] = s.tri >= 0 ? s.t_best : kInf;
      out_tri[ray] = s.tri;
      out_u[ray] = s.u;
      out_v[ray] = s.v;
      out_steps[ray] = s.steps;
      out_seed[ray] = (int64_t)s.seed;
      ray = -1;
    }
  }
  deepest = __reduce_max_sync(lanes, deepest);
  if (lane == 0) atomicMax(scratch + 1, deepest);
}

// The two-level wide rounds (tlas._wide_rounds) for every ray. A lane's ray
// keeps its world ray, its window end tmax0, its last instance (last_t,
// last_id) and the instance of its current round (cid, entered at nt, with
// the best t at the round's start t0); a round ends where its tree's
// traversal does, and the next instance starts or the ray ends there.
// GLOBAL: the instance table in global memory (n_inst > kMaxInstances).
template <bool ANY, bool ALPHA, bool GLOBAL>
__global__ void __launch_bounds__(kThreads, kMachineMinBlocks)
wide_machine_kernel(const float4* __restrict__ rows, int lim, const float* __restrict__ inst_box,
                    const float* __restrict__ inst_w2o, const int32_t* __restrict__ inst_root,
                    int n_inst, const float* __restrict__ origin,
                    const float* __restrict__ direction, const float* __restrict__ t_max,
                    const uint8_t* __restrict__ active, const int64_t* __restrict__ seed_in,
                    Alpha al, int n_rays, int* __restrict__ scratch, int64_t n_slots,
                    float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                    float* __restrict__ out_u, float* __restrict__ out_v,
                    int32_t* __restrict__ out_inst, int64_t* __restrict__ out_seed,
                    int32_t* __restrict__ out_steps) {
  extern __shared__ float smem[];
  __shared__ int sh_stack[kShStack * kThreads];
  const Instances<GLOBAL> it = load_instances<GLOBAL>(smem, inst_box, inst_w2o, inst_root, n_inst);

  const unsigned lanes = __ballot_sync(0xffffffffu, true);
  const int lane = threadIdx.x & 31;
  const int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const Stack st{sh_stack + threadIdx.x, (int)blockDim.x, scratch + kScratchHead + slot, n_slots};
  Trav s;
  s.cur = kTerm;
  Ray w;
  float tmax0 = 0.0f, last_t = kNeg, nt = kInf, t0 = 0.0f;
  int cid = -1, last_id = -1, ibest = 0;
  int64_t ray = -1;
  int deepest = 0;
  bool more = true, live = false;
  while (true) {
    const unsigned idle = __ballot_sync(lanes, ray < 0);
    if (!more && idle == lanes) break;
    const int64_t r = fetch<kRefill>(lanes, idle, lane, scratch, n_rays, more);
    if (r >= 0) {  // a new ray, before its first round
      ray = r;
      w = load_ray(origin, direction, r);
      tmax0 = t_max[r];
      s.t_best = tmax0;
      s.seed = (uint32_t)seed_in[r];
      s.tri = -1;
      s.u = s.v = 0.0f;
      s.steps = 0;
      last_t = kNeg;
      last_id = -1;
      ibest = 0;
      cid = -1;
      live = active == nullptr || active[r];
    }
    if (ray >= 0 && s.cur == kTerm) {  // between two rounds
      if (cid >= 0) {  // the round's tree is done
        if (s.t_best < t0) ibest = cid;  // every accepted hit lowers t_best
        ++s.steps;
        last_t = nt;
        last_id = cid;
        live = !(ANY && s.tri >= 0);  // any hit: the first accepted hit occludes
      }
      cid = live ? next_instance(it, n_inst, w, tmax0, s.t_best, last_t, last_id, nt) : -1;
      if (cid >= 0) {
        // The world origin itself goes into object space: o + d * 0 would
        // make a -0 coordinate +0.
        s.y = instance_ray(it, cid, w.ox, w.oy, w.oz, w);
        s.depth = 0;
        s.cur = it.root_at(cid);
        t0 = s.t_best;
      } else {
        out_t[ray] = s.t_best;
        out_tri[ray] = s.tri;
        out_u[ray] = s.u;
        out_v[ray] = s.v;
        out_inst[ray] = ibest;
        out_seed[ray] = (int64_t)s.seed;
        out_steps[ray] = s.steps;
        ray = -1;
      }
    }
    run_nodes<ANY, ALPHA>(rows, s, st, lim, al, deepest);
  }
  deepest = __reduce_max_sync(lanes, deepest);
  if (lane == 0) atomicMax(scratch + 1, deepest);
}

// The persistent grid's blocks: the rays' blocks of kThreads, at most the
// resident threads n_slots.
inline unsigned grid_blocks(int64_t n_rays, int64_t n_slots) {
  const int64_t need = (n_rays + kThreads - 1) / kThreads;
  return (unsigned)(need < n_slots / kThreads ? need : n_slots / kThreads);
}

// Resident threads of kernel k with `smem` bytes of dynamic shared memory a
// block on the current device, or -1.
template <class K>
int64_t resident(K k, size_t smem) {
  int blocks = 0, dev = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, smem) != cudaSuccess ||
      blocks <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return (int64_t)blocks * sms * kThreads;
}

// The machine instantiation of (any, alpha) for n_inst instances, with its
// dynamic shared memory.
template <bool ANY, bool ALPHA>
auto machine_kernel(int n_inst, size_t& smem)
    -> decltype(&wide_machine_kernel<ANY, ALPHA, false>) {
  if (n_inst > kMaxInstances) {
    smem = 0;
    return &wide_machine_kernel<ANY, ALPHA, true>;
  }
  smem = (size_t)n_inst * kInstWords * sizeof(float);
  return &wide_machine_kernel<ANY, ALPHA, false>;
}

template <bool ANY, bool ALPHA>
int64_t machine_slots(int n_inst) {
  size_t smem = 0;
  const auto k = machine_kernel<ANY, ALPHA>(n_inst, smem);
  return resident(k, smem);
}

struct TreeArgs {
  const float* rows;
  int lim;
  const float *origin, *direction, *t_max;
  const uint8_t* active;
  const int32_t* root0;
  const int64_t* seed;
  Alpha al;
  int n_rays;
  int* scratch;
  int64_t n_slots;
  float* t;
  int32_t* tri;
  float *u, *v;
  int32_t* steps;
  int64_t* seed_out;
  cudaStream_t stream;
};

template <bool ANY, bool ALPHA>
int launch_tree(const TreeArgs& a) {
  wide_kernel<ANY, ALPHA><<<grid_blocks(a.n_rays, a.n_slots), kThreads, 0, a.stream>>>(
      reinterpret_cast<const float4*>(a.rows), a.lim, a.origin, a.direction, a.t_max, a.active,
      a.root0, a.seed, a.al, a.n_rays, a.scratch, a.n_slots, a.t, a.tri, a.u, a.v, a.steps,
      a.seed_out);
  return (int)cudaGetLastError();
}

struct MachineArgs {
  const float* rows;
  int lim;
  const float *box, *w2o;
  const int32_t* root;
  int n_inst;
  const float *origin, *direction, *t_max;
  const uint8_t* active;
  const int64_t* seed;
  Alpha al;
  int n_rays;
  int* scratch;
  int64_t n_slots;
  float* t;
  int32_t* tri;
  float *u, *v;
  int32_t* inst;
  int64_t* seed_out;
  int32_t* steps;
  cudaStream_t stream;
};

template <bool ANY, bool ALPHA>
int launch_machine(const MachineArgs& a) {
  size_t smem = 0;
  const auto k = machine_kernel<ANY, ALPHA>(a.n_inst, smem);
  k<<<grid_blocks(a.n_rays, a.n_slots), kThreads, smem, a.stream>>>(
      reinterpret_cast<const float4*>(a.rows), a.lim, a.box, a.w2o, a.root, a.n_inst, a.origin,
      a.direction, a.t_max, a.active, a.seed, a.al, a.n_rays, a.scratch, a.n_slots, a.t, a.tri,
      a.u, a.v, a.inst, a.seed_out, a.steps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Resident threads (the persistent grid) on the current device of the tree
// entry (machine 0) or of the machine for n_inst instances (machine 1), for
// closest hit (any_hit 0) or any hit (1), without (alpha 0) or with (1) an
// alpha pack; -1 where the occupancy query fails.
int64_t vkrt_wide_slots(int machine, int any_hit, int alpha, int n_inst) {
  if (machine && any_hit) return alpha ? machine_slots<true, true>(n_inst)
                                       : machine_slots<true, false>(n_inst);
  if (machine) return alpha ? machine_slots<false, true>(n_inst)
                            : machine_slots<false, false>(n_inst);
  if (any_hit) return alpha ? resident(&wide_kernel<true, true>, 0)
                            : resident(&wide_kernel<true, false>, 0);
  return alpha ? resident(&wide_kernel<false, true>, 0) : resident(&wide_kernel<false, false>, 0);
}

// int32 words of either entry's scratch for a tree with this stack bound and
// n_slots resident threads: the head, then the stack entries past the shared
// ones, a column per thread.
int64_t vkrt_wide_words(int stack_depth, int64_t n_slots) {
  const int deep = stack_depth > kShStack ? stack_depth - kShStack : 0;
  return kScratchHead + (int64_t)deep * n_slots;
}

// Closest hit with culling (any_hit 0) or any hit without (any_hit 1) over
// 8-wide rows on n_rays rays (< 2^31), persistent warps on min(n_slots, rays)
// threads (vkrt_wide_slots). `active` (u8), `root0` (i32 interior rows) and
// `seed_in` (uint32 values in int64) may be null; `pack` null: no alpha test
// (every alpha-flagged triangle counts as opaque and nothing is drawn).
// scratch: vkrt_wide_words(stack_depth, n_slots) int32 words; this entry
// zeroes its head on the stream, and the kernel leaves the deepest stack any
// ray reached in scratch[1]. Returns the first CUDA error (invalid value for
// a stack bound past kMaxStack, which the wrapper refuses first).
int vkrt_traverse_wide(int any_hit, const float* rows, int stack_depth, const float* origin,
                       const float* direction, const float* t_max, const uint8_t* active,
                       const int32_t* root0, const int64_t* seed_in, const float* pack,
                       int64_t n_pack, const uint8_t* plane, int64_t n_plane, int64_t atlas_w,
                       int64_t n_rays, int* scratch, int64_t scratch_words, int64_t n_slots,
                       float* out_t, int32_t* out_tri, float* out_u, float* out_v,
                       int32_t* out_steps, int64_t* out_seed, cudaStream_t stream) {
  if (stack_depth < 1 || stack_depth > kMaxStack || n_rays < 0 || n_rays >= ((int64_t)1 << 31) ||
      n_slots < kThreads || scratch_words < vkrt_wide_words(stack_depth, n_slots) ||
      (pack != nullptr && (n_pack < 1 || n_plane < 1)))
    return cudaErrorInvalidValue;
  if (n_rays == 0) return cudaSuccess;
  const cudaError_t err = cudaMemsetAsync(scratch, 0, kScratchHead * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const TreeArgs a{rows, stack_depth, origin, direction, t_max, active, root0, seed_in,
                   Alpha{pack, n_pack, plane, n_plane, atlas_w}, (int)n_rays, scratch, n_slots,
                   out_t, out_tri, out_u, out_v, out_steps, out_seed, stream};
  if (any_hit) return pack ? launch_tree<true, true>(a) : launch_tree<true, false>(a);
  return pack ? launch_tree<false, true>(a) : launch_tree<false, false>(a);
}

// The two-level wide rounds over n_rays world rays (< 2^31), each to its last
// instance: closest hit with culling (any_hit 0) or any hit without (1).
// rows: the 8-wide BLAS table with its stack bound; per instance (in shared
// memory up to kMaxInstances, read from global memory above): inst_box (I, 6)
// the world box (min, max), inst_w2o (I, 3, 4) world to object, inst_root
// (I,) the mesh's BLAS root row, -1 outside the pass's mask; active may be
// null; seed (n_rays,) uint32 values in int64; pack null: no alpha test.
// Persistent warps on min(n_slots, rays) threads (vkrt_wide_slots with
// machine 1 and this n_inst); scratch as vkrt_traverse_wide's. Outputs per
// ray: t (t_max where nothing was hit), tri (-1 then), u, v, inst, seed,
// steps (nodes + 1 a round). Returns the first CUDA error.
int vkrt_wide_machine(int any_hit, const float* rows, int stack_depth, const float* inst_box,
                      const float* inst_w2o, const int32_t* inst_root, int n_inst,
                      const float* origin, const float* direction, const float* t_max,
                      const uint8_t* active, const int64_t* seed, const float* pack,
                      int64_t n_pack, const uint8_t* plane, int64_t n_plane, int64_t atlas_w,
                      int64_t n_rays, int* scratch, int64_t scratch_words, int64_t n_slots,
                      float* out_t, int32_t* out_tri, float* out_u, float* out_v,
                      int32_t* out_inst, int64_t* out_seed, int32_t* out_steps,
                      cudaStream_t stream) {
  if (stack_depth < 1 || stack_depth > kMaxStack || n_inst < 0 || n_rays < 0 ||
      n_rays >= ((int64_t)1 << 31) || n_slots < kThreads || seed == nullptr ||
      scratch_words < vkrt_wide_words(stack_depth, n_slots) ||
      (pack != nullptr && (n_pack < 1 || n_plane < 1)))
    return cudaErrorInvalidValue;
  if (n_rays == 0) return cudaSuccess;
  const cudaError_t err = cudaMemsetAsync(scratch, 0, kScratchHead * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const MachineArgs a{rows, stack_depth, inst_box, inst_w2o, inst_root, n_inst, origin,
                      direction, t_max, active, seed, Alpha{pack, n_pack, plane, n_plane, atlas_w},
                      (int)n_rays, scratch, n_slots, out_t, out_tri, out_u, out_v, out_inst,
                      out_seed, out_steps, stream};
  if (any_hit) return pack ? launch_machine<true, true>(a) : launch_machine<true, false>(a);
  return pack ? launch_machine<false, true>(a) : launch_machine<false, false>(a);
}

}  // extern "C"
