// What the traversal sources of both back ends share, included by traverse.cu
// (planar rows) and traverse_wide.cu (8-wide rows): the ray with its guarded
// reciprocal direction, its load and the slab test; the persistent warps'
// stack and ray fetch (vkrt_traverse_ab, and both wide entries); and the
// instance table with the
// candidate enumeration and the ray transform of ops/tlas.py, which the
// two-level machines of both back ends (vkrt_opaque_machine,
// vkrt_alpha_machine, vkrt_wide_machine) run, in the plain versions' order of
// float32 operations.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 1e32f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// 1/c with |c| < 1e-20 clamped to +-1e-20 (tf.inv_dir, traverse_wide._inv_dir).
__device__ __forceinline__ float guard_inv(float c) {
  const float g = fabsf(c) < 1e-20f ? (c < 0.0f ? -1e-20f : 1e-20f) : c;
  return __fdiv_rn(1.0f, g);
}

// The guarded reciprocal of a ray's direction.
__device__ __forceinline__ void set_inverse(Ray& y) {
  y.ix = guard_inv(y.dx);
  y.iy = guard_inv(y.dy);
  y.iz = guard_inv(y.dz);
}

// Ray r of the (R, 3) origin and direction arrays, with its inverse.
__device__ __forceinline__ Ray load_ray(const float* origin, const float* direction, int64_t r) {
  Ray y;
  y.ox = origin[3 * r];
  y.oy = origin[3 * r + 1];
  y.oz = origin[3 * r + 2];
  y.dx = direction[3 * r];
  y.dy = direction[3 * r + 1];
  y.dz = direction[3 * r + 2];
  set_inverse(y);
  return y;
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

// ---- the persistent warps' stack --------------------------------------------
// Entries [0, kShStack) of each thread in shared memory, laid out by thread
// (entry d of thread t at d * blockDim.x + t, so the lanes of a warp hit 32
// banks); deeper ones in the thread's column of a global spill that the
// wrapper allocates, exact up to the tree's stack bound. (A build may set
// fewer shared entries, to run the spill on shallow trees: the host-C++
// tests.)
#ifndef VKRT_SHARED_STACK
#define VKRT_SHARED_STACK 16
#endif
constexpr int kShStack = VKRT_SHARED_STACK;
// Scratch words before the spill: the ray counter, the deepest stack
// reached, two spare (keeps the spill 16-byte aligned).
constexpr int kScratchHead = 4;

// One thread's stack: `sh` its first shared entry (stride blockDim.x),
// `spill` its first spill entry (stride n_slots).
struct Stack {
  int* sh;
  int stride;
  int* spill;
  int64_t n_slots;

  __device__ __forceinline__ void put(int d, int v) const {
    if (d < kShStack) sh[d * stride] = v;
    else spill[(int64_t)(d - kShStack) * n_slots] = v;
  }
  __device__ __forceinline__ int get(int d) const {
    return d < kShStack ? sh[d * stride] : spill[(int64_t)(d - kShStack) * n_slots];
  }
};

// The warp's ray fetch: where every lane is idle, or REFILL are, one
// atomicAdd on the counter (scratch[0]) for all idle lanes. Returns the ray
// this lane takes (-1: none) and clears `more` once the counter passes the
// last ray (the same in every lane).
template <int REFILL>
__device__ __forceinline__ int64_t fetch(unsigned lanes, unsigned idle, int lane, int* scratch,
                                         int n_rays, bool& more) {
  if (!more || !(idle == lanes || __popc(idle) >= REFILL)) return -1;
  int base = 0;
  if (lane == 0) base = atomicAdd(scratch, __popc(idle));
  base = __shfl_sync(lanes, base, 0);
  more = (int64_t)base + __popc(idle) < n_rays;
  const int64_t r = (int64_t)base + __popc(idle & ((1u << lane) - 1u));
  return ((idle >> lane) & 1u) && r < n_rays ? r : -1;
}

// ---- the instance table -------------------------------------------------------
// tlas._DENSE_I_MAX: the largest table held in shared memory (38,912 B).
constexpr int kMaxInstances = 512;
constexpr int kInstWords = 19;    // box 6, world_to_object 12, root 1
constexpr float kNeg = -3.0e38f;  // tlas._NEG: before every entry t

// The instance table: (I, 6) world boxes (min xyz, max xyz), (I, 12)
// world-to-object rows, (I,) BLAS roots (-1: outside the pass's instance
// mask); in shared memory, or (GLOBAL) the caller's global tables, read-only.
template <bool GLOBAL>
struct Instances {
  const float* box;
  const float* m;
  const int* root;
  __device__ __forceinline__ float box_at(int k) const {
    return GLOBAL ? __ldg(box + k) : box[k];
  }
  __device__ __forceinline__ float m_at(int k) const { return GLOBAL ? __ldg(m + k) : m[k]; }
  __device__ __forceinline__ int root_at(int i) const {
    return GLOBAL ? __ldg(root + i) : root[i];
  }
};

// The shared table: every thread of the block copies its share, then waits
// for the rest (call before any thread of the block returns). GLOBAL: the
// global tables themselves, nothing copied.
template <bool GLOBAL>
__device__ __forceinline__ Instances<GLOBAL> load_instances(float* smem,
                                                            const float* __restrict__ inst_box,
                                                            const float* __restrict__ inst_w2o,
                                                            const int32_t* __restrict__ inst_root,
                                                            int n_inst) {
  if (GLOBAL) return Instances<GLOBAL>{inst_box, inst_w2o, inst_root};
  float* s_box = smem;
  float* s_m = smem + 6 * n_inst;
  int* s_root = reinterpret_cast<int*>(smem + 18 * n_inst);
  for (int k = threadIdx.x; k < 6 * n_inst; k += blockDim.x) s_box[k] = inst_box[k];
  for (int k = threadIdx.x; k < 12 * n_inst; k += blockDim.x) s_m[k] = inst_w2o[k];
  for (int k = threadIdx.x; k < n_inst; k += blockDim.x) s_root[k] = inst_root[k];
  __syncthreads();
  return Instances<GLOBAL>{s_box, s_m, s_root};
}

// The next instance after (last_t, last_id) in (entry t, id) order among
// those whose box the world ray enters before both its window end tmax0 and
// its best hit t_best: tlas._instance_slab's slab test and
// tlas._next_candidate's argmin (ties to the lowest id). Instances outside
// the mask have root -1. Returns the id (-1: none) and its entry t.
template <bool GLOBAL>
__device__ __forceinline__ int next_instance(const Instances<GLOBAL>& it, int n_inst,
                                             const Ray& w, float tmax0, float t_best,
                                             float last_t, int last_id, float& nt) {
  float best = kInf;
  int id = -1;
  for (int i = 0; i < n_inst; ++i) {
    if (it.root_at(i) < 0) continue;
    const int b = 6 * i;
    float tn, tf;
    slab(w, it.box_at(b), it.box_at(b + 1), it.box_at(b + 2), it.box_at(b + 3), it.box_at(b + 4),
         it.box_at(b + 5), tn, tf);
    const bool hit = (tn <= tf) && (tf >= 0.0f) && (tn < tmax0) && (tn < t_best);
    const bool after = (tn > last_t) || (tn == last_t && i > last_id);
    if (hit && after && tn < best) {
      best = tn;
      id = i;
    }
  }
  nt = best;
  return id;
}

// tlas._transform_rays for one ray: the point (px, py, pz) and the world
// direction of w into the object space of the world-to-object rows m (3x4),
// the direction not renormalised, in mat3_vec's order ((m0 x + m1 y) + m2 z,
// then + m3).
__device__ __forceinline__ Ray to_object(const float* m, float px, float py, float pz,
                                         const Ray& w) {
  Ray y;
  y.ox = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], px), __fmul_rn(m[1], py)),
                             __fmul_rn(m[2], pz)), m[3]);
  y.oy = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[4], px), __fmul_rn(m[5], py)),
                             __fmul_rn(m[6], pz)), m[7]);
  y.oz = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[8], px), __fmul_rn(m[9], py)),
                             __fmul_rn(m[10], pz)), m[11]);
  y.dx = __fadd_rn(__fadd_rn(__fmul_rn(m[0], w.dx), __fmul_rn(m[1], w.dy)), __fmul_rn(m[2], w.dz));
  y.dy = __fadd_rn(__fadd_rn(__fmul_rn(m[4], w.dx), __fmul_rn(m[5], w.dy)), __fmul_rn(m[6], w.dz));
  y.dz = __fadd_rn(__fadd_rn(__fmul_rn(m[8], w.dx), __fmul_rn(m[9], w.dy)),
                   __fmul_rn(m[10], w.dz));
  set_inverse(y);
  return y;
}

// to_object with instance cid's world-to-object rows.
template <bool GLOBAL>
__device__ __forceinline__ Ray instance_ray(const Instances<GLOBAL>& it, int cid, float px,
                                            float py, float pz, const Ray& w) {
  float m[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) m[k] = it.m_at(12 * cid + k);
  return to_object(m, px, py, pz, w);
}

}  // namespace
