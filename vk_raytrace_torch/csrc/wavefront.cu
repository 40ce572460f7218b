// The pooled wavefront's own bookkeeping, two entries over the lane pool
// (vk_raytrace_torch/integrator/wavefront.py, render_units_pooled):
//
// * vkrt_regenerate replaces the XLA body `regenerate` of the reference's
//   pooled loop (vk_raytrace_tpu/integrator/wavefront.py:158-196) with the
//   camera it calls (integrator/camera.py::generate_rays_for_pixels) and the
//   TEA seed (ops/rng.py::tea). Every dead lane takes its exclusive rank
//   among the dead lanes; rank r claims unit next_unit + r while units
//   remain, maps it to its pixel through the 8x8 tile swizzle, seeds its
//   stream with tea(pixel, stream * spp + sample), shoots the jittered
//   (frame 0: centred) thin-lens camera ray and resets the lane's eleven
//   fields. next_unit advances by min(dead, remaining) on the device, and
//   with an occupancy record the lanes active after regeneration go to
//   occ[min(it, 1023)].
// * vkrt_retire replaces the bounce epilogue after the shadow ray
//   (reference :404-472): the unoccluded NEE add, the Russian-roulette draw
//   and gate, the depth gate, the firefly clamp and the scatter of each
//   retired path's radiance into out[unit] (a unit dies once, so each
//   target is written by one lane), the throughput / seed / depth /
//   bsdf_pdf / active updates, the frame's ray count (active rays plus
//   visible shadow rays), the live count that the host's loop control reads,
//   and with a step record an integer atomic add of each active lane's
//   closest-hit steps into its slice-local pixel (reference :441-444).
//   Origin, direction, absorption and the path length come whole from the
//   shading stage and are not rewritten here.
//
// The loop control lives on the device in ctrl = {next_unit, live, rays}
// (int64): vkrt_regenerate reads and advances next_unit and clears live,
// vkrt_retire adds to live and rays, and the host reads the three once an
// iteration.
//
// What bounds them on this card: device memory. A regenerated lane writes
// ~100 bytes (pix, unit and seed and depth as int64, five float3s, two
// floats, the flag) against ~150 integer and ~60 float operations; a retired
// lane reads ~90 bytes and writes ~50. Every access is per lane and
// coalesced, one thread a lane. The only part that crosses blocks is the
// exclusive scan over the dead flags, a single-pass scan with decoupled
// look-back in the one launch (Merrill and Garland): each block counts its
// chunk's dead lanes with warp ballots, publishes the count, then reads its
// predecessors' published counts or prefixes with one warp, 32 at a time,
// until it meets a prefix, and publishes its own. Integer sums are
// order-free, so the ranks, the counts and the step record are
// deterministic. The scan is in the one launch because a separate
// one-block count pass is latency-bound on one SM (39-41 us of a 59 us
// call in a 1080p atrium frame, chip_profile.py, NVIDIA H100 80GB HBM3,
// 700.00 W).
//
// Numerics follow the plain torch versions (wavefront._regenerate_plain,
// _retire_plain) operation by operation as torch computes them on the card:
// -fmad=false, IEEE division and square root, libdevice cosf / sinf, TEA and
// PCG in uint32 (the plain version's int64 arithmetic masked to 32 bits
// gives the same low bits), x / w for a Python int w as x * (1.0f / w), a
// Python number over a tensor as reciprocal then product, NaN-propagating
// clamps, and the camera's normalise summing the squares as torch's sum over
// a last axis of three does on the card: its reduction splits the axis over
// two threads, (x^2 + z^2) + y^2. VKRT_TORCH_CPU=1 takes torch's order on
// the CPU instead, (x^2 + y^2) + z^2 and x / w divided, for the source built
// as host C++ (tests/test_torch_wavefront.py).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef VKRT_REGEN_CHUNK
#define VKRT_REGEN_CHUNK 256  // lanes a chunk of the scan, and threads an apply block
#endif
#ifndef VKRT_TORCH_CPU
#define VKRT_TORCH_CPU 0
#endif

// One regeneration; the field order is wavefront._RegenArgs's.
struct RegenArgs {
  // the pool's state, (n,) or (n, 3); written where a lane is granted
  int64_t* pix;
  int64_t* unit;
  float* origin;
  float* direction;
  float* radiance;
  float* throughput;
  float* absorption;
  int64_t* seed;
  int64_t* depth;
  float* bsdf_pdf;
  float* tdist;
  uint8_t* active;
  int64_t* ctrl;      // {next_unit, live, rays}
  int32_t* occ;       // (1024,) or null
  int64_t* scratch;   // vkrt_regenerate_scratch_words(n): the scan's ticket, epoch and statuses
  const float* camera;  // view_inverse (4, 4), proj_inverse (4, 4), focal_dist, aperture
  int64_t n, total_units, spp, pix0, stream, width, height, tiles_x;
  int32_t tiled, frame0, it;
};

// One retirement; the field order is wavefront._RetireArgs's.
struct RetireArgs {
  // the bounce's values, (n,) or (n, 3)
  const uint8_t* alive;
  const uint8_t* visible;
  const uint8_t* occluded;
  const float* radiance;
  const float* throughput;
  const float* nee;
  const float* rr_pcont;
  const float* pdf_b;
  const int64_t* seed;
  const int32_t* hit_steps;  // null without a step record
  // the pool's state: read, and written in place
  uint8_t* active;
  const int64_t* pix;
  const int64_t* unit;
  float* st_radiance;
  float* st_throughput;
  int64_t* st_seed;
  int64_t* depth;
  float* bsdf_pdf;
  float* out;        // (total_units + n, 3): a retired path's radiance at out[unit]
  int32_t* steps;    // (n_pix + 1,) or null
  int64_t* ctrl;
  int64_t n, pix0, rr_depth, max_depth;
  float clamp;
  int32_t rr;
};

namespace {

constexpr int kChunk = VKRT_REGEN_CHUNK;

__device__ __forceinline__ uint32_t pcg_step(uint32_t& state) {
  const uint32_t prev = state * 747796405u + 2891336453u;
  const uint32_t shift = (prev >> 28) + 4u;
  const uint32_t word = ((prev >> shift) ^ prev) * 277803737u;
  state = prev;
  return (word >> 22) ^ word;
}

// rng.rand: one uniform in [0, 1), (bits >> 9) * 2^-23.
__device__ __forceinline__ float rand01(uint32_t& state) {
  return __fmul_rn((float)(pcg_step(state) >> 9), 1.0f / 8388608.0f);
}

__device__ __forceinline__ uint32_t tea(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0;
  for (int i = 0; i < 16; ++i) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : (x < lo ? lo : x); }

// x / w for a Python int w.
__device__ __forceinline__ float div_int(float x, int64_t w) {
#if VKRT_TORCH_CPU
  return __fdiv_rn(x, (float)w);
#else
  return __fmul_rn(x, __fdiv_rn(1.0f, (float)w));
#endif
}

// ops/math.normalize: v / sqrt(sum(v * v, -1)), the sum in torch's order on the card.
__device__ __forceinline__ void normalize(float& x, float& y, float& z) {
  const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y), zz = __fmul_rn(z, z);
#if VKRT_TORCH_CPU
  const float s = __fadd_rn(__fadd_rn(xx, yy), zz);
#else
  const float s = __fadd_rn(__fadd_rn(xx, zz), yy);
#endif
  const float l = sqrtf(s);
  x = __fdiv_rn(x, l);
  y = __fdiv_rn(y, l);
  z = __fdiv_rn(z, l);
}

// The scan's scratch, int64 words kept per device and stream by the wrapper
// (zeroed once when made, never reset): [0] the ticket counter (its low 32
// bits), [1] the launch's epoch, [kRegenHead + c] chunk c's status,
// epoch << 32 | flag << 30 | value, the value the chunk's dead lanes
// (kAggregate) or the dead lanes of chunks 0..c (kPrefix). A status of
// another epoch is a status not yet written in this launch.
constexpr int kRegenHead = 2;
constexpr unsigned kAggregate = 1, kPrefix = 2;
constexpr uint64_t kValueMask = (1ull << 30) - 1;

__device__ __forceinline__ uint64_t load_volatile(const int64_t* p) {
  return *reinterpret_cast<const volatile uint64_t*>(p);
}
__device__ __forceinline__ void store_volatile(int64_t* p, uint64_t v) {
  *reinterpret_cast<volatile uint64_t*>(p) = v;
}
__device__ __forceinline__ uint64_t status_word(uint32_t epoch, unsigned flag, int64_t value) {
  return ((uint64_t)epoch << 32) | ((uint64_t)flag << 30) | (uint64_t)value;
}

// The decoupled look-back of chunk c > 0 by the first `nl` lanes of a warp:
// the dead lanes of chunks 0..c-1. Each pass reads the statuses of the nl
// chunks below `top` (lane 0 the nearest), each lane waiting until its
// chunk has published in this epoch; the nearest prefix ends the walk,
// else the nl aggregates are added and the window moves down. A chunk
// below 0 reads as a prefix of 0. The sum fits 32 bits: at most one prefix
// (< 2^30) and nl - 1 aggregates (each at most kChunk).
__device__ int64_t look_back(const int64_t* status, int64_t c, uint32_t epoch, int lane,
                             int nl) {
  const unsigned lanes = nl == 32 ? 0xffffffffu : (1u << nl) - 1u;
  int64_t exclusive = 0;
  for (int64_t top = c - 1;; top -= nl) {
    const int64_t k = top - lane;
    uint64_t s = status_word(epoch, kPrefix, 0);
    if (k >= 0) {
      do {
        s = load_volatile(status + k);
      } while ((uint32_t)(s >> 32) != epoch || ((s >> 30) & 3u) == 0);
    }
    const unsigned prefix = __ballot_sync(lanes, ((s >> 30) & 3u) == kPrefix);
    const unsigned low = prefix & (0u - prefix);  // the nearest prefix's lane
    const unsigned upto = prefix ? (low << 1) - 1u : 0xffffffffu;
    const unsigned v = (upto >> lane) & 1u ? (unsigned)(s & kValueMask) : 0u;
    exclusive += __reduce_add_sync(lanes, v);
    if (prefix) return exclusive;
  }
}

// One block a chunk of kChunk lanes, one thread a lane, in one launch: the
// block takes its chunk from a ticket (the order blocks start in, so a block
// only ever waits on chunks whose blocks run), counts the chunk's dead lanes
// with warp ballots, publishes the count, finds the dead lanes below the
// chunk by the look-back, publishes its prefix and ranks its lanes. The
// last chunk's block writes the grant once the look-back has seen every
// chunk publish; each block reads next_unit before it publishes, so none
// reads it after the grant.
__global__ void __launch_bounds__(kChunk) regenerate_kernel(RegenArgs a) {
  __shared__ int s_warp[(kChunk + 31) / 32];
  __shared__ int64_t s_chunk, s_next, s_below;
  __shared__ uint32_t s_epoch;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  const int64_t nb = (a.n + kChunk - 1) / kChunk;
  int64_t* status = a.scratch + kRegenHead;
  if (threadIdx.x == 0) {
    // Tickets 0..nb-1; the last one takes the counter back to 0 for the next launch.
    s_chunk = atomicInc(reinterpret_cast<unsigned*>(a.scratch), (unsigned)(nb - 1));
    s_epoch = (uint32_t)load_volatile(a.scratch + 1);
    s_next = (int64_t)load_volatile(a.ctrl);
  }
  __syncthreads();
  const int64_t c = s_chunk;
  const uint32_t epoch = s_epoch;
  const int64_t i = c * kChunk + threadIdx.x;
  const bool dead = i < a.n && !a.active[i];
  const unsigned ballot = __ballot_sync(0xffffffffu, dead);
  const unsigned below = lane == 0 ? 0u : ballot & (0xffffffffu >> (32 - lane));
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, count = 0;
  for (int w = 0; w < n_warps; ++w) {
    before += w < warp ? s_warp[w] : 0;
    count += s_warp[w];
  }
  if (warp == 0) {
    if (lane == 0) {
      __threadfence();  // next_unit and the epoch are read before the chunk publishes
      store_volatile(status + c, status_word(epoch, c == 0 ? kPrefix : kAggregate, count));
    }
    const int64_t ex = c == 0 ? 0 : look_back(status, c, epoch, lane,
                                              blockDim.x < 32 ? (int)blockDim.x : 32);
    if (lane == 0) {
      if (c > 0) store_volatile(status + c, status_word(epoch, kPrefix, ex + count));
      s_below = ex;
    }
  }
  __syncthreads();
  const int64_t next = s_next;
  if (c == nb - 1 && threadIdx.x == 0) {
    // Every chunk has published, so every block has read next_unit.
    const int64_t n_dead = s_below + count;
    const int64_t remaining = a.total_units - next;
    const int64_t granted = n_dead < remaining ? n_dead : remaining;
    __threadfence();
    a.ctrl[0] = next + granted;
    a.ctrl[1] = 0;
    if (a.occ != nullptr) a.occ[a.it < 1023 ? a.it : 1023] = (int32_t)(a.n - n_dead + granted);
    store_volatile(a.scratch + 1, (uint64_t)(epoch + 1u));
  }
  if (!dead) return;
  const int64_t rank = s_below + before + __popc(below);
  const int64_t unit = next + rank;
  if (unit >= a.total_units) return;

  // The unit's pixel: its rank's place in the 8x8 tiles, or its rank.
  const int64_t p_rank = unit / a.spp;
  int64_t local = p_rank;
  if (a.tiled) {
    const int64_t t_id = p_rank / 64, w_in = p_rank % 64;
    const int64_t lx = (t_id % a.tiles_x) * 8 + (w_in % 8);
    const int64_t ly = (t_id / a.tiles_x) * 8 + (w_in / 8);
    local = ly * a.width + lx;
  }
  const int64_t pix = a.pix0 + local;
  const int64_t sample = unit % a.spp;
  uint32_t seed = tea((uint32_t)pix, (uint32_t)(a.stream * a.spp + sample));

  // camera.generate_rays_for_pixels: the jitter (two draws, frame 0 centred).
  const float* vi = a.camera;
  const float* pinv = a.camera + 16;
  const float focal = a.camera[32], aperture = a.camera[33];
  const float jx = rand01(seed), jy = rand01(seed);
  const float jit_x = a.frame0 ? 0.5f : jx, jit_y = a.frame0 ? 0.5f : jy;
  const float px = (float)(pix % a.width), py = (float)(pix / a.width);
  const float u = __fadd_rn(__fmul_rn(div_int(__fadd_rn(px, jit_x), a.width), 2.0f), -1.0f);
  const float v = __fadd_rn(__fmul_rn(div_int(__fadd_rn(py, jit_y), a.height), 2.0f), -1.0f);
  float t[3];
  for (int k = 0; k < 3; ++k) {
    const float* row = pinv + 4 * k;
    t[k] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(row[0], u), __fmul_rn(row[1], v)),
                               __fmul_rn(row[2], 1.0f)), __fmul_rn(row[3], 1.0f));
  }
  normalize(t[0], t[1], t[2]);
  float dir[3];
  for (int k = 0; k < 3; ++k) {
    const float* row = vi + 4 * k;
    dir[k] = __fadd_rn(__fadd_rn(__fmul_rn(row[0], t[0]), __fmul_rn(row[1], t[1])),
                       __fmul_rn(row[2], t[2]));
  }
  // The thin lens: two more draws.
  const float r1 = rand01(seed), r2 = rand01(seed);
  const float ang = __fmul_rn(r1, 6.283185307179586f);
  const float rad = __fmul_rn(r2, aperture);
  const float ca = cosf(ang), sa = sinf(ang), sr = sqrtf(rad);
  float o[3], d[3];
  for (int k = 0; k < 3; ++k) {
    const float ap = __fmul_rn(__fadd_rn(__fmul_rn(ca, vi[4 * k + 0]), __fmul_rn(sa, vi[4 * k + 1])),
                               sr);
    d[k] = __fsub_rn(__fmul_rn(focal, dir[k]), ap);
    o[k] = __fadd_rn(vi[4 * k + 3], ap);
  }
  normalize(d[0], d[1], d[2]);

  a.pix[i] = pix;
  a.unit[i] = unit;
  for (int k = 0; k < 3; ++k) {
    a.origin[3 * i + k] = o[k];
    a.direction[3 * i + k] = d[k];
    a.radiance[3 * i + k] = 0.0f;
    a.throughput[3 * i + k] = 1.0f;
    a.absorption[3 * i + k] = 0.0f;
  }
  a.seed[i] = (int64_t)seed;
  a.depth[i] = 0;
  a.bsdf_pdf[i] = 0.0f;
  a.tdist[i] = 0.0f;
  a.active[i] = 1;
}

__global__ void __launch_bounds__(256) retire_kernel(RetireArgs a) {
  __shared__ unsigned s_rays[8], s_live[8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned rays = 0, live = 0;
  if (i < a.n) {
    const bool active = a.active[i], visible = a.visible[i];
    bool alive = a.alive[i];
    const int64_t depth0 = a.depth[i];
    const bool rr_gate = a.rr && depth0 >= a.rr_depth;
    const float pcont = rr_gate ? a.rr_pcont[i] : 1.0f;
    // The unoccluded shadow ray's light.
    const bool lit = visible && !a.occluded[i];
    float rad[3];
    for (int k = 0; k < 3; ++k) rad[k] = __fadd_rn(a.radiance[3 * i + k], lit ? a.nee[3 * i + k] : 0.0f);
    // Russian roulette.
    uint32_t seed = (uint32_t)a.seed[i];
    const float u_rr = rand01(seed);
    float thr[3] = {a.throughput[3 * i], a.throughput[3 * i + 1], a.throughput[3 * i + 2]};
    if (a.rr) {
      alive = alive && !(rr_gate && u_rr >= pcont);
      if (alive) {
        const float q = clamp_min(pcont, 1e-9f);
        for (int k = 0; k < 3; ++k) thr[k] = __fdiv_rn(thr[k], q);
      }
    }
    const int64_t depth = depth0 + (active ? 1 : 0);
    alive = alive && depth < a.max_depth;
    if (active && !alive) {
      // The firefly clamp, then the path's radiance into its unit.
      const float lum = __fadd_rn(__fadd_rn(__fmul_rn(0.212671f, rad[0]), __fmul_rn(0.715160f, rad[1])),
                                  __fmul_rn(0.072169f, rad[2]));
      const float scale = lum > a.clamp ? __fmul_rn(__fdiv_rn(1.0f, clamp_min(lum, 1e-20f)), a.clamp)
                                        : 1.0f;
      const int64_t unit = a.unit[i];
      for (int k = 0; k < 3; ++k) a.out[3 * unit + k] = __fmul_rn(rad[k], scale);
    }
    if (a.steps != nullptr && active) atomicAdd(&a.steps[a.pix[i] - a.pix0], a.hit_steps[i]);
    for (int k = 0; k < 3; ++k) {
      a.st_radiance[3 * i + k] = rad[k];
      a.st_throughput[3 * i + k] = thr[k];
    }
    a.st_seed[i] = (int64_t)seed;
    a.depth[i] = depth;
    if (alive) a.bsdf_pdf[i] = a.pdf_b[i];
    a.active[i] = alive;
    rays = (active ? 1u : 0u) + (visible ? 1u : 0u);
    live = alive ? 1u : 0u;
  }
  rays = __reduce_add_sync(0xffffffffu, rays);
  live = __reduce_add_sync(0xffffffffu, live);
  if (lane == 0) {
    s_rays[warp] = rays;
    s_live[warp] = live;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long r = 0, l = 0;
    for (int w = 0; w < (int)((blockDim.x + 31) >> 5); ++w) {
      r += s_rays[w];
      l += s_live[w];
    }
    if (r) atomicAdd(reinterpret_cast<unsigned long long*>(&a.ctrl[2]), r);
    if (l) atomicAdd(reinterpret_cast<unsigned long long*>(&a.ctrl[1]), l);
  }
}

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch; vkrt_regenerate refuses a
// pool of 2^30 lanes or more (a chunk's status holds its count in 30 bits).
int vkrt_regenerate(const RegenArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  if (a->n > (int64_t)kValueMask) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int64_t blocks = (a->n + kChunk - 1) / kChunk;
  regenerate_kernel<<<(unsigned)blocks, kChunk, 0, s>>>(*a);
  return (int)cudaGetLastError();
}

int vkrt_retire(const RetireArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int64_t blocks = (a->n + 255) / 256;
  retire_kernel<<<(unsigned)blocks, 256, 0, s>>>(*a);
  return (int)cudaGetLastError();
}

int vkrt_regenerate_args_size() { return (int)sizeof(RegenArgs); }
int vkrt_retire_args_size() { return (int)sizeof(RetireArgs); }
// int64 words of vkrt_regenerate's scratch for a pool of n lanes.
int64_t vkrt_regenerate_scratch_words(int64_t n) { return kRegenHead + (n + kChunk - 1) / kChunk; }

}  // extern "C"
