// Native host builders of the port (ctypes, built by runtime.py with g++).
//
// The port's own copy of the host loops it needs from the reference's native
// runtime, trimmed to what vk_raytrace_torch/runtime.py binds:
//   oct_encode_batch  octahedral unit-vector compression (compress.glsl)
//   smooth_normals    area-weighted vertex normals
//   pack_rgba8        RGBA8 vertex-colour packing
//   build_bvh16       binned-SAH build of 16-wide planar 512-byte rows
//   build_bvh32       the same at width 32: 1024-byte rows
//   png_unfilter      PNG scanline reconstruction (filters 0-4), for the
//                     port's PNG decoder (utils/png.py)
// The tables they produce must stay byte-identical to the reference's
// (tests/test_torch_scene.py).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Octahedral unit-vector compression (compress.glsl:111-139 semantics):
// 2x16-bit snorm, lower-hemisphere fold in integer space, round-half-even.
// ---------------------------------------------------------------------------
static inline int32_t round_even_i(float x) {
  return static_cast<int32_t>(std::nearbyintf(x));  // FE_TONEAREST = half-even
}

void oct_encode_batch(const float* vecs /* n*3 */, int64_t n, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float vx = vecs[i * 3 + 0];
    const float vy = vecs[i * 3 + 1];
    const float vz = vecs[i * 3 + 2];
    const float d = 32767.0f / (std::fabs(vx) + std::fabs(vy) + std::fabs(vz));
    int32_t x = round_even_i(vx * d);
    int32_t y = round_even_i(vy * d);
    if (vz < 0.0f) {
      const int32_t maskx = x >> 31;
      const int32_t masky = y >> 31;
      const int32_t tmp = 32767 + maskx + masky;
      const int32_t tmpx = x;
      x = (tmp - (y ^ masky)) ^ maskx;
      y = (tmp - (tmpx ^ maskx)) ^ masky;
    }
    uint32_t packed =
        (uint32_t(y + 32767) << 16) | uint32_t(x + 32767);
    if (packed == 0xFFFFFFFFu) packed = 0xFFFFFFFEu;
    out[i] = packed;
  }
}

// ---------------------------------------------------------------------------
// Area-weighted smooth vertex normals (nvh::GltfScene-style import helper).
// ---------------------------------------------------------------------------
void smooth_normals(const double* pos /* nv*3 */, int64_t nv,
                    const int64_t* idx /* nt*3 */, int64_t nt,
                    double* out /* nv*3 */) {
  std::memset(out, 0, sizeof(double) * size_t(nv) * 3);
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t a = idx[t * 3], b = idx[t * 3 + 1], c = idx[t * 3 + 2];
    const double* pa = pos + a * 3;
    const double* pb = pos + b * 3;
    const double* pc = pos + c * 3;
    const double e1x = pb[0] - pa[0], e1y = pb[1] - pa[1], e1z = pb[2] - pa[2];
    const double e2x = pc[0] - pa[0], e2y = pc[1] - pa[1], e2z = pc[2] - pa[2];
    const double nx = e1y * e2z - e1z * e2y;
    const double ny = e1z * e2x - e1x * e2z;
    const double nz = e1x * e2y - e1y * e2x;
    for (int64_t v : {a, b, c}) {
      out[v * 3 + 0] += nx;
      out[v * 3 + 1] += ny;
      out[v * 3 + 2] += nz;
    }
  }
  for (int64_t v = 0; v < nv; ++v) {
    double* o = out + v * 3;
    const double l = std::sqrt(o[0] * o[0] + o[1] * o[1] + o[2] * o[2]);
    if (l < 1e-20) {
      o[0] = 0.0; o[1] = 0.0; o[2] = 1.0;
    } else {
      o[0] /= l; o[1] /= l; o[2] /= l;
    }
  }
}

// ---------------------------------------------------------------------------
// RGBA8 vertex color packing (scene.cpp:219-242 style).
// ---------------------------------------------------------------------------
void pack_rgba8(const float* colors /* n*4 */, int64_t n, uint32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t v = 0;
    for (int c = 0; c < 4; ++c) {
      float f = colors[i * 4 + c];
      f = f < 0.0f ? 0.0f : (f > 1.0f ? 1.0f : f);
      v |= uint32_t(std::lround(f * 255.0f)) << (8 * c);
    }
    out[i] = v;
  }
}

// ---------------------------------------------------------------------------
// PNG scanline reconstruction (PNG spec section 9): ``raw`` holds h rows of a
// filter-type byte and ``stride`` bytes; ``out`` receives h * stride bytes.
// ``bpp`` is the bytes per complete pixel. Returns 0, or 1 + the row of the
// first unknown filter type.
// ---------------------------------------------------------------------------
int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int64_t bpp,
                     uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* in = raw + y * (stride + 1);
    const uint8_t ft = in[0];
    ++in;
    uint8_t* cur = out + y * stride;
    const uint8_t* up = y > 0 ? cur - stride : nullptr;
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int pred;
      switch (ft) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return 1 + y;
      }
      cur[i] = uint8_t(in[i] + pred);
    }
  }
  return 0;
}

}  // extern "C"

// Shared binned-SAH pieces (bounding boxes, build context, splitter).

namespace wbvh {

constexpr float kInvalid = 3.0e38f;
constexpr int kBins = 16;

struct BBox {
  float mn[3], mx[3];
  void reset() {
    mn[0] = mn[1] = mn[2] = kInvalid;
    mx[0] = mx[1] = mx[2] = -kInvalid;
  }
  void grow(const BBox& b) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], b.mn[k]);
      mx[k] = std::max(mx[k], b.mx[k]);
    }
  }
  void grow(const float* p) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], p[k]);
      mx[k] = std::max(mx[k], p[k]);
    }
  }
  float area() const {
    const float dx = std::max(0.0f, mx[0] - mn[0]);
    const float dy = std::max(0.0f, mx[1] - mn[1]);
    const float dz = std::max(0.0f, mx[2] - mn[2]);
    return 2.0f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Ctx {
  const float* pos;        // (V, 3)
  const int32_t* idx;      // (T, 3)
  const float* uv;         // (V, 2)
  const int32_t* tri_ids;  // (T,) or nullptr
  const int32_t* flags;    // (T,)
  int64_t n_tris;
  std::vector<BBox> tbox;
  std::vector<float> cent;  // (T, 3)
  std::vector<int32_t> prim;
  const int32_t* frag = nullptr;  // fragment -> triangle map (presplitting);
                                  // null when prim entries ARE triangle ids
  float* rows;
  int64_t max_rows;
  int64_t n_rows = 0;
  bool overflow = false;
};

// Binned-SAH split of prim[lo, hi) -> mid, evaluated on all three axes.
// Falls back to a median split on degenerate centroid distributions. Both
// sides non-empty.
inline int64_t split_range(Ctx& c, int64_t lo, int64_t hi) {
  BBox cb;
  cb.reset();
  for (int64_t i = lo; i < hi; ++i) cb.grow(&c.cent[size_t(c.prim[size_t(i)]) * 3]);
  const int64_t median = lo + (hi - lo) / 2;

  float best = kInvalid;
  int best_axis = -1;
  int best_split = -1;
  for (int axis = 0; axis < 3; ++axis) {
    const float ext = cb.mx[axis] - cb.mn[axis];
    if (ext <= 1e-20f) continue;
    BBox bb[kBins];
    int64_t bc[kBins] = {0};
    for (int b = 0; b < kBins; ++b) bb[b].reset();
    const float scale = kBins / ext;
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t p = c.prim[size_t(i)];
      int b = int((c.cent[size_t(p) * 3 + axis] - cb.mn[axis]) * scale);
      b = std::min(std::max(b, 0), kBins - 1);
      bb[b].grow(c.tbox[size_t(p)]);
      ++bc[b];
    }
    // Suffix sweep then prefix sweep for SAH cost at each of kBins-1 splits.
    float rarea[kBins];
    int64_t rcount[kBins];
    BBox acc;
    acc.reset();
    int64_t cnt = 0;
    for (int b = kBins - 1; b > 0; --b) {
      acc.grow(bb[b]);
      cnt += bc[b];
      rarea[b] = acc.area();
      rcount[b] = cnt;
    }
    acc.reset();
    cnt = 0;
    for (int b = 0; b < kBins - 1; ++b) {
      acc.grow(bb[b]);
      cnt += bc[b];
      if (cnt == 0 || rcount[b + 1] == 0) continue;
      const float cost =
          acc.area() * float(cnt) + rarea[b + 1] * float(rcount[b + 1]);
      if (cost < best) { best = cost; best_axis = axis; best_split = b; }
    }
  }
  if (best_axis < 0) {  // degenerate: all centroids coincide on every axis
    std::nth_element(c.prim.begin() + lo, c.prim.begin() + median,
                     c.prim.begin() + hi);
    return median;
  }
  const int axis = best_axis;
  const float scale = kBins / (cb.mx[axis] - cb.mn[axis]);
  auto bin_of = [&](int32_t p) {
    int b = int((c.cent[size_t(p) * 3 + axis] - cb.mn[axis]) * scale);
    return std::min(std::max(b, 0), kBins - 1);
  };
  auto it = std::partition(c.prim.begin() + lo, c.prim.begin() + hi,
                           [&](int32_t p) { return bin_of(p) <= best_split; });
  int64_t mid = it - c.prim.begin();
  if (mid == lo || mid == hi) {  // numeric edge: force median
    auto key = [&](int32_t a, int32_t b2) {
      return c.cent[size_t(a) * 3 + axis] < c.cent[size_t(b2) * 3 + axis];
    };
    std::nth_element(c.prim.begin() + lo, c.prim.begin() + median,
                     c.prim.begin() + hi, key);
    mid = median;
  }
  return mid;
}

}  // namespace wbvh

// ---------------------------------------------------------------------------
// W-wide planar BVH builder (W = 16 or 32): rows of W*8 f32 lanes in the
// layout csrc/traverse.cu reads (ops/traverse_fused.py). At W = 32 every
// 16 and 8 below doubles: leaves hold 16 triangles, refs -(row*16+cnt-1+1).
//
// Row layout at W = 16 (128 f32 lanes):
//   interior: [c]=bmin.x(c) [16+c]=bmin.y [32+c]=bmin.z
//             [48+c]=bmax.x [64+c]=bmax.y [80+c]=bmax.z
//             [96+c]=child ref (>=0 interior row; <0 => -(leaf_row*8+cnt-1+1))
//             [112..127]=0; empty slots carry inverted AABBs.
//   leaf:     [a*8 + t] = attribute a of triangle t (t<8): p0 p1 p2 (attrs
//             0..8), uv0 uv1 uv2 (9..14), attr 15 = orig_id*4 + flags.
// Also computes the exact per-tree stack bound
// need(node) = (nkids-1) + max(child needs).
// ---------------------------------------------------------------------------


namespace wplanar {

using wbvh::BBox;
using wbvh::Ctx;
using wbvh::kInvalid;

// Width-templated: kWidth children per interior row, kWidth/2 triangles per
// leaf row.
template <int kWidth>
inline int64_t alloc_row(Ctx& c) {
  constexpr int kLanes = kWidth * 8;
  if (c.n_rows >= c.max_rows) {
    c.overflow = true;
    return 0;
  }
  std::memset(c.rows + c.n_rows * kLanes, 0, kLanes * sizeof(float));
  return c.n_rows++;
}

// Unique triangles of prim[lo, hi): with presplitting several fragments of
// one triangle can land in the same leaf range; the leaf stores the tri once.
template <int kWidth>
inline int unique_tris(const Ctx& c, int64_t lo, int64_t hi, int32_t* out,
                       int cap) {
  int n = 0;
  for (int64_t i = lo; i < hi; ++i) {
    const int32_t p = c.prim[size_t(i)];
    const int32_t tri = c.frag ? c.frag[p] : p;
    bool seen = false;
    for (int j = 0; j < n; ++j)
      if (out[j] == tri) { seen = true; break; }
    if (seen) continue;
    if (n >= cap) return cap + 1;  // too many: caller must split further
    out[n++] = tri;
  }
  return n;
}

template <int kWidth>
inline float make_leaf(Ctx& c, int64_t lo, int64_t hi) {
  constexpr int kLanes = kWidth * 8;
  constexpr int kLeafMax = kWidth / 2;
  const int64_t row = alloc_row<kWidth>(c);
  float* r = c.rows + row * kLanes;
  int32_t tris[kLeafMax];
  const int cnt = unique_tris<kWidth>(c, lo, hi, tris, kLeafMax);
  for (int j = 0; j < cnt; ++j) {
    const int32_t p = tris[j];
    for (int v = 0; v < 3; ++v) {
      const int32_t vi = c.idx[p * 3 + v];
      r[(v * 3 + 0) * kLeafMax + j] = c.pos[vi * 3 + 0];
      r[(v * 3 + 1) * kLeafMax + j] = c.pos[vi * 3 + 1];
      r[(v * 3 + 2) * kLeafMax + j] = c.pos[vi * 3 + 2];
      r[(9 + v * 2 + 0) * kLeafMax + j] = c.uv[vi * 2 + 0];
      r[(9 + v * 2 + 1) * kLeafMax + j] = c.uv[vi * 2 + 1];
    }
    const int64_t orig = c.tri_ids ? c.tri_ids[p] : p;
    r[15 * kLeafMax + j] = float(orig * 4 + (c.flags[p] & 3));
  }
  const int64_t leaf_code = row * kLeafMax + (cnt - 1);
  return float(-(leaf_code + 1));
}

template <int kWidth>
float build_node(Ctx& c, int64_t lo, int64_t hi, BBox& out, int32_t& need,
                 bool force_interior);

template <int kWidth>
inline float make_interior(Ctx& c, int64_t lo, int64_t hi, int32_t& need) {
  constexpr int kLanes = kWidth * 8;
  constexpr int kLeafMax = kWidth / 2;
  int64_t parts[kWidth + 1];
  float metric[kWidth];  // SAH pick priority: bounds area x count
  int n_parts = 1;
  parts[0] = lo;
  parts[1] = hi;
  // Split the partition with the largest area*count (SAH subtree cost),
  // not the largest count — big flat pieces get cut before dense small
  // ones, which tightens sibling bounds.
  auto part_metric = [&](int64_t a, int64_t b) {
    if (b - a <= kLeafMax) return -1.0f;  // leaf-sized: never split
    BBox bx;
    bx.reset();
    for (int64_t i = a; i < b; ++i) bx.grow(c.tbox[size_t(c.prim[size_t(i)])]);
    return bx.area() * float(b - a);
  };
  metric[0] = part_metric(lo, hi);
  while (n_parts < kWidth) {
    int pick = -1;
    float best = 0.0f;
    for (int i = 0; i < n_parts; ++i) {
      if (metric[i] > best) { best = metric[i]; pick = i; }
    }
    if (pick < 0) break;
    const int64_t mid = wbvh::split_range(c, parts[pick], parts[pick + 1]);
    for (int i = n_parts; i > pick; --i) {
      parts[i + 1] = parts[i];
      metric[i] = metric[i - 1];
    }
    parts[pick + 1] = mid;
    metric[pick] = part_metric(parts[pick], mid);
    metric[pick + 1] = part_metric(mid, parts[pick + 2]);
    ++n_parts;
  }

  const int64_t row = alloc_row<kWidth>(c);
  int32_t kid_need = 0;
  for (int i = 0; i < n_parts && !c.overflow; ++i) {
    BBox box;
    int32_t nd = 0;
    const float ref = build_node<kWidth>(c, parts[i], parts[i + 1], box, nd, false);
    kid_need = std::max(kid_need, nd);
    float* r = c.rows + row * kLanes;
    r[0 * kWidth + i] = box.mn[0];
    r[1 * kWidth + i] = box.mn[1];
    r[2 * kWidth + i] = box.mn[2];
    r[3 * kWidth + i] = box.mx[0];
    r[4 * kWidth + i] = box.mx[1];
    r[5 * kWidth + i] = box.mx[2];
    r[6 * kWidth + i] = ref;
  }
  float* r = c.rows + row * kLanes;
  for (int i = n_parts; i < kWidth; ++i) {
    r[0 * kWidth + i] = r[1 * kWidth + i] = r[2 * kWidth + i] = kInvalid;
    r[3 * kWidth + i] = r[4 * kWidth + i] = r[5 * kWidth + i] = -kInvalid;
    r[6 * kWidth + i] = 0.0f;
  }
  need = (n_parts - 1) + kid_need;
  return float(row);
}

template <int kWidth>
float build_node(Ctx& c, int64_t lo, int64_t hi, BBox& out, int32_t& need,
                 bool force_interior) {
  out.reset();
  for (int64_t i = lo; i < hi; ++i) out.grow(c.tbox[size_t(c.prim[size_t(i)])]);
  if (c.overflow) return 0.0f;
  constexpr int kLeafMax = kWidth / 2;
  if (!force_interior) {
    if (hi - lo <= kLeafMax) {
      need = 0;
      return make_leaf<kWidth>(c, lo, hi);
    }
    // Presplit fragments of one triangle dedup at leaf emission, so a
    // larger fragment range can still be a single-row leaf.
    if (c.frag && hi - lo <= 3 * kLeafMax) {
      int32_t tmp[kLeafMax];
      if (unique_tris<kWidth>(c, lo, hi, tmp, kLeafMax) <= kLeafMax) {
        need = 0;
        return make_leaf<kWidth>(c, lo, hi);
      }
    }
  }
  return make_interior<kWidth>(c, lo, hi, need);
}

// Clip triangle `tri` against the half-space {x[axis] <= mid} (below) or
// {x[axis] >= mid} (!below); returns the clipped polygon's bbox intersected
// with the parent fragment box. Invalid (reset) bbox if the clip is empty.
inline wbvh::BBox clip_tri_box(const float* pos, const int32_t* idx,
                               int32_t tri, const wbvh::BBox& pb, int axis,
                               float mid, bool below) {
  float p[3][3];
  for (int v = 0; v < 3; ++v)
    for (int k = 0; k < 3; ++k)
      p[v][k] = pos[size_t(idx[tri * 3 + v]) * 3 + k];
  wbvh::BBox out;
  out.reset();
  int n_emit = 0;
  for (int i = 0; i < 3; ++i) {
    const float* a = p[i];
    const float* b = p[(i + 1) % 3];
    const float da = below ? mid - a[axis] : a[axis] - mid;
    const float db = below ? mid - b[axis] : b[axis] - mid;
    if (da >= 0.0f) { out.grow(a); ++n_emit; }
    if ((da >= 0.0f) != (db >= 0.0f)) {
      const float t = da / (da - db);
      float q[3];
      for (int k = 0; k < 3; ++k) q[k] = a[k] + t * (b[k] - a[k]);
      out.grow(q);
      ++n_emit;
    }
  }
  if (n_emit < 3) { out.reset(); return out; }
  for (int k = 0; k < 3; ++k) {
    out.mn[k] = std::max(out.mn[k], pb.mn[k]);
    out.mx[k] = std::min(out.mx[k], pb.mx[k]);
    if (out.mn[k] > out.mx[k]) { out.reset(); return out; }
  }
  return out;
}

template <int kWidth>
int64_t build_planar(const float* positions, const int32_t* indices,
                     const float* uv, const int32_t* tri_ids,
                     const int32_t* tri_flags, int64_t n_tris,
                     float* rows_out, int64_t max_rows,
                     int32_t* stack_depth_out, float presplit) {
  if (n_tris < 1 || max_rows < 2) return -1;
  wbvh::Ctx c;
  c.pos = positions;
  c.idx = indices;
  c.uv = uv;
  c.tri_ids = tri_ids;
  c.flags = tri_flags;
  c.n_tris = n_tris;
  c.rows = rows_out;
  c.max_rows = max_rows;
  std::vector<wbvh::BBox> tbox(static_cast<size_t>(n_tris));
  for (int64_t t = 0; t < n_tris; ++t) {
    wbvh::BBox& b = tbox[size_t(t)];
    b.reset();
    for (int v = 0; v < 3; ++v) b.grow(positions + size_t(indices[t * 3 + v]) * 3);
  }

  // SBVH-style presplitting: big flat triangles (architectural floors,
  // walls) get their bounds split at the longest-axis midpoint with a true
  // polygon clip, so sibling subtree bounds stop overlapping them. Budget
  // is `presplit * n_tris` extra fragments, spent largest-box-first.
  std::vector<int32_t> frag_tri;
  int64_t budget = presplit > 0.0f ? int64_t(presplit * float(n_tris)) : 0;
  if (budget > 0) {
    frag_tri.resize(size_t(n_tris));
    std::priority_queue<std::pair<float, int64_t>> heap;
    for (int64_t t = 0; t < n_tris; ++t) {
      frag_tri[size_t(t)] = int32_t(t);
      const float a = tbox[size_t(t)].area();
      if (a > 0.0f) heap.push({a, t});
    }
    while (budget > 0 && !heap.empty()) {
      const int64_t f = heap.top().second;
      heap.pop();
      const wbvh::BBox pb = tbox[size_t(f)];
      int axis = 0;
      float ext = -1.0f;
      for (int k = 0; k < 3; ++k) {
        const float e = pb.mx[k] - pb.mn[k];
        if (e > ext) { ext = e; axis = k; }
      }
      if (ext <= 1e-12f) continue;
      const float mid = 0.5f * (pb.mn[axis] + pb.mx[axis]);
      const int32_t tri = frag_tri[size_t(f)];
      const wbvh::BBox bl =
          clip_tri_box(positions, indices, tri, pb, axis, mid, true);
      const wbvh::BBox br =
          clip_tri_box(positions, indices, tri, pb, axis, mid, false);
      if (bl.mn[0] > bl.mx[0] || br.mn[0] > br.mx[0]) continue;
      tbox[size_t(f)] = bl;
      tbox.push_back(br);
      frag_tri.push_back(tri);
      heap.push({bl.area(), f});
      heap.push({br.area(), int64_t(tbox.size()) - 1});
      --budget;
    }
  }

  const int64_t n_prims = int64_t(tbox.size());
  c.tbox = std::move(tbox);
  c.frag = frag_tri.empty() ? nullptr : frag_tri.data();
  c.cent.resize(size_t(n_prims) * 3);
  c.prim.resize(size_t(n_prims));
  for (int64_t t = 0; t < n_prims; ++t) {
    const wbvh::BBox& b = c.tbox[size_t(t)];
    for (int k = 0; k < 3; ++k)
      c.cent[size_t(t) * 3 + k] = 0.5f * (b.mn[k] + b.mx[k]);
    c.prim[size_t(t)] = int32_t(t);
  }
  wbvh::BBox root_box;
  int32_t need = 1;
  const float root =
      build_node<kWidth>(c, 0, n_prims, root_box, need, /*force_interior=*/true);
  if (c.overflow || root != 0.0f) return -1;
  if (stack_depth_out) *stack_depth_out = std::max(need, 1);
  return c.n_rows;
}

}  // namespace wplanar

extern "C" {

// Returns rows written (row 0 = root) or -1 on overflow; *stack_depth_out
// receives the exact worst-case traversal stack need of this tree.
// `presplit` > 0 spends that fraction of n_tris as extra clipped fragments
// on the largest triangle bounds (SBVH-style; duplicates dedup in leaves).
int64_t build_bvh16(const float* positions, const int32_t* indices,
                    const float* uv, const int32_t* tri_ids,
                    const int32_t* tri_flags, int64_t n_tris,
                    float* rows_out, int64_t max_rows,
                    int32_t* stack_depth_out, float presplit) {
  return wplanar::build_planar<16>(positions, indices, uv, tri_ids, tri_flags,
                                   n_tris, rows_out, max_rows, stack_depth_out,
                                   presplit);
}

// 32-wide variant: 1024-byte rows, leaves of up to 16 triangles.
int64_t build_bvh32(const float* positions, const int32_t* indices,
                    const float* uv, const int32_t* tri_ids,
                    const int32_t* tri_flags, int64_t n_tris,
                    float* rows_out, int64_t max_rows,
                    int32_t* stack_depth_out, float presplit) {
  return wplanar::build_planar<32>(positions, indices, uv, tri_ids, tri_flags,
                                   n_tris, rows_out, max_rows, stack_depth_out,
                                   presplit);
}

}  // extern "C"
