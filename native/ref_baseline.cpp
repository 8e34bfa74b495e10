// Sequential C++ baseline: the reference's per-frame algorithm, re-implemented
// single-threaded at C++ speed, so the device path can be compared with a
// defensible apples-to-apples CPU number.
//
// The actual reference (thepochynsons/MCRay-Tracing) cannot be built in this
// image (no Bullet / OpenCV dev libraries), so this file re-creates its frame
// loop with the same algorithmic structure and constants, written scalar and
// sequential exactly like the C++:
//   trace:  per path, bounce loop with BVH closest-hit queries
//           (reference src/scene.cpp:50-183, src/ray.cpp:11-97)
//   march:  per segment, axial-resolution stepping with texture-table lookups
//           and RF scatter-adds (src/main.cpp:106-141, src/volume.h:46-61)
//   post:   separable uncentered PSF convolution (src/rfimage.h:93-123),
//           sequential peak-lerp envelope walk (src/rfimage.h:54-91),
//           bilinear polar scan conversion (src/rfimage.h:139,183-215)
//
// Charitable deviations (all make THIS baseline faster, so a speedup
// reported against it is conservative):
//  - one mt19937 seeded once, instead of the reference's per-call
//    std::random_device reseeding (src/ray.cpp:85-87,174-177,216-218)
//  - our binned-SAH BVH (mcray_native.cpp) instead of Bullet's quantized BVH
//  - no OpenCV/GUI overhead; outputs written straight into caller buffers
//
// Driven by scripts/ref_baseline_bench.py over ctypes; geometry, probe
// layout, PSF kernels and scan maps are passed in from the same Python scene
// compiler the device path uses, so the workload is identical.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {
void *mcray_build_bvh(const float *tris, int t, int leaf_size, int *n_nodes);
void mcray_copy_bvh(void *handle, float *nodes, int32_t *meta, int32_t *order);
void mcray_free(void *handle);
}

namespace {

struct V3 {
  float x, y, z;
};
static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline V3 hadamard(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float norm(V3 a) { return std::sqrt(std::max(dot(a, a), 0.0f)); }
static inline V3 normalized(V3 a) {
  float n = norm(a);
  return a * (1.0f / std::max(n, 1e-30f));
}

// material table columns (src/mesh.h:7-10 order)
enum { IMPEDANCE, ATTENUATION, MU0, MU1, SIGMA, SPECULARITY, SHININESS, THICKNESS };

struct Segment {
  V3 from, to, dir;
  float reflected;    // Mattausch Eq. 8 boundary echo term
  float initial;      // intensity at segment start
  float attenuation;  // media attenuation
  float distance_mm;  // travelled distance to segment start
  int media_id;
  int element;
};

// max(base,0)^e with 0^e = 0 (physics.safe_pow)
static inline float powmax(float base, float e) {
  return base > 0.0f ? std::pow(base, e) : 0.0f;
}

// flat-BVH closest hit: nodes (N,6) min/max, meta (N,2) inner->(right,-1)
// leaf->(first,count), order (T,) permutation (mcray_native.cpp layout);
// Moller-Trumbore both-sided, t in (0,1) along seg (segment parameterised,
// matching ops/geometry.intersect_closest / Bullet's rayTest contract)
struct Bvh {
  std::vector<float> nodes;
  std::vector<int32_t> meta;
  std::vector<int32_t> order;
};

struct Hit {
  bool hit = false;
  float t = 2.0f;
  int tri = -1;
};

static inline bool slab_hit(const float *n6, V3 o, V3 inv_d, float t_max) {
  float t0 = 0.0f, t1 = t_max;
  const float olist[3] = {o.x, o.y, o.z};
  const float ilist[3] = {inv_d.x, inv_d.y, inv_d.z};
  for (int a = 0; a < 3; ++a) {
    float lo = (n6[a] - olist[a]) * ilist[a];
    float hi = (n6[3 + a] - olist[a]) * ilist[a];
    if (lo > hi) std::swap(lo, hi);
    t0 = std::max(t0, lo);
    t1 = std::min(t1, hi);
    if (t0 > t1) return false;
  }
  return true;
}

static Hit bvh_closest(const Bvh &bvh, const float *tris, V3 origin, V3 seg,
                       long long *n_tri_tests) {
  Hit best;
  V3 inv{1.0f / (seg.x != 0.0f ? seg.x : 1e-30f),
         1.0f / (seg.y != 0.0f ? seg.y : 1e-30f),
         1.0f / (seg.z != 0.0f ? seg.z : 1e-30f)};
  int stack[64];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    int ni = stack[--sp];
    if (!slab_hit(&bvh.nodes[6 * ni], origin, inv, best.t)) continue;
    int32_t a = bvh.meta[2 * ni], b = bvh.meta[2 * ni + 1];
    if (b >= 0) {  // leaf: (first, count)
      for (int k = 0; k < b; ++k) {
        int ti = bvh.order[a + k];
        const float *tp = tris + 9 * ti;
        V3 v0{tp[0], tp[1], tp[2]};
        V3 e1{tp[3] - tp[0], tp[4] - tp[1], tp[5] - tp[2]};
        V3 e2{tp[6] - tp[0], tp[7] - tp[1], tp[8] - tp[2]};
        ++*n_tri_tests;
        V3 pvec = cross(seg, e2);
        float det = dot(e1, pvec);
        if (std::fabs(det) <= 1e-9f) continue;
        float inv_det = 1.0f / det;
        V3 tvec = origin - v0;
        float u = dot(tvec, pvec) * inv_det;
        if (u < 0.0f) continue;
        V3 qvec = cross(tvec, e1);
        float v = dot(seg, qvec) * inv_det;
        if (v < 0.0f || u + v > 1.0f) continue;
        float t = dot(e2, qvec) * inv_det;
        if (t <= 0.0f || t >= 1.0f) continue;
        if (t < best.t) {
          best.t = t;
          best.tri = ti;
          best.hit = true;
        }
      }
    } else {  // inner: left = ni+1, right = a
      if (sp + 2 <= 64) {
        stack[sp++] = a;
        stack[sp++] = ni + 1;
      }
    }
  }
  return best;
}

// perturbed-normal disc sampling (physics._unit_vector_from_disc,
// replicating src/ray.cpp:167-224)
static V3 unit_vector_from_disc(float a, float r, V3 v, float cos_theta) {
  float px = r * std::cos(a);
  float py = r * std::sin(a);
  float p = std::max(px * px + py * py, 1e-12f);
  float vx = v.x, vy = v.y, vz = v.z;
  bool flag = std::fabs(vx) > std::fabs(vy);
  if (flag) std::swap(vx, vy);
  float b = std::max(1.0f - vx * vx, 1e-12f);
  float c = std::sqrt(std::max((1.0f - cos_theta * cos_theta) / (p * b), 1e-20f));
  px *= c;
  py *= c;
  float d = cos_theta - vx * px;
  float wx = vx * cos_theta - b * px;
  float wy = vy * d + vz * py;
  float wz = vz * d - vy * py;
  if (flag) std::swap(wx, wy);
  return {wx, wy, wz};
}

}  // namespace

extern "C" {

// Build the host BVH once (the reference builds Bullet's BVH at scene init,
// src/scene.cpp:306-309 — not per frame). Returns an opaque handle for
// mcray_ref_frame; free with mcray_ref_free.
void *mcray_ref_prepare(const float *tris, int n_tris) {
  int n_nodes = 0;
  void *h = mcray_build_bvh(tris, n_tris, 4, &n_nodes);
  auto *bvh = new Bvh();
  bvh->nodes.resize(6 * (size_t)n_nodes);
  bvh->meta.resize(2 * (size_t)n_nodes);
  bvh->order.resize((size_t)n_tris);
  mcray_copy_bvh(h, bvh->nodes.data(), bvh->meta.data(), bvh->order.data());
  mcray_free(h);
  return bvh;
}

void mcray_ref_free(void *handle) { delete static_cast<Bvh *>(handle); }

// One full frame of the sequential reference algorithm. Returns 0 on success.
// stage_ms: [trace, march, conv+envelope, scan-convert]
// counters: [ray_queries, collisions, segments]
int mcray_ref_frame(
    void *bvh_handle,
    const float *tris, int n_tris,            // (T,3,3) world-space
    const int32_t *tri_mesh_id,               // (T,)
    const int32_t *mesh_mat_inside,           // (K,)
    const int32_t *mesh_mat_outside,          // (K,)
    const uint8_t *mesh_vascular,             // (K,)
    const float *materials, int n_materials,  // (M,8)
    const float *elem_pos, const float *elem_dir, int n_elements,  // (R,3)
    int n_samples, int max_depth, int starting_material,
    const float *spacing,  // (3,)
    const float *vol_noise, const float *vol_prob, int vol_size,  // (V^3,)
    float res_mm,                              // texture voxel pitch [mm]
    float frequency, float speed, float window_us, float axial_res_mm,
    int axial_res_um, float intensity_eps, float ray_start_offset,
    const float *ax_kernel, int ax_n, const float *lat_kernel, int lat_n,
    const float *map_row, const float *map_col, int out_rows, int out_cols,
    int rf_rows, uint64_t rng_seed,
    float *out_bmode,   // (out_rows, out_cols)
    float *out_rf_raw,  // (rf_rows, n_elements) pre-convolution RF (optional, may be null)
    double *stage_ms, long long *counters) {
  (void)n_materials;
  if (n_tris <= 0 || n_elements <= 0 || !bvh_handle) return 1;

  std::mt19937 rng(rng_seed);
  std::uniform_real_distribution<float> uni(0.0f, 1.0f);
  std::normal_distribution<float> gauss(0.0f, 1.0f);

  const Bvh &bvh = *static_cast<const Bvh *>(bvh_handle);

  const int n_cols = n_elements;
  std::vector<float> rf((size_t)rf_rows * n_cols, 0.0f);
  const V3 sp{spacing[0], spacing[1], spacing[2]};
  const float row_dt = (float)axial_res_um / speed;         // rf_row_dt_us
  const float march_dt = axial_res_mm * 1000.0f / speed;    // march_dt_us
  long long ray_queries = 0, collisions = 0, n_segments = 0, tri_tests = 0;

  std::vector<Segment> segments;
  segments.reserve((size_t)n_elements * n_samples * max_depth);

  auto tic = []() {
    return std::chrono::steady_clock::now();
  };
  auto ms_since = [](std::chrono::steady_clock::time_point t0) {
    return std::chrono::duration<double, std::milli>(
               std::chrono::steady_clock::now() - t0)
        .count();
  };

  // ---- trace (scene::cast_rays structure: per element, per sample path) ----
  auto t_trace = tic();
  for (int e = 0; e < n_elements; ++e) {
    V3 epos{elem_pos[3 * e], elem_pos[3 * e + 1], elem_pos[3 * e + 2]};
    V3 edir{elem_dir[3 * e], elem_dir[3 * e + 1], elem_dir[3 * e + 2]};
    for (int s = 0; s < n_samples; ++s) {
      V3 from = epos, dir = edir;
      int media = starting_material, media_out = -1;
      float intensity = 1.0f / n_samples;
      float dist_mm = 0.0f;
      for (int depth = 0; depth < max_depth; ++depth) {
        float att = materials[8 * media + ATTENUATION];
        float r_length = 10.0f *
                         std::log(intensity_eps /
                                  std::max(intensity, intensity_eps * 1e-3f)) /
                         -att * frequency;
        V3 origin = from + dir * ray_start_offset;
        V3 dest = from + hadamard(dir * (r_length / 100.0f), sp);
        V3 seg = dest - origin;
        ++ray_queries;
        Hit hit = bvh_closest(bvh, tris, origin, seg, &tri_tests);
        if (!hit.hit) {
          segments.push_back({from, dest, dir, 0.0f, intensity, att, dist_mm,
                              media, e});
          break;
        }
        ++collisions;
        V3 point = origin + seg * hit.t;
        const float *tp = tris + 9 * hit.tri;
        V3 e1{tp[3] - tp[0], tp[4] - tp[1], tp[5] - tp[2]};
        V3 e2{tp[6] - tp[0], tp[7] - tp[1], tp[8] - tp[2]};
        V3 nrm = normalized(cross(e1, e2));
        if (dot(nrm, seg) > 0.0f) nrm = nrm * -1.0f;  // toward origin side

        int mesh = tri_mesh_id[hit.tri];
        int m_in = mesh_mat_inside[mesh], m_out = mesh_mat_outside[mesh];
        bool vascular = mesh_vascular[mesh] != 0;

        // penetration fuzz q ~ |N(0, thickness_inside)| (src/scene.cpp:129-139)
        float q = std::fabs(gauss(rng) * materials[8 * m_in + THICKNESS]);
        V3 inside = point + dir * q;
        float d_mm = norm(hadamard(from - inside, sp)) * 10.0f;
        float before = intensity;
        intensity *= std::exp(-att * d_mm * 0.01f * frequency);

        // vascular media state machine (src/ray.cpp:14-47)
        int mat_after, out_after;
        if (media_out >= 0) {
          if (vascular) {
            mat_after = media_out;
            out_after = -1;
          } else {
            mat_after = media;
            out_after = (media_out == m_in) ? m_out : m_in;
          }
        } else {
          if (vascular) {
            mat_after = m_in;
            out_after = media;
          } else {
            mat_after = (media == m_in) ? m_out : m_in;
            out_after = -1;
          }
        }

        // perturbed normal (src/ray.cpp:49-50,167-224)
        float shin = materials[8 * mat_after + SHININESS];
        float u_ang = std::max(uni(rng), 1e-12f);
        float cos_th = std::pow(u_ang, 1.0f / (std::floor(shin) + 1.0f));
        float a_draw = uni(rng) * 2.0f * (float)M_PI;
        float r_draw = 0.5f * std::sqrt(uni(rng));
        V3 pn = unit_vector_from_disc(a_draw, r_draw, nrm, cos_th);

        float inc = std::fabs(dot(dir, pn));
        float z1 = materials[8 * media + IMPEDANCE];
        float z2 = materials[8 * mat_after + IMPEDANCE];
        float ratio = z1 / z2;
        float refr_sq = 1.0f - ratio * ratio * (1.0f - inc * inc);
        bool tir = refr_sq < 0.0f;
        float refr = tir ? 0.0f : std::sqrt(std::max(refr_sq, 0.0f));
        V3 refr_dir = normalized(dir * ratio + pn * (ratio * inc - refr));
        V3 refl_dir = normalized(dir + pn * (2.0f * inc));
        float i_refl;
        if (tir) {
          i_refl = intensity;
        } else {
          float num = z1 * inc - z2 * refr, den = z1 * inc + z2 * refr;
          i_refl = intensity * (num / den) * (num / den);
        }
        float i_refr = intensity - i_refl;
        float spec = materials[8 * mat_after + SPECULARITY];
        float back = ((tir ? 0.0f : powmax(dot(dir, refr_dir), spec)) +
                      powmax(dot(dir, refl_dir), spec)) *
                     cos_th;

        segments.push_back(
            {from, inside, dir, back, before, att, dist_mm, media, e});

        // Russian roulette (src/ray.cpp:85-94)
        float x = uni(rng);
        bool reflect = (i_refl / std::max(intensity, intensity_eps)) > x;
        float next_i = reflect ? (i_refl > intensity_eps ? i_refl : 0.0f)
                               : (i_refr > intensity_eps ? i_refr : 0.0f);
        if (!(next_i > intensity_eps)) break;
        dist_mm += d_mm;
        from = point;
        dir = reflect ? refl_dir : refr_dir;
        if (!reflect) {
          media = mat_after;
          media_out = out_after;
        }
        intensity = next_i;
      }
    }
  }
  stage_ms[0] = ms_since(t_trace);
  n_segments = (long long)segments.size();

  // ---- march (src/main.cpp:106-141) ----
  auto t_march = tic();
  for (const Segment &g : segments) {
    float seg_len = norm(g.to - g.from) * 10.0f;  // scene::distance (no spacing)
    int steps = (int)std::floor(seg_len / axial_res_mm);
    float t0 = g.distance_mm * 1000.0f / speed;
    float mu0 = materials[8 * g.media_id + MU0];
    float mu1 = materials[8 * g.media_id + MU1];
    float sg = materials[8 * g.media_id + SIGMA];
    float step_fac = std::exp(-g.attenuation * axial_res_mm * 0.01f * frequency);
    float inten = g.initial;
    float t = t0;
    V3 p = g.from;
    V3 dstep = g.dir * axial_res_mm;
    for (int k = 0; k < steps && t < window_us; ++k) {
      // nearest-voxel wrap lookup (src/volume.h:46-61)
      auto widx = [&](float x) {
        int qi = (int)(x / res_mm);  // C float->int truncation
        int m = qi % vol_size;
        return m < 0 ? m + vol_size : m;
      };
      size_t vi = ((size_t)widx(p.x) * vol_size + widx(p.y)) * vol_size + widx(p.z);
      float scat = vol_prob[vi] >= mu1 ? vol_noise[vi] * sg + mu0 : 0.0f;
      int row = (int)std::floor(t / row_dt);
      if (row >= 0 && row < rf_rows) rf[(size_t)row * n_cols + g.element] += inten * scat;
      p = p + dstep;
      t += march_dt;
      inten *= step_fac;
    }
    if (steps >= 1) {  // boundary echo (src/main.cpp:138-139)
      float tb = t0 + march_dt * (steps - 1);
      int row = (int)std::floor(tb / row_dt);
      if (row >= 0 && row < rf_rows && tb < window_us)
        rf[(size_t)row * n_cols + g.element] += g.reflected / n_samples;
    }
  }
  stage_ms[1] = ms_since(t_march);
  if (out_rf_raw) std::memcpy(out_rf_raw, rf.data(), rf.size() * sizeof(float));

  // ---- convolve + envelope (src/rfimage.h:93-123, 54-91) ----
  auto t_post = tic();
  const int a = ax_n, l = lat_n;
  if (rf_rows > 2 * a && n_cols > l + l / 2) {
    std::vector<float> buf((size_t)rf_rows * n_cols, 0.0f);
    for (int r = a; r < rf_rows - a; ++r)
      for (int c = 0; c < n_cols; ++c) {
        float acc = 0.0f;
        for (int k = 0; k < a; ++k) acc += rf[(size_t)(r + k) * n_cols + c] * ax_kernel[k];
        buf[(size_t)r * n_cols + c] = acc;
      }
    for (int r = a; r < rf_rows - a; ++r)
      for (int c = l / 2; c < n_cols - l; ++c) {
        float acc = 0.0f;
        for (int k = 0; k < l; ++k) acc += buf[(size_t)r * n_cols + (c + k)] * lat_kernel[k];
        rf[(size_t)r * n_cols + c] = acc;
      }
  }
  // sequential peak-lerp walk per column
  for (int c = 0; c < n_cols; ++c) {
    float prev_val = rf[c];  // raw x[0] (reference init)
    int prev_pos = 0;
    bool ascending = false;
    for (int r = 1; r < rf_rows - 1; ++r) {
      float xm = rf[(size_t)(r - 1) * n_cols + c];
      float x0 = rf[(size_t)r * n_cols + c];
      float xp = rf[(size_t)(r + 1) * n_cols + c];
      ascending = xm < x0;
      if (ascending && x0 >= xp) {  // peak
        float pv = std::fabs(x0);
        int span = r - prev_pos;
        for (int j = prev_pos; j <= r; ++j) {
          float alpha = span > 0 ? (float)(j - prev_pos) / span : 1.0f;
          rf[(size_t)j * n_cols + c] = prev_val * (1.0f - alpha) + pv * alpha;
        }
        prev_val = pv;
        prev_pos = r;
      }
    }
    // rows after the last peak keep raw values (reference behaviour)
  }
  stage_ms[2] = ms_since(t_post);

  // ---- scan conversion: bilinear gather, zero outside ----
  auto t_scan = tic();
  for (int i = 0; i < out_rows; ++i)
    for (int j = 0; j < out_cols; ++j) {
      float mr = map_row[(size_t)i * out_cols + j];
      float mc = map_col[(size_t)i * out_cols + j];
      int r0 = (int)std::floor(mr), c0 = (int)std::floor(mc);
      float fr = mr - r0, fc = mc - c0;
      auto sample = [&](int r, int c) -> float {
        if (r < 0 || r >= rf_rows || c < 0 || c >= n_cols) return 0.0f;
        return rf[(size_t)r * n_cols + c];
      };
      float v = (1 - fr) * ((1 - fc) * sample(r0, c0) + fc * sample(r0, c0 + 1)) +
                fr * ((1 - fc) * sample(r0 + 1, c0) + fc * sample(r0 + 1, c0 + 1));
      out_bmode[(size_t)i * out_cols + j] = v;
    }
  stage_ms[3] = ms_since(t_scan);

  counters[0] = ray_queries;
  counters[1] = collisions;
  counters[2] = n_segments;
  return 0;
}

}  // extern "C"
