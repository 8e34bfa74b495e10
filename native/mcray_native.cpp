// Native host-side runtime for mcray_tpu.
//
// Equivalents of the reference's native dependencies (SURVEY.md
// §2.2): Bullet's quantized BVH build (reference src/scene.cpp:306-309) and
// the vendored tinyobjloader (reference src/wavefront/tiny_obj_loader.cpp).
// Scene compilation is host work; this library does the heavy O(T log T)
// parts in C++ and hands flat arrays to the JAX traversal paths.
// Exposed through ctypes (mcray_tpu/utils/native.py) — no pybind needed.
//
// BVH: binned SAH (16 bins), flat depth-first layout:
//   nodes: (N, 6) f32  [min.xyz, max.xyz]
//   meta:  (N, 2) i32  inner -> (right_child_index, -1), left child = i + 1
//                      leaf  -> (first, count) into tri_order
//   tri_order: (T,) i32 permutation, leaf triangles contiguous.

#include <algorithm>
#include <cctype>
#include <cfloat>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Vec3 {
  float x = 0.f, y = 0.f, z = 0.f;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const AABB &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3 &p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    if (hi.x < lo.x) return 0.f;
    float dx = hi.x - lo.x, dy = hi.y - lo.y, dz = hi.z - lo.z;
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct ObjData {
  std::vector<float> verts;   // 3 * V
  std::vector<int32_t> faces; // 3 * F
};

struct BvhData {
  std::vector<float> nodes;   // 6 * N
  std::vector<int32_t> meta;  // 2 * N
  std::vector<int32_t> order; // T
};

struct Handle {
  ObjData *obj = nullptr;
  BvhData *bvh = nullptr;
};

// ---------------------------------------------------------------------------
// OBJ parsing
// ---------------------------------------------------------------------------

ObjData *parse_obj(const char *path) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(len), '\0');
  if (len > 0 && std::fread(&buf[0], 1, static_cast<size_t>(len), f) !=
                     static_cast<size_t>(len)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  auto *out = new ObjData();
  std::vector<int32_t> poly;
  const char *p = buf.c_str();
  const char *end = p + buf.size();
  while (p < end) {
    // find line end
    const char *eol = static_cast<const char *>(memchr(p, '\n', end - p));
    if (!eol) eol = end;
    if (p[0] == 'v' && p[1] == ' ') {
      char *q = const_cast<char *>(p) + 2;
      float x = std::strtof(q, &q);
      float y = std::strtof(q, &q);
      float z = std::strtof(q, &q);
      out->verts.push_back(x);
      out->verts.push_back(y);
      out->verts.push_back(z);
    } else if (p[0] == 'f' && p[1] == ' ') {
      poly.clear();
      const char *q = p + 2;
      while (q < eol) {
        while (q < eol && std::isspace(static_cast<unsigned char>(*q))) ++q;
        if (q >= eol) break;
        char *next = nullptr;
        long idx = std::strtol(q, &next, 10);
        if (next == q) break;
        q = next;
        // skip /vt/vn suffixes
        while (q < eol && !std::isspace(static_cast<unsigned char>(*q))) ++q;
        long nverts = static_cast<long>(out->verts.size() / 3);
        int32_t vi = idx > 0 ? static_cast<int32_t>(idx - 1)
                             : static_cast<int32_t>(nverts + idx);
        poly.push_back(vi);
      }
      for (size_t k = 1; k + 1 < poly.size(); ++k) { // fan triangulation
        out->faces.push_back(poly[0]);
        out->faces.push_back(poly[k]);
        out->faces.push_back(poly[k + 1]);
      }
    }
    p = eol + 1;
  }
  return out;
}

// ---------------------------------------------------------------------------
// Binned SAH BVH
// ---------------------------------------------------------------------------

struct Builder {
  const float *tris; // (T, 3, 3)
  int leaf_size;
  std::vector<AABB> boxes;
  std::vector<Vec3> centroids;
  BvhData out;

  int build(std::vector<int32_t> &idx, int begin, int count) {
    int my = static_cast<int>(out.meta.size() / 2);
    AABB bounds;
    for (int i = begin; i < begin + count; ++i) bounds.grow(boxes[idx[i]]);
    out.nodes.insert(out.nodes.end(),
                     {bounds.lo.x, bounds.lo.y, bounds.lo.z, bounds.hi.x,
                      bounds.hi.y, bounds.hi.z});
    out.meta.push_back(0);
    out.meta.push_back(0);

    if (count <= leaf_size) {
      out.meta[2 * my] = static_cast<int32_t>(out.order.size());
      out.meta[2 * my + 1] = count;
      for (int i = begin; i < begin + count; ++i) out.order.push_back(idx[i]);
      return my;
    }

    // centroid bounds for binning
    AABB cb;
    for (int i = begin; i < begin + count; ++i) cb.grow(centroids[idx[i]]);
    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = ext[1] > ext[0] ? 1 : 0;
    if (ext[2] > ext[axis]) axis = 2;

    int mid;
    if (ext[axis] < 1e-12f) {
      mid = begin + count / 2; // degenerate: median split
    } else {
      constexpr int NB = 16;
      AABB bin_box[NB];
      int bin_cnt[NB] = {0};
      float lo = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
      float scale = NB / ext[axis];
      auto bin_of = [&](int t) {
        const Vec3 &c = centroids[t];
        float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        int b = static_cast<int>((v - lo) * scale);
        return std::min(std::max(b, 0), NB - 1);
      };
      for (int i = begin; i < begin + count; ++i) {
        int b = bin_of(idx[i]);
        bin_cnt[b]++;
        bin_box[b].grow(boxes[idx[i]]);
      }
      // sweep for best SAH split
      float right_area[NB];
      AABB acc;
      int best = -1;
      float best_cost = FLT_MAX;
      for (int b = NB - 1; b > 0; --b) {
        acc.grow(bin_box[b]);
        right_area[b] = acc.area();
      }
      acc = AABB();
      int left_cnt = 0;
      for (int b = 0; b < NB - 1; ++b) {
        acc.grow(bin_box[b]);
        left_cnt += bin_cnt[b];
        int right_cnt = count - left_cnt;
        if (left_cnt == 0 || right_cnt == 0) continue;
        float cost = acc.area() * left_cnt + right_area[b + 1] * right_cnt;
        if (cost < best_cost) {
          best_cost = cost;
          best = b;
        }
      }
      if (best < 0) {
        mid = begin + count / 2;
      } else {
        auto it = std::partition(idx.begin() + begin, idx.begin() + begin + count,
                                 [&](int t) { return bin_of(t) <= best; });
        mid = static_cast<int>(it - idx.begin());
        if (mid == begin || mid == begin + count) mid = begin + count / 2;
      }
    }

    build(idx, begin, mid - begin); // left child == my + 1 (DFS)
    int right = build(idx, mid, begin + count - mid);
    out.meta[2 * my] = right;
    out.meta[2 * my + 1] = -1;
    return my;
  }
};

} // namespace

extern "C" {

void *mcray_load_obj(const char *path, int *n_verts, int *n_faces) {
  ObjData *obj = parse_obj(path);
  if (!obj) return nullptr;
  *n_verts = static_cast<int>(obj->verts.size() / 3);
  *n_faces = static_cast<int>(obj->faces.size() / 3);
  auto *h = new Handle();
  h->obj = obj;
  return h;
}

void mcray_copy_obj(void *handle, float *verts, int32_t *faces) {
  auto *h = static_cast<Handle *>(handle);
  std::memcpy(verts, h->obj->verts.data(), h->obj->verts.size() * sizeof(float));
  std::memcpy(faces, h->obj->faces.data(), h->obj->faces.size() * sizeof(int32_t));
}

void *mcray_build_bvh(const float *tris, int t, int leaf_size, int *n_nodes) {
  auto *b = new Builder();
  b->tris = tris;
  b->leaf_size = std::max(1, leaf_size);
  b->boxes.resize(t);
  b->centroids.resize(t);
  for (int i = 0; i < t; ++i) {
    AABB box;
    for (int v = 0; v < 3; ++v) {
      Vec3 p{tris[9 * i + 3 * v], tris[9 * i + 3 * v + 1],
             tris[9 * i + 3 * v + 2]};
      box.grow(p);
    }
    b->boxes[i] = box;
    b->centroids[i] = {(box.lo.x + box.hi.x) * 0.5f,
                       (box.lo.y + box.hi.y) * 0.5f,
                       (box.lo.z + box.hi.z) * 0.5f};
  }
  std::vector<int32_t> idx(t);
  for (int i = 0; i < t; ++i) idx[i] = i;
  if (t > 0) {
    b->build(idx, 0, t);
  } else {
    b->out.nodes.assign(6, 0.f);
    b->out.meta = {0, 0};
  }
  *n_nodes = static_cast<int>(b->out.meta.size() / 2);
  auto *h = new Handle();
  h->bvh = new BvhData(std::move(b->out));
  delete b;
  return h;
}

void mcray_copy_bvh(void *handle, float *nodes, int32_t *meta, int32_t *order) {
  auto *h = static_cast<Handle *>(handle);
  std::memcpy(nodes, h->bvh->nodes.data(), h->bvh->nodes.size() * sizeof(float));
  std::memcpy(meta, h->bvh->meta.data(), h->bvh->meta.size() * sizeof(int32_t));
  std::memcpy(order, h->bvh->order.data(), h->bvh->order.size() * sizeof(int32_t));
}

void mcray_free(void *handle) {
  auto *h = static_cast<Handle *>(handle);
  delete h->obj;
  delete h->bvh;
  delete h;
}

} // extern "C"
