// Native ray-mesh intersector of the port: a median-split BVH over the
// triangles + Moller-Trumbore first-hit traversal, behind a plain C
// interface (ABI version 1), loaded with ctypes by
// alignnet3d_tpu_torch/data/mesh_raycast.py.
//
// The reference synthesizes LiDAR scans by casting ~288k rays per scene
// into ModelNet meshes through trimesh.ray_pyembree (Embree, C++) --
// reference tp_utils/pointcloud.py:1119-1138. This is the port's own copy
// of the JAX package's native/raycast.cpp, with the same algorithm and
// entry points; it is host code, built at first use by g++ (no nvcc):
//
//   g++ -O3 -fPIC -shared -std=c++17 raycast.cpp -o libalignnet3d_raycast_<hash>.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 sub(const Vec3& a, const Vec3& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
static inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
static inline float dot(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

struct AABB {
  Vec3 lo{1e30f, 1e30f, 1e30f};
  Vec3 hi{-1e30f, -1e30f, -1e30f};
  void grow(const Vec3& p) {
    lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y);
    lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y);
    hi.z = std::max(hi.z, p.z);
  }
  void grow(const AABB& b) { grow(b.lo); grow(b.hi); }
};

struct Node {
  AABB box;
  int32_t left = -1;    // internal: child index; leaf: first tri index
  int32_t count = 0;    // leaf triangle count (0 for internal nodes)
};

struct BVH {
  std::vector<Vec3> v0, e1, e2;     // triangle origin + edge vectors
  std::vector<Vec3> centroid;
  std::vector<int32_t> tri_order;
  std::vector<Node> nodes;

  void build(const float* vertices, const int32_t* faces, int64_t n_faces) {
    v0.resize(n_faces); e1.resize(n_faces); e2.resize(n_faces);
    centroid.resize(n_faces); tri_order.resize(n_faces);
    for (int64_t i = 0; i < n_faces; ++i) {
      const int32_t* f = faces + i * 3;
      Vec3 a{vertices[f[0] * 3], vertices[f[0] * 3 + 1], vertices[f[0] * 3 + 2]};
      Vec3 b{vertices[f[1] * 3], vertices[f[1] * 3 + 1], vertices[f[1] * 3 + 2]};
      Vec3 c{vertices[f[2] * 3], vertices[f[2] * 3 + 1], vertices[f[2] * 3 + 2]};
      v0[i] = a; e1[i] = sub(b, a); e2[i] = sub(c, a);
      centroid[i] = {(a.x + b.x + c.x) / 3, (a.y + b.y + c.y) / 3,
                     (a.z + b.z + c.z) / 3};
      tri_order[i] = static_cast<int32_t>(i);
    }
    nodes.clear();
    nodes.reserve(2 * n_faces);
    nodes.emplace_back();
    build_node(0, 0, static_cast<int32_t>(n_faces));
  }

  void build_node(int32_t node_idx, int32_t start, int32_t end) {
    Node& node = nodes[node_idx];
    AABB box;
    AABB cbox;
    for (int32_t i = start; i < end; ++i) {
      const int32_t t = tri_order[i];
      AABB tb;
      tb.grow(v0[t]);
      const Vec3 p1{v0[t].x + e1[t].x, v0[t].y + e1[t].y, v0[t].z + e1[t].z};
      const Vec3 p2{v0[t].x + e2[t].x, v0[t].y + e2[t].y, v0[t].z + e2[t].z};
      tb.grow(p1);
      tb.grow(p2);
      box.grow(tb);
      cbox.grow(centroid[t]);
    }
    node.box = box;
    const int32_t count = end - start;
    if (count <= 4) {
      node.left = start;
      node.count = count;
      return;
    }
    // split along the widest centroid axis at the median
    const float ex = cbox.hi.x - cbox.lo.x;
    const float ey = cbox.hi.y - cbox.lo.y;
    const float ez = cbox.hi.z - cbox.lo.z;
    int axis = 0;
    if (ey > ex && ey >= ez) axis = 1;
    else if (ez > ex && ez > ey) axis = 2;
    const int32_t mid = start + count / 2;
    std::nth_element(
        tri_order.begin() + start, tri_order.begin() + mid,
        tri_order.begin() + end, [&](int32_t a, int32_t b) {
          const Vec3& ca = centroid[a];
          const Vec3& cb = centroid[b];
          return (axis == 0 ? ca.x < cb.x : axis == 1 ? ca.y < cb.y
                                                      : ca.z < cb.z);
        });
    const int32_t left = static_cast<int32_t>(nodes.size());
    nodes.emplace_back();
    nodes.emplace_back();
    nodes[node_idx].left = left;
    nodes[node_idx].count = 0;
    build_node(left, start, mid);
    build_node(left + 1, mid, end);
  }

  static inline bool hit_box(const AABB& b, const Vec3& o, const Vec3& inv,
                             float tmax_limit) {
    float t1 = (b.lo.x - o.x) * inv.x, t2 = (b.hi.x - o.x) * inv.x;
    float tmin = std::min(t1, t2), tmax = std::max(t1, t2);
    t1 = (b.lo.y - o.y) * inv.y; t2 = (b.hi.y - o.y) * inv.y;
    tmin = std::max(tmin, std::min(t1, t2));
    tmax = std::min(tmax, std::max(t1, t2));
    t1 = (b.lo.z - o.z) * inv.z; t2 = (b.hi.z - o.z) * inv.z;
    tmin = std::max(tmin, std::min(t1, t2));
    tmax = std::min(tmax, std::max(t1, t2));
    return tmax >= std::max(tmin, 0.0f) && tmin <= tmax_limit;
  }

  // Moller-Trumbore; returns t or -1
  inline float hit_tri(int32_t t, const Vec3& o, const Vec3& d) const {
    const Vec3 p = cross(d, e2[t]);
    const float det = dot(e1[t], p);
    if (std::fabs(det) < 1e-12f) return -1.0f;
    const float inv_det = 1.0f / det;
    const Vec3 s = sub(o, v0[t]);
    const float u = dot(s, p) * inv_det;
    if (u < 0.0f || u > 1.0f) return -1.0f;
    const Vec3 q = cross(s, e1[t]);
    const float v = dot(d, q) * inv_det;
    if (v < 0.0f || u + v > 1.0f) return -1.0f;
    const float tt = dot(e2[t], q) * inv_det;
    return tt > 1e-6f ? tt : -1.0f;
  }

  float first_hit(const Vec3& o, const Vec3& d, float max_t) const {
    const Vec3 inv{1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
    float best = max_t;
    bool found = false;
    int32_t stack[64];
    int sp = 0;
    stack[sp++] = 0;
    while (sp) {
      const Node& node = nodes[stack[--sp]];
      if (!hit_box(node.box, o, inv, best)) continue;
      if (node.count > 0) {
        for (int32_t i = node.left; i < node.left + node.count; ++i) {
          const float t = hit_tri(tri_order[i], o, d);
          if (t > 0 && t < best) {
            best = t;
            found = true;
          }
        }
      } else {
        stack[sp++] = node.left;
        stack[sp++] = node.left + 1;
      }
    }
    return found ? best : -1.0f;
  }
};

}  // namespace

extern "C" {

// Build a BVH; returns an opaque handle.
void* raycast_build(const float* vertices, int64_t n_vertices,
                    const int32_t* faces, int64_t n_faces) {
  (void)n_vertices;
  auto* bvh = new BVH();
  bvh->build(vertices, faces, n_faces);
  return bvh;
}

void raycast_free(void* handle) { delete static_cast<BVH*>(handle); }

// First-hit of each origin+direction ray: out_t[i] = distance or -1.
void raycast_first_hits(void* handle, const float* origins,
                        const float* dirs, int64_t n_rays, float max_t,
                        float* out_t) {
  const BVH* bvh = static_cast<BVH*>(handle);
  for (int64_t i = 0; i < n_rays; ++i) {
    const Vec3 o{origins[i * 3], origins[i * 3 + 1], origins[i * 3 + 2]};
    const Vec3 d{dirs[i * 3], dirs[i * 3 + 1], dirs[i * 3 + 2]};
    out_t[i] = bvh->first_hit(o, d, max_t);
  }
}

int raycast_abi_version() { return 1; }

}  // extern "C"
