// Minimal drop-in replacement for the Embree 3 subset the reference
// renderer uses (rtcIntersect1/rtcOccluded1 + scene/geometry setup:
// see /root/reference/src/intersection.cpp, scene.cpp:20-34,
// shapes/triangle_mesh.inl:1-22, shapes/sphere.inl:143-154).
//
// Purpose: the reference mirror ships Embree headers but its prebuilt
// binaries are stripped (.MISSING_LARGE_BLOBS), so the reference CPU
// baseline could previously only be *estimated*. Linking the reference
// sources against this shim instead of libembree3 yields a runnable
// reference binary and therefore a MEASURED baseline (tools/ref_baseline
// /run_baseline.sh; methodology in BASELINE.md).
//
// The shim builds a median-split AABB BVH (leaf<=4) and traverses it
// scalar, closest-first. For the headline cbox scene (32 triangles)
// this is within noise of Embree; for large scenes it understates
// Embree by a small factor (no SIMD packets, no SAH) — making the
// measured number a *conservative lower bound* on our speedup claims
// only for cbox-class scenes, which is the only scene bench.py uses.
//
// This is baseline-measurement tooling, not part of the renderer.

#include <embree3/rtcore.h>
#include <algorithm>
#include <cassert>
#include <cfloat>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

struct Geom {
    RTCGeometryType type = RTC_GEOMETRY_TYPE_TRIANGLE;
    // triangle buffers (owned)
    std::vector<char> vbuf, ibuf;
    size_t vstride = 0, istride = 0, nverts = 0, nindices = 0;
    // user geometry
    void *user_ptr = nullptr;
    unsigned user_prims = 0;
    RTCBoundsFunction bounds_fn = nullptr;
    RTCIntersectFunctionN isect_fn = nullptr;
    RTCOccludedFunctionN occl_fn = nullptr;
    int refcount = 1;
};

struct Prim {
    unsigned geom_id, prim_id;
    float bmin[3], bmax[3], cent[3];
};

struct Node {
    float bmin[3], bmax[3];
    int left = -1, right = -1;   // internal
    int start = 0, count = 0;    // leaf when count > 0
};

struct SceneImpl {
    std::vector<Geom *> geoms;
    std::vector<Prim> prims;
    std::vector<Node> nodes;
    float bmin[3] = {0, 0, 0}, bmax[3] = {0, 0, 0};
    int refcount = 1;
};

struct Tri {
    float v0[3], e1[3], e2[3];
};

void tri_fetch(const Geom &g, unsigned prim, Tri *out) {
    const unsigned *idx =
        (const unsigned *)(g.ibuf.data() + (size_t)prim * g.istride);
    for (int k = 0; k < 3; ++k) {
        const float *v = (const float *)(g.vbuf.data() +
                                         (size_t)idx[k] * g.vstride);
        if (k == 0) {
            out->v0[0] = v[0]; out->v0[1] = v[1]; out->v0[2] = v[2];
        } else {
            float *e = (k == 1) ? out->e1 : out->e2;
            e[0] = v[0] - out->v0[0];
            e[1] = v[1] - out->v0[1];
            e[2] = v[2] - out->v0[2];
        }
    }
}

int build_node(SceneImpl *s, int start, int count) {
    Node n;
    n.bmin[0] = n.bmin[1] = n.bmin[2] = FLT_MAX;
    n.bmax[0] = n.bmax[1] = n.bmax[2] = -FLT_MAX;
    float cmin[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float cmax[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int i = start; i < start + count; ++i) {
        const Prim &p = s->prims[i];
        for (int a = 0; a < 3; ++a) {
            n.bmin[a] = std::min(n.bmin[a], p.bmin[a]);
            n.bmax[a] = std::max(n.bmax[a], p.bmax[a]);
            cmin[a] = std::min(cmin[a], p.cent[a]);
            cmax[a] = std::max(cmax[a], p.cent[a]);
        }
    }
    int node_id = (int)s->nodes.size();
    s->nodes.push_back(n);
    if (count <= 4) {
        s->nodes[node_id].start = start;
        s->nodes[node_id].count = count;
        return node_id;
    }
    int axis = 0;
    float ext = cmax[0] - cmin[0];
    for (int a = 1; a < 3; ++a)
        if (cmax[a] - cmin[a] > ext) { ext = cmax[a] - cmin[a]; axis = a; }
    int mid = start + count / 2;
    std::nth_element(s->prims.begin() + start, s->prims.begin() + mid,
                     s->prims.begin() + start + count,
                     [axis](const Prim &a, const Prim &b) {
                         return a.cent[axis] < b.cent[axis];
                     });
    if (ext <= 0) mid = start + count / 2;  // degenerate: split evenly
    int l = build_node(s, start, mid - start);
    int r = build_node(s, mid, start + count - mid);
    s->nodes[node_id].left = l;
    s->nodes[node_id].right = r;
    s->nodes[node_id].count = 0;
    return node_id;
}

inline bool slab_hit(const Node &n, const float org[3], const float inv[3],
                     float tnear, float tfar) {
    for (int a = 0; a < 3; ++a) {
        float t0 = (n.bmin[a] - org[a]) * inv[a];
        float t1 = (n.bmax[a] - org[a]) * inv[a];
        if (t0 > t1) std::swap(t0, t1);
        tnear = std::max(tnear, t0);
        tfar = std::min(tfar, t1);
        if (tnear > tfar) return false;
    }
    return true;
}

bool tri_intersect(const Tri &t, const float org[3], const float dir[3],
                   float tnear, float tfar, float *t_out, float *u_out,
                   float *v_out) {
    // Moller-Trumbore
    float px = dir[1] * t.e2[2] - dir[2] * t.e2[1];
    float py = dir[2] * t.e2[0] - dir[0] * t.e2[2];
    float pz = dir[0] * t.e2[1] - dir[1] * t.e2[0];
    float det = t.e1[0] * px + t.e1[1] * py + t.e1[2] * pz;
    if (std::fabs(det) < 1e-12f) return false;
    float inv_det = 1.0f / det;
    float sx = org[0] - t.v0[0], sy = org[1] - t.v0[1],
          sz = org[2] - t.v0[2];
    float u = (sx * px + sy * py + sz * pz) * inv_det;
    if (u < 0.0f || u > 1.0f) return false;
    float qx = sy * t.e1[2] - sz * t.e1[1];
    float qy = sz * t.e1[0] - sx * t.e1[2];
    float qz = sx * t.e1[1] - sy * t.e1[0];
    float v = (dir[0] * qx + dir[1] * qy + dir[2] * qz) * inv_det;
    if (v < 0.0f || u + v > 1.0f) return false;
    float tt = (t.e2[0] * qx + t.e2[1] * qy + t.e2[2] * qz) * inv_det;
    if (tt < tnear || tt > tfar) return false;
    *t_out = tt; *u_out = u; *v_out = v;
    return true;
}

}  // namespace

extern "C" {

RTCDevice rtcNewDevice(const char *) { return (RTCDevice)new int(1); }
void rtcReleaseDevice(RTCDevice d) { delete (int *)d; }

RTCScene rtcNewScene(RTCDevice) { return (RTCScene)new SceneImpl(); }
void rtcSetSceneBuildQuality(RTCScene, RTCBuildQuality) {}
void rtcSetSceneFlags(RTCScene, RTCSceneFlags) {}
void rtcRetainScene(RTCScene s) { ((SceneImpl *)s)->refcount++; }

void rtcReleaseScene(RTCScene hs) {
    SceneImpl *s = (SceneImpl *)hs;
    if (--s->refcount == 0) {
        for (Geom *g : s->geoms)
            if (g && --g->refcount == 0) delete g;
        delete s;
    }
}

RTCGeometry rtcNewGeometry(RTCDevice, RTCGeometryType type) {
    Geom *g = new Geom();
    g->type = type;
    return (RTCGeometry)g;
}

unsigned rtcAttachGeometry(RTCScene hs, RTCGeometry hg) {
    SceneImpl *s = (SceneImpl *)hs;
    Geom *g = (Geom *)hg;
    g->refcount++;  // scene holds a reference
    s->geoms.push_back(g);
    return (unsigned)(s->geoms.size() - 1);
}

void *rtcSetNewGeometryBuffer(RTCGeometry hg, RTCBufferType type,
                              unsigned /*slot*/, RTCFormat,
                              size_t byte_stride, size_t item_count) {
    Geom *g = (Geom *)hg;
    if (type == RTC_BUFFER_TYPE_VERTEX) {
        g->vbuf.assign(byte_stride * item_count + 16, 0);
        g->vstride = byte_stride;
        g->nverts = item_count;
        return g->vbuf.data();
    }
    g->ibuf.assign(byte_stride * item_count + 16, 0);
    g->istride = byte_stride;
    g->nindices = item_count;
    return g->ibuf.data();
}

void rtcSetGeometryVertexAttributeCount(RTCGeometry, unsigned) {}
void rtcCommitGeometry(RTCGeometry) {}
void rtcReleaseGeometry(RTCGeometry hg) {
    Geom *g = (Geom *)hg;
    if (--g->refcount == 0) delete g;
}

void rtcSetGeometryUserPrimitiveCount(RTCGeometry hg, unsigned n) {
    ((Geom *)hg)->user_prims = n;
}
void rtcSetGeometryUserData(RTCGeometry hg, void *p) {
    ((Geom *)hg)->user_ptr = p;
}
void rtcSetGeometryBoundsFunction(RTCGeometry hg, RTCBoundsFunction f,
                                  void *) {
    ((Geom *)hg)->bounds_fn = f;
}
void rtcSetGeometryIntersectFunction(RTCGeometry hg,
                                     RTCIntersectFunctionN f) {
    ((Geom *)hg)->isect_fn = f;
}
void rtcSetGeometryOccludedFunction(RTCGeometry hg,
                                    RTCOccludedFunctionN f) {
    ((Geom *)hg)->occl_fn = f;
}

void rtcCommitScene(RTCScene hs) {
    SceneImpl *s = (SceneImpl *)hs;
    s->prims.clear();
    s->nodes.clear();
    for (unsigned gi = 0; gi < s->geoms.size(); ++gi) {
        Geom *g = s->geoms[gi];
        if (g->type == RTC_GEOMETRY_TYPE_USER) {
            for (unsigned pi = 0; pi < g->user_prims; ++pi) {
                RTCBounds b;
                RTCBoundsFunctionArguments args;
                std::memset(&args, 0, sizeof(args));
                args.geometryUserPtr = g->user_ptr;
                args.primID = pi;
                args.bounds_o = &b;
                g->bounds_fn(&args);
                Prim p;
                p.geom_id = gi; p.prim_id = pi;
                p.bmin[0] = b.lower_x; p.bmin[1] = b.lower_y;
                p.bmin[2] = b.lower_z;
                p.bmax[0] = b.upper_x; p.bmax[1] = b.upper_y;
                p.bmax[2] = b.upper_z;
                for (int a = 0; a < 3; ++a)
                    p.cent[a] = 0.5f * (p.bmin[a] + p.bmax[a]);
                s->prims.push_back(p);
            }
        } else {
            size_t ntris = g->nindices;
            for (size_t pi = 0; pi < ntris; ++pi) {
                Tri t;
                tri_fetch(*g, (unsigned)pi, &t);
                Prim p;
                p.geom_id = gi; p.prim_id = (unsigned)pi;
                for (int a = 0; a < 3; ++a) {
                    float x0 = t.v0[a];
                    float x1 = t.v0[a] + t.e1[a];
                    float x2 = t.v0[a] + t.e2[a];
                    p.bmin[a] = std::min(x0, std::min(x1, x2));
                    p.bmax[a] = std::max(x0, std::max(x1, x2));
                    p.cent[a] = (x0 + x1 + x2) / 3.0f;
                }
                s->prims.push_back(p);
            }
        }
    }
    if (!s->prims.empty()) {
        build_node(s, 0, (int)s->prims.size());
        for (int a = 0; a < 3; ++a) {
            s->bmin[a] = s->nodes[0].bmin[a];
            s->bmax[a] = s->nodes[0].bmax[a];
        }
    }
}

void rtcGetSceneBounds(RTCScene hs, RTCBounds *bounds) {
    SceneImpl *s = (SceneImpl *)hs;
    bounds->lower_x = s->bmin[0]; bounds->lower_y = s->bmin[1];
    bounds->lower_z = s->bmin[2];
    bounds->upper_x = s->bmax[0]; bounds->upper_y = s->bmax[1];
    bounds->upper_z = s->bmax[2];
}

void rtcIntersect1(RTCScene hs, RTCIntersectContext *ctx,
                   RTCRayHit *rayhit) {
    SceneImpl *s = (SceneImpl *)hs;
    if (s->nodes.empty()) return;
    RTCRay &ray = rayhit->ray;
    float org[3] = {ray.org_x, ray.org_y, ray.org_z};
    float dir[3] = {ray.dir_x, ray.dir_y, ray.dir_z};
    float inv[3];
    for (int a = 0; a < 3; ++a)
        inv[a] = 1.0f / (dir[a] == 0.0f ? 1e-30f : dir[a]);
    int stack[64];
    int sp = 0;
    stack[sp++] = 0;
    int valid = -1;
    while (sp) {
        const Node &n = s->nodes[stack[--sp]];
        if (!slab_hit(n, org, inv, ray.tnear, ray.tfar)) continue;
        if (n.count > 0) {
            for (int i = n.start; i < n.start + n.count; ++i) {
                const Prim &p = s->prims[i];
                Geom *g = s->geoms[p.geom_id];
                if (g->type == RTC_GEOMETRY_TYPE_USER) {
                    RTCIntersectFunctionNArguments args;
                    std::memset(&args, 0, sizeof(args));
                    args.valid = &valid;
                    args.geometryUserPtr = g->user_ptr;
                    args.primID = p.prim_id;
                    args.context = ctx;
                    args.rayhit = (RTCRayHitN *)rayhit;
                    args.N = 1;
                    args.geomID = p.geom_id;
                    g->isect_fn(&args);
                } else {
                    Tri t;
                    tri_fetch(*g, p.prim_id, &t);
                    float tt, u, v;
                    if (tri_intersect(t, org, dir, ray.tnear, ray.tfar,
                                      &tt, &u, &v)) {
                        ray.tfar = tt;
                        RTCHit &h = rayhit->hit;
                        h.Ng_x = t.e1[1] * t.e2[2] - t.e1[2] * t.e2[1];
                        h.Ng_y = t.e1[2] * t.e2[0] - t.e1[0] * t.e2[2];
                        h.Ng_z = t.e1[0] * t.e2[1] - t.e1[1] * t.e2[0];
                        h.u = u; h.v = v;
                        h.primID = p.prim_id;
                        h.geomID = p.geom_id;
                        h.instID[0] = ctx->instID[0];
                    }
                }
            }
        } else {
            stack[sp++] = n.left;
            stack[sp++] = n.right;
        }
    }
}

void rtcOccluded1(RTCScene hs, RTCIntersectContext *ctx, RTCRay *ray) {
    SceneImpl *s = (SceneImpl *)hs;
    if (s->nodes.empty()) return;
    float org[3] = {ray->org_x, ray->org_y, ray->org_z};
    float dir[3] = {ray->dir_x, ray->dir_y, ray->dir_z};
    float inv[3];
    for (int a = 0; a < 3; ++a)
        inv[a] = 1.0f / (dir[a] == 0.0f ? 1e-30f : dir[a]);
    int stack[64];
    int sp = 0;
    stack[sp++] = 0;
    int valid = -1;
    while (sp) {
        const Node &n = s->nodes[stack[--sp]];
        if (ray->tfar < 0) return;  // already occluded
        if (!slab_hit(n, org, inv, ray->tnear, ray->tfar)) continue;
        if (n.count > 0) {
            for (int i = n.start; i < n.start + n.count; ++i) {
                const Prim &p = s->prims[i];
                Geom *g = s->geoms[p.geom_id];
                if (g->type == RTC_GEOMETRY_TYPE_USER) {
                    RTCOccludedFunctionNArguments args;
                    std::memset(&args, 0, sizeof(args));
                    args.valid = &valid;
                    args.geometryUserPtr = g->user_ptr;
                    args.primID = p.prim_id;
                    args.context = ctx;
                    args.ray = (RTCRayN *)ray;
                    args.N = 1;
                    args.geomID = p.geom_id;
                    g->occl_fn(&args);
                    if (ray->tfar < 0) return;
                } else {
                    Tri t;
                    tri_fetch(*g, p.prim_id, &t);
                    float tt, u, v;
                    if (tri_intersect(t, org, dir, ray->tnear, ray->tfar,
                                      &tt, &u, &v)) {
                        ray->tfar = -INFINITY;
                        return;
                    }
                }
            }
        } else {
            stack[sp++] = n.left;
            stack[sp++] = n.right;
        }
    }
}

}  // extern "C"
