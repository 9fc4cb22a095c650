"""BVH: host-side builder (numpy) + device-side threaded traversal (JAX).

This is the device-side replacement for Embree (src/intersection.cpp:32,83;
BVH built at rtcCommitScene, scene.cpp:20-27). Design:

* Build (host, parse time — build speed is a non-goal, like the
  reference's RTC_BUILD_QUALITY_HIGH): Morton-sort primitive centroids,
  then a balanced median-split tree over the sorted order (LBVH-style
  topology), AABBs computed level-by-level with vectorized numpy. An
  optional C++ binned-SAH builder (csrc/) can replace the topology later;
  the array layout is shared.

* Layout (device): *threaded* (stackless) preorder. Each node stores
  lo/hi AABB, `first` (preorder child index for inner nodes, prim offset
  for leaves), `count` (0 = inner), and `skip` = preorder index of the
  node after its subtree. Traversal is then a single `while node < N`
  loop: advance to `first` on AABB hit (inner) or to `skip` otherwise —
  no per-lane stack, which is exactly what a lockstep vector machine
  wants. Early-out ordering loss vs. a near-child-first stack traversal
  is mitigated by the shrinking t_max in the AABB test.
"""

import numpy as np
import jax
import jax.numpy as jnp

from lajolla_tpu.ops.intersect import ray_triangle, INF

LEAF_SIZE = 4


# ---------------------------------------------------------------------------
# Host build
# ---------------------------------------------------------------------------

def _morton3(x, y, z):
    """Interleave 10-bit x,y,z → 30-bit Morton code (vectorized)."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v
    return spread(x) | (spread(y) << np.uint64(1)) | (spread(z) << np.uint64(2))


_LIBBVH = None


def _load_libbvh():
    """ctypes handle to the native binned-SAH builder (csrc/libbvh.so,
    not tracked: built from csrc/bvh_builder.cpp with `make -C csrc` on
    first use). Returns None, and says so once on stderr, when it cannot
    be built or loaded; build_bvh then uses the numpy Morton builder."""
    global _LIBBVH
    if _LIBBVH is not None:
        return _LIBBVH or None
    import ctypes
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    so = os.path.join(here, 'csrc', 'libbvh.so')
    if not os.path.exists(so):
        try:
            r = subprocess.run(['make', '-C', os.path.join(here, 'csrc')],
                               capture_output=True, text=True, timeout=120)
            why = r.stderr.strip()[-200:]
        except (OSError, subprocess.TimeoutExpired) as e:
            why = str(e)
        if not os.path.exists(so):
            print(f"bvh: building csrc/libbvh.so failed ({why}); using the "
                  "numpy Morton builder", file=sys.stderr)
            _LIBBVH = False
            return None
    try:
        lib = ctypes.CDLL(so)
        f = lib.bvh_build_sah
        f.restype = ctypes.c_int32
        f.argtypes = [ctypes.POINTER(ctypes.c_float),
                      ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                      ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
                      ctypes.POINTER(ctypes.c_float),
                      ctypes.POINTER(ctypes.c_float),
                      ctypes.POINTER(ctypes.c_int32),
                      ctypes.POINTER(ctypes.c_int32),
                      ctypes.POINTER(ctypes.c_int32)]
        _LIBBVH = lib
        return lib
    except OSError as e:
        print(f"bvh: loading csrc/libbvh.so failed ({e}); using the numpy "
              "Morton builder", file=sys.stderr)
        _LIBBVH = False
        return None


def _build_bvh_sah(tri_lo, tri_hi, leaf_size):
    """Native binned-SAH build → threaded layout (csrc/bvh_builder.cpp)."""
    import ctypes
    lib = _load_libbvh()
    if lib is None:
        return None
    T = tri_lo.shape[0]
    cap = 2 * T
    lo = np.ascontiguousarray(tri_lo, np.float32)
    hi = np.ascontiguousarray(tri_hi, np.float32)
    prim = np.zeros(T, np.int32)
    out_lo = np.zeros((cap, 3), np.float32)
    out_hi = np.zeros((cap, 3), np.float32)
    out_first = np.zeros(cap, np.int32)
    out_count = np.zeros(cap, np.int32)
    out_skip = np.zeros(cap, np.int32)
    fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    n = lib.bvh_build_sah(fptr(lo), fptr(hi), T, leaf_size, iptr(prim),
                          fptr(out_lo), fptr(out_hi), iptr(out_first),
                          iptr(out_count), iptr(out_skip))
    return dict(lo=out_lo[:n], hi=out_hi[:n], first=out_first[:n],
                count=out_count[:n], skip=out_skip[:n], prim=prim,
                n_nodes=int(n))


def build_bvh(tri_lo, tri_hi, leaf_size=LEAF_SIZE):
    """Returns dict of numpy arrays: lo (N,3), hi (N,3), first (N,),
    count (N,), skip (N,), prim (T,) — the preorder threaded layout.
    Prefers the native SAH builder; falls back to the Morton median-split
    builder below."""
    T = tri_lo.shape[0]
    if T > 0:
        sah = _build_bvh_sah(np.asarray(tri_lo, np.float32),
                             np.asarray(tri_hi, np.float32), leaf_size)
        if sah is not None:
            return sah
    if T == 0:
        return dict(lo=np.zeros((1, 3), np.float32),
                    hi=np.zeros((1, 3), np.float32),
                    first=np.zeros(1, np.int32), count=np.zeros(1, np.int32),
                    skip=np.ones(1, np.int32), prim=np.zeros(0, np.int32),
                    n_nodes=1)

    centers = 0.5 * (tri_lo + tri_hi)
    cmin, cmax = centers.min(0), centers.max(0)
    ext = np.maximum(cmax - cmin, 1e-12)
    q = np.clip(((centers - cmin) / ext) * 1023.0, 0, 1023).astype(np.uint32)
    codes = _morton3(q[:, 0], q[:, 1], q[:, 2])
    order = np.argsort(codes, kind='stable').astype(np.int32)
    lo_s, hi_s = tri_lo[order], tri_hi[order]

    # --- topology: median split over sorted order, BFS ---------------------
    starts = [0]
    ends = [T]
    left = [-1]
    levels = [[0]]
    while True:
        cur = levels[-1]
        nxt = []
        for n in cur:
            if ends[n] - starts[n] > leaf_size:
                mid = (starts[n] + ends[n]) // 2
                l = len(starts)
                left[n] = l
                starts += [starts[n], mid]
                ends += [mid, ends[n]]
                left += [-1, -1]
                nxt += [l, l + 1]
        if not nxt:
            break
        levels.append(nxt)

    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    left = np.asarray(left, np.int64)
    N = len(starts)
    is_leaf = left < 0

    # --- AABBs --------------------------------------------------------------
    # The full set of leaves tiles [0, T) in sorted order, so one global
    # reduceat computes every leaf AABB; inner nodes then union their
    # children level-by-level bottom-up.
    lo_n = np.empty((N, 3), np.float64)
    hi_n = np.empty((N, 3), np.float64)
    leaf_ids = np.nonzero(is_leaf)[0]
    srt = leaf_ids[np.argsort(starts[leaf_ids])]
    lo_n[srt] = np.minimum.reduceat(lo_s, starts[srt])
    hi_n[srt] = np.maximum.reduceat(hi_s, starts[srt])
    for lvl in levels[::-1]:
        lvl = np.asarray(lvl)
        inner_ids = lvl[~is_leaf[lvl]]
        if inner_ids.size:
            l = left[inner_ids]
            lo_n[inner_ids] = np.minimum(lo_n[l], lo_n[l + 1])
            hi_n[inner_ids] = np.maximum(hi_n[l], hi_n[l + 1])

    # --- preorder threading --------------------------------------------------
    size = np.ones(N, np.int64)
    for lvl in levels[::-1]:
        lvl = np.asarray(lvl)
        inner_ids = lvl[~is_leaf[lvl]]
        if inner_ids.size:
            l = left[inner_ids]
            size[inner_ids] = 1 + size[l] + size[l + 1]
    pre = np.zeros(N, np.int64)
    for lvl in levels:
        lvl = np.asarray(lvl)
        inner_ids = lvl[~is_leaf[lvl]]
        if inner_ids.size:
            l = left[inner_ids]
            pre[l] = pre[inner_ids] + 1
            pre[l + 1] = pre[inner_ids] + 1 + size[l]

    out_lo = np.empty((N, 3), np.float32)
    out_hi = np.empty((N, 3), np.float32)
    out_first = np.empty(N, np.int32)
    out_count = np.empty(N, np.int32)
    out_skip = np.empty(N, np.int32)
    out_lo[pre] = lo_n.astype(np.float32)
    out_hi[pre] = hi_n.astype(np.float32)
    out_first[pre] = np.where(is_leaf, starts, pre[np.maximum(left, 0)]).astype(np.int32)
    out_count[pre] = np.where(is_leaf, ends - starts, 0).astype(np.int32)
    out_skip[pre] = (pre + size).astype(np.int32)

    return dict(lo=out_lo, hi=out_hi, first=out_first, count=out_count,
                skip=out_skip, prim=order, n_nodes=N)


# ---------------------------------------------------------------------------
# Device traversal (per-ray; callers vmap)
# ---------------------------------------------------------------------------

def _safe_inv(d):
    tiny = 1e-12
    return jnp.where(jnp.abs(d) > tiny, 1.0 / jnp.where(jnp.abs(d) > tiny, d, 1.0),
                     jnp.where(d >= 0, 1e12, -1e12))


def bvh_traverse(scene, o, d, tnear, tfar):
    """Closest-hit traversal. Returns (t, prim_id, u, v); prim_id=-1 miss.

    One wide-row gather per node visit (bvh_node) and per tested leaf
    triangle (bvh_leaf_tri, stored in leaf order so a leaf's triangles
    are consecutive rows) — the access pattern that survives vmapping to
    a 262k-lane wavefront."""
    n_nodes = scene.bvh_node.shape[0]
    max_slot = scene.bvh_leaf_tri.shape[0] - 1
    inv_d = _safe_inv(d)

    def cond(st):
        return st[0] < n_nodes

    def body(st):
        node, t_best, best_prim, best_u, best_v = st
        row = scene.bvh_node[node]
        lo, hi = row[0:3], row[3:6]
        first = row[6].astype(jnp.int32)
        count = row[7].astype(jnp.int32)
        skip = row[8].astype(jnp.int32)
        t0 = (lo - o) * inv_d
        t1 = (hi - o) * inv_d
        tmin = jnp.maximum(jnp.max(jnp.minimum(t0, t1)), tnear)
        tmax = jnp.minimum(jnp.min(jnp.maximum(t0, t1)), t_best)
        hit_box = tmin <= tmax
        is_leaf = count > 0
        test = hit_box & is_leaf
        for k in range(LEAF_SIZE):
            slot = jnp.minimum(first + k, max_slot)
            trow = scene.bvh_leaf_tri[slot]
            t, u, v, h = ray_triangle(o, d, trow[0:3], trow[3:6], trow[6:9],
                                      tnear, t_best)
            h = h & test & (k < count)
            t_best = jnp.where(h, t, t_best)
            best_prim = jnp.where(h, trow[9].astype(jnp.int32), best_prim)
            best_u = jnp.where(h, u, best_u)
            best_v = jnp.where(h, v, best_v)
        nxt = jnp.where(hit_box & ~is_leaf, first, skip)
        return (nxt, t_best, best_prim, best_u, best_v)

    init = (jnp.int32(0), jnp.minimum(tfar, INF), jnp.int32(-1),
            jnp.float32(0), jnp.float32(0))
    _, t_best, prim, u, v = jax.lax.while_loop(cond, body, init)
    miss = prim < 0
    return jnp.where(miss, INF, t_best), prim, u, v


def bvh_occluded(scene, o, d, tnear, tfar):
    """Any-hit traversal with early exit. Returns bool."""
    n_nodes = scene.bvh_node.shape[0]
    max_slot = scene.bvh_leaf_tri.shape[0] - 1
    inv_d = _safe_inv(d)

    def cond(st):
        node, found = st
        return (node < n_nodes) & ~found

    def body(st):
        node, found = st
        row = scene.bvh_node[node]
        lo, hi = row[0:3], row[3:6]
        first = row[6].astype(jnp.int32)
        count = row[7].astype(jnp.int32)
        skip = row[8].astype(jnp.int32)
        t0 = (lo - o) * inv_d
        t1 = (hi - o) * inv_d
        tmin = jnp.maximum(jnp.max(jnp.minimum(t0, t1)), tnear)
        tmax = jnp.minimum(jnp.min(jnp.maximum(t0, t1)), tfar)
        hit_box = tmin <= tmax
        is_leaf = count > 0
        test = hit_box & is_leaf
        for k in range(LEAF_SIZE):
            slot = jnp.minimum(first + k, max_slot)
            trow = scene.bvh_leaf_tri[slot]
            _, _, _, h = ray_triangle(o, d, trow[0:3], trow[3:6], trow[6:9],
                                      tnear, tfar)
            found = found | (h & test & (k < count))
        nxt = jnp.where(hit_box & ~is_leaf, first, skip)
        return (nxt, found)

    _, found = jax.lax.while_loop(cond, body, (jnp.int32(0), jnp.bool_(False)))
    return found
