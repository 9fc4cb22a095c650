"""Binned two-level intersector for large scenes.

Per-lane BVH traversal is gather-bound and lockstep-divergent on a
vector machine. This intersector re-casts
ray casting as dense compute over a flat two-level hierarchy:

  build:  cut the SAH tree into treelets ("clusters") of <= C triangles;
          store per-cluster AABBs and dense Woop transform blocks.
  phase A: slab-test every ray against every cluster AABB — a dense
          (N, K) elementwise pass (per-axis unrolled; never materialize
          an (N, K, 3) tensor — a minor dimension of 3 pads badly on
          vector hardware).
  phase B: ordered rounds. Each round, every ray takes its nearest
          unvisited cluster (argmin over the (N, K) entry distances),
          fetches that cluster's triangle block with ONE wide gather,
          and intersects all C triangles as a dense batched matvec.
          Rays whose best hit is already closer than their next
          cluster's entry distance stop contributing — the while_loop
          ends when no ray can improve, giving front-to-back early
          termination without any stack or per-lane control flow.

Everything is static-shaped; rounds are bounded by MAX_ROUNDS.
"""

import numpy as np
import jax
import jax.numpy as jnp

INF = np.float32(np.inf)

CLUSTER_TRIS = 256       # C (compile_scene passes 128)
MAX_ROUNDS = 256          # safety bound on ordered rounds


# ---------------------------------------------------------------------------
# Host build: cut the threaded SAH tree into treelets
# ---------------------------------------------------------------------------

def build_clusters(bvh, tri_p0, tri_e1, tri_e2, max_tris=CLUSTER_TRIS):
    """bvh: threaded arrays from ops.bvh.build_bvh (preorder, skip links).
    Returns dict with cl_lo/cl_hi (K,3), cl_A (K,3,3C), cl_b (K,3C),
    cl_prim (K,C) int32 (-1 pad), n_clusters."""
    first = bvh['first']
    count = bvh['count']
    skip = bvh['skip']
    lo = bvh['lo']
    hi = bvh['hi']
    prim = bvh['prim']
    n = len(first)

    # subtree prim ranges are contiguous in leaf order
    clusters = []

    def subtree_prims(i):
        j = skip[i]
        f = first[i:j]
        c = count[i:j]
        leaf = c > 0
        s = int(f[leaf].min())
        e = int((f[leaf] + c[leaf]).max())
        return s, e - s

    i = 0
    while i < n:
        s, c = subtree_prims(i)
        if c <= max_tris:
            clusters.append((i, s, c))
            i = skip[i]
        else:
            i += 1

    K = len(clusters)
    C = max_tris
    cl_lo = np.zeros((K, 3), np.float32)
    cl_hi = np.zeros((K, 3), np.float32)
    cl_A = np.zeros((K, 3, 3 * C), np.float32)
    cl_b = np.zeros((K, 3 * C), np.float32)
    cl_prim = np.full((K, C), -1, np.int32)

    for ci, (node, s, c) in enumerate(clusters):
        cl_lo[ci] = lo[node]
        cl_hi[ci] = hi[node]
        tri_ids = prim[s:s + c]
        cl_prim[ci, :c] = tri_ids
        p0 = tri_p0[tri_ids]
        e1 = tri_e1[tri_ids]
        e2 = tri_e2[tri_ids]
        nvec = np.cross(e1, e2)
        M = np.stack([e1, e2, nvec], axis=-1)
        dets = np.linalg.det(M)
        ok = np.abs(dets) > 1e-18
        Minv = np.zeros_like(M)
        if ok.any():
            Minv[ok] = np.linalg.inv(M[ok])
        bvec = -np.einsum('tij,tj->ti', Minv, p0)
        for axis in range(3):
            cl_A[ci, :, axis * C:axis * C + c] = Minv[:, axis, :].T
            cl_b[ci, axis * C:axis * C + c] = bvec[:, axis]
    return dict(cl_lo=cl_lo, cl_hi=cl_hi, cl_A=cl_A, cl_b=cl_b,
                cl_prim=cl_prim, n_clusters=K)


# ---------------------------------------------------------------------------
# Device query
# ---------------------------------------------------------------------------

def _cluster_entry(scene, o, d, tnear, tfar):
    """(N,) rays → (N, K) cluster AABB entry distances (INF = miss).
    Per-axis unrolled; all intermediates (N, K)."""
    safe = jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
    inv = 1.0 / safe
    tmin = jnp.broadcast_to(tnear[:, None], (o.shape[0],
                                             scene.cl_lo.shape[0]))
    tmax = jnp.broadcast_to(tfar[:, None], tmin.shape)
    for ax in range(3):
        t0 = (scene.cl_lo[None, :, ax] - o[:, ax, None]) * inv[:, ax, None]
        t1 = (scene.cl_hi[None, :, ax] - o[:, ax, None]) * inv[:, ax, None]
        tmin = jnp.maximum(tmin, jnp.minimum(t0, t1))
        tmax = jnp.minimum(tmax, jnp.maximum(t0, t1))
    return jnp.where(tmin <= tmax, tmin, INF)


def _round(scene, o, d, tnear, tfar, st, any_hit):
    """One ordered round: nearest unvisited cluster per ray, dense test."""
    entry, best_t, best_prim, best_u, best_v = st
    N = o.shape[0]
    C = scene.cl_prim.shape[1]
    rows = jnp.arange(N)

    cid = jnp.argmin(entry, axis=1)                    # (N,)
    t_ent = entry[rows, cid]
    live = t_ent < best_t                              # can still improve
    entry = entry.at[rows, cid].set(INF)               # consume

    A = scene.cl_A[cid]                                # (N, 3, 3C)
    bvec = scene.cl_b[cid]                             # (N, 3C)
    prims = scene.cl_prim[cid]                         # (N, C)
    hp = jax.lax.Precision.HIGHEST
    op_ = jnp.einsum('ni,nij->nj', o, A, precision=hp) + bvec
    dp_ = jnp.einsum('ni,nij->nj', d, A, precision=hp)
    ox, oy, oz = op_[:, :C], op_[:, C:2 * C], op_[:, 2 * C:]
    dx, dy, dz = dp_[:, :C], dp_[:, C:2 * C], dp_[:, 2 * C:]
    safe_dz = jnp.where(jnp.abs(dz) > 1e-12, dz, 1.0)
    t = -oz / safe_dz
    u = ox + t * dx
    v = oy + t * dy
    hit = ((jnp.abs(dz) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1) &
           (t > tnear[:, None]) & (t < jnp.minimum(tfar, best_t)[:, None]) &
           (prims >= 0) & live[:, None])
    t = jnp.where(hit, t, INF)
    j = jnp.argmin(t, axis=1)
    t_new = t[rows, j]
    better = t_new < best_t
    best_t = jnp.where(better, t_new, best_t)
    best_prim = jnp.where(better, prims[rows, j], best_prim)
    best_u = jnp.where(better, u[rows, j], best_u)
    best_v = jnp.where(better, v[rows, j], best_v)
    return (entry, best_t, best_prim, best_u, best_v)


def _query(scene, o, d, tnear, tfar, any_hit):
    N = o.shape[0]
    entry = _cluster_entry(scene, o, d, tnear, tfar)
    st = (entry, jnp.minimum(tfar, INF), jnp.full(N, -1, jnp.int32),
          jnp.zeros(N), jnp.zeros(N))

    def cond(carry):
        it, st = carry
        entry, best_t, best_prim, _, _ = st
        improvable = jnp.min(entry, axis=1) < best_t
        if any_hit:
            improvable = improvable & (best_prim < 0)
        return (it < MAX_ROUNDS) & jnp.any(improvable)

    def body(carry):
        it, st = carry
        return (it + 1, _round(scene, o, d, tnear, tfar, st, any_hit))

    _, st = jax.lax.while_loop(cond, body, (jnp.int32(0), st))
    entry, best_t, best_prim, best_u, best_v = st
    miss = best_prim < 0
    return (jnp.where(miss, INF, best_t), best_prim, best_u, best_v)


# The ordered-rounds loop is lockstep per chunk: it runs until EVERY ray
# in the chunk is finished, so chunk size trades per-launch overhead
# against tail waste from the slowest ray. Not yet measured on the GPU
# (ROADMAP Design 2).
RAY_CHUNK = 1024


def _chunked(scene, o, d, tnear, tfar, any_hit):
    N = o.shape[0]
    if N <= RAY_CHUNK:
        return _query(scene, o, d, tnear, tfar, any_hit)
    nchunk = -(-N // RAY_CHUNK)
    pad = nchunk * RAY_CHUNK - N
    o = jnp.pad(o, ((0, pad), (0, 0)))
    d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    tnear = jnp.pad(tnear, (0, pad))
    tfar = jnp.pad(tfar, (0, pad), constant_values=-1.0)
    out = jax.lax.map(
        lambda args: _query(scene, *args, any_hit),
        (o.reshape(nchunk, RAY_CHUNK, 3), d.reshape(nchunk, RAY_CHUNK, 3),
         tnear.reshape(nchunk, RAY_CHUNK), tfar.reshape(nchunk, RAY_CHUNK)))
    return tuple(x.reshape(nchunk * RAY_CHUNK, *x.shape[2:])[:N]
                 for x in out)


def intersect_binned(scene, o, d, tnear, tfar):
    """Batched closest hit. Returns (t, prim, u, v) each (N,)."""
    return _chunked(scene, o, d, tnear, tfar, any_hit=False)


def occluded_binned(scene, o, d, tnear, tfar):
    """Any-hit variant (stops a ray's rounds at its first hit)."""
    _, prim, _, _ = _chunked(scene, o, d, tnear, tfar, any_hit=True)
    return prim >= 0
