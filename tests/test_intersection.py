"""Intersection tests (reference analogue: tests/intersection.cpp) plus
BVH-vs-brute-force equivalence on random meshes."""

import jax
import jax.numpy as jnp
import numpy as np

from lajolla_tpu.ops.bvh import build_bvh, bvh_traverse, bvh_occluded
from lajolla_tpu.ops.intersect import ray_triangle, ray_sphere


def test_single_triangle():
    # the reference's fixture: triangle {(-1,-1,-2),(1,-1,-2),(0,1,-2)},
    # ray from origin towards -z (tests/intersection.cpp:9-40)
    p0 = jnp.array([-1.0, -1.0, -2.0])
    e1 = jnp.array([1.0, -1.0, -2.0]) - p0
    e2 = jnp.array([0.0, 1.0, -2.0]) - p0
    o = jnp.zeros(3)
    d = jnp.array([0.0, 0.0, -1.0])
    t, u, v, hit = ray_triangle(o, d, p0, e1, e2, 0.0, jnp.inf)
    assert bool(hit)
    pos = o + t * d
    assert np.allclose(pos, [0, 0, -2], atol=1e-6)


def test_sphere_roots():
    o = jnp.array([0.0, 0.0, -5.0])
    d = jnp.array([0.0, 0.0, 1.0])
    t, hit = ray_sphere(o, d, jnp.zeros(3), jnp.float32(1.0), 0.0, jnp.inf)
    assert bool(hit) and np.isclose(float(t), 4.0, atol=1e-5)
    # from inside: far root
    t2, hit2 = ray_sphere(jnp.zeros(3), d, jnp.zeros(3), jnp.float32(1.0),
                          0.0, jnp.inf)
    assert bool(hit2) and np.isclose(float(t2), 1.0, atol=1e-5)


class FakeScene:
    """Minimal duck-typed scene for the traversal functions."""
    def __init__(self, tri):
        self.tri_p0 = jnp.asarray(tri[:, 0], jnp.float32)
        self.tri_e1 = jnp.asarray(tri[:, 1] - tri[:, 0], jnp.float32)
        self.tri_e2 = jnp.asarray(tri[:, 2] - tri[:, 0], jnp.float32)
        lo = np.minimum(np.minimum(tri[:, 0], tri[:, 1]), tri[:, 2])
        hi = np.maximum(np.maximum(tri[:, 0], tri[:, 1]), tri[:, 2])
        b = build_bvh(lo.astype(np.float32), hi.astype(np.float32))
        self.bvh_prim = jnp.asarray(b['prim'])
        node = np.zeros((b['lo'].shape[0], 9), np.float32)
        node[:, 0:3] = b['lo']
        node[:, 3:6] = b['hi']
        node[:, 6] = b['first']
        node[:, 7] = b['count']
        node[:, 8] = b['skip']
        self.bvh_node = jnp.asarray(node)
        perm = b['prim']
        leaf = np.zeros((len(perm), 10), np.float32)
        leaf[:, 0:3] = np.asarray(self.tri_p0)[perm]
        leaf[:, 3:6] = np.asarray(self.tri_e1)[perm]
        leaf[:, 6:9] = np.asarray(self.tri_e2)[perm]
        leaf[:, 9] = perm
        self.bvh_leaf_tri = jnp.asarray(leaf)


def _brute(scene, o, d):
    t, u, v, hit = ray_triangle(o[None], d[None], scene.tri_p0,
                                scene.tri_e1, scene.tri_e2, 0.0, jnp.inf)
    t = jnp.where(hit, t, jnp.inf)
    i = jnp.argmin(t)
    return jnp.where(t[i] == jnp.inf, jnp.inf, t[i])


def test_bvh_matches_brute_force():
    rng = np.random.default_rng(7)
    # random triangle soup
    centers = rng.uniform(-1, 1, size=(500, 1, 3))
    tri = centers + rng.normal(scale=0.08, size=(500, 3, 3))
    scene = FakeScene(tri.astype(np.float32))

    o = rng.uniform(-2, 2, size=(512, 3)).astype(np.float32)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    t_b = jax.vmap(lambda o, d: _brute(scene, o, d))(o, d)
    t_v, prim, _, _ = jax.vmap(
        lambda o, d: bvh_traverse(scene, o, d, 0.0, jnp.inf))(o, d)

    # identical hit distances (same primitive tests, same arithmetic)
    np.testing.assert_allclose(np.asarray(t_v), np.asarray(t_b),
                               rtol=1e-5, atol=1e-5)

    occ = jax.vmap(lambda o, d: bvh_occluded(scene, o, d, 0.0, jnp.inf))(o, d)
    np.testing.assert_array_equal(np.asarray(occ),
                                  np.isfinite(np.asarray(t_b)))


class FakeBinnedScene:
    """Duck-typed scene for the binned two-level intersector."""
    def __init__(self, tri, cluster_tris=64):
        from lajolla_tpu.ops.intersect_binned import build_clusters
        self.tri_p0 = jnp.asarray(tri[:, 0], jnp.float32)
        self.tri_e1 = jnp.asarray(tri[:, 1] - tri[:, 0], jnp.float32)
        self.tri_e2 = jnp.asarray(tri[:, 2] - tri[:, 0], jnp.float32)
        lo = np.minimum(np.minimum(tri[:, 0], tri[:, 1]), tri[:, 2])
        hi = np.maximum(np.maximum(tri[:, 0], tri[:, 1]), tri[:, 2])
        b = build_bvh(lo.astype(np.float32), hi.astype(np.float32))
        cl = build_clusters(b, np.asarray(self.tri_p0),
                            np.asarray(self.tri_e1),
                            np.asarray(self.tri_e2),
                            max_tris=cluster_tris)
        self.cl_lo = jnp.asarray(cl['cl_lo'])
        self.cl_hi = jnp.asarray(cl['cl_hi'])
        self.cl_A = jnp.asarray(cl['cl_A'])
        self.cl_b = jnp.asarray(cl['cl_b'])
        self.cl_prim = jnp.asarray(cl['cl_prim'])


def test_binned_matches_brute_force():
    """Oracle for the big-scene path (ops/intersect_binned.py): closest
    hits and occlusion on a 5k-triangle random soup must agree with the
    all-triangles reference."""
    from lajolla_tpu.ops.intersect_binned import (intersect_binned,
                                                  occluded_binned)
    rng = np.random.default_rng(11)
    centers = rng.uniform(-1, 1, size=(5000, 1, 3))
    tri = (centers + rng.normal(scale=0.04, size=(5000, 3, 3))).astype(
        np.float32)
    bscene = FakeBinnedScene(tri)
    fscene = FakeScene(tri)

    N = 2048
    o = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tnear = np.zeros(N, np.float32)
    tfar = np.full(N, np.inf, np.float32)

    t_ref = jax.vmap(lambda o, d: _brute(fscene, o, d))(o, d)
    t_bin, prim, u, v = intersect_binned(bscene, jnp.asarray(o),
                                         jnp.asarray(d),
                                         jnp.asarray(tnear),
                                         jnp.asarray(tfar))
    np.testing.assert_allclose(np.asarray(t_bin), np.asarray(t_ref),
                               rtol=2e-4, atol=2e-5)

    occ = occluded_binned(bscene, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(tnear), jnp.asarray(tfar))
    np.testing.assert_array_equal(np.asarray(occ),
                                  np.isfinite(np.asarray(t_ref)))
