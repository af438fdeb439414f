"""LBVH invariants and BVH-vs-bruteforce equivalence (SURVEY.md section 4:
'Morton/LBVH invariants ... parent bounds contain children, leaf partition
covers all prims exactly once', mirroring the reference's asserts at
CLBVHnode.cpp:13,85,168-169,203)."""

import numpy as np
import jax.numpy as jnp
import pytest

import mini_opencl_raytracer as mrt
from mini_opencl_raytracer.config import BVHConfig
from mini_opencl_raytracer.ops import bvh as bvh_mod


@pytest.fixture(scope="module")
def cornell_bvh(cornell):
    return bvh_mod.build_bvh(cornell.geometry, BVHConfig(leaf_size=8))


def test_leaf_partition_covers_all(cornell, cornell_bvh):
    """Every original triangle appears in exactly one leaf slot."""
    T = cornell.geometry.num_triangles
    slots = np.asarray(cornell_bvh.slot_to_tri)[:T + (len(cornell_bvh.slot_to_tri) - T)]
    real = np.asarray(cornell_bvh.slot_to_tri)[
        np.asarray(cornell_bvh.pv0)[:, 0] < 1e29]
    assert sorted(real.tolist()) == list(range(T))


def test_parent_bounds_contain_children(cornell_bvh):
    lo = np.asarray(cornell_bvh.node_lo)
    hi = np.asarray(cornell_bvh.node_hi)
    L = cornell_bvh.num_leaves
    for i in range(L - 1):
        for c in (2 * i + 1, 2 * i + 2):
            # Empty child boxes (lo > hi) are trivially contained.
            if (lo[c] > hi[c]).any():
                continue
            assert (lo[i] <= lo[c] + 1e-4).all()
            assert (hi[i] >= hi[c] - 1e-4).all()


def test_leaf_bounds_contain_triangles(cornell_bvh):
    L = cornell_bvh.num_leaves
    leaf = cornell_bvh.leaf_size
    lo = np.asarray(cornell_bvh.node_lo)[L - 1:]
    hi = np.asarray(cornell_bvh.node_hi)[L - 1:]
    pv = [np.asarray(cornell_bvh.pv0), np.asarray(cornell_bvh.pv1),
          np.asarray(cornell_bvh.pv2)]
    for j in range(L):
        for s in range(j * leaf, (j + 1) * leaf):
            if pv[0][s, 0] > 1e29:
                continue
            for corner in pv:
                assert (corner[s] >= lo[j] - 1e-4).all()
                assert (corner[s] <= hi[j] + 1e-4).all()


def _random_rays(n, seed=0):
    r = np.random.default_rng(seed)
    # Origins around/inside the cornell room, random directions.
    o = r.uniform([-7, -20, 1], [7, 19, 16], size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_bvh_matches_bruteforce(cornell, cornell_bvh):
    """The BVH closest hit must agree with the all-pairs oracle on random
    rays: same hit mask, same t, same triangle."""
    o, d = _random_rays(512)
    brute = mrt.intersect_brute(o, d, cornell.geometry, t_max=1e5)
    bvh_hit = mrt.intersect_bvh(o, d, cornell_bvh, t_max=1e5)
    np.testing.assert_array_equal(np.asarray(brute.hit),
                                  np.asarray(bvh_hit.hit))
    m = np.asarray(brute.hit)
    np.testing.assert_allclose(np.asarray(brute.t)[m],
                               np.asarray(bvh_hit.t)[m], rtol=1e-5)
    # Triangle ids may differ only where two triangles are exactly
    # coincident at the hit t; require equality otherwise.
    t_b = np.asarray(brute.t)[m]
    same = np.asarray(brute.tri_idx)[m] == np.asarray(bvh_hit.tri_idx)[m]
    assert same.mean() > 0.99


def test_bvh_occlusion_matches(cornell, cornell_bvh):
    o, d = _random_rays(256, seed=1)
    limit = jnp.full((256,), 8.0)
    brute = mrt.occluded_brute(o, d, limit, cornell.geometry)
    bvh_occ = mrt.occluded_bvh(o, d, limit, cornell_bvh)
    np.testing.assert_array_equal(np.asarray(brute), np.asarray(bvh_occ))


def test_bigger_scene_random_soup():
    """Random triangle soup (unstructured, duplicate morton cells) still
    traverses correctly."""
    r = np.random.default_rng(7)
    n = 500
    base = r.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    e1 = r.normal(scale=0.5, size=(n, 3)).astype(np.float32)
    e2 = r.normal(scale=0.5, size=(n, 3)).astype(np.float32)
    geo = mrt.Geometry(
        v0=jnp.asarray(base), v1=jnp.asarray(base + e1),
        v2=jnp.asarray(base + e2),
        n0=jnp.zeros((n, 3)), n1=jnp.zeros((n, 3)), n2=jnp.zeros((n, 3)),
        uv0=jnp.zeros((n, 2)), uv1=jnp.zeros((n, 2)), uv2=jnp.zeros((n, 2)),
        mat_idx=jnp.zeros((n,), jnp.int32))
    bvh = bvh_mod.build_bvh(geo, BVHConfig(leaf_size=4))
    o, d = _random_rays(256, seed=3)
    brute = mrt.intersect_brute(o, d, geo, t_max=1e5)
    hit = mrt.intersect_bvh(o, d, bvh, t_max=1e5)
    np.testing.assert_array_equal(np.asarray(brute.hit), np.asarray(hit.hit))
    m = np.asarray(brute.hit)
    np.testing.assert_allclose(np.asarray(brute.t)[m],
                               np.asarray(hit.t)[m], rtol=1e-4)
