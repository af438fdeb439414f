"""Intersection unit tests: Moller-Trumbore and slab tests against
hand-computed cases (SURVEY.md section 4)."""

import numpy as np
import jax.numpy as jnp
import pytest

import mini_opencl_raytracer as mrt
from mini_opencl_raytracer.ops.intersect import ray_triangle
from mini_opencl_raytracer.ops.bvh import morton3d, expand_bits_10


def _tri():
    v0 = jnp.array([[0.0, 0.0, 5.0]])
    v1 = jnp.array([[2.0, 0.0, 5.0]])
    v2 = jnp.array([[0.0, 2.0, 5.0]])
    return v0, v1, v2


def test_ray_triangle_hit():
    v0, v1, v2 = _tri()
    o = jnp.array([[0.5, 0.5, 0.0]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    t, u, v, valid = ray_triangle(o, d, v0, v1, v2)
    assert bool(valid[0])
    assert float(t[0]) == pytest.approx(5.0)
    assert float(u[0]) == pytest.approx(0.25)
    assert float(v[0]) == pytest.approx(0.25)


def test_ray_triangle_miss_outside():
    v0, v1, v2 = _tri()
    o = jnp.array([[3.0, 3.0, 0.0]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    _, _, _, valid = ray_triangle(o, d, v0, v1, v2)
    assert not bool(valid[0])


def test_ray_triangle_behind_origin():
    """Hits at t < 0 must be rejected (the reference misses this check,
    kernel_bvh.cl:140 — spec-cleaned)."""
    v0, v1, v2 = _tri()
    o = jnp.array([[0.5, 0.5, 10.0]])
    d = jnp.array([[0.0, 0.0, 1.0]])
    _, _, _, valid = ray_triangle(o, d, v0, v1, v2)
    assert not bool(valid[0])


def test_ray_triangle_parallel():
    v0, v1, v2 = _tri()
    o = jnp.array([[0.5, 0.5, 0.0]])
    d = jnp.array([[1.0, 0.0, 0.0]])
    _, _, _, valid = ray_triangle(o, d, v0, v1, v2)
    assert not bool(valid[0])


def test_backface_cull():
    """The triangle's geometric normal (e1 x e2) is +z; a ray travelling
    -z sees the front face (det > 0), a ray travelling +z the back."""
    v0, v1, v2 = _tri()
    front_o = jnp.array([[0.5, 0.5, 10.0]])
    front_d = jnp.array([[0.0, 0.0, -1.0]])
    back_o = jnp.array([[0.5, 0.5, 0.0]])
    back_d = jnp.array([[0.0, 0.0, 1.0]])
    _, _, _, v_front = ray_triangle(front_o, front_d, v0, v1, v2,
                                    backface_cull=True)
    _, _, _, v_back = ray_triangle(back_o, back_d, v0, v1, v2,
                                   backface_cull=True)
    assert bool(v_front[0])
    assert not bool(v_back[0])
    # Without culling both sides hit.
    _, _, _, v_back_nc = ray_triangle(back_o, back_d, v0, v1, v2,
                                      backface_cull=False)
    assert bool(v_back_nc[0])


def test_brute_force_closest(cornell):
    """Camera ray into the Cornell box must hit, and the closest hit must
    equal the min over all per-triangle hits."""
    geo = cornell.geometry
    o = jnp.array([[0.0, -25.0, 8.5]])
    d = jnp.array([[0.0, 1.0, 0.0]])
    hit = mrt.intersect_brute(o, d, geo, t_max=1e5)
    assert bool(hit.hit[0])
    t_all, _, _, valid = ray_triangle(
        o[:, None, :], d[:, None, :],
        geo.v0[None], geo.v1[None], geo.v2[None])
    expected = float(jnp.min(jnp.where(valid, t_all, jnp.inf)))
    assert float(hit.t[0]) == pytest.approx(expected, rel=1e-5)


def test_morton_basics():
    # expand_bits: 0b11 -> 0b1001
    out = np.asarray(expand_bits_10(jnp.array([3], jnp.uint32)))
    assert out[0] == 0b1001
    # Morton ordering is monotone along each axis at the low end.
    pts = jnp.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    codes = np.asarray(morton3d(pts))
    assert codes[0] < codes[1]
