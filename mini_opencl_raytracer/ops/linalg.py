"""Small vector-math helpers over [..., 3] arrays.

Replaces the reference's ``float3`` operator library (CLmathlib.hpp:18-118)
with broadcasting ``jnp`` helpers. Everything is shape-polymorphic over
leading batch dimensions so the same code serves one ray or a [H*W] grid.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched dot product over the trailing axis (length 3) -> [...].

    Written as three products and two adds, not a reduction: with JAX
    0.9.0 the GPU compiler turned length-3 reductions of some
    differentiated renders (16,384 rays) into a Triton kernel compiled
    for 64 threads and launched with 128, which fails on H100s with
    CUDA_ERROR_INVALID_VALUE."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def all_finite(a: jax.Array) -> jax.Array:
    """Whether all three components are finite -> [...] (no reduction,
    as in ``dot``)."""
    return (jnp.isfinite(a[..., 0]) & jnp.isfinite(a[..., 1])
            & jnp.isfinite(a[..., 2]))


def cross(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.cross(a, b)


def safe_sqrt(x: jax.Array) -> jax.Array:
    """sqrt(max(x, 0)) whose gradient is 0 (not inf or NaN) where
    x <= 0: a sampled direction at the pole of its lobe has sin = 0, and
    the plain sqrt's infinite slope there turns every cotangent that
    meets it into NaN."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def length(a: jax.Array) -> jax.Array:
    return safe_sqrt(dot(a, a))


def normalize(a: jax.Array, eps: float = 1e-20) -> jax.Array:
    """Safe normalize; returns a zero-safe unit vector."""
    return a * jax.lax.rsqrt(jnp.maximum(dot(a, a), eps))[..., None]


def reflect(v: jax.Array, n: jax.Array) -> jax.Array:
    """Reference convention (kernel_bvh.cl:74-77): reflect the *outgoing*
    vector, ``-v + 2 (v.n) n`` (note: NOT the GLSL reflect sign)."""
    return -v + 2.0 * dot(v, n)[..., None] * n


def build_onb(n: jax.Array):
    """Orthonormal basis (s, t, n) matching SampleHemisphereCosine's frame
    (kernel_bvh.cl:85-87): axis = |n.x|>0.001 ? +Y : +X;
    t = normalize(cross(axis, n)); s = cross(n, t)."""
    use_y = (jnp.abs(n[..., 0]) > 1e-3)[..., None]
    axis = jnp.where(
        use_y,
        jnp.array([0.0, 1.0, 0.0], n.dtype),
        jnp.array([1.0, 0.0, 0.0], n.dtype),
    )
    t = normalize(cross(axis, n))
    s = cross(n, t)
    return s, t


def spherical_dir(s: jax.Array, t: jax.Array, n: jax.Array,
                  phi: jax.Array, sin_theta: jax.Array,
                  cos_theta: jax.Array) -> jax.Array:
    """Direction from local spherical angles in the (s, t, n) frame
    (kernel_bvh.cl:89, 238)."""
    return normalize(
        s * (jnp.cos(phi) * sin_theta)[..., None]
        + t * (jnp.sin(phi) * sin_theta)[..., None]
        + n * cos_theta[..., None]
    )
