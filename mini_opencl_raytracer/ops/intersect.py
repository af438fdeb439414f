"""Ray-triangle intersection and the brute-force (oracle) intersector.

Re-design of ``RayTriangle`` (kernel_bvh.cl:98-153). The reference's
scalar Moller-Trumbore has a broken determinant test (its `for i<2` /
fall-through structure at kernel_bvh.cl:102,116,151-153 makes the epsilon
logic effectively cull everything non-frontfacing); per SURVEY.md this is
spec-cleaned here: standard Moller-Trumbore, optional backface culling,
vectorized over a full [rays x triangles] panel. The reference also
accepts hits with negative ``t`` (kernel_bvh.cl:140 has no `t > 0`
test) — cleaned to ``t > 0``.

The brute-force intersector is the *oracle* of the test pyramid
(SURVEY.md section 4): an obviously-correct all-pairs closest hit that the
BVH backend must match exactly. It is also the production intersector
for small scenes (``render.resolve_backend``).

Differentiability: the closest-hit search (min/argmin over triangles) is
done on stop-gradient values; the winning triangle's (t, u, v) are then
recomputed analytically from the gathered vertices so gradients flow
through geometry without materializing [R, T] adjoints.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .. import pytree
from ..models.scene import Geometry
from .linalg import cross, dot, normalize

_DET_EPS = 1e-10

# Bytes of [rays x triangles] f32 intermediates one step of the dense
# sweep may hold, assuming SWEEP_PLANES live planes per ray-triangle pair.
SWEEP_BUDGET_BYTES = 2 << 30
SWEEP_PLANES = 4


def sweep_chunk(num_rays: int, num_tris: int,
                ray_chunk: Optional[int] = None) -> int:
    """Rays per step of the dense sweep: ``ray_chunk`` when given, else
    as many as fit SWEEP_BUDGET_BYTES (the whole wavefront of a small
    scene in one step)."""
    if ray_chunk is None:
        per_ray = max(num_tris, 1) * 4 * SWEEP_PLANES
        ray_chunk = max(SWEEP_BUDGET_BYTES // per_ray, 1)
    return max(min(ray_chunk, num_rays), 1)


@pytree.dataclass
class Hit:
    """Closest-hit record (analog of IntersectData, kernel_bvh.cl:18-27,
    minus the ray, which callers already have)."""

    t: jax.Array        # [R] hit distance (t_max where miss)
    tri_idx: jax.Array  # [R] int32 triangle index (0 where miss)
    hit: jax.Array      # [R] bool


def ray_triangle(o: jax.Array, d: jax.Array,
                 v0: jax.Array, v1: jax.Array, v2: jax.Array,
                 backface_cull: bool = False):
    """Batched Moller-Trumbore.

    All inputs broadcast; typically o, d are [R, 1, 3] and v* are [1, T, 3]
    producing [R, T] outputs.

    Returns (t, u, v, valid): t is +inf where invalid.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    if backface_cull:
        valid = det > _DET_EPS
    else:
        valid = jnp.abs(det) > _DET_EPS
    inv_det = jnp.where(valid, 1.0 / jnp.where(valid, det, 1.0), 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    valid = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    t = jnp.where(valid, t, jnp.inf)
    return t, u, v, valid


def _gather_tri(geometry: Geometry, tri_idx: jax.Array):
    take = lambda a: jnp.take(a, tri_idx, axis=0)
    return (take(geometry.v0), take(geometry.v1), take(geometry.v2))


def intersect_brute(o: jax.Array, d: jax.Array, geometry: Geometry,
                    t_max: float, backface_cull: bool = False,
                    ray_chunk: Optional[int] = None) -> Hit:
    """All-pairs closest hit: the oracle intersector.

    Replaces the BVH walk of ``Intersect`` (kernel_bvh.cl:171-219) with a
    dense [chunk x T] panel sweep. Rays are processed in chunks (see
    ``sweep_chunk``) via ``lax.map`` to bound the [R, T] intermediates.
    """
    R = o.shape[0]
    chunk = sweep_chunk(R, geometry.v0.shape[0], ray_chunk)
    pad = (-R) % chunk
    o_p = jnp.pad(o, ((0, pad), (0, 0)))
    d_p = jnp.pad(d, ((0, pad), (0, 0)))
    # Pad direction zeros would produce NaNs; make them unit +z.
    if pad:
        d_p = d_p.at[R:, 2].set(1.0)
    n_chunks = (R + pad) // chunk
    o_c = o_p.reshape(n_chunks, chunk, 3)
    d_c = d_p.reshape(n_chunks, chunk, 3)

    v0 = geometry.v0[None, :, :]
    v1 = geometry.v1[None, :, :]
    v2 = geometry.v2[None, :, :]

    def one_chunk(args):
        oc, dc = args
        t_all, _, _, _ = ray_triangle(
            oc[:, None, :], dc[:, None, :],
            jax.lax.stop_gradient(v0), jax.lax.stop_gradient(v1),
            jax.lax.stop_gradient(v2),
            backface_cull=backface_cull)
        t_all = jnp.where(t_all < t_max, t_all, jnp.inf)
        best_idx = jnp.argmin(t_all, axis=1).astype(jnp.int32)
        best_t = jnp.min(t_all, axis=1)
        return best_t, best_idx

    best_t, best_idx = jax.lax.map(one_chunk, (o_c, d_c))
    best_t = best_t.reshape(-1)[:R]
    best_idx = best_idx.reshape(-1)[:R]
    hit = jnp.isfinite(best_t)

    # Differentiable recompute on the winning triangle only.
    tv0, tv1, tv2 = _gather_tri(geometry, best_idx)
    t_re, _, _, valid_re = ray_triangle(o, d, tv0, tv1, tv2,
                                        backface_cull=backface_cull)
    t_out = jnp.where(hit & valid_re, t_re, t_max)
    return Hit(t=t_out, tri_idx=best_idx, hit=hit)


@pytree.dataclass
class ShadingPoint:
    """Interpolated surface data at a hit (IntersectData fields pos /
    normal / uv, kernel_bvh.cl:144-147)."""

    pos: jax.Array      # [R, 3]
    normal: jax.Array   # [R, 3] interpolated unit shading normal
    uv: jax.Array       # [R, 2]
    mat_idx: jax.Array  # [R] int32


def shading_point(o: jax.Array, d: jax.Array, hit: Hit,
                  geometry: Geometry,
                  backface_cull: bool = False) -> ShadingPoint:
    """Recompute differentiable (u, v) on the hit triangle and interpolate
    normal/uv exactly as kernel_bvh.cl:144-147:
      pos = o + d t;  n = normalize(u n1 + v n2 + (1-u-v) n0);
      uv = u uv1 + v uv2 + (1-u-v) uv0.
    """
    idx = hit.tri_idx
    take = lambda a: jnp.take(a, idx, axis=0)
    v0, v1, v2 = take(geometry.v0), take(geometry.v1), take(geometry.v2)
    t, u, v, _ = ray_triangle(o, d, v0, v1, v2, backface_cull=backface_cull)
    t = jnp.where(hit.hit, t, 0.0)
    u = jnp.where(hit.hit, u, 0.0)
    v = jnp.where(hit.hit, v, 0.0)
    w = 1.0 - u - v
    pos = o + d * t[..., None]
    normal = normalize(u[..., None] * take(geometry.n1)
                       + v[..., None] * take(geometry.n2)
                       + w[..., None] * take(geometry.n0))
    uv = (u[..., None] * take(geometry.uv1)
          + v[..., None] * take(geometry.uv2)
          + w[..., None] * take(geometry.uv0))
    return ShadingPoint(pos=pos, normal=normal, uv=uv,
                        mat_idx=take(geometry.mat_idx))


def occluded_brute(o: jax.Array, d: jax.Array, t_limit: jax.Array,
                   geometry: Geometry, backface_cull: bool = False,
                   ray_chunk: Optional[int] = None) -> jax.Array:
    """Any-hit query for shadow rays (an extension; the reference casts no
    shadow rays — SURVEY.md 'no shadow rays'). Returns bool [R]: True if
    any triangle lies at 0 < t < t_limit."""
    hit = intersect_brute(o, d, geometry, t_max=jnp.inf,
                          backface_cull=backface_cull, ray_chunk=ray_chunk)
    return hit.hit & (hit.t < t_limit)
