"""Hit-attribute fetch: one row per ray from a per-triangle table.

After the intersector returns a winning triangle index per ray, shading
needs that triangle's corner data and material — in the reference a
pointer chase (``isect->object`` / ``materials[mtlIndex]``,
kernel_bvh.cl:144-147, 364). Here all per-triangle shading attributes
(corners, normals, uvs, and the triangle's material columns) are
concatenated into one [T, C] table, so a bounce fetches everything with
one row gather instead of a dozen.

For small tables the gather is a one-hot matmul ``one_hot(idx) @ table``
at HIGHEST precision: exact in f32 (each product is 1.0 * x or 0.0 * x)
and differentiable (the transpose is a scatter-add matmul). Above
``ONE_HOT_MAX_ROWS`` it is an XLA gather. The threshold is carried over
from the earlier design; it has not been measured on the GPU.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.scene import Geometry, Materials
from .intersect import Hit, ray_triangle
from .linalg import normalize

ONE_HOT_MAX_ROWS = 1024


def take_rows(table: jax.Array, idx: jax.Array) -> jax.Array:
    """table [T, C], idx [R] int32 -> [R, C] rows.

    One-hot matmul for small T, XLA gather otherwise.
    """
    T = table.shape[0]
    if T <= ONE_HOT_MAX_ROWS:
        onehot = (idx[:, None] == jnp.arange(T, dtype=idx.dtype)[None, :])
        onehot = onehot.astype(table.dtype)
        return jax.lax.dot(onehot, table,
                           precision=jax.lax.Precision.HIGHEST)
    return jnp.take(table, idx, axis=0)


class ShadingTable(NamedTuple):
    """[T, C] concatenated per-triangle shading attributes + column map."""

    table: jax.Array

    # Column layout (start offsets).
    V0, V1, V2 = 0, 3, 6
    N0, N1, N2 = 9, 12, 15
    UV0, UV1, UV2 = 18, 20, 22
    KD, KS, KE = 24, 27, 30
    NS = 33
    COLS = 34


def build_shading_table(geometry: Geometry,
                        materials: Materials) -> ShadingTable:
    """Fold geometry corners + per-triangle material data into one table.

    The material gather here is per-*triangle* (T rows from an M-row
    table) — tiny, done once per trace, and differentiable w.r.t. the
    material arrays, so material-optimization gradients flow through it.
    """
    m = geometry.mat_idx
    cols = [
        geometry.v0, geometry.v1, geometry.v2,
        geometry.n0, geometry.n1, geometry.n2,
        geometry.uv0, geometry.uv1, geometry.uv2,
        jnp.take(materials.diffuse, m, axis=0),
        jnp.take(materials.specular, m, axis=0),
        jnp.take(materials.emission, m, axis=0),
        jnp.take(materials.roughness, m, axis=0)[:, None],
    ]
    return ShadingTable(table=jnp.concatenate(cols, axis=1))


class HitAttributes(NamedTuple):
    """Everything the integrator needs at a hit, fetched in one row."""

    pos: jax.Array      # [R, 3]
    normal: jax.Array   # [R, 3] interpolated unit shading normal
    uv: jax.Array       # [R, 2]
    kd: jax.Array       # [R, 3] material diffuse
    ks: jax.Array       # [R, 3] material specular
    ke: jax.Array       # [R, 3] material emission
    ns: jax.Array       # [R] material roughness/shininess exponent
    coverage: jax.Array  # [R] soft edge coverage in (0,1]; 1.0 when hard


def soft_coverage(u: jax.Array, v: jax.Array,
                  soft_sigma: float) -> jax.Array:
    """Sigmoid coverage of the winner's barycentric edge margin
    min(u, v, 1-u-v): ~1 in the triangle interior, 0.5 exactly on an
    edge, -> 0 just outside — the SoftRas-style visibility relaxation
    that gives silhouettes nonzero vertex gradients (the edge term the
    hard closest-hit derivative drops, grad.py module docstring)."""
    margin = jnp.minimum(jnp.minimum(u, v), 1.0 - u - v)
    return jax.nn.sigmoid(margin / soft_sigma)


def hit_attributes(o: jax.Array, d: jax.Array, hit: Hit,
                   st: ShadingTable,
                   backface_cull: bool = False,
                   soft_sigma: float = 0.0) -> HitAttributes:
    """Fetch the winning triangle's row and recompute the differentiable
    intersection on it (t, u, v), then interpolate exactly as
    kernel_bvh.cl:144-147. ``soft_sigma`` > 0 adds the soft edge
    coverage (see soft_coverage)."""
    rows = take_rows(st.table, hit.tri_idx)

    def c3(off):
        return rows[:, off:off + 3]

    def c2(off):
        return rows[:, off:off + 2]

    v0, v1, v2 = c3(st.V0), c3(st.V1), c3(st.V2)
    t, u, v, _ = ray_triangle(o, d, v0, v1, v2, backface_cull=backface_cull)
    t = jnp.where(hit.hit, t, 0.0)
    u = jnp.where(hit.hit, u, 0.0)
    v = jnp.where(hit.hit, v, 0.0)
    if soft_sigma > 0.0:
        coverage = soft_coverage(u, v, soft_sigma)
    else:
        coverage = jnp.ones_like(t)
    u = u[:, None]
    v = v[:, None]
    w = 1.0 - u - v

    pos = o + d * t[:, None]
    normal = normalize(u * c3(st.N1) + v * c3(st.N2) + w * c3(st.N0))
    uv = u * c2(st.UV1) + v * c2(st.UV2) + w * c2(st.UV0)
    return HitAttributes(
        pos=pos, normal=normal, uv=uv,
        kd=c3(st.KD), ks=c3(st.KS), ke=c3(st.KE),
        ns=rows[:, st.NS], coverage=coverage,
    )
