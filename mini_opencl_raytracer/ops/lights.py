"""Analytic direct lighting: directional / point / spot, multi-light,
optional shadow rays and Blinn-Phong direct specular.

Re-design of ``lightPixel`` (kernel_bvh.cl:304-347). Differences from
the reference, per SURVEY.md spec-cleaning:

* the reference hardcodes one light's position/direction in-kernel
  (kernel_bvh.cl:307-308) and never uploads its host CLLight — here the
  ``Lights`` SoA arrays are real differentiable inputs and multiple
  lights are summed;
* the reference computes point-light N.L with the *unnormalized* L and
  attenuation from ``eye = L - X`` (i.e. lightPos - 2X; kernel_bvh.cl:330,
  333-335 — both bugs) — cleaned to normalized L and d = |lightPos - X|;
* the spot branch is a stub (kernel_bvh.cl:337-344) — implemented here
  with a smooth cone falloff;
* shadow rays and a Blinn-Phong direct specular term are extensions
  (benchmark config 2); the reference's direct term is always unoccluded.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..models.scene import (LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPOT,
                            Lights)
from .linalg import dot, normalize


class DirectLight(NamedTuple):
    # Scalar irradiance-style weight per ray (the reference's
    # attn * intensity * NdotL, kernel_bvh.cl:346) summed over lights.
    diffuse_weight: jax.Array   # [R]
    # Blinn-Phong specular weight per ray (0 unless direct_specular).
    specular_weight: jax.Array  # [R]


def direct_light(
    lights: Lights,
    position: jax.Array,      # [R, 3] shading points
    normal: jax.Array,        # [R, 3] unit shading normals
    wo: jax.Array,            # [R, 3] unit direction toward the viewer
    shininess: jax.Array,     # [R] Blinn-Phong exponent (material Ns)
    occluder_fn: Optional[Callable] = None,  # (o, d, t_limit) -> bool [R]
    direct_specular: bool = False,
    shadow_eps: float = 1e-2,
) -> DirectLight:
    """Sum the analytic direct-light weights over all lights.

    ``occluder_fn`` enables shadow rays: it receives (origins, unit dirs,
    t_limit) and returns True where the segment is blocked.
    """
    R = position.shape[0]
    dtype = position.dtype
    diff_total = jnp.zeros((R,), dtype)
    spec_total = jnp.zeros((R,), dtype)

    # Lights are few; a Python loop unrolls into fused vector ops.
    for li in range(lights.count):
        ltype = lights.light_type[li]
        lpos = lights.position[li]
        ldir = normalize(lights.direction[li])
        intensity = lights.intensity[li]
        falloff = lights.attenuation[li]
        cos_cut = lights.cos_cutoff[li]

        to_light = lpos[None, :] - position          # [R, 3]
        dist = jnp.sqrt(jnp.maximum(dot(to_light, to_light), 1e-12))
        l_point = to_light / dist[..., None]
        l_directional = jnp.broadcast_to(-ldir[None, :], l_point.shape)

        is_dir = ltype <= LIGHT_DIRECTIONAL
        l_unit = jnp.where(is_dir, l_directional, l_point)
        ndotl = jnp.maximum(dot(normal, l_unit), 0.0)

        # Quadratic attenuation for point/spot (kernel_bvh.cl:335,
        # cleaned to the true distance).
        attn_point = 1.0 / jnp.maximum(falloff * dist * dist, 1e-6)
        attn = jnp.where(is_dir, jnp.ones_like(attn_point), attn_point)

        # Spot cone falloff (reference stub, kernel_bvh.cl:337-344).
        cos_angle = dot(-l_unit, ldir[None, :])
        spot_w = jnp.clip((cos_angle - cos_cut) / jnp.maximum(1.0 - cos_cut, 1e-6),
                          0.0, 1.0)
        attn = jnp.where(ltype >= LIGHT_SPOT, attn * spot_w, attn)

        weight = attn * intensity * ndotl

        if occluder_fn is not None:
            origins = position + l_unit * shadow_eps
            # Directional lights: occlusion along the full ray.
            t_limit = jnp.where(is_dir, jnp.full_like(dist, jnp.inf),
                                dist - 2.0 * shadow_eps)
            blocked = occluder_fn(origins, l_unit, t_limit)
            weight = jnp.where(blocked, 0.0, weight)

        diff_total = diff_total + weight

        if direct_specular:
            # Blinn-Phong half-vector specular with the material's Ns.
            h = normalize(l_unit + wo)
            ndoth = jnp.maximum(dot(normal, h), 0.0)
            spec = jnp.power(jnp.maximum(ndoth, 1e-6), jnp.maximum(shininess, 1.0))
            spec = jnp.where(ndotl > 0.0, spec, 0.0)
            spec_w = attn * intensity * spec
            if occluder_fn is not None:
                spec_w = jnp.where(blocked, 0.0, spec_w)
            spec_total = spec_total + spec_w

    return DirectLight(diffuse_weight=diff_total, specular_weight=spec_total)
