"""Camera ray generation.

Re-design of ``CreateRay`` (kernel_bvh.cl:386-403): the reference
decodes the pixel from a flat work-item id and jitters +-0.5px per frame
for progressive AA. Here ray generation is a batched pure function over a
[R] pixel-id vector — same math, vectorized, differentiable w.r.t. the
camera, with the hardcoded 45-degree vertical FOV (kernel_bvh.cl:392)
lifted into RenderConfig.fov_deg.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..models.scene import Camera
from . import rng
from .linalg import cross, normalize


def generate_rays(camera: Camera, cfg: RenderConfig, pixel_ids: jax.Array,
                  seeds: jax.Array):
    """Jittered pinhole primary rays.

    Args:
      camera: Camera pytree {position, front, up}.
      cfg: static RenderConfig (width/height/fov).
      pixel_ids: [R] int32 flat pixel indices (row-major, y*W + x, the
        layout of get_global_id(0) in the reference, kernel_bvh.cl:394-395).
      seeds: [R] uint32 per-pixel seeds for the jitter draws.

    Returns:
      (origins [R,3], directions [R,3] normalized).
    """
    dtype = cfg.jnp_dtype()
    w, h = cfg.width, cfg.height
    inv_w = 1.0 / float(w)
    inv_h = 1.0 / float(h)
    aspect = float(w) / float(h)
    # tan(fov/2); reference hardcodes 45 deg (kernel_bvh.cl:392).
    angle = jnp.tan(jnp.asarray(0.5 * cfg.fov_deg * jnp.pi / 180.0, dtype))

    px = (pixel_ids % w).astype(dtype)
    py = (pixel_ids // w).astype(dtype)
    # +-0.5px uniform jitter (kernel_bvh.cl:394-395: pixel + rand() - 0.5,
    # then +0.5 inside the NDC map -> net jitter in [0, 1)).
    jx = rng.uniform(seeds, rng.SITE_JITTER_X)
    jy = rng.uniform(seeds, rng.SITE_JITTER_Y)
    x = (2.0 * (px + jx) * inv_w - 1.0) * angle * aspect
    # Row 0 = top of the image. The reference's sign (kernel_bvh.cl:398)
    # puts row 0 at the *bottom* and then relies on the GL quad draw's
    # v-flip (CLRaytracer.cpp:69-81) to display upright; headless output
    # goes straight to image files, so we bake the upright orientation in.
    y = (1.0 - 2.0 * (py + jy) * inv_h) * angle

    # Basis: right = cross(front, up) (kernel_bvh.cl:400).
    right = cross(camera.front, camera.up)
    d = (x[:, None] * right[None, :]
         + y[:, None] * camera.up[None, :]
         + camera.front[None, :])
    directions = normalize(d)
    origins = jnp.broadcast_to(camera.position[None, :], directions.shape)
    return origins, directions
