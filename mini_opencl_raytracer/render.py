"""Top-level headless render API.

Replaces the reference's frame driver + GL display loop
(CLRaytracer::RenderFrame, CLRaytracer.cpp:12-102; CLEngineBase render
loop, CLEngineBase.cpp:192-210) with pure functions:

  render_sample(scene, camera, cfg, frame)      -> linear radiance [H,W,3]
  render(scene, camera, cfg, frames)            -> accumulated image
  RenderState / accumulate / to_image           -> progressive refinement

Progressive accumulation: the reference stores a gamma-encoded running
average in the output buffer and re-derives the linear average each frame
(kernel_bvh.cl:449-455). This design keeps the *linear* sum and a
sample count as an explicit carry (SURVEY.md section 3.4: "accumulated
render state is an explicit carry"), applying gamma only at readout —
mathematically the same average, without the per-frame encode/decode.

Accumulation-reset-on-change (CLui.cpp:218-232, CLEngineBase.cpp:146-161)
becomes trivial: any scene/camera change is a new ``RenderState()``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from . import pytree
from .config import BVHConfig, RenderConfig
from .models.scene import Camera, Scene
from .ops import rng
from .ops.camera import generate_rays
from .ops.integrator import trace_paths
from .ops.intersect import intersect_brute, occluded_brute
from .ops import bvh as bvh_mod

# ``auto`` sweeps every triangle densely up to this size and walks the
# LBVH above it.
DENSE_MAX_TRIS = 2048

BACKENDS = ("auto", "bruteforce", "bvh")


def resolve_backend(scene: Scene, cfg: RenderConfig) -> str:
    """Resolve ``cfg.backend`` to ``"bruteforce"`` or ``"bvh"``.

    ``auto`` chooses from the triangle count alone: the dense all-pairs
    sweep for scenes of at most ``DENSE_MAX_TRIS`` triangles, the LBVH
    traversal above. Any other name raises ``ValueError``.
    """
    if cfg.backend == "auto":
        return ("bruteforce" if scene.num_triangles <= DENSE_MAX_TRIS
                else "bvh")
    if cfg.backend in BACKENDS:
        return cfg.backend
    raise ValueError(f"unknown backend {cfg.backend!r}; "
                     f"expected one of {BACKENDS}")


def make_intersectors(scene: Scene, cfg: RenderConfig,
                      bvh: Optional["bvh_mod.BVH"] = None,
                      accel=None, backend: Optional[str] = None):
    """Build (closest_hit_fn, any_hit_fn) for the configured backend.

    Backends:
      * ``bruteforce`` — the dense all-pairs sweep (also the tests' oracle);
      * ``bvh``        — LBVH traversal.

    A prebuilt BVH may arrive as ``bvh`` or as ``accel`` (what
    ``build_accel`` returned); without one the ``bvh`` backend builds it
    inside the traced function.
    """
    geo = scene.geometry
    if backend is None:
        backend = resolve_backend(scene, cfg)
    if bvh is None and isinstance(accel, bvh_mod.BVH):
        bvh = accel
    if backend == "bruteforce":
        closest = functools.partial(
            intersect_brute, geometry=geo, t_max=cfg.t_max,
            backface_cull=cfg.backface_cull, ray_chunk=cfg.ray_chunk)
        any_hit = functools.partial(
            occluded_brute, geometry=geo,
            backface_cull=cfg.backface_cull, ray_chunk=cfg.ray_chunk)
        return closest, any_hit
    if backend == "bvh":
        if bvh is None:
            bvh = bvh_mod.build_bvh(geo, BVHConfig())
        closest = functools.partial(
            bvh_mod.intersect_bvh, bvh=bvh, t_max=cfg.t_max,
            backface_cull=cfg.backface_cull)
        any_hit = functools.partial(
            bvh_mod.occluded_bvh, bvh=bvh,
            backface_cull=cfg.backface_cull)
        return closest, any_hit
    raise ValueError(f"unknown backend: {backend!r}")


def build_accel(scene: Scene, cfg: RenderConfig):
    """Acceleration structure for the resolved backend: the LBVH for
    ``bvh``, None for the dense sweep. Call once per scene, outside jit,
    and pass the result to ``render`` / ``render_sample`` as ``accel``;
    rebuild it after moving vertices."""
    if resolve_backend(scene, cfg) == "bvh":
        return bvh_mod.build_bvh(scene.geometry, BVHConfig())
    return None


@pytree.dataclass
class RenderState:
    """Progressive accumulation carry: linear radiance sum + sample count
    (+ the frame counter that seeds the next sample's RNG, the analog of
    m_FrameCount, CLRaytracer.h:30)."""

    radiance_sum: jax.Array  # [H, W, 3] linear
    num_samples: jax.Array   # scalar int32

    @staticmethod
    def create(cfg: RenderConfig) -> "RenderState":
        return RenderState(
            radiance_sum=jnp.zeros((cfg.height, cfg.width, 3), cfg.jnp_dtype()),
            num_samples=jnp.zeros((), jnp.int32),
        )

    def mean(self) -> jax.Array:
        n = jnp.maximum(self.num_samples, 1).astype(self.radiance_sum.dtype)
        return self.radiance_sum / n


# Tile shape: 8 x 16 pixels. The wavefront is traced in tile-swizzled
# order so consecutive rays cover a square screen tile instead of a
# scanline strip. Carried over from the earlier design; not yet
# measured on the GPU.
_TILE_H, _TILE_W = 8, 16


def _swizzled_ids(cfg: RenderConfig) -> Optional[jax.Array]:
    """Flat pixel ids in tile-major order, or None if the resolution
    doesn't tile evenly (fall back to scanline order)."""
    H, W = cfg.height, cfg.width
    if H % _TILE_H or W % _TILE_W:
        return None
    ids = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
    return (ids.reshape(H // _TILE_H, _TILE_H, W // _TILE_W, _TILE_W)
            .transpose(0, 2, 1, 3).reshape(-1))


def _unswizzle_image(radiance: jax.Array, cfg: RenderConfig) -> jax.Array:
    """[R, 3] tile-major radiance -> [H, W, 3] image (pure reshapes)."""
    H, W = cfg.height, cfg.width
    return (radiance.reshape(H // _TILE_H, W // _TILE_W, _TILE_H, _TILE_W, 3)
            .transpose(0, 2, 1, 3, 4).reshape(H, W, 3))


def render_sample(scene: Scene, camera: Camera, cfg: RenderConfig,
                  frame=0,
                  bvh: Optional["bvh_mod.BVH"] = None,
                  accel=None) -> jax.Array:
    """Render one progressive sample -> linear radiance [H, W, 3].

    ``frame`` seeds the per-pixel RNG exactly like the reference's
    frameCount (kernel_bvh.cl:445); successive frames decorrelate the
    jitter and the path choices. Rays are traced in tile-swizzled order
    (see _swizzled_ids) — per-pixel values are identical either way, only
    the wavefront layout changes.
    """
    closest, any_hit = make_intersectors(scene, cfg, bvh=bvh, accel=accel)
    R = cfg.num_pixels
    pixel_ids = _swizzled_ids(cfg)
    swizzled = pixel_ids is not None
    if not swizzled:
        pixel_ids = jnp.arange(R, dtype=jnp.uint32)

    def one_spp(s, acc):
        fr = jnp.uint32(frame) * jnp.uint32(cfg.spp) + jnp.uint32(s)
        seeds = rng.pixel_seeds(pixel_ids, fr)
        o, d = generate_rays(camera, cfg, pixel_ids, seeds)
        radiance = trace_paths(scene, cfg, o, d, seeds, closest, any_hit)
        return acc + radiance

    total = jax.lax.fori_loop(
        0, cfg.spp, one_spp, jnp.zeros((R, 3), cfg.jnp_dtype()))
    total = total / cfg.spp
    if swizzled:
        return _unswizzle_image(total, cfg)
    return total.reshape(cfg.height, cfg.width, 3)


def accumulate(state: RenderState, sample: jax.Array,
               weight: int = 1) -> RenderState:
    """Progressive average update — the linear-space equivalent of
    ``(avg*(N-1) + x) / N`` (kernel_bvh.cl:453-455)."""
    return RenderState(
        radiance_sum=state.radiance_sum + sample * weight,
        num_samples=state.num_samples + weight,
    )


def to_image(state_or_radiance, gamma: float = 2.2) -> jax.Array:
    """Gamma-encode linear radiance for display (ToGamma,
    kernel_bvh.cl:405-408: value^(1/2.2))."""
    lin = (state_or_radiance.mean()
           if isinstance(state_or_radiance, RenderState)
           else state_or_radiance)
    return jnp.power(jnp.maximum(lin, 0.0), 1.0 / gamma)


@functools.partial(jax.jit, static_argnames=("cfg", "frames"))
def render(scene: Scene, camera: Camera, cfg: RenderConfig,
           frames: int = 1,
           bvh: Optional["bvh_mod.BVH"] = None,
           accel=None) -> jax.Array:
    """Render ``frames`` progressive samples and return the gamma-encoded
    image [H, W, 3] — the headless equivalent of letting the reference's
    window accumulate ``frames`` frames."""
    def body(f, st):
        return accumulate(st, render_sample(scene, camera, cfg, frame=f,
                                            bvh=bvh, accel=accel))
    state = jax.lax.fori_loop(0, frames, body, RenderState.create(cfg))
    return to_image(state, cfg.gamma)


def render_radiance(scene: Scene, camera: Camera, cfg: RenderConfig,
                    frames: int = 1,
                    bvh: Optional["bvh_mod.BVH"] = None,
                    accel=None) -> jax.Array:
    """Like ``render`` but returns the *linear* mean radiance (the
    quantity used for gradient-based optimization and FD tests)."""
    def body(f, st):
        return accumulate(st, render_sample(scene, camera, cfg, frame=f,
                                            bvh=bvh, accel=accel))
    state = jax.lax.fori_loop(0, frames, body, RenderState.create(cfg))
    return state.mean()
