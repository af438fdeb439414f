"""Path-trace integrator: the bounce loop as a ``lax.scan`` over a ray
wavefront.

Re-design of ``Render`` (kernel_bvh.cl:349-384). The reference runs a
serial per-work-item loop with early breaks; here the whole pixel grid
advances in lockstep as one wavefront with per-lane ``alive`` masks —
data-dependent control flow becomes lane selects. The per-bounce
recurrence mirrors the reference:

  miss      -> radiance += beta * sky                 (kernel_bvh.cl:358-362)
  hit       -> radiance += beta * Ke * emission_scale (kernel_bvh.cl:365)
  sample    -> f, wi, pdf = SampleBrdf(...)           (kernel_bvh.cl:370)
  dead      -> pdf <= 0 or NaN ends the path          (kernel_bvh.cl:371-372)
  beta     *= f * (wi.n) / pdf                        (kernel_bvh.cl:374-375)
  direct    -> radiance += lightPixel * Kd * beta     (kernel_bvh.cl:378)
  respawn   -> ray = (pos + wi * eps, wi)             (kernel_bvh.cl:380)
  clamp     -> radiance = max(radiance, 0)            (kernel_bvh.cl:383)

The intersector is injected (brute-force sweep / BVH) so every
backend shares this exact code path — the basis of the cross-backend
allclose tests.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..models.scene import Scene
from . import rng
from .brdf import sample_brdf
from .bvh import morton3d
from .intersect import Hit
from .lights import direct_light
from .linalg import all_finite, dot
from .shading import build_shading_table, hit_attributes

# Above this triangle count the wavefront is coherence-sorted before
# each intersection (the auto value of cfg.sort_rays).
SORT_RAYS_MIN_TRIS = 2048


def _ray_sort_keys(o: jax.Array, d: jax.Array, lo: jax.Array,
                   hi: jax.Array) -> jax.Array:
    """uint32 coherence key: 3-bit direction octant (high bits) then the
    top 27 bits of the origin's 30-bit Morton code. Rays sharing a key
    prefix start near each other and head the same way."""
    octant = ((d[:, 0] > 0).astype(jnp.uint32) * 4
              + (d[:, 1] > 0).astype(jnp.uint32) * 2
              + (d[:, 2] > 0).astype(jnp.uint32))
    m = morton3d((o - lo) / jnp.maximum(hi - lo, 1e-12))
    return (octant << 29) | (m >> 3)


# Sort key for dead lanes: strictly above every live key (the live
# key's top octant bits reach at most 0xEFFFFFFF).
DEAD_KEY = 0xFFFFFFFF


def park_point(lo: jax.Array, hi: jax.Array) -> jax.Array:
    """Where dead lanes park: strictly outside every scene AABB, so a
    dead ray's traversal ends at the root's slab test."""
    return hi + (hi - lo) + 1.0


def _sorted_wavefront(scene: Scene, intersect_fn, occluder_fn):
    """Wrap the intersectors to run on a coherence-sorted permutation of
    the wavefront, restoring ray order on the way out. Per-ray values
    are unchanged (each lane's result depends only on its own ray).

    The permutation rides as sort payload (one multi-operand
    ``lax.sort`` each way, carrying the ray state / results alongside
    the keys) instead of argsort + gathers. Whether that beats a gather
    on the GPU has not been measured."""
    g = scene.geometry
    pts = jnp.concatenate([g.v0, g.v1, g.v2], axis=0)
    lo = jax.lax.stop_gradient(jnp.min(pts, axis=0))
    hi = jax.lax.stop_gradient(jnp.max(pts, axis=0))

    def forward_sort(o, d, extra=()):
        keys = _ray_sort_keys(jax.lax.stop_gradient(o),
                              jax.lax.stop_gradient(d), lo, hi)
        ridx = jnp.arange(keys.shape[0], dtype=jnp.uint32)
        ops = (keys, ridx, o[:, 0], o[:, 1], o[:, 2],
               d[:, 0], d[:, 1], d[:, 2]) + tuple(extra)
        out = jax.lax.sort(ops, num_keys=1, is_stable=True)
        os = jnp.stack(out[2:5], axis=-1)
        ds = jnp.stack(out[5:8], axis=-1)
        return out[1], os, ds, out[8:]

    def backward_sort(ridx, results):
        """Restore ray order: sort the result columns by original id."""
        out = jax.lax.sort((ridx,) + tuple(results), num_keys=1,
                           is_stable=True)
        return out[1:]

    def closest(o, d):
        ridx, os, ds, _ = forward_sort(o, d)
        h = intersect_fn(os, ds)
        t, tri, hitc = backward_sort(
            ridx, (h.t, h.tri_idx, h.hit.astype(jnp.int32)))
        return Hit(t=t, tri_idx=tri, hit=hitc > 0)

    if occluder_fn is None:
        return closest, None

    def any_hit(o, d, t_limit):
        ridx, os, ds, (tl,) = forward_sort(o, d, extra=(t_limit,))
        blocked = occluder_fn(os, ds, tl)
        (bl,) = backward_sort(ridx, (blocked.astype(jnp.int32),))
        return bl > 0

    return closest, any_hit


def trace_paths(
    scene: Scene,
    cfg: RenderConfig,
    origins: jax.Array,     # [R, 3]
    directions: jax.Array,  # [R, 3] unit
    seeds: jax.Array,       # [R] uint32 per-pixel seeds
    intersect_fn: Callable[[jax.Array, jax.Array], Hit],
    occluder_fn: Optional[Callable] = None,
    with_stats: bool = False,
) -> jax.Array:
    """Trace one wavefront for ``cfg.bounces`` bounces -> radiance [R, 3].

    ``with_stats=True`` additionally returns a per-bounce live-ray
    fraction vector [bounces] (the wavefront-occupancy observability the
    reference's FPS counter couldn't offer — utils/metrics.py)."""
    R = origins.shape[0]
    dtype = cfg.jnp_dtype()
    if cfg.bounces == 0:
        # Zero bounces renders black on every path (the sorted variant
        # below hoists bounce 0 out of its scan and must not run it).
        radiance = jnp.zeros((R, 3), dtype)
        if with_stats:
            return radiance, jnp.zeros((0,), dtype)
        return radiance
    sort_on = (cfg.sort_rays if cfg.sort_rays is not None
               else scene.num_triangles > SORT_RAYS_MIN_TRIS)
    if sort_on:
        return _trace_paths_sorted(scene, cfg, origins, directions, seeds,
                                   intersect_fn, occluder_fn, with_stats)
    step = make_bounce_step(scene, cfg, intersect_fn, occluder_fn,
                            with_stats=with_stats)
    init = (
        origins,
        directions,
        jnp.ones((R, 3), dtype),
        jnp.zeros((R, 3), dtype),
        jnp.ones((R,), bool),
        seeds,
    )
    (_, _, _, radiance, _, _), stats = jax.lax.scan(
        step, init, jnp.arange(cfg.bounces, dtype=jnp.int32))
    # Final clamp (kernel_bvh.cl:383).
    radiance = jnp.maximum(radiance, 0.0)
    if with_stats:
        return radiance, stats
    return radiance


def _trace_paths_sorted(scene, cfg, origins, directions, seeds,
                        intersect_fn, occluder_fn, with_stats):
    """Coherence-sorted wavefront with a permuted carry.

    The wavefront stays permuted across bounces instead of being
    restored to ray order after each intersection:

      * carry = (o, d, beta, radiance, alive, seeds, ridx), where ridx
        remembers each lane's original ray id;
      * each bounce re-sorts the already-permuted carry by the fresh
        coherence key (one multi-operand ``lax.sort`` per bounce) and
        runs the entire bounce body — intersection, attribute fetch,
        BRDF, lights, throughput — in the sorted domain;
      * dead lanes sort to the tail (key 0xFFFFFFFF) and are parked on
        rays strictly outside the scene AABB, so their traversal ends
        at the root;
      * one final small sort restores only radiance (3 columns) to
        pixel order.

    Per-lane values are identical to the unsorted integrator (each
    lane's result depends only on its own ray — test_render.py).
    """
    R = origins.shape[0]
    dtype = cfg.jnp_dtype()
    g = scene.geometry
    pts = jnp.concatenate([g.v0, g.v1, g.v2], axis=0)
    lo = jax.lax.stop_gradient(jnp.min(pts, axis=0))
    hi = jax.lax.stop_gradient(jnp.max(pts, axis=0))
    park_o = park_point(lo, hi)
    park_d = jnp.full((3,), 1.0 / jnp.sqrt(3.0), dtype)
    dead_key = jnp.uint32(DEAD_KEY)

    core = make_bounce_core(scene, cfg, intersect_fn, occluder_fn,
                            with_stats=with_stats)

    def sorted_step(carry, bounce):
        o, d, beta, radiance, alive, seeds_, ridx = carry
        keys = _ray_sort_keys(jax.lax.stop_gradient(o),
                              jax.lax.stop_gradient(d), lo, hi)
        keys = jnp.where(alive, keys, dead_key)
        ops = (keys, ridx, seeds_, alive.astype(jnp.int32),
               o[:, 0], o[:, 1], o[:, 2],
               d[:, 0], d[:, 1], d[:, 2],
               beta[:, 0], beta[:, 1], beta[:, 2],
               radiance[:, 0], radiance[:, 1], radiance[:, 2])
        out = jax.lax.sort(ops, num_keys=1, is_stable=True)
        ridx_s, seeds_s, alive_s = out[1], out[2], out[3] > 0
        o_s = jnp.stack(out[4:7], axis=-1)
        d_s = jnp.stack(out[7:10], axis=-1)
        beta_s = jnp.stack(out[10:13], axis=-1)
        rad_s = jnp.stack(out[13:16], axis=-1)
        am = alive_s[:, None]
        o_s = jnp.where(am, o_s, park_o[None, :])
        d_s = jnp.where(am, d_s, park_d[None, :])
        inner = (o_s, d_s, beta_s, rad_s, alive_s, seeds_s)
        (o2, d2, b2, r2, a2, s2), stat = core(inner, bounce)
        return (o2, d2, b2, r2, a2, s2, ridx_s), stat

    if cfg.remat:
        sorted_step = jax.checkpoint(sorted_step)

    # Bounce 0 runs unsorted: primary rays arrive tile-swizzled
    # (render._swizzled_ids) and are already coherent.
    step0 = (jax.checkpoint(core) if cfg.remat else core)
    init0 = (
        origins,
        directions,
        jnp.ones((R, 3), dtype),
        jnp.zeros((R, 3), dtype),
        jnp.ones((R,), bool),
        seeds,
    )
    inner0, stats0 = step0(init0, jnp.int32(0))
    ridx = jnp.arange(R, dtype=jnp.uint32)
    carry = inner0 + (ridx,)
    (_, _, _, radiance, _, _, ridx), stats = jax.lax.scan(
        sorted_step, carry, jnp.arange(1, cfg.bounces, dtype=jnp.int32))

    # Restore pixel order for the 3 radiance columns only.
    out = jax.lax.sort(
        (ridx, radiance[:, 0], radiance[:, 1], radiance[:, 2]),
        num_keys=1, is_stable=True)
    radiance = jnp.stack(out[1:4], axis=-1)
    radiance = jnp.maximum(radiance, 0.0)
    if with_stats:
        stats = (jnp.concatenate([stats0[None], stats]) if cfg.bounces > 1
                 else stats0[None])
        return radiance, stats
    return radiance


def make_bounce_step(scene: Scene, cfg: RenderConfig, intersect_fn,
                     occluder_fn=None, with_stats: bool = False):
    """Build the per-bounce transition of the reference recurrence
    (Render, kernel_bvh.cl:349-384) as a ``lax.scan``-shaped step:
    carry = (o, d, beta, radiance, alive, seeds), x = global bounce
    index. Used by parallel/pipeline (bounce segments as pipeline
    stages, which need order-preserving steps — coherence sorting
    happens per-step via the restore-order wrapper). trace_paths itself
    uses make_bounce_core, keeping the wavefront permuted across
    bounces (_trace_paths_sorted). Applies cfg.remat."""
    occ = occluder_fn if cfg.shadow_rays else None
    sort_on = (cfg.sort_rays if cfg.sort_rays is not None
               else scene.num_triangles > SORT_RAYS_MIN_TRIS)
    if sort_on:
        intersect_fn, occ = _sorted_wavefront(scene, intersect_fn, occ)
    core = make_bounce_core(scene, cfg, intersect_fn, occ,
                            with_stats=with_stats, _occ_prefiltered=True)
    return jax.checkpoint(core) if cfg.remat else core


def make_bounce_core(scene: Scene, cfg: RenderConfig, intersect_fn,
                     occluder_fn=None, with_stats: bool = False,
                     _occ_prefiltered: bool = False):
    """The UNSORTED per-bounce transition (no coherence wrapper, no
    remat): the shared body of make_bounce_step and
    _trace_paths_sorted."""
    dtype = cfg.jnp_dtype()
    sky = jnp.asarray(cfg.sky_color, dtype) * cfg.skybox_intensity

    if _occ_prefiltered:
        occ = occluder_fn
    else:
        occ = occluder_fn if cfg.shadow_rays else None

    # All per-hit attributes come from one fused table fetch (see
    # ops/shading.py) instead of the reference's pointer chases.
    st = build_shading_table(scene.geometry, scene.materials)

    def bounce_step(carry, bounce):
        o, d, beta, radiance, alive, seeds = carry

        hit = intersect_fn(o, d)
        at = hit_attributes(o, d, hit, st, backface_cull=cfg.backface_cull,
                            soft_sigma=cfg.soft_edge_sigma)
        # Soft-visibility blend weight (1.0 in hard mode): each hit
        # contribution is scaled by the winner's edge coverage and the
        # remainder falls through to the sky, so silhouettes carry
        # vertex gradients (config.soft_edge_sigma).
        cov = at.coverage[:, None]

        # Miss -> constant-grey sky (kernel_bvh.cl:92-96, 358-362).
        miss = alive & ~hit.hit
        radiance = radiance + jnp.where(miss[:, None], beta * sky[None, :], 0.0)

        live = alive & hit.hit
        if cfg.soft_edge_sigma > 0.0:
            radiance = radiance + jnp.where(
                live[:, None], (1.0 - cov) * beta * sky[None, :], 0.0)

        # Emission boost (kernel_bvh.cl:365: `* 50`).
        radiance = radiance + jnp.where(
            live[:, None], cov * beta * at.ke * cfg.emission_scale, 0.0)

        wo = -d
        sample = sample_brdf(wo, at.normal, at.kd, at.ks, at.ns, seeds,
                             bounce, specular_prob=cfg.specular_prob,
                             specular_model=cfg.specular_model)

        cos_i = dot(sample.wi, at.normal)
        pdf_safe = jnp.where(sample.pdf > 0.0, sample.pdf, 1.0)
        mul = sample.f * (cos_i / pdf_safe)[:, None]
        ok = (sample.valid & (sample.pdf > 0.0)
              & all_finite(mul))
        beta_new = jnp.where((live & ok)[:, None], beta * mul, beta)

        # Direct analytic light, weighted by Kd and the *updated* beta
        # (kernel_bvh.cl:374-378 order).
        dl = direct_light(
            scene.lights, at.pos, at.normal, wo, at.ns,
            occluder_fn=occ, direct_specular=cfg.direct_specular,
            shadow_eps=cfg.ray_epsilon)
        direct = dl.diffuse_weight[:, None] * at.kd
        if cfg.direct_specular:
            direct = direct + dl.specular_weight[:, None] * at.ks
        radiance = radiance + jnp.where(
            (live & ok)[:, None], cov * direct * beta_new, 0.0)

        alive_next = live & ok
        o_next = jnp.where(alive_next[:, None],
                           at.pos + sample.wi * cfg.ray_epsilon, o)
        d_next = jnp.where(alive_next[:, None], sample.wi, d)
        stat = jnp.mean(alive_next.astype(dtype)) if with_stats else None
        return (o_next, d_next, beta_new, radiance, alive_next, seeds), stat

    # Remat is applied by the callers (make_bounce_step /
    # _trace_paths_sorted) so the per-bounce sort sits inside the
    # checkpointed region: reverse-mode stores only the small scan carry
    # per bounce instead of every intermediate (SURVEY.md 'use
    # jax.checkpoint to trade FLOPs for memory').
    return bounce_step
