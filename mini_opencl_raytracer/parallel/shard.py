"""Sharded rendering: DP over pixel tiles + geometry-sharded ring traversal.

Re-design of the reference's only parallelism — the flat
one-work-item-per-pixel launch (CLRaytracer.cpp:53-54) — as first-class
multi-chip strategies (SURVEY.md section 2 'Parallelism & distributed-
communication inventory'):

* **DP**: the H*W ray grid is sharded over the ``dp`` mesh axis with
  ``shard_map``; scene/BVH replicated; zero communication until the
  final image assembly (the sharded axis IS the output layout).
* **TP (geometry-parallel ring)**: triangle buffers are sharded over the
  ``tp`` axis. Each chip intersects its resident triangle shard, then the
  *ray wavefront state* (o, d, best-hit) ring-rotates via ``ppermute``
  until every ray has visited every shard — the renderer's equivalent of
  ring attention (blockwise context parallelism): geometry stays put,
  activations (rays) move between devices.
* Gradients: ``psum`` over replicated scene params happens automatically
  via shard_map's reverse-mode transfer; see tests/test_sharding.py.

All functions work under ``jit`` with a Mesh from parallel/mesh.py and
are exercised on 8 virtual CPU devices in tests.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import MeshConfig, RenderConfig
from ..models.scene import Camera, Scene
from ..ops import rng
from ..ops.camera import generate_rays
from ..ops.integrator import trace_paths
from ..ops.intersect import Hit
from ..render import make_intersectors, resolve_backend


def render_sample_dp(scene: Scene, camera: Camera, cfg: RenderConfig,
                     mesh: Mesh, frame=0,
                     mesh_cfg: MeshConfig = MeshConfig()) -> jax.Array:
    """One progressive sample, pixels sharded over the ``dp`` axis,
    geometry replicated -> linear radiance [H, W, 3].

    The per-shard body is identical to render.render_sample — the same
    integrator and intersector run on a pixel slice; the flat pixel-id
    vector is what gets sharded (row-major, so shards are image rows).
    """
    R = cfg.num_pixels
    dp = mesh.shape[mesh_cfg.dp_axis]
    if R % dp:
        raise ValueError(f"pixels {R} not divisible by dp={dp}")
    pixel_ids = jnp.arange(R, dtype=jnp.uint32)
    backend = resolve_backend(scene, cfg)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(mesh_cfg.dp_axis), P(), P()),
        out_specs=P(mesh_cfg.dp_axis),
        check_vma=False)
    def body(ids_shard, scene_rep, camera_rep):
        closest, any_hit = make_intersectors(scene_rep, cfg,
                                             backend=backend)

        def one_spp(s, acc):
            seeds = rng.pixel_seeds(
                ids_shard, jnp.uint32(frame) * jnp.uint32(cfg.spp)
                + jnp.uint32(s))
            o, d = generate_rays(camera_rep, cfg, ids_shard, seeds)
            rad = trace_paths(scene_rep, cfg, o, d, seeds, closest, any_hit)
            return acc + rad

        total = jax.lax.fori_loop(
            0, cfg.spp, one_spp,
            jnp.zeros((ids_shard.shape[0], 3), cfg.jnp_dtype()))
        return total / cfg.spp

    # jit so the remat'd scan body (jax.checkpoint's closed_call) is legal
    # inside shard_map even when the caller didn't jit us; under an outer
    # jit this inner jit is inlined for free.
    radiance = jax.jit(body)(pixel_ids, scene, camera)
    return radiance.reshape(cfg.height, cfg.width, 3)


def _shard_geometry(geometry, tp: int, index: jax.Array):
    """Slice a triangle range for shard ``index`` (static equal split).

    Padding triangles are all-zero (v0 = v1 = v2 = 0): degenerate, so
    Moller-Trumbore's det == 0 rejects them on every backend, and —
    unlike an out-at-infinity sentinel — they keep BVH/cluster builds
    over the shard numerically finite.
    """
    T = geometry.v0.shape[0]
    per = -(-T // tp)

    def pad_take(a):
        pad = per * tp - T
        a = jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
        return jax.lax.dynamic_slice_in_dim(a, index * per, per, axis=0)

    return jax.tree_util.tree_map(pad_take, geometry), per


def ring_intersect(o: jax.Array, d: jax.Array, scene: Scene,
                   cfg: RenderConfig, tp_axis: str,
                   backend: str = "bruteforce") -> Hit:
    """Closest hit with geometry sharded over ``tp_axis``.

    Called *inside* shard_map. Each chip intersects the triangle shard it
    owns against its resident rays, then rotates the ray state (o, d,
    best t/idx) one hop around the ring with ``ppermute``; after tp hops
    every ray has met every triangle and is back home. Triangle indices
    are globalized with the owning shard's offset so shading gathers work
    on the replicated shading table.

    ``backend`` selects the per-shard intersector ("bruteforce" | "bvh"):
    the local acceleration structure is built once over the resident
    shard (traced LBVH build) and reused for every ring hop.
    """
    tp = jax.lax.axis_size(tp_axis)
    my = jax.lax.axis_index(tp_axis)

    geo_shard, per = _shard_geometry(scene.geometry, tp, my)
    closest, _ = make_intersectors(scene.replace(geometry=geo_shard), cfg,
                                   backend=backend)
    offset = my * per

    def local_hit(o_, d_):
        h = closest(o_, d_)
        return Hit(t=h.t, tri_idx=h.tri_idx + offset, hit=h.hit)

    # Hop 0: intersect the shard we own.
    best = local_hit(o, d)
    state = (o, d, best.t, best.tri_idx, best.hit.astype(jnp.int32))

    perm = [(i, (i + 1) % tp) for i in range(tp)]

    def hop(k, state):
        o_, d_, t_, idx_, hit_ = jax.tree_util.tree_map(
            lambda x: jax.lax.ppermute(x, tp_axis, perm), state)
        # After k+1 rotations these rays originated at my - (k+1); they
        # now get intersected against MY shard.
        h = local_hit(o_, d_)
        better = h.hit & (h.t < t_)
        return (o_, d_,
                jnp.where(better, h.t, t_),
                jnp.where(better, h.tri_idx, idx_),
                jnp.maximum(hit_, h.hit.astype(jnp.int32)))

    state = jax.lax.fori_loop(0, tp - 1, hop, state)
    # One final rotation brings every ray home.
    o_, d_, t_, idx_, hit_ = jax.tree_util.tree_map(
        lambda x: jax.lax.ppermute(x, tp_axis, perm), state)
    return Hit(t=t_, tri_idx=idx_, hit=hit_ > 0)


def a2a_intersect(o: jax.Array, d: jax.Array, scene: Scene,
                  cfg: RenderConfig, tp_axis: str,
                  backend: str = "bruteforce") -> Hit:
    """Ulysses-style closest hit with geometry sharded over ``tp_axis``.

    The all-to-all alternative to ring_intersect (SURVEY.md section 2
    'Ulysses-style all-to-all'): instead of P-1 neighbor hops of the ray
    state, ONE collective round re-shards the wavefront from
    "shard by pixel" to "replicated" (all_gather), every chip
    intersects the full wavefront against its resident geometry shard,
    and the per-ray closest hit is min-combined with pmin/pmax (the
    reduce-scatter back to pixel owners is a local slice of the
    replicated reduction). Same total intersection work as the ring;
    latency-bound workloads trade P-1 small sends for one big one.
    """
    tp = jax.lax.axis_size(tp_axis)
    my = jax.lax.axis_index(tp_axis)
    geo_shard, per = _shard_geometry(scene.geometry, tp, my)
    closest, _ = make_intersectors(scene.replace(geometry=geo_shard), cfg,
                                   backend=backend)

    o_all = jax.lax.all_gather(o, tp_axis, axis=0, tiled=True)
    d_all = jax.lax.all_gather(d, tp_axis, axis=0, tiled=True)
    h = closest(o_all, d_all)

    t = jnp.where(h.hit, h.t, jnp.float32(cfg.t_max))
    t_min = jax.lax.pmin(t, tp_axis)
    hit_any = jax.lax.pmax(h.hit.astype(jnp.int32), tp_axis) > 0
    # Winner = any shard achieving the min t; exact-t ties resolve to the
    # SMALLEST global index, matching ring_intersect and the
    # single-device brute path on coplanar/shared-edge geometry.
    cand = h.hit & (t <= t_min)
    big = jnp.int32(2**31 - 1)
    idx_min = jax.lax.pmin(
        jnp.where(cand, h.tri_idx + my * per, big), tp_axis)
    idx_min = jnp.where(hit_any, idx_min, -1)

    R_l = o.shape[0]
    sl = functools.partial(jax.lax.dynamic_slice_in_dim,
                           start_index=my * R_l, slice_size=R_l, axis=0)
    return Hit(t=sl(t_min), tri_idx=jnp.maximum(sl(idx_min), 0),
               hit=sl(hit_any))


def render_sample_a2a(scene: Scene, camera: Camera, cfg: RenderConfig,
                      mesh: Mesh, frame=0,
                      mesh_cfg: MeshConfig = MeshConfig()) -> jax.Array:
    """render_sample_ring's all-to-all sibling: pixels sharded over
    ``dp``, geometry sharded over ``tp``, traversal via a2a_intersect."""
    R = cfg.num_pixels
    dp = mesh.shape[mesh_cfg.dp_axis]
    if R % dp:
        raise ValueError(f"pixels {R} not divisible by dp={dp}")
    pixel_ids = jnp.arange(R, dtype=jnp.uint32)
    backend = resolve_backend(scene, cfg)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(mesh_cfg.dp_axis), P(), P()),
        out_specs=P(mesh_cfg.dp_axis),
        check_vma=False)
    def body(ids_shard, scene_rep, camera_rep):
        closest = functools.partial(a2a_intersect, scene=scene_rep,
                                    cfg=cfg, tp_axis=mesh_cfg.tp_axis,
                                    backend=backend)

        def any_hit(o, d, t_limit):
            h = closest(o, d)
            return h.hit & (h.t < t_limit)

        seeds = rng.pixel_seeds(ids_shard, jnp.uint32(frame))
        o, d = generate_rays(camera_rep, cfg, ids_shard, seeds)
        return trace_paths(scene_rep, cfg, o, d, seeds, closest, any_hit)

    radiance = jax.jit(body)(pixel_ids, scene, camera)
    return radiance.reshape(cfg.height, cfg.width, 3)


def render_sample_ring(scene: Scene, camera: Camera, cfg: RenderConfig,
                       mesh: Mesh, frame=0,
                       mesh_cfg: MeshConfig = MeshConfig()) -> jax.Array:
    """One progressive sample with pixels sharded over ``dp`` AND
    geometry sharded over ``tp`` (ring traversal) -> [H, W, 3].

    Shadow rays use the same ring (occlusion = ring closest-hit below the
    light distance). The per-shard intersector backend follows
    ``cfg.backend`` (render.resolve_backend).
    """
    R = cfg.num_pixels
    dp = mesh.shape[mesh_cfg.dp_axis]
    if R % dp:
        raise ValueError(f"pixels {R} not divisible by dp={dp}")
    pixel_ids = jnp.arange(R, dtype=jnp.uint32)
    backend = resolve_backend(scene, cfg)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(mesh_cfg.dp_axis), P(), P()),
        out_specs=P(mesh_cfg.dp_axis),
        check_vma=False)
    def body(ids_shard, scene_rep, camera_rep):
        closest = functools.partial(ring_intersect, scene=scene_rep,
                                    cfg=cfg, tp_axis=mesh_cfg.tp_axis,
                                    backend=backend)

        def any_hit(o, d, t_limit):
            h = closest(o, d)
            return h.hit & (h.t < t_limit)

        def one_spp(s, acc):
            seeds = rng.pixel_seeds(
                ids_shard, jnp.uint32(frame) * jnp.uint32(cfg.spp)
                + jnp.uint32(s))
            o, d = generate_rays(camera_rep, cfg, ids_shard, seeds)
            return acc + trace_paths(scene_rep, cfg, o, d, seeds, closest,
                                     any_hit)

        total = jax.lax.fori_loop(
            0, cfg.spp, one_spp,
            jnp.zeros((ids_shard.shape[0], 3), cfg.jnp_dtype()))
        return total / cfg.spp

    radiance = jax.jit(body)(pixel_ids, scene, camera)
    return radiance.reshape(cfg.height, cfg.width, 3)


def train_step_dp(scene: Scene, camera: Camera, cfg: RenderConfig,
                  mesh: Mesh, frame=0,
                  mesh_cfg: MeshConfig = MeshConfig(),
                  grad_buckets: int = 1):
    """One dp-sharded differentiable render step -> (loss, scene grads)
    with the gradient all-reduce placed MANUALLY inside shard_map
    (SURVEY.md section 2 comm row: "psum gradient all-reduce overlapped
    with backward traversal").

    ``grad_buckets=1`` is the baseline: one psum of the whole gradient
    pytree after the full backward. ``grad_buckets=k>1`` splits the
    pixel shard into k microbatches, run one after another by a
    ``lax.scan``: each microbatch's backward produces a gradient
    contribution whose psum is issued in the same scan step
    (DDP-style gradient bucketing). The microbatch is compiled once, and
    a scan step holds the residuals of one microbatch only, so buckets
    also bound the backward's memory. Loss = global mean radiance;
    gradients cover every float leaf of the scene (see
    grad.grad_float_leaves).
    """
    import jax.tree_util as jtu

    R = cfg.num_pixels
    dp = mesh.shape[mesh_cfg.dp_axis]
    if R % dp:
        raise ValueError(f"pixels {R} not divisible by dp={dp}")
    R_local = R // dp
    if R_local % grad_buckets:
        raise ValueError(
            f"local pixels {R_local} not divisible by {grad_buckets}")
    pixel_ids = jnp.arange(R, dtype=jnp.uint32)
    backend = resolve_backend(scene, cfg)
    denom = float(R * 3)

    leaves, treedef = jtu.tree_flatten(scene)
    is_float = [jnp.issubdtype(jnp.asarray(l).dtype, jnp.floating)
                for l in leaves]

    def merged(float_leaves):
        it = iter(float_leaves)
        full = [next(it) if isf else leaf
                for leaf, isf in zip(leaves, is_float)]
        return jtu.tree_unflatten(treedef, full)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(mesh_cfg.dp_axis), P(), P()),
        out_specs=(P(), P()),
        check_vma=False)
    def body(ids_shard, float_leaves, camera_rep):
        def chunk_loss(fl, ids_chunk):
            scene_l = merged(fl)
            closest, any_hit = make_intersectors(scene_l, cfg,
                                                 backend=backend)
            seeds = rng.pixel_seeds(ids_chunk, jnp.uint32(frame))
            o, d = generate_rays(camera_rep, cfg, ids_chunk, seeds)
            rad = trace_paths(scene_l, cfg, o, d, seeds, closest, any_hit)
            return jnp.sum(rad) / denom

        vg = jax.value_and_grad(chunk_loss)

        def bucket(acc, ids_chunk):
            loss_b, g_b = vg(float_leaves, ids_chunk)
            g_b = jax.lax.psum(g_b, mesh_cfg.dp_axis)
            return jtu.tree_map(jnp.add, acc, (loss_b, g_b)), None

        init = (jnp.zeros(()), jtu.tree_map(jnp.zeros_like, float_leaves))
        (loss_acc, g_acc), _ = jax.lax.scan(
            bucket, init, ids_shard.reshape(grad_buckets, -1))
        return jax.lax.psum(loss_acc, mesh_cfg.dp_axis), g_acc

    float_in = [l for l, isf in zip(leaves, is_float) if isf]
    loss, gfloat = jax.jit(body)(pixel_ids, float_in, camera)
    it = iter(gfloat)
    out = [next(it) if isf else jnp.zeros_like(leaf)
           for leaf, isf in zip(leaves, is_float)]
    return loss, jtu.tree_unflatten(treedef, out)
