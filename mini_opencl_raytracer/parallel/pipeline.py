"""Pipeline-parallel rendering: bounce segments as pipeline stages.

The PP row of SURVEY.md section 2's parallelism inventory: the path
recurrence (Render, kernel_bvh.cl:349-384) is a chain of identical
per-bounce transitions, so it pipelines the way transformer layers do —
stage p owns bounces [p*B/P, (p+1)*B/P) (scene replicated), and
*microbatches* of the pixel grid flow through the stages in a GPipe
schedule: at step t, stage p runs microbatch t-p, then the ray-wavefront
state (o, d, beta, radiance, alive, seeds) hops to stage p+1 between devices
with ``ppermute`` while stage p starts the next microbatch. After
n_micro + P - 1 steps every microbatch has traversed all bounces; the
last stage scatters finished radiance into the output buffer.

Numerically identical to the single-device render: the same
make_bounce_step transition runs with the same global bounce indices and
RNG draw sites (ops/integrator.make_bounce_step), only partitioned in
time. Utilization is (n_micro)/(n_micro + P - 1) — the classic pipeline
bubble; raise n_micro to amortize it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import MeshConfig, RenderConfig
from ..models.scene import Camera, Scene
from ..ops import rng
from ..ops.camera import generate_rays
from ..ops.integrator import make_bounce_step
from ..render import make_intersectors


def render_sample_pp(scene: Scene, camera: Camera, cfg: RenderConfig,
                     mesh: Mesh, frame=0, pp_axis: str = "pp",
                     n_micro: int = None) -> jax.Array:
    """One progressive sample with bounces pipelined over the ``pp``
    mesh axis -> linear radiance [H, W, 3]. ``cfg.bounces`` must divide
    evenly over the axis; ``n_micro`` microbatches (default: 2 * stages)
    must divide the pixel count."""
    pp = mesh.shape[pp_axis]
    if cfg.bounces % pp:
        raise ValueError(f"bounces {cfg.bounces} not divisible by "
                         f"pp={pp}")
    bps = cfg.bounces // pp
    if n_micro is None:
        n_micro = 2 * pp
    R = cfg.num_pixels
    if R % n_micro:
        raise ValueError(f"pixels {R} not divisible by n_micro={n_micro}")
    R_mb = R // n_micro

    # All microbatches' primary rays, generated once (replicated input).
    pixel_ids = jnp.arange(R, dtype=jnp.uint32)
    seeds = rng.pixel_seeds(pixel_ids, jnp.uint32(frame))
    o, d = generate_rays(camera, cfg, pixel_ids, seeds)
    o_mb = o.reshape(n_micro, R_mb, 3)
    d_mb = d.reshape(n_micro, R_mb, 3)
    s_mb = seeds.reshape(n_micro, R_mb)
    dtype = cfg.jnp_dtype()

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False)
    def body(o_all, d_all, s_all, scene_rep, camera_rep):
        p = jax.lax.axis_index(pp_axis)
        is_first = p == 0
        is_last = p == pp - 1
        closest, any_hit = make_intersectors(scene_rep, cfg)
        step = make_bounce_step(scene_rep, cfg, closest, any_hit)
        perm = [(i, i + 1) for i in range(pp - 1)]

        def fresh_state(mb):
            take = lambda a: jax.lax.dynamic_slice_in_dim(a, mb, 1, 0)[0]
            return (take(o_all), take(d_all),
                    jnp.ones((R_mb, 3), dtype),
                    jnp.zeros((R_mb, 3), dtype),
                    jnp.ones((R_mb,), bool),
                    take(s_all))

        def zeros_state():
            return (jnp.zeros((R_mb, 3), dtype),
                    jnp.zeros((R_mb, 3), dtype),
                    jnp.ones((R_mb, 3), dtype),
                    jnp.zeros((R_mb, 3), dtype),
                    jnp.zeros((R_mb,), bool),
                    jnp.zeros((R_mb,), jnp.uint32))

        def pipeline_step(t, carry):
            recv, outputs = carry
            mb = t - p
            active = (mb >= 0) & (mb < n_micro)
            mbc = jnp.clip(mb, 0, n_micro - 1)
            fresh = fresh_state(mbc)
            state = jax.tree_util.tree_map(
                lambda f, r: jnp.where(is_first, f, r), fresh, recv)
            # Run this stage's bounce segment (global bounce indices).
            bounces = p * bps + jnp.arange(bps, dtype=jnp.int32)
            state, _ = jax.lax.scan(step, state, bounces)
            # Last stage banks the finished microbatch's radiance.
            rad = jnp.maximum(state[3], 0.0)     # clamp, kernel_bvh.cl:383
            cur = jax.lax.dynamic_slice(outputs, (mbc, 0, 0),
                                        (1, R_mb, 3))
            val = jnp.where(active & is_last, rad[None], cur)
            outputs = jax.lax.dynamic_update_slice(outputs, val,
                                                   (mbc, 0, 0))
            # Hop the wavefront to the next stage (stage 0 receives
            # zeros, which it replaces with fresh rays; the last stage's
            # send is dropped).
            sent = jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(x, pp_axis, perm), state)
            return (sent, outputs)

        outputs0 = jnp.zeros((n_micro, R_mb, 3), dtype)
        _, outputs = jax.lax.fori_loop(0, n_micro + pp - 1, pipeline_step,
                                       (zeros_state(), outputs0))
        # Only the last stage holds real outputs; psum replicates them.
        return jax.lax.psum(outputs, pp_axis)

    out = jax.jit(body)(o_mb, d_mb, s_mb, scene, camera)
    return out.reshape(cfg.height, cfg.width, 3)
