"""Expert-parallel (EP) material routing: MoE-style all-to-all ray
binning by material class.

The EP row of SURVEY.md section 2's parallelism inventory — the MoE
analog of the reference's per-ray BRDF lobe switch (SampleBrdf,
kernel_bvh.cl:294-302). Materials are partitioned over the ``ep`` mesh
axis (material m lives on device m % ep); each device's resident rays
are binned by their hit material's owner, all-to-all'd to that owner
with fixed per-peer capacity (the standard MoE dispatch), shaded there
against the owner's *local* material shard only, and all-to-all'd back.

On a lane-select SIMD machine the single-kernel path already evaluates
both lobes for every lane, so EP routing buys nothing for the built-in
BRDF — this module exists for material systems whose per-class shading
is too heavy or too divergent to evaluate everywhere (many-BSDF scenes,
measured materials), and as the routing fabric those systems need. The
capacity-overflow convention is also MoE's: overflowing rays are
dropped by the dispatch and report ``routed=False`` so the caller can
shade them locally (the test sizes capacity so none drop).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import RenderConfig
from ..models.scene import Camera, Scene
from ..ops.linalg import all_finite, dot


class EpResult(NamedTuple):
    values: jax.Array   # [R_local, F_out] routed computation results
    routed: jax.Array   # [R_local] bool — False where capacity dropped


def ep_route(payload: jax.Array, owner: jax.Array, ep_axis: str,
             capacity: int, eval_fn: Callable[[jax.Array], jax.Array],
             out_features: int) -> EpResult:
    """Inside shard_map: send each row of ``payload`` [R, F] to device
    ``owner[r]`` over ``ep_axis`` (capacity-padded all-to-all), apply
    ``eval_fn`` ([ep * capacity, F] -> [ep * capacity, F_out]) on the
    owning device, and return results to the rows' home device."""
    ep = jax.lax.axis_size(ep_axis)
    R = payload.shape[0]
    F = payload.shape[1]

    order = jnp.argsort(owner, stable=True)
    sorted_owner = owner[order]
    group_start = jnp.searchsorted(sorted_owner,
                                   jnp.arange(ep, dtype=owner.dtype))
    pos = jnp.arange(R) - group_start[sorted_owner]
    ok = pos < capacity
    # Flat dispatch buffer with one trash slot for overflow rows.
    slot = jnp.where(ok, sorted_owner * capacity + pos, ep * capacity)
    send = jnp.zeros((ep * capacity + 1, F), payload.dtype)
    send = send.at[slot].set(payload[order])
    send = send[:-1].reshape(ep, capacity, F)

    recv = jax.lax.all_to_all(send, ep_axis, split_axis=0, concat_axis=0,
                              tiled=False)
    out = eval_fn(recv.reshape(ep * capacity, F))
    out = out.reshape(ep, capacity, out_features)
    back = jax.lax.all_to_all(out, ep_axis, split_axis=0, concat_axis=0,
                              tiled=False)

    flat = jnp.concatenate(
        [back.reshape(ep * capacity, out_features),
         jnp.zeros((1, out_features), back.dtype)], axis=0)
    res_sorted = flat[slot]
    values = jnp.zeros((R, out_features), back.dtype).at[order].set(
        res_sorted)
    routed = jnp.zeros((R,), bool).at[order].set(ok)
    return EpResult(values=values, routed=routed)


def ep_shade_demo(positions: jax.Array, normals: jax.Array,
                  mat_idx: jax.Array, materials_diffuse: jax.Array,
                  light_pos: jax.Array, mesh: Mesh,
                  ep_axis: str = "ep", capacity: int = None) -> jax.Array:
    """Reference EP pipeline: Lambert direct shading where material m's
    diffuse row lives ONLY on device m % ep — rays are routed to their
    material's owner, shaded against the local shard, and routed home.

    Inputs are full (unsharded) arrays; rays are pixel-sharded over the
    ep axis for the demo. Returns [R, 3] shaded colors, equal to the
    local computation (tests assert equality).
    """
    ep = mesh.shape[ep_axis]
    R = positions.shape[0]
    M = materials_diffuse.shape[0]
    M_per = -(-M // ep)
    if capacity is None:
        capacity = -(-R // ep)  # ample for the demo

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(ep_axis), P(ep_axis), P(ep_axis), P(), P()),
        out_specs=P(ep_axis),
        check_vma=False)
    def body(pos_s, n_s, mi_s, mats, lpos):
        my = jax.lax.axis_index(ep_axis)
        # This device's resident material shard (m owned by m % ep).
        local_ids = my + ep * jnp.arange(M_per)
        local_kd = jnp.take(mats, jnp.minimum(local_ids, M - 1), axis=0)

        owner = (mi_s % ep).astype(jnp.int32)
        payload = jnp.concatenate(
            [pos_s, n_s, (mi_s // ep).astype(jnp.float32)[:, None]],
            axis=1)

        def shade_local(rows):
            p, n, mrow = rows[:, 0:3], rows[:, 3:6], rows[:, 6]
            kd = jnp.take(local_kd,
                          jnp.clip(mrow.astype(jnp.int32), 0, M_per - 1),
                          axis=0)
            to_l = lpos[None, :] - p
            dist2 = jnp.maximum(dot(to_l, to_l), 1e-12)
            l_unit = to_l / jnp.sqrt(dist2)[:, None]
            ndotl = jnp.maximum(dot(n, l_unit), 0.0)
            return kd * (ndotl / dist2)[:, None]

        res = ep_route(payload, owner, ep_axis, capacity, shade_local, 3)
        # Capacity-overflow fallback (module docstring contract): rays
        # the dispatch dropped are shaded locally against the replicated
        # table instead of silently going black.
        kd_full = jnp.take(mats, jnp.clip(mi_s.astype(jnp.int32), 0, M - 1),
                           axis=0)
        to_l = lpos[None, :] - pos_s
        dist2 = jnp.maximum(dot(to_l, to_l), 1e-12)
        l_unit = to_l / jnp.sqrt(dist2)[:, None]
        ndotl = jnp.maximum(dot(n_s, l_unit), 0.0)
        local = kd_full * (ndotl / dist2)[:, None]
        return jnp.where(res.routed[:, None], res.values, local)

    return body(positions, normals, mat_idx, materials_diffuse, light_pos)


# ---------------------------------------------------------------------------
# EP-integrated path tracing: material-routed shading of the real hit
# wavefront (EP wired into the renderer, not just a routing fabric).

def render_sample_ep(scene: Scene, camera: Camera, cfg: RenderConfig,
                     mesh: Mesh, frame=0, ep_axis: str = "dp",
                     capacity: int = None) -> jax.Array:
    """One progressive sample with pixels sharded over ``ep_axis`` AND
    the material table logically sharded over it: material ``m`` is
    owned by device ``m % ep``, and every bounce's material-dependent
    shading (the BRDF lobe sampling of SampleBrdf, kernel_bvh.cl:
    294-302, plus the Kd/Ks/Ke/Ns fetch) runs on the OWNER after a
    capacity-padded all-to-all of the hit wavefront — the MoE dispatch
    applied to rays. Geometry stays replicated; intersection,
    throughput/radiance updates and the direct-light sum stay local.

    Semantics are identical to render.render_sample (equivalence-tested
    at 8 virtual devices): the routed shading consumes the same
    counter-based RNG sites, and capacity-overflow rays fall back to
    local shading against the replicated table per the module contract.
    """
    from ..ops import rng
    from ..ops.brdf import sample_brdf
    from ..ops.camera import generate_rays
    from ..ops.lights import direct_light
    from ..ops.shading import build_shading_table, hit_attributes
    from ..render import make_intersectors, resolve_backend

    R = cfg.num_pixels
    ep = mesh.shape[ep_axis]
    if R % ep:
        raise ValueError(f"pixels {R} not divisible by ep={ep}")
    M = scene.materials.diffuse.shape[0]
    M_per = -(-M // ep)
    cap = capacity if capacity is not None else R // ep
    pixel_ids = jnp.arange(R, dtype=jnp.uint32)
    backend = resolve_backend(scene, cfg)
    dtype = cfg.jnp_dtype()
    sky = jnp.asarray(cfg.sky_color, dtype) * cfg.skybox_intensity

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(ep_axis), P(), P()),
        out_specs=P(ep_axis),
        check_vma=False)
    def body(ids_shard, scene_rep, camera_rep):
        my = jax.lax.axis_index(ep_axis)
        mats = scene_rep.materials
        # This device's resident material shard (m owned by m % ep) —
        # the 18-feature record the owner returns per routed ray.
        local_ids = jnp.minimum(my + ep * jnp.arange(M_per), M - 1)
        loc_kd = jnp.take(mats.diffuse, local_ids, axis=0)
        loc_ks = jnp.take(mats.specular, local_ids, axis=0)
        loc_ke = jnp.take(mats.emission, local_ids, axis=0)
        loc_ns = jnp.take(mats.roughness, local_ids, axis=0)

        closest, any_hit = make_intersectors(scene_rep, cfg,
                                             backend=backend)
        occ = any_hit if cfg.shadow_rays else None
        st = build_shading_table(scene_rep.geometry, scene_rep.materials)
        tri_mat = scene_rep.geometry.mat_idx.astype(jnp.int32)

        def bounce_step(carry, bounce):
            o, d, beta, radiance, alive, seeds = carry
            hit = closest(o, d)
            at = hit_attributes(o, d, hit, st,
                                backface_cull=cfg.backface_cull,
                                soft_sigma=cfg.soft_edge_sigma)
            cov = at.coverage[:, None]
            mi = jnp.take(tri_mat, hit.tri_idx)
            wo = -d

            # --- routed material shading -----------------------------
            owner = (mi % ep).astype(jnp.int32)
            seeds_f = jax.lax.bitcast_convert_type(seeds, jnp.float32)
            payload = jnp.concatenate(
                [at.normal, wo, seeds_f[:, None],
                 (mi // ep).astype(jnp.float32)[:, None]], axis=1)

            def shade_remote(rows):
                n_r = rows[:, 0:3]
                wo_r = rows[:, 3:6]
                seeds_r = jax.lax.bitcast_convert_type(rows[:, 6],
                                                       jnp.uint32)
                mrow = jnp.clip(rows[:, 7].astype(jnp.int32), 0,
                                M_per - 1)
                kd = jnp.take(loc_kd, mrow, axis=0)
                ks = jnp.take(loc_ks, mrow, axis=0)
                ke = jnp.take(loc_ke, mrow, axis=0)
                ns = jnp.take(loc_ns, mrow)
                s = sample_brdf(wo_r, n_r, kd, ks, ns, seeds_r, bounce,
                                specular_prob=cfg.specular_prob,
                                specular_model=cfg.specular_model)
                return jnp.concatenate(
                    [s.wi, s.f, s.pdf[:, None],
                     s.valid.astype(jnp.float32)[:, None],
                     kd, ks, ke, ns[:, None]], axis=1)

            res = ep_route(payload, owner, ep_axis, cap, shade_remote, 18)

            # Overflow fallback: local shading against the replicated
            # table (module docstring contract).
            s_loc = sample_brdf(wo, at.normal, at.kd, at.ks, at.ns,
                                seeds, bounce,
                                specular_prob=cfg.specular_prob,
                                specular_model=cfg.specular_model)
            local_vals = jnp.concatenate(
                [s_loc.wi, s_loc.f, s_loc.pdf[:, None],
                 s_loc.valid.astype(jnp.float32)[:, None],
                 at.kd, at.ks, at.ke, at.ns[:, None]], axis=1)
            vals = jnp.where(res.routed[:, None], res.values, local_vals)
            wi, f, pdf = vals[:, 0:3], vals[:, 3:6], vals[:, 6]
            valid = vals[:, 7] > 0.5
            kd, ks, ke, ns = (vals[:, 8:11], vals[:, 11:14],
                              vals[:, 14:17], vals[:, 17])

            # --- local bounce recurrence (integrator.make_bounce_step,
            # with the routed material record substituted) -------------
            miss = alive & ~hit.hit
            radiance = radiance + jnp.where(miss[:, None],
                                            beta * sky[None, :], 0.0)
            live = alive & hit.hit
            if cfg.soft_edge_sigma > 0.0:
                radiance = radiance + jnp.where(
                    live[:, None], (1.0 - cov) * beta * sky[None, :], 0.0)
            radiance = radiance + jnp.where(
                live[:, None], cov * beta * ke * cfg.emission_scale, 0.0)

            cos_i = dot(wi, at.normal)
            pdf_safe = jnp.where(pdf > 0.0, pdf, 1.0)
            mul = f * (cos_i / pdf_safe)[:, None]
            ok = (valid & (pdf > 0.0)
                  & all_finite(mul))
            beta_new = jnp.where((live & ok)[:, None], beta * mul, beta)

            dl = direct_light(
                scene_rep.lights, at.pos, at.normal, wo, ns,
                occluder_fn=occ, direct_specular=cfg.direct_specular,
                shadow_eps=cfg.ray_epsilon)
            direct = dl.diffuse_weight[:, None] * kd
            if cfg.direct_specular:
                direct = direct + dl.specular_weight[:, None] * ks
            radiance = radiance + jnp.where(
                (live & ok)[:, None], cov * direct * beta_new, 0.0)

            alive_next = live & ok
            o_next = jnp.where(alive_next[:, None],
                               at.pos + wi * cfg.ray_epsilon, o)
            d_next = jnp.where(alive_next[:, None], wi, d)
            return (o_next, d_next, beta_new, radiance, alive_next,
                    seeds), None

        def one_spp(s, acc):
            seeds = rng.pixel_seeds(
                ids_shard, jnp.uint32(frame) * jnp.uint32(cfg.spp)
                + jnp.uint32(s))
            o, d = generate_rays(camera_rep, cfg, ids_shard, seeds)
            init = (o, d, jnp.ones_like(o), jnp.zeros_like(o),
                    jnp.ones(o.shape[:1], bool), seeds)
            (_, _, _, radiance, _, _), _ = jax.lax.scan(
                bounce_step, init,
                jnp.arange(cfg.bounces, dtype=jnp.int32))
            return acc + jnp.maximum(radiance, 0.0)

        total = jax.lax.fori_loop(
            0, cfg.spp, one_spp,
            jnp.zeros((ids_shard.shape[0], 3), dtype))
        return total / cfg.spp

    radiance = jax.jit(body)(pixel_ids, scene, camera)
    return radiance.reshape(cfg.height, cfg.width, 3)
