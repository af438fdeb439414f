"""Distributed tests on 8 virtual CPU devices (SURVEY.md section 4):
sharded renders must match the single-device render."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

import mini_opencl_raytracer as mrt
from mini_opencl_raytracer.config import MeshConfig
from mini_opencl_raytracer.parallel import mesh as mesh_mod
from mini_opencl_raytracer.parallel.shard import (render_sample_a2a,
                                                      render_sample_dp,
                                                      render_sample_ring)

CFG = mrt.RenderConfig(width=32, height=32, bounces=2,
                       backend="bruteforce", ray_chunk=256)
CAM = mrt.Camera.default()

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def reference_image(cornell):
    return np.asarray(mrt.render_sample(cornell, CAM, CFG))


def test_dp_sharded_matches_single(cornell, reference_image):
    mesh_cfg = MeshConfig(dp=8, tp=1)
    mesh = mesh_mod.make_mesh(mesh_cfg)
    img = np.asarray(render_sample_dp(cornell, CAM, CFG, mesh,
                                      mesh_cfg=mesh_cfg))
    np.testing.assert_allclose(img, reference_image, rtol=1e-5, atol=1e-5)


def test_ring_sharded_matches_single(cornell, reference_image):
    """dp=4 x tp=2: pixels sharded AND geometry ring-sharded."""
    mesh_cfg = MeshConfig(dp=4, tp=2)
    mesh = mesh_mod.make_mesh(mesh_cfg)
    img = np.asarray(render_sample_ring(cornell, CAM, CFG, mesh,
                                        mesh_cfg=mesh_cfg))
    np.testing.assert_allclose(img, reference_image, rtol=1e-4, atol=1e-4)


def test_ring_tp4(cornell, reference_image):
    mesh_cfg = MeshConfig(dp=2, tp=4)
    mesh = mesh_mod.make_mesh(mesh_cfg)
    img = np.asarray(render_sample_ring(cornell, CAM, CFG, mesh,
                                        mesh_cfg=mesh_cfg))
    np.testing.assert_allclose(img, reference_image, rtol=1e-4, atol=1e-4)


def test_a2a_sharded_matches_single(cornell, reference_image):
    """Ulysses-style all-to-all traversal (all_gather rays + local shard
    intersect + pmin/pmax combine) matches the single-device render."""
    mesh_cfg = MeshConfig(dp=2, tp=4)
    mesh = mesh_mod.make_mesh(mesh_cfg)
    img = np.asarray(render_sample_a2a(cornell, CAM, CFG, mesh,
                                       mesh_cfg=mesh_cfg))
    np.testing.assert_allclose(img, reference_image, rtol=1e-4, atol=1e-4)


def test_ring_bvh_backend(cornell, reference_image):
    """Geometry-sharded ring traversal with the LBVH backend per
    shard."""
    cfg = mrt.RenderConfig(width=32, height=32, bounces=2, backend="bvh",
                           ray_chunk=256)
    mesh_cfg = MeshConfig(dp=4, tp=2)
    mesh = mesh_mod.make_mesh(mesh_cfg)
    img = np.asarray(render_sample_ring(cornell, CAM, cfg, mesh,
                                        mesh_cfg=mesh_cfg))
    np.testing.assert_allclose(img, reference_image, rtol=1e-4, atol=1e-4)


def test_dp_mega_backend(cornell, reference_image):
    """DP-sharded render on the LBVH backend (traversal inside
    shard_map) matches the single-device oracle."""
    cfg = mrt.RenderConfig(width=32, height=32, bounces=2, backend="bvh")
    mesh_cfg = MeshConfig(dp=8, tp=1)
    mesh = mesh_mod.make_mesh(mesh_cfg)
    img = np.asarray(render_sample_dp(cornell, CAM, cfg, mesh,
                                      mesh_cfg=mesh_cfg))
    np.testing.assert_allclose(img, reference_image, rtol=1e-4, atol=1e-4)


def test_dp_honors_spp(cornell):
    """render_sample_dp with spp=2 must average two decorrelated samples
    exactly like the single-device render_sample."""
    cfg = mrt.RenderConfig(width=32, height=32, bounces=2,
                           backend="bruteforce", ray_chunk=256, spp=2)
    single = np.asarray(mrt.render_sample(cornell, CAM, cfg))
    mesh_cfg = MeshConfig(dp=8, tp=1)
    mesh = mesh_mod.make_mesh(mesh_cfg)
    img = np.asarray(render_sample_dp(cornell, CAM, cfg, mesh,
                                      mesh_cfg=mesh_cfg))
    np.testing.assert_allclose(img, single, rtol=1e-5, atol=1e-5)


def test_pipeline_matches_single(cornell, reference_image):
    """GPipe-style bounce pipeline (parallel/pipeline.py): 2 stages x
    1 bounce each, 4 microbatches — must reproduce the single-device
    render exactly (same transitions, same RNG, partitioned in time)."""
    import numpy as np_
    from jax.sharding import Mesh as Mesh_
    from mini_opencl_raytracer.parallel.pipeline import render_sample_pp
    mesh = Mesh_(np_.asarray(jax.devices()[:2]), ("pp",))
    img = np.asarray(render_sample_pp(cornell, CAM, CFG, mesh, n_micro=4))
    np.testing.assert_allclose(img, reference_image, rtol=1e-5, atol=1e-5)


def test_sharded_gradients_match(cornell):
    """Gradients w.r.t. materials through the sharded render must match
    the single-device gradients (psum correctness)."""
    mesh_cfg = MeshConfig(dp=8, tp=1)
    mesh = mesh_mod.make_mesh(mesh_cfg)

    def loss_single(kd):
        s = cornell.replace(materials=cornell.materials.replace(diffuse=kd))
        return jnp.mean(mrt.render_sample(s, CAM, CFG))

    def loss_dp(kd):
        s = cornell.replace(materials=cornell.materials.replace(diffuse=kd))
        return jnp.mean(render_sample_dp(s, CAM, CFG, mesh,
                                         mesh_cfg=mesh_cfg))

    kd = cornell.materials.diffuse
    g1 = np.asarray(jax.grad(loss_single)(kd))
    g2 = np.asarray(jax.grad(loss_dp)(kd))
    np.testing.assert_allclose(g1, g2, rtol=1e-4, atol=1e-6)


def test_ep_material_routing():
    """MoE-style expert-parallel material routing (parallel/expert.py):
    rays all-to-all'd to their material's owning device, shaded against
    that device's local material shard, routed home — must equal the
    plain local computation."""
    from jax.sharding import Mesh as Mesh_
    from mini_opencl_raytracer.parallel.expert import ep_shade_demo

    ep = 4
    mesh = Mesh_(np.asarray(jax.devices()[:ep]), ("ep",))
    r = np.random.default_rng(0)
    R, M = 512, 11
    pos = jnp.asarray(r.uniform(-5, 5, size=(R, 3)).astype(np.float32))
    nrm = r.normal(size=(R, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = jnp.asarray(nrm)
    mi = jnp.asarray(r.integers(0, M, size=(R,)).astype(np.int32))
    kd = jnp.asarray(r.uniform(size=(M, 3)).astype(np.float32))
    lpos = jnp.asarray(np.array([0.0, -10.0, 16.0], np.float32))

    out = np.asarray(ep_shade_demo(pos, nrm, mi, kd, lpos, mesh))
    # Local oracle.
    to_l = np.asarray(lpos)[None, :] - np.asarray(pos)
    dist2 = np.maximum((to_l * to_l).sum(1), 1e-12)
    lu = to_l / np.sqrt(dist2)[:, None]
    ndotl = np.maximum((np.asarray(nrm) * lu).sum(1), 0.0)
    ref = np.asarray(kd)[np.asarray(mi)] * (ndotl / dist2)[:, None]
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_graft_entry_dryrun():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_graft_entry_single():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (256, 256, 3)
    assert bool(jnp.isfinite(out).all())


def test_ep_render_matches_single(cornell, reference_image):
    """EP-integrated path tracer (material-routed per-bounce shading,
    parallel/expert.render_sample_ep) must match the single-device
    render exactly: same RNG sites, routed Kd/Ks/Ke/Ns fetched from the
    owner's shard only."""
    from mini_opencl_raytracer.parallel.expert import render_sample_ep
    mesh_cfg = MeshConfig(dp=8, tp=1)
    mesh = mesh_mod.make_mesh(mesh_cfg)
    img = np.asarray(render_sample_ep(cornell, CAM, CFG, mesh,
                                      ep_axis=mesh_cfg.dp_axis))
    np.testing.assert_allclose(img, reference_image, rtol=1e-5, atol=1e-5)


def test_ep_render_capacity_overflow_fallback(cornell, reference_image):
    """A deliberately undersized capacity drops most rays from the
    dispatch; the local fallback must keep the image exact."""
    from mini_opencl_raytracer.parallel.expert import render_sample_ep
    mesh_cfg = MeshConfig(dp=8, tp=1)
    mesh = mesh_mod.make_mesh(mesh_cfg)
    img = np.asarray(render_sample_ep(cornell, CAM, CFG, mesh,
                                      ep_axis=mesh_cfg.dp_axis,
                                      capacity=4))
    np.testing.assert_allclose(img, reference_image, rtol=1e-5, atol=1e-5)


def test_train_step_dp_bucketed_grads_match(cornell):
    """Manual-psum training step: bucketed (overlapped placement) and
    single-psum gradients must both equal the single-device gradient."""
    from mini_opencl_raytracer.parallel.shard import train_step_dp
    mesh_cfg = MeshConfig(dp=8, tp=1)
    mesh = mesh_mod.make_mesh(mesh_cfg)

    loss1, g1 = train_step_dp(cornell, CAM, CFG, mesh, mesh_cfg=mesh_cfg,
                              grad_buckets=1)
    loss4, g4 = train_step_dp(cornell, CAM, CFG, mesh, mesh_cfg=mesh_cfg,
                              grad_buckets=4)

    def loss_single(kd):
        s = cornell.replace(materials=cornell.materials.replace(diffuse=kd))
        return jnp.mean(mrt.render_sample(s, CAM, CFG))

    g_ref = np.asarray(jax.grad(loss_single)(cornell.materials.diffuse))
    np.testing.assert_allclose(float(loss1), float(loss4), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g1.materials.diffuse), g_ref,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g4.materials.diffuse), g_ref,
                               rtol=1e-4, atol=1e-6)
