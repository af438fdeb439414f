"""Gradient correctness: autodiff vs central finite differences for
materials, lights, camera, and vertex positions (BASELINE.json metric:
'pixel-grad allclose vs FD'; SURVEY.md section 4 'Gradient tests')."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mini_opencl_raytracer as mrt
from mini_opencl_raytracer import grad as gradlib

# Small, single-bounce, no-jitter-sensitive losses keep FD well-behaved.
CFG = mrt.RenderConfig(width=24, height=24, bounces=1,
                       backend="bruteforce", specular_prob=0.0)
CAM = mrt.Camera.default()


def _loss_of_scene(scene):
    return gradlib.render_loss(scene, CAM, CFG, lambda img: jnp.sum(img))


def test_material_diffuse_grad_fd(cornell):
    """d loss / d Kd: smooth (no visibility term), must match FD tightly."""
    base = cornell.materials.diffuse

    def f(kd):
        s = cornell.replace(materials=cornell.materials.replace(diffuse=kd))
        return _loss_of_scene(s)

    ad = jax.grad(f)(base)
    # FD on two material channels only (dense FD over all 18 is slow).
    for idx in [(0, 0), (4, 1)]:
        eps = 1e-2
        e = jnp.zeros_like(base).at[idx].set(eps)
        fd = (f(base + e) - f(base - e)) / (2 * eps)
        assert np.isfinite(float(fd))
        np.testing.assert_allclose(float(ad[idx]), float(fd),
                                   rtol=2e-2, atol=1e-3)
    # Gradient w.r.t. wall diffuse must be positive (more albedo ->
    # brighter image).
    assert float(ad[0, 0]) > 0.0


def test_light_intensity_grad_fd(cornell):
    base = cornell.lights.intensity

    def f(inten):
        s = cornell.replace(lights=cornell.lights.replace(intensity=inten))
        return _loss_of_scene(s)

    ad = jax.grad(f)(base)
    # Direct lighting is linear in intensity; a large FD step is exact in
    # infinite precision and beats f32 cancellation noise.
    eps = 0.1
    e = jnp.zeros_like(base).at[0].set(eps)
    fd = (f(base + e) - f(base - e)) / (2 * eps)
    np.testing.assert_allclose(float(ad[0]), float(fd), rtol=2e-2, atol=1e-4)
    assert float(ad[0]) > 0.0


def test_light_position_grad_fd(cornell):
    base = cornell.lights.position

    def f(pos):
        s = cornell.replace(lights=cornell.lights.replace(position=pos))
        return _loss_of_scene(s)

    ad = jax.grad(f)(base)
    for idx in [(0, 1), (0, 2)]:
        eps = 1e-2
        e = jnp.zeros_like(base).at[idx].set(eps)
        fd = (f(base + e) - f(base - e)) / (2 * eps)
        np.testing.assert_allclose(float(ad[idx]), float(fd),
                                   rtol=5e-2, atol=1e-3)


def test_camera_position_grad_fd(cornell):
    def f(pos):
        cam = CAM.replace(position=pos)
        return gradlib.render_loss(cornell, cam, CFG,
                                   lambda img: jnp.sum(img))

    base = CAM.position
    ad = jax.grad(f)(base)
    eps = 1e-3
    e = jnp.zeros_like(base).at[1].set(eps)
    fd = (f(base + e) - f(base - e)) / (2 * eps)
    # Camera motion shifts silhouettes -> small edge error is expected;
    # interior term dominates at this scale.
    np.testing.assert_allclose(float(ad[1]), float(fd), rtol=0.2, atol=5e-2)


def test_vertex_position_grad_interior(cornell):
    """Gradient w.r.t. the back-wall geometry through the smooth
    (interior) path: perturbing the wall along +y moves it away from the
    point light -> less irradiance -> loss decreases. FD vs AD."""
    v1 = cornell.geometry.v1

    def f(v1_new):
        s = cornell.replace(geometry=cornell.geometry.replace(v1=v1_new))
        return _loss_of_scene(s)

    ad = jax.grad(f)(v1)
    assert np.isfinite(np.asarray(ad)).all()
    # FD on one coordinate of one back-wall triangle corner.
    back_wall = int(np.argmax(np.asarray(cornell.geometry.v0)[:, 1]))
    eps = 5e-3
    e = jnp.zeros_like(v1).at[back_wall, 1].set(eps)
    fd = (f(v1 + e) - f(v1 - e)) / (2 * eps)
    np.testing.assert_allclose(float(ad[back_wall, 1]), float(fd),
                               rtol=0.2, atol=5e-2)


def _floating_triangle_scene():
    """One triangle floating in front of the camera against the sky —
    the minimal silhouette-against-background setup."""
    g = mrt.Geometry(
        v0=jnp.array([[-4.0, 0.0, 4.0]]),
        v1=jnp.array([[4.0, 0.0, 4.0]]),
        v2=jnp.array([[0.0, 0.0, 12.0]]),
        n0=jnp.array([[0.0, -1.0, 0.0]]),
        n1=jnp.array([[0.0, -1.0, 0.0]]),
        n2=jnp.array([[0.0, -1.0, 0.0]]),
        uv0=jnp.zeros((1, 2)), uv1=jnp.zeros((1, 2)), uv2=jnp.zeros((1, 2)),
        mat_idx=jnp.zeros((1,), jnp.int32))
    m = mrt.Materials(
        diffuse=jnp.array([[0.7, 0.2, 0.2]]),
        specular=jnp.zeros((1, 3)),
        emission=jnp.zeros((1, 3)),
        roughness=jnp.array([9999.0]),
        ior=jnp.array([1.0]))
    return mrt.Scene(geometry=g, materials=m,
                     lights=mrt.Lights.default_point())


def test_silhouette_vertex_grad_fd():
    """Edge-aware visibility gradients (soft_edge_sigma > 0): moving a
    vertex changes which pixels the triangle covers; with the soft
    relaxation the forward is smooth across the silhouette, so AD must
    match FD through the *visibility* change — the term hard rendering
    drops (round-2 verdict #8)."""
    scene = _floating_triangle_scene()
    cfg = mrt.RenderConfig(width=24, height=24, bounces=1,
                           backend="bruteforce", specular_prob=0.0,
                           soft_edge_sigma=0.05)
    cam = mrt.Camera.default()

    def f(v2):
        s = scene.replace(geometry=scene.geometry.replace(v2=v2))
        return gradlib.render_loss(s, cam, cfg, lambda img: jnp.sum(img))

    base = scene.geometry.v2
    ad = jax.grad(f)(base)
    # Perturb the apex along +z: grows the triangle -> more sky covered.
    eps = 2e-2
    e = jnp.zeros_like(base).at[0, 2].set(eps)
    fd = (f(base + e) - f(base - e)) / (2 * eps)
    assert abs(float(fd)) > 1e-3, "test setup: silhouette term is live"
    np.testing.assert_allclose(float(ad[0, 2]), float(fd),
                               rtol=5e-2, atol=1e-3)
    # Hard mode drops the silhouette term for this pure-visibility setup:
    cfg_hard = mrt.RenderConfig(width=24, height=24, bounces=1,
                                backend="bruteforce", specular_prob=0.0)
    def f_hard(v2):
        s = scene.replace(geometry=scene.geometry.replace(v2=v2))
        return gradlib.render_loss(s, cam, cfg_hard,
                                   lambda img: jnp.sum(img))
    ad_hard = jax.grad(f_hard)(base)
    assert np.isfinite(np.asarray(ad_hard)).all()


def test_soft_edge_mega_matches_bruteforce():
    """The soft-coverage path must agree across backends too (the LBVH
    backend against the dense sweep)."""
    scene = _floating_triangle_scene()
    cam = mrt.Camera.default()
    kw = dict(width=24, height=24, bounces=2, soft_edge_sigma=0.05)
    img_b = np.asarray(mrt.render_sample(
        scene, cam, mrt.RenderConfig(backend="bruteforce", **kw)))
    img_m = np.asarray(mrt.render_sample(
        scene, cam, mrt.RenderConfig(backend="bvh", **kw)))
    np.testing.assert_allclose(img_m, img_b, atol=2e-5, rtol=1e-4)


def test_scene_grad_api(cornell):
    g = gradlib.scene_grad(cornell, CAM, CFG, lambda img: jnp.mean(img))
    assert isinstance(g, mrt.Scene)
    # Float leaves populated, int leaves zero.
    assert np.asarray(g.materials.diffuse).shape == \
        np.asarray(cornell.materials.diffuse).shape
    assert np.abs(np.asarray(g.materials.diffuse)).sum() > 0
    assert np.asarray(g.geometry.mat_idx).sum() == 0


def test_material_optimization_converges(cornell):
    """Benchmark config 4 capability: optimize a material to match a
    target render (tiny version)."""
    cfg = mrt.RenderConfig(width=16, height=16, bounces=1,
                           backend="bruteforce", specular_prob=0.0)
    target_kd = cornell.materials.diffuse
    target = mrt.render_radiance(cornell, CAM, cfg)

    def loss(kd):
        s = cornell.replace(materials=cornell.materials.replace(diffuse=kd))
        img = mrt.render_radiance(s, CAM, cfg)
        return jnp.mean((img - target) ** 2)

    kd = target_kd * 0.3 + 0.2  # wrong start
    # Adam (host-side): the raw MSE gradient scale is dominated by the few
    # emissive pixels, so plain GD needs an absurd LR; per-parameter
    # normalization is the standard fix (benchmark config 4's loop). The
    # update runs in NumPy so the only compiled graph is grad(loss).
    g = jax.jit(jax.grad(loss))
    l0 = float(loss(kd))
    kd = np.asarray(kd, np.float64)
    m = np.zeros_like(kd)
    v = np.zeros_like(kd)
    lr, b1, b2, eps = 5e-2, 0.9, 0.999, 1e-8
    for i in range(1, 61):
        gi = np.asarray(g(jnp.asarray(kd, jnp.float32)), np.float64)
        m = b1 * m + (1 - b1) * gi
        v = b2 * v + (1 - b2) * gi * gi
        mh = m / (1 - b1 ** i)
        vh = v / (1 - b2 ** i)
        kd = kd - lr * mh / (np.sqrt(vh) + eps)
    l1 = float(loss(jnp.asarray(kd, jnp.float32)))
    assert l1 < l0 * 0.2


@pytest.mark.parametrize("lobe", ["safe_sqrt", "blinn", "ggx"])
def test_grads_finite_at_lobe_pole(lobe):
    """A half-vector sampled at its lobe's pole has sin(theta_h) = 0;
    a plain sqrt's infinite slope there made the roughness gradient NaN
    for every material (seen at 1080p x 9 bounces)."""
    from mini_opencl_raytracer.ops import brdf
    from mini_opencl_raytracer.ops.linalg import safe_sqrt
    if lobe == "safe_sqrt":
        g = jax.grad(lambda x: jnp.sum(safe_sqrt(x)))(
            jnp.array([0.0, -1.0, 4.0]))
        np.testing.assert_allclose(np.asarray(g), [0.0, 0.0, 0.25])
        return
    n = jnp.array([[0.0, 0.0, 1.0]])
    wo = jnp.array([[0.0, 0.6, 0.8]])
    ks = jnp.full((1, 3), 0.5)
    # u2 = 1 puts the Blinn sample at the pole, u2 = 0 the GGX one.
    u1, u2 = jnp.array([0.3]), jnp.array([1.0 if lobe == "blinn" else 0.0])
    sample = brdf.sample_specular if lobe == "blinn" else \
        brdf.sample_specular_ggx

    def f(ns):
        s = sample(wo, n, ks, ns, u1, u2)
        return jnp.sum(s.f) + jnp.sum(s.pdf) + jnp.sum(s.wi)

    g = jax.grad(f)(jnp.array([50.0]))
    assert np.isfinite(np.asarray(g)).all()
