"""The LBVH backend against the dense sweep, and how ``auto`` chooses
between them (render.resolve_backend). Both backends share the
integrator and the RNG draw sites, so images agree to float rounding."""

import numpy as np
import jax.numpy as jnp
import pytest

import mini_opencl_raytracer as mrt
from mini_opencl_raytracer.render import DENSE_MAX_TRIS, resolve_backend

CAM = mrt.Camera.default()

TWO_LIGHTS = dict(
    position=[[0.0, -10.0, 16.0], [5.0, -5.0, 10.0]],
    direction=[[-0.5, 0.4, -0.1], [0.0, 0.3, -1.0]],
    light_type=[0, 1], intensity=[1.0, 8.0], attenuation=[0.8, 0.5],
    cos_cutoff=[0.9, 0.9])


def _lights(spec):
    return mrt.Lights(**{k: jnp.asarray(v, jnp.int32 if k == "light_type"
                                        else jnp.float32)
                         for k, v in spec.items()})


def _soup(n, seed=7):
    """Random triangle soup of ``n`` triangles around the origin."""
    r = np.random.default_rng(seed)
    base = r.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    e1 = r.normal(scale=0.5, size=(n, 3)).astype(np.float32)
    e2 = r.normal(scale=0.5, size=(n, 3)).astype(np.float32)
    z3, z2 = jnp.zeros((n, 3)), jnp.zeros((n, 2))
    return mrt.Geometry(
        v0=jnp.asarray(base), v1=jnp.asarray(base + e1),
        v2=jnp.asarray(base + e2), n0=z3, n1=z3, n2=z3,
        uv0=z2, uv1=z2, uv2=z2, mat_idx=jnp.zeros((n,), jnp.int32))


def _rays(n, seed=3):
    r = np.random.default_rng(seed)
    o = r.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


FORWARD_CASES = {
    "default": dict(kw={}),
    "nonsquare_40x30": dict(kw=dict(width=40, height=30, bounces=2)),
    "directional_multi_light": dict(kw=dict(bounces=2), lights=TWO_LIGHTS),
    "ggx": dict(kw=dict(bounces=2, specular_model="ggx",
                        specular_prob=0.7)),
    "shadow_rays": dict(kw=dict(bounces=2, shadow_rays=True)),
    "shadow_rays_direct_specular": dict(kw=dict(
        bounces=2, shadow_rays=True, direct_specular=True)),
    "spp2_frames2": dict(kw=dict(bounces=2, spp=2), frames=2),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_bvh_forward_matches_bruteforce(cornell, case):
    spec = FORWARD_CASES[case]
    kw = dict(width=16, height=16, bounces=3)
    kw.update(spec["kw"])
    scene = cornell
    if "lights" in spec:
        scene = cornell.replace(lights=_lights(spec["lights"]))
    frames = spec.get("frames", 1)
    imgs = [np.asarray(mrt.render_radiance(
        scene, CAM, mrt.RenderConfig(backend=b, **kw), frames=frames))
        for b in ("bruteforce", "bvh")]
    assert imgs[0].shape == (kw["height"], kw["width"], 3)
    assert np.isfinite(imgs[0]).all() and imgs[0].max() > 0
    np.testing.assert_allclose(imgs[1], imgs[0], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("query", ["closest", "occlusion"])
def test_soup_above_auto_threshold(query):
    """A soup too large for the dense path resolves to ``bvh`` under
    ``auto`` and answers like the sweep, for a ray count that fills no
    power of two."""
    geo = _soup(DENSE_MAX_TRIS + 500)
    scene = mrt.Scene(geometry=geo, materials=mrt.Materials.zeros(1),
                      lights=mrt.Lights.default_point())
    cfg = mrt.RenderConfig()
    assert resolve_backend(scene, cfg) == "bvh"
    auto = mrt.make_intersectors(scene, cfg)
    dense = mrt.make_intersectors(scene, cfg, backend="bruteforce")
    o, d = _rays(1001)
    if query == "closest":
        a, b = auto[0](o, d), dense[0](o, d)
        np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
        m = np.asarray(b.hit)
        assert 0.05 < m.mean() < 0.95
        np.testing.assert_allclose(np.asarray(a.t)[m], np.asarray(b.t)[m],
                                   rtol=1e-4)
    else:
        limit = jnp.full((1001,), 3.0)
        a, b = auto[1](o, d, limit), dense[1](o, d, limit)
        assert 0.02 < np.asarray(b).mean() < 0.98
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_prebuilt_accel_identical_and_tracks_materials(cornell):
    """A BVH from build_accel gives the image of the in-frame build, and
    keeps following material edits (it holds geometry only)."""
    cfg = mrt.RenderConfig(width=16, height=16, bounces=2, backend="bvh")
    accel = mrt.build_accel(cornell, cfg)
    assert isinstance(accel, mrt.BVH)
    a = np.asarray(mrt.render_sample(cornell, CAM, cfg, frame=2))
    b = np.asarray(mrt.render_sample(cornell, CAM, cfg, frame=2,
                                     accel=accel))
    np.testing.assert_array_equal(a, b)
    mats = cornell.materials.replace(
        diffuse=cornell.materials.diffuse * 0.5)
    edited = cornell.replace(materials=mats)
    c = np.asarray(mrt.render_sample(edited, CAM, cfg, frame=2,
                                     accel=accel))
    d = np.asarray(mrt.render_sample(edited, CAM, cfg, frame=2))
    np.testing.assert_array_equal(c, d)
    assert np.abs(c - a).max() > 1e-3
    assert mrt.build_accel(cornell, mrt.RenderConfig()) is None


@pytest.mark.parametrize("backend,tris,expected", [
    ("auto", 36, "bruteforce"),
    ("auto", DENSE_MAX_TRIS + 1, "bvh"),
    ("mega", 36, ValueError),
    ("pallas", 36, ValueError),
])
def test_resolve_backend(backend, tris, expected):
    scene = mrt.Scene(geometry=_soup(tris), materials=mrt.Materials.zeros(1),
                      lights=mrt.Lights.default_point())
    cfg = mrt.RenderConfig(backend=backend)
    if expected is ValueError:
        with pytest.raises(ValueError, match="unknown backend"):
            resolve_backend(scene, cfg)
    else:
        assert resolve_backend(scene, cfg) == expected
