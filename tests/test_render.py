"""End-to-end render tests: oracle sanity, backend equivalence,
progressive accumulation math (SURVEY.md section 4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mini_opencl_raytracer as mrt


CFG = mrt.RenderConfig(width=64, height=64, bounces=3, backend="bruteforce")


@pytest.fixture(scope="module")
def oracle_image(cornell):
    return np.asarray(mrt.render_sample(cornell, mrt.Camera.default(), CFG))


def test_render_shapes_and_finite(oracle_image):
    assert oracle_image.shape == (64, 64, 3)
    assert np.isfinite(oracle_image).all()
    assert (oracle_image >= 0).all()


def test_render_nontrivial(oracle_image):
    """The Cornell box must produce a structured image: red tint on the
    left, green on the right, nonzero content in most pixels."""
    img = oracle_image
    assert (img.sum(-1) > 0).mean() > 0.5
    left = img[:, : 16]
    right = img[:, -16:]
    assert left[..., 0].mean() > left[..., 1].mean()    # red wall side
    assert right[..., 1].mean() > right[..., 0].mean()  # green wall side


def test_bvh_backend_matches_oracle(cornell):
    cfg_bvh = mrt.RenderConfig(width=64, height=64, bounces=3, backend="bvh")
    img_oracle = mrt.render_sample(cornell, mrt.Camera.default(), CFG)
    img_bvh = mrt.render_sample(cornell, mrt.Camera.default(), cfg_bvh)
    np.testing.assert_allclose(np.asarray(img_oracle), np.asarray(img_bvh),
                               rtol=1e-4, atol=1e-4)


def test_accumulation_math():
    """(avg*(N-1)+x)/N equivalence (kernel_bvh.cl:449-455): our linear
    sum/count must reproduce the reference's running average."""
    r = np.random.default_rng(0)
    samples = r.uniform(size=(5, 4, 4, 3)).astype(np.float32)
    state = mrt.RenderState.create(mrt.RenderConfig(width=4, height=4))
    ref_avg = np.zeros((4, 4, 3), np.float32)
    for n, s in enumerate(samples, start=1):
        state = mrt.accumulate(state, jnp.asarray(s))
        ref_avg = (ref_avg * (n - 1) + s) / n
    np.testing.assert_allclose(np.asarray(state.mean()), ref_avg, rtol=1e-5)


def test_progressive_converges(cornell):
    """More frames -> less noise: variance between two independent 4-frame
    averages must exceed variance between two 16-frame averages."""
    cam = mrt.Camera.default()
    cfg = mrt.RenderConfig(width=32, height=32, bounces=2,
                           backend="bruteforce")

    def avg(f0, n):
        st = mrt.RenderState.create(cfg)
        for f in range(f0, f0 + n):
            st = mrt.accumulate(st, mrt.render_sample(cornell, cam, cfg,
                                                      frame=f))
        return np.asarray(st.mean())

    d_small = np.abs(avg(0, 2) - avg(2, 2)).mean()
    d_big = np.abs(avg(0, 8) - avg(8, 8)).mean()
    assert d_big < d_small


def test_jit_and_gamma(cornell):
    img = mrt.render(cornell, mrt.Camera.default(), CFG, frames=1)
    img = np.asarray(img)
    assert img.shape == (64, 64, 3)
    assert np.isfinite(img).all()


def test_light_types_differ(cornell):
    """Directional vs point light produce different images (lightPixel
    branches, kernel_bvh.cl:316-336)."""
    cam = mrt.Camera.default()
    sc_dir = cornell.replace(lights=mrt.Lights.default_directional())
    sc_pt = cornell.replace(lights=mrt.Lights.default_point())
    i1 = np.asarray(mrt.render_sample(sc_dir, cam, CFG))
    i2 = np.asarray(mrt.render_sample(sc_pt, cam, CFG))
    assert np.abs(i1 - i2).mean() > 1e-4


def test_shadow_rays_darken(cornell):
    cam = mrt.Camera.default()
    cfg_ns = mrt.RenderConfig(width=32, height=32, bounces=2,
                              backend="bruteforce", shadow_rays=False)
    cfg_sh = mrt.RenderConfig(width=32, height=32, bounces=2,
                              backend="bruteforce", shadow_rays=True)
    i_ns = np.asarray(mrt.render_sample(cornell, cam, cfg_ns))
    i_sh = np.asarray(mrt.render_sample(cornell, cam, cfg_sh))
    assert i_sh.sum() < i_ns.sum()
    assert (i_sh <= i_ns + 1e-5).mean() > 0.99


def test_sorted_wavefront_identical():
    """cfg.sort_rays permutes only the packet layout: per-ray radiance
    must match with sorting on and off (the sorted wavefront is
    restored to ray order before shading). Tolerance is compilation
    noise only: the sorted path runs the (already coherent) primary
    bounce outside the scan, so the same math compiles as a separate
    XLA program."""
    import mini_opencl_raytracer.models.procedural as proc
    scene = proc.bunny_scene(target_tris=4000)  # small but > sort threshold
    cam = mrt.Camera.default()
    kw = dict(width=16, height=16, bounces=2, backend="bvh")
    i0 = np.asarray(mrt.render_sample(
        scene, cam, mrt.RenderConfig(sort_rays=False, **kw)))
    i1 = np.asarray(mrt.render_sample(
        scene, cam, mrt.RenderConfig(sort_rays=True, **kw)))
    np.testing.assert_allclose(i1, i0, atol=2e-5, rtol=1e-4)


def test_swizzle_roundtrip():
    """Tile swizzle and unswizzle must be exact inverses: tracing pixel
    ids through the swizzled pipeline reproduces the identity image."""
    from mini_opencl_raytracer.render import (_swizzled_ids,
                                                  _unswizzle_image)
    cfg = mrt.RenderConfig(width=48, height=32)
    ids = _swizzled_ids(cfg)
    assert ids is not None
    # Values as fake radiance: pixel id in channel 0.
    fake = jnp.stack([ids.astype(jnp.float32)] * 3, axis=-1)
    img = _unswizzle_image(fake, cfg)
    expect = np.arange(cfg.num_pixels, dtype=np.float32).reshape(32, 48)
    np.testing.assert_array_equal(np.asarray(img[..., 0]), expect)
    # Swizzled ids are a permutation.
    assert sorted(np.asarray(ids).tolist()) == list(range(cfg.num_pixels))


def test_swizzle_fallback_odd_resolution():
    from mini_opencl_raytracer.render import _swizzled_ids
    assert _swizzled_ids(mrt.RenderConfig(width=50, height=30)) is None
    img = mrt.render_sample(
        mrt.cornell_scene(), mrt.Camera.default(),
        mrt.RenderConfig(width=40, height=20, bounces=1,
                         backend="bruteforce"))
    assert img.shape == (20, 40, 3)


def test_zero_bounces_black_all_paths(cornell):
    """bounces=0 must render black on every integrator path — the
    sorted variant hoists bounce 0 out of its scan and must not run it
    (round-5 review finding)."""
    cam = mrt.Camera.default()
    for sort in (False, True):
        cfg = mrt.RenderConfig(width=8, height=16, bounces=0,
                               backend="bruteforce", sort_rays=sort)
        img = np.asarray(mrt.render_sample(cornell, cam, cfg))
        assert img.shape == (16, 8, 3)
        np.testing.assert_array_equal(img, 0.0)
