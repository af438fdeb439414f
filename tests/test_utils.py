"""Utility-layer tests: image IO, checkpoint/resume, metrics, CLI."""

import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

import mini_opencl_raytracer as mrt
from mini_opencl_raytracer.utils import checkpoint as ckpt
from mini_opencl_raytracer.utils.image import (to_uint8, write_npy,
                                                   write_pfm, write_png,
                                                   _write_png_pure)
from mini_opencl_raytracer.utils.metrics import render_metrics


def test_to_uint8_clips():
    img = np.array([[[-0.5, 0.5, 2.0]]])
    out = to_uint8(img)
    assert out.tolist() == [[[0, 128, 255]]]


def test_write_png_roundtrip(tmp_path):
    img = np.random.default_rng(0).uniform(size=(8, 8, 3)).astype(np.float32)
    p = str(tmp_path / "x.png")
    write_png(p, img)
    from PIL import Image
    back = np.asarray(Image.open(p))
    np.testing.assert_array_equal(back, to_uint8(img))


def test_pure_png_writer(tmp_path):
    img = np.random.default_rng(1).uniform(size=(4, 6, 3)).astype(np.float32)
    p = str(tmp_path / "pure.png")
    _write_png_pure(p, to_uint8(img))
    from PIL import Image
    back = np.asarray(Image.open(p))
    np.testing.assert_array_equal(back, to_uint8(img))


def test_write_pfm(tmp_path):
    img = np.random.default_rng(2).uniform(size=(4, 4, 3)).astype(np.float32)
    p = str(tmp_path / "x.pfm")
    write_pfm(p, img)
    with open(p, "rb") as f:
        assert f.readline() == b"PF\n"
        assert f.readline() == b"4 4\n"
        assert f.readline() == b"-1.0\n"
        data = np.frombuffer(f.read(), np.float32).reshape(4, 4, 3)
    np.testing.assert_allclose(data, img[::-1])


def test_checkpoint_roundtrip(tmp_path):
    cfg = mrt.RenderConfig(width=8, height=8)
    state = mrt.RenderState(
        radiance_sum=jnp.arange(8 * 8 * 3, dtype=jnp.float32).reshape(8, 8, 3),
        num_samples=jnp.int32(7))
    p = str(tmp_path / "state.npz")
    ckpt.save_render_state(p, state)
    back = ckpt.load_render_state(p, mrt.RenderState.create(cfg))
    np.testing.assert_allclose(np.asarray(back.radiance_sum),
                               np.asarray(state.radiance_sum))
    assert int(back.num_samples) == 7


def test_checkpoint_shape_mismatch(tmp_path):
    state = mrt.RenderState.create(mrt.RenderConfig(width=8, height=8))
    p = str(tmp_path / "state.npz")
    ckpt.save_render_state(p, state)
    with pytest.raises(ValueError):
        ckpt.load_render_state(
            p, mrt.RenderState.create(mrt.RenderConfig(width=16, height=16)))


def test_render_metrics():
    m = render_metrics(0.5, 100, 100, 4)
    assert m["rays_per_second"] == pytest.approx(100 * 100 * 4 / 0.5)
    assert m["fps"] == pytest.approx(2.0)


@pytest.mark.slow
def test_cli_render_and_resume(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = str(tmp_path / "img.png")
    ck = str(tmp_path / "st.npz")
    base = [sys.executable, "-m", "mini_opencl_raytracer.cli", "render",
            "--width", "32", "--height", "32", "--bounces", "2",
            "--backend", "bruteforce", "--frames", "2", "--out", out,
            "--checkpoint", ck]
    r = subprocess.run(base, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr
    assert os.path.exists(out) and os.path.exists(ck)
    # Resume two more frames.
    r2 = subprocess.run(base + ["--resume", ck], env=env,
                        capture_output=True, text=True, timeout=900)
    assert r2.returncode == 0, r2.stderr
    assert "resumed at 2 samples" in r2.stderr


def test_decode_error_classes():
    """Typed device-error layer (utils/errors.py): common runtime
    failures map to actionable typed exceptions; unknown ones pass
    through."""
    from mini_opencl_raytracer.utils import errors

    e = errors.decode_error(RuntimeError(
        "RESOURCE_EXHAUSTED: Allocation (size=68719476736) would exceed "
        "memory (size=17179869184)"))
    assert isinstance(e, errors.DeviceOutOfMemoryError)
    e = errors.decode_error(RuntimeError(
        "Unable to initialize backend 'cuda': no supported devices found"))
    assert isinstance(e, errors.NoAcceleratorError)
    assert errors.decode_error(ValueError("plain bug")) is None
    with pytest.raises(errors.DeviceOutOfMemoryError):
        errors.run_decoded(lambda: (_ for _ in ()).throw(
            RuntimeError("Out of memory while trying to allocate")))


def test_bounce_occupancy():
    """Per-bounce live-ray fractions: finite, in [0,1], monotone
    non-increasing (paths only die, kernel_bvh.cl:371-372)."""
    from mini_opencl_raytracer.utils.metrics import bounce_occupancy
    scene = mrt.cornell_scene()
    cfg = mrt.RenderConfig(width=16, height=16, bounces=3,
                           backend="bruteforce", ray_chunk=256)
    occ = np.asarray(bounce_occupancy(scene, mrt.Camera.default(), cfg))
    assert occ.shape == (3,)
    assert ((occ >= 0) & (occ <= 1)).all()
    assert (np.diff(occ) <= 1e-6).all()


def test_time_scan_slope_basic():
    """The slope harness must return the MARGINAL per-frame cost of a
    frame with real work (for a ~ns frame the slope is legitimately
    noise around zero, so the test frame carries a matmul)."""
    import jax.numpy as jnp
    from mini_opencl_raytracer.utils.metrics import (scan_frames,
                                                         time_scan_slope)

    def heavy(fr, data):
        x = data + fr.astype(jnp.float32)
        return jnp.sum(x @ x)

    data = jnp.ones((256, 256), jnp.float32)
    sec = time_scan_slope(heavy, inner_lo=2, inner_hi=10, iters=3,
                          data=data)
    assert sec > 0.0 and sec < 1.0

    def frame(fr, data):
        return jnp.sum(data * fr.astype(jnp.float32))

    # scan_frames sums distinct frames: 2 frames of sum(1*fr) from
    # base=3 -> 3+4 = 7 per element * 128.
    out = scan_frames(frame, 2)(jnp.uint32(3),
                                jnp.ones((128,), jnp.float32))
    assert float(out) == 128.0 * 7.0
