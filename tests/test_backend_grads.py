"""Gradients through the LBVH backend against the dense sweep. Both
recompute the winning triangle's intersection differentiably, so every
float leaf's gradient agrees to float rounding."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mini_opencl_raytracer as mrt
from mini_opencl_raytracer import grad as gradlib

CAM = mrt.Camera.default()


def _loss(img):
    return jnp.mean(img)


def _close(a_tree, b_tree):
    for a, b in zip(jax.tree_util.tree_leaves(a_tree),
                    jax.tree_util.tree_leaves(b_tree)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4)


@pytest.mark.parametrize("part", ["materials", "lights", "camera",
                                  "shadow_rays", "vertices"])
def test_bvh_grads_match_bruteforce(cornell, part):
    kw = dict(width=12, height=12, bounces=2)
    if part == "shadow_rays":
        kw.update(bounces=1, shadow_rays=True)
    cfgs = [mrt.RenderConfig(backend=b, **kw) for b in ("bvh", "bruteforce")]
    if part == "camera":
        g = [gradlib.camera_grad(cornell, CAM, c, _loss) for c in cfgs]
        _close(g[0], g[1])
        assert np.abs(np.asarray(g[1].position)).max() > 0
        return
    g = [gradlib.scene_grad(cornell, CAM, c, _loss) for c in cfgs]
    pick = {"materials": lambda s: s.materials,
            "lights": lambda s: s.lights,
            "shadow_rays": lambda s: s,
            "vertices": lambda s: (s.geometry.v0, s.geometry.v1,
                                   s.geometry.v2)}[part]
    _close(pick(g[0]), pick(g[1]))
    assert max(np.abs(np.asarray(x)).max()
               for x in jax.tree_util.tree_leaves(pick(g[1]))) > 0
