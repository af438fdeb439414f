"""Differentiable-rendering utilities: gradient APIs + finite-difference
validation.

The reference has no gradients at all; differentiability is a headline
capability of this rebuild (BASELINE.json metric: "pixel-grad allclose
vs FD"). Design (SURVEY.md section 7, step 5):

* Forward rendering uses *hard* closest hits (exact, matches the
  reference's semantics). Inside a fixed triangle assignment the pixel
  value is a smooth function of vertices / normals / materials / lights /
  camera, and the recompute-on-winner pattern (ops/shading.hit_attributes)
  exposes exactly that smooth path to autodiff. These "interior"
  gradients are FD-validated in tests/test_grad.py.
* At visibility silhouettes the true derivative has a Dirac edge term
  that hard rasterization drops. For optimization through visibility the
  jittered-subpixel sampling already in the pipeline acts as a box-filter
  prefilter, so multi-frame-averaged FD and VJP agree in expectation;
  per-sample gradients are one-sided. (Reparameterized edge gradients
  are the follow-up that slots into hit_attributes.)

``loss_fn`` below is any scalar function of the linear radiance image.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from .config import RenderConfig
from .models.scene import Camera, Scene
from .render import render_radiance


def render_loss(scene: Scene, camera: Camera, cfg: RenderConfig,
                loss_fn: Callable[[jax.Array], jax.Array],
                frames: int = 1) -> jax.Array:
    """Scalar loss of the rendered linear radiance."""
    return loss_fn(render_radiance(scene, camera, cfg, frames=frames))


def grad_float_leaves(f: Callable, pytree):
    """jax.grad over only the float leaves of a pytree (integer leaves —
    mat_idx, light_type — are held constant and get zero entries).

    Returns a pytree of the same structure with gradients in float leaves
    and zeros in integer leaves.
    """
    leaves, treedef = jtu.tree_flatten(pytree)
    is_float = [jnp.issubdtype(jnp.asarray(l).dtype, jnp.floating)
                for l in leaves]

    def merged(float_leaves):
        it = iter(float_leaves)
        full = [next(it) if isf else leaf
                for leaf, isf in zip(leaves, is_float)]
        return jtu.tree_unflatten(treedef, full)

    float_in = [l for l, isf in zip(leaves, is_float) if isf]
    gfloat = jax.grad(lambda fl: f(merged(fl)))(float_in)

    it = iter(gfloat)
    out = [next(it) if isf else jnp.zeros_like(leaf)
           for leaf, isf in zip(leaves, is_float)]
    return jtu.tree_unflatten(treedef, out)


def scene_grad(scene: Scene, camera: Camera, cfg: RenderConfig,
               loss_fn: Callable[[jax.Array], jax.Array],
               frames: int = 1) -> Scene:
    """d(loss)/d(scene) — gradients w.r.t. every float leaf of the scene
    pytree (vertices, normals, uvs, materials, lights)."""
    return grad_float_leaves(
        lambda s: render_loss(s, camera, cfg, loss_fn, frames=frames),
        scene)


def camera_grad(scene: Scene, camera: Camera, cfg: RenderConfig,
                loss_fn: Callable[[jax.Array], jax.Array],
                frames: int = 1) -> Camera:
    """d(loss)/d(camera)."""
    return jax.grad(
        lambda c: render_loss(scene, c, cfg, loss_fn, frames=frames)
    )(camera)


def finite_difference(f: Callable[[jax.Array], jax.Array],
                      x: jax.Array, eps: float = 1e-3) -> jax.Array:
    """Central finite differences of scalar ``f`` w.r.t. every element of
    ``x`` (dense; use on small parameter sets only)."""
    flat = x.reshape(-1)
    n = flat.shape[0]

    def one(i):
        e = jnp.zeros_like(flat).at[i].set(eps)
        return (f((flat + e).reshape(x.shape))
                - f((flat - e).reshape(x.shape))) / (2.0 * eps)

    return jnp.stack([one(i) for i in range(n)]).reshape(x.shape)


def fd_check(f: Callable[[jax.Array], jax.Array], x: jax.Array,
             eps: float = 1e-3, rtol: float = 5e-2,
             atol: float = 1e-4) -> Tuple[jax.Array, jax.Array, bool]:
    """Compare autodiff grad vs central FD. Returns (ad, fd, allclose)."""
    ad = jax.grad(f)(x)
    fd = finite_difference(f, x, eps=eps)
    ok = bool(jnp.allclose(ad, fd, rtol=rtol, atol=atol))
    return ad, fd, ok
