"""The pytree dataclass helper, and the matmul precision of the render
path (XLA may run a default-precision f32 product at reduced precision
on a GPU's tensor cores)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jex_core

import mini_opencl_raytracer as mrt
from mini_opencl_raytracer import pytree


@pytree.dataclass
class _Pair:
    a: jax.Array
    b: jax.Array
    n: int = pytree.field(static=True, default=3)


def test_dataclass_round_trip():
    p = _Pair(a=jnp.arange(3.0), b=jnp.ones((2,)), n=5)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(q, _Pair) and q.n == 5
    np.testing.assert_array_equal(np.asarray(q.a), np.arange(3.0))
    with pytest.raises(Exception):
        p.a = jnp.zeros(3)  # frozen


def test_dataclass_replace():
    p = _Pair(a=jnp.zeros(2), b=jnp.ones(2))
    q = p.replace(b=jnp.full((2,), 7.0))
    assert float(q.b[0]) == 7.0 and float(p.b[0]) == 1.0
    assert q.a is p.a and q.n == p.n == 3
    scene = mrt.cornell_scene()
    s2 = scene.replace(lights=mrt.Lights.default_directional())
    assert int(s2.lights.light_type[0]) == mrt.LIGHT_DIRECTIONAL
    assert s2.geometry is scene.geometry


def test_dataclass_static_field():
    """A static field is tree structure, not a leaf: two values give two
    tree definitions, and grad leaves it alone."""
    p3, p4 = _Pair(jnp.zeros(1), jnp.zeros(1), 3), _Pair(
        jnp.zeros(1), jnp.zeros(1), 4)
    assert (jax.tree_util.tree_structure(p3)
            != jax.tree_util.tree_structure(p4))
    g = jax.grad(lambda p: jnp.sum(p.a * p.b) * p.n)(
        _Pair(jnp.ones(2), jnp.full((2,), 2.0), 3))
    assert g.n == 3
    np.testing.assert_allclose(np.asarray(g.a), [6.0, 6.0])
    bvh = mrt.build_bvh(mrt.cornell_geometry())
    leaves = jax.tree_util.tree_leaves(bvh)
    assert len(leaves) == 6 and all(isinstance(x, jax.Array) for x in leaves)


def test_dataclass_under_jit():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.n)
        return p.replace(a=p.a + p.n)

    out = f(_Pair(jnp.zeros(2), jnp.zeros(2), 2))
    out = f(_Pair(jnp.ones(2), jnp.zeros(2), 2))
    assert isinstance(out, _Pair) and out.n == 2
    np.testing.assert_allclose(np.asarray(out.a), [3.0, 3.0])
    assert traces == [2]
    f(_Pair(jnp.ones(2), jnp.zeros(2), 5))
    assert traces == [2, 5]


def _eqns(jaxpr):
    """Every equation of a jaxpr, sub-jaxprs (scan, while, cond, remat,
    custom rules) included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jex_core.ClosedJaxpr):
                    yield from _eqns(sub.jaxpr)
                elif isinstance(sub, jex_core.Jaxpr):
                    yield from _eqns(sub)


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in a jaxpr."""
    return [e.params["precision"] for e in _eqns(jaxpr)
            if e.primitive.name == "dot_general"]


@pytest.mark.parametrize("mode", ["forward", "gradient"])
def test_render_matmuls_at_highest_precision(cornell, mode):
    cfg = mrt.RenderConfig(width=8, height=8, bounces=2, shadow_rays=True)
    cam = mrt.Camera.default()

    def f(scene):
        return jnp.mean(mrt.render_sample(scene, cam, cfg))

    fn = f if mode == "forward" else jax.grad(f, allow_int=True)
    precs = _dot_precisions(jax.make_jaxpr(fn)(cornell).jaxpr)
    assert precs, "expected the one-hot attribute fetch matmul"
    hi = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and all(x == hi for x in p), precs


def test_render_has_no_length3_reductions(cornell):
    """Vector dot products and finiteness checks are written out per
    component (ops/linalg.py): the forward render reduces over no lone
    axis of length 3, the pattern the GPU compiler mislaunched."""
    cfg = mrt.RenderConfig(width=8, height=8, bounces=2, shadow_rays=True)
    cam = mrt.Camera.default()
    jaxpr = jax.make_jaxpr(
        lambda s: mrt.render_sample(s, cam, cfg))(cornell).jaxpr
    reductions = [e for e in _eqns(jaxpr)
                  if e.primitive.name.startswith(("reduce_", "argm"))]
    assert reductions, "expected the sweep's min/argmin"
    bad = [e for e in reductions
           if all(e.invars[0].aval.shape[a] == 3 for a in e.params["axes"])]
    assert not bad, bad
