"""BRDF sampling: cosine-hemisphere diffuse + Blinn/GGX-style specular.

Re-design of kernel_bvh.cl:221-302, fully vectorized over rays.

The reference's specular lobe is self-described as a "temporary hack"
(kernel_bvh.cl:231) and is numerically degenerate for MTL-style ``Ns``
exponents: it plugs the raw Ns into ``alpha = 2/Ns^2 - 2``
(kernel_bvh.cl:275), which for Ns > 1 yields a *negative* Blinn exponent
and cosTheta > 1. We spec-clean to the intended model — Blinn half-vector
sampling with exponent Ns (the identical formula applied to the standard
perceptual roughness r = sqrt(2/(Ns+2)) gives exactly alpha = Ns), a
matching Blinn NDF, Smith geometry (kernel_bvh.cl:241-257), and Schlick
Fresnel with F0 = 0.04 (kernel_bvh.cl:259-262, 283) — which the reference
computes but then drops from its outgoing colour (kernel_bvh.cl:289);
here D, G and F are all used.

Lobe selection is the reference's 50/50 russian roulette
(kernel_bvh.cl:294-302); note the reference does NOT divide by the lobe
probability, so we don't either (capability parity; energy conservation
follows the reference's convention).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import rng
from .linalg import build_onb, dot, reflect, safe_sqrt, spherical_dir

_TWO_PI = 2.0 * jnp.pi
_INV_PI = 1.0 / jnp.pi


class BrdfSample(NamedTuple):
    wi: jax.Array     # [R, 3] sampled incident direction
    f: jax.Array      # [R, 3] BRDF value
    pdf: jax.Array    # [R] sampling pdf
    valid: jax.Array  # [R] bool — sample admissible (pdf > 0, finite)


def sample_hemisphere_cosine(normal: jax.Array, u1: jax.Array,
                             u2: jax.Array) -> jax.Array:
    """Cosine-weighted hemisphere direction around ``normal``
    (SampleHemisphereCosine, kernel_bvh.cl:79-90): phi = 2 pi u1,
    sin^2(theta) = u2."""
    phi = _TWO_PI * u1
    sin_theta = jnp.sqrt(u2)
    cos_theta = safe_sqrt(1.0 - u2)
    s, t = build_onb(normal)
    return spherical_dir(s, t, normal, phi, sin_theta, cos_theta)


def sample_diffuse(normal: jax.Array, diffuse: jax.Array,
                   u1: jax.Array, u2: jax.Array) -> BrdfSample:
    """Lambert lobe (SampleDiffuse, kernel_bvh.cl:264-269):
    f = Kd/pi, pdf = cos(theta)/pi."""
    wi = sample_hemisphere_cosine(normal, u1, u2)
    cos_i = dot(wi, normal)
    pdf = cos_i * _INV_PI
    f = diffuse * _INV_PI
    valid = pdf > 0.0
    return BrdfSample(wi=wi, f=f, pdf=pdf, valid=valid)


def _smith_g(n, v, l, perceptual_roughness):
    """Smith geometry term with the reference's Schlick-GGX k mapping
    (GeometrySchlickGGX/GeometrySmith, kernel_bvh.cl:241-257)."""
    def g1(ndotx):
        r = perceptual_roughness + 1.0
        k = (r * r) / 8.0
        return ndotx / (ndotx * (1.0 - k) + k)
    ndotv = jnp.maximum(dot(n, v), 0.0)
    ndotl = jnp.maximum(dot(n, l), 0.0)
    return g1(ndotv) * g1(ndotl)


def fresnel_schlick(f0, cos_i):
    """FresnelSchlick (kernel_bvh.cl:259-262). x^5 as three multiplies —
    a float-exponent pow lowers to exp/log."""
    x = jnp.maximum(1.0 - cos_i, 0.0)
    x2 = x * x
    return f0 + (1.0 - f0) * (x2 * x2 * x)


def sample_specular(wo: jax.Array, normal: jax.Array, specular: jax.Array,
                    ns: jax.Array, u1: jax.Array, u2: jax.Array) -> BrdfSample:
    """Blinn half-vector lobe (SampleSpecular/SampleGGX,
    kernel_bvh.cl:227-239, 271-292), spec-cleaned (see module docstring).

    Blinn exponent alpha = Ns; half-vector pdf (alpha+1)/(2 pi) cos^alpha;
    D = (alpha+2)/(2 pi) cos^alpha; wi = reflect(wo, wh); full microfacet
    f = Ks D G F / (4 (n.wi)(n.wo) + 1e-3).
    """
    alpha = jnp.maximum(ns, 0.0)
    phi = _TWO_PI * u1
    # cos(theta_h) = u2^(1/(alpha+1)) — Blinn sampling (kernel_bvh.cl:231).
    u2c = jnp.clip(u2, 1e-12, 1.0)
    log_u2 = jnp.log(u2c)
    cos_h = jnp.exp(log_u2 / (alpha + 1.0))
    # sin^2 = 1 - cos^2 = -expm1(2 log(cos)): no cancellation near the
    # pole, where 1/sin scales the roughness gradient.
    sin_h = safe_sqrt(-jnp.expm1(2.0 * log_u2 / (alpha + 1.0)))
    s, t = build_onb(normal)
    wh = spherical_dir(s, t, normal, phi, sin_h, cos_h)
    wi = reflect(wo, wh)

    cos_i = dot(wi, normal)
    cos_o = dot(wo, normal)
    # Same-hemisphere test (kernel_bvh.cl:278).
    same_hemi = (cos_i * cos_o) >= 1e-6

    # cos^alpha(theta_h) = exp(alpha/(alpha+1) log u2) — reuses the
    # sampling log instead of a second pow's exp+log pair.
    cosn = jnp.exp(log_u2 * (alpha / (alpha + 1.0)))
    d_ndf = (alpha + 2.0) * (0.5 * _INV_PI) * cosn
    pdf_h = (alpha + 1.0) * (0.5 * _INV_PI) * cosn
    wo_dot_wh = jnp.maximum(dot(wo, wh), 0.0)
    pdf = pdf_h / jnp.maximum(4.0 * wo_dot_wh, 1e-8)

    g = _smith_g(normal, wo, wi, jnp.sqrt(2.0 / (alpha + 2.0)))
    fr = fresnel_schlick(jnp.float32(0.04), wo_dot_wh)
    denom = 4.0 * jnp.maximum(cos_i, 0.0) * jnp.maximum(cos_o, 0.0) + 1e-3
    f = specular * (d_ndf * g * fr / denom)[..., None]

    valid = same_hemi & (pdf > 0.0) & (wo_dot_wh > 0.0)
    f = jnp.where(valid[..., None], f, 0.0)
    return BrdfSample(wi=wi, f=f, pdf=pdf, valid=valid)


def sample_specular_ggx(wo: jax.Array, normal: jax.Array,
                        specular: jax.Array, ns: jax.Array,
                        u1: jax.Array, u2: jax.Array) -> BrdfSample:
    """True GGX lobe: the reference's actual distribution term
    (DistributionGGX, kernel_bvh.cl:221-225 — D = a^2 / (pi ((n.h)^2
    (a^2 - 1) + 1)^2) with a = roughness^2) paired with the matching
    GGX half-vector sampler the reference lacks. The MTL Ns exponent
    maps to perceptual roughness r = sqrt(2/(Ns+2)) (the inverse of the
    Blinn mapping in sample_specular), Smith G and Schlick F as there.
    """
    r = jnp.sqrt(2.0 / (jnp.maximum(ns, 0.0) + 2.0))
    a = r * r
    a2 = jnp.maximum(a * a, 1e-12)
    phi = _TWO_PI * u1
    u2c = jnp.clip(u2, 0.0, 1.0 - 1e-7)
    # GGX NDF inversion: cos^2(theta_h) = (1 - u) / (1 + (a^2 - 1) u).
    dd_u = 1.0 + (a2 - 1.0) * u2c
    cos_h2 = (1.0 - u2c) / dd_u
    cos_h = safe_sqrt(jnp.minimum(cos_h2, 1.0))
    # sin^2 = 1 - cos^2 in closed form (no cancellation near the pole).
    sin_h = safe_sqrt(a2 * u2c / dd_u)
    s, t = build_onb(normal)
    wh = spherical_dir(s, t, normal, phi, sin_h, cos_h)
    wi = reflect(wo, wh)

    cos_i = dot(wi, normal)
    cos_o = dot(wo, normal)
    same_hemi = (cos_i * cos_o) >= 1e-6

    dd = cos_h2 * (a2 - 1.0) + 1.0
    d_ndf = a2 * _INV_PI / jnp.maximum(dd * dd, 1e-12)
    pdf_h = d_ndf * cos_h
    wo_dot_wh = jnp.maximum(dot(wo, wh), 0.0)
    pdf = pdf_h / jnp.maximum(4.0 * wo_dot_wh, 1e-8)

    g = _smith_g(normal, wo, wi, r)
    fr = fresnel_schlick(jnp.float32(0.04), wo_dot_wh)
    denom = 4.0 * jnp.maximum(cos_i, 0.0) * jnp.maximum(cos_o, 0.0) + 1e-3
    f = specular * (d_ndf * g * fr / denom)[..., None]

    valid = same_hemi & (pdf > 0.0) & (wo_dot_wh > 0.0)
    f = jnp.where(valid[..., None], f, 0.0)
    return BrdfSample(wi=wi, f=f, pdf=pdf, valid=valid)


def sample_brdf(wo: jax.Array, normal: jax.Array, diffuse: jax.Array,
                specular: jax.Array, ns: jax.Array, seeds: jax.Array,
                bounce, specular_prob: float = 0.5,
                specular_model: str = "blinn") -> BrdfSample:
    """50/50 lobe russian roulette (SampleBrdf, kernel_bvh.cl:294-302),
    expressed branch-free with lane selects."""
    u_lobe = rng.uniform(seeds, rng.bounce_site(bounce, rng.SITE_LOBE))
    pick_spec = u_lobe > (1.0 - specular_prob)

    du1 = rng.uniform(seeds, rng.bounce_site(bounce, rng.SITE_DIFF_PHI))
    du2 = rng.uniform(seeds, rng.bounce_site(bounce, rng.SITE_DIFF_R2))
    su1 = rng.uniform(seeds, rng.bounce_site(bounce, rng.SITE_SPEC_PHI))
    su2 = rng.uniform(seeds, rng.bounce_site(bounce, rng.SITE_SPEC_COS))

    diff = sample_diffuse(normal, diffuse, du1, du2)
    if specular_model == "ggx":
        spec = sample_specular_ggx(wo, normal, specular, ns, su1, su2)
    else:
        spec = sample_specular(wo, normal, specular, ns, su1, su2)

    sel = pick_spec[..., None]
    return BrdfSample(
        wi=jnp.where(sel, spec.wi, diff.wi),
        f=jnp.where(sel, spec.f, diff.f),
        pdf=jnp.where(pick_spec, spec.pdf, diff.pdf),
        valid=jnp.where(pick_spec, spec.valid, diff.valid),
    )
