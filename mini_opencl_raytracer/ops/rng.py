"""Counter-based, stateless RNG for the path tracer.

The reference uses a *stateful* per-work-item xorshift-multiply mixer
seeded with ``global_id + HashUInt32(frameCount)`` (kernel_bvh.cl:57-71,
445; the LCG ``HashUInt32`` is kernel_bvh.cl:57-59). Stateful RNG is the
wrong shape for a vector machine and for ``grad``/``vmap``, so this
design replaces it with a **counter-based** hash: every random draw is a
pure function ``uniform(pixel_seed, counter)``. This keeps the draw
sequence identical across backends (brute-force sweep, BVH),
which is what makes cross-backend allclose tests exact.

The mixer itself is the same well-known hash family the reference uses
(https://github.com/skeeto/hash-prospector, the `lowbias32` constants that
also appear at kernel_bvh.cl:60-67), applied in counter mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_GOLDEN = jnp.uint32(0x9E3779B9)


def mix_u32(x: jax.Array) -> jax.Array:
    """Finalizing 32-bit mixer (lowbias32)."""
    x = x.astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_combine(a: jax.Array, b) -> jax.Array:
    """Order-sensitive combine of two u32 streams."""
    b = jnp.asarray(b)
    return mix_u32(a.astype(jnp.uint32) ^ (mix_u32(b.astype(jnp.uint32)) + _GOLDEN))


def pixel_seeds(pixel_ids: jax.Array, frame) -> jax.Array:
    """Per-pixel base seed for one frame/sample index.

    Analog of ``seed = get_global_id(0) + HashUInt32(frameCount)``
    (kernel_bvh.cl:445) but collision-resistant: the frame is fully mixed
    before combining with the pixel id.
    """
    return hash_combine(jnp.asarray(pixel_ids), jnp.uint32(frame))


def uniform(seed: jax.Array, counter) -> jax.Array:
    """Uniform float32 in [0, 1) for draw site ``counter``.

    ``seed`` is any uint32 array (e.g. per-pixel seeds), ``counter`` a
    scalar (static or traced) identifying the draw site. Replaces the
    stateful ``GetRandomFloat`` (kernel_bvh.cl:68-71).
    """
    bits = hash_combine(seed, counter)
    # Take the top 24 bits -> uniform in [0, 1) with exact float32 spacing.
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


# Fixed draw-site layout per bounce so every backend consumes the same
# sequence. (The reference draws lazily from mutable state; we give every
# site a static address instead.)
DRAWS_PER_BOUNCE = 8
SITE_LOBE = 0          # specular-vs-diffuse lobe pick (kernel_bvh.cl:298)
SITE_DIFF_PHI = 1      # SampleHemisphereCosine phi (kernel_bvh.cl:81)
SITE_DIFF_R2 = 2       # SampleHemisphereCosine sin^2(theta) (kernel_bvh.cl:82)
SITE_SPEC_PHI = 3      # SampleGGX phi (kernel_bvh.cl:229)
SITE_SPEC_COS = 4      # SampleGGX cosTheta draw (kernel_bvh.cl:231)
SITE_LIGHT_A = 5       # area-light / shadow-ray sampling (extension)
SITE_LIGHT_B = 6
SITE_RESERVED = 7

# Raygen draws live before the bounce sites.
SITE_JITTER_X = 0  # kernel_bvh.cl:394
SITE_JITTER_Y = 1  # kernel_bvh.cl:395
RAYGEN_DRAWS = 2


def bounce_site(bounce, site) -> jax.Array:
    """Global counter for draw ``site`` at ``bounce``."""
    return RAYGEN_DRAWS + bounce * DRAWS_PER_BOUNCE + site
