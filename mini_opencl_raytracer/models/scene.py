"""Scene data model: SoA pytrees for geometry, materials, camera, lights.

The reference stores an AoS ``CLTriangle`` (three embedded ``CLVertex`` +
material index, CLshared_structs.hpp:44-74) and a ``CLMaterial``
{diffuse, specular, emission, type, roughness, ior}
(CLshared_structs.hpp:13-26). Here the layout is structure-of-arrays
``jnp`` buffers, so intersection reads dense [T, 3] panels. Camera
defaults mirror CLcamera.h:8-13; light defaults mirror CLLight.h:6-13.

All containers are pytree dataclasses (``pytree.dataclass``): they flow
through ``jit`` / ``grad`` / ``shard_map`` and every leaf is
differentiable scene state.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .. import pytree


@pytree.dataclass
class Materials:
    """SoA material table (reference: CLMaterial, CLshared_structs.hpp:13-26).

    ``roughness`` stores the raw MTL ``Ns`` exponent exactly like the
    reference loader (CLOBJloader.cpp:167-170); the GGX/Blinn mapping
    ``alpha = 2/Ns^2 - 2`` happens in the BRDF (kernel_bvh.cl:275).
    ``ior`` is parsed from ``Ni`` (CLOBJloader.cpp:171-174) and, as in the
    reference ("isn't ior value", kernel_bvh.cl:288), is currently unused
    by shading.
    """

    diffuse: jax.Array   # [M, 3] Kd
    specular: jax.Array  # [M, 3] Ks
    emission: jax.Array  # [M, 3] Ke
    roughness: jax.Array  # [M] Ns
    ior: jax.Array        # [M] Ni

    @property
    def count(self) -> int:
        return self.diffuse.shape[0]

    @staticmethod
    def zeros(n: int, dtype=jnp.float32) -> "Materials":
        return Materials(
            diffuse=jnp.zeros((n, 3), dtype),
            specular=jnp.zeros((n, 3), dtype),
            emission=jnp.zeros((n, 3), dtype),
            roughness=jnp.ones((n,), dtype),
            ior=jnp.ones((n,), dtype),
        )


@pytree.dataclass
class Geometry:
    """SoA triangle soup (reference: CLTriangle AoS, CLshared_structs.hpp:44-74).

    Vertices are stored per-corner (not indexed) exactly as the reference
    flattens them after fan triangulation (CLOBJloader.cpp:101-126); this
    keeps leaf intersection fully dense.
    """

    v0: jax.Array  # [T, 3] corner positions
    v1: jax.Array  # [T, 3]
    v2: jax.Array  # [T, 3]
    n0: jax.Array  # [T, 3] per-corner shading normals
    n1: jax.Array  # [T, 3]
    n2: jax.Array  # [T, 3]
    uv0: jax.Array  # [T, 2]
    uv1: jax.Array  # [T, 2]
    uv2: jax.Array  # [T, 2]
    mat_idx: jax.Array  # [T] int32 material index per triangle

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    def centroids(self) -> jax.Array:
        return (self.v0 + self.v1 + self.v2) / 3.0

    def aabbs(self):
        """Per-triangle AABB (lo, hi), each [T, 3]."""
        lo = jnp.minimum(jnp.minimum(self.v0, self.v1), self.v2)
        hi = jnp.maximum(jnp.maximum(self.v0, self.v1), self.v2)
        return lo, hi

    def permute(self, order: jax.Array) -> "Geometry":
        """Reorder triangles (used to make BVH leaves contiguous, the
        analog of the reference's orderedTriangles swap, CLBVHnode.cpp:197)."""
        take = lambda a: jnp.take(a, order, axis=0)
        return Geometry(
            v0=take(self.v0), v1=take(self.v1), v2=take(self.v2),
            n0=take(self.n0), n1=take(self.n1), n2=take(self.n2),
            uv0=take(self.uv0), uv1=take(self.uv1), uv2=take(self.uv2),
            mat_idx=take(self.mat_idx),
        )


@pytree.dataclass
class Camera:
    """Pinhole camera (reference: CLCamera, CLcamera.h:6-23).

    Defaults: position (0,-25,8.5) looking along +Y with +Z up
    (CLcamera.h:8-13). The ray-generation basis is
    right = cross(front, up) (kernel_bvh.cl:400).
    """

    position: jax.Array  # [3]
    front: jax.Array     # [3]
    up: jax.Array        # [3]

    @staticmethod
    def default(dtype=jnp.float32) -> "Camera":
        return Camera(
            position=jnp.array([0.0, -25.0, 8.5], dtype),
            front=jnp.array([0.0, 1.0, 0.0], dtype),
            up=jnp.array([0.0, 0.0, 1.0], dtype),
        )

    @staticmethod
    def from_angles(position, pitch: float, yaw: float, dtype=jnp.float32) -> "Camera":
        """Spherical-angle camera like CLCamera::Update (CLcamera.h:15-21):
        front = (cos(yaw)sin(pitch), sin(yaw)sin(pitch), cos(pitch))."""
        front = jnp.array(
            [jnp.cos(yaw) * jnp.sin(pitch),
             jnp.sin(yaw) * jnp.sin(pitch),
             jnp.cos(pitch)], dtype)
        return Camera(
            position=jnp.asarray(position, dtype),
            front=front,
            up=jnp.array([0.0, 0.0, 1.0], dtype),
        )


# Light types (CLLight.h:10: 0 == directional, 1 == point, 2 == spot).
LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1
LIGHT_SPOT = 2


@pytree.dataclass
class Lights:
    """SoA analytic light set.

    The reference supports one light of type directional / point / spot
    (kernel_bvh.cl:304-347) with position (0,-10,16), direction
    (-0.5,0.4,-0.1) hardcoded in-kernel (kernel_bvh.cl:307-308) and a host
    struct that is never uploaded (CLLight.h). Here lights are first-class
    differentiable state and multiple lights are supported (benchmark
    config 2 is multi-light).
    """

    position: jax.Array    # [L, 3]
    direction: jax.Array   # [L, 3]
    light_type: jax.Array  # [L] int32
    intensity: jax.Array   # [L]
    attenuation: jax.Array  # [L] quadratic falloff coefficient
    # Spot cosine cutoff (reference spot branch is a stub,
    # kernel_bvh.cl:337-344; we implement it properly).
    cos_cutoff: jax.Array  # [L]

    @property
    def count(self) -> int:
        return self.position.shape[0]

    @staticmethod
    def default_point(dtype=jnp.float32) -> "Lights":
        """The reference's effective point light: pos (0,-10,16),
        intensity 16, quadratic falloff 0.8 (kernel_bvh.cl:322-336)."""
        return Lights(
            position=jnp.array([[0.0, -10.0, 16.0]], dtype),
            direction=jnp.array([[-0.5, 0.4, -0.1]], dtype),
            light_type=jnp.array([LIGHT_POINT], jnp.int32),
            intensity=jnp.array([16.0], dtype),
            attenuation=jnp.array([0.8], dtype),
            cos_cutoff=jnp.array([0.9], dtype),
        )

    @staticmethod
    def default_directional(dtype=jnp.float32) -> "Lights":
        """The reference's directional light: dir (-0.5,0.4,-0.1),
        intensity 1 (kernel_bvh.cl:307-321)."""
        return Lights(
            position=jnp.array([[0.0, -10.0, 16.0]], dtype),
            direction=jnp.array([[-0.5, 0.4, -0.1]], dtype),
            light_type=jnp.array([LIGHT_DIRECTIONAL], jnp.int32),
            intensity=jnp.array([1.0], dtype),
            attenuation=jnp.array([0.8], dtype),
            cos_cutoff=jnp.array([0.9], dtype),
        )


@pytree.dataclass
class Scene:
    """Complete differentiable scene: geometry + materials + lights.

    The analog of the reference's CLBVHScene buffers
    (m_Triangles/m_Materials, CLBVHnode.cpp:209-236) plus the host-side
    CLLight that the reference never uploads. Camera is passed separately
    to ``render`` (it changes per frame; scene rarely does).
    """

    geometry: Geometry
    materials: Materials
    lights: Lights

    @property
    def num_triangles(self) -> int:
        return self.geometry.num_triangles
