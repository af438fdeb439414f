"""Configuration system for the raytracer.

The reference hardcodes every tunable: scene file (CLEngineBase.cpp:177),
maxPrimitivesInNode=4 (CLEngineBase.cpp:175), vertical FOV 45 deg
(kernel_bvh.cl:392), light parameters (kernel_bvh.cl:307-308), camera
defaults (CLcamera.h:8-13), window size = monitor resolution
(CLEngineBase.cpp:36-39), bounces=9 / skybox=1.0 (CLRaytracer.h:32-34).
Here every one of those becomes an explicit frozen-dataclass field so the
whole pipeline is reproducible and jit-friendly (configs are static
hashable pytree-free objects passed as Python constants into traced fns).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (everything the reference exposed via ImGui
    widgets, CLui.cpp:204-266, plus hardcoded kernel constants)."""

    width: int = 512
    height: int = 512
    # Path-trace depth; reference default 9 (CLRaytracer.h:32), UI range 1..20
    # (CLui.cpp:250).
    bounces: int = 9
    # Samples accumulated per call to ``render`` (progressive accumulation
    # over calls is handled by RenderState).
    spp: int = 1
    # Vertical field of view in degrees (hardcoded 45 at kernel_bvh.cl:392).
    fov_deg: float = 45.0
    # Constant-grey sky multiplier (kernel_bvh.cl:92-96, CLRaytracer.h:34).
    skybox_intensity: float = 1.0
    # Grey sky colour (kernel_bvh.cl:94).
    sky_color: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    # Emission boost applied in the integrator (kernel_bvh.cl:365: `* 50`).
    emission_scale: float = 50.0
    # Self-intersection offset along the scattered direction
    # (kernel_bvh.cl:380: `isect.pos + wi * 0.01`).
    ray_epsilon: float = 1e-2
    # Max ray distance (kernel_bvh.cl:7 MAX_RENDER_DIST).
    t_max: float = 1.0e5
    # Cull back-facing triangles in intersection. The reference's test
    # (kernel_bvh.cl:116) is broken-as-written; we expose the intent as a
    # clean flag, default off like its CULL_BACKFACE constant.
    backface_cull: bool = False
    # Cast occlusion (shadow) rays for the direct-light term. The reference
    # never does (SURVEY.md: "no shadow rays"); benchmark config 2 needs it.
    shadow_rays: bool = False
    # Add a Blinn-Phong specular direct-light term (benchmark config 2).
    direct_specular: bool = False
    # Probability of choosing the specular lobe per bounce
    # (kernel_bvh.cl:294-302: 50/50 russian roulette between lobes).
    specular_prob: float = 0.5
    # Specular microfacet distribution: "blinn" (the spec-cleaned default
    # — the reference's sampler is a self-described hack, ops/brdf.py) or
    # "ggx" — the reference's actual GGX D-term (DistributionGGX,
    # kernel_bvh.cl:221-225) with matched GGX half-vector sampling; the
    # MTL Ns exponent maps to perceptual roughness r = sqrt(2/(Ns+2)).
    specular_model: str = "blinn"
    # Soft-visibility relaxation bandwidth (barycentric units) for
    # silhouette gradients. 0 (default) = hard visibility, exactly the
    # reference's semantics; > 0 blends each hit's contribution with the
    # sky by a sigmoid of the winner triangle's barycentric edge margin
    # (SoftRas-style), making the rendered image — and therefore its
    # vertex gradients — smooth across silhouettes. Sky-backed
    # silhouettes get quantitatively correct edge gradients;
    # surface-over-surface edges are approximated by the sky blend.
    soft_edge_sigma: float = 0.0
    # Gamma for output encoding (kernel_bvh.cl:405-413: 1/2.2 and 2.2).
    gamma: float = 2.2
    # Rays per step of the dense (bruteforce) sweep; bounds its
    # [rays x tris] intermediates. None sizes it from the triangle count
    # and a byte budget (ops/intersect.sweep_chunk).
    ray_chunk: Optional[int] = None
    # Intersection backend: "auto" | "bruteforce" | "bvh". "auto" (the
    # default) chooses from the triangle count: the dense sweep for
    # small scenes, the LBVH above (render.resolve_backend). The two
    # explicit names exist for tests and cross-checks.
    backend: str = "auto"
    # Rematerialize each bounce in the backward pass (jax.checkpoint on
    # the scan body): trades recompute for activation memory so full-res
    # gradient renders fit in device memory.
    remat: bool = True
    # Sort the ray wavefront by direction octant + origin Morton code
    # before each intersection (per-ray results are identical — only the
    # wavefront order changes), so neighbouring rays traverse similar
    # parts of the BVH (SURVEY.md section 7 step 4 'ray
    # sorting/compaction'). None = auto: on for scenes above
    # integrator.SORT_RAYS_MIN_TRIS, off otherwise.
    sort_rays: Optional[bool] = None
    # float dtype for the compute path.
    dtype: str = "float32"

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def num_pixels(self) -> int:
        return self.height * self.width

    def jnp_dtype(self):
        return jnp.dtype(self.dtype)


@dataclasses.dataclass(frozen=True)
class BVHConfig:
    """LBVH build settings.

    The reference uses a CPU-recursive SAH builder with
    maxPrimitivesInNode=4 (CLBVHnode.cpp:7-159, CLEngineBase.cpp:175). This
    build is a Karras-style LBVH (Morton sort + parallel hierarchy emit)
    so construction itself runs on device as sorts/scans.
    """

    # Number of triangles packed per leaf; traversal intersects a whole
    # leaf as one dense block. Carried over from the earlier design; not
    # yet measured on the GPU.
    leaf_size: int = 8
    # Morton code quantization bits per axis.
    morton_bits: int = 21
    # Upper bound on traversal stack / iteration; the reference uses a
    # 64-deep per-thread stack (kernel_bvh.cl:180-181).
    max_depth: int = 64


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh / sharding settings (all new — the reference is single
    device, SURVEY.md section 2 'Parallelism inventory')."""

    # Data-parallel axis size (pixel tiles). 0/None = use all devices.
    dp: Optional[int] = None
    # Geometry-parallel axis size (triangle shards; ring traversal).
    tp: int = 1
    # Axis names.
    dp_axis: str = "dp"
    tp_axis: str = "tp"


DEFAULT_RENDER = RenderConfig()
DEFAULT_BVH = BVHConfig()
DEFAULT_MESH = MeshConfig()
