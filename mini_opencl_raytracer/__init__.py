"""mini_opencl_raytracer — a differentiable path tracer in JAX.

A from-scratch JAX/XLA re-design of the capability set of
jstrom2002/Mini-OpenCL-Raytracer (C++17 + OpenCL progressive path
tracer): headless, batched, end-to-end differentiable, and sharded over
GPU device meshes. See SURVEY.md at the repo root for the layer-by-layer
mapping to the reference.

Public API::

    import mini_opencl_raytracer as mrt

    scene  = mrt.cornell_scene()                  # or mrt.load_scene(path)
    camera = mrt.Camera.default()
    cfg    = mrt.RenderConfig(width=512, height=512, bounces=9)
    image  = mrt.render(scene, camera, cfg, frames=16)   # [H, W, 3] in [0,1]
"""

from .config import BVHConfig, MeshConfig, RenderConfig
from .models.scene import (Camera, Geometry, Lights, Materials, Scene,
                           LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPOT)
from .models.objloader import load_obj, load_mtl, load_scene
from .models.cornell import (cornell_scene, cornell_geometry,
                             cornell_materials, write_cornell_obj,
                             CORNELL_MATERIAL_NAMES)
from .ops.bvh import BVH, build_bvh, intersect_bvh, occluded_bvh
from .ops.intersect import Hit, intersect_brute, occluded_brute, ray_triangle
from .render import (RenderState, accumulate, build_accel,
                     make_intersectors, render, render_radiance,
                     render_sample, to_image)

__version__ = "0.1.0"

__all__ = [
    "BVH", "BVHConfig", "Camera", "Geometry", "Hit", "Lights",
    "LIGHT_DIRECTIONAL", "LIGHT_POINT", "LIGHT_SPOT", "Materials",
    "MeshConfig", "RenderConfig", "RenderState", "Scene", "accumulate", "build_accel",
    "build_bvh", "cornell_geometry", "cornell_materials", "cornell_scene",
    "CORNELL_MATERIAL_NAMES", "intersect_brute", "intersect_bvh",
    "load_mtl", "load_obj", "load_scene", "make_intersectors",
    "occluded_brute", "occluded_bvh", "ray_triangle", "render",
    "render_radiance", "render_sample", "to_image", "write_cornell_obj",
]
