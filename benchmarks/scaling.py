"""DP strong scaling of one progressive sample (shard.render_sample_dp).

    python benchmarks/scaling.py          # the visible GPUs
    python benchmarks/scaling.py --cpu    # 8 virtual CPU devices

Fixed image, pixels sharded over 1/2/4/8 devices (as many as exist).
Prints one JSON line per device count, naming the device. Each sharded
image is checked against the one-device image: at most 1% of its pixels
may differ by more than 1e-3 (a knife-edge hit can take another winner
under another fusion of the same arithmetic).

With ``--cpu`` the virtual devices are slices of ONE host CPU, which XLA
already multithreads at dp=1: the numbers validate the sharded program
(it compiles, runs and matches the single-device image), not scaling.
"""

from __future__ import annotations

import json
import os
import sys

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8")

import numpy as np
import jax
from jax.sharding import Mesh

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import mini_opencl_raytracer as mrt
from mini_opencl_raytracer.config import MeshConfig
from mini_opencl_raytracer.parallel.shard import render_sample_dp
from mini_opencl_raytracer.utils.metrics import (device_record,
                                                 gpu_name_and_power_limit,
                                                 time_fn)


def main() -> int:
    from mini_opencl_raytracer.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    scene = mrt.cornell_scene()
    cam = mrt.Camera.default()
    n_dev = len(jax.devices())
    cfg = mrt.RenderConfig(width=1920, height=1080, bounces=9)
    if jax.default_backend() == "cpu":
        cfg = mrt.RenderConfig(width=256, height=256, bounces=2)
    rays = cfg.num_pixels * cfg.bounces
    device, gpu = device_record(), gpu_name_and_power_limit()

    ref_img = None
    for dp in [1, 2, 4, 8]:
        if dp > n_dev:
            break
        mesh_cfg = MeshConfig(dp=dp, tp=1)
        mesh = Mesh(np.asarray(jax.devices()[:dp]).reshape(dp, 1),
                    (mesh_cfg.dp_axis, mesh_cfg.tp_axis))
        f = jax.jit(lambda s: render_sample_dp(s, cam, cfg, mesh,
                                               mesh_cfg=mesh_cfg))
        img = np.asarray(f(scene))
        if ref_img is None:
            ref_img = img
        bad = float((np.abs(img - ref_img) > 1e-3).any(-1).mean())
        if bad > 0.01:
            raise SystemExit(f"dp={dp}: {bad:.4f} of pixels differ")
        sec = time_fn(lambda: f(scene), iters=5)
        print(json.dumps({
            "dp": dp, "shape": [cfg.height, cfg.width, cfg.bounces],
            "ms_per_sample": sec * 1e3, "rays_per_s": rays / sec,
            "bad_pixel_frac_vs_dp1": bad,
            "device": device, "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
