"""Run the five BASELINE.json benchmark configs, one JSON line each.

Usage:
    python benchmarks/run_all.py            # all configs on the default device
    python benchmarks/run_all.py --quick    # smaller iteration counts
    python benchmarks/run_all.py --configs 1 2 4

Method:
  * acceleration structures are built ONCE, OUTSIDE the timed/jitted
    frame (mrt.build_accel), like the reference's load-time BVH build
    (CLBVHnode.cpp:185-207), and reported in their own field;
  * each timed sample runs distinct frames inside one jitted lax.scan,
    at two scan lengths; the per-frame figure is the slope between them
    (utils.metrics.time_scan_slope);
  * every line names the device (platform, kind, count) and, where
    nvidia-smi exists, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import mini_opencl_raytracer as mrt
from mini_opencl_raytracer import grad as gradlib
from mini_opencl_raytracer.models.procedural import (bunny_scene,
                                                         sponza_scene)
from mini_opencl_raytracer.utils.metrics import (
    device_record, gpu_name_and_power_limit, render_metrics,
    time_scan_slope)

INNER = (8, 40)  # (lo, hi) scan lengths for slope timing


def _build_accel_timed(scene, cfg):
    """Accel build (outside jit), measured: (accel, seconds). The first
    build pays one-off compilation; the best of three later builds is
    reported."""
    accel = jax.block_until_ready(mrt.build_accel(scene, cfg))
    if accel is None:
        return None, 0.0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        accel = jax.block_until_ready(mrt.build_accel(scene, cfg))
        times.append(time.perf_counter() - t0)
    return accel, min(times)


def _measure_forward(scene, cfg, camera, iters, accel=None, inner=None):
    # scene/accel are passed as jit arguments (time_scan_slope's
    # ``data``), not embedded in the program as closure constants.
    def frame(fr, data):
        s, acc = data
        return jnp.mean(mrt.render_sample(s, camera, cfg, frame=fr,
                                          accel=acc))
    lo, hi = inner or INNER
    sec = time_scan_slope(frame, inner_lo=lo, inner_hi=hi, iters=iters,
                          data=(scene, accel))
    return render_metrics(sec, cfg.width, cfg.height, cfg.bounces, cfg.spp)


def _measure_fwd_bwd(scene, cfg, camera, iters, accel=None, inner=None):
    def frame(fr, data):
        s, acc = data
        g = gradlib.grad_float_leaves(
            lambda s_: jnp.mean(mrt.render_sample(s_, camera, cfg,
                                                  frame=fr, accel=acc)),
            s)
        # Sum every gradient leaf so no backward work is DCE'd.
        return sum(jnp.sum(l).astype(jnp.float32)
                   for l in jax.tree_util.tree_leaves(g))
    lo, hi = inner or INNER
    sec = time_scan_slope(frame, inner_lo=lo, inner_hi=hi, iters=iters,
                          data=(scene, accel))
    return render_metrics(sec, cfg.width, cfg.height, cfg.bounces, cfg.spp)


def config_1(iters, backend, quick=False):
    """Cornell 512x512, primary rays + point light (CPU-runnable)."""
    scene = mrt.cornell_scene()
    cfg = mrt.RenderConfig(width=512, height=512, bounces=1, backend=backend)
    accel, build_s = _build_accel_timed(scene, cfg)
    m = _measure_forward(scene, cfg, mrt.Camera.default(), iters,
                         accel=accel)
    m["config"] = "1: cornell 512x512 primary+point"
    m["accel_build_seconds"] = build_s
    return m


def config_2(iters, backend, quick=False):
    """Cornell 1080p, shadow rays + Phong direct specular, multi-light."""
    lights = mrt.Lights(
        position=jnp.array([[0.0, -10.0, 16.0], [4.0, 2.0, 14.0]]),
        direction=jnp.array([[-0.5, 0.4, -0.1], [0.0, 0.5, -1.0]]),
        light_type=jnp.array([mrt.LIGHT_POINT, mrt.LIGHT_POINT], jnp.int32),
        intensity=jnp.array([16.0, 8.0]),
        attenuation=jnp.array([0.8, 0.8]),
        cos_cutoff=jnp.array([0.9, 0.9]))
    scene = mrt.cornell_scene(lights=lights)
    cfg = mrt.RenderConfig(width=1920, height=1080, bounces=2,
                           backend=backend, shadow_rays=True,
                           direct_specular=True)
    accel, build_s = _build_accel_timed(scene, cfg)
    m = _measure_forward(scene, cfg, mrt.Camera.default(), iters,
                         accel=accel)
    m["config"] = "2: cornell 1080p shadows+phong multi-light"
    m["accel_build_seconds"] = build_s
    return m


def config_3(iters, backend, quick=False):
    """Bunny-scale (~70k tris): prebuilt LBVH + deep traversal."""
    scene = bunny_scene()
    cfg = mrt.RenderConfig(width=512, height=512, bounces=2, backend=backend)
    accel, build_s = _build_accel_timed(scene, cfg)
    m = _measure_forward(scene, cfg, mrt.Camera.default(), iters,
                         accel=accel, inner=(1, 2) if quick else (4, 16))
    m["config"] = f"3: bunny-scale ({scene.num_triangles} tris) 512x512"
    m["accel_build_seconds"] = build_s
    return m


def config_4(iters, backend, quick=False):
    """4-bounce differentiable Cornell: fwd+bwd step."""
    scene = mrt.cornell_scene()
    cfg = mrt.RenderConfig(width=512, height=512, bounces=4, backend=backend)
    accel, build_s = _build_accel_timed(scene, cfg)
    m = _measure_fwd_bwd(scene, cfg, mrt.Camera.default(), iters,
                         accel=accel)
    m["config"] = "4: cornell 512x512 4-bounce fwd+bwd"
    m["accel_build_seconds"] = build_s
    return m


def config_5(iters, backend, quick=False):
    """Sponza-scale (~260k tris) at 4K on one device (the sharded path
    is parallel/shard.py)."""
    scene = sponza_scene()
    cfg = mrt.RenderConfig(width=3840, height=2160, bounces=1,
                           backend=backend)
    accel, build_s = _build_accel_timed(scene, cfg)
    m = _measure_forward(scene, cfg, mrt.Camera.default(), iters,
                         accel=accel, inner=(1, 2) if quick else (2, 8))
    m["config"] = f"5: sponza-scale ({scene.num_triangles} tris) 4K"
    m["accel_build_seconds"] = build_s
    return m


CONFIGS = {1: config_1, 2: config_2, 3: config_3, 4: config_4, 5: config_5}


def main() -> int:
    from mini_opencl_raytracer.render import BACKENDS
    from mini_opencl_raytracer.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, nargs="*",
                    default=[1, 2, 3, 4, 5])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--quick", action="store_true",
                    help="2 timed pairs; scan lengths 1 and 2 for the "
                         "large scenes")
    ap.add_argument("--backend", default="auto", choices=BACKENDS)
    args = ap.parse_args()
    iters = 2 if args.quick else args.iters

    device, gpu = device_record(), gpu_name_and_power_limit()
    failed = False
    for c in args.configs:
        try:
            m = CONFIGS[c](iters, args.backend, args.quick)
        except Exception as e:  # noqa: BLE001 - record, go on, exit 1
            m = {"config": f"{c}: FAILED", "error": str(e)[:300]}
            failed = True
        m.update(device=device, gpu=gpu)
        print(json.dumps(m), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
