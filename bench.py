"""Benchmark harness: one JSON line.

Metric: rays/s forward+backward at 1080p Cornell box, 9 bounces. 'rays' =
width * height * bounces per step (one ray per pixel per bounce, the
reference's work-item-per-pixel workload, CLRaytracer.cpp:53, extended
over the bounce loop). The measured step is jit(value_and_grad) of the
mean rendered radiance w.r.t. the float scene leaves on the
auto-resolved backend — a full differentiable render step, not just
forward.

Timing: the same jitted step scan runs at two lengths (4 and 12 steps),
interleaved, and the metric is the median slope (T_hi - T_lo) / 8 — the
marginal cost of one step (utils.metrics.time_scan_slope). Each scanned
step uses a distinct seed and the timed scalar sums every gradient
leaf, so nothing is cached or dead-code-eliminated.

    python bench.py
"""

import json
import sys

import jax
import jax.numpy as jnp


def main() -> int:
    from mini_opencl_raytracer.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    import mini_opencl_raytracer as mrt
    from mini_opencl_raytracer import grad as gradlib
    from mini_opencl_raytracer.render import resolve_backend
    from mini_opencl_raytracer.utils.metrics import (
        device_record, gpu_name_and_power_limit, time_scan_slope)

    W, H, B = 1920, 1080, 9
    scene = mrt.cornell_scene()
    camera = mrt.Camera.default()
    cfg = mrt.RenderConfig(width=W, height=H, bounces=B, backend="auto")
    backend = resolve_backend(scene, cfg)
    accel = mrt.build_accel(scene, cfg)

    def loss(s, fr):
        return jnp.mean(mrt.render_sample(s, camera, cfg, frame=fr,
                                          accel=accel))

    def step_scalar(fr, s):
        g = gradlib.grad_float_leaves(lambda s_: loss(s_, fr), s)
        # Sum EVERY gradient leaf: the timed scalar must depend on all
        # backward work or XLA dead-code-eliminates it.
        return sum(jnp.sum(l).astype(jnp.float32)
                   for l in jax.tree_util.tree_leaves(g))

    dt = time_scan_slope(step_scalar, inner_lo=4, inner_hi=12, iters=7,
                         data=scene)

    rays = W * H * B
    print(json.dumps({
        "metric": "rays/s fwd+bwd, 1080p Cornell, 9 bounces (%s)" % backend,
        "value": rays / dt,
        "unit": "rays/s",
        "seconds_per_step": dt,
        "device": device_record(),
        "gpu": gpu_name_and_power_limit(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
