"""Timing / throughput metrics.

Replaces the reference's clock()-based FPS counter (CLEngineBase.cpp:
193-196, shown at CLui.cpp:196-197) with a block_until_ready timing
harness and structured per-frame metrics (SURVEY.md section 5).
"""

from __future__ import annotations

import subprocess
import time
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp


def time_fn(f: Callable[..., Any], iters: int = 5, warmup: int = 1) -> float:
    """Median wall-clock seconds per call, each call ended by
    ``jax.block_until_ready`` on its output.

    ``f`` is called with the iteration index when it takes an argument,
    so callers can feed it into the computation (e.g. as the frame
    seed) and every timed call does distinct work. Zero-arg callables
    are accepted too.
    """
    import inspect

    takes_arg = True
    try:
        inspect.signature(f).bind(0)
    except TypeError:
        takes_arg = False
    call = (lambda i: f(i)) if takes_arg else (lambda i: f())

    for w in range(warmup):
        jax.block_until_ready(call(1_000_000 + w))
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(call(i))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def scan_frames(f: Callable[[Any], Any], inner: int) -> Callable[[Any], Any]:
    """Fold ``inner`` distinct frames of a jittable scalar-returning
    ``f(frame_u32)`` into ONE jitted executable (a ``lax.scan`` over
    frame indices summing the scalars), so one dispatch runs ``inner``
    frames — the analog of the reference timing its frame loop, not its
    dispatch (CLEngineBase.cpp:193-196).

    ``f`` must return a scalar that DEPENDS on all work to be timed
    (e.g. the mean image, or the sum of every gradient leaf) so nothing
    is dead-code-eliminated; frames inside the scan use consecutive
    distinct frame numbers starting at the call's base argument.

    ``data``: optional pytree of device arrays ``f`` needs (scene,
    accel, ...), passed as a real jit argument rather than captured as
    closure constants, which would be embedded in the compiled program.
    With ``data``, ``f`` is called as ``f(frame, data)``.
    """
    def batched(base, data=None):
        def body(c, k):
            fr = jnp.uint32(base) + k
            return c + (f(fr) if data is None else f(fr, data)), None
        tot, _ = jax.lax.scan(
            body, jnp.zeros((), jnp.float32),
            jnp.arange(inner, dtype=jnp.uint32))
        return tot

    return jax.jit(batched)


def time_scan_fn(f: Callable[..., Any], inner: int = 8, iters: int = 5,
                 warmup: int = 1, data: Any = None) -> float:
    """Median seconds per FRAME of ``f`` (see ``scan_frames``): each
    timed sample is one call executing ``inner`` distinct frames,
    divided by ``inner``. ``data`` is forwarded per scan_frames. The
    result includes one dispatch per ``inner`` frames."""
    batched = scan_frames(f, inner)
    sec = time_fn(
        lambda i: batched(jnp.asarray((7919 * (i + 1)) & 0xFFFFFFFF,
                                      jnp.uint32), data),
        iters=iters, warmup=warmup)
    return sec / inner


def time_scan_slope(f: Callable[..., Any], inner_lo: int = 8,
                    inner_hi: int = 40, iters: int = 5,
                    data: Any = None) -> float:
    """Marginal seconds per frame of ``f``: the SLOPE between two scan
    lengths, median over ``iters`` interleaved (lo, hi) pairs.

    Timing the same scanned program at two lengths and taking
    (T_hi - T_lo) / (inner_hi - inner_lo) cancels the per-call constant
    (dispatch and synchronisation) and keeps everything a frame costs.
    """
    b_lo = scan_frames(f, inner_lo)
    b_hi = scan_frames(f, inner_hi)

    def run(b, base):
        t0 = time.perf_counter()
        jax.block_until_ready(
            b(jnp.asarray(base & 0xFFFFFFFF, jnp.uint32), data))
        return time.perf_counter() - t0

    # Warm both programs (compile + first-run effects).
    run(b_lo, 7)
    run(b_hi, 11)
    slopes = []
    for i in range(iters):
        t_lo = run(b_lo, 7919 * (2 * i + 1))
        t_hi = run(b_hi, 7919 * (2 * i + 2))
        slopes.append((t_hi - t_lo) / (inner_hi - inner_lo))
    slopes.sort()
    return slopes[len(slopes) // 2]


def bounce_occupancy(scene, camera, cfg, frame: int = 0):
    """Per-bounce live-ray fractions [bounces] — wavefront occupancy
    observability (how much of each bounce's lockstep work is wasted on
    dead lanes). Runs the jnp integrator with stats on the configured
    wavefront backend."""
    import jax.numpy as jnp

    from ..ops import rng
    from ..ops.camera import generate_rays
    from ..ops.integrator import trace_paths
    from ..render import make_intersectors

    closest, any_hit = make_intersectors(scene, cfg)
    pix = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
    seeds = rng.pixel_seeds(pix, jnp.uint32(frame))
    o, d = generate_rays(camera, cfg, pix, seeds)
    _, stats = trace_paths(scene, cfg, o, d, seeds, closest, any_hit,
                           with_stats=True)
    return stats


def render_metrics(seconds_per_frame: float, width: int, height: int,
                   bounces: int, spp: int = 1) -> Dict[str, float]:
    """Structured throughput record for one render configuration.

    'rays' counts one ray per pixel per bounce per sample — the direct
    extension of the reference's work-item-per-pixel workload
    (CLRaytracer.cpp:53) to multi-bounce batches.
    """
    rays = width * height * bounces * spp
    return {
        "seconds_per_frame": seconds_per_frame,
        "fps": 1.0 / seconds_per_frame,
        "rays_per_frame": float(rays),
        "rays_per_second": rays / seconds_per_frame,
        "mrays_per_second": rays / seconds_per_frame / 1e6,
    }


def device_record() -> Dict[str, Any]:
    """The device as JAX reports it: platform, kind and count."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of each card (one line per
    card), or None where nvidia-smi is absent or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()
