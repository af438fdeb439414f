"""Smoke test of the path tracer on NVIDIA GPUs.

Drives the main path through the public API (``mrt.render``,
``mrt.render_sample``, ``mrt.build_accel``, ``grad``) at full size,
compares it with the dense brute-force reference, and prints one JSON
line per phase: compile seconds, steady milliseconds per frame or step,
device memory and the comparison figures with their tolerances.

    python chip_smoke.py             # one GPU: every single-card phase
    python chip_smoke.py --cards 4   # four GPUs: dp render and dp gradient
                                     # step, each against one GPU

The last line of standard output is ``{"ok": true, "device": {...}}``
only when every phase passed. Without a GPU, or when any phase fails,
the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np

# Image comparisons between two intersectors. Both evaluate the same
# f32 Moller-Trumbore formula in differently fused kernels, so a pixel's
# radiance agrees to rounding amplified along its path (ATOL, RTOL).
# Where rounding flips the winner of a knife-edge hit (a shared edge or
# a silhouette), that pixel's whole path changes; at most MAX_BAD of
# the pixels may differ for that reason.
IMG_ATOL = 1e-3
IMG_RTOL = 1e-3
IMG_MAX_BAD = 0.01
# Gradient comparisons: each float leaf of the scene gradient, as the
# L2 norm of the difference over the L2 norm of the reference leaf. A
# flipped path moves a mean-radiance gradient by about one pixel's share.
GRAD_RTOL = 2e-2
# A leaf's own norm can sit far below the rounding of the sums that
# make it (positive and negative pixel contributions cancel), and a leaf
# the render does not depend on is exactly zero: its ratio could read
# anything. The denominator is therefore at least GRAD_FLOOR times the
# norm of the whole reference gradient, about ten f32 roundings of it.
# At 512x512x4 on Cornell that floor is 1.2e-5: only the roughness leaf
# (norm 8.9e-6) and the leaves the render does not depend on fall under
# it; every other leaf is held to GRAD_RTOL of its own norm.
GRAD_FLOOR = 1e-6
# Finite-difference check of one material gradient. The radiance is a
# polynomial in the diffuse albedo (path choices do not depend on it),
# so a central difference with FD_EPS is accurate to f32 rounding of the
# image mean.
FD_EPS = 5e-2
FD_RTOL = 2e-2
# Gradient buckets (microbatches, each with its own all-reduce) of the
# 4-GPU training step.
DP_GRAD_BUCKETS = 4


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Image sizes (width, height, bounces) of each phase."""

    forward: tuple = (1920, 1080, 9)
    forward_frames: int = 4
    grad: tuple = (1920, 1080, 9)
    bunny: tuple = (512, 512, 2)
    sponza: tuple = (3840, 2160, 1)
    compare_cornell: tuple = (1920, 1080, 9)
    compare_large: tuple = (128, 128)
    compare_grad: tuple = (512, 512, 4)
    bunny_tris: int = 70_000
    sponza_tris: int = 260_000
    iters: int = 3


def frac_mismatch(a, b, atol: float, rtol: float):
    """(share of pixels where any channel misses |a-b| <= atol +
    rtol*|b|, largest absolute difference). NaNs count as mismatches."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    diff = np.abs(a - b)
    bad = ~(diff <= atol + rtol * np.abs(b))
    if bad.ndim == 3:
        bad = bad.any(axis=-1)
    return float(bad.mean()), float(np.nanmax(diff)) if diff.size else 0.0


def rel_l2(a, b, floor: float = 0.0) -> float:
    """||a - b|| / max(||b||, floor) (0 when both are zero)."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    nb = max(float(np.linalg.norm(b)), floor)
    nd = float(np.linalg.norm(a - b))
    if nb == 0.0:
        return 0.0 if nd == 0.0 else float("inf")
    return nd / nb


class PhaseFailed(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def _peak_bytes():
    import jax
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in jax.local_devices()]
    peaks = [p for p in peaks if p is not None]
    return max(peaks) if peaks else None


def timed(fn, args, iters: int, per_call: int = 1):
    """jit ``fn``, compile it for ``args``, run it once, then time
    ``iters`` calls. Returns (output, record)."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    rec = {"compile_s": compile_s,
           "steady_ms": float(np.median(times)) * 1e3 / per_call,
           "temp_bytes": getattr(mem, "temp_size_in_bytes", None)}
    return out, rec


def _float_leaves(tree):
    import jax
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)
            if np.issubdtype(np.asarray(x).dtype, np.floating)]


def _check_grads(test, ref) -> dict:
    """Compare every float leaf of two gradient trees with rel_l2 and
    the GRAD_FLOOR rule; fail on the worst. Returns, keyed by the leaf's
    path, [rel_l2, norm of the reference leaf], and the figures used."""
    import jax
    pairs = [(jax.tree_util.keystr(path), np.asarray(a, np.float64),
              np.asarray(b, np.float64))
             for (path, a), b in zip(
                 jax.tree_util.tree_flatten_with_path(test)[0],
                 jax.tree_util.tree_leaves(ref))
             if np.issubdtype(np.asarray(a).dtype, np.floating)]
    whole = float(np.sqrt(sum(np.sum(b * b) for _, _, b in pairs)))
    floor = GRAD_FLOOR * whole
    errs = {k: [rel_l2(a, b, floor), float(np.linalg.norm(b))]
            for k, a, b in pairs}
    worst = max(errs, key=lambda k: errs[k][0])
    check(all(np.isfinite(a).all() for _, a, _ in pairs),
          "non-finite gradient leaf")
    check(errs[worst][0] <= GRAD_RTOL,
          f"gradient leaf {worst} rel L2 {errs[worst][0]:.4g} > {GRAD_RTOL} "
          f"(reference leaf norm {errs[worst][1]:.4g}, floor {floor:.4g})")
    return {"grad_leaf_rel_l2_and_ref_norm": errs,
            "grad_leaf_rel_l2_max": errs[worst][0], "grad_worst_leaf": worst,
            "grad_ref_norm": whole, "grad_floor": floor,
            "grad_rtol": GRAD_RTOL}


# ---------------------------------------------------------------- phases


def phase_forward(mrt, sz: Sizes):
    W, H, B = sz.forward
    F = sz.forward_frames
    scene, cam = mrt.cornell_scene(), mrt.Camera.default()
    cfg = mrt.RenderConfig(width=W, height=H, bounces=B)
    img, rec = timed(lambda s, c: mrt.render(s, c, cfg, frames=F),
                     (scene, cam), sz.iters, per_call=F)
    img = np.asarray(img)
    check(img.shape == (H, W, 3), f"shape {img.shape}")
    check(bool(np.isfinite(img).all()), "non-finite pixels")
    check(bool((img >= 0).all()), "negative pixels")
    nonzero = float((img.sum(-1) > 0).mean())
    check(nonzero > 0.5, f"only {nonzero:.3f} of pixels nonzero")
    # Red wall on the left, green wall on the right: over the middle
    # rows, the reddest column lies in the left half and the greenest in
    # the right half.
    band = img[H // 3: 2 * H // 3].mean(axis=0)
    red_excess = band[:, 0] - band[:, 1]
    reddest, greenest = int(np.argmax(red_excess)), int(np.argmin(red_excess))
    check(reddest < W // 2 and red_excess[reddest] > 0.1,
          f"no red wall on the left (column {reddest})")
    check(greenest >= W // 2 and -red_excess[greenest] > 0.1,
          f"no green wall on the right (column {greenest})")
    rec.update(shape=[H, W, B], frames_per_call=F, mean=float(img.mean()),
               nonzero=nonzero, reddest_column=reddest,
               greenest_column=greenest,
               rays_per_s=W * H * B / (rec["steady_ms"] * 1e-3))
    return rec


def phase_grad_step(mrt, sz: Sizes):
    import jax
    import jax.numpy as jnp
    W, H, B = sz.grad
    scene, cam = mrt.cornell_scene(), mrt.Camera.default()
    cfg = mrt.RenderConfig(width=W, height=H, bounces=B, remat=True)

    def loss(s):
        return jnp.mean(mrt.render_sample(s, cam, cfg, frame=0))

    (val, g), rec = timed(jax.value_and_grad(loss, allow_int=True),
                          (scene,), sz.iters)
    leaves = _float_leaves(g)
    check(bool(np.isfinite(float(val))), "non-finite loss")
    check(all(np.isfinite(x).all() for x in leaves),
          "non-finite gradient leaf")
    check(any(np.abs(x).max() > 0 for x in leaves), "all-zero gradient")
    rec.update(shape=[H, W, B], loss=float(val), n_float_leaves=len(leaves),
               rays_per_s=W * H * B / (rec["steady_ms"] * 1e-3))
    return rec


def _large_scene(mrt, which: str, sz: Sizes):
    from mini_opencl_raytracer.models.procedural import (bunny_scene,
                                                         sponza_scene)
    if which == "bunny":
        return bunny_scene(sz.bunny_tris)
    return sponza_scene(sz.sponza_tris)


def phase_large(mrt, which: str, sz: Sizes):
    import jax
    import jax.numpy as jnp
    from mini_opencl_raytracer.render import resolve_backend
    W, H, B = getattr(sz, which)
    scene, cam = _large_scene(mrt, which, sz), mrt.Camera.default()
    cfg = mrt.RenderConfig(width=W, height=H, bounces=B)
    t0 = time.perf_counter()
    accel = jax.block_until_ready(mrt.build_accel(scene, cfg))
    build_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    accel = jax.block_until_ready(mrt.build_accel(scene, cfg))
    build_s = time.perf_counter() - t0
    img, rec = timed(
        lambda s, a, f: mrt.render_sample(s, cam, cfg, frame=f, accel=a),
        (scene, accel, jnp.uint32(0)), sz.iters)
    img = np.asarray(img)
    check(img.shape == (H, W, 3), f"shape {img.shape}")
    check(bool(np.isfinite(img).all()), "non-finite pixels")
    check(bool((img >= 0).all()), "negative pixels")
    nonzero = float((img.sum(-1) > 0).mean())
    check(nonzero > 0.5, f"only {nonzero:.3f} of pixels nonzero")
    rec.update(triangles=scene.num_triangles, shape=[H, W, B],
               backend=resolve_backend(scene, cfg),
               accel_build_first_s=build_first_s, accel_build_s=build_s,
               mean=float(img.mean()), nonzero=nonzero,
               rays_per_s=W * H * B / (rec["steady_ms"] * 1e-3))
    return rec


def _compare_images(a, b):
    bad, max_abs = frac_mismatch(a, b, IMG_ATOL, IMG_RTOL)
    rec = {"bad_pixel_frac": bad, "max_abs_diff": max_abs,
           "mean_abs_diff": float(np.abs(np.asarray(a, np.float64)
                                         - np.asarray(b)).mean()),
           "atol": IMG_ATOL, "rtol": IMG_RTOL, "max_bad_frac": IMG_MAX_BAD}
    check(bool(np.isfinite(np.asarray(a)).all()), "non-finite test image")
    check(bad <= IMG_MAX_BAD,
          f"{bad:.4f} of pixels differ (limit {IMG_MAX_BAD})")
    return rec


def _render_pair(mrt, scene, cam, W, H, B):
    """(bvh image, bruteforce image) of one sample; the reference runs
    with every matmul at the highest precision."""
    import jax
    out = {}
    for backend in ("bvh", "bruteforce"):
        cfg = mrt.RenderConfig(width=W, height=H, bounces=B, backend=backend)
        with jax.default_matmul_precision("highest"):
            f = jax.jit(lambda s, c: mrt.render_sample(s, c, cfg, frame=0))
            out[backend] = np.asarray(f(scene, cam))
    return out["bvh"], out["bruteforce"]


def phase_compare_cornell(mrt, sz: Sizes):
    W, H, B = sz.compare_cornell
    a, b = _render_pair(mrt, mrt.cornell_scene(), mrt.Camera.default(),
                        W, H, B)
    rec = _compare_images(a, b)
    rec.update(shape=[H, W, B])
    return rec


def phase_compare_large(mrt, which: str, sz: Sizes):
    W, H = sz.compare_large
    B = getattr(sz, which)[2]
    scene = _large_scene(mrt, which, sz)
    a, b = _render_pair(mrt, scene, mrt.Camera.default(), W, H, B)
    rec = _compare_images(a, b)
    rec.update(triangles=scene.num_triangles, shape=[H, W, B])
    return rec


def phase_compare_grads(mrt, sz: Sizes):
    import jax
    import jax.numpy as jnp
    W, H, B = sz.compare_grad
    scene, cam = mrt.cornell_scene(), mrt.Camera.default()

    def loss_for(backend):
        cfg = mrt.RenderConfig(width=W, height=H, bounces=B,
                               backend=backend)
        return lambda s: jnp.mean(mrt.render_sample(s, cam, cfg, frame=0))

    loss_bvh = jax.jit(loss_for("bvh"))
    (_, g_bvh), rec = timed(
        jax.value_and_grad(loss_for("bvh"), allow_int=True), (scene,),
        sz.iters)
    with jax.default_matmul_precision("highest"):
        _, g_ref = jax.jit(jax.value_and_grad(loss_for("bruteforce"),
                                              allow_int=True))(scene)
    rec.update(_check_grads(g_bvh, g_ref))

    # Finite-difference check of the diffuse-albedo entry with the
    # largest gradient.
    kd = np.asarray(scene.materials.diffuse)
    g_kd = np.asarray(g_bvh.materials.diffuse)
    m, c = np.unravel_index(np.argmax(np.abs(g_kd)), g_kd.shape)

    def with_kd(v):
        mats = scene.materials.replace(
            diffuse=jnp.asarray(kd).at[m, c].set(v))
        return scene.replace(materials=mats)

    fd = (float(loss_bvh(with_kd(kd[m, c] + FD_EPS)))
          - float(loss_bvh(with_kd(kd[m, c] - FD_EPS)))) / (2 * FD_EPS)
    ad = float(g_kd[m, c])
    fd_err = abs(ad - fd) / max(abs(fd), 1e-12)
    check(fd_err <= FD_RTOL, f"FD {fd:.6g} vs AD {ad:.6g} ({fd_err:.3g})")
    rec.update(shape=[H, W, B], fd_index=[int(m), int(c)], fd=fd, ad=ad,
               fd_rel_err=fd_err, fd_eps=FD_EPS, fd_rtol=FD_RTOL)
    return rec


def phase_dp_render(mrt, sz: Sizes, cards: int):
    import jax
    from mini_opencl_raytracer.config import MeshConfig
    from mini_opencl_raytracer.parallel import mesh as mesh_mod
    from mini_opencl_raytracer.parallel.shard import render_sample_dp
    W, H, B = sz.forward
    scene, cam = mrt.cornell_scene(), mrt.Camera.default()
    cfg = mrt.RenderConfig(width=W, height=H, bounces=B)
    mesh_cfg = MeshConfig(dp=cards, tp=1)
    mesh = mesh_mod.make_mesh(mesh_cfg, jax.devices()[:cards])
    img, rec = timed(
        lambda s, c: render_sample_dp(s, c, cfg, mesh, mesh_cfg=mesh_cfg),
        (scene, cam), sz.iters)
    single, rec1 = timed(
        lambda s, c: mrt.render_sample(s, c, cfg, frame=0),
        jax.device_put((scene, cam), jax.devices()[0]), sz.iters)
    rec.update(_compare_images(img, single))
    rec.update(shape=[H, W, B], cards=cards,
               single_card_steady_ms=rec1["steady_ms"],
               speedup=rec1["steady_ms"] / rec["steady_ms"])
    return rec


def phase_dp_grads(mrt, sz: Sizes, cards: int):
    """The dp training step with one gradient all-reduce and with
    DP_GRAD_BUCKETS, each against the one-card gradient."""
    import jax
    import jax.numpy as jnp
    from mini_opencl_raytracer.config import MeshConfig
    from mini_opencl_raytracer.parallel import mesh as mesh_mod
    from mini_opencl_raytracer.parallel.shard import train_step_dp
    W, H, B = sz.compare_grad
    scene, cam = mrt.cornell_scene(), mrt.Camera.default()
    cfg = mrt.RenderConfig(width=W, height=H, bounces=B)
    mesh_cfg = MeshConfig(dp=cards, tp=1)
    mesh = mesh_mod.make_mesh(mesh_cfg, jax.devices()[:cards])

    def loss1(s):
        return jnp.mean(mrt.render_sample(s, cam, cfg, frame=0))

    (loss_ref, g_ref), rec1 = timed(
        jax.value_and_grad(loss1, allow_int=True),
        (jax.device_put(scene, jax.devices()[0]),), sz.iters)
    rec = {"shape": [H, W, B], "cards": cards,
           "single_card_steady_ms": rec1["steady_ms"]}
    for buckets in (1, DP_GRAD_BUCKETS):
        (loss, g_dp), rb = timed(
            lambda s: train_step_dp(s, cam, cfg, mesh, mesh_cfg=mesh_cfg,
                                    grad_buckets=buckets),
            (scene,), sz.iters)
        rb.update(_check_grads(g_dp, g_ref))
        rb["loss_rel_err"] = (abs(float(loss) - float(loss_ref))
                              / abs(float(loss_ref)))
        check(rb["loss_rel_err"] <= IMG_RTOL,
              f"{buckets} buckets: loss rel err {rb['loss_rel_err']:.3g}")
        rb["speedup"] = rec1["steady_ms"] / rb["steady_ms"]
        rec[f"buckets_{buckets}"] = rb
    return rec


def run_phase(name: str, fn) -> bool:
    """Run one phase and print its JSON line. A failure is reported and
    the remaining phases still run; the exit code records it."""
    t0 = time.perf_counter()
    try:
        rec = {"phase": name, "ok": True, **fn()}
    except Exception as exc:  # noqa: BLE001 - reported, exit code non-zero
        traceback.print_exc()
        rec = {"phase": name, "ok": False,
               "error": f"{type(exc).__name__}: {exc}"[:1000]}
    rec["wall_s"] = time.perf_counter() - t0
    rec["peak_bytes_in_use"] = _peak_bytes()
    print(json.dumps(rec), flush=True)
    return rec["ok"]


def phases(mrt, sz: Sizes, cards: int):
    """(name, thunk) of every phase of a run on ``cards`` devices."""
    if cards > 1:
        return [("dp_render", lambda: phase_dp_render(mrt, sz, cards)),
                ("dp_grads", lambda: phase_dp_grads(mrt, sz, cards))]
    return [
        ("forward", lambda: phase_forward(mrt, sz)),
        ("grad_step", lambda: phase_grad_step(mrt, sz)),
        ("bunny", lambda: phase_large(mrt, "bunny", sz)),
        ("sponza", lambda: phase_large(mrt, "sponza", sz)),
        ("compare_cornell", lambda: phase_compare_cornell(mrt, sz)),
        ("compare_bunny", lambda: phase_compare_large(mrt, "bunny", sz)),
        ("compare_sponza", lambda: phase_compare_large(mrt, "sponza", sz)),
        ("compare_grads", lambda: phase_compare_grads(mrt, sz)),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="1: every single-card phase; 4: the dp render "
                         "and dp gradient step on four GPUs")
    args = ap.parse_args(argv)

    import jax
    import mini_opencl_raytracer as mrt
    from mini_opencl_raytracer.utils.cache import enable_persistent_cache
    from mini_opencl_raytracer.utils.metrics import (
        device_record, gpu_name_and_power_limit)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"chip_smoke: {args.cards} GPUs needed, {len(devices)} found",
              file=sys.stderr)
        return 2
    enable_persistent_cache()
    print(f"gpu: {gpu_name_and_power_limit()}")
    xla_flags = os.environ.get("XLA_FLAGS", "")
    print(f"jax {jax.__version__}, XLA_FLAGS={xla_flags!r}", flush=True)

    ok = all([run_phase(name, fn)
              for name, fn in phases(mrt, Sizes(), args.cards)])
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device_record()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
