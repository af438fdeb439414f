"""Headless CLI: render / benchmark / optimize.

Replaces the reference's GLFW window + ImGui control panel
(CLEngineBase.cpp, CLui.cpp) — every ImGui widget (camera pos/rot, light
params, skybox intensity, bounces, light type; CLui.cpp:204-266) is a
flag here, and the 'optimize' subcommand is the differentiable material
optimization loop of BASELINE.json config 4.

    python -m mini_opencl_raytracer.cli render --out img.png
    python -m mini_opencl_raytracer.cli render --scene mesh.obj \\
        --width 1920 --height 1080 --frames 64 --backend auto
    python -m mini_opencl_raytracer.cli benchmark --width 1920 \\
        --height 1080 --bounces 9
    python -m mini_opencl_raytracer.cli optimize --steps 50
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp

from . import (Camera, Lights, RenderConfig, RenderState, accumulate,
               cornell_scene, load_scene, render_sample, to_image)
from .render import BACKENDS
from .utils import checkpoint as ckpt
from .utils.image import write_npy, write_pfm, write_png
from .utils.metrics import render_metrics


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default=None,
                   help="OBJ file (default: built-in Cornell box)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--bounces", type=int, default=9)
    p.add_argument("--frames", type=int, default=16,
                   help="progressive samples to accumulate; 0 = refine "
                        "until interrupted (Ctrl-C writes the image)")
    p.add_argument("--backend", default="auto", choices=BACKENDS)
    p.add_argument("--fov", type=float, default=45.0)
    p.add_argument("--skybox-intensity", type=float, default=1.0)
    p.add_argument("--light-type", default=None,
                   choices=[None, "directional", "point"],
                   help="override scene light with a default of this type")
    p.add_argument("--shadow-rays", action="store_true")
    p.add_argument("--direct-specular", action="store_true")
    p.add_argument("--camera-pos", type=float, nargs=3,
                   default=[0.0, -25.0, 8.5])
    p.add_argument("--camera-pitch", type=float, default=1.571)
    p.add_argument("--camera-yaw", type=float, default=1.571)


def _build(args):
    cfg = RenderConfig(
        width=args.width, height=args.height, bounces=args.bounces,
        backend=args.backend, fov_deg=args.fov,
        skybox_intensity=args.skybox_intensity,
        shadow_rays=args.shadow_rays, direct_specular=args.direct_specular)
    scene = load_scene(args.scene) if args.scene else cornell_scene()
    if args.light_type == "directional":
        scene = scene.replace(lights=Lights.default_directional())
    elif args.light_type == "point":
        scene = scene.replace(lights=Lights.default_point())
    camera = Camera.from_angles(args.camera_pos, args.camera_pitch,
                                args.camera_yaw)
    return scene, camera, cfg


def cmd_render(args) -> int:
    scene, camera, cfg = _build(args)
    # Build the acceleration structure once, outside the frame loop —
    # the reference's load-time build (CLBVHnode.cpp:185-207).
    from .render import build_accel
    accel = build_accel(scene, cfg)
    sample = jax.jit(lambda s, c, a, f: render_sample(s, c, cfg, frame=f,
                                                      accel=a),
                     static_argnums=())
    state = RenderState.create(cfg)
    start = 0
    if args.resume:
        state = ckpt.load_render_state(args.resume, state)
        start = int(state.num_samples)
        print(f"resumed at {start} samples", file=sys.stderr)
    # --frames 0: refine until interrupted — the reference's progressive
    # window UX (accumulate until the user acts, CLui.cpp:204-266 /
    # CLEngineBase.cpp:192-210), headless: Ctrl-C stops and the image is
    # written; periodic checkpoints make the run resumable.
    endless = args.frames == 0
    end = start + (args.frames if not endless else 1 << 62)
    f = start
    try:
        while f < end:
            state = accumulate(state, sample(scene, camera, accel, f))
            f += 1
            if (endless and args.checkpoint
                    and f % args.checkpoint_every == 0):
                ckpt.save_render_state(args.checkpoint, state)
                print(f"{f} samples (checkpointed)", file=sys.stderr)
    except KeyboardInterrupt:
        print(f"interrupted at {f} samples", file=sys.stderr)
    img = to_image(state, cfg.gamma)
    if args.checkpoint:
        ckpt.save_render_state(args.checkpoint, state)
    out = args.out
    if out.endswith(".pfm"):
        write_pfm(out, state.mean())
    elif out.endswith(".npy"):
        write_npy(out, np.asarray(img))
    else:
        write_png(out, img)
    print(out)
    return 0


def cmd_benchmark(args) -> int:
    from .render import build_accel, resolve_backend
    from .utils.metrics import time_scan_fn
    scene, camera, cfg = _build(args)
    accel = build_accel(scene, cfg)

    # 8 distinct frames per jitted scan (utils.metrics.time_scan_fn),
    # scene/accel passed as jit arguments rather than closure constants.
    def frame(fr, data):
        s, c, a = data
        return jnp.mean(render_sample(s, c, cfg, frame=fr, accel=a))

    sec = time_scan_fn(frame, inner=8, iters=args.iters,
                       data=(scene, camera, accel))
    m = render_metrics(sec, cfg.width, cfg.height, cfg.bounces, cfg.spp)
    m.update(backend=resolve_backend(scene, cfg), width=cfg.width,
             height=cfg.height, bounces=cfg.bounces,
             triangles=scene.num_triangles)
    if args.occupancy:
        from .utils.metrics import bounce_occupancy
        occ = bounce_occupancy(scene, camera, cfg)
        m["live_ray_fraction_per_bounce"] = [
            round(float(x), 4) for x in occ]
    print(json.dumps(m))
    return 0


def cmd_optimize(args) -> int:
    """Differentiable material optimization (BASELINE.json config 4):
    recover the Cornell wall albedos from a target render."""
    scene, camera, cfg = _build(args)
    target = render_sample(scene, camera, cfg, frame=0)

    def loss_fn(diffuse):
        s = scene.replace(materials=scene.materials.replace(diffuse=diffuse))
        img = render_sample(s, camera, cfg, frame=0)
        return jnp.mean((img - target) ** 2)

    vg = jax.jit(jax.value_and_grad(loss_fn))
    kd = jnp.clip(scene.materials.diffuse * 0.2 + 0.4, 0.0, 1.0)
    for step in range(args.steps):
        loss, g = vg(kd)
        kd = jnp.clip(kd - args.lr * g, 0.0, 1.0)
        if step % max(args.steps // 10, 1) == 0:
            print(f"step {step:4d} loss {float(loss):.3e}", file=sys.stderr)
    err = float(jnp.abs(kd - scene.materials.diffuse).max())
    print(json.dumps({"final_loss": float(loss), "max_abs_err": err,
                      "steps": args.steps}))
    return 0


def main(argv=None) -> int:
    from .utils.cache import enable_persistent_cache
    enable_persistent_cache()
    ap = argparse.ArgumentParser(prog="mini_opencl_raytracer")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render an image")
    _add_render_args(pr)
    pr.add_argument("--out", default="render.png")
    pr.add_argument("--checkpoint", default=None,
                    help="save progressive state to this .npz")
    pr.add_argument("--resume", default=None,
                    help="resume progressive state from this .npz")
    pr.add_argument("--checkpoint-every", type=int, default=64,
                    help="checkpoint interval (frames) when --frames 0")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("benchmark", help="measure rays/s")
    _add_render_args(pb)
    pb.add_argument("--iters", type=int, default=5)
    pb.add_argument("--occupancy", action="store_true",
                    help="also report per-bounce live-ray fractions")
    pb.set_defaults(fn=cmd_benchmark)

    po = sub.add_parser("optimize", help="material optimization demo")
    _add_render_args(po)
    po.add_argument("--steps", type=int, default=40)
    po.add_argument("--lr", type=float, default=2.0)
    po.set_defaults(fn=cmd_optimize)

    args = ap.parse_args(argv)
    # Typed device-error decoding (the reference's CLException ->
    # MessageBox path, CLEngineBase.cpp:181-185): recognized runtime
    # failures surface with the framework-level remedy attached.
    from .utils.errors import run_decoded
    return run_decoded(lambda: args.fn(args))


if __name__ == "__main__":
    raise SystemExit(main())
