"""Headless CLI: render / benchmark / optimize (the JAX package's
``cli.py``, with the same flags and defaults, plus ``--device``).

Replaces the reference's GLFW window and ImGui panel (CLEngineBase.cpp,
CLui.cpp): every widget (camera position and angles, light type, skybox
intensity, bounces; CLui.cpp:204-266) is a flag, and ``optimize`` is the
differentiable material optimisation of BASELINE.json config 4.

    python -m mini_opencl_raytracer_tpu_torch.cli render --out img.png
    python -m mini_opencl_raytracer_tpu_torch.cli render --scene mesh.obj \\
        --width 1920 --height 1080 --frames 4 --checkpoint st.npz
    python -m mini_opencl_raytracer_tpu_torch.cli render --resume st.npz ...
    python -m mini_opencl_raytracer_tpu_torch.cli benchmark --width 1920 \\
        --height 1080 --bounces 9 --occupancy
    python -m mini_opencl_raytracer_tpu_torch.cli optimize --steps 50

``--device`` defaults to ``cuda``: without a CUDA device the command
fails (NoAcceleratorError); ``--device cpu`` runs the kernels' plain
versions on the CPU.

As in the JAX package's CLI, ``render`` runs its per-frame sample and
``optimize`` its value-and-grad step as compiled programs (jit.py: CUDA
graphs, replayed from the second call on; the frame goes in as a device
tensor), and ``benchmark`` times ``utils/metrics.scan_frames``' compiled
program, on every backend.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from . import (Camera, Lights, RenderConfig, RenderState, accumulate, build_accel,
               cornell_scene, load_scene, render_sample, resolve_backend, to_image)
from .config import default_device
from .jit import jit
from .utils import checkpoint as ckpt
from .utils.image import write_npy, write_pfm, write_png
from .utils.metrics import bounce_occupancy, render_metrics, time_scan_fn


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default=None,
                   help="OBJ file (default: built-in Cornell box)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--bounces", type=int, default=9)
    p.add_argument("--frames", type=int, default=16,
                   help="progressive samples to accumulate; 0 = refine "
                        "until interrupted (Ctrl-C writes the image)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "bruteforce", "bvh", "pallas", "mega"])
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
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; cpu runs "
                        "the kernels' plain versions)")


def _build(args):
    device = default_device(args.device)
    cfg = RenderConfig(
        width=args.width, height=args.height, bounces=args.bounces,
        backend=args.backend, fov_deg=args.fov,
        skybox_intensity=args.skybox_intensity,
        shadow_rays=args.shadow_rays, direct_specular=args.direct_specular)
    scene = (load_scene(args.scene, device=device) if args.scene
             else cornell_scene(device=device))
    if args.light_type == "directional":
        scene = dataclasses.replace(scene, lights=Lights.default_directional(device=device))
    elif args.light_type == "point":
        scene = dataclasses.replace(scene, lights=Lights.default_point(device=device))
    camera = Camera.from_angles(args.camera_pos, args.camera_pitch,
                                args.camera_yaw, device=device)
    return scene, camera, cfg


@torch.no_grad()
def cmd_render(args) -> int:
    scene, camera, cfg = _build(args)
    # The acceleration structure is built once, outside the frame loop
    # (the reference's load-time build, CLBVHnode.cpp:185-207).
    accel = build_accel(scene, cfg)

    @jit
    def sample(s, c, a, f):
        return render_sample(s, c, cfg, frame=f, accel=a)

    state = RenderState.create(cfg, scene.device)
    start = 0
    if args.resume:
        state = ckpt.load_render_state(args.resume, state)
        start = state.num_samples
        print(f"resumed at {start} samples", file=sys.stderr)
    # --frames 0 refines until interrupted (the reference's progressive
    # window, CLEngineBase.cpp:192-210): Ctrl-C stops, the image is
    # written, and periodic checkpoints make the run resumable.
    endless = args.frames == 0
    end = start + (args.frames if not endless else 1 << 62)
    f = start
    try:
        while f < end:
            frame = torch.full((), f, dtype=torch.int64, device=scene.device)
            state = accumulate(state, sample(scene, camera, accel, frame))
            f += 1
            if endless and args.checkpoint and f % args.checkpoint_every == 0:
                ckpt.save_render_state(args.checkpoint, state)
                print(f"{f} samples (checkpointed)", file=sys.stderr)
    except KeyboardInterrupt:
        print(f"interrupted at {f} samples", file=sys.stderr)
    if args.checkpoint:
        ckpt.save_render_state(args.checkpoint, state)
    out = args.out
    if out.endswith(".pfm"):
        write_pfm(out, state.mean())
    elif out.endswith(".npy"):
        write_npy(out, to_image(state, cfg.gamma))
    else:
        write_png(out, to_image(state, cfg.gamma))
    print(out)
    return 0


@torch.no_grad()
def cmd_benchmark(args) -> int:
    scene, camera, cfg = _build(args)
    accel = build_accel(scene, cfg)

    # Per-frame time of one call of 8 distinct frames (a compiled program),
    # timed by CUDA events on the card (utils/metrics.time_scan_fn).
    def frame(fr, data):
        s, c, a = data
        return render_sample(s, c, cfg, frame=fr, accel=a).mean()

    sec = time_scan_fn(frame, inner=8, iters=args.iters, data=(scene, camera, accel))
    m = render_metrics(sec, cfg.width, cfg.height, cfg.bounces, cfg.spp)
    m.update(backend=resolve_backend(scene, cfg), width=cfg.width,
             height=cfg.height, bounces=cfg.bounces, triangles=scene.num_triangles,
             device=str(scene.device))
    if args.occupancy:
        occ = bounce_occupancy(scene, camera, cfg)
        m["live_ray_fraction_per_bounce"] = [round(float(x), 4) for x in occ.tolist()]
    print(json.dumps(m))
    return 0


def cmd_optimize(args) -> int:
    """Differentiable material optimisation (BASELINE.json config 4):
    recover the Cornell wall albedos from a target render, by gradient
    descent through torch autograd of ``render_sample``; the value and
    gradient are one compiled program (the JAX CLI's
    ``jit(value_and_grad)``)."""
    scene, camera, cfg = _build(args)
    with torch.no_grad():
        target = render_sample(scene, camera, cfg, frame=0)
    truth = scene.materials.diffuse

    @jit
    def value_and_grad(diffuse):
        diffuse = diffuse.detach().requires_grad_()
        s = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, diffuse=diffuse))
        loss = torch.mean((render_sample(s, camera, cfg, frame=0) - target) ** 2)
        (g,) = torch.autograd.grad(loss, diffuse)
        return loss.detach(), g

    kd = torch.clamp(truth * 0.2 + 0.4, 0.0, 1.0)
    for step in range(args.steps):
        loss, g = value_and_grad(kd)
        kd = torch.clamp(kd - args.lr * g, 0.0, 1.0)
        if step % max(args.steps // 10, 1) == 0:
            print(f"step {step:4d} loss {loss.item():.3e}", file=sys.stderr)
    err = (kd - truth).abs().max().item()
    print(json.dumps({"final_loss": loss.item(), "max_abs_err": err,
                      "steps": args.steps}))
    return 0


def main(argv=None) -> int:
    from .utils.cache import enable_persistent_cache
    enable_persistent_cache()
    ap = argparse.ArgumentParser(prog="mini_opencl_raytracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render an image")
    _add_render_args(pr)
    pr.add_argument("--out", default="render.png",
                    help="output file: .pfm (linear), .npy or .png (gamma)")
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
    # Recognised device failures surface as typed errors with the remedy
    # attached (the reference's CLException -> MessageBox path).
    from .utils.errors import run_decoded
    return run_decoded(lambda: args.fn(args))


if __name__ == "__main__":
    raise SystemExit(main())
