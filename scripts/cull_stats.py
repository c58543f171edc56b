#!/usr/bin/env python3
"""What the per-warp cull of the panel and first-bounce kernels keeps
(csrc/bundle.cuh), by its model (ops/cuda/bundle_cull.py), on Cornell's
wavefront rays: primary rays in render_sample's tile order, the bounce-1
rays of the live paths in that order and coherence-sorted, and the shadow
rays of the primary hits toward light 0.

    python3 scripts/cull_stats.py [--width 1920 --height 1080] [--device cuda]

Per ray set: the share of warps that go dense (directions straddling 0 on
two or more axes) and of those that straddle on one axis, the records the
cull keeps per culled warp, the records it would keep on the dense warps
if they were culled, and the M-T tests per ray that the kernels run. The
cull costs one round of the test per 32 records and lane; it saves an
exact test per dropped record and lane: the dense rule is right where it
would keep nearly every record. Counts are the model's, the kernels' own
on the card (chip_smoke.py phase 8 holds them equal).
"""

from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    import mini_opencl_raytracer_tpu_torch as mrt
    from mini_opencl_raytracer_tpu_torch.ops.cuda import bundle_cull as bc
    from mini_opencl_raytracer_tpu_torch.ops.cuda import panel

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device(args.device)
    scene, cam = mrt.cornell_scene(device=dev), mrt.Camera.default(device=dev)
    cfg = mrt.RenderConfig(width=args.width, height=args.height)
    tris = panel.pack_triangles(scene.geometry)
    rays = smoke.wavefront_rays(mrt, torch, scene, cam, cfg,
                                *panel.make_intersectors(scene.geometry, cfg))
    print(f"Cornell {cfg.width}x{cfg.height}, {tris.shape[0]} records ({args.device})")
    for name in ("primary", "bounce1", "bounce1_sorted", "shadow"):
        o, d = rays[name][:2]
        limit = (rays[name][2] if name == "shadow"
                 else torch.full((o.shape[0],), cfg.t_max, device=dev))
        live = torch.ones((o.shape[0],), dtype=torch.bool, device=dev)
        olo, ohi, dlo, dhi, thi, dense, empty = bc.bundles(o, d, limit, live)
        straddle = (~(dlo > 0) & ~(dhi < 0)).sum(1)
        kept, cull = bc.candidates(tris, o, d, limit, live)
        would = bc.keep(tris, olo[dense], ohi[dense], dlo[dense], dhi[dense], thi[dense])
        tests = bc.cull_hits(tris, o, d, limit, False, any_hit=(name == "shadow"))[2]
        print(f"{name}: {o.shape[0]} rays, {dense.shape[0]} warps; dense "
              f"{dense.float().mean().item():.4f}, one axis straddled "
              f"{(straddle == 1).float().mean().item():.4f}; kept per culled warp "
              f"{kept[cull].sum(1).float().mean().item():.3f}; the cull would keep "
              f"{would.sum(1).float().mean().item() if would.numel() else 0.0:.3f} per dense "
              f"warp; M-T tests per ray {tests.float().mean().item():.3f}"
              + (" (any mode)" if name == "shadow" else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
