"""Headless render CLI (port of steeljax/apps/render_cli.py: the path
tracer and the hybrid renderer on builtin scenes).

`--mode pt` (the default) renders N accumulated frames, `--mode hybrid` one
hybrid frame, whose environment bakes at load_environment's full budgets
first; either writes a PNG:

    python -m steeljax_torch.apps.render_cli builtin:cornell -o out.png \
        --size 320x180 --spp 8 --device cuda [--instancing]
    python -m steeljax_torch.apps.render_cli builtin:cornell --mode hybrid \
        -o hybrid.png --size 320x180 --device cuda
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Render a builtin scene on a CUDA card (or the CPU "
                    "when asked) and write a PNG.")
    parser.add_argument("scene", help="builtin:cornell")
    parser.add_argument("--mode", choices=["pt", "hybrid"], default="pt",
                        help="path tracer (default) or hybrid renderer")
    parser.add_argument("-o", "--output", default="render.png")
    parser.add_argument("--size", default="1280x720",
                        help="WIDTHxHEIGHT (default 1280x720)")
    parser.add_argument("--spp", type=int, default=16,
                        help="accumulated samples per pixel (pt mode)")
    parser.add_argument("--device", default="cuda",
                        help="render device: cuda (default), cuda:N or cpu")
    parser.add_argument("--instancing", action="store_true",
                        help="two-level acceleration structure (per-"
                             "primitive BLAS + instance TLAS)")
    args = parser.parse_args(argv)

    try:
        width, height = (int(v) for v in args.size.split("x"))
    except ValueError:
        parser.error(f"--size must be WIDTHxHEIGHT, got {args.size!r}")
    if args.scene != "builtin:cornell":
        raise NotImplementedError(
            f"scene {args.scene!r}: GLTF loading is not ported yet "
            "(ROADMAP item 4); the port renders builtin:cornell")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA card is "
                           "available (pass --device cpu to render on the "
                           "CPU)")

    from steeljax_torch.accel.instances import InstancedAccel
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.io.image import write_png
    from steeljax_torch.render.pt.renderer import (PathTracingRenderer,
                                                   prepare_scene)
    from steeljax_torch.scene.builtin import make_cornell_scene

    scene = make_cornell_scene()
    config = RenderConfig(width=width, height=height)
    if args.mode == "hybrid":
        from steeljax_torch.render.hybrid.renderer import HybridRenderer

        t0 = time.perf_counter()
        prepared = None
        if args.instancing:
            prepared = prepare_scene(scene, device,
                                     accel=InstancedAccel(device=device))
        renderer = HybridRenderer(scene, width, height, config,
                                  prepared=prepared, device=device)
        t1 = time.perf_counter()
        image = renderer.render_frame()  # host numpy: synchronized
        print(f"hybrid: preparation and environment bake {t1 - t0:.2f} s, "
              f"frame {(time.perf_counter() - t1) * 1000.0:.2f} ms on "
              f"{device}")
        write_png(args.output, image)
        print(f"wrote {args.output} ({width}x{height}, hybrid)")
        return 0

    renderer = PathTracingRenderer(scene, width, height, config,
                                   instancing=args.instancing, device=device)
    image = None
    for i in range(args.spp):
        t0 = time.perf_counter()
        image = renderer.render_frame()  # returns host numpy: synchronized
        dt = max(time.perf_counter() - t0, 1e-9)
        print(f"frame {i + 1}/{args.spp}: {dt * 1000.0:.2f} ms "
              f"({width * height / dt / 1e6:.1f} Mpixel/s) on {device}")
    write_png(args.output, image)
    print(f"wrote {args.output} ({width}x{height}, {args.spp} spp)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
