"""Headless path-tracing render CLI (port of steeljax/apps/render_cli.py,
PT mode only).

Renders N accumulated frames of a builtin scene and writes a PNG:

    python -m steeljax_torch.apps.render_cli builtin:cornell -o out.png \
        --size 320x180 --spp 8 --device cuda [--instancing]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Path-trace a builtin scene on a CUDA card (or the CPU "
                    "when asked) and write a PNG.")
    parser.add_argument("scene", help="builtin:cornell")
    parser.add_argument("-o", "--output", default="render.png")
    parser.add_argument("--size", default="1280x720",
                        help="WIDTHxHEIGHT (default 1280x720)")
    parser.add_argument("--spp", type=int, default=16,
                        help="accumulated samples per pixel")
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

    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.io.image import write_png
    from steeljax_torch.render.pt.renderer import PathTracingRenderer
    from steeljax_torch.scene.builtin import make_cornell_scene

    renderer = PathTracingRenderer(
        make_cornell_scene(), width, height,
        RenderConfig(width=width, height=height),
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
