"""Headless render CLI (port of steeljax/apps/render_cli.py: the path
tracer and the hybrid renderer on a GLTF file or the builtin Cornell box).

`--mode pt` (the default) renders N accumulated frames, `--mode hybrid` one
hybrid frame, whose environment bakes at load_environment's full budgets
first; either writes a PNG:

    python -m steeljax_torch.apps.render_cli scene.gltf -o out.png \
        --size 320x180 --spp 8 --device cuda [--validate] [--bvh-width 16]
    python -m steeljax_torch.apps.render_cli builtin:cornell -o out.png \
        --size 320x180 --spp 8 --device cuda [--instancing] \
        [--checkpoint accum.npz] [--profile trace_dir] [--overlay]
    python -m steeljax_torch.apps.render_cli builtin:cornell --mode hybrid \
        -o hybrid.png --size 320x180 --device cuda [--debug-view normals]
    python -m steeljax_torch.apps.render_cli builtin:cornell --mode hybrid \
        -o gi.png --size 320x180 --device cuda --gi [--show-probes] \
        [--lv-checkpoint lv.npz]

`--checkpoint FILE.npz` resumes the accumulation from FILE when it exists
(a checkpoint of another size starts afresh) and saves it at the end;
`--profile DIR` writes a torch.profiler Chrome trace of the frames into
DIR.  `--gi` (hybrid mode) bakes the light volume on the render device
(`--gi-spp`, `--gi-min-edge`, `--gi-resolution`) and lights the frame with
it; `--lv-checkpoint FILE.npz` loads the bake from FILE when it exists,
else bakes and saves it there; `--show-probes` (which implies `--gi`)
splats the probes over the frame.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Render a GLTF scene or the builtin Cornell box on a "
                    "CUDA card (or the CPU when asked) and write a PNG.")
    parser.add_argument("scene", help="GLTF path or builtin:cornell")
    parser.add_argument("--mode", choices=["pt", "hybrid"], default="pt",
                        help="path tracer (default) or hybrid renderer")
    parser.add_argument("-o", "--output", default="render.png")
    parser.add_argument("--size", default="1280x720",
                        help="WIDTHxHEIGHT (default 1280x720)")
    parser.add_argument("--spp", type=int, default=16,
                        help="accumulated samples per pixel (pt mode)")
    parser.add_argument("--gi", action="store_true",
                        help="bake + use the light-volume GI (hybrid mode)")
    parser.add_argument("--show-probes", action="store_true",
                        help="overlay light-volume probe splats on the "
                             "frame (the reference's orphaned LightVolume"
                             "Positions viz, working; implies --gi)")
    parser.add_argument("--gi-spp", type=int, default=8,
                        help="probe-capture samples per pixel")
    parser.add_argument("--gi-min-edge", type=float, default=None,
                        help="octree min cell edge for probe placement "
                             "(GlobalIllumination.cpp:34 default 0.5)")
    parser.add_argument("--gi-resolution", type=int, default=None,
                        help="probe cubemap face resolution (default 32, "
                             "ProbeRenderer.cpp:8-10)")
    parser.add_argument("--device", default="cuda",
                        help="render device: cuda (default), cuda:N or cpu")
    parser.add_argument("--instancing", action="store_true",
                        help="two-level acceleration structure (per-"
                             "primitive BLAS + instance TLAS)")
    parser.add_argument("--hdr", action="store_true",
                        help="skip tone mapping (linear output)")
    parser.add_argument("--env-color", default=None,
                        help="constant environment radiance 'R,G,B' (linear)"
                             ", in place of a missing panorama")
    parser.add_argument("--validate", action="store_true",
                        help="check the prepared scene's and tables' "
                             "structural invariants (core.validate)")
    parser.add_argument("--bvh-width", type=int, choices=[8, 16], default=8,
                        help="children per supernode row of the flat "
                             "tables (the reference's STEELJAX_BVH_WIDTH)")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="capture a torch.profiler trace of the render "
                             "into DIR (a Chrome trace: open it in "
                             "Perfetto; the easy_profiler analog)")
    parser.add_argument("--checkpoint", metavar="FILE.npz", default=None,
                        help="pt mode: resume accumulation from FILE if it "
                             "exists and save it at the end, so that long "
                             "converging renders survive restarts")
    parser.add_argument("--lv-checkpoint", metavar="FILE.npz", default=None,
                        help="gi mode: load the light-volume bake from "
                             "FILE if it exists, else bake and save it")
    parser.add_argument("--overlay", action="store_true",
                        help="burn the frame-time/FPS text into the output "
                             "(the UIRenderer imgui overlay, "
                             "UIRenderer.cpp:108-112)")
    parser.add_argument("--debug-view", default=None,
                        choices=["normals", "albedo", "roughness",
                                 "metallic", "occlusion", "emission",
                                 "depth", "direct", "indirect",
                                 "diffuse", "specular"],
                        help="isolate one G-buffer channel or lighting "
                             "term (Common/PBR.glsl:78-90 / Debug.glsl "
                             "composition switches); diffuse/specular "
                             "(ComposeBRDF isolation) work in BOTH modes, "
                             "the rest are hybrid-only")
    parser.add_argument("--override-material", default=None,
                        metavar="ROUGH,METAL",
                        help="force roughness,metallic after material "
                             "unpack in every shading path "
                             "(DEBUG_OVERRIDE_MATERIAL, Debug.glsl:16-18)")
    parser.add_argument("--force-forward", action="store_true",
                        help="route every material through the forward "
                             "path (Config::kForceForward, Config.hpp:41)")
    parser.add_argument("--sample-count", type=int, default=1,
                        help="sub-samples per accumulated frame (the "
                             "SAMPLE_COUNT shader define, RayGen.rgen)")
    args = parser.parse_args(argv)

    try:
        width, height = (int(v) for v in args.size.split("x"))
    except ValueError:
        parser.error(f"--size must be WIDTHxHEIGHT, got {args.size!r}")
    if args.scene != "builtin:cornell" and not Path(args.scene).exists():
        parser.error(f"scene not found: {args.scene}")
    if (args.debug_view and args.mode != "hybrid"
            and args.debug_view not in ("diffuse", "specular")):
        parser.error(f"--debug-view {args.debug_view} requires --mode "
                     "hybrid (only diffuse/specular apply to pt)")
    override = None
    if args.override_material:
        try:
            override = tuple(
                float(v) for v in args.override_material.split(","))
            if len(override) != 2:
                raise ValueError(override)
        except ValueError:
            parser.error("--override-material must be ROUGH,METAL, got "
                         f"{args.override_material!r}")
    from steeljax_torch.render.scene_renderer import render_device

    device = render_device(args.device)

    from steeljax_torch.accel.instances import InstancedAccel
    from steeljax_torch.core import profiling
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.engine.overlay import burn_overlay
    from steeljax_torch.io import checkpoint
    from steeljax_torch.io.image import write_png
    from steeljax_torch.render.pt.renderer import (PathTracingRenderer,
                                                   prepare_scene)
    from steeljax_torch.scene import load_scene
    from steeljax_torch.scene.builtin import make_cornell_scene

    if args.scene == "builtin:cornell":
        scene = make_cornell_scene()
    else:
        scene = load_scene(args.scene)
    if args.env_color:
        try:
            scene.environment_color = tuple(
                float(v) for v in args.env_color.split(","))
        except ValueError:
            parser.error(f"--env-color must be R,G,B, got {args.env_color!r}")
    config = RenderConfig(width=width, height=height,
                          render_to_hdr=args.hdr,
                          sample_count=args.sample_count,
                          force_forward=args.force_forward,
                          debug_view=args.debug_view,
                          override_material=override)
    profile = (profiling.trace(args.profile) if args.profile
               else contextlib.nullcontext())

    def overlay(image, frame_seconds: float):
        """The frame-time line burned into the image, as Engine's
        default binding words it."""
        return burn_overlay(image, [
            f"Frame time: {frame_seconds * 1e3:.2f} ms "
            f"({1.0 / max(frame_seconds, 1e-9):.1f} FPS)"])

    t0 = time.perf_counter()
    prepared = prepare_scene(
        scene, device,
        accel=InstancedAccel(device=device) if args.instancing else None,
        snode_width=args.bvh_width, validate=args.validate)
    if args.mode == "hybrid":
        from steeljax_torch.render.hybrid.renderer import HybridRenderer

        renderer = HybridRenderer(scene, width, height, config,
                                  prepared=prepared, device=device)
        if args.gi or args.show_probes:
            t1 = time.perf_counter()
            if args.lv_checkpoint and Path(args.lv_checkpoint).exists():
                renderer.light_volume = checkpoint.load_light_volume(
                    args.lv_checkpoint, device)
                print(f"loaded the light volume from {args.lv_checkpoint}")
            else:
                bake_kwargs = {"spp": args.gi_spp}
                if args.gi_min_edge is not None:
                    bake_kwargs["min_edge"] = args.gi_min_edge
                if args.gi_resolution is not None:
                    bake_kwargs["resolution"] = args.gi_resolution
                renderer.bake_light_volume(**bake_kwargs)
                if args.lv_checkpoint:
                    checkpoint.save_light_volume(args.lv_checkpoint,
                                                 renderer.light_volume)
            print(f"light volume: {renderer.light_volume.positions.shape[0]}"
                  f" probes, {renderer.light_volume.tet_vertices.shape[0]} "
                  f"tets in {time.perf_counter() - t1:.2f} s")
        t1 = time.perf_counter()
        with profile:
            image = renderer.render_frame()  # host numpy: synchronized
        print(f"hybrid: preparation and environment bake {t1 - t0:.2f} s, "
              f"frame {(time.perf_counter() - t1) * 1000.0:.2f} ms on "
              f"{device}")
        warm_s = None
        if args.overlay:
            # A warm second frame's time (the first pays the warm-up).
            t1 = time.perf_counter()
            renderer.render_frame()
            warm_s = time.perf_counter() - t1
        if args.show_probes:
            from steeljax_torch.gi.debug import overlay_probes
            image = overlay_probes(image, renderer.light_volume,
                                   renderer.frame.view_proj)
        if warm_s is not None:
            image = overlay(image, warm_s)
        write_png(args.output, image)
        print(f"wrote {args.output} ({width}x{height}, hybrid)")
        return 0

    renderer = PathTracingRenderer(scene, width, height, config,
                                   prepared=prepared, device=device)
    print(f"preparation {time.perf_counter() - t0:.2f} s")
    if args.checkpoint and Path(args.checkpoint).exists():
        state = checkpoint.load_accumulation(args.checkpoint, device)
        if tuple(state.accumulated.shape) != (height, width, 3):
            # Another resolution: the accumulation restarts, as the
            # reference's resize resets it.
            print(f"checkpoint {args.checkpoint} is "
                  f"{state.accumulated.shape[1]}x"
                  f"{state.accumulated.shape[0]}, render is "
                  f"{width}x{height}; starting fresh")
        else:
            renderer.state = state
            print(f"resumed accumulation at index {state.index} from "
                  f"{args.checkpoint}")
    image = None
    dt = 0.0
    with profile:
        for i in range(args.spp):
            t0 = time.perf_counter()
            image = renderer.render_frame()  # host numpy: synchronized
            dt = max(time.perf_counter() - t0, 1e-9)
            print(f"frame {i + 1}/{args.spp}: {dt * 1000.0:.2f} ms "
                  f"({width * height / dt / 1e6:.1f} Mpixel/s) on {device}")
    if args.checkpoint:
        checkpoint.save_accumulation(args.checkpoint, renderer.state)
        print(f"saved accumulation index {renderer.state.index} to "
              f"{args.checkpoint}")
    if args.overlay:
        # The last frame's time: the first pays the warm-up.
        image = overlay(image, dt)
    write_png(args.output, image)
    print(f"wrote {args.output} ({width}x{height}, {args.spp} spp)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
