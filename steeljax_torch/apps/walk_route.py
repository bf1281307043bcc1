"""Time one path-traced tile through the port's CPU route and through the
BVH walk in its place.

The port's CPU route traces with the kernels' plain versions, brute force
over the packed records (rays x records a trace).  The reference's CPU
backend walks the binary tree instead (accel.traverse: about rays x
log(triangles)).  This app renders the same tile of path L
(kernel_parity's "sunlit" scene) both ways: as the renderer does
("plain"), and with the integrator's trace_nearest / trace_any replaced
by dispatch.trace_nearest_walk / trace_any_walk ("walk"; the walk's record
has no fused outputs, so that way runs under STEELJAX_SHADE_MODE=0 and
the integrator gathers the tri_shade rows).  It prints one JSON line: the
host seconds of each way, rays_traced, and the pixels of the walk's tile
beyond 1e-4 of the plain one.  That is the number that decides whether
the CPU route should move to the walk (ROADMAP.md, Queue 1).

Usage:
    python -m steeljax_torch.apps.walk_route [--size 64x36] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

PIXEL_ATOL = 1e-4


def _tile(flat, tables, scene, width: int, height: int):
    """One sample of a width x height tile (accumulation index 0): the
    (H W, 3) radiance and rays_traced."""
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.render.pt import integrator

    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    result, stats = integrator.render_pixels(
        flat, tables, frame.inverse_view, frame.inverse_proj,
        frame.camera_near, frame.camera_far, width, height, xs.reshape(-1),
        ys.reshape(-1), 0, 0, RenderConfig(width=width, height=height),
        return_stats=True)
    return result.cpu().numpy(), int(stats["rays_traced"])


def _walked(flat):
    """The integrator's two trace entry points through the walk."""
    from steeljax_torch.accel import dispatch

    def nearest(tables, o, d, t_min, t_max, cull_backface=True):
        return dispatch.trace_nearest_walk(
            tables, flat.tri_pos, flat.tri_double_sided, o, d, t_min, t_max,
            cull_backface)

    def any_hit(tables, o, d, t_min, t_max):
        return dispatch.trace_any_walk(tables, flat.tri_pos,
                                       flat.tri_double_sided, o, d, t_min,
                                       t_max)

    return nearest, any_hit


def run(width: int, height: int, device: str) -> dict:
    """Both ways on one tile; returns the JSON line's fields."""
    from steeljax_torch.apps import kernel_parity as kp
    from steeljax_torch.render.pt import frame_graphs, integrator
    from steeljax_torch.render.pt.renderer import prepare_scene

    scene = kp.make_path_scene("sunlit")
    flat, tables = prepare_scene(scene, device, env_resolution=16)
    out = {"scene": "path L", "size": f"{width}x{height}",
           "device": device, "threads": torch.get_num_threads(),
           "triangles": flat.source_tri_count}
    start = time.perf_counter()
    plain, out["plain_rays_traced"] = _tile(flat, tables, scene, width,
                                            height)
    out["plain_s"] = time.perf_counter() - start

    saved = (integrator.trace_nearest, integrator.trace_any,
             os.environ.get("STEELJAX_SHADE_MODE"), integrator.FRAME_GRAPHS)
    integrator.trace_nearest, integrator.trace_any = _walked(flat)
    os.environ["STEELJAX_SHADE_MODE"] = "0"
    # The walk's tile as the host runs it, whatever graphs were captured.
    integrator.FRAME_GRAPHS = frame_graphs.FrameGraphs(frame_graphs.Eager())
    try:
        start = time.perf_counter()
        walk, out["walk_rays_traced"] = _tile(flat, tables, scene, width,
                                              height)
        out["walk_s"] = time.perf_counter() - start
    finally:
        integrator.trace_nearest, integrator.trace_any = saved[:2]
        integrator.FRAME_GRAPHS = saved[3]
        if saved[2] is None:
            os.environ.pop("STEELJAX_SHADE_MODE", None)
        else:
            os.environ["STEELJAX_SHADE_MODE"] = saved[2]
    delta = np.abs(walk - plain).max(axis=-1)
    out["pixels_beyond"] = int((delta > PIXEL_ATOL).sum())
    out["pixels"] = int(delta.size)
    out["max_pixel_delta"] = float(delta.max())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", default="64x36")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    width, height = (int(v) for v in args.size.split("x"))
    print(json.dumps(run(width, height, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
