"""G-buffer generation: primary visibility and the material fetch.

Port of steeljax/render/hybrid/gbuffer.py:36-289.  The reference's engine
rasterizes opaque geometry into five targets (GBufferStage.hpp:14-20:
packed normals, emission, base colour and occlusion, roughness and
metallic, reverse depth); here primary visibility is a nearest trace at the
pixel centres (the visibility the rasterizer computes, backface culling
included), and the unorm targets are quantized to the engine's bit depths.
Alpha-blend surfaces are skipped (they belong to the forward stage), and
alpha-test texels below the cutoff are discarded by a bounded re-trace.

The reference skips a re-trace pass in which no ray was rejected
(`lax.cond`); here every pass is launched, with the dead interval for the
rays that need none, so the stage never reads a device value on the host.
The output is the same.  Opaque scenes return after the first trace, as
the reference does.  With `raster=` (the reference's opt-in raster
G-buffer, HybridRenderer under STEELJAX_RASTER=1) primary visibility comes
from render/hybrid/raster.py instead of the trace, and only alpha-tested
scenes re-trace after it.

`generate_gbuffer` has the reference's two branches: tables with fused
shading (the trace kernel's interpolated normal, material id and, in shade
mode 2, tangent, uv and uv density) and tables without, which read the
hits' tri_shade rows.  They differ on purpose in two places: the fused
branch's normal is flipped by winding (the kernel's), the row branch's
toward the viewer; and the fused branch takes the LOD's incidence term from
the shading normal, the row branch from the geometric one.
"""

from __future__ import annotations

import torch

from steeljax_torch.accel.dispatch import TraceTables, trace_nearest
from steeljax_torch.core import profiling
from steeljax_torch.core.constants import RAY_DEAD_T
from steeljax_torch.render.hybrid.raster import raster_rec
from steeljax_torch.render.surface import (alpha_rejected, interpolate,
                                           material_flag, material_select,
                                           normalize, select_rec, shade_rows,
                                           textured_surface)
from steeljax_torch.render.texture import sample_trilinear
from steeljax_torch.scene.flatten import FlatScene, MatPacked, TriShade
from steeljax_torch.scene.material import MaterialFlags


def _quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Round to the nearest of 2^bits - 1 levels in [0, 1], half to even."""
    levels = float((1 << bits) - 1)
    return torch.round(torch.clamp(x, 0.0, 1.0) * levels) / levels


def _opaque_rejected(scene: FlatScene, tables, rec) -> torch.Tensor:
    """hit & (alpha blend | alpha-test discard): surfaces the G-buffer does
    not show (they belong to the forward stage)."""
    row = shade_rows(scene, tables, rec)
    return ((rec["hit"] & material_flag(row, MaterialFlags.ALPHA_BLEND))
            | alpha_rejected(scene, rec, row))


def trace_opaque(scene: FlatScene, tables: TraceTables, o, d, t_min, t_max,
                 max_retrace: int) -> dict:
    """Nearest opaque hit: past alpha-blend surfaces and alpha-test texels
    below the cutoff.  A scene with neither returns the first trace."""
    rec = trace_nearest(tables, o, d, t_min, t_max, cull_backface=True)
    if not (scene.any_alpha_blend or scene.any_alpha_test):
        return rec
    return _alpha_retrace(scene, tables, o, d, rec, t_max, max_retrace)


def raster_or_trace_opaque(scene: FlatScene, tables: TraceTables, o, d,
                           t_min, t_max, max_retrace: int, raster,
                           view_proj) -> dict:
    """Rasterized primary visibility (render/hybrid/raster.py, the
    reference's raster G-buffer pipeline, GBufferStage.cpp:147-157).

    `raster` is (RasterScene, width, height, tile).  The raster gives the
    traced path's nearest-opaque record; alpha-blend triangles are left out
    of its input, and alpha-test discards resolve through the same bounded
    re-trace as the traced path."""
    rscene, width, height, tile = raster
    rec = raster_rec(rscene, view_proj, width, height, tile, d, t_min)
    if not scene.any_alpha_test:
        return rec
    return _alpha_retrace(scene, tables, o, d, rec, t_max, max_retrace)


def _alpha_retrace(scene: FlatScene, tables: TraceTables, o, d, rec,
                   t_max, max_retrace: int) -> dict:
    """`max_retrace` re-trace passes past the rejected hits of an initial
    nearest-hit record; a hit still rejected after them is a miss.  Every
    pass is launched, the rays not rejected with the dead interval."""
    tmax = profiling.upload(t_max, "gbuffer.upload_tmax",
                            dtype=torch.float32,
                            device=o.device).expand(o.shape[0])
    for _ in range(max_retrace):
        rejected = _opaque_rejected(scene, tables, rec)
        again = trace_nearest(tables, o, d, rec["t"] + 1e-4,
                              torch.where(rejected, tmax, RAY_DEAD_T),
                              cull_backface=True)
        rec = select_rec(rejected, again, rec)
    final_reject = _opaque_rejected(scene, tables, rec)
    rec["hit"] = rec["hit"] & ~final_reject
    rec["tri"] = torch.where(rec["hit"], rec["tri"], -1)
    rec["t"] = torch.where(rec["hit"], rec["t"], -1.0)
    return rec


def generate_gbuffer(scene: FlatScene, tables: TraceTables, o, d,
                     t_min, t_max, view_proj, camera_position,
                     max_retrace: int = 4, pixel_spread: float = 0.0,
                     raster=None) -> dict:
    """The G-buffer of a ray batch: normal (N, 3) in [0, 1] at 10 bits,
    emission (N, 3) linear, base_color_occlusion (N, 4) at 8 bits,
    rough_metal (N, 2) at 8 bits, depth (N,) reverse-z NDC (0 = miss), hit
    (N,).  view_proj and camera_position are tensors on the rays'
    device.  `raster` = (RasterScene, width, height, tile) takes primary
    visibility from the rasterizer (the rays then are the full frame's in
    tiled_order of `tile`); None keeps the traced path."""
    if raster is not None:
        rec = raster_or_trace_opaque(scene, tables, o, d, t_min, t_max,
                                     max_retrace, raster, view_proj)
    else:
        rec = trace_opaque(scene, tables, o, d, t_min, t_max, max_retrace)
    u, v = rec["u"], rec["v"]
    hit = rec["hit"]
    p = o + d * rec["t"][..., None]

    if "n" in rec:  # the trace kernel's fused shading outputs
        rows, _, tex = material_select(scene, rec["mat"])
        layout = MatPacked
        # The kernel interpolated and normalized the normal and flipped it
        # by winding; with culling on, that flips exactly the double-sided
        # backfaces (Material.glsl:33-38 with a geometric test).
        normal = rec["n"]
        tangent = rec.get("tan", torch.zeros_like(normal))
        uv = rec.get("uv", torch.zeros_like(normal[..., :2]))
        uv_density = rec.get("uvd", torch.zeros_like(rec["t"]))
        # The LOD's incidence term from the shading normal: the kernel
        # exports no geometric normal.
        cos_inc = torch.clamp((normal * d).sum(dim=-1).abs(), min=0.3)
    else:
        rows = shade_rows(scene, tables, rec)
        layout, tex = TriShade, rows[:, TriShade.TEX_IDS]
        uv = interpolate(rows, layout.UVS, u, v)
        normal = normalize(interpolate(rows, layout.NORMALS, u, v))
        tangent = normalize(interpolate(rows, layout.TANGENTS, u, v))
        geom_n = normalize(rows[:, layout.GEOM_NORMAL])
        cos_inc = torch.clamp((geom_n * d).sum(dim=-1).abs(), min=0.3)
        uv_density = rows[:, layout.UV_DENSITY]

        # DOUBLE_SIDED: face the viewer (Material.glsl:33-38).
        view = normalize(camera_position - p)
        flip = (material_flag(rows, MaterialFlags.DOUBLE_SIDED)
                & ((normal * view).sum(dim=-1) < 0.0))
        normal = torch.where(flip[..., None], -normal, normal)

    # Mip lod from the ray footprint (the raster pipeline's derivatives):
    # world footprint ~ t * pixel spread / cos(incidence), in texels
    # through the triangle's uv density.
    footprint_uv = (rec["t"] * pixel_spread / cos_inc) * uv_density
    base_lod = torch.log2(torch.clamp(footprint_uv, min=1e-20))

    def sample(idx):
        width = torch.clamp(scene.tex_size[idx.long().clamp(min=0), 0],
                            min=1)
        lod = base_lod + torch.log2(width.to(torch.float32))
        return sample_trilinear(scene.atlas, scene.tex_offset,
                                scene.tex_size, idx, uv, lod)

    s = textured_surface(rows, layout, tex,
                         sample if scene.has_textures else None,
                         ("base_color", "emission", "roughness", "metallic",
                          "occlusion"), normal, tangent)
    if scene.has_textures:
        normal = torch.where(s["has_normal_map"][..., None], s["normal"],
                             normal)

    # Reverse-z NDC depth from the (already reverse-depth) projection.
    clip = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1) @ view_proj.T
    w = clip[..., 3]
    depth = clip[..., 2] / torch.where(w.abs() < 1e-20, 1e-20, w)

    col = hit[..., None]
    return {
        "normal": torch.where(col, _quantize(normal * 0.5 + 0.5, 10), 0.0),
        "emission": torch.where(col, s["emission"], 0.0),
        "base_color_occlusion": torch.where(col, _quantize(torch.cat(
            [s["base_color"], s["occlusion"][..., None]], dim=-1), 8), 0.0),
        "rough_metal": torch.where(col, _quantize(torch.stack(
            [s["roughness"], s["metallic"]], dim=-1), 8), 0.0),
        "depth": torch.where(hit, depth, 0.0),  # clear = 0 under reverse z
        "hit": hit,
    }
