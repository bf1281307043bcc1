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
from steeljax_torch.render.pt import brdf as brdf_lib
from steeljax_torch.render.pt.integrator import (_alpha_rejected, _normalize,
                                                 material_select, shade_rows)
from steeljax_torch.render.texture import sample_trilinear
from steeljax_torch.scene.flatten import FlatScene
from steeljax_torch.scene.material import MaterialFlags


def _quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Round to the nearest of 2^bits - 1 levels in [0, 1], half to even."""
    levels = float((1 << bits) - 1)
    return torch.round(torch.clamp(x, 0.0, 1.0) * levels) / levels


def _interp_cols(row, base: int, u, v, width: int = 3):
    """Barycentric interpolation of a per-vertex attribute stored as three
    consecutive `width`-column blocks of a tri_shade row."""
    w = (1.0 - u - v)[..., None]
    return (row[:, base:base + width] * w
            + row[:, base + width:base + 2 * width] * u[..., None]
            + row[:, base + 2 * width:base + 3 * width] * v[..., None])


def _opaque_rejected(scene: FlatScene, tables, rec) -> torch.Tensor:
    """hit & (alpha blend | alpha-test discard): surfaces the G-buffer does
    not show (they belong to the forward stage)."""
    row = shade_rows(scene, tables, rec)
    blend = (row[:, 40].to(torch.int32)
             & int(MaterialFlags.ALPHA_BLEND)) != 0
    return (rec["hit"] & blend) | _alpha_rejected(scene, rec, row)


def select_rec(mask: torch.Tensor, new: dict, old: dict) -> dict:
    """Field by field, `new` where `mask` holds and `old` elsewhere; (N,)
    and (N, k) fields alike."""
    return {k: torch.where(mask.reshape((-1,) + (1,) * (old[k].dim() - 1)),
                           new[k], old[k]) for k in old}


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
        mrow, _, tex_ids = material_select(scene, rec["mat"])
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
        base_factor = mrow[:, 0:3]
        em_factor = mrow[:, 4:7]
        rough_factor = mrow[:, 7]
        metal_factor = mrow[:, 8]
        normal_scale = mrow[:, 9]
        occl_strength = mrow[:, 10]

        def slot_idx(slot):
            return tex_ids[:, slot]
    else:
        shade = shade_rows(scene, tables, rec)        # (N, 56)
        uv = _interp_cols(shade, 18, u, v, width=2)
        normal = _normalize(_interp_cols(shade, 0, u, v))
        tangent = _normalize(_interp_cols(shade, 9, u, v))
        geom_n = _normalize(shade[:, 24:27])
        cos_inc = torch.clamp((geom_n * d).sum(dim=-1).abs(), min=0.3)
        uv_density = shade[:, 27]
        flags = shade[:, 40].to(torch.int32)
        base_factor = shade[:, 46:49]
        em_factor = shade[:, 49:52]
        rough_factor = shade[:, 36]
        metal_factor = shade[:, 37]
        normal_scale = shade[:, 39]
        occl_strength = shade[:, 52]

        def slot_idx(slot):
            return shade[:, 41 + slot].to(torch.int32)

        # DOUBLE_SIDED: face the viewer (Material.glsl:33-38).
        view = _normalize(camera_position - p)
        ds_mat = (flags & int(MaterialFlags.DOUBLE_SIDED)) != 0
        flip = ds_mat & ((normal * view).sum(dim=-1) < 0.0)
        normal = torch.where(flip[..., None], -normal, normal)

    # Mip lod from the ray footprint (the raster pipeline's derivatives):
    # world footprint ~ t * pixel spread / cos(incidence), in texels
    # through the triangle's uv density.
    footprint_uv = (rec["t"] * pixel_spread / cos_inc) * uv_density
    base_lod = torch.log2(torch.clamp(footprint_uv, min=1e-20))

    def lod_of(idx):
        width = torch.clamp(scene.tex_size[idx.long().clamp(min=0), 0],
                            min=1)
        return base_lod + torch.log2(width.to(torch.float32))

    # NORMAL_MAPPING (Material.glsl:40-47), for textured scenes only.
    if scene.has_textures:
        n_idx = slot_idx(2)
        ns = sample_trilinear(scene.atlas, scene.tex_offset, scene.tex_size,
                              n_idx, uv, lod_of(n_idx))[..., :3] * 2.0 - 1.0
        scale = normal_scale
        ns = _normalize(ns * torch.stack(
            [scale, scale, torch.ones_like(scale)], dim=-1))
        tbn = brdf_lib.make_tbn_with_tangent(normal, tangent)
        mapped = _normalize(brdf_lib.tangent_to_world(ns, tbn))
        normal = torch.where((n_idx >= 0)[..., None], mapped, normal)

    def tex_sample(slot):
        idx = slot_idx(slot)
        if not scene.has_textures:
            return torch.ones(idx.shape + (4,), device=idx.device), idx >= 0
        s = sample_trilinear(scene.atlas, scene.tex_offset, scene.tex_size,
                             idx, uv, lod_of(idx))
        return s, idx >= 0

    base_tex, has_base = tex_sample(0)
    base_color = base_factor * torch.where(has_base[..., None],
                                           base_tex[..., :3], 1.0)
    em_tex, has_em = tex_sample(4)
    emission = em_factor * torch.where(has_em[..., None], em_tex[..., :3],
                                       1.0)
    rm_tex, has_rm = tex_sample(1)
    roughness = rough_factor * torch.where(has_rm, rm_tex[..., 1], 1.0)
    metallic = metal_factor * torch.where(has_rm, rm_tex[..., 2], 1.0)
    occ_tex, has_occ = tex_sample(3)
    occlusion = occl_strength * torch.where(has_occ, occ_tex[..., 0], 1.0)

    # Reverse-z NDC depth from the (already reverse-depth) projection.
    clip = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1) @ view_proj.T
    w = clip[..., 3]
    depth = clip[..., 2] / torch.where(w.abs() < 1e-20, 1e-20, w)

    col = hit[..., None]
    return {
        "normal": torch.where(col, _quantize(normal * 0.5 + 0.5, 10), 0.0),
        "emission": torch.where(col, emission, 0.0),
        "base_color_occlusion": torch.where(col, _quantize(torch.cat(
            [base_color, occlusion[..., None]], dim=-1), 8), 0.0),
        "rough_metal": torch.where(col, _quantize(torch.stack(
            [roughness, metallic], dim=-1), 8), 0.0),
        "depth": torch.where(hit, depth, 0.0),  # clear = 0 under reverse z
        "hit": hit,
    }
