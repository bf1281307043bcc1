"""Forward stage: the environment background and the alpha-blend surfaces.

Port of steeljax/render/hybrid/forward.py:41-239 (ForwardStage.cpp): the
environment draws wherever the opaque depth still holds the clear value,
then the alpha-blend surfaces composite with standard alpha blending,
depth-tested against the opaque depth.  The engine draws blend geometry
unsorted; the reference peels up to `max_blend_layers` blend surfaces per
pixel and composites them far to near, on tone-mapped values (the engine
blends in swapchain space).

`all_materials=True` is kForceForward (Config.hpp:41): the G-buffer shows
nothing and the forward stage draws every material, non-blend ones
opaquely, alpha-test ones discarding below the cutoff.

The reference skips a re-trace pass with no rejected ray and a peel layer
once no ray has a surface left (`lax.cond`); here every pass and layer is
launched, the finished rays with the dead interval, so the stage never
reads a device value on the host.  The output is the same.  Scenes with no
blend material return the background composite, as the reference does.
"""

from __future__ import annotations

import torch

from steeljax_torch.accel.dispatch import TraceTables, trace_nearest
from steeljax_torch.core import profiling
from steeljax_torch.core.colors import to_linear, tone_map
from steeljax_torch.core.constants import RAY_DEAD_T
from steeljax_torch.env.cubemap import sample_cube_quads
from steeljax_torch.env.environment import Environment
from steeljax_torch.env.sky import sky_radiance
from steeljax_torch.render.hybrid.gbuffer import _interp_cols, select_rec
from steeljax_torch.render.hybrid.lighting import (compute_direct_lighting,
                                                   compute_indirect_lighting)
from steeljax_torch.render.pt import brdf as brdf_lib
from steeljax_torch.render.pt.integrator import (_alpha_rejected, _normalize,
                                                 _retrace_tmin, shade_rows)
from steeljax_torch.render.texture import sample_bilinear
from steeljax_torch.scene.flatten import FlatScene
from steeljax_torch.scene.material import MaterialFlags


def _forward_rejected(scene: FlatScene, tables, rec,
                      all_materials: bool) -> torch.Tensor:
    """Hits the forward stage skips: non-blend surfaces (they are in the
    G-buffer), or under kForceForward alpha-test texels below the cutoff."""
    row = shade_rows(scene, tables, rec)
    if all_materials:
        return _alpha_rejected(scene, rec, row)
    blend = (row[:, 40].to(torch.int32)
             & int(MaterialFlags.ALPHA_BLEND)) != 0
    return rec["hit"] & ~blend


def trace_blend(scene: FlatScene, tables: TraceTables, o, d, t_min, t_max,
                max_retrace: int = 4, all_materials: bool = False) -> dict:
    """Nearest forward-stage hit within [t_min, t_max]: the nearest
    alpha-blend surface, past non-blend ones, or with `all_materials` the
    nearest surface of any material that is not discarded."""
    tmax = profiling.upload(t_max, "forward_stage.upload_tmax",
                            dtype=torch.float32,
                            device=o.device).expand(o.shape[0])
    rec = trace_nearest(tables, o, d, t_min, t_max, cull_backface=True)
    for _ in range(max_retrace):
        rejected = _forward_rejected(scene, tables, rec, all_materials)
        again = trace_nearest(tables, o, d, _retrace_tmin(rec["t"]),
                              torch.where(rejected, tmax, RAY_DEAD_T),
                              cull_backface=True)
        rec = select_rec(rejected, again, rec)
    ok = rec["hit"] & ~_forward_rejected(scene, tables, rec, all_materials)
    rec["hit"] = ok
    rec["tri"] = torch.where(ok, rec["tri"], -1)
    return rec


def shade_forward(scene: FlatScene, tables: TraceTables, env: Environment,
                  rec, o, d, camera_position,
                  ray_tracing_enabled: bool = True,
                  all_materials: bool = False,
                  override_material: tuple | None = None):
    """Forward PBR at a blend hit (Forward.frag:25-66): (linear colour
    (N, 3), alpha (N,)).  With `all_materials` non-blend materials return
    alpha 1 (their pipelines do not blend)."""
    u, v_bar = rec["u"], rec["v"]
    shade = shade_rows(scene, tables, rec)
    p = o + d * rec["t"][..., None]
    uv = _interp_cols(shade, 18, u, v_bar, width=2)
    normal = _normalize(_interp_cols(shade, 0, u, v_bar))
    tangent = _normalize(_interp_cols(shade, 9, u, v_bar))
    view = _normalize(camera_position - p)

    flags = shade[:, 40].to(torch.int32)
    ds_mat = (flags & int(MaterialFlags.DOUBLE_SIDED)) != 0
    flip = ds_mat & ((normal * view).sum(dim=-1) < 0.0)
    normal = torch.where(flip[..., None], -normal, normal)

    def tex(col):
        idx = shade[:, col].to(torch.int32)
        if not scene.has_textures:
            return torch.ones(idx.shape + (4,), device=idx.device), idx >= 0
        return sample_bilinear(scene.atlas, scene.tex_offset,
                               scene.tex_size, idx, uv), idx >= 0

    if scene.has_textures:
        nm, has_nm = tex(43)
        ns = nm[..., :3] * 2.0 - 1.0
        scale = shade[:, 39]
        ns = _normalize(ns * torch.stack(
            [scale, scale, torch.ones_like(scale)], dim=-1))
        tbn = brdf_lib.make_tbn_with_tangent(normal, tangent)
        mapped = _normalize(brdf_lib.tangent_to_world(ns, tbn))
        normal = torch.where(has_nm[..., None], mapped, normal)

    base_s, has_base = tex(41)
    base_raw = shade[:, 46:49] * torch.where(has_base[..., None],
                                             base_s[..., :3], 1.0)
    alpha = shade[:, 35] * torch.where(has_base, base_s[..., 3], 1.0)
    base_color = to_linear(base_raw)

    rm_s, has_rm = tex(42)
    roughness = shade[:, 36] * torch.where(has_rm, rm_s[..., 1], 1.0)
    metallic = shade[:, 37] * torch.where(has_rm, rm_s[..., 2], 1.0)
    if override_material is not None:
        # DEBUG_OVERRIDE_MATERIAL (Forward.frag:46-49).
        roughness = torch.full_like(roughness, override_material[0])
        metallic = torch.full_like(metallic, override_material[1])

    occ_s, has_occ = tex(44)
    occlusion = shade[:, 52] * torch.where(has_occ, occ_s[..., 0], 1.0)
    em_s, has_em = tex(45)
    emission = to_linear(shade[:, 49:52] * torch.where(
        has_em[..., None], em_s[..., :3], 1.0))

    f0 = 0.04 + (base_color - 0.04) * metallic[..., None]
    nov = torch.clamp((normal * view).sum(dim=-1), min=0.0)
    if scene.light_count > 0:
        direct = compute_direct_lighting(
            scene, tables, p, normal, view, nov, base_color, f0, roughness,
            metallic, shadows=ray_tracing_enabled)
    else:
        direct = torch.zeros_like(base_color)
    indirect = compute_indirect_lighting(
        env, p, normal, view, nov, base_color, f0, roughness, metallic,
        occlusion)
    if all_materials:
        blend = (flags & int(MaterialFlags.ALPHA_BLEND)) != 0
        alpha = torch.where(blend, alpha, 1.0)
    return direct + indirect + emission, alpha


def forward_stage(scene: FlatScene, tables: TraceTables, env: Environment,
                  lit_linear, gbuffer, o, d, opaque_t, t_min,
                  camera_position, ray_tracing_enabled: bool = True,
                  max_blend_layers: int = 4, all_materials: bool = False,
                  override_material: tuple | None = None) -> torch.Tensor:
    """The display image (N, 3): tone-mapped opaque lighting, the
    environment behind it, then up to `max_blend_layers` forward layers
    composited far to near."""
    hit = gbuffer["hit"]
    with profiling.named_scope("forward_stage.background"):
        if env.analytic:
            # The procedural sky in closed form: no face discretization.
            env_color = tone_map(sky_radiance(d))
        else:
            env_color = tone_map(sample_cube_quads(env.cube_quads, d))
        display = torch.where(hit[..., None], tone_map(lit_linear),
                              env_color)
    if not (scene.any_alpha_blend or all_materials):
        return display

    blend_tmax = torch.where(hit, opaque_t, 1000.0)
    tmin = profiling.upload(t_min, "forward_stage.upload_tmin",
                            dtype=torch.float32,
                            device=o.device).expand(o.shape[0])
    layers = []
    for _ in range(max_blend_layers):
        with profiling.named_scope("forward_stage.peel"):
            rec = trace_blend(scene, tables, o, d, tmin, blend_tmax,
                              all_materials=all_materials)
            color, alpha = shade_forward(
                scene, tables, env, rec, o, d, camera_position,
                ray_tracing_enabled, all_materials=all_materials,
                override_material=override_material)
            layers.append((rec["hit"], tone_map(color),
                           torch.clamp(alpha, 0.0, 1.0)))
            # Finished rays get an empty interval, so later peels reject
            # them before the walk.
            tmin = torch.where(rec["hit"], _retrace_tmin(rec["t"]),
                               blend_tmax + 1.0)

    # Far to near over the opaque and background image: the blend state of
    # ForwardStage.cpp:94-104 (srcAlpha, oneMinusSrcAlpha).
    with profiling.named_scope("forward_stage.composite"):
        for hit_i, src_i, a_i in reversed(layers):
            a = a_i[..., None]
            display = torch.where(hit_i[..., None], src_i * a
                                  + display * (1.0 - a), display)
    return display
