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
from steeljax_torch.render.hybrid.lighting import (compute_direct_lighting,
                                                   compute_indirect_lighting)
from steeljax_torch.render.surface import (alpha_rejected, bilinear,
                                           interpolate, material_flag,
                                           normalize, retrace_tmin,
                                           select_rec, shade_rows,
                                           textured_surface)
from steeljax_torch.scene.flatten import FlatScene, TriShade
from steeljax_torch.scene.material import MaterialFlags


def _forward_rejected(scene: FlatScene, tables, rec,
                      all_materials: bool) -> torch.Tensor:
    """Hits the forward stage skips: non-blend surfaces (they are in the
    G-buffer), or under kForceForward alpha-test texels below the cutoff."""
    row = shade_rows(scene, tables, rec)
    if all_materials:
        return alpha_rejected(scene, rec, row)
    return rec["hit"] & ~material_flag(row, MaterialFlags.ALPHA_BLEND)


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
        again = trace_nearest(tables, o, d, retrace_tmin(rec["t"]),
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
    row = shade_rows(scene, tables, rec)
    p = o + d * rec["t"][..., None]
    uv = interpolate(row, TriShade.UVS, u, v_bar)
    normal = normalize(interpolate(row, TriShade.NORMALS, u, v_bar))
    tangent = normalize(interpolate(row, TriShade.TANGENTS, u, v_bar))
    view = normalize(camera_position - p)

    flip = (material_flag(row, MaterialFlags.DOUBLE_SIDED)
            & ((normal * view).sum(dim=-1) < 0.0))
    normal = torch.where(flip[..., None], -normal, normal)

    s = textured_surface(row, TriShade, row[:, TriShade.TEX_IDS],
                         bilinear(scene, uv),
                         ("base_color", "alpha", "roughness", "metallic",
                          "occlusion", "emission"), normal, tangent)
    if scene.has_textures:
        normal = torch.where(s["has_normal_map"][..., None], s["normal"],
                             normal)
    base_color = to_linear(s["base_color"])
    alpha, roughness, metallic = s["alpha"], s["roughness"], s["metallic"]
    if override_material is not None:
        # DEBUG_OVERRIDE_MATERIAL (Forward.frag:46-49).
        roughness = torch.full_like(roughness, override_material[0])
        metallic = torch.full_like(metallic, override_material[1])
    emission = to_linear(s["emission"])

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
        s["occlusion"])
    if all_materials:
        alpha = torch.where(material_flag(row, MaterialFlags.ALPHA_BLEND),
                            alpha, 1.0)
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
            tmin = torch.where(rec["hit"], retrace_tmin(rec["t"]),
                               blend_tmax + 1.0)

    # Far to near over the opaque and background image: the blend state of
    # ForwardStage.cpp:94-104 (srcAlpha, oneMinusSrcAlpha).
    with profiling.named_scope("forward_stage.composite"):
        for hit_i, src_i, a_i in reversed(layers):
            a = a_i[..., None]
            display = torch.where(hit_i[..., None], src_i * a
                                  + display * (1.0 - a), display)
    return display
