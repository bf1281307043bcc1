"""Deferred PBR lighting with ray-traced hard shadows.

Port of steeljax/render/hybrid/lighting.py:29-230 (Lighting.comp and
Lighting.glsl): the world position comes back from reverse depth through
inverseProjView; direct lighting loops over the punctual lights with
GGX, Schlick and the visibility term, and a pixel is lit only where its
shadow ray (integrator.trace_visibility: the any-hit kernel, or the alpha
re-trace in alpha-tested scenes) finds no occluder; indirect lighting is
the split-sum IBL, the irradiance cube's diffuse and the prefiltered
reflection times (F0 * scale + offset), scaled by occlusion.  The split-sum
scale and offset are Karis's analytic fit, as the reference takes them;
the baked LUT (env.ibl.specular_brdf_lut) is not read here.  With a light
volume (gi.light_volume) the diffuse irradiance is the volume's, sampled by
the tet walk (gi.sample), and the specular term is scaled by its ratio to
the environment's irradiance, clipped to [0, 8].
"""

from __future__ import annotations

import torch

from steeljax_torch.accel.dispatch import TraceTables
from steeljax_torch.core import profiling
from steeljax_torch.core.colors import to_linear
from steeljax_torch.core.constants import (BIAS, DIELECTRIC_F0, EPSILON,
                                           RAY_DEAD_T, RAY_MAX_T, RAY_MIN_T)
from steeljax_torch.env.cubemap import (sample_cube_quads,
                                        sample_flat_mips_tri)
from steeljax_torch.env.environment import Environment
from steeljax_torch.env.ibl import eval_cube_sh
from steeljax_torch.gi.sample import sample_light_volume
from steeljax_torch.render.pt import brdf as brdf_lib
from steeljax_torch.render.pt.integrator import trace_visibility
from steeljax_torch.render.surface import normalize
from steeljax_torch.scene.flatten import FlatScene

def restore_position(depth, uv, inverse_proj_view):
    """RestorePosition (Lighting.comp:18-26): world positions (N, 3) from
    reverse depth (N,) and screen uv (N, 2)."""
    clip = torch.cat([uv * 2.0 - 1.0, depth[..., None],
                      torch.ones_like(depth[..., None])], dim=-1)
    world = clip @ inverse_proj_view.T
    w = world[..., 3:4]
    return world[..., :3] / torch.where(w.abs() < 1e-20, 1e-20, w)


def light_terms(scene: FlatScene, i: int, position, n):
    """Light i at the pixels: (unit direction l (N, 3), distance (N,),
    attenuation (N,), nol (N,), irradiance (N,), colour (3,))."""
    loc = scene.light_location[i]
    color = scene.light_color[i, :3]
    is_point = loc[3]
    direction = loc[:3] - position * is_point
    distance = torch.where(is_point == 0.0, RAY_MAX_T,
                           torch.linalg.vector_norm(direction, dim=-1))
    attenuation = torch.where(
        is_point == 0.0, 1.0,
        1.0 / torch.clamp(distance * distance, min=1e-20))
    l = normalize(direction)
    nol = torch.clamp((n * l).sum(dim=-1), min=0.0)
    lum = 0.2126 * color[0] + 0.7152 * color[1] + 0.0722 * color[2]
    return l, distance, attenuation, nol, attenuation * nol * lum, color


def shadow_rays(position, n, l, distance, irradiance, live=None):
    """The shadow rays of one light (Lighting.glsl:226-236 traces inside
    `irradiance > EPSILON`): (origin, direction, t_min, t_max), the pixels
    the light cannot reach, and without `live` (the G-buffer's misses),
    with the dead interval, which the kernel rejects before the walk."""
    contributes = irradiance > EPSILON
    if live is not None:
        contributes = contributes & live
    t_far = torch.where(contributes, distance, RAY_DEAD_T)
    return position + n * BIAS, l, RAY_MIN_T, t_far


def compute_direct_lighting(scene: FlatScene, tables: TraceTables,
                            position, n, v, nov, base_color, f0,
                            roughness, metallic, max_alpha_retrace: int = 4,
                            shadows: bool = True, live=None,
                            compose: str = "both"):
    """ComputeDirectLighting (Lighting.glsl:186-243) over the pixels, one
    pass per light, with shadow_rays' rays (`live` masks the pixels whose
    result is used: the G-buffer's hits)."""
    total = torch.zeros_like(base_color)
    a = roughness * roughness
    a2 = a * a
    for i in range(scene.light_count):
        l, distance, attenuation, nol, irradiance, color = light_terms(
            scene, i, position, n)
        h = normalize(l + v)
        noh = torch.clamp((n * h).sum(dim=-1), min=0.0)
        voh = torch.clamp((v * h).sum(dim=-1), min=0.0)

        d_term = brdf_lib.d_ggx(a2, noh)
        f_term = brdf_lib.f_schlick(f0, voh)
        vis = brdf_lib.vis_schlick(a, nov, nol)
        kd = (1.0 - f_term) * (1.0 - metallic)[..., None]
        diffuse = kd * brdf_lib.diffuse_lambert(base_color)
        specular = d_term[..., None] * f_term * vis[..., None]

        if shadows:
            occluded = trace_visibility(
                scene, tables, *shadow_rays(position, n, l, distance,
                                            irradiance, live),
                max_alpha_retrace).to(torch.float32)
        else:
            occluded = torch.zeros_like(nol)  # RAY_TRACING_ENABLED=0

        lighting = (nol * attenuation)[..., None] * color * (
            1.0 - occluded)[..., None]
        contribution = brdf_lib.compose_brdf(diffuse, specular,
                                             compose) * lighting
        total = total + torch.where((irradiance > EPSILON)[..., None],
                                    contribution, 0.0)
    return total


def env_brdf_scale_offset(nov, roughness):
    """Split-sum BRDF scale and offset (..., 2) from Karis's analytic
    quartic fit of the LUT ("Physically Based Material on Mobile"), as the
    reference lights with it; the fit's constants enter as Python floats,
    channel by channel."""
    r0 = roughness * -1.0 + 1.0
    r1 = roughness * -0.0275 + 0.0425
    r2 = roughness * -0.572 + 1.04
    r3 = roughness * 0.022 + -0.04
    a004 = torch.minimum(r0 * r0, torch.exp2(-9.28 * nov)) * r0 + r1
    return torch.stack([a004 * -1.04 + r2, a004 * 1.04 + r3], dim=-1)


def _env_irradiance(env: Environment, direction):
    """The irradiance cube at `direction`: the SH fit where the bake
    accepted one, else the quad rows."""
    if env.irradiance_sh is not None:
        return eval_cube_sh(env.irradiance_sh, direction)
    return sample_cube_quads(env.irradiance_quads, direction)


def compute_indirect_lighting(env: Environment, position, n, v, nov,
                              base_color, f0, roughness, metallic,
                              occlusion, light_volume=None,
                              compose: str = "both"):
    """ComputeIndirectLighting (Lighting.glsl:245-272)."""
    if light_volume is not None:
        with profiling.named_scope("light_volume_sample"):
            irradiance = sample_light_volume(light_volume, position, n)
        # The reference divides raw (Lighting.glsl:252); the ratio is
        # bounded so that a near-zero environment irradiance cannot blow up
        # the specular term.
        specular_norm = torch.clamp(
            irradiance / torch.clamp(_env_irradiance(env, n), min=1e-4),
            0.0, 8.0)
    else:
        irradiance = _env_irradiance(env, n)
        specular_norm = None
    ks = brdf_lib.f_schlick_roughness(f0, nov, roughness)
    kd = (1.0 - ks) * (1.0 - metallic)[..., None]

    r = 2.0 * (v * n).sum(dim=-1, keepdim=True) * n - v
    lod = roughness * (len(env.reflection_mips) - 1)
    reflection = sample_flat_mips_tri(
        env.reflection_tri_data, env.reflection_offsets,
        env.reflection_sizes, r, lod)

    scale_offset = env_brdf_scale_offset(nov, roughness)
    diffuse = kd * irradiance * base_color
    specular = (f0 * scale_offset[..., 0:1]
                + scale_offset[..., 1:2]) * reflection
    if specular_norm is not None:
        specular = specular * specular_norm
    return brdf_lib.compose_brdf(diffuse, specular,
                                 compose) * occlusion[..., None]


def deferred_lighting(scene: FlatScene, tables: TraceTables,
                      env: Environment, gbuffer, uv, inverse_proj_view,
                      camera_position, light_volume=None,
                      ray_tracing_enabled: bool = True,
                      debug_view: str | None = None,
                      override_material: tuple | None = None):
    """Lighting.comp: unpack the G-buffer, then direct + indirect +
    emission, linear HDR (N, 3).  `debug_view` "direct" or "indirect"
    returns one lighting term, "diffuse" or "specular" one ComposeBRDF
    term (Common/PBR.glsl:78-90); `override_material` forces (roughness,
    metallic) after the unpack (Lighting.comp:45-48)."""
    position = restore_position(gbuffer["depth"], uv, inverse_proj_view)
    n = gbuffer["normal"] * 2.0 - 1.0
    emission = to_linear(gbuffer["emission"])
    base_color = to_linear(gbuffer["base_color_occlusion"][..., :3])
    occlusion = gbuffer["base_color_occlusion"][..., 3]
    roughness = gbuffer["rough_metal"][..., 0]
    metallic = gbuffer["rough_metal"][..., 1]
    if override_material is not None:
        roughness = torch.full_like(roughness, override_material[0])
        metallic = torch.full_like(metallic, override_material[1])
    compose = (debug_view if debug_view in ("diffuse", "specular")
               else "both")

    f0 = DIELECTRIC_F0 + (base_color - DIELECTRIC_F0) * metallic[..., None]
    v = normalize(camera_position - position)
    nov = torch.clamp((n * v).sum(dim=-1), min=0.0)

    with profiling.named_scope("lighting_stage.direct"):
        if scene.light_count > 0:
            direct = compute_direct_lighting(
                scene, tables, position, n, v, nov, base_color, f0,
                roughness, metallic, shadows=ray_tracing_enabled,
                live=gbuffer["hit"], compose=compose)
        else:
            direct = torch.zeros_like(base_color)
    with profiling.named_scope("lighting_stage.indirect"):
        indirect = compute_indirect_lighting(
            env, position, n, v, nov, base_color, f0, roughness, metallic,
            occlusion, light_volume, compose=compose)

    if debug_view == "direct":
        return direct
    if debug_view == "indirect":
        return indirect
    return direct + indirect + emission
