"""The plain hybrid frame at chosen pixels (HybridRenderer.cpp:79-91:
GBufferStage -> LightingStage -> ForwardStage), as the port's
`render/hybrid/` defines it for an opaque, untextured scene.

- G-buffer: the nearest hit of the ray through each pixel centre (back
  faces culled), the interpolated normal flipped to face the ray, the
  material's sRGB factors; the unorm targets quantized to the engine's bit
  depths (normal 10 bits, base colour and occlusion, roughness and
  metallic 8), reverse-z depth.
- Lighting (Lighting.comp, Lighting.glsl:186-272): the position restored
  from the stored depth, GGX direct light from each light with a shadow ray
  (any hit, back faces counted), split-sum indirect light from the baked
  irradiance and reflection chain with Karis's analytic BRDF fit, emission.
- Forward: the tone-mapped result, the sky in closed form where the
  G-buffer missed.

Rays are traced by brute force (`portbench.reference.trace`) and the
environment is baked again (`portbench.reference.environment`).
"""

from __future__ import annotations

import torch

from portbench.reference import brdf as brdf_lib
from portbench.reference.environment import Environment, sample_mips
from portbench.reference.path import (BIAS, RAY_DEAD_T, RAY_MAX_T,
                                      RAY_MIN_T, _normalize, sky_radiance)
from portbench.reference.scene import RefScene
from portbench.reference.trace import (Triangles, interpolate, nearest,
                                       occluded)

EPSILON = brdf_lib.EPSILON


def quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    levels = float((1 << bits) - 1)
    return torch.round(torch.clamp(x, 0.0, 1.0) * levels) / levels


def tone_map(linear: torch.Tensor) -> torch.Tensor:
    """Filmic (Hejl-Burgess-Dawson), sRGB-encoded (Common.glsl:119-124)."""
    x = torch.clamp(linear - 0.004, min=0.0)
    return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)


def render_pixels(scene: RefScene, tris: Triangles, env: Environment,
                  width: int, height: int, px, py) -> torch.Tensor:
    """(display colour (N, 3) in [0, 1], G-buffer hit (N,)) of pixels
    (px, py)."""
    dtype = scene.dtype
    iv, ip = scene.inverse_view, scene.inverse_proj
    uv = torch.stack([(px.to(dtype) + 0.5) / width,
                      (py.to(dtype) + 0.5) / height], dim=-1)
    xy = uv * 2.0 - 1.0
    target = torch.cat([xy, torch.ones_like(xy)], dim=-1) @ ip.T
    d = _normalize(target[..., :3])
    d = _normalize((torch.cat([d, torch.zeros_like(d[..., :1])], dim=-1)
                    @ iv.T)[..., :3])
    o = iv[:3, 3].expand(d.shape)
    camera = iv[:3, 3]
    count = d.shape[0]

    rec = nearest(tris, o, d, torch.full((count,), scene.near, dtype=dtype,
                                         device=d.device),
                  torch.full((count,), scene.far, dtype=dtype,
                             device=d.device), cull=True)
    hit = rec["hit"]
    tri = rec["tri"]
    mat = scene.mat[tri]
    normal = _normalize(interpolate(scene.nrm[tri], rec["u"], rec["v"]))
    backface = (scene.geom_n[tri] * d).sum(dim=-1) > 0.0
    normal = torch.where(backface[..., None], -normal, normal)
    p = o + d * rec["t"][..., None]
    clip = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1) @ \
        scene.view_proj.T
    w = clip[..., 3]
    depth = clip[..., 2] / torch.where(w.abs() < 1e-20,
                                       torch.full_like(w, 1e-20), w)
    col = hit[..., None]
    g_normal = torch.where(col, quantize(normal * 0.5 + 0.5, 10), 0.0)
    g_emission = torch.where(col, scene.emission[mat], 0.0)
    g_bco = torch.where(col, quantize(torch.cat(
        [scene.base_color[mat, :3], scene.occlusion[mat][..., None]],
        dim=-1), 8), 0.0)
    g_rm = torch.where(col, quantize(torch.stack(
        [scene.roughness[mat], scene.metallic[mat]], dim=-1), 8), 0.0)
    g_depth = torch.where(hit, depth, torch.zeros_like(depth))

    # Lighting.comp: unpack.
    ipv = iv @ ip
    clip = torch.cat([uv * 2.0 - 1.0, g_depth[..., None],
                      torch.ones_like(g_depth[..., None])], dim=-1)
    world = clip @ ipv.T
    ww = world[..., 3:4]
    position = world[..., :3] / torch.where(ww.abs() < 1e-20,
                                            torch.full_like(ww, 1e-20), ww)
    n = g_normal * 2.0 - 1.0
    emission = brdf_lib.to_linear(g_emission)
    base = brdf_lib.to_linear(g_bco[..., :3])
    occlusion = g_bco[..., 3]
    roughness, metallic = g_rm[..., 0], g_rm[..., 1]
    f0 = 0.04 + (base - 0.04) * metallic[..., None]
    v = _normalize(camera - position)
    nov = torch.clamp((n * v).sum(dim=-1), min=0.0)

    # Direct light (Lighting.glsl:186-243).
    direct = torch.zeros_like(base)
    a = roughness * roughness
    a2 = a * a
    for i in range(scene.light_location.shape[0]):
        loc = scene.light_location[i]
        color = scene.light_color[i]
        is_point = loc[3]
        direction = loc[:3] - position * is_point
        distance = torch.where(is_point == 0.0,
                               torch.full_like(direction[..., 0], RAY_MAX_T),
                               torch.linalg.vector_norm(direction, dim=-1))
        attenuation = torch.where(
            is_point == 0.0, torch.ones_like(distance),
            1.0 / torch.clamp(distance * distance, min=1e-20))
        l = _normalize(direction)
        nol = torch.clamp((n * l).sum(dim=-1), min=0.0)
        irradiance = attenuation * nol * brdf_lib.luminance(color)
        h = _normalize(l + v)
        noh = torch.clamp((n * h).sum(dim=-1), min=0.0)
        voh = torch.clamp((v * h).sum(dim=-1), min=0.0)
        f_term = brdf_lib.f_schlick(f0, voh)
        kd = (1.0 - f_term) * (1.0 - metallic)[..., None]
        brdf = (kd * brdf_lib.diffuse_lambert(base)
                + brdf_lib.d_ggx(a2, noh)[..., None] * f_term
                * brdf_lib.vis_schlick(a, nov, nol)[..., None])
        lights = (irradiance > EPSILON) & hit
        t_far = torch.where(lights, distance,
                            torch.full_like(distance, RAY_DEAD_T))
        blocked = occluded(tris, position + n * BIAS, l,
                           torch.full_like(t_far, RAY_MIN_T), t_far)
        lighting = (nol * attenuation)[..., None] * color * (
            1.0 - blocked.to(dtype))[..., None]
        direct = direct + torch.where((irradiance > EPSILON)[..., None],
                                      brdf * lighting, 0.0)

    # Indirect light (Lighting.glsl:245-272).
    ks = brdf_lib.f_schlick_roughness(f0, nov, roughness)
    kd = (1.0 - ks) * (1.0 - metallic)[..., None]
    r = 2.0 * (v * n).sum(dim=-1, keepdim=True) * n - v
    reflection = sample_mips(env.reflection, r,
                             roughness * (len(env.reflection) - 1))
    r0 = roughness * -1.0 + 1.0
    r1 = roughness * -0.0275 + 0.0425
    r2 = roughness * -0.572 + 1.04
    r3 = roughness * 0.022 + -0.04
    a004 = torch.minimum(r0 * r0, torch.exp2(-9.28 * nov)) * r0 + r1
    scale, offset = a004 * -1.04 + r2, a004 * 1.04 + r3
    indirect = (kd * env.irradiance_at(n) * base
                + (f0 * scale[..., None] + offset[..., None]) * reflection
                ) * occlusion[..., None]
    lit = direct + indirect + emission
    return torch.where(col, tone_map(lit), tone_map(sky_radiance(d))), hit
