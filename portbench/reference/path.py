"""The plain path tracer: one sample of chosen pixels, as RayGen.rgen:322-425
defines it (the port's `steeljax_torch/render/pt/integrator.py`).

Per pixel a seeded xoroshiro stream (the program's sample sequence), a
jittered primary ray from the inverse projection and view, then a bounded
bounce loop: a miss takes the sky; a hit adds its emission, next-event
estimation against the lights (irradiance-proportional pick, a jittered
shadow ray), samples the BRDF, and after `min_bounce_count` bounces plays
Russian roulette; the sum is clamped.  Rays are traced by brute force
(`portbench.reference.trace`), shading reads the reference's own scene
tables (`portbench.reference.scene`), and the whole computation runs in
the scene's dtype: float32 is the reference, a lower precision the control.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import brdf as brdf_lib
from portbench.reference import rng
from portbench.reference.scene import RefScene
from portbench.reference.trace import (Triangles, base_texel, interpolate,
                                       nearest, occluded)

BIAS = 0.005
RAY_MIN_T = 0.001
RAY_MAX_T = 1000.0
RAY_DEAD_T = -3.0e38
DIRECT_LIGHT_DISK_RADIUS = 0.0047
POINT_LIGHT_RADIUS = 0.05
EPSILON = brdf_lib.EPSILON
PI = brdf_lib.PI

# The procedural sky (steeljax/env/sky.py:25-78), in closed form.
_SUN_DIRECTION = np.asarray((0.35, 0.65, 0.25), np.float32)
_SUN_DIRECTION = _SUN_DIRECTION / np.linalg.norm(_SUN_DIRECTION)
_SUN_RADIANCE = 80.0
_SUN_COS_RADIUS = 0.9995
_ZENITH_COLOR = (0.20, 0.45, 1.05)
_HORIZON_COLOR = (0.85, 0.92, 1.05)
_GROUND_COLOR = (0.35, 0.30, 0.25)
_SKY_SCALE = 1.2
_SUN_COLOR = (1.0, 0.95, 0.85)


def _normalize(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-20)


def sky_radiance(dirs: torch.Tensor) -> torch.Tensor:
    y = dirs[..., 1]
    sun = _SUN_DIRECTION
    t = torch.clamp(y, 0.0, 1.0) ** 0.45
    below = torch.clamp(-y, 0.0, 1.0) ** 0.5
    cos_sun = (dirs[..., 0] * float(sun[0]) + dirs[..., 1] * float(sun[1])
               + dirs[..., 2] * float(sun[2]))
    disk = (cos_sun > _SUN_COS_RADIUS).to(dirs.dtype)
    halo = torch.clamp((cos_sun - 0.995) / 0.005, 0.0, 1.0) ** 8
    sun_weight = disk * _SUN_RADIANCE + halo * 2.0
    channels = []
    for c in range(3):
        sky = ((1.0 - t) * _HORIZON_COLOR[c] + t * _ZENITH_COLOR[c]) \
            * _SKY_SCALE
        color = sky * (1.0 - below) + _GROUND_COLOR[c] * below
        channels.append(color + sun_weight * _SUN_COLOR[c])
    return torch.stack(channels, dim=-1)


def _float(seed, dtype):
    value, seed = rng.next_float(seed)
    return value.to(dtype), seed


def primary_rays(scene: RefScene, width, height, px, py, seed):
    jitter, seed = rng.next_vec2(seed)
    jitter = jitter.to(scene.dtype)
    u = (px.to(scene.dtype) + jitter[..., 0]) / width
    v = (py.to(scene.dtype) + jitter[..., 1]) / height
    xy = torch.stack([u, v], dim=-1) * 2.0 - 1.0
    target = torch.cat([xy, torch.ones_like(xy)], dim=-1) @ \
        scene.inverse_proj.T
    direction = _normalize(target[..., :3])
    direction = (torch.cat([direction, torch.zeros_like(direction[..., :1])],
                           dim=-1) @ scene.inverse_view.T)[..., :3]
    origin = scene.inverse_view[:3, 3].expand(direction.shape)
    return origin, _normalize(direction), seed


def surface_at(scene: RefScene, rec: dict, d: torch.Tensor):
    """Surface constants and tangent frame at the hits (ClosestHit.rchit,
    UnpackMaterial): the interpolated vertex normal, flipped to face the
    ray where the geometric normal faces away from it; base colour and
    emission linearized from their sRGB factors (times the base texture)."""
    tri, u, v = rec["tri"], rec["u"], rec["v"]
    mat = scene.mat[tri]
    normal = _normalize(interpolate(scene.nrm[tri], u, v))
    backface = (scene.geom_n[tri] * d).sum(dim=-1) > 0.0
    normal = torch.where(backface[..., None], -normal, normal)
    base = scene.base_color[mat, :3]
    if scene.textures:
        base = base * base_texel(scene, tri, u, v)[:, :3]
    surface = brdf_lib.make_surface(brdf_lib.to_linear(base),
                                    scene.roughness[mat],
                                    scene.metallic[mat],
                                    brdf_lib.to_linear(scene.emission[mat]))
    return surface, brdf_lib.make_tbn(normal)


def sample_light(scene: RefScene, n, p, seed):
    """DirectLighting's light pick and jittered direction (RayGen.rgen:
    180-290): one float for the pick, two for the distortion."""
    loc = scene.light_location
    color = scene.light_color
    direction = loc[None, :, :3] - p[:, None, :] * loc[None, :, 3:4]
    dist2 = (direction * direction).sum(dim=-1)
    attenuation = torch.where(loc[None, :, 3] == 0.0, 1.0,
                              torch.where(dist2 == 0.0, 1e10, 1.0 / dist2))
    nol = torch.clamp((n[:, None, :] * _normalize(direction)).sum(dim=-1),
                      min=0.0)
    estimates = attenuation * nol * brdf_lib.luminance(color)[None, :]
    running = list(estimates.unbind(dim=-1))
    for i in range(1, len(running)):
        running[i] = running[i - 1] + running[i]
    cum = torch.stack(running, dim=-1)
    total = running[-1]
    has_light = total > 0.0
    cum_norm = cum / torch.clamp(total, min=1e-20)[:, None]
    pick, seed = _float(seed, scene.dtype)
    index = (pick[:, None] >= cum_norm[:, :-1]).sum(dim=-1)
    pdf = (estimates / torch.clamp(total, min=1e-20)[:, None]).gather(
        1, index[:, None])[:, 0]
    loc = loc[index]
    is_point = loc[..., 3]
    direction = loc[..., :3] - p * is_point[..., None]

    # ComputeLightDistortion (RayGen.rgen:251-266) about -direction.
    nd = -direction
    zero = torch.zeros_like(nd[..., 0])
    axis_u = torch.stack([nd[..., 1], -nd[..., 0], zero], dim=-1)
    u_len = torch.linalg.vector_norm(axis_u, dim=-1, keepdim=True)
    unit_x = torch.stack([torch.ones_like(zero), zero, zero], dim=-1)
    axis_u = torch.where(u_len > 1e-12,
                         axis_u / torch.clamp(u_len, min=1e-20), unit_x)
    axis_v = _normalize(torch.linalg.cross(nd, axis_u, dim=-1))
    theta, seed = _float(seed, scene.dtype)
    theta = theta * 2.0 * PI
    offset = torch.cos(theta)[..., None] * axis_u \
        + torch.sin(theta)[..., None] * axis_v
    r, seed = _float(seed, scene.dtype)
    dd = torch.sqrt(torch.clamp(1.0 - r * r, min=0.0))
    offset = offset * r[..., None] + _normalize(nd) * (dd * is_point)[..., None]

    radius = torch.where(is_point == 0.0,
                         torch.full_like(is_point, DIRECT_LIGHT_DISK_RADIUS),
                         torch.full_like(is_point, POINT_LIGHT_RADIUS))
    direction = direction + offset * radius[..., None]
    distance = torch.where(is_point == 0.0, RAY_MAX_T,
                           torch.linalg.vector_norm(direction, dim=-1))
    attenuation = torch.where(
        is_point == 0.0, 1.0,
        1.0 / torch.clamp(distance * distance, min=1e-20))
    return {"direction": _normalize(direction), "distance": distance,
            "attenuation": attenuation, "pdf": pdf, "has_light": has_light,
            "color": color[index]}, seed


def render_pixels(scene: RefScene, tris: Triangles, width: int, height: int,
                  px, py, accumulation_index: int, sample_index: int,
                  config: dict):
    """One sample of pixels (px, py): (N, 3) linear irradiance, clamped.
    `config` holds max_bounce_count, min_bounce_count, rr_min_threshold,
    max_irradiance and backface_culling."""
    dtype, device = scene.dtype, px.device
    seed = rng.make_seed(px, py, sample_index, accumulation_index)
    o, d, seed = primary_rays(scene, width, height, px, py, seed)
    count = o.shape[0]
    f = dict(dtype=dtype, device=device)
    irradiance = torch.zeros((count, 3), **f)
    throughput = torch.ones((count, 3), **f)
    ray_pdf = torch.ones((count,), **f)
    alive = torch.ones((count,), dtype=torch.bool, device=device)
    miss = torch.zeros_like(alive)
    t_min = torch.full((count,), scene.near, **f)
    t_max = torch.full((count,), scene.far, **f)
    lit = scene.light_location.shape[0] > 0
    for bounce in range(config["max_bounce_count"]):
        rec = nearest(tris, o, d, t_min, t_max, config["backface_culling"])
        weight = throughput / torch.clamp(ray_pdf, min=1e-30)[..., None]
        miss = miss | (alive & ~rec["hit"])
        alive = alive & rec["hit"]
        surface, tbn = surface_at(scene, rec, d)
        irradiance = irradiance + torch.where(
            alive[..., None], surface["emission"] * weight, 0.0)
        p = o + d * rec["t"][..., None]
        wo = _normalize(brdf_lib.world_to_tangent(-d, tbn))
        if lit:
            n = tbn[2]
            light, seed = sample_light(scene, n, p, seed)
            wi = brdf_lib.world_to_tangent(light["direction"], tbn)
            wh = _normalize(wo + wi)
            t_far = torch.where(light["has_light"] & alive, light["distance"],
                                torch.full_like(light["distance"],
                                                RAY_DEAD_T))
            blocked = occluded(tris, p + n * BIAS, light["direction"],
                               torch.full_like(t_far, RAY_MIN_T), t_far)
            fr = brdf_lib.evaluate_brdf(surface, wo, wi, wh)
            contrib = (fr * brdf_lib.cos_theta(wi)[..., None] * light["color"]
                       * (light["attenuation"] / torch.clamp(
                           light["pdf"], min=1e-20))[..., None])
            visible = light["has_light"] & ~blocked
            direct = torch.where(visible[..., None], contrib, 0.0)
            irradiance = irradiance + torch.where(alive[..., None],
                                                  direct * weight, 0.0)
        fr, wi, pdf, seed = brdf_lib.sample_brdf(surface, wo, seed)
        black = (fr * fr).sum(dim=-1) < EPSILON
        alive = alive & (pdf >= EPSILON) & ~black
        throughput = torch.where(
            alive[..., None],
            throughput * fr * brdf_lib.cos_theta(wi)[..., None], throughput)
        ray_pdf = torch.where(alive, ray_pdf * pdf, ray_pdf)
        if bounce >= config["min_bounce_count"]:
            threshold = torch.clamp(1.0 - throughput.max(dim=-1).values,
                                    min=config["rr_min_threshold"])
            r, seed = _float(seed, dtype)
            alive = alive & ~(r < threshold)
            throughput = torch.where(
                alive[..., None],
                throughput / torch.clamp(1.0 - threshold, min=1e-20)[..., None],
                throughput)
        o = p
        d = torch.where(alive[..., None], brdf_lib.tangent_to_world(wi, tbn),
                        d)
        t_min = torch.full_like(t_min, RAY_MIN_T)
        t_max = torch.where(alive, torch.full_like(t_max, RAY_MAX_T),
                            torch.full_like(t_max, RAY_DEAD_T))
    env_weight = torch.where(
        miss[..., None],
        throughput / torch.clamp(ray_pdf, min=1e-30)[..., None], 0.0)
    irradiance = irradiance + sky_radiance(d) * env_weight
    return torch.clamp(irradiance, max=config["max_irradiance"])
