"""Monte-Carlo path-tracing integrator on tensors.

Port of steeljax/render/pt/integrator.py (RayGen.rgen:322-425): per pixel
a seeded xoroshiro stream, a jittered primary ray from the inverse
proj/view matrices, a bounded bounce loop (miss -> environment; emission;
next-event estimation against punctual lights with an irradiance-
proportional light pick and an any-hit shadow ray; textured shading with
normal mapping; BRDF importance sampling; Russian roulette after bounce 2),
irradiance clamp.  The bounce loop is a Python loop over a flat ray batch
with one nearest trace per bounce (plus one shadow trace in lit scenes);
dead lanes ride along with an inverted t interval (RAY_DEAD_T) and cost the
trace nothing.  Above REPACK_MIN_TRIS the in-flight rays are repacked
before every secondary bounce (repack_rays).

Alpha-tested materials (the any-hit re-trace) and multi-chunk scenes are
not ported; prepare_scene refuses them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from steeljax_torch.accel.dispatch import (TraceTables, trace_any,
                                           trace_nearest)
from steeljax_torch.core import rng
from steeljax_torch.core.colors import luminance, to_linear
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.core.constants import (BIAS, DIRECT_LIGHT_DISK_RADIUS,
                                           EPSILON, PI, POINT_LIGHT_RADIUS,
                                           RAY_DEAD_T, RAY_MAX_T, RAY_MIN_T)
from steeljax_torch.render.pt import brdf as brdf_lib
from steeljax_torch.render.texture import sample_bilinear
from steeljax_torch.scene.flatten import FlatScene


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-20)


def _matrix(m, device) -> torch.Tensor:
    return torch.as_tensor(m, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Ray generation (RayGen.rgen:52-70)
# ---------------------------------------------------------------------------

def primary_rays(inverse_view, inverse_proj, width, height, px, py, seed):
    """Jittered primary rays for pixels (px, py); returns (o, d, seed) with
    o/d shaped (N, 3).  inverse_view/inverse_proj are (4, 4) arrays or
    tensors; they are moved to the pixels' device."""
    device = px.device
    inverse_view = _matrix(inverse_view, device)
    inverse_proj = _matrix(inverse_proj, device)
    xs = px.to(torch.float32)
    ys = py.to(torch.float32)

    jitter, seed = rng.next_vec2(seed)
    u = (xs + jitter[..., 0]) / width
    v = (ys + jitter[..., 1]) / height
    xy = torch.stack([u, v], dim=-1) * 2.0 - 1.0

    target = torch.cat([xy, torch.ones_like(xy)], dim=-1) @ inverse_proj.T
    direction = _normalize(target[..., :3])
    direction = (torch.cat([direction, torch.zeros_like(direction[..., :1])],
                           dim=-1) @ inverse_view.T)[..., :3]
    origin = inverse_view[:3, 3].expand(direction.shape)
    return origin, _normalize(direction), seed


# ---------------------------------------------------------------------------
# Ray repacking for big scenes (integrator.py:151-265)
# ---------------------------------------------------------------------------

def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 5 bits of x across every third bit (Morton interleave)."""
    x = x & 0x1F
    x = (x | (x << 8)) & 0x100F
    x = (x | (x << 4)) & 0x10C3
    x = (x | (x << 2)) & 0x1249
    return x


def _ray_sort_key(o, d, lo, inv_extent) -> torch.Tensor:
    """18-bit int32 coherence key: 15-bit Morton cell of the origin (5 bits
    per axis over the scene AABB), direction octant in the low 3 bits.
    lo and inv_extent are 3-sequences of Python floats (float32 values)."""
    q = [torch.clamp((o[:, k] - lo[k]) * inv_extent[k] * 32.0, 0.0,
                     31.0).to(torch.int32) for k in range(3)]
    morton = (_part1by2(q[0]) | (_part1by2(q[1]) << 1)
              | (_part1by2(q[2]) << 2))
    octant = ((d[:, 0] > 0).to(torch.int32)
              | ((d[:, 1] > 0).to(torch.int32) << 1)
              | ((d[:, 2] > 0).to(torch.int32) << 2))
    return (morton << 3) | octant


# Scenes above this triangle count repack in-flight rays before every
# secondary bounce (trace_paths); it is read at call time, so a test can
# patch it.
REPACK_MIN_TRIS = 200_000


def _total_triangles(tables: TraceTables) -> int:
    """Triangle count (padded rows) of the flat tables, for the repack
    gate."""
    return sum(c.rows for c in tables.chunks)


def scene_bounds(tables: TraceTables) -> tuple[tuple, tuple]:
    """(lo, inv_extent) of the chunk AABBs for ray-sort keys, as float32
    values in Python floats (a constant of the key needs no device copy)."""
    lo = np.min([c.aabb[0] for c in tables.chunks], axis=0)
    hi = np.max([c.aabb[1] for c in tables.chunks], axis=0)
    inv = 1.0 / np.maximum(hi - lo, 1e-6)
    return (tuple(float(v) for v in lo.astype(np.float32)),
            tuple(float(v) for v in inv.astype(np.float32)))


def repack_rays(key: torch.Tensor, columns):
    """Reorder the in-flight ray state by `key`: one stable sort, then the
    same permutation of every column ((N,) or (N, k) tensors).  Returns
    (sorted_key, columns).  The reference moves the columns as payloads of
    one sort; the permutation gives the same order."""
    sorted_key, perm = torch.sort(key, stable=True)
    return sorted_key, [c.index_select(0, perm) for c in columns]


# ---------------------------------------------------------------------------
# Hit shading inputs (ClosestHit.rchit + UnpackMaterial, RayGen.rgen:72-115)
# ---------------------------------------------------------------------------

def material_select(scene: FlatScene, mid: torch.Tensor):
    """Per-ray material constants: (packed_row (N, 16), emission_linear
    (N, 3), texture ids (N, 5)).  The reference builds these with a select
    chain because a TPU gather is slow; plain indexing gives the same
    values."""
    mid = mid.long()
    return (scene.mat_packed[mid], scene.mat_emission_linear[mid],
            scene.mat_tex[mid])


def unpack_material_fused(scene: FlatScene, rec: dict):
    """Surface + TBN from the trace kernel's fused outputs: the
    interpolated, normalized, back-face-flipped normal and the material id,
    and in textured scenes (shade mode 2) the tangent and uv, which drive
    normal mapping and the base-colour, roughness-metallic and emission
    textures (integrator.py:554-599)."""
    normal = rec["n"]
    mrow, emission, tex = material_select(scene, rec["mat"])
    base_color = mrow[:, 13:16]  # ToLinear(factor) precomputed
    roughness = mrow[:, 7]
    metallic = mrow[:, 8]

    tbn = brdf_lib.make_tbn(normal)
    if scene.has_textures:
        uv = rec["uv"]

        def sample(idx):
            return sample_bilinear(scene.atlas, scene.tex_offset,
                                   scene.tex_size, idx, uv)

        def tex_rgb(idx):
            return torch.where((idx >= 0)[..., None], sample(idx)[..., :3],
                               1.0)

        n_idx = tex[:, 2]
        ns = sample(n_idx)[..., :3] * 2.0 - 1.0
        scale = mrow[:, 9]
        ns = _normalize(ns * torch.stack(
            [scale, scale, torch.ones_like(scale)], dim=-1))
        tbn_t = brdf_lib.make_tbn_with_tangent(normal, rec["tan"])
        perturbed = _normalize(brdf_lib.tangent_to_world(ns, tbn_t))
        tbn_nm = brdf_lib.make_tbn(perturbed)
        has_nm = (n_idx >= 0)[..., None]
        tbn = tuple(torch.where(has_nm, a, b) for a, b in zip(tbn_nm, tbn))

        base_color = to_linear(mrow[:, 0:3] * tex_rgb(tex[:, 0]))
        rm_idx = tex[:, 1]
        rm = sample(rm_idx)
        roughness = roughness * torch.where(rm_idx >= 0, rm[..., 1], 1.0)
        metallic = metallic * torch.where(rm_idx >= 0, rm[..., 2], 1.0)
        emission = to_linear(mrow[:, 4:7] * tex_rgb(tex[:, 4]))

    surface = brdf_lib.make_surface(base_color, roughness, metallic,
                                    emission)
    return surface, tbn


def trace_material_ray(scene: FlatScene, tables: TraceTables, o, d,
                       t_min, t_max, cull_backface: bool) -> dict:
    """Nearest hit of a material ray (the reference's non-alpha branch,
    steeljax/render/pt/integrator.py:268-313)."""
    if scene.any_alpha_test:
        raise NotImplementedError(
            "alpha-tested materials need the any-hit re-trace, not ported "
            "yet (ROADMAP item 16)")
    return trace_nearest(tables, o, d, t_min, t_max,
                         cull_backface=cull_backface)


def trace_visibility(scene: FlatScene, tables: TraceTables, o, d,
                     t_min, t_max) -> torch.Tensor:
    """TraceVisibilityRay (RayGen.rgen:127-178): occlusion without backface
    culling, (N,) bool (the reference's non-alpha branch,
    steeljax/render/pt/integrator.py:506-525)."""
    if scene.any_alpha_test:
        raise NotImplementedError(
            "alpha-tested shadow rays need the any-hit re-trace, not ported "
            "yet (ROADMAP item 16)")
    return trace_any(tables, o, d, t_min, t_max)


# ---------------------------------------------------------------------------
# Next-event estimation (RayGen.rgen:180-305)
# ---------------------------------------------------------------------------

def _estimate_lights(scene: FlatScene, n, p) -> torch.Tensor:
    """Per-light irradiance estimate (EstimateLight, RayGen.rgen:180-197).
    Returns (N, L) for the first light_count lights."""
    loc = scene.light_location[:scene.light_count]          # (L, 4)
    color = scene.light_color[:scene.light_count, :3]       # (L, 3)
    direction = loc[None, :, :3] - p[:, None, :] * loc[None, :, 3:4]
    dist2 = (direction * direction).sum(dim=-1)
    attenuation = torch.where(
        loc[None, :, 3] == 0.0, 1.0,
        torch.where(dist2 == 0.0, 1e10, 1.0 / dist2))
    l = _normalize(direction)
    nol = torch.clamp((n[:, None, :] * l).sum(dim=-1), min=0.0)
    return attenuation * nol * luminance(color)[None, :]


def _light_distortion(n, w, seed):
    """ComputeLightDistortion (RayGen.rgen:251-266): disk/sphere jitter of
    the light direction for soft penumbrae.  Draws two floats."""
    zero = torch.zeros_like(n[..., 0])
    u = torch.stack([n[..., 1], -n[..., 0], zero], dim=-1)
    u_len = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    unit_x = torch.stack([torch.ones_like(zero), zero, zero], dim=-1)
    u = torch.where(u_len > 1e-12, u / torch.clamp(u_len, min=1e-20), unit_x)
    v = _normalize(torch.linalg.cross(n, u, dim=-1))
    theta, seed = rng.next_float(seed)
    theta = theta * 2.0 * PI
    offset = torch.cos(theta)[..., None] * u + torch.sin(theta)[..., None] * v
    r, seed = rng.next_float(seed)
    dd = torch.sqrt(torch.clamp(1.0 - r * r, min=0.0))
    offset = offset * r[..., None] + _normalize(n) * (dd * w)[..., None]
    return offset, seed


def sample_light(scene: FlatScene, n, p, seed):
    """The light pick and jittered light direction of DirectLighting
    (RayGen.rgen:268-290), in the reference's RNG order: one float for the
    pick, then two for the distortion.  Returns ({"direction" (N, 3) unit,
    "distance", "attenuation", "pdf", "has_light" (N,), "color" (N, 3)},
    seed)."""
    estimates = _estimate_lights(scene, n, p)            # (N, L)
    # Running sum over the few lights, in cumsum's order: torch.cumsum
    # along this short innermost axis runs as a scan kernel that took 5 ms
    # per call at 921,600 rays on an H100.
    running = list(estimates.unbind(dim=-1))
    for i in range(1, len(running)):
        running[i] = running[i - 1] + running[i]
    cum = torch.stack(running, dim=-1)
    total = running[-1]
    has_light = total > 0.0
    cum_norm = cum / torch.clamp(total, min=1e-20)[:, None]

    pick, seed = rng.next_float(seed)
    # First index with pick < cum_norm[i] (RayGen.rgen:226-234).
    light_index = (pick[:, None] >= cum_norm[:, :-1]).sum(dim=-1)
    norm_est = estimates / torch.clamp(total, min=1e-20)[:, None]
    pdf = norm_est.gather(1, light_index[:, None])[:, 0]
    loc = scene.light_location[light_index]
    color = scene.light_color[light_index, :3]
    is_point = loc[..., 3]

    direction = loc[..., :3] - p * is_point[..., None]
    distortion, seed = _light_distortion(-direction, is_point, seed)
    radius = torch.where(is_point == 0.0, DIRECT_LIGHT_DISK_RADIUS,
                         POINT_LIGHT_RADIUS)
    direction = direction + distortion * radius[..., None]

    distance = torch.where(is_point == 0.0, RAY_MAX_T,
                           torch.linalg.vector_norm(direction, dim=-1))
    attenuation = torch.where(
        is_point == 0.0, 1.0,
        1.0 / torch.clamp(distance * distance, min=1e-20))
    return {"direction": _normalize(direction), "distance": distance,
            "attenuation": attenuation, "pdf": pdf, "has_light": has_light,
            "color": color}, seed


def shadow_rays(p, n, light):
    """The shadow ray of sample_light's light: (origin, direction, t_min,
    t_max), with an inverted interval where no light was picked."""
    t_far = torch.where(light["has_light"], light["distance"], RAY_DEAD_T)
    return p + n * BIAS, light["direction"], RAY_MIN_T, t_far


def direct_lighting(scene: FlatScene, tables: TraceTables, surface, tbn,
                    p, wo, seed, compose: str = "both"):
    """DirectLighting (RayGen.rgen:268-305).  Returns (radiance, seed).
    `compose` isolates the diffuse/specular BRDF term (ComposeBRDF,
    PathTracing.glsl:59)."""
    n = tbn[2]
    light, seed = sample_light(scene, n, p, seed)
    wi = brdf_lib.world_to_tangent(light["direction"], tbn)
    wh = _normalize(wo + wi)
    # Lanes with no light get an inverted interval: the kernel reports them
    # unoccluded without descending, and has_light zeroes them anyway.
    occluded = trace_visibility(scene, tables, *shadow_rays(p, n, light))

    f = brdf_lib.evaluate_brdf(surface, wo, wi, wh, compose=compose)
    contrib = (f * brdf_lib.cos_theta(wi)[..., None] * light["color"]
               * (light["attenuation"]
                  / torch.clamp(light["pdf"], min=1e-20))[..., None])
    visible = light["has_light"] & ~occluded
    return torch.where(visible[..., None], contrib, 0.0), seed


# ---------------------------------------------------------------------------
# The bounce loop (RayGen.rgen:322-412)
# ---------------------------------------------------------------------------

def _environment(scene: FlatScene, d: torch.Tensor) -> torch.Tensor:
    """Radiance of the environment seen along d: the procedural sky in
    closed form, else the constant colour prepare_scene baked (zero when
    there is no environment)."""
    if scene.env_analytic:
        from steeljax_torch.env.sky import sky_radiance
        return sky_radiance(d)
    return scene.env_cube.reshape(-1, 3)[0].expand(d.shape)


def trace_paths(scene: FlatScene, tables: TraceTables, o, d, seed,
                t_min, t_max, config: RenderConfig):
    """The bounce loop for a prepared ray batch (RayGen.rgen:344-407).

    Returns (irradiance (N, 3) clamped, seed, rays_traced) with rays_traced
    (path segments and shadow rays) a 0-d float32 tensor on the render
    device (no host sync per bounce)."""
    count = o.shape[0]
    device = o.device
    f32 = dict(dtype=torch.float32, device=device)
    rays_traced = torch.zeros((), **f32)
    irradiance = torch.zeros((count, 3), **f32)
    throughput = torch.ones((count, 3), **f32)
    ray_pdf = torch.ones((count,), **f32)
    alive = torch.ones((count,), dtype=torch.bool, device=device)
    t_min = torch.full((count,), float(t_min), **f32)
    t_max = torch.full((count,), float(t_max), **f32)
    # Deferred environment lookup: a lane misses at most once (it dies at
    # the miss) and its throughput / ray_pdf / direction freeze there, so
    # the miss-time env weight is recovered at the end from the frozen state
    # plus one "ever missed" bit.
    miss = torch.zeros((count,), dtype=torch.bool, device=device)

    # Before every secondary bounce on big scenes the in-flight ray state
    # is repacked by one stable sort (repack_rays): dead rays sink to the
    # tail and the live block is ordered by (Morton origin cell, direction
    # octant), so neighbouring threads walk neighbouring nodes.  `slot`
    # carries each ray's pixel, which restores frame order at the end.
    use_repack = _total_triangles(tables) > REPACK_MIN_TRIS
    sort_bounds = scene_bounds(tables) if use_repack else None
    slot = torch.arange(count, device=device)
    compose = (config.debug_view
               if config.debug_view in ("diffuse", "specular") else "both")
    for bounce in range(config.max_bounce_count):
        if bounce > 0 and use_repack:
            key = (((~alive).to(torch.int32) << 19)
                   | (miss.to(torch.int32) << 18)
                   | _ray_sort_key(o, d, *sort_bounds))
            key, (o, d, throughput, ray_pdf, irradiance, seed,
                  slot) = repack_rays(
                key, [o, d, throughput, ray_pdf, irradiance, seed, slot])
            alive = (key >> 19) == 0
            miss = ((key >> 18) & 1) == 1
            t_max = torch.where(alive, RAY_MAX_T, RAY_DEAD_T).to(
                torch.float32)
        rays_traced = rays_traced + alive.sum(dtype=torch.float32)
        rec = trace_material_ray(scene, tables, o, d, t_min, t_max,
                                 cull_backface=config.backface_culling)

        weight = throughput / torch.clamp(ray_pdf, min=1e-30)[..., None]

        # Miss -> environment (RayGen.rgen:353-357), deferred.
        miss = miss | (alive & ~rec["hit"])
        alive = alive & rec["hit"]

        surface, tbn = unpack_material_fused(scene, rec)
        if config.override_material is not None:
            # DEBUG_OVERRIDE_MATERIAL (RayGen.rgen:99-102).
            r_ov, m_ov = config.override_material
            surface = brdf_lib.make_surface(
                surface["base_color"],
                torch.full_like(surface["roughness"], r_ov),
                torch.full_like(surface["metallic"], m_ov),
                surface["emission"])

        # Emission (RayGen.rgen:361).
        irradiance = irradiance + torch.where(
            alive[..., None], surface["emission"] * weight, 0.0)

        p = o + d * rec["t"][..., None]
        wo = _normalize(brdf_lib.world_to_tangent(-d, tbn))

        # NEE against punctual lights (RayGen.rgen:366-371).
        if scene.light_count > 0:
            rays_traced = rays_traced + alive.sum(dtype=torch.float32)
            direct, seed = direct_lighting(scene, tables, surface, tbn, p,
                                           wo, seed, compose=compose)
            irradiance = irradiance + torch.where(
                alive[..., None], direct * weight, 0.0)

        # BRDF sample (RayGen.rgen:374-385).
        f, wi, pdf, seed = brdf_lib.sample_brdf(surface, wo, seed)
        black = (f * f).sum(dim=-1) < EPSILON
        alive = alive & (pdf >= EPSILON) & ~black

        throughput = torch.where(
            alive[..., None],
            throughput * f * brdf_lib.cos_theta(wi)[..., None], throughput)
        ray_pdf = torch.where(alive, ray_pdf * pdf, ray_pdf)

        # Russian roulette (RayGen.rgen:387-395).
        if bounce >= config.min_bounce_count:
            threshold = torch.clamp(
                1.0 - throughput.max(dim=-1).values,
                min=config.rr_min_threshold)
            r, seed = rng.next_float(seed)
            alive = alive & ~(r < threshold)
            throughput = torch.where(
                alive[..., None],
                throughput / torch.clamp(1.0 - threshold,
                                         min=1e-20)[..., None],
                throughput)

        o = p
        # Guarded so a ray that missed keeps its traced direction — that
        # frozen d is the deferred environment lookup direction.
        d = torch.where(alive[..., None],
                        brdf_lib.tangent_to_world(wi, tbn), d)
        t_min = torch.full_like(t_min, RAY_MIN_T)
        # Dead lanes get an inverted interval: the trace reports them as
        # misses without descending.
        t_max = torch.where(alive, RAY_MAX_T, RAY_DEAD_T).to(torch.float32)

    # Deferred env: throughput/ray_pdf/d froze at the miss bounce, so this
    # reproduces the per-bounce miss shading (RayGen.rgen:353-357).
    env_weight = torch.where(
        miss[..., None],
        throughput / torch.clamp(ray_pdf, min=1e-30)[..., None], 0.0)
    irradiance = irradiance + _environment(scene, d) * env_weight
    clamped = torch.clamp(irradiance, max=config.max_irradiance)
    if use_repack and config.max_bounce_count > 1:
        # Restore frame order: `slot` is a permutation, so scattering by it
        # puts every ray's irradiance (and seed, for the caller's next
        # sample) back at its pixel.
        restored = [torch.empty_like(x) for x in (clamped, seed)]
        restored[0][slot] = clamped
        restored[1][slot] = seed
        clamped, seed = restored
    return clamped, seed, rays_traced


def render_pixels(scene: FlatScene, tables: TraceTables,
                  inverse_view, inverse_proj,
                  camera_near: float, camera_far: float, width: int,
                  height: int, px, py, accumulation_index: int,
                  sample_index: int, config: RenderConfig = RenderConfig(),
                  return_stats: bool = False):
    """One path-traced irradiance sample for each pixel in (px, py);
    returns (N, 3) float32 linear (pre-tonemap, clamped), on the device the
    scene was prepared on.  px/py may be arrays or tensors; they are moved
    to that device.  With return_stats also {"rays_traced": 0-d tensor}."""
    device = scene.device
    px = torch.as_tensor(px, device=device).to(torch.int64)
    py = torch.as_tensor(py, device=device).to(torch.int64)
    count = px.shape[0]
    total = torch.zeros((count, 3), dtype=torch.float32, device=device)
    rays_traced = torch.zeros((), dtype=torch.float32, device=device)

    for s in range(config.sample_count):
        seed = rng.make_seed(px, py, s + int(sample_index),
                             int(accumulation_index))
        o, d, seed = primary_rays(inverse_view, inverse_proj, width, height,
                                  px, py, seed)
        sample, seed, rays = trace_paths(scene, tables, o, d, seed,
                                         camera_near, camera_far, config)
        total = total + sample
        rays_traced = rays_traced + rays

    result = total / config.sample_count
    if return_stats:
        return result, {"rays_traced": rays_traced}
    return result


@functools.lru_cache(maxsize=32)
def tiled_order(width: int, height: int):
    """Pixel order grouping rays into screen tiles (ThreadGroupTiling.glsl:
    19-70).  Returns (px, py, (tile_w, tile_h)) as numpy int32 arrays, or
    None when the extent doesn't tile; `detile` undoes the ordering."""
    for tw, th in ((64, 16), (128, 8), (32, 16), (16, 16)):
        if width % tw == 0 and height % th == 0:
            idx = np.arange(width * height, dtype=np.int32).reshape(
                height, width)
            order = idx.reshape(height // th, th, width // tw,
                                tw).transpose(0, 2, 1, 3).reshape(-1)
            return order % width, order // width, (tw, th)
    return None


def detile(result: torch.Tensor, width: int, height: int, tile):
    """Invert tiled_order's pixel ordering: (W*H, C) tile-ordered ->
    (H, W, C) row-major."""
    tw, th = tile
    c = tuple(result.shape[1:])
    r = result.reshape((height // th, width // tw, th, tw) + c)
    return r.permute(0, 2, 1, 3, *range(4, 4 + len(c))).reshape(
        (height, width) + c)


def render_sample(scene: FlatScene, tables: TraceTables,
                  inverse_view, inverse_proj,
                  camera_near, camera_far, width: int, height: int,
                  accumulation_index, sample_index,
                  config: RenderConfig = RenderConfig()) -> torch.Tensor:
    """Full-frame wrapper around render_pixels; (H, W, 3)."""
    tiled = tiled_order(width, height)
    if tiled is not None:
        px, py, tile = tiled
        result = render_pixels(
            scene, tables, inverse_view, inverse_proj, camera_near,
            camera_far, width, height, px, py,
            accumulation_index, sample_index, config)
        return detile(result, width, height, tile)
    ys, xs = np.meshgrid(np.arange(height, dtype=np.int32),
                         np.arange(width, dtype=np.int32), indexing="ij")
    result = render_pixels(
        scene, tables, inverse_view, inverse_proj, camera_near, camera_far,
        width, height, xs.reshape(-1), ys.reshape(-1),
        accumulation_index, sample_index, config)
    return result.reshape(height, width, 3)
