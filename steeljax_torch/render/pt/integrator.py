"""Monte-Carlo path-tracing integrator on tensors.

Port of steeljax/render/pt/integrator.py (RayGen.rgen:322-425): per pixel
a seeded xoroshiro stream, a jittered primary ray from the inverse
proj/view matrices, a bounded bounce loop (miss -> environment; emission;
next-event estimation against punctual lights with an irradiance-
proportional light pick and an any-hit shadow ray; textured shading with
normal mapping; BRDF importance sampling; Russian roulette after bounce 2),
irradiance clamp.  A bounce's work around its visibility trace is the two
stages of stages.py, on a CUDA device two kernels.  The bounce loop is a
Python loop over a flat ray batch with one nearest trace per bounce (plus
one shadow trace in lit scenes);
dead lanes ride along with an inverted t interval (RAY_DEAD_T) and cost the
trace nothing.  Above REPACK_MIN_TRIS the in-flight rays are repacked
before every secondary bounce (repack_rays); the reference's
STEELJAX_REPACK=force repacks below it too, and =live repacks by liveness
alone (dead rays sink, the live ones keep their order).

Alpha-tested materials (the reference's any-hit shader, AnyHit.rahit:
25-52): the trace kernel K4 drops candidates the coverage masks prove
transparent, and the exact test (render/surface.alpha_test, on a CUDA
device one kernel) re-traces past the rest, a bounded number of passes;
with tables.multihit_k > 0 the multi-hit kernel K5 returns K candidates
per walk instead.  Every pass runs unconditionally, with the rays that
need no re-trace given the dead interval, so the loop never reads a
device value on the host: the output is the reference's, whose lax.cond
skips only passes in which no ray would change.  A scene of several
chunks traces through dispatch's chunk sweep, whose records carry global
triangle ids; its alpha re-trace re-traces hit by hit (the K-nearest
kernel K5 traces one chunk, as in the reference).

Instanced tables (accel.instances, kernel K6) and treelet tables
(accel.treelets, K7) answer the same queries through accel.dispatch; with
instanced tables the unfused shading rows are composed from the BLAS's
object-space row and the instance's material row (surface.shade_rows).

`render_pixels` is a frame of core.profiling's record
(`integrator.render_pixels`): the pixel upload `integrator.upload_pixels`
(a wait: a copy of host data synchronizes the stream; tiled_order's
arrays are uploaded once per extent and device, by frame_pixels), then
`integrator.primary_rays`, each bounce `integrator.bounce` (its
`integrator.repack`, `integrator.trace_material` with the alpha re-trace's
`integrator.retrace_pass`es, `integrator.shade_fused` or
`integrator.shade_gather`, `integrator.nee` (stages.nee_stage and, in a
lit scene, the visibility trace), `integrator.sample` (stages.sample_stage))
and `integrator.environment`.  Since no frame reads the device on the
host, a CUDA device replays each kind of frame as one CUDA graph
(frame_graphs); a replayed frame's row holds the frame span alone.  Every
row counts the frame's bounces (`integrator.bounces`) and those whose
stages ran as the kernels of csrc/pathstage.cu
(`integrator.stage_bounces`), and its exact alpha tests
(`integrator.alpha_tests`) and those that ran as the kernel of
csrc/alphatest.cu (`integrator.alpha_kernel_tests`), replayed rows too.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from steeljax_torch.accel.bvh import TRI_PER_ROW
from steeljax_torch.accel.dispatch import (TraceTables, trace_any,
                                           trace_multihit, trace_nearest)
from steeljax_torch.accel.instances import InstancedTables
from steeljax_torch.core import profiling, rng
from steeljax_torch.core.colors import to_linear
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.core.constants import RAY_DEAD_T, RAY_MAX_T
from steeljax_torch.env.cubemap import sample_cube_quads
from steeljax_torch.render import surface as surface_lib
from steeljax_torch.render.pt import brdf as brdf_lib
from steeljax_torch.render.pt import frame_graphs, stages
from steeljax_torch.render.surface import (alpha_test, bilinear,
                                           interpolate, material_select,
                                           normalize, retrace_tmin,
                                           shade_rows, textured_surface)
from steeljax_torch.scene.flatten import FlatScene, MatPacked, TriShade


def _matrix(m, device) -> torch.Tensor:
    return profiling.upload(m, "integrator.upload_matrix",
                            dtype=torch.float32, device=device)


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
    direction = normalize(target[..., :3])
    direction = (torch.cat([direction, torch.zeros_like(direction[..., :1])],
                           dim=-1) @ inverse_view.T)[..., :3]
    origin = inverse_view[:3, 3].expand(direction.shape)
    return origin, normalize(direction), seed


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
    lo and inv_extent are 3-sequences of Python floats (float32 values) or
    (3,) float32 tensors (scene_bounds): the same float32 arithmetic."""
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


def _total_triangles(tables: TraceTables | InstancedTables) -> int:
    """Triangle count (padded rows) of the tables, for the repack gate.
    Instanced tables count instances x mean BLAS size (the world the rays
    traverse), not the deduplicated BLAS pool."""
    if isinstance(tables, InstancedTables):
        n_blas = max(len(tables.blas_tri_offset), 1)
        mean_blas = max(tables.tris_packed.shape[0] * TRI_PER_ROW // n_blas,
                        1)
        return tables.instance_count * mean_blas
    return sum(c.rows for c in tables.chunks)


def scene_bounds(tables: TraceTables | InstancedTables) -> tuple:
    """(lo, inv_extent) of the chunk AABBs for ray-sort keys, as float32
    values in Python floats (a constant of the key needs no device copy);
    of instanced tables, the rows of their `sort_bounds` tensor, which a
    refresh rewrites in place, so that a replayed frame reads the
    instances' bounds as they are now."""
    if isinstance(tables, InstancedTables):
        return tables.sort_bounds[0], tables.sort_bounds[1]
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

def _surface(base_color, roughness, metallic, emission) -> dict:
    """The surface's inputs, as the stages take them (stages.py derives
    brdf.make_surface's terms from them)."""
    return {"base_color": base_color, "roughness": roughness,
            "metallic": metallic, "emission": emission}


# The material terms a bounce shades with.
_SHADE_TERMS = ("base_color", "roughness", "metallic", "emission")


def unpack_material(scene: FlatScene, tables, rec: dict, d: torch.Tensor):
    """Surface + TBN at the hits of `rec` (UnpackMaterial, RayGen.rgen:
    72-115).  From the trace kernel's fused outputs where the record has
    them (integrator.py:554-599): the interpolated, normalized,
    back-face-flipped normal and the material id, and in textured scenes
    (shade mode 2) the tangent and uv.  Else from the hits' shading rows
    (surface.shade_rows, integrator.py:602-688), the normal flipped where
    geom_n . d > 0 (ClosestHit.rchit:67-70).  Untextured scenes take the
    precomputed linear colours; textured ones normal-map and sample the
    base-colour, roughness-metallic and emission textures.  Returns
    (surface, tbn), surface _surface's dict."""
    textured = scene.has_textures
    if "n" in rec:
        normal = rec["n"]
        rows, emission, tex = material_select(scene, rec["mat"])
        layout = MatPacked
        plain = (rows[:, layout.BASE_LINEAR], rows[:, layout.ROUGHNESS],
                 rows[:, layout.METALLIC], emission)
        if textured:
            tangent, uv = rec["tan"], rec["uv"]
    else:
        rows = shade_rows(scene, tables, rec)
        layout, tex = TriShade, rows[:, TriShade.TEX_IDS]
        u, v = rec["u"], rec["v"]
        normal = normalize(interpolate(rows, layout.NORMALS, u, v))
        if textured:
            tangent = normalize(interpolate(rows, layout.TANGENTS, u, v))
            uv = interpolate(rows, layout.UVS, u, v)
        backface = (rows[:, layout.GEOM_NORMAL] * d).sum(dim=-1) > 0.0
        normal = torch.where(backface[..., None], -normal, normal)
        plain = (rows[:, layout.BASE_LINEAR], rows[:, layout.ROUGHNESS],
                 rows[:, layout.METALLIC], rows[:, layout.EMISSION_LINEAR])

    tbn = brdf_lib.make_tbn(normal)
    if not textured:
        return _surface(*plain), tbn
    s = textured_surface(rows, layout, tex, bilinear(scene, uv),
                         _SHADE_TERMS, normal, tangent)
    has_nm = s["has_normal_map"][..., None]
    tbn = tuple(torch.where(has_nm, a, b)
                for a, b in zip(brdf_lib.make_tbn(s["normal"]), tbn))
    return _surface(to_linear(s["base_color"]), s["roughness"],
                    s["metallic"], to_linear(s["emission"])), tbn


class _Compaction:
    """Rejected-first compaction of a re-trace loop's rays (integrator.py:
    324-354): one stable sort moves the rays still to re-trace to the front,
    Morton-ordered by their current hit point, so the re-trace passes' live
    rays are neighbours; `restore` scatters results back to the caller's
    order.  Active above REPACK_MIN_TRIS for batches of 8192 rays or more."""

    def __init__(self, tables: TraceTables, count: int):
        self.active = (_total_triangles(tables) > REPACK_MIN_TRIS
                       and count >= 64 * 128)
        self.slot = None

    def apply(self, tables, pending, o, d, t_hit, columns):
        """Sort (pending, o, d, *columns) by the compaction key; returns
        (pending, o, d, columns) in the new order."""
        lo, inv_extent = scene_bounds(tables)
        p = o + d * torch.clamp(t_hit, min=0.0)[..., None]
        key = (((~pending).to(torch.int32) << 19)
               | _ray_sort_key(p, d, lo, inv_extent))
        self.slot = torch.arange(o.shape[0], device=o.device)
        key, cols = repack_rays(key, [o, d, self.slot] + list(columns))
        o, d, self.slot = cols[:3]
        return (key >> 19) == 0, o, d, cols[3:]

    def restore(self, rec: dict) -> dict:
        out = {}
        for k, x in rec.items():
            out[k] = torch.empty_like(x)
            out[k][self.slot] = x
        return out


def trace_material_ray(scene: FlatScene, tables: TraceTables, o, d,
                       t_min, t_max, cull_backface: bool,
                       max_alpha_retrace: int = 4,
                       retrace_log: list | None = None) -> dict:
    """Nearest hit of a material ray honouring alpha tests
    (integrator.py:268-384): in an alpha-tested scene, re-trace past
    alpha-rejected hits up to `max_alpha_retrace` times; a hit still
    rejected then counts as a miss.  With tables.multihit_k each pass runs
    the K-nearest kernel K5 and resolves its slots (integrator.py:417-503):
    one walk yields K candidates for the exact test, and a pass past slot
    K-1 runs only for rays whose K candidates were all rejected.
    `retrace_log`, when a list, gets (label, counts): the rays still to
    re-trace before the first pass and after each, as 0-d tensors."""
    if not scene.any_alpha_test:
        return trace_nearest(tables, o, d, t_min, t_max,
                             cull_backface=cull_backface)
    # The multi-hit path is the flat one-chunk tables' (integrator.py:
    # 297-300): instanced and treelet tables re-trace hit by hit.
    flat_tables = (not isinstance(tables, InstancedTables)
                   and tables.treelets is None)
    k_hits = tables.multihit_k if flat_tables else 0
    if k_hits > 0 and tables.shade_mode == 0 and len(tables.chunks) == 1:
        def trace(o, d, t_min, t_max):
            slots = trace_multihit(tables, o, d, t_min, t_max, k_hits,
                                   cull_backface=cull_backface)
            rec, exhausted = _resolve_multihit(scene, tables, slots)
            return rec, exhausted, slots["t"][k_hits - 1]
    else:
        def trace(o, d, t_min, t_max):
            rec = trace_nearest(tables, o, d, t_min, t_max,
                                cull_backface=cull_backface)
            return rec, alpha_test(scene, tables, rec), rec["t"]
    rec, counts = _bounded_retrace(tables, o, d, t_min, t_max, trace,
                                   max_alpha_retrace, retrace_log is not None)
    if retrace_log is not None:
        retrace_log.append(("material" if cull_backface else "shadow",
                            counts))
    return rec


def _bounded_retrace(tables: TraceTables, o, d, t_min, t_max, trace,
                     max_alpha_retrace: int, count_pending: bool):
    """The bounded re-trace of an alpha-tested trace (integrator.py:
    311-384, 417-503).  `trace(o, d, t_min, t_max)` returns (rec, pending,
    restart_t): the resolved hits, the rays whose hit is still unresolved,
    and the t each such ray re-traces from.  Every pass is launched, with
    the dead interval for the rays already resolved, so no pass waits on
    the host; above REPACK_MIN_TRIS the pending rays are compacted first.
    Returns (rec, counts): counts, when count_pending, the pending rays
    before the first pass and after each, as 0-d tensors."""
    count = o.shape[0]
    tmax = profiling.upload(t_max, "integrator.upload_tmax",
                            dtype=torch.float32, device=o.device).expand(count)
    rec, pending, restart_t = trace(o, d, t_min, tmax)
    compaction = _Compaction(tables, count)
    keys = sorted(rec)
    if compaction.active:
        pending, o, d, cols = compaction.apply(
            tables, pending, o, d, restart_t,
            [tmax, restart_t] + [rec[k] for k in keys])
        tmax, restart_t = cols[:2]
        rec = dict(zip(keys, cols[2:]))
    counts = [pending.sum()] if count_pending else None
    for _ in range(max_alpha_retrace):
        with profiling.named_scope("integrator.retrace_pass"):
            again, pending_again, restart_again = trace(
                o, d, retrace_tmin(restart_t),
                torch.where(pending, tmax, RAY_DEAD_T))
            rec = {k: torch.where(pending, again[k], rec[k]) for k in rec}
            restart_t = torch.where(pending, restart_again, restart_t)
            # Only pending rays changed, so the pending set only shrinks.
            pending = pending & pending_again
            if count_pending:
                counts.append(pending.sum())
    rec["hit"] = rec["hit"] & ~pending
    rec["tri"] = torch.where(rec["hit"], rec["tri"], -1)
    rec["t"] = torch.where(rec["hit"], rec["t"], -1.0)
    return (compaction.restore(rec) if compaction.active else rec), counts


def _resolve_multihit(scene: FlatScene, tables: TraceTables, slots: dict):
    """Winner selection over K sorted candidate slots (integrator.py:
    387-414): the first slot that is a hit and survives the exact alpha
    test wins; an empty slot means the ray ran out of surfaces (a resolved
    miss).  Returns (rec, exhausted), exhausted where all K slots hit and
    all were rejected (more surfaces may lie past slot K-1)."""
    k_hits, n = slots["t"].shape
    device = slots["t"].device
    rec = {"t": torch.full((n,), -1.0, device=device),
           "tri": torch.full((n,), -1, dtype=torch.int32, device=device),
           "u": torch.zeros((n,), device=device),
           "v": torch.zeros((n,), device=device),
           "hit": torch.zeros((n,), dtype=torch.bool, device=device)}
    resolved = torch.zeros((n,), dtype=torch.bool, device=device)
    for k in range(k_hits):
        rec_k = {f: slots[f][k] for f in ("t", "u", "v", "tri")}
        rec_k["hit"] = rec_k["tri"] >= 0
        rejected = alpha_test(scene, tables, rec_k)
        take = ~resolved & rec_k["hit"] & ~rejected
        for f in ("t", "u", "v", "tri"):
            rec[f] = torch.where(take, rec_k[f], rec[f])
        rec["hit"] = rec["hit"] | take
        resolved = resolved | take | ~rec_k["hit"]
    return rec, ~resolved


def trace_visibility(scene: FlatScene, tables: TraceTables, o, d,
                     t_min, t_max, max_alpha_retrace: int = 4,
                     retrace_log: list | None = None) -> torch.Tensor:
    """TraceVisibilityRay (RayGen.rgen:127-178): occlusion without backface
    culling, (N,) bool (integrator.py:506-525).  Alpha-tested scenes trace
    it as a material ray with culling off, so transparent texels let the
    shadow ray through (`retrace_log` as in trace_material_ray)."""
    if not scene.any_alpha_test:
        return trace_any(tables, o, d, t_min, t_max)
    return trace_material_ray(scene, tables, o, d, t_min, t_max,
                              cull_backface=False,
                              max_alpha_retrace=max_alpha_retrace,
                              retrace_log=retrace_log)["hit"]


# ---------------------------------------------------------------------------
# The bounce loop (RayGen.rgen:322-412)
# ---------------------------------------------------------------------------

def _environment(scene: FlatScene, d: torch.Tensor) -> torch.Tensor:
    """Radiance of the environment seen along d: the procedural sky in
    closed form, else a bilinear read of the cube prepare_scene baked
    (integrator.py:959-967; zero when there is no environment)."""
    if scene.env_analytic:
        from steeljax_torch.env.sky import sky_radiance
        return sky_radiance(d)
    return sample_cube_quads(scene.env_quads, d)


def trace_paths(scene: FlatScene, tables: TraceTables, o, d, seed,
                t_min, t_max, config: RenderConfig,
                retrace_log: list | None = None):
    """The bounce loop for a prepared ray batch (RayGen.rgen:344-407): a
    bounce is the material trace, the shading unpack, stages.nee_stage, the
    visibility trace in a lit scene and stages.sample_stage.

    Returns (irradiance (N, 3) clamped, seed, rays_traced) with rays_traced
    (path segments and shadow rays) a 0-d float32 tensor on the render
    device (no host sync per bounce).  `retrace_log`, when a list, gets
    the alpha re-trace counts of every material and shadow trace, in
    bounce order (trace_material_ray)."""
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
    # STEELJAX_REPACK=force repacks small scenes too, =live with a key of
    # liveness alone (steeljax/render/pt/integrator.py:826-848).
    use_repack = _total_triangles(tables) > REPACK_MIN_TRIS
    repack_env = os.environ.get("STEELJAX_REPACK", "")
    live_key_only = repack_env == "live"
    if repack_env in ("force", "live"):
        use_repack = True
    sort_bounds = scene_bounds(tables) if use_repack else None
    slot = torch.arange(count, device=device)
    compose = (config.debug_view
               if config.debug_view in ("diffuse", "specular") else "both")
    for bounce in range(config.max_bounce_count):
        with profiling.named_scope("integrator.bounce"):
            if bounce > 0 and use_repack:
                with profiling.named_scope("integrator.repack"):
                    key = (((~alive).to(torch.int32) << 19)
                           | (miss.to(torch.int32) << 18))
                    if not live_key_only:
                        key = key | _ray_sort_key(o, d, *sort_bounds)
                    key, (o, d, throughput, ray_pdf, irradiance, seed,
                          slot) = repack_rays(
                        key, [o, d, throughput, ray_pdf, irradiance, seed,
                              slot])
                    alive = (key >> 19) == 0
                    miss = ((key >> 18) & 1) == 1
                    t_max = torch.where(alive, RAY_MAX_T, RAY_DEAD_T).to(
                        torch.float32)
            rays_traced = rays_traced + alive.sum(dtype=torch.float32)
            with profiling.named_scope("integrator.trace_material"):
                rec = trace_material_ray(
                    scene, tables, o, d, t_min, t_max,
                    cull_backface=config.backface_culling,
                    max_alpha_retrace=config.max_alpha_retrace,
                    retrace_log=retrace_log)

            # The fused kernel's shading outputs, or without fused shading
            # (STEELJAX_SHADE_MODE=0, or tables without it) the gather of
            # the hits' shading rows.
            with profiling.named_scope("integrator.shade_fused" if "n" in rec
                                       else "integrator.shade_gather"):
                surface, tbn = unpack_material(scene, tables, rec, d)
            if config.override_material is not None:
                # DEBUG_OVERRIDE_MATERIAL (RayGen.rgen:99-102).
                r_ov, m_ov = config.override_material
                surface = {**surface,
                           "roughness": torch.full_like(
                               surface["roughness"], r_ov),
                           "metallic": torch.full_like(
                               surface["metallic"], m_ov)}

            # The miss and alive update, emission, and NEE against punctual
            # lights up to the shadow ray (RayGen.rgen:353-371).
            with profiling.named_scope("integrator.nee"):
                nee = stages.nee_stage(
                    scene, surface, tbn, o, d, rec["t"], rec["hit"],
                    throughput, ray_pdf, alive, miss, irradiance, seed,
                    compose)
                alive, miss = nee["alive"], nee["miss"]
                irradiance, seed = nee["irradiance"], nee["seed"]
                direct = None
                if scene.light_count > 0:
                    rays_traced = rays_traced + alive.sum(dtype=torch.float32)
                    # Lanes with no light get an inverted interval: the
                    # kernel reports them unoccluded without descending, and
                    # has_light zeroes them anyway.
                    occluded = trace_visibility(
                        scene, tables, *nee["shadow"],
                        max_alpha_retrace=config.max_alpha_retrace,
                        retrace_log=retrace_log)
                    direct = (nee["contrib"], nee["has_light"], occluded)

            # The shadow ray's term, the BRDF sample and Russian roulette
            # (RayGen.rgen:366-395).
            with profiling.named_scope("integrator.sample"):
                nxt = stages.sample_stage(
                    surface, tbn, nee["p"], nee["wo"], d, throughput,
                    ray_pdf, alive, irradiance, seed, direct,
                    roulette=bounce >= config.min_bounce_count,
                    rr_min_threshold=config.rr_min_threshold)
                o, d, t_min, t_max = (nxt["o"], nxt["d"], nxt["t_min"],
                                      nxt["t_max"])
                throughput, ray_pdf = nxt["throughput"], nxt["ray_pdf"]
                alive, irradiance = nxt["alive"], nxt["irradiance"]
                seed = nxt["seed"]

    with profiling.named_scope("integrator.environment"):
        # Deferred env: throughput/ray_pdf/d froze at the miss bounce, so
        # this reproduces the per-bounce miss shading (RayGen.rgen:
        # 353-357).
        env_weight = torch.where(
            miss[..., None],
            throughput / torch.clamp(ray_pdf, min=1e-30)[..., None], 0.0)
        irradiance = irradiance + _environment(scene, d) * env_weight
        clamped = torch.clamp(irradiance, max=config.max_irradiance)
        if use_repack and config.max_bounce_count > 1:
            # Restore frame order: `slot` is a permutation, so scattering
            # by it puts every ray's irradiance (and seed, for the caller's
            # next sample) back at its pixel.
            restored = [torch.empty_like(x) for x in (clamped, seed)]
            restored[0][slot] = clamped
            restored[1][slot] = seed
            clamped, seed = restored
    return clamped, seed, rays_traced


def _samples(scene: FlatScene, tables: TraceTables, inverse_view,
             inverse_proj, camera_near: float, camera_far: float, width: int,
             height: int, px, py, seed_of, config: RenderConfig,
             retrace_log: list | None):
    """The frame's work on pixels (px, py) on the scene's device:
    config.sample_count samples, sample s seeded by seed_of(s).  Returns
    (mean irradiance (N, 3), rays_traced)."""
    count = px.shape[0]
    device = px.device
    total = torch.zeros((count, 3), dtype=torch.float32, device=device)
    rays_traced = torch.zeros((), dtype=torch.float32, device=device)
    for s in range(config.sample_count):
        with profiling.named_scope("integrator.primary_rays"):
            seed = seed_of(s)
            o, d, seed = primary_rays(inverse_view, inverse_proj, width,
                                      height, px, py, seed)
        sample, seed, rays = trace_paths(scene, tables, o, d, seed,
                                         camera_near, camera_far, config,
                                         retrace_log)
        total = total + sample
        rays_traced = rays_traced + rays
    return total / config.sample_count, rays_traced


# The frames' CUDA graphs (frame_graphs).  A test or an app that replaces
# a function the frame calls (walk_route's walk) puts a
# FrameGraphs(frame_graphs.Eager()) in its place.
FRAME_GRAPHS = frame_graphs.FrameGraphs(frame_graphs.CudaGraphs())


def _frame_key(scene, tables, config: RenderConfig, width, height,
               camera_near, camera_far, pixels: int,
               return_stats: bool) -> tuple:
    """Everything a captured frame bakes in: the device, the scene and
    tables, the config, the extent, near and far, the number of pixels,
    return_stats, and the values the frame reads at call time
    (STEELJAX_REPACK, STEELJAX_SHADE_MODE, REPACK_MIN_TRIS)."""
    return (scene.device, id(scene), id(tables), config, int(width),
            int(height), float(camera_near), float(camera_far), pixels,
            bool(return_stats), os.environ.get("STEELJAX_REPACK"),
            os.environ.get("STEELJAX_SHADE_MODE"), REPACK_MIN_TRIS)


def _device_pixels(px, py, width: int, height: int, device) -> tuple:
    """(px, py) as tensors on `device`: tiled_order's arrays of this extent
    as frame_pixels' copy, anything else through the upload (a wait: a
    copy of host data synchronizes the stream; none for tensors on
    `device`)."""
    tiled = tiled_order(width, height)
    if tiled is not None and px is tiled[0] and py is tiled[1]:
        return frame_pixels(width, height, device)[:2]
    with profiling.named_scope("integrator.upload_pixels", wait=True):
        return torch.as_tensor(px, device=device), \
            torch.as_tensor(py, device=device)


def render_pixels(scene: FlatScene, tables: TraceTables,
                  inverse_view, inverse_proj,
                  camera_near: float, camera_far: float, width: int,
                  height: int, px, py, accumulation_index: int,
                  sample_index: int, config: RenderConfig = RenderConfig(),
                  return_stats: bool = False):
    """One path-traced irradiance sample for each pixel in (px, py);
    returns (N, 3) float32 linear (pre-tonemap, clamped), on the device the
    scene was prepared on.  px/py may be arrays or tensors; they are moved
    to that device.  With return_stats also {"rays_traced": 0-d tensor,
    "alpha_retrace": [(label, counts), ...]}: in alpha-tested scenes, for
    every material and shadow trace in bounce order, the rays still to
    re-trace before the first re-trace pass and after each, as 0-d tensors
    (trace_material_ray; empty otherwise).  No stat is read back.

    On a CUDA device the frame is replayed as a CUDA graph from its third
    call with the same key on (frame_graphs, _frame_key): the same kernels
    in the same order, so the same bits; the returned tensors are the
    caller's own.  The seed words, the matrices and the pixels reach the
    frame through buffers (frame_graphs.FrameInputs) on every device."""
    with profiling.frame("integrator.render_pixels"):
        device = scene.device
        px, py = _device_pixels(px, py, width, height, device)
        inputs = frame_graphs.FrameInputs(
            [rng.seed_word(s + int(sample_index), int(accumulation_index))
             for s in range(config.sample_count)],
            (inverse_view, inverse_proj), (px, py))

        def frame(buffers):
            words, view, proj, x, y = buffers
            log = [] if return_stats else None
            before = dict(stages.LAUNCHES)
            alpha = dict(surface_lib.COUNTS)
            result, rays = _samples(
                scene, tables, view, proj, camera_near, camera_far, width,
                height, x, y, lambda s: rng.make_seed(x, y, word=words[s]),
                config, log)
            # A bounce ran as the stage kernels where it launched both.
            staged = min(stages.LAUNCHES[k] - before[k] for k in before)
            layout = {"stage_bounces": staged,
                      "alpha_tests":
                          surface_lib.COUNTS["tests"] - alpha["tests"],
                      "alpha_kernel_tests":
                          surface_lib.COUNTS["alpha"] - alpha["alpha"],
                      "retrace": None}
            if log is None:
                return [result, rays], layout
            layout["retrace"] = [(label, len(cs)) for label, cs in log]
            return [result, rays] + [c for _, cs in log for c in cs], layout

        key = _frame_key(scene, tables, config, width, height, camera_near,
                         camera_far, px.shape[0], return_stats)
        (result, rays_traced, *counts), layout = FRAME_GRAPHS.run(
            key, (scene, tables), device, frame, inputs)
        # The bounces that ran the stage kernels, of the frame's bounces,
        # and the exact alpha tests that ran the alpha kernel, of its
        # tests: counted when the host ran the frame and kept in the
        # layout, so that a replayed frame counts them too.
        profiling.count("integrator.stage_bounces", layout["stage_bounces"])
        profiling.count("integrator.bounces",
                        config.sample_count * config.max_bounce_count)
        profiling.count("integrator.alpha_kernel_tests",
                        layout["alpha_kernel_tests"])
        profiling.count("integrator.alpha_tests", layout["alpha_tests"])
        retrace_log = None
        if layout["retrace"] is not None:
            counts = iter(counts)
            retrace_log = [(label, [next(counts) for _ in range(n)])
                           for label, n in layout["retrace"]]
        for _, counts in retrace_log or ():
            # The rays entering each pass, each pass launched over the
            # frame's rays.
            profiling.count_retrace(counts[:-1], result.shape[0])
    if return_stats:
        return result, {"rays_traced": rays_traced,
                        "alpha_retrace": retrace_log}
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


@functools.lru_cache(maxsize=8)
def frame_pixels(width: int, height: int, device):
    """A whole frame's pixels as int64 tensors on `device`, uploaded once
    per extent and device: tiled_order's where the extent tiles, with its
    tile, else row-major with tile None.  Returns (px, py, tile)."""
    tiled = tiled_order(width, height)
    if tiled is None:
        ys, xs = np.meshgrid(np.arange(height), np.arange(width),
                             indexing="ij")
        tiled = xs.reshape(-1), ys.reshape(-1), None
    with profiling.named_scope("integrator.upload_pixels", wait=True):
        return (torch.as_tensor(tiled[0], dtype=torch.int64, device=device),
                torch.as_tensor(tiled[1], dtype=torch.int64, device=device),
                tiled[2])


def render_sample(scene: FlatScene, tables: TraceTables,
                  inverse_view, inverse_proj,
                  camera_near, camera_far, width: int, height: int,
                  accumulation_index, sample_index,
                  config: RenderConfig = RenderConfig()) -> torch.Tensor:
    """Full-frame wrapper around render_pixels; (H, W, 3)."""
    px, py, tile = frame_pixels(width, height, scene.device)
    result = render_pixels(
        scene, tables, inverse_view, inverse_proj, camera_near, camera_far,
        width, height, px, py, accumulation_index, sample_index, config)
    if tile is not None:
        return detile(result, width, height, tile)
    return result.reshape(height, width, 3)
