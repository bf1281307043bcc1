"""Scene -> FlatScene: flat per-triangle and per-material tensors.

Port of steeljax/scene/flatten.py:23-398 (refresh_lights and
refresh_materials, :204-257, re-pack the light rows and the material tables
alone for the instanced refresh path).  The host packing is the same
numpy code, so every array equals the reference's; `FlatScene` then holds
the arrays as tensors on the render device, and its static fields stay
plain Python values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from steeljax_torch.core import profiling
from steeljax_torch.core.constants import MAX_LIGHT_COUNT
from steeljax_torch.scene.material import MaterialFlags
from steeljax_torch.scene.scene import Scene

MAX_TEX_MIPS = 13  # enough for 4096^2 sources


class TriGeometry:
    """Columns of a triangle's geometry: the shading row's columns
    TRI_SHADE_GEOMETRY, and the whole of the instanced tables' object-space
    blas_shade rows.  A per-vertex block holds vertex 0's, 1's and 2's
    attribute in turn; an int names one column, a slice a block."""
    NORMALS = slice(0, 9)          # shading normals
    TANGENTS = slice(9, 18)
    UVS = slice(18, 24)
    GEOM_NORMAL = slice(24, 27)    # cross(p1 - p0, p2 - p0), unnormalized
    UV_DENSITY = 27                # sqrt(uv area / world area)


class TriShade(TriGeometry):
    """Columns of the (T, TRI_SHADE_COLS) per-triangle shading row
    (pack_tri_shade, steeljax/scene/flatten.py:57-72): TriGeometry's, then
    the triangle's material's constants (TRI_SHADE_MATERIAL, the instanced
    tables' per-instance material row)."""
    MAT_ID = 28
    EMISSION_LINEAR = slice(29, 32)
    BASE_LINEAR = slice(32, 35)
    ALPHA = 35
    ROUGHNESS = 36
    METALLIC = 37
    ALPHA_CUTOFF = 38
    NORMAL_SCALE = 39
    FLAGS = 40                     # MaterialFlags bits
    TEX_IDS = slice(41, 46)        # mat_tex's five texture slots
    BASE_COLOR = slice(46, 49)
    EMISSION = slice(49, 52)
    OCCLUSION = 52                 # occlusion strength
    PAD = slice(53, 56)


TRI_SHADE_COLS = 56
TRI_SHADE_GEOMETRY = slice(0, 28)
TRI_SHADE_MATERIAL = slice(28, 56)


class MatPacked:
    """Columns of the (M, 16) per-material row (pack_materials)."""
    BASE_COLOR = slice(0, 3)
    ALPHA = 3
    EMISSION = slice(4, 7)
    ROUGHNESS = 7
    METALLIC = 8
    NORMAL_SCALE = 9
    OCCLUSION = 10
    ALPHA_CUTOFF = 11
    FLAGS = 12
    BASE_LINEAR = slice(13, 16)


@dataclasses.dataclass
class FlatScene:
    # Geometry (world space), one row per triangle.
    tri_pos: torch.Tensor   # (T, 3, 3) float32
    tri_nrm: torch.Tensor   # (T, 3, 3) float32 shading normals
    tri_tan: torch.Tensor   # (T, 3, 3) float32 tangents
    tri_uv: torch.Tensor    # (T, 3, 2) float32
    tri_mat: torch.Tensor   # (T,) int32 material id
    tri_double_sided: torch.Tensor  # (T,) bool — disables backface culling

    # Materials (gpu::Material, Common.h:30-45).
    mat_base_color: torch.Tensor  # (M, 4) float32
    mat_emission: torch.Tensor    # (M, 3) float32
    mat_params: torch.Tensor      # (M, 5) float32: rough, metal,
    #                               normal_scale, occlusion, alpha_cutoff
    mat_tex: torch.Tensor         # (M, 5) int32 texture ids (-1 none)
    mat_flags: torch.Tensor       # (M,) int32 MaterialFlags bits

    # Texture pool: every texture's mip chain as quad rows (row y*w + x of
    # a level holds the repeat-wrapped 2x2 bilinear footprint [c(x,y),
    # c(x+1,y), c(x,y+1), c(x+1,y+1)]); tex_offset[k, m] is the first row of
    # texture k's mip m (repeating the last level).  One empty row when the
    # scene has no textures.
    atlas: torch.Tensor        # (N, 16) uint8
    tex_offset: torch.Tensor   # (K, MAX_TEX_MIPS) int32
    tex_size: torch.Tensor     # (K, 2) int32 base (width, height)

    # Lights (gpu::Light, Common.h:24-28), padded to MAX_LIGHT_COUNT.
    light_location: torch.Tensor  # (16, 4) float32, w = isPoint
    light_color: torch.Tensor     # (16, 4) float32

    # Environment cubemap (+X -X +Y -Y +Z -Z), linear RGB.
    env_cube: torch.Tensor  # (6, R, R, 3) float32

    # Per-triangle shading rows (TriShade's columns).
    tri_shade: torch.Tensor   # (T, 56) float32
    # Per-material rows (MatPacked's columns).
    mat_packed: torch.Tensor  # (M, 16) float32
    mat_emission_linear: torch.Tensor  # (M, 3) float32
    # Bilinear-footprint rows of env_cube (env.cubemap.pack_cube_quads).
    env_quads: torch.Tensor  # (6*R*R, 16) float32

    # Static metadata.
    light_count: int = 0
    env_enabled: bool = False
    # The env cube was baked from the closed-form procedural sky: miss
    # shading evaluates env.sky.sky_radiance per ray.
    env_analytic: bool = False
    any_alpha_test: bool = False
    any_alpha_blend: bool = False
    has_textures: bool = False
    source_tri_count: int = -1

    @property
    def device(self) -> torch.device:
        return self.mat_packed.device

    def replace(self, **changes) -> "FlatScene":
        return dataclasses.replace(self, **changes)


def _downsample2(img: np.ndarray) -> np.ndarray:
    """2x2 box filter with odd-size clamping (mip generation)."""
    h, w = img.shape[:2]
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    ys = (np.arange(nh) * 2)
    xs = (np.arange(nw) * 2)
    y1 = np.minimum(ys + 1, h - 1)
    x1 = np.minimum(xs + 1, w - 1)
    acc = (img[np.ix_(ys, xs)].astype(np.uint16)
           + img[np.ix_(ys, x1)] + img[np.ix_(y1, xs)]
           + img[np.ix_(y1, x1)])
    return (acc // 4).astype(np.uint8)


def _pack_texture_quads(level: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 -> (H*W, 16) rows of the repeat-wrapped 2x2
    bilinear footprint."""
    h, w = level.shape[:2]
    xr = (np.arange(w) + 1) % w
    yd = (np.arange(h) + 1) % h
    quad = np.concatenate([level, level[:, xr], level[yd],
                           level[yd][:, xr]], axis=-1)
    return quad.reshape(-1, 16)


def _texture_pool(textures) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(atlas, tex_offset, tex_size) of the scene's textures, each with its
    full mip chain (steeljax/scene/flatten.py:306-337)."""
    if not textures:
        return (np.zeros((1, 16), np.uint8),
                np.zeros((1, MAX_TEX_MIPS), np.int32),
                np.ones((1, 2), np.int32))
    offsets, sizes, chunks = [], [], []
    total = 0
    for tex in textures:
        h, w = tex.shape[:2]
        sizes.append((w, h))
        mip_offsets = []
        level = tex
        for m in range(MAX_TEX_MIPS):
            mip_offsets.append(total)
            chunks.append(_pack_texture_quads(level))
            total += level.shape[0] * level.shape[1]
            if level.shape[0] == 1 and level.shape[1] == 1:
                # Repeat the last offset for the remaining slots.
                mip_offsets += [mip_offsets[-1]] * (MAX_TEX_MIPS - m - 1)
                break
            level = _downsample2(level)
        offsets.append(mip_offsets[:MAX_TEX_MIPS])
    return (np.concatenate(chunks), np.asarray(offsets, np.int32),
            np.asarray(sizes, np.int32))


def pack_tri_shade(tri_nrm, tri_tan, tri_uv, tri_pos, tri_mat=None,
                   mat_base_color=None, mat_emission=None, mat_params=None,
                   mat_tex=None, mat_flags=None) -> np.ndarray:
    """(T, 56) per-triangle shading row (TriShade): vertex attributes plus
    the owning material's constants (steeljax/scene/flatten.py:139-180)."""
    t = len(tri_nrm)
    c = TriShade
    out = np.zeros((t, TRI_SHADE_COLS), np.float32)
    if t:
        out[:, c.NORMALS] = np.asarray(tri_nrm, np.float32).reshape(t, 9)
        out[:, c.TANGENTS] = np.asarray(tri_tan, np.float32).reshape(t, 9)
        uv = np.asarray(tri_uv, np.float32)
        out[:, c.UVS] = uv.reshape(t, 6)
        p = np.asarray(tri_pos, np.float32)
        gn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        out[:, c.GEOM_NORMAL] = gn
        world_area = 0.5 * np.linalg.norm(gn, axis=-1)
        duv1 = uv[:, 1] - uv[:, 0]
        duv2 = uv[:, 2] - uv[:, 0]
        uv_area = 0.5 * np.abs(duv1[:, 0] * duv2[:, 1]
                               - duv1[:, 1] * duv2[:, 0])
        out[:, c.UV_DENSITY] = np.sqrt(
            uv_area / np.maximum(world_area, 1e-20)).astype(np.float32)
        if tri_mat is not None:
            m = np.asarray(tri_mat, np.int64)
            out[:, c.MAT_ID] = m.astype(np.float32)
            out[:, c.EMISSION_LINEAR] = _to_linear_np(
                np.asarray(mat_emission))[m]
            base = np.asarray(mat_base_color, np.float32)[m]
            out[:, c.BASE_LINEAR] = _to_linear_np(base[:, :3])
            out[:, c.ALPHA] = base[:, 3]
            params = np.asarray(mat_params, np.float32)[m]
            out[:, c.ROUGHNESS] = params[:, 0]
            out[:, c.METALLIC] = params[:, 1]
            out[:, c.ALPHA_CUTOFF] = params[:, 4]
            out[:, c.NORMAL_SCALE] = params[:, 2]
            out[:, c.FLAGS] = np.asarray(mat_flags, np.float32)[m]
            out[:, c.TEX_IDS] = np.asarray(mat_tex, np.float32)[m]
            out[:, c.BASE_COLOR] = base[:, :3]
            out[:, c.EMISSION] = np.asarray(mat_emission, np.float32)[m]
            out[:, c.OCCLUSION] = params[:, 3]
    return out


def _to_linear_np(srgb):
    srgb = np.asarray(srgb, np.float32)
    return np.where(srgb < 0.04045, srgb / 12.92,
                    ((srgb + 0.055) / 1.055) ** 2.4).astype(np.float32)


def pack_materials(mat_base_color, mat_emission, mat_params,
                   mat_flags) -> np.ndarray:
    """(M, 16) per-material rows (MatPacked) from the material tables;
    mat_params' columns are roughness, metallic, normal scale, occlusion
    strength and alpha cutoff."""
    m = len(mat_base_color)
    c = MatPacked
    out = np.zeros((m, 16), np.float32)
    out[:, c.BASE_COLOR] = mat_base_color[:, :3]
    out[:, c.ALPHA] = mat_base_color[:, 3]
    out[:, c.EMISSION] = mat_emission
    out[:, c.ROUGHNESS] = mat_params[:, 0]
    out[:, c.METALLIC] = mat_params[:, 1]
    out[:, c.NORMAL_SCALE] = mat_params[:, 2]
    out[:, c.OCCLUSION] = mat_params[:, 3]
    out[:, c.ALPHA_CUTOFF] = mat_params[:, 4]
    out[:, c.FLAGS] = np.asarray(mat_flags, np.float32)
    out[:, c.BASE_LINEAR] = _to_linear_np(mat_base_color[:, :3])
    return out


def _material_arrays(scene: Scene):
    """(base_color, emission, params, tex, flags) numpy tables from the
    scene's material list (gpu::Material re-pack, Common.h:30-45)."""
    mats = scene.materials or []
    m = max(len(mats), 1)
    mat_base_color = np.ones((m, 4), np.float32)
    mat_emission = np.zeros((m, 3), np.float32)
    mat_params = np.tile(np.array([1, 1, 1, 1, 0.5], np.float32), (m, 1))
    mat_tex = np.full((m, 5), -1, np.int32)
    mat_flags = np.zeros((m,), np.int32)
    for i, mat in enumerate(mats):
        mat_base_color[i] = mat.base_color_factor
        mat_emission[i] = mat.emission_factor[:3]
        mat_params[i] = [mat.roughness_factor, mat.metallic_factor,
                         mat.normal_scale, mat.occlusion_strength,
                         mat.alpha_cutoff]
        mat_tex[i] = [mat.base_color_texture,
                      mat.roughness_metallic_texture, mat.normal_texture,
                      mat.occlusion_texture, mat.emission_texture]
        mat_flags[i] = int(mat.flags)
    return mat_base_color, mat_emission, mat_params, mat_tex, mat_flags


def _light_rows(scene: Scene):
    """(light_location, light_color, light_count) padded to the reference's
    fixed UBO size (Common.h:4)."""
    locations, colors = scene.gather_lights()
    light_count = min(len(locations), MAX_LIGHT_COUNT)
    light_location = np.zeros((MAX_LIGHT_COUNT, 4), np.float32)
    light_color = np.zeros((MAX_LIGHT_COUNT, 4), np.float32)
    light_location[:light_count] = locations[:light_count]
    light_color[:light_count] = colors[:light_count]
    return light_location, light_color, int(light_count)


def copy_in(dst: torch.Tensor, host: np.ndarray) -> None:
    """Copy the host array into `dst` behind the work queued on the current
    stream, through pinned staging on a CUDA device: the host allocator
    keeps a staging block until the copy from it has run, so no later copy
    overwrites a pending one, and nothing waits.  Counts the bytes
    (core.profiling's `instances.upload_bytes`, the instanced refresh's)."""
    src = torch.from_numpy(np.ascontiguousarray(host))
    if dst.is_cuda:
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)
    profiling.count("instances.upload_bytes", host.nbytes)


def _write_into(flat: FlatScene, arrays: dict) -> bool:
    """Copy each host array of `arrays` into the FlatScene tensor of its
    name (copy_in) where every shape and dtype matches; else copy nothing.
    Returns whether it copied."""
    pairs = [(getattr(flat, name), a) for name, a in arrays.items()]
    if any(tuple(t.shape) != a.shape
           or t.dtype != torch.from_numpy(a[:0]).dtype for t, a in pairs):
        return False
    for dst, a in pairs:
        copy_in(dst, a)
    return True


def refresh_lights(flat: FlatScene, scene: Scene) -> FlatScene:
    """Re-pack just the light rows from the entity view, O(entities): the
    instanced refresh path keeps its geometry tables on the device.  With
    the light count unchanged the rows are copied into `flat`'s own
    tensors (no wait) and `flat` itself comes back, else a new FlatScene."""
    light_location, light_color, light_count = _light_rows(scene)
    if light_count == flat.light_count and _write_into(flat, {
            "light_location": light_location, "light_color": light_color}):
        return flat
    device = flat.device
    return flat.replace(
        light_location=torch.from_numpy(light_location).to(device),
        light_color=torch.from_numpy(light_color).to(device),
        light_count=light_count)


def refresh_materials(flat: FlatScene, scene: Scene) -> FlatScene:
    """Re-pack just the material tables, O(materials), for the instanced
    refresh path (the per-instance material rows are rebuilt inside
    InstancedAccel; these are the tables material_select reads).  With the
    material count unchanged they are copied into `flat`'s own tensors (no
    wait) and `flat` itself comes back, else a new FlatScene."""
    mat_base_color, mat_emission, mat_params, mat_tex, mat_flags = \
        _material_arrays(scene)
    arrays = {
        "mat_base_color": mat_base_color, "mat_emission": mat_emission,
        "mat_params": mat_params, "mat_tex": mat_tex, "mat_flags": mat_flags,
        "mat_packed": pack_materials(mat_base_color, mat_emission,
                                     mat_params, mat_flags),
        "mat_emission_linear": _to_linear_np(mat_emission)}
    if _write_into(flat, arrays):
        return flat
    device = flat.device
    return flat.replace(**{
        name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for name, a in arrays.items()})


def flatten_scene(scene: Scene, device: torch.device | str,
                  env_cube: np.ndarray | None = None,
                  env_analytic: bool = False) -> FlatScene:
    tri_pos, tri_nrm, tri_tan, tri_uv, tri_mat, tri_ds = [], [], [], [], [], []

    for entity_index in scene.renderable_entities():
        world = scene.world_transform(entity_index)
        nmat = np.linalg.inv(world[:3, :3]).T
        for ro in scene.entities[entity_index].render_objects:
            prim = scene.primitives[ro.primitive]
            mat = scene.materials[ro.material]
            tri = prim.indices.reshape(-1, 3)

            pos = prim.positions @ world[:3, :3].T + world[:3, 3]
            nrm = prim.normals @ nmat.T
            nrm /= np.maximum(
                np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
            tan = prim.tangents @ world[:3, :3].T
            tan /= np.maximum(
                np.linalg.norm(tan, axis=-1, keepdims=True), 1e-20)

            tri_pos.append(pos[tri].astype(np.float32))
            tri_nrm.append(nrm[tri].astype(np.float32))
            tri_tan.append(tan[tri].astype(np.float32))
            tri_uv.append(prim.tex_coords[tri].astype(np.float32))
            tri_mat.append(np.full(len(tri), ro.material, np.int32))
            tri_ds.append(np.full(len(tri), mat.double_sided, bool))

    if tri_pos:
        tri_pos = np.concatenate(tri_pos)
        tri_nrm = np.concatenate(tri_nrm)
        tri_tan = np.concatenate(tri_tan)
        tri_uv = np.concatenate(tri_uv)
        tri_mat = np.concatenate(tri_mat)
        tri_ds = np.concatenate(tri_ds)
    else:
        tri_pos = np.zeros((0, 3, 3), np.float32)
        tri_nrm = np.zeros((0, 3, 3), np.float32)
        tri_tan = np.zeros((0, 3, 3), np.float32)
        tri_uv = np.zeros((0, 3, 2), np.float32)
        tri_mat = np.zeros((0,), np.int32)
        tri_ds = np.zeros((0,), bool)

    mat_base_color, mat_emission, mat_params, mat_tex, mat_flags = \
        _material_arrays(scene)
    atlas, tex_offset, tex_size = _texture_pool(scene.textures)

    light_location, light_color, light_count = _light_rows(scene)

    env_enabled = env_cube is not None
    if env_cube is None:
        env_cube = np.zeros((6, 1, 1, 3), np.float32)

    any_alpha_test = any(
        (f & MaterialFlags.ALPHA_TEST) and t[0] >= 0
        for f, t in zip(mat_flags, mat_tex))
    any_alpha_blend = any(
        bool(f & MaterialFlags.ALPHA_BLEND) for f in mat_flags)

    tri_shade = pack_tri_shade(tri_nrm, tri_tan, tri_uv, tri_pos, tri_mat,
                               mat_base_color, mat_emission, mat_params,
                               mat_tex, mat_flags)
    mat_packed = pack_materials(mat_base_color, mat_emission, mat_params,
                                mat_flags)

    from steeljax_torch.env.cubemap import pack_cube_quads
    env_quads = pack_cube_quads(np.asarray(env_cube, np.float32))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return FlatScene(
        tri_pos=dev(tri_pos), tri_nrm=dev(tri_nrm),
        tri_tan=dev(tri_tan), tri_uv=dev(tri_uv),
        tri_mat=dev(tri_mat), tri_double_sided=dev(tri_ds),
        mat_base_color=dev(mat_base_color),
        mat_emission=dev(mat_emission),
        mat_params=dev(mat_params),
        mat_tex=dev(mat_tex),
        mat_flags=dev(mat_flags),
        atlas=dev(atlas),
        tex_offset=dev(tex_offset),
        tex_size=dev(tex_size),
        light_location=dev(light_location),
        light_color=dev(light_color),
        env_cube=dev(env_cube),
        tri_shade=dev(tri_shade),
        mat_packed=dev(mat_packed),
        mat_emission_linear=dev(_to_linear_np(mat_emission)),
        env_quads=dev(env_quads),
        light_count=int(light_count),
        env_enabled=bool(env_enabled),
        env_analytic=bool(env_analytic and env_enabled),
        any_alpha_test=bool(any_alpha_test),
        any_alpha_blend=bool(any_alpha_blend),
        has_textures=bool(scene.textures),
        source_tri_count=int(len(tri_pos)),
    )
