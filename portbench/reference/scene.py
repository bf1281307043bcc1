"""The reference's own scene tables, worked out again from the generator's
`SceneArrays`: world-space triangles, their shading attributes, the
material constants, the textures at level 0, the lights and the camera.

Nothing here comes from the program: the flattening (each mesh's vertices
through its entity's transform, normals through the inverse transpose) and
the camera matrices (glm's lookAtRH and perspectiveRH_ZO with the Vulkan Y
flip and reverse depth) follow the reference renderer's definitions
(`steeljax/scene/flatten.py`, `core/camera.py`) in plain numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.scenes.common import ALPHA_TEST, DOUBLE_SIDED, SceneArrays


@dataclasses.dataclass
class RefScene:
    v0: torch.Tensor            # (T, 3) first vertex
    e1: torch.Tensor            # (T, 3) p1 - p0
    e2: torch.Tensor            # (T, 3) p2 - p0
    nrm: torch.Tensor           # (T, 3, 3) vertex shading normals
    uv: torch.Tensor            # (T, 3, 2)
    geom_n: torch.Tensor        # (T, 3) cross(p1 - p0, p2 - p0)
    mat: torch.Tensor           # (T,) int64
    double_sided: torch.Tensor  # (T,) bool
    base_color: torch.Tensor    # (M, 4) sRGB factors
    emission: torch.Tensor      # (M, 3) sRGB factors
    roughness: torch.Tensor     # (M,)
    metallic: torch.Tensor      # (M,)
    alpha_cutoff: torch.Tensor  # (M,)
    alpha_test: torch.Tensor    # (M,) bool
    base_tex: torch.Tensor      # (M,) int64, -1 for none
    textures: list              # (H, W, 4) tensors in [0, 1]
    light_location: torch.Tensor  # (L, 4): xyz, w = is point
    light_color: torch.Tensor     # (L, 3)
    inverse_view: torch.Tensor  # (4, 4)
    inverse_proj: torch.Tensor  # (4, 4)
    view_proj: torch.Tensor     # (4, 4) projection @ view
    occlusion: torch.Tensor     # (M,) occlusion strength
    near: float
    far: float
    any_alpha_test: bool
    dtype: torch.dtype

    @property
    def device(self) -> torch.device:
        return self.v0.device

    @property
    def triangle_count(self) -> int:
        return int(self.v0.shape[0])


def world_triangles(arrays: SceneArrays):
    """(pos (T, 3, 3), nrm (T, 3, 3), uv (T, 3, 2), mat (T,)) in entity
    order, numpy float32."""
    pos, nrm, uv, mat = [], [], [], []
    for e in arrays.entities:
        world = np.asarray(e.transform, np.float32)
        nmat = np.linalg.inv(world[:3, :3]).T
        for m, material in e.objects:
            mesh = arrays.meshes[m]
            tri = mesh.indices.reshape(-1, 3)
            p = mesh.positions @ world[:3, :3].T + world[:3, 3]
            n = mesh.normals @ nmat.T
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            pos.append(p[tri].astype(np.float32))
            nrm.append(n[tri].astype(np.float32))
            uv.append(mesh.uvs[tri].astype(np.float32))
            mat.append(np.full(len(tri), material, np.int64))
    return (np.concatenate(pos), np.concatenate(nrm), np.concatenate(uv),
            np.concatenate(mat))


def _look_at(eye, center, up):
    eye = np.asarray(eye, np.float32)
    f = np.asarray(center, np.float32) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float32))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def _perspective_reverse(y_fov, aspect, near, far):
    """perspectiveRH_ZO with near and far swapped (reverse depth) and the
    Vulkan Y flip."""
    z_near, z_far = far, near
    tan_half = np.tan(0.5 * y_fov)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = 1.0 / (aspect * tan_half)
    m[1, 1] = -1.0 / tan_half
    m[2, 2] = z_far / (z_near - z_far)
    m[2, 3] = -(z_far * z_near) / (z_far - z_near)
    m[3, 2] = -1.0
    return m


def camera_matrices(arrays: SceneArrays, with_view_proj: bool = False):
    """(inverse_view, inverse_proj[, view_proj]) as float32 numpy (4, 4)."""
    cam = arrays.camera
    position = np.asarray(cam.position, np.float32)
    view = _look_at(position, position + np.asarray(cam.direction,
                                                    np.float32), cam.up)
    proj = _perspective_reverse(cam.y_fov, cam.aspect_w / cam.aspect_h,
                                cam.near, cam.far)
    out = (np.linalg.inv(view).astype(np.float32),
           np.linalg.inv(proj).astype(np.float32))
    if with_view_proj:
        out += ((proj @ view).astype(np.float32),)
    return out


def lights(arrays: SceneArrays):
    """(location (L, 4), colour (L, 3)): a directional light shines along
    its transform's -X axis, w = 0."""
    loc, color = [], []
    for e in arrays.entities:
        if e.light_color is not None:
            world = np.asarray(e.transform, np.float32)
            loc.append([*(-world[:3, 0]), 0.0])
            color.append(e.light_color)
    return (np.asarray(loc, np.float32).reshape(-1, 4),
            np.asarray(color, np.float32).reshape(-1, 3))


def build(arrays: SceneArrays, device, dtype=torch.float32) -> RefScene:
    pos, nrm, uv, mat = world_triangles(arrays)
    geom_n = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    mats = arrays.materials
    flags = np.asarray([m.flags for m in mats], np.int64)
    base_tex = np.asarray([m.base_color_texture for m in mats], np.int64)
    alpha_test = ((flags & ALPHA_TEST) != 0) & (base_tex >= 0)
    inverse_view, inverse_proj, view_proj = camera_matrices(arrays, True)
    light_location, light_color = lights(arrays)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)

    p = dev(pos)
    return RefScene(
        v0=p[:, 0], e1=p[:, 1] - p[:, 0], e2=p[:, 2] - p[:, 0],
        nrm=dev(nrm), uv=dev(uv), geom_n=dev(geom_n),
        mat=dev(mat, torch.int64),
        double_sided=dev((flags[mat] & DOUBLE_SIDED) != 0, torch.bool),
        base_color=dev([m.base_color for m in mats]),
        emission=dev([m.emission for m in mats]),
        roughness=dev([m.roughness for m in mats]),
        metallic=dev([m.metallic for m in mats]),
        alpha_cutoff=dev([m.alpha_cutoff for m in mats]),
        alpha_test=dev(alpha_test, torch.bool),
        base_tex=dev(base_tex, torch.int64),
        textures=[dev(t.astype(np.float32) / 255.0) for t in arrays.textures],
        light_location=dev(light_location), light_color=dev(light_color),
        inverse_view=dev(inverse_view), inverse_proj=dev(inverse_proj),
        view_proj=dev(view_proj),
        occlusion=dev([m.occlusion for m in mats]),
        near=float(arrays.camera.near), far=float(arrays.camera.far),
        any_alpha_test=bool(alpha_test.any()), dtype=dtype)
