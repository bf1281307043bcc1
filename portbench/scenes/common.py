"""Plain scene description shared by the generators, the port's scene
builder (portbench/port_scene.py) and the reference (portbench/reference).

A generator returns a `SceneArrays`: numpy arrays and Python numbers only,
nothing of the program.  The mesh helpers are frozen copies of the port's
`steeljax_torch/scene/builtin.py` (`make_quad`, `make_box`, `_trs`) and
`scene/primitive.py` (`make_uv_sphere`) as they stood when the benchmark
was written, so a later change to the program's generators changes no
benchmark input.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# MaterialFlags bits (steeljax_torch/scene/material.py).
ALPHA_TEST = 1
DOUBLE_SIDED = 4

UP = (0.0, 1.0, 0.0)


@dataclasses.dataclass
class Mesh:
    indices: np.ndarray    # (I,) uint32
    positions: np.ndarray  # (V, 3) float32
    normals: np.ndarray    # (V, 3) float32
    uvs: np.ndarray        # (V, 2) float32


@dataclasses.dataclass
class MaterialSpec:
    base_color: tuple = (1.0, 1.0, 1.0, 1.0)
    emission: tuple = (0.0, 0.0, 0.0)
    base_color_texture: int = -1
    roughness: float = 1.0
    metallic: float = 1.0
    normal_scale: float = 1.0
    occlusion: float = 1.0
    alpha_cutoff: float = 0.5
    flags: int = 0


@dataclasses.dataclass
class EntitySpec:
    transform: np.ndarray           # (4, 4) float32 world transform
    objects: list                   # [(mesh index, material index)]
    light_color: tuple | None = None  # a directional light along -X


@dataclasses.dataclass
class CameraSpec:
    position: tuple
    direction: tuple
    y_fov: float
    aspect_w: float
    aspect_h: float
    near: float
    far: float
    up: tuple = UP


@dataclasses.dataclass
class SceneArrays:
    meshes: list
    materials: list
    textures: list        # (H, W, 4) uint8 arrays
    entities: list
    camera: CameraSpec

    def triangle_count(self) -> int:
        return sum(len(self.meshes[m].indices) // 3
                   for e in self.entities for m, _ in e.objects)


def quad(size: float = 10.0) -> Mesh:
    """size x size quad in the XY plane facing +Z."""
    h = size * 0.5
    positions = np.array([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]],
                         np.float32)
    uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    normals = np.tile(np.array([0, 0, 1], np.float32), (4, 1))
    return Mesh(indices, positions, normals, uvs)


def box(size: float = 1.0) -> Mesh:
    """Axis-aligned cube with per-face normals, centred at the origin."""
    h = size * 0.5
    faces, idx, normals, uvs = [], [], [], []
    base = 0
    for axis, u_ax, v_ax in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
        for sign in (1.0, -1.0):
            for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3, np.float32)
                p[axis] = sign * h
                p[u_ax] = du * h
                p[v_ax] = dv * h
                faces.append(p)
            n = np.zeros(3, np.float32)
            n[axis] = sign
            normals.extend([n] * 4)
            uvs.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
            if sign > 0:
                idx.extend([base, base + 1, base + 2, base, base + 2,
                            base + 3])
            else:
                idx.extend([base, base + 2, base + 1, base, base + 3,
                            base + 2])
            base += 4
    return Mesh(np.array(idx, np.uint32), np.array(faces, np.float32),
                np.array(normals, np.float32), np.array(uvs, np.float32))


def uv_sphere(radius: float = 1.0, rings: int = 16,
              sectors: int = 32) -> Mesh:
    ring = np.linspace(0.0, np.pi, rings + 1)
    sector = np.linspace(0.0, 2.0 * np.pi, sectors + 1)
    theta, phi = np.meshgrid(ring, sector, indexing="ij")
    x = np.sin(theta) * np.cos(phi)
    y = np.cos(theta)
    z = np.sin(theta) * np.sin(phi)
    positions = np.stack([x, y, z], axis=-1).reshape(-1, 3) * radius
    uv = np.stack([phi / (2 * np.pi), theta / np.pi], axis=-1).reshape(-1, 2)
    idx = []
    for i in range(rings):
        for j in range(sectors):
            a = i * (sectors + 1) + j
            b = a + sectors + 1
            idx += [a, a + 1, b, a + 1, b + 1, b]
    normals = positions / np.maximum(
        np.linalg.norm(positions, axis=-1, keepdims=True), 1e-20)
    return Mesh(np.array(idx, np.uint32), positions.astype(np.float32),
                normals.astype(np.float32), uv.astype(np.float32))


def trs(translation, rotation_axis=None, angle=0.0, scale=(1, 1, 1)):
    m = np.eye(4, dtype=np.float32)
    r = np.eye(3, dtype=np.float32)
    if rotation_axis is not None:
        axis = np.asarray(rotation_axis, np.float32)
        axis = axis / np.linalg.norm(axis)
        c, s = np.cos(angle), np.sin(angle)
        x, y, z = axis
        r = np.array([
            [c + x * x * (1 - c), x * y * (1 - c) - z * s,
             x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c),
             y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
             c + z * z * (1 - c)],
        ], np.float32)
    m[:3, :3] = r * np.asarray(scale, np.float32)[None, :]
    m[:3, 3] = translation
    return m


def placement_seed(seed: int, salt: int) -> int:
    """A 63-bit generator seed from the run's seed (any non-negative whole
    number) and a salt naming the draw."""
    state = np.random.SeedSequence([int(seed), salt]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))
