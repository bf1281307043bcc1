"""The foliage scene: a canopy of alpha-tested leaf cards over a ground
quad, lit by a sun.

Frozen copy of `make_foliage_scene` and `_leaf_texture` of the port's
`steeljax_torch/scene/builtin.py` (which follow `steeljax/scene/
builtin.py:199-307`), as they stood when the benchmark was written.  The
only difference: the placement generator's seed is a parameter (the
port's fixes it at 11), so `make(params, placement_seed=11)` gives the
port's scene.
"""

from __future__ import annotations

import numpy as np

from portbench.scenes.common import (ALPHA_TEST, DOUBLE_SIDED, CameraSpec,
                                     EntitySpec, MaterialSpec, Mesh,
                                     SceneArrays, quad, trs)


def leaf_texture(size: int = 128, serrated: bool = True) -> np.ndarray:
    """RGBA leaf card: three elliptical leaflets with a midrib cut and, when
    `serrated`, texel-scale perforations (no coverage cell provably
    opaque)."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    alpha = np.zeros((size, size), bool)
    for cx, cy, rx, ry, rot in ((0.5, 0.42, 0.16, 0.34, 0.0),
                                (0.30, 0.55, 0.13, 0.27, 0.6),
                                (0.70, 0.55, 0.13, 0.27, -0.6)):
        dx, dy = x - cx, y - cy
        u = dx * np.cos(rot) - dy * np.sin(rot)
        v = dx * np.sin(rot) + dy * np.cos(rot)
        alpha |= (u / rx) ** 2 + (v / ry) ** 2 < 1.0
    alpha &= ~((np.abs(x - 0.5) < 0.012) & (y < 0.45))
    if serrated:
        alpha &= (np.sin(x * 97.0) * np.sin(y * 83.0)) > -0.92
    tex = np.zeros((size, size, 4), np.uint8)
    tex[..., 0] = 30
    tex[..., 1] = (90 + 100 * y).astype(np.uint8)
    tex[..., 2] = 25
    tex[..., 3] = np.where(alpha, 255, 0)
    return tex


def make(params: dict, placement_seed: int) -> SceneArrays:
    cards = int(params["cards"])
    region = float(params["region"])
    card_size = float(params["card_size"])
    rng = np.random.default_rng(placement_seed)
    materials = [
        MaterialSpec(base_color=(1.0, 1.0, 1.0, 1.0), base_color_texture=0,
                     roughness=0.8, metallic=0.0, alpha_cutoff=0.5,
                     flags=ALPHA_TEST | DOUBLE_SIDED),
        MaterialSpec(base_color=(0.45, 0.4, 0.32, 1.0), roughness=0.95,
                     metallic=0.0, flags=DOUBLE_SIDED)]

    h = card_size * 0.5
    base = np.array([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]],
                    np.float32)
    axis = rng.normal(size=(cards, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(0, np.pi, cards).astype(np.float32)
    c, s = np.cos(ang)[:, None, None], np.sin(ang)[:, None, None]
    k = np.zeros((cards, 3, 3), np.float32)
    k[:, 0, 1], k[:, 0, 2] = -axis[:, 2], axis[:, 1]
    k[:, 1, 0], k[:, 1, 2] = axis[:, 2], -axis[:, 0]
    k[:, 2, 0], k[:, 2, 1] = axis[:, 1], -axis[:, 0]
    rot = np.eye(3, dtype=np.float32)[None] + s * k + (1 - c) * (k @ k)
    centers = np.empty((cards, 3), np.float32)
    centers[:, 0] = rng.uniform(-region, region, cards)
    centers[:, 2] = rng.uniform(-region, region, cards)
    centers[:, 1] = rng.uniform(0.3, max(region * 0.65, 0.3 + 1e-6), cards)
    pos = (base[None] @ rot.transpose(0, 2, 1) + centers[:, None])
    nrm = np.broadcast_to(rot[:, None, :, 2], (cards, 4, 3))
    uv = np.tile(np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32),
                 (cards, 1))
    quad_idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    idx = (quad_idx[None] + 4 * np.arange(cards, dtype=np.uint32)[:, None])
    canopy = Mesh(idx.reshape(-1), pos.reshape(-1, 3).astype(np.float32),
                  np.ascontiguousarray(nrm.reshape(-1, 3), np.float32), uv)

    entities = [
        EntitySpec(trs((0, 0, 0)), [(0, 0)]),
        EntitySpec(trs((0, 0, 0), (1, 0, 0), float(np.pi / 2)), [(1, 1)]),
        EntitySpec(trs((0, 0, 0), (0, 0, 1), -2.1), [],
                   light_color=(3.0, 2.9, 2.7)),
    ]
    camera = CameraSpec(position=(0.0, region * 0.45, region * 1.6),
                        direction=(0.0, -0.12, -1.0), y_fov=0.872664626,
                        aspect_w=1.77777, aspect_h=1.0, near=0.01, far=200.0)
    return SceneArrays(meshes=[canopy, quad(region * 4.0)],
                       materials=materials,
                       textures=[leaf_texture(
                           serrated=bool(params["serrated"]))],
                       entities=entities, camera=camera)
