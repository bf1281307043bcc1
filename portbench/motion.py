"""The per-frame motion of the moving instanced cell: a pure numpy function
of the run's seed and the frame's number, read by the program's side (the
scene edit before every frame) and the reference's side (the checked
frame's transforms) alike.

Each moved instance k keeps its base transform's translation p_k and
linear part S_k (scale) and at frame n takes

    T(p_k + AMPLITUDE sin(2 pi n / SWAY_FRAMES + phi_k) u_k)
    R(a_k, 2 pi n / TURN_FRAMES + psi_k) S_k

with u_k and a_k unit vectors and phi_k, psi_k phases drawn from the seed:
about 0.08 world units and 7.5 degrees a frame at most, some 4 pixels of a
1280x720 frame of the sunlit scene (16 units from the camera).  The moved
instances are the last `count` entities that hold render objects (the
sunlit generator's 300 grid instances); the room and the sun stay.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.scenes.common import SceneArrays, placement_seed

AMPLITUDE = 0.3
SWAY_FRAMES = 24
TURN_FRAMES = 48
SALT = 3


def moved_entities(arrays: SceneArrays, count: int) -> list:
    """Indices of the entities the motion moves."""
    renderable = [i for i, e in enumerate(arrays.entities) if e.objects]
    return renderable[len(renderable) - count:] if count else []


class Motion:
    """The motion of `count` instances of `arrays` for the run's `seed`."""

    def __init__(self, arrays: SceneArrays, count: int, seed: int):
        self.entities = moved_entities(arrays, count)
        base = np.stack([np.asarray(arrays.entities[i].transform, np.float64)
                         for i in self.entities]) if self.entities \
            else np.zeros((0, 4, 4))
        self.position = base[:, :3, 3]
        self.linear = base[:, :3, :3]
        rng = np.random.default_rng(placement_seed(seed, SALT))
        n = len(self.entities)
        self.sway = _unit(rng.normal(size=(n, 3)))
        self.axis = _unit(rng.normal(size=(n, 3)))
        self.sway_phase = rng.uniform(0.0, 2.0 * np.pi, n)
        self.turn_phase = rng.uniform(0.0, 2.0 * np.pi, n)

    def transforms(self, frame: int) -> np.ndarray:
        """(count, 4, 4) float32 world transforms of the moved entities at
        frame number `frame`."""
        n = len(self.entities)
        offset = AMPLITUDE * np.sin(2.0 * np.pi * frame / SWAY_FRAMES
                                    + self.sway_phase)
        angle = 2.0 * np.pi * frame / TURN_FRAMES + self.turn_phase
        out = np.zeros((n, 4, 4))
        out[:, :3, :3] = _rotation(self.axis, angle) @ self.linear
        out[:, :3, 3] = self.position + offset[:, None] * self.sway
        out[:, 3, 3] = 1.0
        return out.astype(np.float32)

    def arrays_at(self, arrays: SceneArrays, frame: int) -> SceneArrays:
        """`arrays` with the moved entities' transforms of frame `frame`."""
        entities = list(arrays.entities)
        for i, m in zip(self.entities, self.transforms(frame)):
            entities[i] = dataclasses.replace(entities[i], transform=m)
        return dataclasses.replace(arrays, entities=entities)


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _rotation(axis: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """(n, 3, 3) rotations by `angle` about unit `axis` (Rodrigues)."""
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    c, s = np.cos(angle), np.sin(angle)
    t = 1.0 - c
    return np.stack([
        np.stack([c + x * x * t, x * y * t - z * s, x * z * t + y * s], -1),
        np.stack([y * x * t + z * s, c + y * y * t, y * z * t - x * s], -1),
        np.stack([z * x * t - y * s, z * y * t + x * s, c + z * z * t], -1),
    ], axis=-2)
