"""Checkpoint and resume of a path-traced accumulation and of a
light-volume bake.

Port of steeljax/io/checkpoint.py: each goes to an npz file under the
reference's keys, so that a checkpoint written by either package loads in
the other.  An accumulation is `accumulated` ((H, W, 3) float32) and
`index` (a 0-d integer); a light volume is its five arrays `positions`,
`tet_vertices`, `tet_neighbors`, `tet_matrices` and `coefficients`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from steeljax_torch.gi.light_volume import LightVolume
from steeljax_torch.render.pt.renderer import AccumulationState

_VOLUME_KEYS = ("positions", "tet_vertices", "tet_neighbors", "tet_matrices",
                "coefficients")


def save_accumulation(path: str | Path, state: AccumulationState) -> None:
    np.savez_compressed(
        path, accumulated=state.accumulated.detach().cpu().numpy(),
        index=np.asarray(state.index, np.int32))


def load_accumulation(path: str | Path,
                      device: torch.device | str) -> AccumulationState:
    with np.load(path) as data:
        return AccumulationState(
            accumulated=torch.as_tensor(
                np.asarray(data["accumulated"], np.float32), device=device),
            index=int(data["index"]))


def save_light_volume(path: str | Path, volume: LightVolume) -> None:
    np.savez_compressed(path, **{
        key: getattr(volume, key).detach().cpu().numpy()
        for key in _VOLUME_KEYS})


def load_light_volume(path: str | Path,
                      device: torch.device | str) -> LightVolume:
    with np.load(path) as data:
        volume = LightVolume(**{key: torch.from_numpy(data[key])
                                for key in _VOLUME_KEYS})
    return volume.to(device)
