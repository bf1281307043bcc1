"""Light-volume debug visualization.

The reference ships probe-sphere / tet-edge visualization shaders that are
never called (Hybrid/LightVolumePositions.*, LightVolumeEdges.* — orphaned
per SURVEY.md §2.6; the README claims "Light volume can be visualized").
This working version splats probe positions over a rendered frame,
coloring each probe by its SH DC irradiance.  A copy of
steeljax/gi/debug.py (host numpy) that reads the volume's tensors from
any device.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def overlay_probes(image: np.ndarray, light_volume, view_proj: np.ndarray,
                   radius_px: int = 3) -> np.ndarray:
    """Return a copy of `image` (H, W, 3) with probe splats drawn on top.

    Probes are projected with view_proj (reverse-z clip conventions);
    color = tone-down of the probe's DC irradiance (c4 * L00)."""
    image = np.asarray(image).copy()
    h, w = image.shape[:2]
    positions = _host(light_volume.positions)
    coeffs = _host(light_volume.coefficients)
    if len(positions) == 0:
        return image

    dc = np.clip(coeffs[:, 0, :] * 0.886227, 0.0, 1.0)  # c4 * L00

    homo = np.concatenate([positions, np.ones((len(positions), 1))], axis=1)
    clip = homo @ _host(view_proj).T
    keep = clip[:, 3] > 1e-6
    ndc = clip[keep, :3] / clip[keep, 3:4]
    colors = dc[keep]
    xs = ((ndc[:, 0] + 1.0) * 0.5 * w).astype(int)
    ys = ((ndc[:, 1] + 1.0) * 0.5 * h).astype(int)
    # Reverse-z: visible points have depth in (0, 1].
    visible = (ndc[:, 2] > 0.0) & (ndc[:, 2] <= 1.0)

    for x, y, c, v in zip(xs, ys, colors, visible):
        if not v or not (0 <= x < w and 0 <= y < h):
            continue
        x0, x1 = max(0, x - radius_px), min(w, x + radius_px + 1)
        y0, y1 = max(0, y - radius_px), min(h, y + radius_px + 1)
        image[y0:y1, x0:x1] = 0.2 + 0.8 * c
    return image
