"""Probe placement: octree subdivision filtered by a geometry oracle.

Port of steeljax/gi/probes.py (GlobalIllumination.cpp:34-161): extend the
scene AABB by 0.25, split boxes (stop at min edge 0.5), keep the boxes
that overlap a triangle's bounds, and dedup their corner positions.  The
positions equal the reference's array.

The reference pops one box at a time and tests it against every
triangle's bounds.  `np.unique` sorts the corners, so only the set of
terminal boxes matters, not the order the boxes are visited in: here the
octree goes level by level, and every box of a level is tested against
the triangle bounds at once, in blocks, as torch ops on the triangles'
device (one host read of the keep mask per level).  The box arithmetic
stays the reference's numpy float32 (`mid = 0.5 * (blo + bhi)`, the
terminal test on a float32 scalar edge), and the overlap is the same
float32 comparison, so the set of boxes is the same.
"""

from __future__ import annotations

import numpy as np
import torch

MIN_EDGE = 0.5            # GlobalIllumination.cpp:34
BBOX_EXTENSION = 0.25     # GlobalIllumination.cpp:61-66
# Box x triangle pairs tested in one block of the batched overlap.
OVERLAP_BLOCK = 1 << 24

# (8, 3) child and corner selectors: bit k of i picks the upper half on
# axis k, as the reference's `[(i >> k) & 1 for k in range(3)]`.
_OCTANTS = np.array([[(i >> k) & 1 for k in range(3)] for i in range(8)],
                    bool)


def _real_triangles(tri_pos) -> torch.Tensor:
    tri_pos = torch.as_tensor(tri_pos)
    return tri_pos[tri_pos[:, 0, 0] < 1e30]


def scene_aabb(tri_pos) -> tuple[np.ndarray, np.ndarray]:
    """AABB over real (non-pad) triangles, as float32 numpy (3,) arrays."""
    pts = _real_triangles(tri_pos).reshape(-1, 3)
    if len(pts) == 0:
        return np.zeros(3, np.float32), np.zeros(3, np.float32)
    return (pts.min(dim=0).values.cpu().numpy(),
            pts.max(dim=0).values.cpu().numpy())


class GeometryOracle:
    """'Does this box contain geometry?' via triangle-AABB overlap (the
    OcclusionRenderer::ContainsGeometry replacement), on the triangles'
    device."""

    def __init__(self, tri_pos):
        tris = _real_triangles(tri_pos)
        self.tri_min = tris.min(dim=1).values
        self.tri_max = tris.max(dim=1).values

    def overlaps(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """(B,) bool: which boxes (lo, hi), (B, 3) float32, overlap the
        bounds of at least one triangle."""
        count = len(self.tri_min)
        out = np.zeros(len(lo), bool)
        if count == 0 or len(lo) == 0:
            return out
        device = self.tri_min.device
        lo_t = torch.as_tensor(lo, device=device)
        hi_t = torch.as_tensor(hi, device=device)
        block = max(1, OVERLAP_BLOCK // count)
        found = torch.cat([
            ((self.tri_min[None] <= hi_t[i:i + block, None]).all(dim=-1)
             & (self.tri_max[None] >= lo_t[i:i + block, None]).all(dim=-1)
             ).any(dim=-1)
            for i in range(0, len(lo), block)])
        out[:] = found.cpu().numpy()
        return out

    def contains_geometry(self, lo: np.ndarray, hi: np.ndarray) -> bool:
        return bool(self.overlaps(np.asarray(lo, np.float32)[None],
                                  np.asarray(hi, np.float32)[None])[0])


def generate_probe_positions(tri_pos, min_edge: float = MIN_EDGE,
                             extension: float = BBOX_EXTENSION,
                             max_probes: int = 4096) -> np.ndarray:
    """Octree-split probe positions (GlobalIllumination.cpp:61-161) of the
    triangles `tri_pos` ((T, 3, 3), a tensor on the device that runs the
    overlap tests, or an array for the CPU); returns (P, 3) float32 unique
    corner positions."""
    lo, hi = scene_aabb(tri_pos)
    lo = lo - extension
    hi = hi + extension
    oracle = GeometryOracle(tri_pos)

    corners: list[np.ndarray] = []
    blo, bhi = lo[None], hi[None]
    while len(blo):
        keep = oracle.overlaps(blo, bhi)
        blo, bhi = blo[keep], bhi[keep]
        edges = (bhi - blo).max(axis=1)
        # The reference's test on a float32 scalar edge, box by box, so
        # that numpy's scalar promotion rules are the same.
        terminal = np.array([e <= min_edge * 2.0 + 1e-6 for e in edges],
                            bool)
        # Terminal boxes: their 8 corners.
        corners.append(np.where(_OCTANTS[None], bhi[terminal, None],
                                blo[terminal, None]).reshape(-1, 3))
        blo, bhi = blo[~terminal], bhi[~terminal]
        mid = 0.5 * (blo + bhi)
        blo, bhi = (
            np.where(_OCTANTS[None], mid[:, None], blo[:, None]).reshape(
                -1, 3),
            np.where(_OCTANTS[None], bhi[:, None], mid[:, None]).reshape(
                -1, 3))

    corners_all = np.concatenate(corners).astype(np.float32)
    if not len(corners_all):
        return np.zeros((0, 3), np.float32)
    positions = np.unique(
        np.round(corners_all / 1e-4).astype(np.int64), axis=0
    ).astype(np.float32) * 1e-4
    if len(positions) > max_probes:
        step = -(-len(positions) // max_probes)
        positions = positions[::step]
    return positions
