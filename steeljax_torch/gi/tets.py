"""Delaunay tetrahedralization of probe positions.

A copy of steeljax/gi/tets.py (host numpy and scipy; the arrays equal the
reference's).

Replaces tetgen (MeshHelpers.cpp:113-168) with scipy.spatial.Delaunay
(qhull), which directly provides `simplices` (tetrahedronlist) and
`neighbors` (neighborlist).  Each tet stores the inverse barycentric
matrix B^-1 where B's columns are (a-d, b-d, c-d) (MeshHelpers.cpp:19-37):
for a point p, (u, v, w) = B^-1 (p - d) and the 4th coordinate is
1 - u - v - w.
"""

from __future__ import annotations

import numpy as np


def tetrahedralize(positions: np.ndarray):
    """Returns (vertices (T, 4) int32, neighbors (T, 4) int32 with -1 at
    hull faces, matrices (T, 3, 3) float32, positions_used (P, 3) float32
    — the possibly-jittered coordinates the matrices are built from; use
    these as the volume's probe positions).

    scipy neighbor convention: neighbors[i, k] is the tet opposite vertex
    k of tet i — the same convention the GLSL walk expects (hop across the
    face opposite the most negative barycentric coordinate,
    Lighting.glsl:125-150).
    """
    from scipy.spatial import Delaunay

    positions = np.asarray(positions, np.float64)
    if len(positions) < 4:
        return (np.zeros((0, 4), np.int32), np.zeros((0, 4), np.int32),
                np.zeros((0, 3, 3), np.float32),
                positions.astype(np.float32))

    # Octree-corner probes are exactly cospherical/cogrid — a worst case
    # for Delaunay (sliver tets, ambiguous neighbors, and tets whose
    # un-jittered vertices are coplanar).  A deterministic sub-millimeter
    # jitter breaks the degeneracy; the jittered coordinates are used
    # consistently for the mesh, matrices, and probe positions.
    rng = np.random.default_rng(0x5EED)
    scale = max(float(positions.max() - positions.min()), 1.0)
    positions = positions + rng.uniform(-1e-5, 1e-5,
                                        positions.shape) * scale
    tri = Delaunay(positions)
    simplices = tri.simplices.astype(np.int32)          # (T, 4)
    neighbors = tri.neighbors.astype(np.int32)          # (T, 4), -1 hull

    a = positions[simplices[:, 0]]
    b = positions[simplices[:, 1]]
    c = positions[simplices[:, 2]]
    d = positions[simplices[:, 3]]
    basis = np.stack([a - d, b - d, c - d], axis=-1)    # columns
    det = np.linalg.det(basis)
    ok = np.abs(det) > 1e-18
    safe = np.where(ok[:, None, None], basis, np.eye(3)[None])
    inv = np.linalg.inv(safe)
    inv[~ok] = 0.0
    return simplices, neighbors, inv.astype(np.float32), \
        positions.astype(np.float32)


def barycentric(positions: np.ndarray, vertices: np.ndarray,
                matrices: np.ndarray, tet: int, p: np.ndarray) -> np.ndarray:
    """Host-side reference for tests: 4-vector barycentric coords of p in
    tet (GetBaryCoord, Lighting.glsl:104-118)."""
    d = positions[vertices[tet, 3]]
    uvw = matrices[tet] @ (np.asarray(p, np.float64) - d)
    return np.array([*uvw, 1.0 - uvw.sum()], np.float32)
