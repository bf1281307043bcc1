"""Cubemap construction and sampling.

Port of steeljax/env/cubemap.py:18-313.  The host part (`face_directions`,
`pack_cube_quads`, the mip packers) is numpy, so the arrays equal the
reference's; the packers hand their tables over as tensors on the caller's
device.  Face basis tables match Source/Shaders/Common/Constants.glsl:24-48
(order +X -X +Y -Y +Z -Z), and texel directions match `GetCubeDirection`
(Compute/Compute.glsl:18-27): sampling inverts that mapping, so a cube
baked at texel centres samples back exactly there.

The reference reads the face basis and the mip descriptors through select
chains because a TPU gather from a tiny table is slow; plain indexing gives
the same values.  `sample_flat_mips_tri` reads one 48-float mip-pair row
per lookup where `sample_flat_mips` reads two quad rows; the two are
bit-exact with each other.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from steeljax_torch.core.constants import (CUBE_FACES_B, CUBE_FACES_N,
                                           CUBE_FACES_T)


def face_directions(resolution: int) -> np.ndarray:
    """(6, R, R, 3) unit directions at texel centers (host-side)."""
    texel = (np.arange(resolution, dtype=np.float32) + 0.5) / resolution
    x, y = np.meshgrid(texel * 2.0 - 1.0, texel * 2.0 - 1.0, indexing="xy")
    dirs = (CUBE_FACES_N[:, None, None, :]
            + x[None, :, :, None] * CUBE_FACES_T[:, None, None, :]
            + y[None, :, :, None] * CUBE_FACES_B[:, None, None, :])
    # y index is the row (v), x the column (u): meshgrid 'xy' gives [row, col].
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs.astype(np.float32)


def pack_cube_quads(cube: np.ndarray) -> np.ndarray:
    """Pack a (6, R, R, 3) cube into bilinear-footprint rows (6*R*R, 16):
    row (f*R + v)*R + u = [c(u,v), c(u+1,v), c(u,v+1), c(u+1,v+1), pad*4]
    with edge-clamped neighbors."""
    cube = np.asarray(cube, np.float32)
    faces, res = cube.shape[0], cube.shape[1]
    right = cube[:, :, np.minimum(np.arange(res) + 1, res - 1)]
    down = cube[:, np.minimum(np.arange(res) + 1, res - 1)]
    down_right = down[:, :, np.minimum(np.arange(res) + 1, res - 1)]
    quads = np.zeros((faces, res, res, 16), np.float32)
    quads[..., 0:3] = cube
    quads[..., 3:6] = right
    quads[..., 6:9] = down
    quads[..., 9:12] = down_right
    return quads.reshape(faces * res * res, 16)


@functools.lru_cache(maxsize=8)
def _face_basis(device: torch.device) -> torch.Tensor:
    """(3, 6, 3) float32: the N, T and B rows of the six faces on
    `device` (copied there once per device)."""
    return torch.from_numpy(np.stack(
        [CUBE_FACES_N, CUBE_FACES_T, CUBE_FACES_B])).to(device)


def _cube_face_uv(direction: torch.Tensor):
    """Face selection and in-face coordinates of directions (..., 3), which
    need not be unit: (face int64, x, y) with x, y in [-1, 1]."""
    d = direction
    ax, ay, az = d[..., 0].abs(), d[..., 1].abs(), d[..., 2].abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= az)
    face = torch.where(
        is_x, (d[..., 0] < 0).long(),
        torch.where(is_y, 2 + (d[..., 1] < 0).long(),
                    4 + (d[..., 2] < 0).long()))
    basis = _face_basis(d.device)[:, face]            # (3, ..., 3)
    denom = (d * basis[0]).sum(dim=-1)
    denom = torch.where(denom.abs() < 1e-20, 1e-20, denom)
    x = (d * basis[1]).sum(dim=-1) / denom
    y = (d * basis[2]).sum(dim=-1) / denom
    return face, x, y


def sample_cube(cube: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Bilinear samplerCube lookup, clamp to edge: cube (6, R, R, 3),
    direction (..., 3) -> (..., 3)."""
    res = cube.shape[1]
    face, x, y = _cube_face_uv(direction)
    u = (x + 1.0) * 0.5 * res - 0.5
    v = (y + 1.0) * 0.5 * res - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]

    def clampi(i):
        return torch.clamp(i.to(torch.int64), 0, res - 1)

    u0i, u1i = clampi(u0), clampi(u0 + 1)
    v0i, v1i = clampi(v0), clampi(v0 + 1)
    c00 = cube[face, v0i, u0i]
    c10 = cube[face, v0i, u1i]
    c01 = cube[face, v1i, u0i]
    c11 = cube[face, v1i, u1i]
    top = c00 * (1 - fu) + c10 * fu
    bot = c01 * (1 - fu) + c11 * fu
    return top * (1 - fv) + bot * fv


def _quad_row(res, x, y):
    """Row index of the bilinear quad within a level of resolution `res`
    (an int or an int tensor) and the fractions (fu, fv) (..., 1), clamp to
    edge: a quad below the range collapses onto the edge texel by a zero
    fraction (the packed quad already clamps the far neighbours)."""
    resf = res.to(torch.float32) if isinstance(res, torch.Tensor) else res
    u = (x + 1.0) * 0.5 * resf - 0.5
    v = (y + 1.0) * 0.5 * resf - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = torch.where(u0 < 0, 0.0, u - u0)[..., None]
    fv = torch.where(v0 < 0, 0.0, v - v0)[..., None]
    u0i = torch.clamp(u0.to(torch.int64), 0).clamp(max=res - 1)
    v0i = torch.clamp(v0.to(torch.int64), 0).clamp(max=res - 1)
    return u0i, v0i, fu, fv


def _lerp_quad(row, fu, fv):
    top = row[..., 0:3] * (1 - fu) + row[..., 3:6] * fu
    bot = row[..., 6:9] * (1 - fu) + row[..., 9:12] * fu
    return top * (1 - fv) + bot * fv


def sample_cube_quads(quads: torch.Tensor, direction: torch.Tensor
                      ) -> torch.Tensor:
    """Bilinear samplerCube lookup over a pack_cube_quads table (one row
    per lookup); equal to sample_cube."""
    res = int(round((quads.shape[0] // 6) ** 0.5))
    face, x, y = _cube_face_uv(direction)
    u0i, v0i, fu, fv = _quad_row(res, x, y)
    return _lerp_quad(quads[(face * res + v0i) * res + u0i], fu, fv)


def pack_mips(mips, device: torch.device | str):
    """Pack a cube mip chain into one pool of quad rows so a trilinear
    lookup reads two rows, one per bracketing level.  Returns (data (N, 16),
    offsets (M,) int32, resolutions (M,) int32) on `device`."""
    offsets, sizes, chunks = [], [], []
    total = 0
    for cube in mips:
        cube = _host(cube)
        r = cube.shape[1]
        offsets.append(total)
        sizes.append(r)
        chunks.append(pack_cube_quads(cube))
        total += 6 * r * r
    return _tables(np.concatenate(chunks, axis=0), offsets, sizes, device)


def _host(cube) -> np.ndarray:
    if isinstance(cube, torch.Tensor):
        cube = cube.cpu().numpy()
    return np.asarray(cube, np.float32)


def _tables(data, offsets, sizes, device):
    return (torch.from_numpy(data).to(device),
            torch.tensor(offsets, dtype=torch.int32, device=device),
            torch.tensor(sizes, dtype=torch.int32, device=device))


def _sample_flat_level(data, offsets, sizes, level, face, x, y):
    """Bilinear fetch at integer mip `level` (an int64 tensor) given the
    face and in-face coordinates: one quad row and a lerp."""
    res = sizes[level].long()
    off = offsets[level].long()
    u0i, v0i, fu, fv = _quad_row(res, x, y)
    return _lerp_quad(data[off + (face * res + v0i) * res + u0i], fu, fv)


def _levels(sizes, lod):
    count = sizes.shape[0]
    lod = torch.clamp(lod, 0.0, count - 1)
    lo = torch.floor(lod).to(torch.int64)
    hi = torch.clamp(lo + 1, max=count - 1)
    frac = (lod - lo.to(torch.float32))[..., None]
    return lo, hi, frac


def sample_flat_mips(data, offsets, sizes, direction, lod):
    """Trilinear samplerCube lookup over a pack_mips pool."""
    face, x, y = _cube_face_uv(direction)
    lo, hi, frac = _levels(sizes, lod)
    a = _sample_flat_level(data, offsets, sizes, lo, face, x, y)
    c = _sample_flat_level(data, offsets, sizes, hi, face, x, y)
    return a * (1 - frac) + c * frac


# ---------------------------------------------------------------------------
# One-row trilinear: mip-pair rows (steeljax/env/cubemap.py:193-313).
# Row layout (48 f32):
#   [0:12]  the fine level's 2x2 bilinear quad (pack_cube_quads order)
#   [12:39] the coarse level's 3x3 block at base = ((fine_texel - 1) >> 1)
#           per axis, edge-clamped: the coarse quad starts at one of two
#           texels of it, depending on the sub-texel fraction
#   [39:48] pad
# ---------------------------------------------------------------------------

def pack_mips_tri(mips, device: torch.device | str):
    """Pack a cube mip chain into mip-pair rows for one-row trilinear.
    Returns (data (N, 48), offsets (M,), resolutions (M,)) on `device`,
    keyed as pack_mips (the last level pairs with itself; its coarse half
    carries zero weight)."""
    offsets, sizes, chunks = [], [], []
    total = 0
    count = len(mips)
    host = [_host(m) for m in mips]
    for m in range(count):
        fine = host[m]
        coarse = host[min(m + 1, count - 1)]
        rf = fine.shape[1]
        rc = coarse.shape[1]
        rows = np.zeros((6, rf, rf, 48), np.float32)
        rows[..., 0:12] = pack_cube_quads(fine).reshape(6, rf, rf, 16)[
            ..., 0:12]
        base = (np.arange(rf) - 1) >> 1
        for j in range(3):          # coarse v offset
            iv = np.clip(base + j, 0, rc - 1)
            for i in range(3):      # coarse u offset
                iu = np.clip(base + i, 0, rc - 1)
                sl = 12 + (j * 3 + i) * 3
                rows[..., sl:sl + 3] = coarse[:, iv[:, None], iu[None, :]]
        offsets.append(total)
        sizes.append(rf)
        chunks.append(rows.reshape(6 * rf * rf, 48))
        total += 6 * rf * rf
    return _tables(np.concatenate(chunks, axis=0), offsets, sizes, device)


def sample_flat_mips_tri(data, offsets, sizes, direction, lod):
    """Trilinear samplerCube lookup over a pack_mips_tri pool, one row per
    lookup; equal to sample_flat_mips."""
    face, x, y = _cube_face_uv(direction)
    lo, hi, frac = _levels(sizes, lod)
    res = sizes[lo].long()
    off = offsets[lo].long()
    u0i, v0i, fu, fv = _quad_row(res, x, y)
    row = data[off + (face * res + v0i) * res + u0i]     # (..., 48)
    fine = _lerp_quad(row, fu, fv)

    uc0i, vc0i, fuc, fvc = _quad_row(sizes[hi].long(), x, y)
    # The coarse quad's place in the packed 3x3 block: 0 or 1 by
    # construction when the coarse level is half the fine one, clipped for
    # the last level's weight-0 self-pair.
    pu = (torch.clamp(uc0i - ((u0i - 1) >> 1), 0, 1) == 1)[..., None]
    pv = (torch.clamp(vc0i - ((v0i - 1) >> 1), 0, 1) == 1)[..., None]

    def block(i, j):
        sl = 12 + (j * 3 + i) * 3
        return row[..., sl:sl + 3]

    def corner(i, j):
        """The texel (i, j) of the coarse quad inside the block."""
        return torch.where(
            pv, torch.where(pu, block(i + 1, j + 1), block(i, j + 1)),
            torch.where(pu, block(i + 1, j), block(i, j)))

    c00, c01, c10, c11 = corner(0, 0), corner(0, 1), corner(1, 0), \
        corner(1, 1)
    topc = c00 * (1 - fuc) + c10 * fuc
    botc = c01 * (1 - fuc) + c11 * fuc
    coarse = topc * (1 - fvc) + botc * fvc
    return fine * (1 - frac) + coarse * frac
