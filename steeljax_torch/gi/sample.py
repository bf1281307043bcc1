"""Runtime light-volume sampling: tetrahedral walk + SH irradiance.

Port of steeljax/gi/sample.py (SampleLightVolume, Lighting.glsl:104-182):
starting from tet 0, compute barycentric coordinates via the per-tet
inverse matrix, hop across the face of the most negative coordinate to
that face's neighbour, stop when inside (all coords >= 0), when stepping
outside the hull (-1 neighbour -> black, matching the reference), or when
ping-ponging between two tets.  The SH coefficients of the 4 corner
probes interpolate barycentrically before the Ramamoorthi evaluation.

The reference runs a bounded while_loop per point under vmap.  Here the
walk is MAX_WALK_STEPS masked steps over all points at once: a point that
has stopped keeps its state, and the loop never asks the host whether
every point has stopped, so a frame does not synchronize.
"""

from __future__ import annotations

import torch

from steeljax_torch.gi.sh import eval_irradiance

MAX_WALK_STEPS = 64


def _bary(lv, tet: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(N, 4) barycentric coordinates of points p (N, 3) in tets (N,).

    A point on a face or at a probe sits where a coordinate's sign is
    decided by its last bit, and with it the walk's path and whether the
    point counts as outside the hull.  So each row of B^-1 (p - d) is
    rounded as the reference's float32 dot rounds it, a chain of fused
    multiply-adds fma(m2, v2, fma(m1, v1, m0 * v0)): a float32 product is
    exact in float64, so each step is one float64 multiply-add rounded to
    float32.  The fourth coordinate sums left to right, as the reference
    does."""
    d = lv.positions[lv.tet_vertices[tet, 3].long()]
    m = lv.tet_matrices[tet].double()                       # (N, 3, 3)
    v = (p - d).double()[:, None, :]                        # (N, 1, 3)
    uvw = (m[..., 0] * v[..., 0]).float()
    for k in (1, 2):
        uvw = (m[..., k] * v[..., k] + uvw.double()).float()
    rest = 1.0 - ((uvw[:, 0] + uvw[:, 1]) + uvw[:, 2])
    return torch.cat([uvw, rest[:, None]], dim=-1)


def _find_tet(lv, p: torch.Tensor):
    """Walk every point to its containing tet; returns (tet, bary, valid)
    with tet clamped to 0 where the walk left the hull (valid False)."""
    n = p.shape[0]
    tet = torch.zeros((n,), dtype=torch.int64, device=p.device)
    prev = torch.zeros_like(tet)
    done = torch.zeros((n,), dtype=torch.bool, device=p.device)
    neighbors = lv.tet_neighbors.long()
    for _ in range(MAX_WALK_STEPS):
        # A point that walked off the hull holds tet -1 (and is done): its
        # lookups read tet 0 and are discarded.
        here = tet.clamp(min=0)
        bary = _bary(lv, here, p)
        worst = bary.argmin(dim=-1)
        inside = bary.gather(-1, worst[:, None])[:, 0] >= 0.0
        nxt = neighbors[here, worst]
        stop = inside | (nxt == prev) | (nxt < 0)
        new_tet = torch.where(stop, tet, nxt)
        new_prev = torch.where(stop, prev, tet)
        # Walking off the hull means "no data" (Lighting.glsl:140-147).
        new_tet = torch.where(~inside & (nxt < 0), -1, new_tet)
        tet = torch.where(done, tet, new_tet)
        prev = torch.where(done, prev, new_prev)
        done = done | stop
    valid = tet >= 0
    tet_safe = tet.clamp(min=0)
    bary = _bary(lv, tet_safe, p)
    # Ping-pong/step-limit endings can leave slightly negative
    # coordinates; clamp + renormalize instead of extrapolating (the
    # reference's choice, more robust than the GLSL for sliver tets).
    bary = torch.clamp(bary, min=0.0)
    total = ((bary[:, 0] + bary[:, 1]) + bary[:, 2]) + bary[:, 3]
    bary = bary / torch.clamp(total, min=1e-8)[:, None]
    return tet_safe, bary, valid


def sample_light_volume(lv, position: torch.Tensor,
                        n: torch.Tensor) -> torch.Tensor:
    """Irradiance at (position, normal) batches (N, 3) -> (N, 3), on the
    volume's device."""
    if lv.tet_vertices.shape[0] == 0:
        return torch.zeros(position.shape[:-1] + (3,), dtype=torch.float32,
                           device=position.device)
    tet, bary, valid = _find_tet(lv, position)
    verts = lv.tet_vertices[tet].long()                 # (N, 4)
    blended = bary[:, 0, None, None] * lv.coefficients[verts[:, 0]]
    for k in range(1, 4):
        blended = blended + bary[:, k, None, None] * lv.coefficients[
            verts[:, k]]
    # SH-9 ringing can go negative; irradiance is non-negative.
    irr = torch.clamp(eval_irradiance(blended, n), min=0.0)
    return torch.where(valid[:, None], irr, 0.0)
