"""Moller-Trumbore ray/triangle intersection (batched, fp32).

Port of steeljax/accel/intersect.py.  Backface culling follows
gl_RayFlagsCullBackFacingTrianglesEXT semantics with the per-instance
facing-cull-disable of double-sided materials: a back hit (det < 0)
survives only when culling is off for the ray or the triangle is
double-sided.

The reference intersects one ray with K triangles under vmap; here n rays
each meet their own K candidates.  The operations come in the reference's
order (the cross products, then the three-term dot products), each rounded
as XLA's CPU backend rounds the reference's walk: the cross products'
terms and the direction's dot with qvec as fused multiply-adds, the other
dots summed left to right.  So the walk (accel.traverse) gives the
reference's bits on the CPU, and, each step being a separate tensor op,
the same bits on the card.
"""

from __future__ import annotations

import torch

_DET_EPS = 1e-12


def _fma(a, b, c):
    """fma(a, b, c) in float32: a float32 product is exact in float64, so
    the float64 sum rounded to float32 is the fused result."""
    return (a.double() * b.double() + c.double()).float()


# Each component's two factors of a cross product: (a x b)_i =
# a[_NEXT]_i b[_PREV]_i - a[_PREV]_i b[_NEXT]_i.
_NEXT = [1, 2, 0]
_PREV = [2, 0, 1]


def _cross(a, b):
    """a x b over the last axis, each component fma(a_j, b_k, -(a_k b_j))
    as XLA's CPU backend contracts the reference's jnp.cross."""
    return _fma(a[..., _NEXT], b[..., _PREV], -(a[..., _PREV] * b[..., _NEXT]))


def _dot(a, b):
    """The "kc,kc->k" einsum: products summed left to right."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _dot_fused(a, b):
    """The "c,kc->k" einsum: a chain of fused multiply-adds."""
    return _fma(a[..., 2], b[..., 2],
                _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def intersect(origin: torch.Tensor, direction: torch.Tensor,
              v0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor,
              double_sided: torch.Tensor, t_min: torch.Tensor,
              t_max: torch.Tensor, cull_backface: bool):
    """Intersect n rays with K triangles each.

    origin/direction: (n, 3); v0/e1/e2: (n, K, 3) (or broadcastable, such
    as (1, K, 3)); double_sided: (n, K) bool; t_min/t_max: (n,).  Returns
    (t, u, v, hit), each (n, K)."""
    d = direction[:, None, :]
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    solid = det.abs() > _DET_EPS
    if cull_backface:
        facing_ok = (det > _DET_EPS) | (double_sided & solid)
    else:
        facing_ok = solid
    inv_det = 1.0 / torch.where(solid, det, 1.0)
    tvec = origin[:, None, :] - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot_fused(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = (facing_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= t_min[:, None]) & (t <= t_max[:, None]))
    return t, u, v, hit
