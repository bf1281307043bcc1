"""Ray queries by brute force: every ray against every triangle.

No acceleration structure, so nothing the program builds (its BVH, record
tables, coverage masks) enters the answer.  Each block of rays meets all
triangles in two stages:

1. a coarse test with the Moller-Trumbore quantities written as products
   of per-ray and per-triangle features (four small matrix products, with
   a margin of 1e-3 in the barycentrics and in t), which keeps every
   triangle the ray can hit;
2. the exact Moller-Trumbore test (the reference renderer's
   `accel/intersect.py`: back faces culled unless the triangle is
   double-sided, inclusive [t_min, t_max]) on those candidates alone, then
   the alpha test at the hit, and the nearest survivor (ties to the lower
   triangle index).

An alpha-tested hit whose coverage at (u, v) is below the material's
cutoff is skipped, so the nearest hit is the nearest opaque one, without a
bound on the surfaces skipped.
"""

from __future__ import annotations

import torch

from portbench.reference.scene import RefScene

_DET_EPS = 1e-12
_BARY_MARGIN = 1e-3
_T_MARGIN = 1e-3
# Ray-triangle pairs held at once by the coarse stage.
BLOCK_PAIRS = 1 << 26


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _dot(a, b):
    return (a * b).sum(dim=-1)


class Triangles:
    """Per-triangle features of the coarse stage, for one scene."""

    def __init__(self, scene: RefScene):
        self.scene = scene
        v0, e1, e2 = scene.v0, scene.e1, scene.e2
        n = _cross(e1, e2)
        self.det_b = (-n).T.contiguous()                              # (3, T)
        self.u_b = torch.cat([e2, -_cross(e2, v0)], dim=1).T.contiguous()
        self.v_b = torch.cat([-e1, -_cross(v0, e1)], dim=1).T.contiguous()
        self.t_b = torch.cat([n, -_dot(v0, n)[:, None]],
                             dim=1).T.contiguous()                    # (4, T)

    def candidates(self, o, d, t_min, t_max):
        """(ray, tri) index pairs of a block that may hit."""
        ones = torch.ones_like(o[:, :1])
        ray_a = torch.cat([_cross(o, d), d], dim=1)
        det = d @ self.det_b
        u = (ray_a @ self.u_b) / det
        v = (ray_a @ self.v_b) / det
        t = (torch.cat([o, ones], dim=1) @ self.t_b) / det
        slack = _T_MARGIN * (1.0 + t.abs())
        keep = ((det != 0) & (u >= -_BARY_MARGIN) & (v >= -_BARY_MARGIN)
                & (u + v <= 1.0 + _BARY_MARGIN)
                & (t >= t_min[:, None] - slack)
                & (t <= t_max[:, None] + slack))
        return keep.nonzero(as_tuple=True)


def _exact(o, d, v0, e1, e2, double_sided, t_min, t_max, cull):
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    solid = det.abs() > _DET_EPS
    facing = ((det > _DET_EPS) | (double_sided & solid)) if cull else solid
    inv_det = 1.0 / torch.where(solid, det, torch.ones_like(det))
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = (facing & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= t_min) & (t <= t_max))
    return t, u, v, hit


def sample_texture(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear, repeat-wrapped read of an (H, W, 4) texture at level 0:
    the ray-tracing stages' implicit lod 0."""
    h, w = tex.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi = torch.remainder(x0.long(), w)
    yi = torch.remainder(y0.long(), h)
    x1 = (xi + 1) % w
    y1 = (yi + 1) % h
    top = tex[yi, xi] * (1.0 - fx) + tex[yi, x1] * fx
    bot = tex[y1, xi] * (1.0 - fx) + tex[y1, x1] * fx
    return top * (1.0 - fy) + bot * fy


def interpolate(values: torch.Tensor, u, v) -> torch.Tensor:
    """Barycentric blend of (N, 3, C) vertex values at (u, v)."""
    w = (1.0 - u - v)[..., None]
    return values[:, 0] * w + values[:, 1] * u[..., None] \
        + values[:, 2] * v[..., None]


def base_texel(scene: RefScene, tri, u, v) -> torch.Tensor:
    """(N, 4) base-colour texture read at the hits; 1 where the material has
    no base texture."""
    out = torch.ones(tri.shape + (4,), dtype=scene.dtype, device=tri.device)
    tex = scene.base_tex[scene.mat[tri]]
    uv = interpolate(scene.uv[tri], u, v)
    for k, texture in enumerate(scene.textures):
        sel = tex == k
        if bool(sel.any()):
            out[sel] = sample_texture(texture, uv[sel])
    return out


def opaque(scene: RefScene, tri, u, v) -> torch.Tensor:
    """False where an alpha-tested material's coverage at (u, v) is below
    its cutoff (AnyHit.rahit:35-52)."""
    mat = scene.mat[tri]
    keep = torch.ones_like(tri, dtype=torch.bool)
    tested = scene.alpha_test[mat]
    if not scene.any_alpha_test or not bool(tested.any()):
        return keep
    idx = tested.nonzero(as_tuple=True)[0]
    alpha = scene.base_color[mat[idx], 3] * base_texel(
        scene, tri[idx], u[idx], v[idx])[:, 3]
    keep[idx] = alpha >= scene.alpha_cutoff[mat[idx]]
    return keep


def nearest(tris: Triangles, o, d, t_min, t_max, cull: bool) -> dict:
    """The nearest opaque hit of each ray: {"hit", "t", "u", "v", "tri"};
    rays with t_max < t_min are misses and cost nothing."""
    scene = tris.scene
    n = o.shape[0]
    dtype, device = o.dtype, o.device
    out = {"hit": torch.zeros(n, dtype=torch.bool, device=device),
           "t": torch.full((n,), -1.0, dtype=dtype, device=device),
           "u": torch.zeros(n, dtype=dtype, device=device),
           "v": torch.zeros(n, dtype=dtype, device=device),
           "tri": torch.zeros(n, dtype=torch.int64, device=device)}
    live = (t_max >= t_min).nonzero(as_tuple=True)[0]
    block = max(1, BLOCK_PAIRS // max(scene.triangle_count, 1))
    inf = torch.tensor(float("inf"), dtype=dtype, device=device)
    for start in range(0, live.shape[0], block):
        rays = live[start:start + block]
        ro, rd, rmin, rmax = o[rays], d[rays], t_min[rays], t_max[rays]
        ray, tri = tris.candidates(ro, rd, rmin, rmax)
        if ray.shape[0] == 0:
            continue
        t, u, v, hit = _exact(ro[ray], rd[ray], scene.v0[tri],
                              scene.e1[tri], scene.e2[tri],
                              scene.double_sided[tri], rmin[ray], rmax[ray],
                              cull)
        ok = hit.clone()
        if scene.any_alpha_test:
            ok[hit] = opaque(scene, tri[hit], u[hit], v[hit])
        t_ok = torch.where(ok, t, inf)
        best = torch.full((rays.shape[0],), float("inf"), dtype=dtype,
                          device=device).scatter_reduce(
            0, ray, t_ok, reduce="amin")
        at_best = ok & (t_ok == best[ray])
        big = torch.iinfo(torch.int64).max
        best_tri = torch.full((rays.shape[0],), big, dtype=torch.int64,
                              device=device).scatter_reduce(
            0, ray[at_best], tri[at_best], reduce="amin")
        win = at_best & (tri == best_tri[ray])
        slot = rays[ray[win]]
        out["hit"][slot] = True
        out["t"][slot] = t[win]
        out["u"][slot] = u[win]
        out["v"][slot] = v[win]
        out["tri"][slot] = tri[win]
    return out


def occluded(tris: Triangles, o, d, t_min, t_max) -> torch.Tensor:
    """Any opaque hit in [t_min, t_max], back faces counted (the shadow
    ray's query)."""
    return nearest(tris, o, d, t_min, t_max, cull=False)["hit"]
