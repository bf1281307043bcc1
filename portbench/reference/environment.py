"""The hybrid frame's environment, baked again from the procedural sky.

Frozen copies of the port's `steeljax_torch/env/sky.py`
(`procedural_sky_cube`), `env/cubemap.py` (`face_directions`,
`sample_cube`) and `env/ibl.py` (`generate_irradiance_cube`,
`generate_reflection_mips`, `fit_cube_sh`, `sh_basis`, `eval_cube_sh`), as
they stood when the benchmark was written (Irradiance.comp,
Reflection.comp, the reference's least-squares SH fit), at
`load_environment`'s default budgets.  The reflection prefilter reads the
source chain with a trilinear clamp-to-edge cube lookup, which the port's
packed mip rows reproduce.  Everything runs in the dtype given: float32 is
the reference, a lower precision the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import brdf as brdf_lib
from portbench.reference.path import (_GROUND_COLOR, _HORIZON_COLOR,
                                      _SKY_SCALE, _SUN_COLOR,
                                      _SUN_COS_RADIUS, _SUN_DIRECTION,
                                      _SUN_RADIANCE, _ZENITH_COLOR)

PI = brdf_lib.PI
MAX_LUMINANCE = 25.0
STEP_ELEMENTS = 1 << 22
_X = np.array([1.0, 0.0, 0.0], np.float32)
_Y = np.array([0.0, 1.0, 0.0], np.float32)
_Z = np.array([0.0, 0.0, 1.0], np.float32)
FACES_N = np.array([_X, -_X, _Y, -_Y, _Z, -_Z], np.float32)
FACES_T = np.array([-_Z, _Z, _X, _X, _X, -_X], np.float32)
FACES_B = np.array([-_Y, -_Y, _Z, -_Z, -_Y, -_Y], np.float32)


def face_directions(resolution: int) -> np.ndarray:
    texel = (np.arange(resolution, dtype=np.float32) + 0.5) / resolution
    x, y = np.meshgrid(texel * 2.0 - 1.0, texel * 2.0 - 1.0, indexing="xy")
    dirs = (FACES_N[:, None, None, :] + x[None, :, :, None]
            * FACES_T[:, None, None, :] + y[None, :, :, None]
            * FACES_B[:, None, None, :])
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs.astype(np.float32)


def sky_cube(resolution: int) -> np.ndarray:
    dirs = face_directions(resolution)
    y = dirs[..., 1]
    sun = _SUN_DIRECTION
    t = np.clip(y, 0.0, 1.0) ** 0.45
    sky = ((1.0 - t[..., None]) * np.asarray(_HORIZON_COLOR, np.float32)
           + t[..., None] * np.asarray(_ZENITH_COLOR, np.float32)) \
        * _SKY_SCALE
    below = np.clip(-y, 0.0, 1.0) ** 0.5
    color = sky * (1.0 - below[..., None]) \
        + np.asarray(_GROUND_COLOR, np.float32) * below[..., None]
    cos_sun = (dirs[..., 0] * sun[0] + dirs[..., 1] * sun[1]
               + dirs[..., 2] * sun[2])
    disk = (cos_sun > _SUN_COS_RADIUS).astype(np.float32)
    halo = np.clip((cos_sun - 0.995) / 0.005, 0.0, 1.0) ** 8
    return (color + (disk * _SUN_RADIANCE + halo * 2.0)[..., None]
            * np.asarray(_SUN_COLOR, np.float32)).astype(np.float32)


def _face_uv(d: torch.Tensor):
    ax, ay, az = d[..., 0].abs(), d[..., 1].abs(), d[..., 2].abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= az)
    face = torch.where(
        is_x, (d[..., 0] < 0).long(),
        torch.where(is_y, 2 + (d[..., 1] < 0).long(),
                    4 + (d[..., 2] < 0).long()))
    basis = torch.from_numpy(np.stack([FACES_N, FACES_T, FACES_B])).to(
        device=d.device, dtype=d.dtype)[:, face]
    denom = (d * basis[0]).sum(dim=-1)
    denom = torch.where(denom.abs() < 1e-20, torch.full_like(denom, 1e-20),
                        denom)
    return face, (d * basis[1]).sum(dim=-1) / denom, \
        (d * basis[2]).sum(dim=-1) / denom


def sample_cube(cube: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Bilinear cube lookup, clamp to edge."""
    res = cube.shape[1]
    face, x, y = _face_uv(direction)
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
    top = cube[face, v0i, u0i] * (1 - fu) + cube[face, v0i, u1i] * fu
    bot = cube[face, v1i, u0i] * (1 - fu) + cube[face, v1i, u1i] * fu
    return top * (1 - fv) + bot * fv


def sample_mips(mips: tuple, direction: torch.Tensor,
                lod: torch.Tensor) -> torch.Tensor:
    """Trilinear lookup over a mip chain: the two bracketing levels."""
    count = len(mips)
    lod = torch.clamp(lod, 0.0, count - 1)
    lo = torch.floor(lod).to(torch.int64)
    hi = torch.clamp(lo + 1, max=count - 1)
    frac = (lod - lo.to(lod.dtype))[..., None]
    a = torch.zeros(direction.shape[:-1] + (3,), dtype=direction.dtype,
                    device=direction.device)
    c = torch.zeros_like(a)
    for m, cube in enumerate(mips):
        s = sample_cube(cube, direction)
        a = torch.where((lo == m)[..., None], s, a)
        c = torch.where((hi == m)[..., None], s, c)
    return a * (1 - frac) + c * frac


def _batches(count: int, texels: int):
    step = max(1, STEP_ELEMENTS // max(texels, 1))
    return [(s, min(s + step, count)) for s in range(0, count, step)]


def _texel_dirs(resolution: int, device, dtype) -> torch.Tensor:
    return torch.from_numpy(face_directions(resolution).reshape(-1, 3)).to(
        device=device, dtype=dtype)


def hammersley(count: int) -> np.ndarray:
    i = np.arange(count, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    e1 = np.mod(i.astype(np.float64) / count, 1.0)
    e2 = bits.astype(np.float64) * 2.3283064365386963e-10
    return np.stack([e1, e2], -1).astype(np.float32)


def irradiance_cube(env: torch.Tensor, resolution: int,
                    sample_delta: float) -> torch.Tensor:
    """Irradiance.comp: a hemisphere Riemann sum per texel."""
    device, dtype = env.device, env.dtype
    dirs = _texel_dirs(resolution, device, dtype)
    t, b, n = brdf_lib.make_tbn(dirs)
    phi = np.arange(0.0, 2.0 * np.pi, sample_delta)
    theta = np.arange(0.0, 0.5 * np.pi, sample_delta)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    tangent = torch.from_numpy(np.stack(
        [np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)],
        axis=-1).reshape(-1, 3).astype(np.float32)).to(device=device,
                                                        dtype=dtype)
    cos_sin = torch.from_numpy((np.cos(tt) * np.sin(tt)).reshape(-1).astype(
        np.float32)).to(device=device, dtype=dtype)
    count = tangent.shape[0]
    acc = torch.zeros_like(dirs)
    for start, end in _batches(count, dirs.shape[0]):
        td = tangent[start:end, None, :]
        world = td[..., 0:1] * t + td[..., 1:2] * b + td[..., 2:3] * n
        acc = acc + (sample_cube(env, world)
                     * cos_sin[start:end, None, None]).sum(dim=0)
    return (PI * acc / count).reshape(6, resolution, resolution, 3)


def cube_mips(cube: torch.Tensor) -> tuple:
    mips = [cube]
    while mips[-1].shape[1] > 1:
        f, r, _, c = mips[-1].shape
        half = r // 2
        mips.append(mips[-1].reshape(f, half, 2, half, 2, c).mean(
            dim=(2, 4)))
    return tuple(mips)


def reflection_mips(env: torch.Tensor, resolution: int,
                    sample_count: int) -> tuple:
    """Reflection.comp: mip m GGX-prefiltered at roughness m / (mips - 1),
    each sample read trilinearly from the source chain at the lod of its
    solid angle, its luminance clamped."""
    device, dtype = env.device, env.dtype
    source = cube_mips(env)
    mip_count = int(np.log2(resolution)) + 1
    xi_all = torch.from_numpy(hammersley(sample_count)).to(device=device,
                                                           dtype=dtype)
    out = []
    for m in range(mip_count):
        res = max(resolution >> m, 1)
        roughness = m / max(mip_count - 1, 1)
        a = roughness * roughness
        a2 = torch.full((), max(a * a, 1e-6), dtype=dtype, device=device)
        sa_texel = 4.0 * PI / (6.0 * res * res)
        dirs = _texel_dirs(res, device, dtype)
        t, b, n = brdf_lib.make_tbn(dirs)
        acc_r = torch.zeros_like(dirs)
        acc_w = torch.zeros(dirs.shape[:-1] + (1,), dtype=dtype,
                            device=device)
        for start, end in _batches(sample_count, dirs.shape[0]):
            e = xi_all[start:end, None, :].expand(end - start,
                                                  dirs.shape[0], 2)
            h_t = brdf_lib.importance_sample_ggx(e, a2)
            h = h_t[..., 0:1] * t + h_t[..., 1:2] * b + h_t[..., 2:3] * n
            voh = (dirs * h).sum(dim=-1)
            l = 2.0 * voh[..., None] * h - dirs
            nol = torch.clamp((dirs * l).sum(dim=-1), min=0.0)
            noh = torch.clamp((dirs * h).sum(dim=-1), min=0.0)
            voh = torch.clamp(voh, min=0.0)
            pdf = brdf_lib.specular_pdf(noh, a2, voh)
            sa_sample = 1.0 / (sample_count * pdf + 1e-6)
            if roughness == 0.0:
                lod = torch.zeros_like(pdf)
            else:
                lod = 0.5 * torch.log2(sa_sample / sa_texel)
            radiance = sample_mips(source, l, lod)
            radiance = radiance / torch.clamp(
                brdf_lib.luminance(radiance)[..., None] / MAX_LUMINANCE,
                min=1.0)
            weight = nol[..., None]
            acc_r = acc_r + (radiance * weight).sum(dim=0)
            acc_w = acc_w + weight.sum(dim=0)
        out.append((acc_r / torch.clamp(acc_w, min=1e-8)).reshape(
            6, res, res, 3))
    return tuple(out)


def sh_basis(dirs: torch.Tensor, order: int) -> torch.Tensor:
    """Real SH basis at unit directions, bands 0..order-1."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    one = torch.ones_like(z)
    a = [one]
    b = [torch.zeros_like(z)]
    for m in range(1, order):
        am, bm = a[m - 1], b[m - 1]
        a.append(x * am - y * bm)
        b.append(x * bm + y * am)
    q = [[one]]
    for l in range(1, order):
        row = [None] * (l + 1)
        row[l] = q[l - 1][l - 1] * float(1 - 2 * l)
        row[l - 1] = z * q[l - 1][l - 1] * float(2 * l - 1)
        for m in range(l - 2, -1, -1):
            row[m] = ((float(2 * l - 1) * z * q[l - 1][m]
                       - float(l + m - 1) * q[l - 2][m]) / float(l - m))
        q.append(row)
    out = []
    for l in range(order):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt((2 * l + 1) / (4.0 * math.pi)
                             * math.factorial(l - am)
                             / math.factorial(l + am))
            if m != 0:
                norm *= math.sqrt(2.0)
            base = q[l][am]
            val = base * b[am] if m < 0 else base * a[am] if m > 0 else base
            out.append(val * float(np.float32(norm)))
    return torch.stack(out, dim=-1)


def fit_sh(cube: torch.Tensor, max_order: int = 8, rel_tol: float = 0.005,
           noise_cap: float = 0.04):
    """Weighted least-squares SH fit (host float64): the smallest order
    whose RMS residual passes the gate, or None."""
    cube = cube.float().cpu().numpy()
    res = cube.shape[1]
    dirs = torch.from_numpy(face_directions(res).reshape(-1, 3))
    vals = cube.reshape(-1, 3).astype(np.float64)
    texel = (np.arange(res, dtype=np.float64) + 0.5) / res * 2.0 - 1.0
    gx, gy = np.meshgrid(texel, texel, indexing="xy")
    w = np.tile(((1.0 + gx * gx + gy * gy) ** -1.5).reshape(-1), 6)
    scale = float(np.abs(vals).mean() + 1e-12)
    c64 = cube.astype(np.float64)
    lap = 0.5 * (np.abs(np.diff(c64, n=2, axis=1)).mean()
                 + np.abs(np.diff(c64, n=2, axis=2)).mean())
    floor = max(rel_tol, min(lap / scale, noise_cap))
    for order in range(2, max_order + 1):
        basis = sh_basis(dirs, order).numpy().astype(np.float64)
        bw = basis * w[:, None]
        coeffs, *_ = np.linalg.lstsq(bw.T @ basis, bw.T @ vals, rcond=None)
        fit = np.maximum(basis @ coeffs, 0.0)
        err = float(np.sqrt(((fit - vals) ** 2).mean()) / scale)
        if err <= floor:
            return coeffs.astype(np.float32)
    return None


class Environment:
    """The default environment's bakes: the procedural sky at
    `cube_resolution`, its irradiance (an SH fit where the gate accepts
    one, else the cube) and the prefiltered reflection chain."""

    def __init__(self, device, dtype, cube_resolution: int = 256,
                 irradiance_resolution: int = 64,
                 reflection_resolution: int = 256,
                 reflection_samples: int = 2048,
                 irradiance_delta: float = 0.025):
        cube = torch.from_numpy(sky_cube(cube_resolution)).to(
            device=device, dtype=dtype)
        self.dtype = dtype
        self.reflection = reflection_mips(cube, reflection_resolution,
                                          reflection_samples)
        self.irradiance = irradiance_cube(cube, irradiance_resolution,
                                          irradiance_delta)
        coeffs = fit_sh(self.irradiance)
        self.sh = None if coeffs is None else torch.from_numpy(coeffs).to(
            device=device, dtype=dtype)

    def irradiance_at(self, direction: torch.Tensor) -> torch.Tensor:
        if self.sh is None:
            return sample_cube(self.irradiance, direction)
        order = int(round(float(self.sh.shape[0]) ** 0.5))
        d = direction / torch.clamp(torch.linalg.vector_norm(
            direction, dim=-1, keepdim=True), min=1e-20)
        return torch.clamp(sh_basis(d, order) @ self.sh, min=0.0)
