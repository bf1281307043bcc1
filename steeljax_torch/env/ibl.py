"""Image-based lighting bakes: the split-sum BRDF LUT, the irradiance cube,
the prefiltered reflection mip chain and the least-squares SH fit of the
irradiance cube.

Port of steeljax/env/ibl.py:35-434, the same math and sample budgets:

* SpecularLut.comp:27-68: (NoV, roughness) scale/offset over Hammersley
  GGX samples;
* Irradiance.comp:31-63: a per-texel hemisphere Riemann sum with step
  `sample_delta`, irradiance = PI * sum / count;
* Reflection.comp:35-85: a per-mip GGX prefilter (N = V = R) with
  solid-angle mip selection and the luminance clamp MAX_LUMINANCE.

The reference sums each bake sample by sample in fixed segments; here a
segment is a batch of samples taken together over all texels, sized so a
step holds about STEP_ELEMENTS (texel, sample) pairs, so the default
budgets (256-texel reflection at 2,048 samples, a 256x256 LUT at 4,096)
fit in memory.  Sums over a batch run in another order than the
reference's sequential ones: the bakes agree to float32 rounding.
`fit_cube_sh` is host numpy, as in the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from steeljax_torch.core.colors import luminance
from steeljax_torch.core.constants import PI
from steeljax_torch.env.cubemap import (face_directions, pack_mips,
                                        sample_cube, sample_flat_mips)
from steeljax_torch.render.pt.brdf import (importance_sample_ggx, make_tbn,
                                           specular_pdf, vis_schlick)

MAX_LUMINANCE = 25.0
# (texel, sample) pairs evaluated together in one step of a bake.
STEP_ELEMENTS = 1 << 22


def _hammersley(count: int) -> np.ndarray:
    """Radical-inverse point set (MonteCarlo.glsl:12-28), host-side."""
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


def _batches(count: int, texels: int):
    """(start, end) sample ranges of the bake steps."""
    step = max(1, STEP_ELEMENTS // max(texels, 1))
    return [(s, min(s + step, count)) for s in range(0, count, step)]


def specular_brdf_lut(resolution: int = 256, sample_count: int = 4096, *,
                      device: torch.device | str) -> torch.Tensor:
    """(R, R, 2) split-sum scale/offset table on `device`; u = NoV,
    v = roughness."""
    texel = (torch.arange(resolution, dtype=torch.float32, device=device)
             + 0.5) / resolution
    rough, nov = torch.meshgrid(texel, texel, indexing="ij")
    nov = nov.reshape(-1)          # u axis
    rough = rough.reshape(-1)      # v axis (row index)
    v = torch.stack([torch.sqrt(torch.clamp(1.0 - nov * nov, min=0.0)),
                     torch.zeros_like(nov), nov], dim=-1)
    a = rough * rough
    a2 = a * a
    xi = torch.from_numpy(_hammersley(sample_count)).to(device)
    scale = torch.zeros_like(nov)
    offset = torch.zeros_like(nov)
    for start, end in _batches(sample_count, nov.shape[0]):
        e = xi[start:end, None, :].expand(end - start, nov.shape[0], 2)
        h = importance_sample_ggx(e, a2)
        voh_raw = (v * h).sum(dim=-1)
        l = 2.0 * voh_raw[..., None] * h - v
        nol = torch.clamp(l[..., 2], min=0.0)
        noh = torch.clamp(h[..., 2], min=0.0)
        voh = torch.clamp(voh_raw, min=0.0)
        vis = vis_schlick(a, nov, nol)
        vis_nol_pdf = torch.where(
            nol > 0.0,
            vis * nol * (4.0 * voh / torch.clamp(noh, min=1e-8)), 0.0)
        fc = (1.0 - voh) ** 5
        scale = scale + ((1.0 - fc) * vis_nol_pdf).sum(dim=0)
        offset = offset + (fc * vis_nol_pdf).sum(dim=0)
    lut = torch.stack([scale, offset], dim=-1) / sample_count
    return lut.reshape(resolution, resolution, 2)


def pack_lut_quads(lut) -> torch.Tensor:
    """Pack the (R, R, 2) LUT into bilinear quad rows (R*R, 8):
    [c00, c10, c01, c11] with clamped edge neighbours, on the LUT's device
    (the CPU for an array)."""
    device = lut.device if isinstance(lut, torch.Tensor) else "cpu"
    if isinstance(lut, torch.Tensor):
        lut = lut.cpu().numpy()
    lut = np.asarray(lut, np.float32)
    r = lut.shape[0]
    nxt = np.minimum(np.arange(r) + 1, r - 1)
    out = np.zeros((r, r, 8), np.float32)
    out[..., 0:2] = lut
    out[..., 2:4] = lut[:, nxt]
    out[..., 4:6] = lut[nxt]
    out[..., 6:8] = lut[nxt][:, nxt]
    return torch.from_numpy(out.reshape(r * r, 8)).to(device)


def sample_lut_quads(quads: torch.Tensor, nov: torch.Tensor,
                     roughness: torch.Tensor) -> torch.Tensor:
    """Bilinear clamp-sample over a pack_lut_quads table; equal to
    sample_lut."""
    r = int(round(quads.shape[0] ** 0.5))
    x = torch.clamp(nov, 0.0, 1.0) * r - 0.5
    y = torch.clamp(roughness, 0.0, 1.0) * r - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = torch.where(x0 < 0, 0.0, x - x0)[..., None]
    fy = torch.where(y0 < 0, 0.0, y - y0)[..., None]
    x0i = torch.clamp(x0.to(torch.int64), 0, r - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, r - 1)
    row = quads[y0i * r + x0i]
    top = row[..., 0:2] * (1 - fx) + row[..., 2:4] * fx
    bot = row[..., 4:6] * (1 - fx) + row[..., 6:8] * fx
    return top * (1 - fy) + bot * fy


def sample_lut(lut: torch.Tensor, nov: torch.Tensor,
               roughness: torch.Tensor) -> torch.Tensor:
    """Bilinear clamp-sample of the (R, R, 2) LUT at (NoV, roughness)."""
    r = lut.shape[0]
    x = torch.clamp(nov, 0.0, 1.0) * r - 0.5
    y = torch.clamp(roughness, 0.0, 1.0) * r - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def cl(i):
        return torch.clamp(i.to(torch.int64), 0, r - 1)

    c00 = lut[cl(y0), cl(x0)]
    c10 = lut[cl(y0), cl(x0 + 1)]
    c01 = lut[cl(y0 + 1), cl(x0)]
    c11 = lut[cl(y0 + 1), cl(x0 + 1)]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def _texel_dirs(resolution: int, device) -> torch.Tensor:
    return torch.from_numpy(
        face_directions(resolution).reshape(-1, 3)).to(device)


def generate_irradiance_cube(env: torch.Tensor, resolution: int = 64,
                             sample_delta: float = 0.025) -> torch.Tensor:
    """Diffuse irradiance cubemap (Irradiance.comp) of a (6, R, R, 3) cube,
    on the cube's device."""
    device = env.device
    dirs = _texel_dirs(resolution, device)
    t, b, n = make_tbn(dirs)                        # (P, 3) each
    phi = np.arange(0.0, 2.0 * np.pi, sample_delta)
    theta = np.arange(0.0, 0.5 * np.pi, sample_delta)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    tangent = torch.from_numpy(np.stack(
        [np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)],
        axis=-1).reshape(-1, 3).astype(np.float32)).to(device)
    cos_sin = torch.from_numpy((np.cos(tt) * np.sin(tt)).reshape(-1).astype(
        np.float32)).to(device)
    count = tangent.shape[0]
    acc = torch.zeros_like(dirs)
    for start, end in _batches(count, dirs.shape[0]):
        td = tangent[start:end, None, :]             # (S, 1, 3)
        world = td[..., 0:1] * t + td[..., 1:2] * b + td[..., 2:3] * n
        acc = acc + (sample_cube(env, world)
                     * cos_sin[start:end, None, None]).sum(dim=0)
    irradiance = PI * acc / count
    return irradiance.reshape(6, resolution, resolution, 3)


def downsample_cube(cube: torch.Tensor) -> torch.Tensor:
    """2x2 box filter per face (the reference's runtime mip blits)."""
    f, r, _, c = cube.shape
    if r == 1:
        return cube
    half = r // 2
    return cube.reshape(f, half, 2, half, 2, c).mean(dim=(2, 4))


def build_cube_mips(cube: torch.Tensor) -> tuple:
    mips = [cube]
    while mips[-1].shape[1] > 1:
        mips.append(downsample_cube(mips[-1]))
    return tuple(mips)


def sample_cube_lod(mips: tuple, direction: torch.Tensor,
                    lod: torch.Tensor) -> torch.Tensor:
    """Trilinear cubemap lookup across a mip tuple (textureLod): every
    level is sampled and blended with its trilinear weight."""
    count = len(mips)
    lod = torch.clamp(lod, 0.0, count - 1)
    lo = torch.floor(lod)
    frac = (lod - lo)[..., None]
    lo = lo[..., None]
    result = torch.zeros(direction.shape[:-1] + (3,), dtype=torch.float32,
                         device=direction.device)
    for m, cube in enumerate(mips):
        s = sample_cube(cube, direction)
        w_lo = torch.where(lo == m, 1.0 - frac, 0.0)
        w_hi = torch.where(lo == m - 1, frac, 0.0)
        result = result + s * (w_lo + w_hi)
    return result


def generate_reflection_mips(env: torch.Tensor, resolution: int = 256,
                             sample_count: int = 2048) -> tuple:
    """Prefiltered specular reflection chain (Reflection.comp) on the
    cube's device: mip m is filtered at roughness m / (mips - 1), each
    sample reading the source's packed mip chain trilinearly."""
    device = env.device
    flat_data, flat_offsets, flat_sizes = pack_mips(build_cube_mips(env),
                                                    device)
    mip_count = int(np.log2(resolution)) + 1
    xi_all = torch.from_numpy(_hammersley(sample_count)).to(device)
    out = []
    for m in range(mip_count):
        res = max(resolution >> m, 1)
        roughness = m / max(mip_count - 1, 1)
        a = roughness * roughness
        a2 = torch.full((), max(a * a, 1e-6), dtype=torch.float32,
                        device=device)
        sa_texel = 4.0 * PI / (6.0 * res * res)
        dirs = _texel_dirs(res, device)
        t, b, n = make_tbn(dirs)
        acc_r = torch.zeros_like(dirs)
        acc_w = torch.zeros(dirs.shape[:-1] + (1,), dtype=torch.float32,
                            device=device)
        for start, end in _batches(sample_count, dirs.shape[0]):
            e = xi_all[start:end, None, :].expand(end - start,
                                                  dirs.shape[0], 2)
            h_t = importance_sample_ggx(e, a2)
            h = h_t[..., 0:1] * t + h_t[..., 1:2] * b + h_t[..., 2:3] * n
            voh = (dirs * h).sum(dim=-1)
            l = 2.0 * voh[..., None] * h - dirs
            nol = torch.clamp((dirs * l).sum(dim=-1), min=0.0)
            noh = torch.clamp((dirs * h).sum(dim=-1), min=0.0)
            voh = torch.clamp(voh, min=0.0)
            pdf = specular_pdf(noh, a2, voh)
            sa_sample = 1.0 / (sample_count * pdf + 1e-6)
            if roughness == 0.0:
                lod = torch.zeros_like(pdf)
            else:
                lod = 0.5 * torch.log2(sa_sample / sa_texel)
            radiance = sample_flat_mips(flat_data, flat_offsets, flat_sizes,
                                        l, lod)
            radiance = radiance / torch.clamp(
                luminance(radiance)[..., None] / MAX_LUMINANCE, min=1.0)
            weight = nol[..., None]
            acc_r = acc_r + (radiance * weight).sum(dim=0)
            acc_w = acc_w + weight.sum(dim=0)
        result = acc_r / torch.clamp(acc_w, min=1e-8)
        out.append(result.reshape(6, res, res, 3))
    return tuple(out)


# ---------------------------------------------------------------------------
# Irradiance as a least-squares SH fit of the baked cube
# (steeljax/env/ibl.py:321-434): the fit is weighted by texel solid angle,
# its order the smallest whose residual passes a gate; lighting evaluates
# the fit inline when the bake accepted one, else reads the cube's quads.
# ---------------------------------------------------------------------------


def sh_basis(dirs: torch.Tensor, order: int) -> torch.Tensor:
    """Real spherical-harmonics basis at UNIT directions (..., 3) ->
    (..., order**2), bands l = 0..order-1, m = -l..l inside each band;
    trig-free (the complex-power and the s^m-factored Legendre
    recurrences)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    one = torch.ones_like(z)

    # a[m] = Re((x+iy)^m) = s^m cos(m phi); b[m] = Im = s^m sin(m phi).
    a = [one]
    b = [torch.zeros_like(z)]
    for m in range(1, order):
        am, bm = a[m - 1], b[m - 1]
        a.append(x * am - y * bm)
        b.append(x * bm + y * am)

    # q[l][m] = P_l^m(z) / s^m (the s^m factor lives in a and b).
    q = [[one]]
    for l in range(1, order):
        row = [None] * (l + 1)
        row[l] = q[l - 1][l - 1] * float(1 - 2 * l)
        row[l - 1] = z * q[l - 1][l - 1] * float(2 * l - 1)
        for m in range(l - 2, -1, -1):
            row[m] = ((float(2 * l - 1) * z * q[l - 1][m]
                       - float(l + m - 1) * q[l - 2][m])
                      / float(l - m))
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
            if m < 0:
                val = base * b[am]
            elif m > 0:
                val = base * a[am]
            else:
                val = base
            out.append(val * float(np.float32(norm)))
    return torch.stack(out, dim=-1)


def fit_cube_sh(cube, max_order: int = 8, rel_tol: float = 0.005,
                noise_cap: float = 0.04, *,
                device: torch.device | str):
    """Weighted least-squares SH fit of a (6, R, R, 3) cube (host numpy
    lstsq).  Accepts the SMALLEST order whose RMS texel residual, relative
    to the cube's mean magnitude, is under max(rel_tol, noise floor): the
    floor is the bake's own texel noise from in-face second differences,
    capped at `noise_cap`.  Returns (coeffs (order**2, 3) float32 on
    `device`, rms_rel_err), or (None, best_err)."""
    if isinstance(cube, torch.Tensor):
        cube = cube.cpu().numpy()
    cube = np.asarray(cube, np.float32)
    res = cube.shape[1]
    dirs = torch.from_numpy(face_directions(res).reshape(-1, 3))
    vals = cube.reshape(-1, 3).astype(np.float64)
    # Cube texel solid angle ~ (1 + x^2 + y^2)^{-3/2}; relative weights
    # are all the fit needs.
    texel = (np.arange(res, dtype=np.float64) + 0.5) / res * 2.0 - 1.0
    gx, gy = np.meshgrid(texel, texel, indexing="xy")
    w_face = (1.0 + gx * gx + gy * gy) ** -1.5
    w = np.tile(w_face.reshape(-1), 6)
    scale = float(np.abs(vals).mean() + 1e-12)

    c64 = cube.astype(np.float64)
    lap = 0.5 * (np.abs(np.diff(c64, n=2, axis=1)).mean()
                 + np.abs(np.diff(c64, n=2, axis=2)).mean())
    floor = max(rel_tol, min(lap / scale, noise_cap))

    best = None
    for order in range(2, max_order + 1):
        basis = sh_basis(dirs, order).numpy().astype(np.float64)  # (T, K)
        bw = basis * w[:, None]
        coeffs, *_ = np.linalg.lstsq(bw.T @ basis, bw.T @ vals, rcond=None)
        fit = np.maximum(basis @ coeffs, 0.0)
        err = float(np.sqrt(((fit - vals) ** 2).mean()) / scale)
        best = err if best is None else min(best, err)
        if err <= floor:
            return (torch.from_numpy(coeffs.astype(np.float32)).to(device),
                    err)
    return None, best


def eval_cube_sh(coeffs: torch.Tensor, direction: torch.Tensor
                 ) -> torch.Tensor:
    """Inline SH cube lookup: normalize, basis, one (..., K) @ (K, 3)
    product, clamp at zero (fit ringing may dip below)."""
    order = int(round(float(coeffs.shape[0]) ** 0.5))
    d = direction / torch.clamp(
        torch.linalg.vector_norm(direction, dim=-1, keepdim=True), min=1e-20)
    return torch.clamp(sh_basis(d, order) @ coeffs, min=0.0)
