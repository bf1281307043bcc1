"""Spherical harmonics (SH-9) projection and irradiance evaluation.

Port of steeljax/gi/sh.py.  Projection parity with LightVolume.comp: a
sphere Riemann sum with SAMPLE_DELTA=0.05, coefficients = 2*PI *
sum(basis * L * sin(theta)) / count.  Evaluation parity with
ComputeIrradiance (Common.glsl:180-194), the Ramamoorthi-Hanrahan
irradiance polynomial.

The reference maps one probe at a time over its cube (`vmap`); here every
probe's cube is sampled in one env.cubemap.sample_cube call (the probes
ride in the channel axis, since all of them are read at the same
directions) and projected in one batched product.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from steeljax_torch.core.constants import PI
from steeljax_torch.env.cubemap import sample_cube

SAMPLE_DELTA = 0.05  # LightVolume.comp:10


def sh_basis(n: torch.Tensor) -> torch.Tensor:
    """The 9 basis values at directions n (..., 3) -> (..., 9)
    (ComputeSH, LightVolume.comp:31-58)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    one = torch.ones_like(x)
    return torch.stack([
        0.282095 * one,
        0.488603 * y,
        0.488603 * z,
        0.488603 * x,
        1.092548 * x * y,
        1.092548 * y * z,
        0.315392 * (3.0 * z * z - 1.0),
        1.092548 * x * z,
        0.546274 * (x * x - y * y),
    ], dim=-1)


@functools.lru_cache(maxsize=4)
def _sphere_grid(delta: float = SAMPLE_DELTA):
    """(directions (S, 3), sin(theta) (S,)) float32 numpy, built in float64
    as the reference does: 126 x 63 directions at delta 0.05."""
    phi = np.arange(0.0, 2.0 * np.pi, delta)
    theta = np.arange(0.0, np.pi, delta)
    pp, tt = np.meshgrid(phi, theta, indexing="ij")
    dirs = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                     np.cos(tt)], axis=-1).reshape(-1, 3)
    norms = np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs / np.maximum(norms, 1e-12)
    sin_t = np.sin(tt).reshape(-1)
    return dirs.astype(np.float32), sin_t.astype(np.float32)


def project_sh9(cubes: torch.Tensor,
                delta: float = SAMPLE_DELTA) -> torch.Tensor:
    """Project probe cubemaps (P, 6, R, R, 3) to SH-9 (P, 9, 3) RGB
    coefficients, on the cubes' device."""
    p, faces, res = cubes.shape[0], cubes.shape[1], cubes.shape[2]
    dirs_np, sin_np = _sphere_grid(delta)
    dirs = torch.as_tensor(dirs_np, device=cubes.device)
    sin_t = torch.as_tensor(sin_np, device=cubes.device)
    weights = sh_basis(dirs) * sin_t[:, None]                 # (S, 9)
    # (6, R, R, P * 3): one bilinear lookup per direction serves them all.
    stacked = cubes.permute(1, 2, 3, 0, 4).reshape(faces, res, res, p * 3)
    radiance = sample_cube(stacked, dirs).reshape(-1, p, 3)   # (S, P, 3)
    coeffs = torch.einsum("sk,spc->pkc", weights, radiance)
    return 2.0 * PI * coeffs / dirs.shape[0]


def eval_irradiance(coeffs: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Ramamoorthi irradiance polynomial (Common.glsl:180-194).

    coeffs: (..., 9, 3); n: (..., 3) -> (..., 3)."""
    c1, c2, c3, c4, c5 = 0.429043, 0.511664, 0.743125, 0.886227, 0.247708
    x = n[..., 0:1]
    y = n[..., 1:2]
    z = n[..., 2:3]
    c = coeffs
    return (c1 * c[..., 8, :] * (x * x - y * y)
            + c3 * c[..., 6, :] * z * z
            + c4 * c[..., 0, :]
            - c5 * c[..., 6, :]
            + 2.0 * c1 * (c[..., 4, :] * x * y + c[..., 7, :] * x * z
                          + c[..., 5, :] * y * z)
            + 2.0 * c2 * (c[..., 3, :] * x + c[..., 1, :] * y
                          + c[..., 2, :] * z))
