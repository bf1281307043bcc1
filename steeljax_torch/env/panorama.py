"""Equirectangular panorama -> cubemap conversion.

Port of steeljax/env/panorama.py (PanoramaToCube.comp:1-41): per cube
texel, the direction from the face basis tables, the panorama texcoord
(atan(z, x), asin(y)) * (0.1591, 0.3183) + 0.5 with the reference's Y flip,
and a bilinear sample, repeat in u and clamp in v.
"""

from __future__ import annotations

import numpy as np
import torch

from steeljax_torch.env.cubemap import face_directions


def _sample_panorama(panorama: torch.Tensor, uv: torch.Tensor
                     ) -> torch.Tensor:
    """Bilinear sample of an (H, W, 3) panorama, repeat wrap in u and clamp
    in v."""
    h, w = panorama.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi = x0.to(torch.int64)
    yi = y0.to(torch.int64)
    x0i = torch.remainder(xi, w)
    x1i = torch.remainder(xi + 1, w)
    y0i = torch.clamp(yi, 0, h - 1)
    y1i = torch.clamp(yi + 1, 0, h - 1)
    c00 = panorama[y0i, x0i]
    c10 = panorama[y0i, x1i]
    c01 = panorama[y1i, x0i]
    c11 = panorama[y1i, x1i]
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def panorama_to_cube(panorama, resolution: int = 256, *,
                     device: torch.device | str) -> torch.Tensor:
    """(H, W, 3) float32 equirect (array or tensor) -> (6, R, R, 3) cubemap
    on `device`."""
    pano = torch.as_tensor(np.asarray(panorama, np.float32)
                           if not isinstance(panorama, torch.Tensor)
                           else panorama, dtype=torch.float32).to(device)
    d = torch.from_numpy(face_directions(resolution)).to(device)
    dx, dy, dz = d[..., 0], -d[..., 1], d[..., 2]
    uv = torch.stack([torch.atan2(dz, dx) * 0.1591 + 0.5,
                      torch.asin(torch.clamp(dy, -1.0, 1.0)) * 0.3183
                      + 0.5], dim=-1)
    return _sample_panorama(pano, uv)
