"""Color-space conversions, luminance, tone mapping on tensors.

Port of steeljax/core/colors.py:14-45 (Common.glsl:90-140).
"""

from __future__ import annotations

import torch

_LUMA = (0.2126, 0.7152, 0.0722)


def to_srgb(linear: torch.Tensor) -> torch.Tensor:
    higher = 1.055 * torch.pow(torch.clamp(linear, min=0.0),
                               1.0 / 2.4) - 0.055
    lower = linear * 12.92
    return torch.where(linear < 0.0031308, lower, higher)


def to_linear(srgb: torch.Tensor) -> torch.Tensor:
    higher = torch.pow(torch.clamp(srgb + 0.055, min=0.0) / 1.055, 2.4)
    lower = srgb / 12.92
    return torch.where(srgb < 0.04045, lower, higher)


def luminance(color: torch.Tensor) -> torch.Tensor:
    # Python-float weights: no constant tensor to copy to the device (a
    # pageable host-to-device copy synchronizes the stream).
    return (color[..., 0] * _LUMA[0] + color[..., 1] * _LUMA[1]
            + color[..., 2] * _LUMA[2])


def tone_map(linear: torch.Tensor) -> torch.Tensor:
    """Filmic (Hejl-Burgess-Dawson) tone map; output is sRGB-encoded
    (Common.glsl:119-124)."""
    x = torch.clamp(linear - 0.004, min=0.0)
    return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)


def uncharted_tone_map(linear: torch.Tensor) -> torch.Tensor:
    """Uncharted-2 filmic curve (Common.glsl:126-138); output is linear and
    still needs sRGB encoding."""
    a, b, c, d, e, f, wp = 0.22, 0.30, 0.10, 0.20, 0.01, 0.30, 11.2

    def curve(x):
        return ((x * (a * x + c * b) + d * e)
                / (x * (a * x + b) + d * f)) - e / f

    white = curve(torch.tensor(wp, dtype=torch.float32))
    return curve(linear) / float(white)
