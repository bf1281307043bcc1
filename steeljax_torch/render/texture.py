"""Bilinear and trilinear texture sampling from the flat texel pool.

Port of steeljax/render/texture.py:16-83.  Ray-generation shaders sample
implicit lod 0 (no derivatives in ray-tracing stages), so bilinear lod 0 is
the path tracer's texture read; the hybrid G-buffer samples trilinear at a
per-pixel lod (`sample_trilinear`, the raster pipeline's texture()).  The
pool (scene.flatten) stores each texel's repeat-wrapped 2x2 footprint as
one 16-byte row, so a sample is one row read and a lerp.  The reference
fetches the per-texture descriptors with a select chain because a TPU
gather is slow; plain indexing gives the same values.
"""

from __future__ import annotations

import torch


def _bilinear_level(atlas, tex_offset, tex_size, tex_id, uv, level):
    """Bilinear repeat-wrap sample at mip `level`, an int or an integer
    tensor broadcastable to tex_id.

    atlas: (N, 16) uint8 quad rows; tex_offset: (K, M) int32 per-mip row
    offsets; tex_size: (K, 2) int32; tex_id: (...,) integer (callers mask
    id < 0 themselves); uv: (..., 2).  Returns (..., 4) float32 in [0, 1]."""
    tid = torch.clamp(tex_id.long(), min=0)
    if isinstance(level, torch.Tensor):
        level = torch.clamp(level.long(), 0, tex_offset.shape[1] - 1)
    else:
        level = min(max(int(level), 0), tex_offset.shape[1] - 1)
    size_row = tex_size[tid]                       # (..., 2)
    off = tex_offset[tid, level]
    w = torch.clamp(size_row[..., 0] >> level, min=1)
    h = torch.clamp(size_row[..., 1] >> level, min=1)

    x = uv[..., 0] * w.to(torch.float32) - 0.5
    y = uv[..., 1] * h.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    x0i = torch.remainder(x0.to(torch.int32), w)
    y0i = torch.remainder(y0.to(torch.int32), h)

    quad = atlas[(off + y0i * w + x0i).long()].to(torch.float32) * (
        1.0 / 255.0)
    top = quad[..., 0:4] * (1.0 - fx) + quad[..., 4:8] * fx
    bot = quad[..., 8:12] * (1.0 - fx) + quad[..., 12:16] * fx
    return top * (1.0 - fy) + bot * fy


def sample_bilinear(atlas, tex_offset, tex_size, tex_id, uv):
    """Bilinear sample at lod 0 (ray-tracing stages sample implicit lod 0,
    so this is the path tracer's texture read)."""
    return _bilinear_level(atlas, tex_offset, tex_size, tex_id, uv, 0)


def sample_trilinear(atlas, tex_offset, tex_size, tex_id, uv, lod):
    """Trilinear sample (the raster pipeline's mip-mapped texture()):
    bilinear at the two bracketing mips of the per-pixel `lod` and a
    linear blend."""
    lod = torch.clamp(lod, min=0.0)
    lo = torch.floor(lod).to(torch.int64)
    frac = (lod - lo.to(torch.float32))[..., None]
    a = _bilinear_level(atlas, tex_offset, tex_size, tex_id, uv, lo)
    b = _bilinear_level(atlas, tex_offset, tex_size, tex_id, uv, lo + 1)
    return a * (1.0 - frac) + b * frac
