"""Per-triangle conservative alpha-coverage masks for in-kernel alpha
testing.

Port of steeljax/accel/alphamask.py.  compute_alpha_masks and
compute_fine_masks run the reference's numpy computation (the cell grids
and the coverage integrals, in the same float32 operations and order) as
tensor code on a device of the caller's choice, so every mask equals the
reference's and the 1M-triangle foliage scenes get theirs from the card in
a fraction of the host's time; mask_test and fine_mask_test are the
tensor versions of the per-candidate tests the alpha-masked trace kernels
(K4, K5 in csrc/) apply.

The reference's alpha-tested materials reject a hit when the base-colour
texture's alpha at the hit is below the material's cutoff (its any-hit
shader, AnyHit.rahit:25-52).  The trace kernels cannot sample textures per
candidate, so each triangle carries a conservative mask in barycentric
space instead:

* the coarse mask: the (u, v) domain is cut into a GRID x GRID cell grid;
  the CELLS cells meeting {u >= 0, v >= 0, u + v <= 1} are enumerated
  triangularly (21 cells at GRID = 6) and packed into the triangle record's
  AUX lane beside the double-sided bit (cuda_traverse.pack_tris);
* a cell's bit is 0 only when every bilinear alpha sample inside it is
  below the cutoff, so a kernel may drop such candidates without the
  texture: the integrator's exact test would have rejected them too;
* the fine masks: a parallel int32 row table (cuda_traverse.
  pack_fine_mask_rows) gives each record FINE_STRIDE words, a PASS plane
  (the same contract at FINE_CELLS = 153 cells) and an OPAQUE plane (bit 1
  only when every bilinear sample is at or above the cutoff, so the exact
  test provably keeps the hit).

Opaque triangles, and alpha materials the integrator's test ignores (no
ALPHA_TEST flag, no base texture), get all-ones masks.
"""

from __future__ import annotations

import numpy as np
import torch

from steeljax_torch.scene.material import MaterialFlags

GRID = 6                 # cells per barycentric axis
CELLS = 21               # triangular cells with i + j <= GRID - 1
MASK_FULL = (1 << CELLS) - 1
# AUX lane encoding (pack_tris with masks): bit 0 = double-sided, bits
# [1, 22) = mask; 22 bits < 2^24, exact in a float32 lane.
AUX_BITS = 1 + CELLS

FINE_GRID = 17
FINE_CELLS = 153         # 17 * 18 / 2 <= 160 = 5 * 32 bits
FINE_WORDS = 5           # int32 words per plane
FINE_STRIDE = 2 * FINE_WORDS  # record stride in the mask row (lanes)


def cell_index(ci, cj):
    """Triangular packing of in-domain cells: row j holds GRID - j cells.
    Works for numpy arrays and integer tensors."""
    return cj * GRID + ci - ((cj * (cj - 1)) >> 1)


def _cells(u: torch.Tensor, v: torch.Tensor, grid: int):
    """(ci, cj) of the grid cell holding (u, v): the float product cast
    toward zero, then clamped to the grid."""
    ci = torch.clamp((u * grid).to(torch.int32), 0, grid - 1)
    cj = torch.clamp((v * grid).to(torch.int32), 0, grid - 1)
    return ci, cj


def fine_cell(u: torch.Tensor, v: torch.Tensor, grid: int = FINE_GRID):
    """(cell index, in-domain) on the fine triangular grid."""
    ci, cj = _cells(u, v, grid)
    cell = cj * grid + ci - ((cj * (cj - 1)) >> 1)
    return cell, (ci + cj) <= grid - 1


def fine_mask_test(words: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Two-plane fine test: (keep, opaque) from (..., FINE_STRIDE) int32
    words (PASS plane words [0, FINE_WORDS), OPAQUE plane words
    [FINE_WORDS, FINE_STRIDE)).  Out-of-domain cells (the u + v == 1 edge
    through fp rounding) keep and are never opaque."""
    cell, in_dom = fine_cell(u, v)
    word = cell >> 5
    bit = cell & 31
    p = torch.zeros_like(cell)
    o = torch.zeros_like(cell)
    for wd in range(FINE_WORDS):
        p = torch.where(word == wd, words[..., wd], p)
        o = torch.where(word == wd, words[..., wd + FINE_WORDS], o)
    keep = (((p >> bit) & 1) == 1) | ~in_dom
    opaque = (((o >> bit) & 1) == 1) & in_dom
    return keep, opaque


def mask_test(mask_int: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """The coarse coverage test: True = keep the hit.  `mask_int` is an
    int32 mask (bits [0, CELLS)), u/v the barycentrics of a candidate hit.
    Cells outside the triangular domain (reachable only on the u + v == 1
    edge through fp rounding) always pass."""
    ci, cj = _cells(u, v, GRID)
    bit = (mask_int >> cell_index(ci, cj)) & 1
    return (bit == 1) | ((ci + cj) > (GRID - 1))


def _coverage_integral(texture: np.ndarray, threshold: float,
                       device: torch.device) -> torch.Tensor:
    """(H+1, W+1) int64 integral image of (texel_alpha/255 >= threshold),
    flattened, on `device`."""
    covered = (texture[..., 3].astype(np.float32) * (1.0 / 255.0)
               >= threshold - 1e-6)
    ii = np.zeros((covered.shape[0] + 1, covered.shape[1] + 1), np.int64)
    ii[1:, 1:] = covered.cumsum(0).cumsum(1)
    return torch.from_numpy(ii.reshape(-1)).to(device)


def _rect_count(ii: torch.Tensor, stride: int, y0, y1, x0, x1):
    """Inclusive in-bounds rect count from a flattened integral image of
    row length `stride`.  Empty ranges (x0 > x1) contribute 0."""
    x0c = torch.minimum(x0, x1 + 1)
    y0c = torch.minimum(y0, y1 + 1)

    def at(y, x):
        return ii[y * stride + x]

    return (at(y1 + 1, x1 + 1) - at(y0c, x1 + 1) - at(y1 + 1, x0c)
            + at(y0c, x0c))


def _wrapped_ranges(lo, hi, n: int):
    """Split the repeat-wrapped inclusive texel range [lo, hi] into <= 2
    in-bounds ranges (a0, a1), (b0, b1); the second is empty (b0 > b1)
    when no wrap occurs.  Spans >= n cover the whole axis."""
    full = (hi - lo + 1) >= n
    lo_m = torch.remainder(lo, n)
    hi_m = torch.remainder(hi, n)
    wraps = lo_m > hi_m
    zero = torch.zeros_like(lo_m)
    a0 = torch.where(full, zero, lo_m)
    a1 = torch.where(full | wraps, zero + (n - 1), hi_m)
    b0 = torch.where(~full & wraps, zero, zero + 1)
    b1 = torch.where(~full & wraps, hi_m, zero)
    return a0, a1, b0, b1


def _cell_counts(uv: torch.Tensor, ii: torch.Tensor, w: int, h: int,
                 grid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cell >=cutoff texel counts and footprint areas for one batch.

    uv: (B, 3, 2) float32 per-vertex texture coordinates.  Returns (count,
    area), each (B, cells) int64, over the triangular cells of `grid` in
    cell_index order.  The footprint is the cell square's affine image,
    repeat-wrapped, dilated by the bilinear support and one texel of fp
    slack (conservative for both planes: `count > 0` over-approximates
    "any sample >= cutoff", `count == area` under-approximates "every
    sample >= cutoff").  The float32 arithmetic is the reference's, one
    IEEE operation at a time in the same order, so the footprints are its
    own on any device."""
    q0 = uv[:, 0]
    e1 = uv[:, 1] - uv[:, 0]
    e2 = uv[:, 2] - uv[:, 0]

    js, is_ = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    keep = (is_ + js) <= grid - 1
    ci = torch.from_numpy(is_[keep].astype(np.float32)).to(uv.device)
    cj = torch.from_numpy(js[keep].astype(np.float32)).to(uv.device)
    inv = 1.0 / grid

    def axis_bounds(axis):
        base = (q0[:, axis, None]
                + ci[None, :] * inv * e1[:, axis, None]
                + cj[None, :] * inv * e2[:, axis, None])
        lo = (base + torch.clamp(e1[:, axis, None], max=0.0) * inv
              + torch.clamp(e2[:, axis, None], max=0.0) * inv)
        hi = (base + torch.clamp(e1[:, axis, None], min=0.0) * inv
              + torch.clamp(e2[:, axis, None], min=0.0) * inv)
        return lo, hi

    def texel(x, size, offset):
        return torch.floor(x * size - 0.5).to(torch.int64) + offset

    ulo, uhi = axis_bounds(0)
    vlo, vhi = axis_bounds(1)
    x_lo, x_hi = texel(ulo, w, -1), texel(uhi, w, 2)
    y_lo, y_hi = texel(vlo, h, -1), texel(vhi, h, 2)

    xa0, xa1, xb0, xb1 = _wrapped_ranges(x_lo, x_hi, w)
    ya0, ya1, yb0, yb1 = _wrapped_ranges(y_lo, y_hi, h)
    stride = w + 1
    count = (_rect_count(ii, stride, ya0, ya1, xa0, xa1)
             + _rect_count(ii, stride, ya0, ya1, xb0, xb1)
             + _rect_count(ii, stride, yb0, yb1, xa0, xa1)
             + _rect_count(ii, stride, yb0, yb1, xb0, xb1))
    area = (torch.clamp(x_hi - x_lo + 1, max=w)
            * torch.clamp(y_hi - y_lo + 1, max=h))
    return count, area


# Triangle batch bound for the (B, cells) temporaries, by device.
_BATCH = {"cpu": 32768, "cuda": 262144}


def _batches(uv: torch.Tensor):
    step = _BATCH[uv.device.type]
    for s in range(0, uv.shape[0], step):
        yield s, min(s + step, uv.shape[0])


def _pack_bits(bits: torch.Tensor, words: int) -> torch.Tensor:
    """(B, cells) bool -> (B, words) int32, little-endian bit packing."""
    b, cells = bits.shape
    padded = torch.zeros((b, words * 32), dtype=torch.int64,
                         device=bits.device)
    padded[:, :cells] = bits.to(torch.int64)
    shifts = torch.arange(32, device=bits.device)
    packed = (padded.reshape(b, words, 32) << shifts).sum(dim=2)
    # Two's complement: bit 31 set is a negative int32.
    return (packed - ((packed >> 31) << 32)).to(torch.int32)


def _cell_bits(uv: torch.Tensor, ii: torch.Tensor, w: int,
               h: int) -> torch.Tensor:
    """(T,) coarse masks for triangles sharing one coverage integral
    image: bit c set when the cell's footprint contains any >=cutoff
    texel."""
    masks = torch.empty(uv.shape[0], dtype=torch.int64, device=uv.device)
    shifts = torch.arange(CELLS, device=uv.device)
    for s, e in _batches(uv):
        count, _ = _cell_counts(uv[s:e], ii, w, h, GRID)
        masks[s:e] = ((count > 0).to(torch.int64) << shifts).sum(dim=1)
    return masks


def _fine_planes(uv: torch.Tensor, ii: torch.Tensor, w: int,
                 h: int) -> torch.Tensor:
    """(T, FINE_STRIDE) int32 two-plane fine masks."""
    out = torch.empty((uv.shape[0], FINE_STRIDE), dtype=torch.int32,
                      device=uv.device)
    for s, e in _batches(uv):
        count, area = _cell_counts(uv[s:e], ii, w, h, FINE_GRID)
        out[s:e, :FINE_WORDS] = _pack_bits(count > 0, FINE_WORDS)
        out[s:e, FINE_WORDS:] = _pack_bits(count >= area, FINE_WORDS)
    return out


def _alpha_materials(tri_mat, mat_base_color, mat_params, mat_tex,
                     mat_flags):
    """For every material the integrator's exact alpha test applies to
    (ALPHA_TEST flag and a base texture) that owns triangles: (triangle
    ids, texture id, threshold), where the threshold is cutoff / alpha
    factor, None when nothing is ever rejected (cutoff <= 0) and inf when
    every hit is (the factor or the texture cannot reach the cutoff)."""
    tri_mat = np.asarray(tri_mat, np.int64)
    mat_flags = np.asarray(mat_flags, np.int64)
    mat_tex = np.asarray(mat_tex, np.int64)
    params = np.asarray(mat_params, np.float32)
    base = np.asarray(mat_base_color, np.float32)
    for m in range(len(mat_flags)):
        if not (mat_flags[m] & int(MaterialFlags.ALPHA_TEST)):
            continue
        tex_id = int(mat_tex[m, 0])
        if tex_id < 0:
            continue
        sel = np.nonzero(tri_mat == m)[0]
        if not len(sel):
            continue
        cutoff = float(params[m, 4])
        factor = float(base[m, 3])
        if cutoff <= 0.0:
            yield sel, tex_id, None
        elif factor <= 0.0 or cutoff / factor > 1.0 + 1e-6:
            yield sel, tex_id, float("inf")
        else:
            yield sel, tex_id, cutoff / factor


def _per_material(out, planes, tri_uv, tri_mat, mat_base_color, mat_params,
                  mat_tex, mat_flags, textures, device):
    """Fill `out` (all-ones) per alpha material: zeros where no texel can
    pass, `planes(uv, ii, w, h)`, computed on `device`, where the texture
    decides."""
    tri_uv = np.asarray(tri_uv, np.float32)
    device = torch.device(device)
    ii_cache: dict[tuple[int, float], torch.Tensor] = {}
    for sel, tex_id, thr in _alpha_materials(tri_mat, mat_base_color,
                                             mat_params, mat_tex, mat_flags):
        if thr is None:
            continue
        if thr == float("inf"):
            out[sel] = 0
            continue
        key = (tex_id, round(thr, 6))
        tex = np.asarray(textures[tex_id])
        if key not in ii_cache:
            ii_cache[key] = _coverage_integral(tex, thr, device)
        h, w = tex.shape[:2]
        uv = torch.from_numpy(tri_uv[sel]).to(device)
        out[sel] = planes(uv, ii_cache[key], w, h).cpu().numpy()
    return out


def compute_fine_masks(tri_uv, tri_mat, mat_base_color, mat_params,
                       mat_tex, mat_flags, textures, *,
                       device: torch.device | str) -> np.ndarray:
    """(T, FINE_STRIDE) int32 two-plane fine masks, with the material
    semantics of compute_alpha_masks, computed on `device`.
    Non-participating triangles get PASS = OPAQUE = all-ones: their hits
    are final and bound a multi-hit walk like any opaque surface."""
    t = np.asarray(tri_mat).shape[0]
    out = np.full((t, FINE_STRIDE), -1, np.int32)
    if t == 0 or not textures:
        return out
    return _per_material(out, _fine_planes, tri_uv, tri_mat, mat_base_color,
                         mat_params, mat_tex, mat_flags, textures, device)


def compute_alpha_masks(tri_uv, tri_mat, mat_base_color, mat_params,
                        mat_tex, mat_flags, textures, *,
                        device: torch.device | str) -> np.ndarray:
    """(T,) uint32 conservative coverage masks from unpermuted
    per-triangle arrays and raw (H, W, 4) uint8 textures (Scene.textures
    order), computed on `device`.  Only materials with the ALPHA_TEST flag
    and a base-colour texture take part (flatten_scene's any_alpha_test
    gate); alpha = base alpha factor * texel alpha against the material
    cutoff.  Everything else gets MASK_FULL."""
    t = np.asarray(tri_mat).shape[0]
    masks = np.full(t, MASK_FULL, np.uint32)
    if t == 0 or not textures:
        return masks
    return _per_material(masks, _cell_bits, tri_uv, tri_mat, mat_base_color,
                         mat_params, mat_tex, mat_flags, textures, device)
