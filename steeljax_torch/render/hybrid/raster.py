"""Tile-binned rasterized primary visibility for the hybrid G-buffer.

Port of steeljax/render/hybrid/raster.py.  The reference's engine
rasterizes the G-buffer (a graphics pipeline over the opaque scene,
GBufferStage.cpp:147-157, GBuffer.vert/.frag) and ray-traces only the
shadows; this module is that raster stage in four steps:

 1. VERTEX STAGE: every triangle to clip space in one batched product,
    clipped against the near plane (at most 2 pieces a triangle, carrying
    the ORIGINAL triangle's barycentrics, so attributes interpolate
    exactly), and per piece the screen-space linear forms a*sx + b*sy + c:
    3 edge functions (the inside test), Fw (perspective 1/w), Fu and Fv
    (perspective-correct original barycentrics) and reverse-z NDC depth.
 2. BIN: each piece gets as key its least covered 32x24-pixel subtile;
    pieces spanning more than a 2x2 neighbourhood of subtiles go to a
    global "big" segment, culled and degenerate ones to the tail.  One
    stable sort of the keys and a row gather order the record table, and a
    searchsorted gives each subtile's segment offsets: no per-tile copies.
    A subtile tests the segment of its own row and of the row above
    (columns tx - 1 .. tx), then the big segment.
 3. RASTER (`_raster_tiles`): each subtile's 768 pixels walk their
    candidate segments in WINDOW-piece slices, keep an exact running
    reverse-z maximum, and take the winner's Fu, Fv, Fw and triangle from
    ONE pinned piece, so coplanar exact-z ties never mix attributes.
    Within a slice the last piece of the greatest z wins; a later slice
    replaces the running winner only on a strictly greater z.  On a CPU
    tensor this stage is `_raster_tiles_plain`, the reference's slice loop
    (its trip counts read on the host).  On a CUDA tensor it is the
    hand-written kernel csrc/raster.cu, one thread block a subtile, which
    walks otherwise with the same result.  Each candidate carries a slice
    tag (its segment, then its slice), and a pixel takes a piece on a
    greater z, or on an equal z with the tag of its current winner: the
    slice rule in one pass, and the greatest (z, -tag, row) of the pieces
    inside the pixel (equal z: the earliest slice, and in it the last
    piece), a maximum that can be taken over parts and then over the
    parts.  So the block culls its candidates by bounding box 512 at a
    time, stages only the covering ones in walk order (cp.async into two
    shared buffers, the next chunk's copies in flight while this one is
    walked), the two warps of each 32x3 strip skip the pieces that miss it
    (`corner_max`, `strip_rejects`) and take the others 32 at a time in
    turn, the two warps' winners merge by that maximum, and the winner's
    Fu, Fv, Fw are evaluated once at the end.  Blocks take the subtiles
    densest first (`density_order`), as the reference orders them for its
    lockstep map; the outputs stay in the caller's row order.  No host
    read, so the frame keeps no host synchronization.
 4. RESOLVE: u = Fu / Fw, v = Fv / Fw, w_eye = 1 / Fw per pixel.

The stage is opt-in (STEELJAX_RASTER=1, HybridRenderer._prepare_raster).
Outputs keep trace_nearest's contract ({hit, tri, t, u, v}; misses at t =
-1, tri = -1), so the G-buffer's alpha re-trace and shading are unchanged.
Deviations from the traced visibility, as in the reference: near and far
clipping is planar (eye z) rather than radial (ray t), and exact-z ties
(coplanar overlap, shared edges) resolve by record order rather than by
traversal order; both touch isolated edge pixels.
"""

from __future__ import annotations

import dataclasses

import torch

from steeljax_torch.render.surface import material_flag
from steeljax_torch.scene.material import MaterialFlags

# Subtile: the binning granule and the pixel group of one raster block (768
# pixels).  At 32x24, pieces up to about 64x48 pixels bin locally; 24
# divides 720 and 1080.
TILE_W = 32
TILE_H = 24
PX = TILE_W * TILE_H
SPAN = 2      # subtile span (columns or rows) from which a piece is "big"
WINDOW = 256  # pieces per slice of the tie rule
_KEY_BIG = 1 << 29
_KEY_CULL = 1 << 30
_REC_COLS = 24
# Record columns: the (a, b, c) triples of E0, E1, E2, Fw, Fu, Fv, Z.
_E0, _E1, _E2, _FW, _FU, _FV, _Z = (3 * k for k in range(7))
_TRI, _BMIN, _BMAX = 21, 22, 23
# The plain version keeps each batch of subtiles' (pixels x pieces)
# intermediates near this many bytes: 64 MiB on the host, 1 GiB on the card.
_PLAIN_CHUNK_BYTES = {"cpu": 64 << 20, "cuda": 1 << 30}
# The raster kernel's warps: each owns STRIP_ROWS rows of a subtile and
# skips the pieces strip_rejects names.
STRIP_ROWS = 3


def supported(width: int, height: int) -> bool:
    """Raster engages only on frames that tile exactly into 32x24-pixel
    subtiles (1280x720 and 1920x1080 do); others keep the traced path."""
    return width % TILE_W == 0 and height % TILE_H == 0


@dataclasses.dataclass
class RasterScene:
    """Per-triangle raster inputs on the scene's device (prepare_raster):
    world-space vertices and the raster mask (pad slots and alpha-BLEND
    materials excluded: blend surfaces belong to the forward stage,
    GBufferStage.cpp:147-157)."""
    v0: torch.Tensor           # (T, 3) float32
    e1: torch.Tensor           # (T, 3) float32
    e2: torch.Tensor           # (T, 3) float32
    double_sided: torch.Tensor  # (T,) bool
    in_raster: torch.Tensor    # (T,) bool


def prepare_raster(flat, tables) -> RasterScene | None:
    """The raster inputs of a prepared scene, or None where the tables
    cannot supply them: instanced and treelet tables keep the traced
    G-buffer.  The vertices are flat.tri_pos (the reference's CPU and
    multi-chunk branch), in the tables' triangle order."""
    if getattr(tables, "chunks", None) is None or tables.treelets is not None:
        return None
    in_raster = ~material_flag(flat.tri_shade, MaterialFlags.ALPHA_BLEND)
    # Pad slots (tri_pos parked at 3e37) are also culled by the vertex
    # magnitude test of raster_visibility.
    in_raster &= flat.tri_pos[:, 0, 0] < 3.0e36
    pos = flat.tri_pos.to(torch.float32)
    return RasterScene(pos[:, 0], pos[:, 1] - pos[:, 0],
                       pos[:, 2] - pos[:, 0],
                       flat.tri_double_sided.to(torch.bool), in_raster)


def _clip_near(p, bary, w_eps):
    """Clip triangles (p: (T, 3, 4) clip-space vertices, bary: (T, 3, 3)
    original barycentrics) against w >= w_eps.  Returns two pieces, each
    (vertices (T, 3, 4), barycentrics (T, 3, 3), valid (T,)); piece B is
    valid only where the clip made a quad.  Select chains, as the
    reference."""
    w = p[..., 3]
    inb = w >= w_eps                                  # (T, 3)
    count = inb.to(torch.int32).sum(-1)

    # Rotate the vertex order to start at the inside vertex whose
    # predecessor (in winding order) is outside (unique for counts 1 and 2;
    # count 3 keeps the order).
    v = [(p[:, i], bary[:, i]) for i in range(3)]

    def rot(sel1, sel2):
        out = []
        for k in range(3):
            pk = torch.where(sel1[:, None], v[(k + 1) % 3][0], v[k][0])
            pk = torch.where(sel2[:, None], v[(k + 2) % 3][0], pk)
            bk = torch.where(sel1[:, None], v[(k + 1) % 3][1], v[k][1])
            bk = torch.where(sel2[:, None], v[(k + 2) % 3][1], bk)
            out.append((pk, bk))
        return out

    start1 = inb[:, 1] & ~inb[:, 0]
    start2 = inb[:, 2] & ~inb[:, 1]
    (p0, b0), (p1, b1), (p2, b2) = rot(start1, start2)
    w0, w1, w2 = p0[..., 3], p1[..., 3], p2[..., 3]

    def isect(pa, ba, wa, pb, bb, wb):
        den = wb - wa
        t = (w_eps - wa) / torch.where(den.abs() < 1e-30, 1e-30, den)
        t = torch.clamp(t, 0.0, 1.0)[:, None]
        return pa + (pb - pa) * t, ba + (bb - ba) * t

    # count 1: inside = {v0'}; piece A = (v0', i01, i20).
    i01_p, i01_b = isect(p0, b0, w0, p1, b1, w1)
    i20_p, i20_b = isect(p2, b2, w2, p0, b0, w0)
    # count 2: inside = {v0', v1'}; the quad (v0', v1', i12, i20) is
    # A = (v0', v1', i12) and B = (v0', i12, i20).
    i12_p, i12_b = isect(p1, b1, w1, p2, b2, w2)

    c1 = (count == 1)[:, None]
    c2 = (count == 2)[:, None]
    a1p = torch.where(c1, i01_p, p1)
    a1b = torch.where(c1, i01_b, b1)
    a2p = torch.where(c1, i20_p, torch.where(c2, i12_p, p2))
    a2b = torch.where(c1, i20_b, torch.where(c2, i12_b, b2))
    piece_a = (torch.stack([p0, a1p, a2p], 1),
               torch.stack([b0, a1b, a2b], 1), count >= 1)
    piece_b = (torch.stack([p0, i12_p, i20_p], 1),
               torch.stack([b0, i12_b, i20_b], 1), count == 2)
    return piece_a, piece_b


def _piece_records(pp, bb, valid, double_sided, width, height, ntx, nty):
    """Screen-space linear-form records of clipped pieces.

    Record columns (24 float32): (a, b, c) of E0, E1, E2 (piece edges
    scaled by 1 / area2, so E(p) is the piece barycentric), Fw (1/w), Fu, Fv
    (perspective original-barycentric u, v), Z (reverse-z NDC): 21; then
    tri_id, bbox_min (tx0 + 4096 * ty0), bbox_max.  Returns (records (P,
    24), key (P,) int32)."""
    w = pp[..., 3]
    iw = 1.0 / w
    sx = (pp[..., 0] * iw + 1.0) * (0.5 * width)
    sy = (pp[..., 1] * iw + 1.0) * (0.5 * height)
    sz = pp[..., 2] * iw                          # reverse-z NDC in [0, 1]

    x0, x1, x2 = sx[:, 0], sx[:, 1], sx[:, 2]
    y0, y1, y2 = sy[:, 0], sy[:, 1], sy[:, 2]
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    backface = area2 <= 0.0
    keep = valid & ~(backface & ~double_sided)
    # Degenerate and sliver pieces never win meaningfully: drop them.
    keep &= area2.abs() > 1e-7
    inv_a = 1.0 / torch.where(area2.abs() < 1e-30, 1e-30, area2)

    def edge(xa, ya, xb, yb):
        """Edge form scaled to a barycentric: a*sx + b*sy + c = signed
        twice-area of (p, a, b) / area2."""
        return ((ya - yb) * inv_a, (xb - xa) * inv_a,
                (xa * yb - xb * ya) * inv_a)

    e0 = edge(x1, y1, x2, y2)   # lambda_0
    e1 = edge(x2, y2, x0, y0)   # lambda_1
    e2 = edge(x0, y0, x1, y1)   # lambda_2
    lam = (e0, e1, e2)

    def interp(vals):
        """The linear form of sum_k lambda_k * vals[:, k]."""
        return tuple(sum(lam[k][j] * vals[:, k] for k in range(3))
                     for j in range(3))

    fw = interp(iw)                  # 1/w at the pixel
    fu = interp(iw * bb[..., 1])     # perspective-weighted original u
    fv = interp(iw * bb[..., 2])
    fz = interp(sz)                  # screen-linear reverse z

    # Subtile bbox from the piece's screen extent at pixel centres.
    xmin = torch.minimum(torch.minimum(x0, x1), x2)
    xmax = torch.maximum(torch.maximum(x0, x1), x2)
    ymin = torch.minimum(torch.minimum(y0, y1), y2)
    ymax = torch.maximum(torch.maximum(y0, y1), y2)
    keep &= (xmax >= 0.0) & (xmin < width) & (ymax >= 0.0) & (ymin < height)
    keep &= torch.isfinite(xmin) & torch.isfinite(xmax)
    keep &= torch.isfinite(ymin) & torch.isfinite(ymax)

    def tile_of(x, size, n):
        return torch.clamp((x - 0.5) / size, 0, n - 1).to(torch.int32)

    tx0, tx1 = tile_of(xmin, TILE_W, ntx), tile_of(xmax, TILE_W, ntx)
    ty0, ty1 = tile_of(ymin, TILE_H, nty), tile_of(ymax, TILE_H, nty)
    big = ((tx1 - tx0) >= SPAN) | ((ty1 - ty0) >= SPAN)

    key = torch.where(keep, torch.where(big, _KEY_BIG, ty0 * ntx + tx0),
                      _KEY_CULL).to(torch.int32)
    tri_id = torch.arange(pp.shape[0] // 2, dtype=torch.int32,
                          device=pp.device)
    tri_id = torch.cat([tri_id, tri_id])  # the caller stacks A, then B
    cols = [*e0, *e1, *e2, *fw, *fu, *fv, *fz,
            tri_id.to(torch.float32),
            (tx0 + 4096 * ty0).to(torch.float32),
            (tx1 + 4096 * ty1).to(torch.float32)]
    recs = torch.stack(cols, dim=-1)
    recs = torch.where(keep[:, None],
                       torch.nan_to_num(recs, nan=0.0, posinf=0.0,
                                        neginf=0.0), 0.0)
    return recs, key


def _segments(offsets, tile_ids, ntx, nty):
    """Candidate segments of each subtile in the sorted records: row ty - 1
    and row ty, columns tx - 1 .. tx, clamped at the borders.  Returns
    (startA, lenA, startB, lenB)."""
    ty = tile_ids // ntx
    tx = tile_ids % ntx
    c0 = torch.clamp(tx - 1, min=0)

    def seg(row, row_valid):
        row = torch.clamp(row, 0, nty - 1)
        start = offsets[row * ntx + c0]
        end = offsets[row * ntx + tx + 1]
        return start, torch.where(row_valid, end - start, 0)

    sa, la = seg(ty - 1, ty >= 1)
    sb, lb = seg(ty, torch.ones_like(ty, dtype=torch.bool))
    return sa, la, sb, lb


def _form(r, base: int, px, py):
    """a*px + b*py + c of the record columns base..base+2, each operation
    rounded on its own (the kernel's order, with no fused multiply-add)."""
    return r[..., base] * px + r[..., base + 1] * py + r[..., base + 2]


def _raster_tiles_plain(recs_sorted, tile_ids, segments, ntx):
    """The plain version of _raster_tiles: the reference's slice loop over
    batches of subtiles, the trip counts read on the host."""
    device = recs_sorted.device
    n_rows = recs_sorted.shape[0]
    window = WINDOW
    idx = torch.arange(PX, device=device)
    sub = (idx // TILE_W).to(torch.float32)
    lane = (idx % TILE_W).to(torch.float32)
    lidx = torch.arange(window, device=device)
    batch = max(1, _PLAIN_CHUNK_BYTES[device.type] // (PX * window * 32))
    outs = []
    for b0 in range(0, tile_ids.shape[0], batch):
        tid = tile_ids[b0:b0 + batch].to(torch.int64)
        segs = [s[b0:b0 + batch].to(torch.int64) for s in segments]
        ty, tx = tid // ntx, tid % ntx
        px = ((tx * TILE_W).to(torch.float32)[:, None] + lane + 0.5)[..., None]
        py = ((ty * TILE_H).to(torch.float32)[:, None] + sub + 0.5)[..., None]
        shape = (tid.shape[0], PX)
        bz = torch.full(shape, -1.0, device=device)
        bu = torch.zeros(shape, device=device)
        bv = torch.zeros(shape, device=device)
        bw = torch.ones(shape, device=device)
        bt = torch.full(shape, -1.0, device=device)
        for start, length in zip(segs[0::2], segs[1::2]):
            slices = int(((length + window - 1) // window).max())
            for i in range(slices):
                count = length - i * window
                rows = torch.clamp(start[:, None] + i * window + lidx,
                                   max=n_rows - 1)
                recs_w = recs_sorted[rows]                    # (B, W, 24)
                pok = lidx[None, :] < count[:, None]
                bmin = recs_w[..., _BMIN].to(torch.int64)
                bmax = recs_w[..., _BMAX].to(torch.int64)
                pok &= (tx[:, None] >= bmin % 4096) & (tx[:, None]
                                                       <= bmax % 4096)
                pok &= (ty[:, None] >= bmin // 4096) & (ty[:, None]
                                                        <= bmax // 4096)
                r = recs_w[:, None]                           # (B, 1, W, 24)
                z = _form(r, _Z, px, py)                      # (B, PX, W)
                inside = ((_form(r, _E0, px, py) >= 0.0)
                          & (_form(r, _E1, px, py) >= 0.0)
                          & (_form(r, _E2, px, py) >= 0.0)
                          & (z > 0.0) & (z <= 1.0) & pok[:, None, :])
                zm = torch.where(inside, z, -1.0)
                sz = zm.max(dim=-1).values
                # Pin ONE winning piece (the last of the greatest z), then
                # take every attribute from it.
                win = (zm == sz[..., None]) & (zm > 0.0)
                si = torch.where(win, lidx, -1).max(dim=-1).values
                rw = torch.gather(recs_w, 1, si.clamp(min=0)[..., None]
                                  .expand(-1, -1, _REC_COLS))  # (B, PX, 24)
                px2, py2 = px[..., 0], py[..., 0]
                take = sz > bz
                bz = torch.where(take, sz, bz)
                bu = torch.where(take, _form(rw, _FU, px2, py2), bu)
                bv = torch.where(take, _form(rw, _FV, px2, py2), bv)
                bw = torch.where(take, _form(rw, _FW, px2, py2), bw)
                bt = torch.where(take, rw[..., _TRI], bt)
        outs.append((bz, bu, bv, bw, bt))
    return tuple(torch.cat(parts) for parts in zip(*outs))


def corner_max(recs, base: int, tx, ty, strip):
    """The linear form at record columns base..base+2 of `recs` (..., 24)
    float32 at the corner pixel centre of the raster kernel's strip
    `strip` (rows STRIP_ROWS * strip .. STRIP_ROWS * strip + STRIP_ROWS - 1)
    of subtile (tx, ty) where it is largest: x_hi where a >= 0, else x_lo;
    likewise y (tx, ty, strip: integer tensors that broadcast with
    recs[..., 0]).  Evaluated as every pixel evaluates it (_form), it
    bounds the form at every pixel centre of the strip: each rounded
    operation is monotone, so no margin is needed.  The raster kernel
    evaluates the same operations in the same order."""
    row = ty * TILE_H + STRIP_ROWS * strip
    x_lo = (tx * TILE_W).to(torch.float32) + 0.5
    y_lo = row.to(torch.float32) + 0.5
    x = torch.where(recs[..., base] >= 0.0, x_lo + (TILE_W - 1), x_lo)
    y = torch.where(recs[..., base + 1] >= 0.0, y_lo + (STRIP_ROWS - 1),
                    y_lo)
    return _form(recs, base, x, y)


def strip_rejects(recs, tx, ty, strip):
    """Whether the raster kernel's warps that own strip `strip` of subtile
    (tx, ty) skip each record of `recs`: one of its edge forms is below 0
    at corner_max, so at every pixel centre of the strip."""
    out = [corner_max(recs, base, tx, ty, strip) < 0.0
           for base in (_E0, _E1, _E2)]
    return out[0] | out[1] | out[2]


def density_order(la, lb):
    """The rows by descending local candidate count (la + lb; the big
    segment is the same for every subtile): the order in which the raster
    kernel's blocks take them, computed on the rows' device."""
    return torch.argsort(la + lb, descending=True).to(torch.int32)


def raster_tiles_launcher(recs_sorted, tile_ids, segments, ntx):
    """Check the inputs of one launch of the raster kernel (csrc/raster.cu)
    on CUDA tensors and allocate its outputs.  Returns (launch, out): each
    `launch()` runs the kernel on the current stream into out's five
    (tiles, 768) float32 tensors (bz, fu, fv, fw, ft) and adds one to
    cuda_traverse.LAUNCHES["R"].  The wrapper calls it once; a benchmark
    can repeat it without the wrapper's host work.  The tie rule's slices
    are WINDOW pieces long; the blocks take the rows in density_order."""
    from steeljax_torch.accel.cuda_traverse import _launch_fn

    if WINDOW < 1:
        raise ValueError(f"the tie rule's slices need WINDOW >= 1, got "
                         f"{WINDOW}")
    device = recs_sorted.device
    if device.type != "cuda":
        raise ValueError(f"the raster kernel needs CUDA tensors, got "
                         f"{device}")
    if (recs_sorted.dtype != torch.float32 or recs_sorted.dim() != 2
            or recs_sorted.shape[1] != _REC_COLS
            or not recs_sorted.is_contiguous()
            or recs_sorted.data_ptr() % 16):
        raise ValueError(f"records must be contiguous 16-byte aligned (P, "
                         f"{_REC_COLS}) float32, got "
                         f"{tuple(recs_sorted.shape)} {recs_sorted.dtype}")
    n = tile_ids.shape[0]
    ints = [x.to(torch.int32).contiguous() for x in (tile_ids, *segments)]
    if len(ints) != 7 or any(x.shape != (n,) or x.device != device
                             for x in ints):
        raise ValueError("tile_ids and the six segment arrays must be (n,) "
                         f"on {device}")
    order = density_order(ints[2], ints[4])
    out = tuple(torch.empty((n, PX), dtype=torch.float32, device=device)
                for _ in range(5))
    args = [x.data_ptr() for x in (recs_sorted, ints[0], order, *ints[1:],
                                   *out)]
    args += [recs_sorted.shape[0], n, ntx, WINDOW]
    return _launch_fn("R", "steeljax_raster_tiles", args,
                      [recs_sorted, *ints, order, *out]), out


def _raster_tiles(recs_sorted, tile_ids, segments, ntx):
    """Rasterize 32x24 subtiles: `tile_ids` (n,) and their segments (sa,
    la, sb, lb, gstart, glen), each (n,), over the sorted records.
    Returns (bz, fu, fv, fw, ft), each (n, 768): the winner's reverse z
    (-1: no piece), Fu, Fv, Fw (0, 0, 1 on a miss) and triangle id (-1).
    The kernel csrc/raster.cu for CUDA tensors, the plain version only for
    CPU tensors."""
    if recs_sorted.device.type == "cuda":
        launch, out = raster_tiles_launcher(recs_sorted, tile_ids, segments,
                                            ntx)
        launch()
        return out
    if recs_sorted.device.type != "cpu":
        raise ValueError(f"no raster path for device {recs_sorted.device}")
    return _raster_tiles_plain(recs_sorted, tile_ids, segments, ntx)


def _w_eps(camera_near):
    """max(near / 2, 1e-4) in float32: a 0-d tensor for a tensor `near`,
    else a Python float holding the float32 value (no host-to-device copy
    in the frame)."""
    if isinstance(camera_near, torch.Tensor):
        return torch.clamp(camera_near.to(torch.float32) * 0.5, min=1e-4)
    near = torch.tensor(float(camera_near), dtype=torch.float32) * 0.5
    return float(torch.clamp(near, min=1e-4))


def _pieces(rscene: RasterScene, view_proj, camera_near):
    """The vertex stage: the clipped pieces (vertices (2T, 3, 4),
    barycentrics (2T, 3, 3), valid (2T,), double-sided (2T,)), piece A of
    every triangle, then piece B."""
    verts = torch.stack([rscene.v0, rscene.v0 + rscene.e1,
                         rscene.v0 + rscene.e2], dim=1)      # (T, 3, 3)
    clip = torch.cat([verts, torch.ones_like(verts[..., :1])],
                     dim=-1) @ view_proj.T                   # (T, 3, 4)
    bary = torch.eye(3, dtype=torch.float32,
                     device=clip.device).expand(clip.shape[0], 3, 3)
    (pa, ba, va), (pb, bbb, vb) = _clip_near(clip, bary,
                                             _w_eps(camera_near))
    valid = rscene.in_raster & (rscene.v0[:, 0].abs() < 3.0e36)
    return (torch.cat([pa, pb]), torch.cat([ba, bbb]),
            torch.cat([va & valid, vb & valid]),
            torch.cat([rscene.double_sided, rscene.double_sided]))


def _binned(rscene: RasterScene, view_proj, width: int, height: int,
            camera_near):
    """Vertex stage and binning: (records sorted by key, padded by WINDOW
    zero rows; the sorted keys; tile ids (n_tiles,); their segments (sa,
    la, sb, lb, gstart, glen)).  No value is read on the host."""
    ntx, nty = width // TILE_W, height // TILE_H
    n_tiles = ntx * nty
    recs, key = _piece_records(*_pieces(rscene, view_proj, camera_near),
                               width, height, ntx, nty)
    # Stable: pieces of one key keep their order, which the tie rule reads.
    key_sorted, perm = torch.sort(key, stable=True)
    recs_sorted = torch.cat([recs[perm], recs.new_zeros((WINDOW,
                                                         _REC_COLS))])
    device = key.device
    tile_ids = torch.arange(n_tiles, dtype=torch.int32, device=device)
    offsets = torch.searchsorted(key_sorted, torch.arange(
        n_tiles + 1, dtype=torch.int32, device=device)).to(torch.int32)
    off_big = (key_sorted < _KEY_BIG).sum().to(torch.int32)
    off_cull = (key_sorted < _KEY_CULL).sum().to(torch.int32)
    sa, la, sb, lb = _segments(offsets, tile_ids, ntx, nty)
    gstart = off_big.expand(n_tiles)
    glen = (off_cull - off_big).expand(n_tiles)
    return recs_sorted, key_sorted, tile_ids, (sa, la, sb, lb, gstart, glen)


def raster_visibility(rscene: RasterScene, view_proj, width: int,
                      height: int, camera_near):
    """Full-frame rasterized nearest-opaque visibility.  Returns (hit, tri,
    u, v, w_eye), each (H*W,) in RASTER ROW ORDER ((ty, tx, sub, lane));
    `to_tiled` reorders to a tiled_order ray layout."""
    recs_sorted, _, tile_ids, segments = _binned(
        rscene, view_proj, width, height, camera_near)
    bz, fu, fv, fw, ft = (a.reshape(-1) for a in _raster_tiles(
        recs_sorted, tile_ids, segments, width // TILE_W))
    hit = bz > 0.0
    inv_fw = 1.0 / torch.where(fw.abs() < 1e-30, 1e-30, fw)
    u = torch.where(hit, fu * inv_fw, 0.0)
    v = torch.where(hit, fv * inv_fw, 0.0)
    tri = torch.where(hit, ft.to(torch.int32), -1)
    w_eye = torch.where(hit, inv_fw, -1.0)
    return hit, tri, u, v, w_eye


def raster_stats(rscene: RasterScene, view_proj, width: int, height: int,
                 camera_near) -> dict:
    """Binning statistics of a frame: pieces, big_count, max_segment and
    mean_segment (host values)."""
    _, _, _, (_, la, _, lb, gstart, glen) = _binned(
        rscene, view_proj, width, height, camera_near)
    seg = la + lb
    return {"pieces": int(gstart[0] + glen[0]), "big_count": int(glen[0]),
            "max_segment": int(seg.max()),
            "mean_segment": float(seg.to(torch.float32).mean())}


def to_tiled(arr, width: int, height: int, tile):
    """Raster row order ((ty, tx, sub, lane)) to the tiled_order ray order
    of tile (tw, th), as pure reshape and permute (never a gather)."""
    tw, th = tile
    c = tuple(arr.shape[1:])
    rest = tuple(range(4, 4 + len(c)))
    frame = arr.reshape((height // TILE_H, width // TILE_W, TILE_H,
                         TILE_W) + c).permute(0, 2, 1, 3, *rest)
    r = frame.reshape((height // th, th, width // tw, tw) + c)
    return r.permute(0, 2, 1, 3, *rest).reshape((-1,) + c)


def raster_rec(rscene: RasterScene, view_proj, width: int, height: int,
               tile, d, camera_near) -> dict:
    """trace_nearest's record from the raster, in the caller's tiled_order
    ray layout (tile = (tw, th)); `d` holds the unit ray directions in that
    layout."""
    hit, tri, u, v, w_eye = (
        to_tiled(a, width, height, tile) for a in raster_visibility(
            rscene, view_proj, width, height, camera_near))
    # w_clip is the eye-forward distance (perspectiveRH_ZO: w_clip =
    # -z_eye, so view_proj's row 3 is the unit forward linear form); t
    # along the unit ray is w / (d . forward).
    fwd = view_proj[3, :3]
    fwd = fwd / torch.clamp(torch.linalg.vector_norm(fwd), min=1e-12)
    cosf = torch.clamp((d * fwd).sum(dim=-1), min=1e-6)
    t = torch.where(hit, w_eye / cosf, -1.0)
    return {"hit": hit, "tri": tri, "t": t, "u": torch.clamp(u, 0.0, 1.0),
            "v": torch.clamp(v, 0.0, 1.0)}
