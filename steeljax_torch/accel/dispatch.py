"""Trace tables, the nearest-hit query and the any-hit query.

Port of steeljax/accel/dispatch.py:76-135 (ChunkTables/TraceTables),
:159-343 (prepare_tables, _prepare_treelet_tables), :346-365
(make_trace_tables), :368-418 (attach_shade_tables), :426-442
(_chunk_interval), :451-530 (trace_nearest) and :533-589 (trace_any).
The reference picks its backend with a `use_pallas` flag; here the device
of the tensors decides (cuda_traverse.trace_nearest_bvh8,
trace_any_bvh8).  Fused-shading tables
are always attached for scenes without alpha-tested materials, so the CPU
runs the same fused path as the card.  Alpha-masked tables carry the
coarse masks in the triangle records and, unless asked otherwise, the fine
mask rows on every device (the reference builds those only for the TPU),
so the CPU and the card run the same kernel instances' arithmetic.

A scene above `max_chunk` triangles (MAX_CHUNK_TRIS, read when
prepare_tables is called) is cut into Morton-ordered chunks, each with its
own tree and tables, and a trace runs the chunks in turn: every chunk is
launched with the rays' interval pre-culled against its AABB (a ray that
cannot reach it is dead there), and t_max shrinks to the best hit so far.
The reference skips a chunk no ray can reach with a lax.cond; that test
would read the device on the host once per chunk and trace, so here every
chunk is launched and its dead rays leave at the root.  The K-nearest
query (K5) traces one chunk, as the reference's integrator gates it.
`prepare_tables(treelets=True)` builds the streamed-treelet tables instead
(accel.treelets, kernel K7), and both queries route
instances.InstancedTables to the two-level trace (K6).
STEELJAX_SHADE_MODE caps the fused shading mode of the flat nearest trace
(_shade_mode_cap).

`trace_nearest_walk` and `trace_any_walk` are the reference's
`use_pallas=False` branches (:451-530, :533-589): every chunk's binary tree
walked by accel.traverse over the chunk's slice of the permuted triangle
arrays, through the same sweep.  They are the oracle the kernels are held
against (apps.kernel_parity, chip_smoke.py phase 20), not the render path:
the port's CPU route stays on the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from steeljax_torch.accel import cuda_traverse, traverse
from steeljax_torch.accel import treelets as treelets_lib
from steeljax_torch.accel.alphamask import MASK_FULL
from steeljax_torch.accel.bvh import (BVH, BVH8, DENSE_PER_ROW, SNODE_WIDTH,
                                      _align_leaves, _morton3, build_bvh,
                                      collapse_bvh8)
from steeljax_torch.accel.instances import (InstancedTables,
                                            trace_nearest_instanced,
                                            trace_nearest_instanced_walk)
from steeljax_torch.core import profiling
from steeljax_torch.core.constants import RAY_DEAD_T

# The reference's chunk size (steeljax/accel/dispatch.py MAX_CHUNK_TRIS):
# scenes up to this count are one chunk there, and so here; a larger scene
# is cut into ceil(count / MAX_CHUNK_TRIS) chunks of equal size.
MAX_CHUNK_TRIS = 1_900_000


@dataclasses.dataclass
class ChunkTables:
    bvh: BVH                   # binary tree (host)
    # Supernode rows and (R, 128) pack_tris rows (device); both None in the
    # metadata-only chunk of treelet tables.
    bvh8: BVH8 | None
    tris_packed: torch.Tensor | None
    # Fused-shading rows (pack_shade_records in the tables' shade mode),
    # None until attach_shade_tables.
    shade_packed: torch.Tensor | None = None
    # Dense any-hit tables (pack_tris_dense rows over supernode rows of the
    # same tree with leaves re-aligned to DENSE_PER_ROW, and their Hopper
    # record table, cuda_traverse.hopper_records(anyhit_tris, dense=True),
    # which the kernel K2_dense reads), built only when prepare_tables is
    # asked to; occlusion queries then read them.
    anyhit_bvh8: BVH8 | None = None
    anyhit_tris: torch.Tensor | None = None
    anyhit_records: torch.Tensor | None = None
    # Alpha-masked tables: the permuted coarse masks ((rows,) int32, also in
    # the records' AUX words) and the fine mask rows ((R, 128) int32
    # pack_fine_mask_rows, parallel to tris_packed), or None.
    tri_mask: torch.Tensor | None = None
    fine_mask_rows: torch.Tensor | None = None
    # The Hopper record table the kernels K1-K5 read
    # (cuda_traverse.hopper_records of tris_packed), derived on the device
    # for every chunk that has triangle rows.
    tri_records: torch.Tensor | None = None
    row_offset: int = 0
    rows: int = 0
    # Chunk AABB of the real triangles.
    aabb: tuple = ((0.0,) * 3, (0.0,) * 3)

    def replace(self, **changes) -> "ChunkTables":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class TraceTables:
    chunks: tuple  # tuple[ChunkTables, ...], in row_offset order
    # Streamed-treelet tables (treelets.TreeletTables), set by
    # prepare_tables(treelets=True); the one chunk then carries metadata
    # only (binary tree, row count, scene AABB) for the integrator's bounds
    # and size queries.
    treelets: treelets_lib.TreeletTables | None = None
    # 0 = trace only; 1 = fuse (normal, mat id) into the kernel; 2 = also
    # (tangent, uv, uv density).
    shade_mode: int = 0
    # The triangle records carry coarse alpha masks in their AUX words.
    alpha_masked: bool = False
    # Slots of the multi-hit kernel K5 on the alpha path (0: single-hit
    # re-trace), the reference's STEELJAX_MULTIHIT_K.
    multihit_k: int = 0

    @property
    def bvh8(self) -> BVH8:
        return self.chunks[0].bvh8

    def replace(self, **changes) -> "TraceTables":
        return dataclasses.replace(self, **changes)


def _permute(order: np.ndarray, padded: int, arr: np.ndarray, fill):
    """`arr` reordered by `order` into `padded` slots; pad slots get
    `fill`."""
    out = np.full((padded,) + arr.shape[1:], fill, arr.dtype)
    if len(order):
        real = order >= 0
        out[np.nonzero(real)[0]] = arr[order[real]]
    return out


def _permuted(order: np.ndarray, padded: int, tri_pos, ds):
    return (_permute(order, padded, tri_pos, np.float32(3.0e37)),
            _permute(order, padded, np.asarray(ds, bool), False))


def prepare_tables(tri_pos, tri_double_sided, device: torch.device | str,
                   leaf_size: int = 24, max_chunk: int | None = None,
                   dense_anyhit: bool = False,
                   tri_alpha_mask: np.ndarray | None = None,
                   tri_fine_mask: np.ndarray | None = None,
                   treelets: bool = False,
                   treelet_tris: int = treelets_lib.TREELET_TRIS,
                   snode_width: int = SNODE_WIDTH, method: str = "auto"
                   ) -> tuple[TraceTables, np.ndarray, int]:
    """Build the acceleration tables on `device`: one chunk, or above
    `max_chunk` triangles (default MAX_CHUNK_TRIS, read at the call)
    ceil(count / max_chunk) chunks, the triangles' centroid Morton order
    cut into equal runs (np.array_split), each with its own tree, rows
    and AABB, its rows at `row_offset` of the concatenated order.  Every
    tree, a chunk's or the treelets' one, is built by bvh.build_bvh's
    `method` ("auto" follows STEELJAX_SBVH, as in the reference); with
    spatial splits `order` is a reference list and each slot gets its own
    record, masks and fine rows.

    `snode_width` (8 or 16) is the supernode rows' width, the counterpart
    of the reference's STEELJAX_BVH_WIDTH (8 by default there and here).
    `treelets` builds the streamed-treelet tables instead (the reference's
    STEELJAX_TREELETS=1 and prepare_tables(treelets=True), off by default;
    an argument here, not an environment variable), cut into treelets of at
    most `treelet_tris` triangles: one tree at width 8, with the coarse
    masks but neither fine rows nor dense any-hit tables.

    `dense_anyhit` also builds the dense any-hit tables, the counterpart of
    the reference's STEELJAX_DENSE_ANYHIT=1 (off by default there and here).
    `tri_alpha_mask` ((T,) uint32, alphamask.compute_alpha_masks) bakes the
    coarse alpha masks into the triangle records' AUX words, and
    `tri_fine_mask` ((T, FINE_STRIDE) int32, alphamask.compute_fine_masks)
    adds the fine mask rows; both are dropped when every triangle's coarse
    mask is MASK_FULL (masking is then a no-op), and masked tables get no
    dense any-hit tables (their rows carry no masks).  Every chunk also
    gets the Hopper record table the kernels K1-K5 read, derived on the
    device from the triangle rows (cuda_traverse.hopper_records), and the
    dense any-hit tables their own, from the dense rows.
    The whole is the span `dispatch.prepare_tables` and each step a
    `prepare_tables.<step>` span (core.profiling), those that launch device
    work ending in a synchronize.

    Returns (tables, order, total_padded): reorder every per-triangle array
    by `order` (global ids; entries of -1 are pad slots) and pad to
    total_padded — bvh.apply_permutation does both."""
    with profiling.named_scope("dispatch.prepare_tables", sync=device):
        if max_chunk is None:
            max_chunk = MAX_CHUNK_TRIS
        tri_pos = np.asarray(tri_pos, np.float32)
        ds = np.asarray(tri_double_sided)
        count = len(tri_pos)
        mask = (None if tri_alpha_mask is None
                else np.asarray(tri_alpha_mask, np.uint32))
        if mask is not None and count and int(mask.min()) == MASK_FULL:
            mask = None
        fine = (np.asarray(tri_fine_mask, np.int32)
                if tri_fine_mask is not None and mask is not None else None)
        dense_anyhit = dense_anyhit and mask is None
        if treelets:
            return _prepare_treelet_tables(tri_pos, ds, device, leaf_size,
                                           mask, treelet_tris, method)

        if count <= max_chunk:
            pieces = [np.arange(count, dtype=np.int64)]
        else:
            with profiling.named_scope("prepare_tables.morton_split"):
                # steeljax/accel/dispatch.py:213-223.
                centroids = tri_pos.mean(axis=1)
                lo = centroids.min(axis=0)
                extent = np.maximum(centroids.max(axis=0) - lo, 1e-9)
                q = np.clip((centroids - lo) / extent * 1023.0,
                            0, 1023).astype(np.uint32)
                morton = np.argsort(_morton3(q),
                                    kind="stable").astype(np.int64)
                pieces = np.array_split(morton, -(-count // max_chunk))

        chunks, order_parts, offset = [], [], 0
        for piece in pieces:
            def part(arr):
                # One chunk holds every triangle in its own order: no copy.
                if arr is None or len(pieces) == 1:
                    return arr
                return arr[piece]

            chunk, sub_order = _prepare_chunk(
                part(tri_pos), part(ds), part(mask), part(fine), device,
                leaf_size, dense_anyhit, snode_width, offset, method)
            # The chunk-local order (with -1 pads) as global ids.
            order_parts.append(
                np.where(sub_order >= 0, piece[np.clip(sub_order, 0, None)],
                         -1)
                if len(pieces) > 1 else sub_order)
            chunks.append(chunk)
            offset += chunk.rows
        return (TraceTables(chunks=tuple(chunks),
                            alpha_masked=mask is not None),
                np.concatenate(order_parts), offset)


def _prepare_chunk(tri_pos, ds, mask, fine, device, leaf_size: int,
                   dense_anyhit: bool, snode_width: int, row_offset: int,
                   method: str) -> tuple[ChunkTables, np.ndarray]:
    """The tables of one chunk's triangles (chunk-local arrays) at
    `row_offset` of the concatenated order: (chunk, chunk-local order with
    -1 pads)."""
    with profiling.named_scope("prepare_tables.build_bvh"):
        bvh, order, padded = build_bvh(tri_pos, leaf_size, method)
    with profiling.named_scope("prepare_tables.collapse_bvh8"):
        rows8, depth8 = collapse_bvh8(bvh.nodes, leaf_size,
                                      width=snode_width)
    anyhit_bvh8 = anyhit_tris = anyhit_records = None
    if dense_anyhit:
        with profiling.named_scope("prepare_tables.dense_anyhit_tables",
                                   sync=device):
            # The same binary tree, leaves re-aligned to DENSE_PER_ROW, and
            # ds-less 9-float records (steeljax/accel/dispatch.py:259-277).
            dnodes, dorder, dpadded = _align_leaves(
                bvh.nodes, order, leaf_size, align=DENSE_PER_ROW)
            dense_pos, _ = _permuted(dorder, dpadded, tri_pos, ds)
            drows8, ddepth8 = collapse_bvh8(dnodes, leaf_size,
                                            width=snode_width)
            anyhit_bvh8 = BVH8(rows=torch.from_numpy(drows8).to(device),
                               depth=ddepth8, max_leaf=leaf_size,
                               width=snode_width)
            anyhit_tris = torch.from_numpy(
                cuda_traverse.pack_tris_dense(dense_pos)).to(device)
            anyhit_records = cuda_traverse.hopper_records(anyhit_tris,
                                                          dense=True)
    if len(tri_pos):
        real_pos = tri_pos.reshape(-1, 3)
        lo = tuple(float(v) for v in real_pos.min(axis=0))
        hi = tuple(float(v) for v in real_pos.max(axis=0))
    else:
        lo, hi = (0.0,) * 3, (0.0,) * 3
    with profiling.named_scope("prepare_tables.pack_tris", sync=device):
        permuted_pos, permuted_ds = _permuted(order, padded, tri_pos, ds)
        permuted_mask = (None if mask is None
                         else _permute(order, padded, mask, np.uint32(0)))
        chunk = ChunkTables(
            bvh=bvh,
            bvh8=BVH8(rows=torch.from_numpy(rows8).to(device), depth=depth8,
                      max_leaf=leaf_size, width=snode_width),
            tris_packed=torch.from_numpy(cuda_traverse.pack_tris(
                permuted_pos, permuted_ds,
                tri_alpha_mask=permuted_mask)).to(device),
            anyhit_bvh8=anyhit_bvh8, anyhit_tris=anyhit_tris,
            anyhit_records=anyhit_records,
            tri_mask=(None if mask is None else torch.from_numpy(
                permuted_mask.astype(np.int32)).to(device)),
            row_offset=row_offset, rows=padded, aabb=(lo, hi))
    with profiling.named_scope("prepare_tables.hopper_records",
                               sync=device):
        chunk = chunk.replace(tri_records=cuda_traverse.hopper_records(
            chunk.tris_packed))
    if fine is not None:
        with profiling.named_scope("prepare_tables.pack_fine_mask_rows",
                                   sync=device):
            chunk = chunk.replace(fine_mask_rows=torch.from_numpy(
                cuda_traverse.pack_fine_mask_rows(_permute(
                    order, padded, fine, np.int32(0)))).to(device))
    return chunk, order


def _prepare_treelet_tables(tri_pos, ds, device, leaf_size: int,
                            mask: np.ndarray | None, max_tris: int,
                            method: str
                            ) -> tuple[TraceTables, np.ndarray, int]:
    """One global BVH cut into streamed treelets (accel.treelets) of at most
    `max_tris` slots.  The kept chunk carries metadata only; the kernel
    reads the per-treelet stacks."""
    with profiling.named_scope("prepare_tables.build_bvh"):
        bvh, order, padded = build_bvh(tri_pos, leaf_size, method)
    with profiling.named_scope("prepare_tables.pack_tris"):
        permuted_pos, permuted_ds = _permuted(order, padded, tri_pos, ds)
        permuted_mask = (None if mask is None
                         else _permute(order, padded, mask, np.uint32(0)))
        packed = cuda_traverse.pack_tris(permuted_pos, permuted_ds,
                                         tri_alpha_mask=permuted_mask)
    with profiling.named_scope("prepare_tables.build_treelet_tables",
                               sync=device):
        tt = treelets_lib.build_treelet_tables(
            bvh.nodes, packed, leaf_size, device, max_tris=max_tris)
        tt = tt.replace(alpha_mask=mask is not None)
    real_pos = tri_pos.reshape(-1, 3)
    aabb = (tuple(float(v) for v in real_pos.min(axis=0)),
            tuple(float(v) for v in real_pos.max(axis=0)))
    chunk = ChunkTables(
        bvh=bvh, bvh8=None, tris_packed=None,
        tri_mask=(None if mask is None else torch.from_numpy(
            permuted_mask.astype(np.int32)).to(device)),
        row_offset=0, rows=padded, aabb=aabb)
    return (TraceTables(chunks=(chunk,), treelets=tt,
                        alpha_masked=mask is not None), order, padded)


def make_trace_tables(bvh: BVH, tri_pos, tri_double_sided,
                      device: torch.device | str,
                      snode_width: int = SNODE_WIDTH) -> TraceTables:
    """One-chunk tables on `device` from an existing BVH and its permuted
    (padded) triangle arrays (steeljax/accel/dispatch.py:346-365): its
    supernode rows, triangle rows and Hopper record table.  The chunk's
    AABB is that of the real (unpadded) triangles; the reference leaves it
    at zero, which only its repack's sort key would read."""
    tri_pos = np.asarray(tri_pos, np.float32)
    rows8, depth8 = collapse_bvh8(bvh.nodes, bvh.max_leaf, width=snode_width)
    tris_packed = torch.from_numpy(cuda_traverse.pack_tris(
        tri_pos, np.asarray(tri_double_sided, bool))).to(device)
    real = tri_pos[tri_pos[:, 0, 0] < 1e37].reshape(-1, 3)
    aabb = ((tuple(float(v) for v in real.min(axis=0)),
             tuple(float(v) for v in real.max(axis=0))) if len(real)
            else ((0.0,) * 3, (0.0,) * 3))
    chunk = ChunkTables(
        bvh=bvh,
        bvh8=BVH8(rows=torch.from_numpy(rows8).to(device), depth=depth8,
                  max_leaf=bvh.max_leaf, width=snode_width),
        tris_packed=tris_packed,
        tri_records=cuda_traverse.hopper_records(tris_packed),
        row_offset=0, rows=len(tri_pos), aabb=aabb)
    return TraceTables(chunks=(chunk,))


def attach_shade_tables(tables: TraceTables, tri_nrm, tri_mat,
                        textured: bool = False, tri_tan=None, tri_uv=None,
                        tri_uvd=None) -> TraceTables:
    """Fused-shading rows from the PERMUTED per-triangle arrays (the ones
    matching the BVH leaf order, padded to prepare_tables' total), on the
    tables' device: mode 1, or mode 2 when `textured` (which needs tri_tan
    and tri_uv; tri_uvd is the uv density, flatten.TriShade.UV_DENSITY)."""
    tri_nrm = np.asarray(tri_nrm)
    tri_mat = np.asarray(tri_mat)
    mode = 2 if textured else 1
    if tables.treelets is not None:
        # The treelet shade stack, at any treelet size (the reference's
        # budget for it sizes another chip's memory and is not ported).
        packed = cuda_traverse.pack_shade_records(
            tri_nrm, tri_mat, textured, tri_tan=tri_tan, tri_uv=tri_uv,
            tri_uvd=tri_uvd)
        return tables.replace(
            treelets=treelets_lib.attach_shade_stack(tables.treelets, packed,
                                                     mode),
            shade_mode=mode)

    def part(arr, s):
        return None if arr is None else np.asarray(arr)[s]

    chunks = []
    for chunk in tables.chunks:
        s = slice(chunk.row_offset, chunk.row_offset + chunk.rows)
        packed = cuda_traverse.pack_shade_records(
            tri_nrm[s], tri_mat[s], textured, tri_tan=part(tri_tan, s),
            tri_uv=part(tri_uv, s), tri_uvd=part(tri_uvd, s))
        chunks.append(chunk.replace(shade_packed=torch.from_numpy(packed).to(
            chunk.tris_packed.device)))
    return tables.replace(chunks=tuple(chunks), shade_mode=mode)


def _one_chunk(tables: TraceTables) -> ChunkTables:
    if len(tables.chunks) != 1:
        raise NotImplementedError(
            "the K-nearest kernel K5 traces one chunk, as the reference's "
            "integrator gates it (steeljax/render/pt/integrator.py:296-300); "
            f"these tables have {len(tables.chunks)} chunks, which the "
            "integrator re-traces hit by hit")
    return tables.chunks[0]


def _chunk_interval(chunk: ChunkTables, o: torch.Tensor, d: torch.Tensor,
                    t_min: torch.Tensor, t_max: torch.Tensor
                    ) -> torch.Tensor:
    """The rays' t_max over `chunk`: unchanged for a ray whose slab test
    against the chunk AABB leaves an interval within [t_min, t_max], else
    RAY_DEAD_T, so that the kernel rejects the ray at the root
    (steeljax/accel/dispatch.py:426-442).  The box corners enter as Python
    floats, exact float32 values, so the test reads nothing from the
    host."""
    lo, hi = chunk.aabb
    small = d.abs() < 1e-12
    inv = 1.0 / torch.where(small, torch.where(d < 0, -1e-12, 1e-12), d)
    near = far = None
    for axis in range(3):
        t0 = (lo[axis] - o[:, axis]) * inv[:, axis]
        t1 = (hi[axis] - o[:, axis]) * inv[:, axis]
        a, b = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = a if near is None else torch.maximum(near, a)
        far = b if far is None else torch.minimum(far, b)
    possible = (near <= far) & (far >= t_min) & (near <= t_max)
    return torch.where(possible, t_max, RAY_DEAD_T)


def _per_ray(x, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (N,) interval bound as an (N,) float32 tensor on
    `like`'s device (a scalar is filled there, not copied from the host)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).expand(like.shape[0])
    return torch.full((like.shape[0],), float(x), dtype=torch.float32,
                      device=like.device)


def sweep_nearest(chunks, trace_chunk, o: torch.Tensor, d: torch.Tensor,
                  t_min, t_max) -> dict:
    """The nearest-hit sweep over `chunks` (steeljax/accel/dispatch.py:
    451-530): `trace_chunk(chunk, chunk_t_max)` traces one chunk with the
    rays' interval pre-culled against its AABB (_chunk_interval); each
    record gets its chunk's row_offset added to tri, a later chunk's hit
    wins only at a strictly smaller t, and the next chunk's t_max is the
    best t so far.  trace_nearest passes the chunk kernels; a caller may
    pass their plain versions."""
    tmin, tmax = _per_ray(t_min, o), _per_ray(t_max, o)
    best = None
    for chunk in chunks:
        rec = trace_chunk(chunk, _chunk_interval(chunk, o, d, tmin, tmax))
        rec["tri"] = torch.where(rec["hit"], rec["tri"] + chunk.row_offset,
                                 -1)
        if best is None:
            best = rec
        else:
            better = rec["hit"] & (~best["hit"] | (rec["t"] < best["t"]))
            best = {k: torch.where(better if v.dim() == 1
                                   else better[:, None], rec[k], v)
                    for k, v in best.items()}
        # Later chunks need only closer hits.
        tmax = torch.where(best["hit"], best["t"], tmax)
    return best


def sweep_any(chunks, trace_chunk, o: torch.Tensor, d: torch.Tensor, t_min,
              t_max) -> torch.Tensor:
    """The occlusion sweep over `chunks` (steeljax/accel/dispatch.py:
    533-589): `trace_chunk(chunk, chunk_t_max)` as in sweep_nearest, (N,)
    bool; a ray already occluded is dead in the chunks after."""
    tmin, tmax = _per_ray(t_min, o), _per_ray(t_max, o)
    occluded = None
    for chunk in chunks:
        live_tmax = (tmax if occluded is None
                     else torch.where(occluded, RAY_DEAD_T, tmax))
        hit = trace_chunk(chunk, _chunk_interval(chunk, o, d, tmin, live_tmax))
        occluded = hit if occluded is None else occluded | hit
    return occluded


def _shade_mode_cap() -> int | None:
    """STEELJAX_SHADE_MODE, the cap on the flat nearest trace's fused
    shading mode (steeljax/accel/dispatch.py:27-32): unset is no cap, an
    integer >= 0 (as int() reads it) the cap.  Anything else, an empty or
    negative value included, raises ValueError.  The reference reads the
    switch once, at import; here it is read at every trace, as
    STEELJAX_SBVH, STEELJAX_REPACK and STEELJAX_RASTER are, so a process may
    change it between frames.  That changes when the value is read, not
    what it means."""
    value = os.environ.get("STEELJAX_SHADE_MODE")
    if value is None:
        return None
    try:
        cap = int(value)
    except ValueError:
        cap = -1
    if cap < 0:
        raise ValueError(f"STEELJAX_SHADE_MODE={value!r}: expected an integer "
                         ">= 0 (0 gathers the shading rows after the trace, "
                         "1 caps the fused mode at normal and material), or "
                         "unset for the tables' own mode")
    return cap


def _capped_shade_mode(tables: TraceTables) -> int:
    """The fused shading mode of a flat nearest trace: the tables' mode,
    capped by STEELJAX_SHADE_MODE (steeljax/accel/dispatch.py:476-478).  A
    cap of 1 over textured (mode 2) tables raises: their rows hold 26-float
    records, which a mode-1 trace would read as 10-float ones (the
    reference's kernel does, and its integrator then fails on the missing
    uv)."""
    cap = _shade_mode_cap()
    mode = tables.shade_mode
    if cap is None or cap >= mode:
        return mode
    if cap == 1:
        raise ValueError("STEELJAX_SHADE_MODE=1 over textured (shade mode 2) "
                         "tables: their shading rows hold mode-2 records; "
                         "use STEELJAX_SHADE_MODE=0 (gather the shading rows "
                         "after the trace) or leave it unset")
    return 0


def trace_nearest(tables: TraceTables | InstancedTables, o: torch.Tensor,
                  d: torch.Tensor, t_min, t_max, cull_backface: bool = True
                  ) -> dict:
    """Nearest hit over the scene's chunks; the record of
    cuda_traverse.trace_nearest_bvh8, with tri as an index into the permuted
    triangle arrays (-1 on a miss).  Alpha-masked tables trace with their
    masks (K4), instanced tables through the two-level trace (K6, with
    "inst" in the record and tri indexing the BLAS pool), treelet tables
    through the treelet scheduler (K7).  Several chunks trace through
    sweep_nearest, one kernel launch a chunk.

    STEELJAX_SHADE_MODE caps the fused mode of flat tables only
    (_capped_shade_mode): at 0 the record has no n/mat (nor tan/uv/uvd),
    and the integrator and the G-buffer gather the tri_shade rows instead.
    As in the reference, instanced and treelet tables keep their fused
    shading under any cap, and the occlusion query has none to cap.  The
    reference caps only its kernel path (use_pallas), because its CPU path
    has no fused shading at all; here the plain versions run the fused
    path the kernels do on every device, so the cap applies on both and
    the CPU and the card stay on one code path."""
    if isinstance(tables, InstancedTables):
        return trace_nearest_instanced(tables, o, d, t_min, t_max,
                                       cull_backface=cull_backface)
    if tables.treelets is not None:
        return treelets_lib.trace_treelets(tables.treelets, o, d, t_min,
                                           t_max,
                                           cull_backface=cull_backface)
    mode = _capped_shade_mode(tables)

    def trace(chunk, chunk_tmax):
        return cuda_traverse.trace_nearest_bvh8(
            chunk.bvh8, chunk.tris_packed, o, d, t_min, chunk_tmax,
            cull_backface=cull_backface, shade_rows=chunk.shade_packed,
            shade_mode=mode, alpha_mask=tables.alpha_masked,
            fine_rows=chunk.fine_mask_rows, records=chunk.tri_records)

    if len(tables.chunks) == 1:
        return trace(tables.chunks[0], t_max)
    return sweep_nearest(tables.chunks, trace, o, d, t_min, t_max)


def trace_any(tables: TraceTables | InstancedTables, o: torch.Tensor,
              d: torch.Tensor, t_min, t_max) -> torch.Tensor:
    """Occlusion over the scene's chunks, (N,) bool: the dense any-hit
    tables when they are attached (K2_dense), else the nearest tables' rows
    with culling off (K2, or with their masks K4_anyhit when
    alpha-masked), each with its chunk's Hopper record table; instanced and
    treelet tables through their own any-hit queries.  Several chunks trace
    through sweep_any."""
    if isinstance(tables, InstancedTables):
        return trace_nearest_instanced(tables, o, d, t_min, t_max,
                                       cull_backface=False,
                                       any_hit=True)["hit"]
    if tables.treelets is not None:
        return treelets_lib.trace_treelets(
            tables.treelets, o, d, t_min, t_max, cull_backface=False,
            any_hit=True)["hit"]

    def trace(chunk, chunk_tmax):
        bvh8, tris, records, dense = anyhit_tables(chunk)
        return cuda_traverse.trace_any_bvh8(
            bvh8, tris, o, d, t_min, chunk_tmax, dense=dense,
            alpha_mask=tables.alpha_masked, fine_rows=chunk.fine_mask_rows,
            records=records)

    if len(tables.chunks) == 1:
        return trace(tables.chunks[0], t_max)
    return sweep_any(tables.chunks, trace, o, d, t_min, t_max)


def _chunk_arrays(chunk: ChunkTables, tri_pos, tri_double_sided) -> tuple:
    """The chunk's slice of the permuted per-triangle arrays
    (steeljax/accel/dispatch.py:421-423)."""
    s = slice(chunk.row_offset, chunk.row_offset + chunk.rows)
    return tri_pos[s], tri_double_sided[s]


def trace_nearest_walk(tables: TraceTables | InstancedTables, tri_pos,
                       tri_double_sided, o: torch.Tensor, d: torch.Tensor,
                       t_min, t_max, cull_backface: bool = True,
                       stats: dict | None = None) -> dict:
    """The reference's CPU nearest hit (steeljax/accel/dispatch.py:451-530,
    use_pallas=False): each chunk's binary tree walked
    (traverse.trace_nearest) over its slice of `tri_pos`/`tri_double_sided`
    (the tables' permuted (T, 3, 3) positions and (T,) flags, as
    prepare_scene's FlatScene holds them) with the chunk's coarse masks;
    above one chunk through sweep_nearest (the AABB pre-cull, tri ids
    offset by row_offset, the interval shrunk to the best hit, a later
    chunk winning only at a strictly smaller t).  Instanced tables go to
    the two-level walk (instances.trace_nearest_instanced_walk; tri_pos is
    not read), treelet tables walk the one tree their treelets were cut
    from (the kept chunk's).  The record has the walk's fields: t, tri, u,
    v, hit (and inst), no fused shading.  `stats` is
    traverse.trace_nearest's."""
    if isinstance(tables, InstancedTables):
        return trace_nearest_instanced_walk(tables, o, d, t_min, t_max,
                                            cull_backface=cull_backface,
                                            stats=stats)

    def trace(chunk, chunk_tmax):
        return traverse.trace_nearest(
            chunk.bvh, *_chunk_arrays(chunk, tri_pos, tri_double_sided), o,
            d, t_min, chunk_tmax, cull_backface=cull_backface,
            tri_alpha_mask=chunk.tri_mask, stats=stats)

    if len(tables.chunks) == 1:
        return trace(tables.chunks[0], t_max)
    return sweep_nearest(tables.chunks, trace, o, d, t_min, t_max)


def trace_any_walk(tables: TraceTables | InstancedTables, tri_pos,
                   tri_double_sided, o: torch.Tensor, d: torch.Tensor, t_min,
                   t_max, stats: dict | None = None) -> torch.Tensor:
    """The reference's CPU occlusion query (steeljax/accel/dispatch.py:
    533-589, use_pallas=False): traverse.trace_any over each chunk's tree
    and slice with its coarse masks, through sweep_any above one chunk (a
    ray occluded in one chunk is dead in the next); instanced tables through
    the two-level walk's hit flags.  (N,) bool."""
    if isinstance(tables, InstancedTables):
        return trace_nearest_instanced_walk(
            tables, o, d, t_min, t_max, cull_backface=False,
            stats=stats)["hit"]

    def trace(chunk, chunk_tmax):
        return traverse.trace_any(
            chunk.bvh, *_chunk_arrays(chunk, tri_pos, tri_double_sided), o,
            d, t_min, chunk_tmax, tri_alpha_mask=chunk.tri_mask, stats=stats)

    if len(tables.chunks) == 1:
        return trace(tables.chunks[0], t_max)
    return sweep_any(tables.chunks, trace, o, d, t_min, t_max)


def anyhit_tables(chunk: ChunkTables) -> tuple:
    """(bvh8, rows, records, dense): the tables a chunk's occlusion query
    reads, the dense any-hit tables when they are attached (masked tables
    never have them), else the nearest tables'."""
    if chunk.anyhit_tris is not None:
        return (chunk.anyhit_bvh8, chunk.anyhit_tris, chunk.anyhit_records,
                True)
    return chunk.bvh8, chunk.tris_packed, chunk.tri_records, False


def trace_multihit(tables: TraceTables, o: torch.Tensor, d: torch.Tensor,
                   t_min, t_max, k_hits: int, cull_backface: bool = True
                   ) -> dict:
    """The k_hits nearest hits over the scene's one chunk (K5), with the
    tables' masks: cuda_traverse.trace_multihit_bvh8's (K, N) slots, tri
    indexing the permuted triangle arrays.  Tables of several chunks raise
    (_one_chunk)."""
    chunk = _one_chunk(tables)
    return cuda_traverse.trace_multihit_bvh8(
        chunk.bvh8, chunk.tris_packed, o, d, t_min, t_max, k_hits,
        cull_backface=cull_backface, alpha_mask=tables.alpha_masked,
        fine_rows=chunk.fine_mask_rows, records=chunk.tri_records)
