"""Trace tables, the nearest-hit query and the any-hit query.

Port of steeljax/accel/dispatch.py:76-135 (ChunkTables/TraceTables),
:159-343 (prepare_tables, _prepare_treelet_tables), :368-418
(attach_shade_tables), :451-530 (trace_nearest) and :533-589 (trace_any).
The reference picks its backend with a `use_pallas` flag; here the device
of the tensors decides (cuda_traverse.trace_nearest_bvh8,
trace_any_bvh8).  Fused-shading tables
are always attached for scenes without alpha-tested materials, so the CPU
runs the same fused path as the card.  Alpha-masked tables carry the
coarse masks in the triangle records and, unless asked otherwise, the fine
mask rows on every device (the reference builds those only for the TPU),
so the CPU and the card run the same kernel instances' arithmetic.

The port traces one chunk.  A scene larger than `max_chunk` raises: the
multi-chunk sweep is ROADMAP item 13.  `prepare_tables(treelets=True)`
builds the streamed-treelet tables instead (accel.treelets, kernel K7), and
both queries route instances.InstancedTables to the two-level trace (K6).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torch.profiler import record_function

from steeljax_torch.accel import cuda_traverse, treelets as treelets_lib
from steeljax_torch.accel.alphamask import MASK_FULL
from steeljax_torch.accel.bvh import (BVH, BVH8, DENSE_PER_ROW, _align_leaves,
                                      build_bvh, collapse_bvh8)
from steeljax_torch.accel.instances import (InstancedTables,
                                            trace_nearest_instanced)

# The reference's chunk size (steeljax/accel/dispatch.py MAX_CHUNK_TRIS):
# scenes up to this count are one chunk there, and so here.
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
    chunks: tuple  # tuple[ChunkTables, ...]; one chunk in the port
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
                   treelet_tris: int = treelets_lib.TREELET_TRIS
                   ) -> tuple[TraceTables, np.ndarray, int]:
    """Build the acceleration tables of one chunk on `device`.

    `treelets` builds the streamed-treelet tables instead (the reference's
    STEELJAX_TREELETS=1 and prepare_tables(treelets=True), off by default;
    an argument here, not an environment variable), cut into treelets of at
    most `treelet_tris` triangles: they carry the coarse masks but neither
    fine rows nor dense any-hit tables.

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
    Each step is a `prepare_tables.<step>` range for torch.profiler.

    Returns (tables, order, total_padded): reorder every per-triangle array
    by `order` (entries of -1 are pad slots) and pad to total_padded —
    bvh.apply_permutation does both."""
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
        return _prepare_treelet_tables(tri_pos, ds, device, leaf_size, mask,
                                       treelet_tris)
    if count > max_chunk:
        raise NotImplementedError(
            f"{count} triangles need {-(-count // max_chunk)} chunks of "
            f"{max_chunk}; the multi-chunk sweep is not ported yet "
            "(ROADMAP item 13)")

    with record_function("prepare_tables.build_bvh"):
        bvh, order, padded = build_bvh(tri_pos, leaf_size)
    with record_function("prepare_tables.collapse_bvh8"):
        rows8, depth8 = collapse_bvh8(bvh.nodes, leaf_size)
    anyhit_bvh8 = anyhit_tris = anyhit_records = None
    if dense_anyhit:
        with record_function("prepare_tables.dense_anyhit_tables"):
            # The same binary tree, leaves re-aligned to DENSE_PER_ROW, and
            # ds-less 9-float records (steeljax/accel/dispatch.py:259-277).
            dnodes, dorder, dpadded = _align_leaves(
                bvh.nodes, order, leaf_size, align=DENSE_PER_ROW)
            dense_pos, _ = _permuted(dorder, dpadded, tri_pos, ds)
            drows8, ddepth8 = collapse_bvh8(dnodes, leaf_size)
            anyhit_bvh8 = BVH8(rows=torch.from_numpy(drows8).to(device),
                               depth=ddepth8, max_leaf=leaf_size)
            anyhit_tris = torch.from_numpy(
                cuda_traverse.pack_tris_dense(dense_pos)).to(device)
            anyhit_records = cuda_traverse.hopper_records(anyhit_tris,
                                                          dense=True)
    if count:
        real_pos = tri_pos.reshape(-1, 3)
        lo = tuple(float(v) for v in real_pos.min(axis=0))
        hi = tuple(float(v) for v in real_pos.max(axis=0))
    else:
        lo, hi = (0.0,) * 3, (0.0,) * 3
    with record_function("prepare_tables.pack_tris"):
        permuted_pos, permuted_ds = _permuted(order, padded, tri_pos, ds)
        permuted_mask = (None if mask is None
                         else _permute(order, padded, mask, np.uint32(0)))
        chunk = ChunkTables(
            bvh=bvh,
            bvh8=BVH8(rows=torch.from_numpy(rows8).to(device), depth=depth8,
                      max_leaf=leaf_size),
            tris_packed=torch.from_numpy(cuda_traverse.pack_tris(
                permuted_pos, permuted_ds,
                tri_alpha_mask=permuted_mask)).to(device),
            anyhit_bvh8=anyhit_bvh8, anyhit_tris=anyhit_tris,
            anyhit_records=anyhit_records,
            tri_mask=(None if mask is None else torch.from_numpy(
                permuted_mask.astype(np.int32)).to(device)),
            row_offset=0, rows=padded, aabb=(lo, hi))
    with record_function("prepare_tables.hopper_records"):
        chunk = chunk.replace(tri_records=cuda_traverse.hopper_records(
            chunk.tris_packed))
    if fine is not None:
        with record_function("prepare_tables.pack_fine_mask_rows"):
            chunk = chunk.replace(fine_mask_rows=torch.from_numpy(
                cuda_traverse.pack_fine_mask_rows(_permute(
                    order, padded, fine, np.int32(0)))).to(device))
    return (TraceTables(chunks=(chunk,), alpha_masked=mask is not None),
            order, padded)


def _prepare_treelet_tables(tri_pos, ds, device, leaf_size: int,
                            mask: np.ndarray | None, max_tris: int
                            ) -> tuple[TraceTables, np.ndarray, int]:
    """One global SAH BVH cut into streamed treelets (accel.treelets).  The
    kept chunk carries metadata only; the kernel reads the per-treelet
    stacks."""
    with record_function("prepare_tables.build_bvh"):
        bvh, order, padded = build_bvh(tri_pos, leaf_size)
    with record_function("prepare_tables.pack_tris"):
        permuted_pos, permuted_ds = _permuted(order, padded, tri_pos, ds)
        permuted_mask = (None if mask is None
                         else _permute(order, padded, mask, np.uint32(0)))
        packed = cuda_traverse.pack_tris(permuted_pos, permuted_ds,
                                         tri_alpha_mask=permuted_mask)
    with record_function("prepare_tables.build_treelet_tables"):
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


def attach_shade_tables(tables: TraceTables, tri_nrm, tri_mat,
                        textured: bool = False, tri_tan=None, tri_uv=None,
                        tri_uvd=None) -> TraceTables:
    """Fused-shading rows from the PERMUTED per-triangle arrays (the ones
    matching the BVH leaf order, padded to prepare_tables' total), on the
    tables' device: mode 1, or mode 2 when `textured` (which needs tri_tan
    and tri_uv; tri_uvd is the uv density, tri_shade column 27)."""
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
            "multi-chunk traces are not ported yet (ROADMAP item 13)")
    return tables.chunks[0]


def trace_nearest(tables: TraceTables | InstancedTables, o: torch.Tensor,
                  d: torch.Tensor, t_min, t_max, cull_backface: bool = True
                  ) -> dict:
    """Nearest hit over the scene's one chunk; the record of
    cuda_traverse.trace_nearest_bvh8, with tri as an index into the permuted
    triangle arrays (-1 on a miss).  Alpha-masked tables trace with their
    masks (K4), instanced tables through the two-level trace (K6, with
    "inst" in the record and tri indexing the BLAS pool), treelet tables
    through the treelet scheduler (K7)."""
    if isinstance(tables, InstancedTables):
        return trace_nearest_instanced(tables, o, d, t_min, t_max,
                                       cull_backface=cull_backface)
    if tables.treelets is not None:
        return treelets_lib.trace_treelets(tables.treelets, o, d, t_min,
                                           t_max,
                                           cull_backface=cull_backface)
    chunk = _one_chunk(tables)
    return cuda_traverse.trace_nearest_bvh8(
        chunk.bvh8, chunk.tris_packed, o, d, t_min, t_max,
        cull_backface=cull_backface, shade_rows=chunk.shade_packed,
        shade_mode=tables.shade_mode, alpha_mask=tables.alpha_masked,
        fine_rows=chunk.fine_mask_rows, records=chunk.tri_records)


def trace_any(tables: TraceTables | InstancedTables, o: torch.Tensor,
              d: torch.Tensor, t_min, t_max) -> torch.Tensor:
    """Occlusion over the scene's one chunk, (N,) bool: the dense any-hit
    tables when they are attached (K2_dense), else the nearest tables' rows
    with culling off (K2, or with their masks K4_anyhit when
    alpha-masked), each with its chunk's Hopper record table; instanced and
    treelet tables through their own any-hit queries."""
    if isinstance(tables, InstancedTables):
        return trace_nearest_instanced(tables, o, d, t_min, t_max,
                                       cull_backface=False,
                                       any_hit=True)["hit"]
    if tables.treelets is not None:
        return treelets_lib.trace_treelets(
            tables.treelets, o, d, t_min, t_max, cull_backface=False,
            any_hit=True)["hit"]
    chunk = _one_chunk(tables)
    bvh8, tris, records, dense = anyhit_tables(chunk)
    return cuda_traverse.trace_any_bvh8(
        bvh8, tris, o, d, t_min, t_max, dense=dense,
        alpha_mask=tables.alpha_masked, fine_rows=chunk.fine_mask_rows,
        records=records)


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
    indexing the permuted triangle arrays."""
    chunk = _one_chunk(tables)
    return cuda_traverse.trace_multihit_bvh8(
        chunk.bvh8, chunk.tris_packed, o, d, t_min, t_max, k_hits,
        cull_backface=cull_backface, alpha_mask=tables.alpha_masked,
        fine_rows=chunk.fine_mask_rows, records=chunk.tri_records)
