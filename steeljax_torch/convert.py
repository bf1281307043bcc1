"""Carry the JAX package's prepared scene state across to the port.

`from_jax_prepared(flat, tables, device)` takes a steeljax `FlatScene` and
`TraceTables` (the result of steeljax.render.pt.renderer.prepare_scene) and
returns the port's FlatScene and TraceTables on `device`.  It reads the
reference's objects only through `np.asarray` of their attributes, so this
module imports neither jax nor steeljax.  It is the port's analogue of
loading another framework's weights: tests use it to feed both packages
identical tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from steeljax_torch.accel.bvh import BVH, BVH8
from steeljax_torch.accel.cuda_traverse import pack_shade_records
from steeljax_torch.accel.dispatch import ChunkTables, TraceTables
from steeljax_torch.scene.flatten import FlatScene

_STATIC_FIELDS = ("light_count", "env_enabled", "env_analytic",
                  "any_alpha_test", "any_alpha_blend", "has_textures",
                  "source_tri_count")


def from_jax_prepared(flat, tables, device: torch.device | str
                      ) -> tuple[FlatScene, TraceTables]:
    if not hasattr(tables, "chunks"):
        raise NotImplementedError(
            "instanced tables are not ported yet (ROADMAP item 17)")
    if getattr(tables, "treelets", None) is not None:
        raise NotImplementedError(
            "streamed-treelet tables are not ported yet (ROADMAP item 19)")
    if getattr(tables, "alpha_masked", False):
        raise NotImplementedError(
            "alpha-masked tables are not ported yet (ROADMAP item 16)")
    if len(tables.chunks) != 1:
        raise NotImplementedError(
            "multi-chunk tables are not ported yet (ROADMAP item 13)")
    if getattr(tables.chunks[0].bvh8, "width", 8) != 8:
        raise NotImplementedError("only 8-wide supernode rows are ported")

    def dev(x):
        return torch.from_numpy(np.array(np.asarray(x))).to(device)

    tensor_fields = [f.name for f in dataclasses.fields(FlatScene)
                     if f.name not in _STATIC_FIELDS]
    port_flat = FlatScene(
        **{name: dev(getattr(flat, name)) for name in tensor_fields},
        **{name: getattr(flat, name) for name in _STATIC_FIELDS})

    chunk = tables.chunks[0]
    shade = chunk.shade_packed
    mode = int(tables.shade_mode)
    if shade is None:
        # The reference attaches no shade rows off the TPU; build the rows
        # of the port's mode from its permuted per-triangle arrays.
        s = slice(chunk.row_offset, chunk.row_offset + chunk.rows)
        mode = 2 if flat.has_textures else 1
        shade = pack_shade_records(
            np.asarray(flat.tri_nrm)[s], np.asarray(flat.tri_mat)[s],
            mode == 2, tri_tan=np.asarray(flat.tri_tan)[s],
            tri_uv=np.asarray(flat.tri_uv)[s],
            tri_uvd=np.asarray(flat.tri_shade)[s, 27])
    dense = chunk.anyhit_tris is not None
    port_chunk = ChunkTables(
        bvh=BVH(nodes=np.array(np.asarray(chunk.bvh.nodes)),
                depth=int(chunk.bvh.depth), max_leaf=int(chunk.bvh.max_leaf)),
        bvh8=BVH8(rows=dev(chunk.bvh8.rows), depth=int(chunk.bvh8.depth),
                  max_leaf=int(chunk.bvh8.max_leaf)),
        tris_packed=dev(chunk.tris_packed),
        shade_packed=dev(shade),
        anyhit_bvh8=(BVH8(rows=dev(chunk.anyhit_bvh8.rows),
                          depth=int(chunk.anyhit_bvh8.depth),
                          max_leaf=int(chunk.anyhit_bvh8.max_leaf))
                     if dense else None),
        anyhit_tris=dev(chunk.anyhit_tris) if dense else None,
        row_offset=int(chunk.row_offset), rows=int(chunk.rows),
        aabb=tuple(tuple(float(v) for v in corner) for corner in chunk.aabb))
    return port_flat, TraceTables(chunks=(port_chunk,), shade_mode=mode)
