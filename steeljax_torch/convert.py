"""Carry the JAX package's prepared scene state across to the port.

`from_jax_prepared(flat, tables, device)` takes a steeljax `FlatScene` and
`TraceTables` (the result of steeljax.render.pt.renderer.prepare_scene) and
returns the port's FlatScene and TraceTables on `device`.  It reads the
reference's objects only through `np.asarray` of their attributes, so this
module imports neither jax nor steeljax.  It is the port's analogue of
loading another framework's weights: tests use it to feed both packages
identical tables.

Alpha-masked tables come across with their AUX rows, coarse masks and
`alpha_masked` flag.  The reference builds fine mask rows only for its TPU
kernels; with `fine_masks` (and a `scene` to take the textures from) the
port builds them here from the permuted arrays, as its own prepare_scene
does.  Alpha-tested scenes get no fused shade rows.

Tables of several chunks come across chunk by chunk, each at its
row_offset with its own rows, AABB and derived record table, and
supernode rows of either width (8 or 16) with theirs.

Instanced tables (the reference's InstancedTables, as
`InstancedAccel(use_pallas=True).prepare(scene)` packs them on the host,
fused rows included, with every BLAS's binary tree and permuted triangles
for the walk) and TraceTables with treelet stacks come across too.
The reference's CPU tables (`use_pallas=False`) carry no fused rows: the
port then traces in shade mode 0 and shades from the composed rows.

`from_jax_environment(env, device)` carries a steeljax `Environment` (the
cube and every baked table) across the same way, so that two renderers can
light a frame from the same bakes, and `from_jax_light_volume(lv, device)`
a steeljax `LightVolume` (a GI bake).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from steeljax_torch.accel.alphamask import compute_fine_masks
from steeljax_torch.accel.bvh import BVH, BVH8
from steeljax_torch.accel.cuda_traverse import (hopper_records,
                                                pack_fine_mask_rows,
                                                pack_shade_records)
from steeljax_torch.accel.dispatch import ChunkTables, TraceTables
from steeljax_torch.accel.instances import (CpuBlas, InstancedTables,
                                            sort_bounds)
from steeljax_torch.accel.treelets import TreeletTables
from steeljax_torch.env.cubemap import pack_mips_tri
from steeljax_torch.env.environment import Environment
from steeljax_torch.gi.light_volume import LightVolume
from steeljax_torch.scene.flatten import FlatScene, TriShade

_STATIC_FIELDS = ("light_count", "env_enabled", "env_analytic",
                  "any_alpha_test", "any_alpha_blend", "has_textures",
                  "source_tri_count")


def _fine_rows(flat, chunk, scene) -> np.ndarray:
    """Fine mask rows of an alpha-masked chunk from the reference's
    permuted per-triangle arrays (pad slots, whose material is 0 like the
    reference's padding, get rows the kernel never reads: their triangles
    never hit)."""
    s = slice(chunk.row_offset, chunk.row_offset + chunk.rows)
    masks = compute_fine_masks(
        np.asarray(flat.tri_uv)[s], np.asarray(flat.tri_mat)[s],
        np.asarray(flat.mat_base_color), np.asarray(flat.mat_params),
        np.asarray(flat.mat_tex), np.asarray(flat.mat_flags),
        scene.textures, device="cpu")
    return pack_fine_mask_rows(masks)


def _instanced(tables, dev) -> InstancedTables:
    """The reference's InstancedTables on the port's device."""
    fused = tables.shade_rows is not None and int(tables.shade_mode) > 0
    tris_packed = dev(tables.tris_packed)
    return InstancedTables(
        snode_rows=dev(tables.snode_rows), tris_packed=tris_packed,
        inst_trace=dev(tables.inst_trace), inst_shade=dev(tables.inst_shade),
        blas_shade=dev(tables.blas_shade),
        tri_records=hopper_records(tris_packed), n_tlas=int(tables.n_tlas),
        shade_rows=dev(tables.shade_rows) if fused else None,
        shade_mode=int(tables.shade_mode) if fused else 0,
        depth=int(tables.depth), max_leaf=int(tables.max_leaf),
        aabb_lo=tuple(float(v) for v in np.asarray(tables.aabb_lo)),
        aabb_hi=tuple(float(v) for v in np.asarray(tables.aabb_hi)),
        sort_bounds=dev(sort_bounds(np.asarray(tables.aabb_lo),
                                    np.asarray(tables.aabb_hi))),
        cpu_blas=tuple(CpuBlas(bvh=_bvh(b.bvh), tri_pos=dev(b.tri_pos),
                               tri_double_sided=dev(b.tri_double_sided))
                       for b in tables.cpu_blas),
        inst_blas=tuple(int(b) for b in tables.inst_blas),
        blas_tri_offset=tuple(int(t) for t in tables.blas_tri_offset))


def _treelets(tt, dev) -> TreeletTables:
    """The reference's TreeletTables on the port's device."""
    shade = tt.shade_stack
    tri_stack = dev(tt.tri_stack)
    return TreeletTables(
        node_stack=dev(tt.node_stack), tri_stack=tri_stack,
        tri_records=hopper_records(tri_stack.reshape(-1, 128)),
        aabb_lo=dev(tt.aabb_lo), aabb_hi=dev(tt.aabb_hi),
        tri_offsets=dev(tt.tri_offsets),
        shade_stack=None if shade is None else dev(shade),
        depth=int(tt.depth), max_leaf=int(tt.max_leaf),
        shade_mode=int(tt.shade_mode), alpha_mask=bool(tt.alpha_mask),
        ranges=tuple((int(lo), int(hi)) for lo, hi in tt.ranges))


def from_jax_prepared(flat, tables, device: torch.device | str,
                      fine_masks: bool = False, scene=None
                      ) -> tuple[FlatScene, TraceTables | InstancedTables]:
    def dev(x):
        return torch.from_numpy(np.array(np.asarray(x))).to(device)

    tensor_fields = [f.name for f in dataclasses.fields(FlatScene)
                     if f.name not in _STATIC_FIELDS]
    port_flat = FlatScene(
        **{name: dev(getattr(flat, name)) for name in tensor_fields},
        **{name: getattr(flat, name) for name in _STATIC_FIELDS})
    if not hasattr(tables, "chunks"):
        return port_flat, _instanced(tables, dev)

    alpha = bool(getattr(tables, "alpha_masked", False))
    if fine_masks and alpha and scene is None:
        raise ValueError("fine masks need the scene's textures")
    if tables.treelets is not None:
        # The kept chunk carries metadata only.
        chunk = tables.chunks[0]
        meta = ChunkTables(
            bvh=_bvh(chunk.bvh), bvh8=None, tris_packed=None,
            tri_mask=(dev(np.asarray(chunk.tri_mask).astype(np.int32))
                      if alpha else None),
            row_offset=int(chunk.row_offset), rows=int(chunk.rows),
            aabb=_aabb(chunk))
        return port_flat, TraceTables(
            chunks=(meta,), treelets=_treelets(tables.treelets, dev),
            shade_mode=int(tables.shade_mode), alpha_masked=alpha)

    mode = int(tables.shade_mode)
    if flat.any_alpha_test:
        mode = 0
    elif tables.chunks[0].shade_packed is None:
        # The reference attaches no shade rows off the TPU; build the rows
        # of the port's mode from its permuted per-triangle arrays.
        mode = 2 if flat.has_textures else 1
    chunks = tuple(_chunk(flat, chunk, dev, mode, alpha and fine_masks,
                          scene) for chunk in tables.chunks)
    return port_flat, TraceTables(chunks=chunks, shade_mode=mode,
                                  alpha_masked=alpha)


def _bvh(bvh) -> BVH:
    return BVH(nodes=np.array(np.asarray(bvh.nodes)), depth=int(bvh.depth),
               max_leaf=int(bvh.max_leaf))


def _bvh8(bvh8, dev) -> BVH8:
    return BVH8(rows=dev(bvh8.rows), depth=int(bvh8.depth),
                max_leaf=int(bvh8.max_leaf),
                width=int(getattr(bvh8, "width", 8)))


def _aabb(chunk) -> tuple:
    return tuple(tuple(float(v) for v in corner) for corner in chunk.aabb)


def _chunk(flat, chunk, dev, mode: int, fine: bool, scene) -> ChunkTables:
    """One of the reference's flat chunks on the port's device, at its
    row_offset: its rows at their width, its shade rows of `mode` (built
    from the permuted arrays where the reference has none), its fine mask
    rows when `fine`, and the record tables derived from its rows."""
    shade = chunk.shade_packed
    if mode and shade is None:
        s = slice(chunk.row_offset, chunk.row_offset + chunk.rows)
        shade = pack_shade_records(
            np.asarray(flat.tri_nrm)[s], np.asarray(flat.tri_mat)[s],
            mode == 2, tri_tan=np.asarray(flat.tri_tan)[s],
            tri_uv=np.asarray(flat.tri_uv)[s],
            tri_uvd=np.asarray(flat.tri_shade)[s, TriShade.UV_DENSITY])
    dense = chunk.anyhit_tris is not None
    alpha = chunk.tri_mask is not None
    port = ChunkTables(
        bvh=_bvh(chunk.bvh), bvh8=_bvh8(chunk.bvh8, dev),
        tris_packed=dev(chunk.tris_packed),
        shade_packed=dev(shade) if mode else None,
        anyhit_bvh8=_bvh8(chunk.anyhit_bvh8, dev) if dense else None,
        anyhit_tris=dev(chunk.anyhit_tris) if dense else None,
        tri_mask=(dev(np.asarray(chunk.tri_mask).astype(np.int32))
                  if alpha else None),
        fine_mask_rows=(dev(_fine_rows(flat, chunk, scene))
                        if alpha and fine else None),
        row_offset=int(chunk.row_offset), rows=int(chunk.rows),
        aabb=_aabb(chunk))
    return port.replace(
        tri_records=hopper_records(port.tris_packed),
        anyhit_records=(hopper_records(port.anyhit_tris, dense=True)
                        if dense else None))


def from_jax_environment(env, device: torch.device | str) -> Environment:
    """The reference's Environment on `device`: every table as it was
    baked, read through np.asarray (None where the reference has none).
    The mip-pair reflection rows, which the reference packs only for small
    chains, are packed here from its reflection mips (env.environment)."""
    def dev(x):
        return (None if x is None
                else torch.from_numpy(np.array(np.asarray(x))).to(device))

    tables = {f.name: dev(getattr(env, f.name))
              for f in dataclasses.fields(Environment)
              if f.name not in ("reflection_mips", "analytic",
                                "reflection_tri_data")}
    mips = tuple(dev(m) for m in env.reflection_mips)
    return Environment(
        reflection_mips=mips,
        reflection_tri_data=pack_mips_tri(mips, device)[0],
        analytic=bool(env.analytic), **tables)


def from_jax_light_volume(lv, device: torch.device | str) -> LightVolume:
    """The port's LightVolume holding the arrays of a steeljax one."""
    return LightVolume(**{
        f.name: torch.from_numpy(np.array(np.asarray(getattr(lv, f.name))))
        for f in dataclasses.fields(LightVolume)}).to(device)
