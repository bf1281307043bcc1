"""Two-level acceleration structure: per-primitive BLAS + instance TLAS.

Port of steeljax/accel/instances.py.  The flat path re-flattens world-space
triangles and rebuilds one SAH tree on every scene revision, O(triangles)
per edit.  The two-level structure builds

* a BLAS per primitive: object-space BVH8 supernode rows and packed
  triangle records, built once (native SAH) and cached by primitive
  identity;
* a TLAS: an 8-wide median-split tree over the instances' world AABBs,
  rebuilt per scene revision on the host, O(instances log instances) numpy;
* one unified supernode table: TLAS rows first, then every cached BLAS's
  rows with child indices offset.  Instance rows carry the inverse world
  transform and the BLAS root, so re-preparing after a transform, material
  or instance edit uploads only the supernode rows and the two (I, 48)
  instance tables: the triangle, shading-row and fused-record tensors stay
  on the device and are the same objects.

All host packing is the reference's numpy code, so every table equals the
reference's arrays.  Traversal is kernel K6 (cuda_traverse.
trace_nearest_bvh8_inst, csrc/instanced8.cu) for CUDA tensors and its plain
version for CPU tensors; there is no `use_pallas` flag, and the fused shade
records are built on every device.  Triangle facing is decided by
object-space winding, and double-sidedness is an instance (material)
property applied at trace time.  Each BLAS also keeps its binary tree and
permuted triangles on the device (CpuBlas, the tables' `cpu_blas`), which
`trace_nearest_instanced_walk`, the reference's CPU two-level trace and
K6's oracle, walks instance by instance.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from steeljax_torch.accel import cuda_traverse, traverse
from steeljax_torch.accel.bvh import (BVH, apply_permutation, build_bvh,
                                      collapse_bvh8)
from steeljax_torch.core import profiling
from steeljax_torch.scene.flatten import (TRI_SHADE_COLS, TRI_SHADE_GEOMETRY,
                                          TRI_SHADE_MATERIAL, TriGeometry,
                                          TriShade, _to_linear_np, copy_in,
                                          pack_tri_shade, refresh_lights,
                                          refresh_materials)

# Floats per row of inst_trace and inst_shade.
INST_COLS = cuda_traverse.INST_COLS


class InstShade:
    """Columns of inst_shade's (I, INST_COLS) per-instance rows."""
    NORMAL_MATRIX = slice(0, 9)    # inverse transpose of WORLD_LINEAR
    WORLD_LINEAR = slice(9, 18)    # row-major 3x3
    MATERIAL = slice(18, 46)       # tri_shade's TRI_SHADE_MATERIAL columns
    SCALE = 46                     # uniform scale, cbrt |det WORLD_LINEAR|
    PAD = 47


@dataclasses.dataclass
class InstancedTables:
    """Tables of the two-level traversal; tensors on the render device."""
    snode_rows: torch.Tensor   # (S, 128) f32: TLAS rows, then BLAS rows
    tris_packed: torch.Tensor  # (R, 128) f32: concatenated BLAS records
    # (I, 48) f32: inverse world 3x4 (0:12), BLAS root supernode (12),
    # double-sided flag (13), material id (14), 1 / uniform scale (15),
    # normal matrix (16:25), world linear matrix (25:34).
    inst_trace: torch.Tensor
    inst_shade: torch.Tensor   # (I, 48) f32, InstShade's columns
    blas_shade: torch.Tensor   # (T, 28) f32, TriGeometry's columns
    # (R * 12, 12) f32: cuda_traverse.hopper_records of tris_packed, the
    # 48-byte records K6 reads.
    tri_records: torch.Tensor | None = None
    n_tlas: int = 1            # supernode rows below this are TLAS rows
    # Fused-shading records (pack_shade_records layout, object space,
    # concatenated per BLAS like tris_packed); None in mode 0.
    shade_rows: torch.Tensor | None = None
    shade_mode: int = 0
    depth: int = 1             # TLAS depth + 1 + deepest BLAS
    max_leaf: int = 24
    # World bounds of the instances, for the ray-sort keys.
    aabb_lo: tuple = (0.0, 0.0, 0.0)
    aabb_hi: tuple = (1.0, 1.0, 1.0)
    # (2, 3) f32 on the device: the bounds' lower corner and inverse extent
    # (sort_bounds), which the ray-sort keys read; a refresh rewrites it.
    sort_bounds: torch.Tensor | None = None
    # Every cached BLAS's binary tree and permuted triangles, in BLAS index
    # order, for the walk (trace_nearest_instanced_walk).
    cpu_blas: tuple = ()       # tuple[CpuBlas]
    # BLAS index of every instance, and the first pool record of every
    # BLAS: the plain trace walks them, _total_triangles counts them.
    inst_blas: tuple = ()
    blas_tri_offset: tuple = ()

    @property
    def instance_count(self) -> int:
        return self.inst_trace.shape[0]


@dataclasses.dataclass
class CpuBlas:
    """One BLAS as the walk reads it (steeljax/accel/instances.py:84-87)."""
    bvh: BVH
    tri_pos: torch.Tensor           # (Tp, 3, 3) permuted object space
    tri_double_sided: torch.Tensor  # (Tp,) bool, all False


class _Blas:
    """Host-side cached BLAS of one primitive; `cpu` is its CpuBlas on the
    accel's device."""

    def __init__(self, primitive, leaf_size: int, device: torch.device):
        tri = np.asarray(primitive.indices).reshape(-1, 3)
        pos = np.asarray(primitive.positions, np.float32)
        tri_pos = pos[tri]
        bvh, order, padded = build_bvh(tri_pos, leaf_size)
        permuted = apply_permutation((None, order, padded), {
            "tri_pos": tri_pos,
            "tri_nrm": np.asarray(primitive.normals, np.float32)[tri],
            "tri_tan": np.asarray(primitive.tangents, np.float32)[tri],
            "tri_uv": np.asarray(primitive.tex_coords, np.float32)[tri],
        })
        self.bvh = bvh
        self.tri_pos = permuted["tri_pos"]
        self.cpu = CpuBlas(
            bvh=bvh, tri_pos=torch.from_numpy(self.tri_pos).to(device),
            tri_double_sided=torch.zeros(padded, dtype=torch.bool,
                                         device=device))
        # The records carry no double-sided flag: the instance's does.
        self.rows8, self.depth8 = collapse_bvh8(np.asarray(bvh.nodes),
                                                leaf_size)
        self.tris_packed = cuda_traverse.pack_tris(
            self.tri_pos, np.zeros(padded, bool))
        self.tri_nrm = permuted["tri_nrm"]
        self.tri_tan = permuted["tri_tan"]
        self.tri_uv = permuted["tri_uv"]
        self.shade = pack_tri_shade(
            permuted["tri_nrm"], permuted["tri_tan"], permuted["tri_uv"],
            permuted["tri_pos"])[:, TRI_SHADE_GEOMETRY]
        self.padded = padded
        # AABB over real triangles (object space).
        real = self.tri_pos[:, 0, 0] < 1e37
        if real.any():
            pts = self.tri_pos[real].reshape(-1, 3)
            self.lo, self.hi = pts.min(axis=0), pts.max(axis=0)
        else:
            self.lo = np.zeros(3, np.float32)
            self.hi = np.zeros(3, np.float32)


def _runs(starts: np.ndarray, lengths: np.ndarray) -> tuple:
    """(positions, run): every position of the runs [start, start + length)
    in run order, and the run of each."""
    run = np.repeat(np.arange(len(starts)), lengths)
    first = np.cumsum(lengths) - lengths
    return starts[run] + np.arange(len(run)) - first[run], run


def _build_tlas8(lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, int]:
    """8-wide median-split tree over instance AABBs, the reference's
    recursion (steeljax/accel/instances.py:130-193) level by level in numpy:
    a node over more than 8 instances splits its instances three times at
    the median of their centres along the widest axis of the centres
    (stable order), one over 2 to 8 gives each its own slot; a group of one
    is an instance slot, a larger one a child node.  Rows are numbered in
    depth-first order, children in slot order, as the recursion appends
    them, so the rows equal the reference's.

    Child slots: meta1 == -1 -> instance (meta0 = instance id);
    meta1 == 0 -> internal (meta0 = supernode id); empty slots have
    inverted AABBs and meta0 = -1.  Returns (rows (S, 128), depth)."""
    count = len(lo)
    if count == 0:
        row = np.zeros(128, np.float32)
        for slot in range(8):
            off = 16 * slot
            row[off:off + 3] = 3.0e37
            row[off + 3:off + 6] = -3.0e37
            row[off + 6] = -1.0
        return row[None], 1
    centers = (lo + hi) * 0.5
    # Every node holds a run of `perm`, and its groups are runs inside it.
    perm = np.arange(count)
    nodes = []   # per node: its groups (start, length) in slot order
    child = {}   # a group of more than one instance -> its node
    level = [(0, count)]
    while level:
        base = len(nodes)
        child.update({run: base + i for i, run in enumerate(level)})
        nodes.extend([] for _ in level)
        starts, lengths = (np.asarray(x, np.int64) for x in zip(*level))
        big = np.flatnonzero(lengths > 8)
        seg_start, seg_len, seg_node = starts[big], lengths[big], big
        for _ in range(3 if len(big) else 0):
            pos, seg = _runs(seg_start, seg_len)
            c = centers[perm[pos]]
            first = np.cumsum(seg_len) - seg_len
            extent = (np.maximum.reduceat(c, first)
                      - np.minimum.reduceat(c, first))
            key = c[np.arange(len(pos)), np.argmax(extent, axis=1)[seg]]
            perm[pos] = perm[pos[np.lexsort((key, seg))]]
            half = seg_len // 2
            seg_start = np.stack([seg_start, seg_start + half], 1).ravel()
            seg_len = np.stack([half, seg_len - half], 1).ravel()
            keep = seg_len > 0
            seg_start, seg_len = seg_start[keep], seg_len[keep]
            seg_node = np.repeat(seg_node, 2)[keep]
        small = np.flatnonzero(lengths <= 8)
        single, single_node = _runs(starts[small], lengths[small])
        level = []
        for node, start, length in sorted(zip(
                np.concatenate([seg_node, small[single_node]]).tolist(),
                np.concatenate([seg_start, single]).tolist(),
                np.concatenate([seg_len, np.ones_like(single)]).tolist())):
            nodes[base + node].append((start, length))
            if length > 1:
                level.append((start, length))
    # Depth-first numbering, children in slot order.
    number = [0] * len(nodes)
    stack, numbered = [0], 0
    while stack:
        node = stack.pop()
        number[node] = numbered
        numbered += 1
        stack.extend(child[g] for g in reversed(nodes[node]) if g[1] > 1)
    depth = [1] * len(nodes)
    for node in reversed(range(len(nodes))):
        for g in nodes[node]:
            if g[1] > 1:
                depth[node] = max(depth[node], 1 + depth[child[g]])
    rows = np.zeros((len(nodes), 128), np.float32)
    slots = rows.reshape(len(nodes), 8, 16)
    slots[:, :, 0:3] = 3.0e37
    slots[:, :, 3:6] = -3.0e37
    slots[:, :, 6] = -1.0
    row_of, slot_of, start, length = (np.asarray(x, np.int64) for x in zip(
        *[(number[node], slot, a, n) for node in range(len(nodes))
          for slot, (a, n) in enumerate(nodes[node])]))
    pos, _ = _runs(start, length)
    first = np.cumsum(length) - length
    slots[row_of, slot_of, 0:3] = np.minimum.reduceat(lo[perm[pos]], first)
    slots[row_of, slot_of, 3:6] = np.maximum.reduceat(hi[perm[pos]], first)
    leaf = length == 1
    inner = ~leaf
    slots[row_of[leaf], slot_of[leaf], 6] = perm[start[leaf]]
    slots[row_of[leaf], slot_of[leaf], 7] = -1.0
    slots[row_of[inner], slot_of[inner], 6] = [
        number[child[(a, n)]]
        for a, n in zip(start[inner].tolist(), length[inner].tolist())]
    slots[row_of[inner], slot_of[inner], 7] = 0.0
    return rows, depth[0]


def _pack_inst_material(mat) -> np.ndarray:
    """The material's constants as tri_shade's material columns
    (TRI_SHADE_MATERIAL, 28 floats), its material id left 0."""
    row = np.zeros(TRI_SHADE_COLS, np.float32)
    c = TriShade
    base = np.asarray(mat.base_color_factor, np.float32)
    emission = np.asarray(mat.emission_factor, np.float32)[:3]
    row[c.EMISSION_LINEAR] = _to_linear_np(emission)
    row[c.BASE_LINEAR] = _to_linear_np(base[:3])
    row[c.ALPHA] = base[3]
    row[c.ROUGHNESS] = mat.roughness_factor
    row[c.METALLIC] = mat.metallic_factor
    row[c.ALPHA_CUTOFF] = mat.alpha_cutoff
    row[c.NORMAL_SCALE] = mat.normal_scale
    row[c.FLAGS] = float(int(mat.flags))
    row[c.TEX_IDS] = [mat.base_color_texture, mat.roughness_metallic_texture,
                      mat.normal_texture, mat.occlusion_texture,
                      mat.emission_texture]
    row[c.BASE_COLOR] = base[:3]
    row[c.EMISSION] = emission
    row[c.OCCLUSION] = mat.occlusion_strength
    return row[TRI_SHADE_MATERIAL]


class InstancedAccel:
    """Host-side manager of the two-level structure on `device`.

    BLAS are cached by primitive identity; the concatenated triangle,
    shading-row and fused-record tensors are rebuilt and uploaded only when
    the cached BLAS set (or the shade mode) changes.  `prepare(scene)` is
    O(instances) for transform, material and instance edits over known
    primitives; `blas_builds` counts the BLAS built so far."""

    def __init__(self, leaf_size: int = 24, *, device: torch.device | str):
        self.leaf_size = leaf_size
        self.device = torch.device(device)
        self._blas: dict[int, _Blas] = {}      # id(primitive) -> BLAS
        self._packed = None
        self._packed_key = None
        self.blas_builds = 0

    def _get_blas(self, primitive) -> tuple[int, _Blas]:
        key = id(primitive)
        blas = self._blas.get(key)
        if blas is None:
            blas = _Blas(primitive, self.leaf_size, self.device)
            self._blas[key] = blas
            self.blas_builds += 1
        return key, blas

    def _pack_blas_tables(self, shade_mode: int):
        """(BLAS supernode rows (host), triangle rows, their Hopper records,
        shading rows, fused records or None (device tensors), {blas key:
        (first row, first record)}) of the cached BLAS set.  The device
        tensors are reused across prepare calls until the set or the shade
        mode changes."""
        key = (tuple(sorted(self._blas)), shade_mode)
        if self._packed_key != key:
            offsets = {}
            rows_parts, tri_parts, shade_parts, fused_parts = [], [], [], []
            srow, tri0 = 0, 0
            for bkey in key[0]:
                blas = self._blas[bkey]
                offsets[bkey] = (srow, tri0)
                rows = blas.rows8.copy()
                for c in range(8):
                    internal = (rows[:, 16 * c + 7] == 0) \
                        & (rows[:, 16 * c + 6] >= 0)
                    rows[internal, 16 * c + 6] += srow
                    leaf = rows[:, 16 * c + 7] > 0
                    rows[leaf, 16 * c + 6] += tri0
                rows_parts.append(rows)
                tri_parts.append(blas.tris_packed)
                shade_parts.append(blas.shade)
                if shade_mode:
                    # Object-space fused records: the kernel takes the
                    # material id from the instance row and scales the uv
                    # density by 1 / instance scale.
                    fused_parts.append(cuda_traverse.pack_shade_records(
                        blas.tri_nrm, np.zeros(blas.padded, np.float32),
                        shade_mode == 2, tri_tan=blas.tri_tan,
                        tri_uv=blas.tri_uv,
                        tri_uvd=blas.shade[:, TriGeometry.UV_DENSITY]))
                srow += len(rows)
                tri0 += blas.padded

            def dev(parts, width):
                host = (np.concatenate(parts) if parts
                        else np.zeros((0, width), np.float32))
                return torch.from_numpy(host).to(self.device)

            tris_packed = dev(tri_parts, 128)
            self._packed = (
                np.concatenate(rows_parts) if rows_parts
                else np.zeros((0, 128), np.float32),
                tris_packed, cuda_traverse.hopper_records(tris_packed),
                dev(shade_parts, 28),
                dev(fused_parts, 128) if fused_parts else None,
                offsets)
            self._packed_key = key
        return self._packed

    def _instances(self, scene) -> tuple[list, np.ndarray, np.ndarray]:
        """(BLAS key, world transform (I, 4, 4) float32, material id (I,))
        of every render object of the scene's renderable entities, in
        entity order; a BLAS is built for each primitive not cached yet."""
        keys, worlds, mids = [], [], []
        for ei in scene.renderable_entities():
            world = scene.world_transform(ei)
            for ro in scene.entities[ei].render_objects:
                keys.append(self._get_blas(scene.primitives[ro.primitive])[0])
                worlds.append(world)
                mids.append(ro.material)
        return (keys, np.asarray(worlds, np.float32).reshape(-1, 4, 4),
                np.asarray(mids, np.int64))

    def _host_tables(self, scene, keys, world, mids, blas_rows, offsets
                     ) -> dict:
        """The instance tables, the TLAS and the sort bounds of the scene's
        instances as host arrays, and the host fields of InstancedTables:
        the instance rows in one numpy pass (`_instance_rows`), then the
        TLAS over their world bounds."""
        from steeljax_torch.scene.material import MaterialFlags

        sorted_keys = sorted(self._blas)
        blas_index = {k: j for j, k in enumerate(sorted_keys)}
        inst_blas = np.asarray([blas_index[k] for k in keys], np.int64)
        pool = [self._blas[k] for k in sorted_keys]
        with profiling.named_scope("instances.instance_rows"):
            materials = scene.materials
            material_rows = np.zeros((max(len(materials), 1), 28),
                                     np.float32)
            double_sided = np.zeros(max(len(materials), 1), bool)
            for m, mat in enumerate(materials):
                material_rows[m] = _pack_inst_material(mat)
                double_sided[m] = bool(mat.flags & MaterialFlags.DOUBLE_SIDED)
            blas_lo = np.zeros((max(len(pool), 1), 3), np.float32)
            blas_hi = np.zeros((max(len(pool), 1), 3), np.float32)
            for j, blas in enumerate(pool):
                blas_lo[j], blas_hi[j] = blas.lo, blas.hi
            inst_trace, inst_shade, lo, hi = _instance_rows(
                world, blas_lo[inst_blas], blas_hi[inst_blas],
                double_sided[mids], mids, material_rows[mids])
        with profiling.named_scope("instances.build_tlas"):
            tlas_rows, tlas_depth = _build_tlas8(lo, hi)
            n_tlas = len(tlas_rows)
            # Every instance points at its BLAS root, shifted past the TLAS
            # prefix.
            roots = np.asarray([offsets[k][0] for k in sorted_keys] or [0],
                               np.float32)
            inst_trace[:, 12] = roots[inst_blas] + n_tlas
        count = len(keys)
        aabb_lo = lo.min(axis=0) if count else np.zeros(3, np.float32)
        aabb_hi = hi.max(axis=0) if count else np.ones(3, np.float32)
        max_blas_depth = max([pool[j].depth8 for j in set(inst_blas.tolist())]
                             + [1])
        return {"tlas_rows": tlas_rows, "inst_trace": inst_trace,
                "inst_shade": inst_shade,
                "sort_bounds": sort_bounds(aabb_lo, aabb_hi),
                "n_tlas": n_tlas, "depth": tlas_depth + 1 + max_blas_depth,
                "aabb_lo": tuple(float(v) for v in aabb_lo),
                "aabb_hi": tuple(float(v) for v in aabb_hi),
                "inst_blas": tuple(int(j) for j in inst_blas)}

    def _shade_mode(self, scene) -> int:
        """Fused shading follows the flat path's gate: alpha-tested
        materials keep the row-gather path (the bounded re-trace reads full
        rows)."""
        from steeljax_torch.scene.material import MaterialFlags

        if any((m.flags & MaterialFlags.ALPHA_TEST)
               and m.base_color_texture >= 0 for m in scene.materials):
            return 0
        return 2 if scene.textures else 1

    def prepare(self, scene) -> InstancedTables:
        """Build the instance tables for the scene's current entity state,
        as new tables.  Each step is an `instances.<step>` span
        (core.profiling), those that launch device work ending in a
        synchronize."""
        with profiling.named_scope("instances.blas", sync=self.device):
            keys, world, mids = self._instances(scene)
        shade_mode = self._shade_mode(scene)
        with profiling.named_scope("instances.pack_blas_tables",
                                   sync=self.device):
            blas_rows, tris_packed, tri_records, blas_shade, fused_rows, \
                offsets = self._pack_blas_tables(shade_mode)
        host = self._host_tables(scene, keys, world, mids, blas_rows,
                                 offsets)
        n_tlas = host["n_tlas"]
        # Shift every BLAS child reference past the TLAS prefix.
        snode = np.concatenate([host["tlas_rows"], blas_rows])
        blas_section = snode[n_tlas:]
        for c in range(8):
            internal = (blas_section[:, 16 * c + 7] == 0) \
                & (blas_section[:, 16 * c + 6] >= 0)
            blas_section[internal, 16 * c + 6] += n_tlas
        sorted_keys = sorted(self._blas)
        with profiling.named_scope("instances.upload", sync=self.device):
            def dev(a):
                profiling.count("instances.upload_bytes", a.nbytes)
                return torch.from_numpy(a).to(self.device)

            return InstancedTables(
                snode_rows=dev(snode), tris_packed=tris_packed,
                inst_trace=dev(host["inst_trace"]),
                inst_shade=dev(host["inst_shade"]),
                blas_shade=blas_shade, tri_records=tri_records,
                n_tlas=n_tlas, shade_rows=fused_rows, shade_mode=shade_mode,
                depth=host["depth"], max_leaf=self.leaf_size,
                aabb_lo=host["aabb_lo"], aabb_hi=host["aabb_hi"],
                sort_bounds=dev(host["sort_bounds"]),
                cpu_blas=tuple(self._blas[k].cpu for k in sorted_keys),
                inst_blas=host["inst_blas"],
                blas_tri_offset=tuple(offsets[k][1] for k in sorted_keys))

    def refresh(self, scene, flat, tables: InstancedTables,
                materials: bool = False) -> tuple:
        """The tables and the flat scene after a scene edit, the reference's
        per-frame TLAS rebuild into its persistent instance buffer
        (AccelerationStructureManager.cpp:128-220): `(flat, tables)` for
        `prepare_scene`'s pair, the light rows refreshed and, with
        `materials`, the material tables (flatten.refresh_lights,
        refresh_materials).

        While the instances, the BLAS pool, the shade mode and with them
        the TLAS's shape stay as they were, the new TLAS rows, the two
        instance tables, the sort bounds and the light and material rows
        are copied into the tensors the tables and the scene already hold,
        stream-ordered from pinned staging (no synchronize), and the same
        objects come back: a frame captured over them (frame_graphs) stays
        valid and replays.  A spawn, an erase, a new primitive or another
        shade mode prepares new tables instead (`prepare`), as the
        reference recreates its TLAS when the instance count changes.  One
        row of core.profiling's record, `instances.refresh`, with the
        counters `instances.in_place` or `instances.rebuilt` and
        `instances.upload_bytes`."""
        with profiling.frame("instances.refresh"):
            builds = self.blas_builds
            keys, world, mids = self._instances(scene)
            shade_mode = self._shade_mode(scene)
            host = None
            if (self.blas_builds == builds and shade_mode == tables.shade_mode
                    and len(keys) == tables.instance_count):
                blas_rows, tris_packed, _, _, _, offsets = \
                    self._pack_blas_tables(shade_mode)
                if tris_packed is tables.tris_packed:
                    host = self._host_tables(scene, keys, world, mids,
                                             blas_rows, offsets)
            kept = (host is not None and host["n_tlas"] == tables.n_tlas
                    and host["depth"] == tables.depth)
            if kept:
                copy_in(tables.snode_rows[:tables.n_tlas], host["tlas_rows"])
                for name in ("inst_trace", "inst_shade", "sort_bounds"):
                    copy_in(getattr(tables, name), host[name])
                for name in ("aabb_lo", "aabb_hi", "inst_blas"):
                    setattr(tables, name, host[name])
            else:
                tables = self.prepare(scene)
            new_flat = refresh_lights(flat, scene)
            if materials:
                new_flat = refresh_materials(new_flat, scene)
            kept = kept and new_flat is flat
            profiling.count("instances.in_place" if kept
                            else "instances.rebuilt")
        return new_flat, tables


def sort_bounds(lo, hi) -> np.ndarray:
    """(2, 3) float32: the lower corner and the inverse extent of the world
    bounds (lo, hi), the ray-sort keys' constants
    (integrator.scene_bounds)."""
    lo = np.asarray(lo, np.float32)
    inv = 1.0 / np.maximum(np.asarray(hi, np.float32) - lo, 1e-6)
    return np.stack([lo, inv.astype(np.float32)])


def _instance_rows(world, blas_lo, blas_hi, double_sided, material_ids,
                   material_rows) -> tuple:
    """The instance rows of I instances in one numpy pass, equal to the
    reference's per-instance loop (steeljax/accel/instances.py:329-356):
    world (I, 4, 4) float32 transforms, blas_lo and blas_hi (I, 3) each
    instance's BLAS bounds in object space, double_sided (I,) its
    material's flag, material_ids (I,) and material_rows (I, 28)
    (_pack_inst_material).  Returns (inst_trace, inst_shade, lo, hi), lo and
    hi the instances' world AABBs: the corners of the BLAS bounds
    transformed."""
    count = len(world)
    inst_trace = np.zeros((count, INST_COLS), np.float32)
    inst_shade = np.zeros((count, INST_COLS), np.float32)
    lin = world[:, :3, :3]
    nmat = np.linalg.inv(lin).transpose(0, 2, 1).reshape(count, 9)
    scale = np.cbrt(np.abs(np.linalg.det(lin))).astype(np.float64)
    inst_trace[:, 0:12] = np.linalg.inv(world)[:, :3, :4].reshape(count, 12)
    inst_trace[:, 13] = double_sided
    inst_trace[:, 14] = material_ids
    inst_trace[:, 15] = 1.0 / np.maximum(scale, 1e-6)
    inst_trace[:, 16:25] = nmat
    inst_trace[:, 25:34] = lin.reshape(count, 9)
    inst_shade[:, InstShade.NORMAL_MATRIX] = nmat
    inst_shade[:, InstShade.WORLD_LINEAR] = lin.reshape(count, 9)
    inst_shade[:, InstShade.MATERIAL] = material_rows
    inst_shade[:, InstShade.SCALE] = scale
    # Corner c takes hi on axis k where bit 2 - k of c is set (the
    # reference's meshgrid order).
    bits = (np.arange(8)[:, None] >> np.arange(2, -1, -1)) & 1
    corners = np.where(bits[None] == 1, blas_hi[:, None], blas_lo[:, None])
    wc = corners @ lin.transpose(0, 2, 1) + world[:, None, :3, 3]
    return inst_trace, inst_shade, wc.min(axis=1), wc.max(axis=1)


def world_shade_rows(tables: InstancedTables, tri: torch.Tensor,
                     inst: torch.Tensor) -> torch.Tensor:
    """The world-space tri_shade rows (TriShade) of hits on the pool's
    triangles `tri` of instances `inst`, int64 (N,) each
    (integrator.py:82-129): the object-space geometric BLAS row composed
    with the instance's material row, normals rotated by the instance's
    normal matrix and tangents by its world linear matrix (plain indexing
    of inst_shade; the reference's select chain over few instances gives
    the same rows)."""
    geo = tables.blas_shade[tri]
    irow = tables.inst_shade[inst]
    nm = irow[:, InstShade.NORMAL_MATRIX]
    wl = irow[:, InstShade.WORLD_LINEAR]

    def rotate(vecs, m):
        return torch.cat([cuda_traverse.rotate(m, vecs[:, i:i + 3])
                          for i in range(0, vecs.shape[1], 3)], dim=-1)

    # The uv density is per world length: divide by the instance scale.
    uvd = geo[:, TriGeometry.UV_DENSITY, None] / torch.clamp(
        irow[:, InstShade.SCALE, None], min=1e-6)
    # TriShade's column order.
    return torch.cat([rotate(geo[:, TriGeometry.NORMALS], nm),
                      rotate(geo[:, TriGeometry.TANGENTS], wl),
                      geo[:, TriGeometry.UVS],
                      rotate(geo[:, TriGeometry.GEOM_NORMAL], nm), uvd,
                      irow[:, InstShade.MATERIAL]], dim=-1)


def trace_nearest_instanced(tables: InstancedTables, o, d, t_min, t_max,
                            cull_backface: bool = True,
                            any_hit: bool = False) -> dict:
    """Two-level nearest hit: the flat trace record plus "inst" (N,) int32
    instance ids (-1 on a miss), and the fused shading outputs of the
    tables' shade mode; tri indexes the pooled BLAS records.  With any_hit
    the record holds only "hit", the occlusion flags (no culling)."""
    return cuda_traverse.trace_nearest_bvh8_inst(
        tables, o, d, t_min, t_max, cull_backface=cull_backface,
        any_hit=any_hit)


def _transform_rays(inv_row: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """The rays in an instance's object space (steeljax/accel/instances.py:
    402-406): o A^T + a and d A^T for the inverse world 3x4 [A | a] in
    inv_row[:12], each component's products summed left to right.  The
    reference's eager matrix product rounds its own way, so the object-space
    rays, and with them t, may differ from it in the last bit."""
    a = inv_row[:12].reshape(3, 4)

    def apply(x):
        return torch.stack([(x[:, 0] * a[j, 0] + x[:, 1] * a[j, 1])
                            + x[:, 2] * a[j, 2] for j in range(3)], dim=-1)

    return apply(o) + a[:, 3], apply(d)


def trace_nearest_instanced_walk(tables: InstancedTables, o, d, t_min,
                                 t_max, cull_backface: bool = True,
                                 stats: dict | None = None) -> dict:
    """The two-level nearest hit of the reference's CPU path
    (steeljax/accel/instances.py:425-451), the oracle of K6: instance by
    instance, the rays transformed into its object space, the BLAS walked
    (traverse.trace_nearest) with the instance's double-sided flag ORed in,
    the interval shrunk to the best hit so far; a later instance wins only
    at a strictly smaller t.  Returns the walk's record with tri indexing
    the BLAS pool and "inst" (N,) int32 (-1 on a miss); its hit flags
    answer the occlusion query too, as the reference's CPU path (which
    takes any_hit and walks for the nearest hit all the same) answers it.
    `stats` is traverse.trace_nearest's."""
    n = o.shape[0]
    tmn = torch.as_tensor(t_min, dtype=torch.float32,
                          device=o.device).expand(n)
    cur = torch.as_tensor(t_max, dtype=torch.float32,
                          device=o.device).expand(n)
    best = None
    for i in range(tables.instance_count):
        blas = tables.cpu_blas[tables.inst_blas[i]]
        row = tables.inst_trace[i]
        o2, d2 = _transform_rays(row, o, d)
        rec = traverse.trace_nearest(
            blas.bvh, blas.tri_pos, blas.tri_double_sided | (row[13] > 0.5),
            o2, d2, tmn, cur, cull_backface=cull_backface, stats=stats)
        rec["inst"] = torch.where(rec["hit"], i, -1).to(torch.int32)
        rec["tri"] = torch.where(
            rec["hit"],
            rec["tri"] + tables.blas_tri_offset[tables.inst_blas[i]], -1)
        if best is None:
            best = rec
        else:
            better = rec["hit"] & (~best["hit"] | (rec["t"] < best["t"]))
            best = {k: torch.where(better, rec[k], v)
                    for k, v in best.items()}
        cur = torch.where(best["hit"], best["t"], cur)
    if best is None:
        best = {"t": torch.full((n,), -1.0, device=o.device),
                "tri": torch.full((n,), -1, dtype=torch.int32,
                                  device=o.device),
                "u": torch.zeros((n,), device=o.device),
                "v": torch.zeros((n,), device=o.device),
                "hit": torch.zeros((n,), dtype=torch.bool, device=o.device),
                "inst": torch.full((n,), -1, dtype=torch.int32,
                                   device=o.device)}
    return best
