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
from steeljax_torch.scene.flatten import _to_linear_np, pack_tri_shade

# Floats per row of inst_trace and inst_shade.
INST_COLS = cuda_traverse.INST_COLS


@dataclasses.dataclass
class InstancedTables:
    """Tables of the two-level traversal; tensors on the render device."""
    snode_rows: torch.Tensor   # (S, 128) f32: TLAS rows, then BLAS rows
    tris_packed: torch.Tensor  # (R, 128) f32: concatenated BLAS records
    # (I, 48) f32: inverse world 3x4 (0:12), BLAS root supernode (12),
    # double-sided flag (13), material id (14), 1 / uniform scale (15),
    # normal matrix (16:25), world linear matrix (25:34).
    inst_trace: torch.Tensor
    # (I, 48) f32: normal matrix (0:9), world linear (9:18), material row
    # (18:46, tri_shade columns 28:56), uniform scale (46).
    inst_shade: torch.Tensor
    blas_shade: torch.Tensor   # (T, 28) f32 object-space geometric rows
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
            permuted["tri_pos"])[:, :28]
        self.padded = padded
        # AABB over real triangles (object space).
        real = self.tri_pos[:, 0, 0] < 1e37
        if real.any():
            pts = self.tri_pos[real].reshape(-1, 3)
            self.lo, self.hi = pts.min(axis=0), pts.max(axis=0)
        else:
            self.lo = np.zeros(3, np.float32)
            self.hi = np.zeros(3, np.float32)


def _build_tlas8(lo: np.ndarray, hi: np.ndarray) -> tuple[np.ndarray, int]:
    """8-wide median-split tree over instance AABBs.

    Child slots: meta1 == -1 -> instance (meta0 = instance id);
    meta1 == 0 -> internal (meta0 = supernode id); empty slots have
    inverted AABBs and meta0 = -1.  Returns (rows (S, 128), depth)."""
    count = len(lo)
    centers = (lo + hi) * 0.5
    rows: list[np.ndarray] = []

    def rec(ids: np.ndarray) -> tuple[int, int]:
        sid = len(rows)
        rows.append(np.zeros(128, np.float32))
        if len(ids) <= 8:
            groups = [np.array([i]) for i in ids]
        else:
            groups = [ids]
            for _ in range(3):
                nxt = []
                for g in groups:
                    if len(g) <= 1:
                        nxt.append(g)
                        continue
                    c = centers[g]
                    axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
                    order = g[np.argsort(c[:, axis], kind="stable")]
                    h = len(order) // 2
                    nxt.extend([order[:h], order[h:]])
                groups = nxt
            groups = [g for g in groups if len(g)]
        depth = 1
        row = rows[sid]
        for slot in range(8):
            off = 16 * slot
            if slot < len(groups):
                g = groups[slot]
                row[off:off + 3] = lo[g].min(axis=0)
                row[off + 3:off + 6] = hi[g].max(axis=0)
                if len(g) == 1:
                    row[off + 6] = float(g[0])
                    row[off + 7] = -1.0
                else:
                    child, d = rec(g)
                    row = rows[sid]
                    row[off + 6] = float(child)
                    row[off + 7] = 0.0
                    depth = max(depth, 1 + d)
            else:
                row[off:off + 3] = 3.0e37
                row[off + 3:off + 6] = -3.0e37
                row[off + 6] = -1.0
                row[off + 7] = 0.0
        return sid, depth

    if count == 0:
        row = np.zeros(128, np.float32)
        for slot in range(8):
            off = 16 * slot
            row[off:off + 3] = 3.0e37
            row[off + 3:off + 6] = -3.0e37
            row[off + 6] = -1.0
        return row[None], 1
    _, depth = rec(np.arange(count))
    return np.stack(rows), depth


def _pack_inst_material(mat) -> np.ndarray:
    """Material constants in tri_shade col 28:56 semantics (28 floats):
    [mat id, emission linear (3), base linear (3), base alpha, roughness,
    metallic, alpha cutoff, normal scale, flags, tex ids (5), base raw
    (3), emission raw (3), occlusion strength, pad (3)]."""
    out = np.zeros(28, np.float32)
    base = np.asarray(mat.base_color_factor, np.float32)
    emission = np.asarray(mat.emission_factor, np.float32)[:3]
    out[1:4] = _to_linear_np(emission)
    out[4:7] = _to_linear_np(base[:3])
    out[7] = base[3]
    out[8] = mat.roughness_factor
    out[9] = mat.metallic_factor
    out[10] = mat.alpha_cutoff
    out[11] = mat.normal_scale
    out[12] = float(int(mat.flags))
    out[13:18] = [mat.base_color_texture, mat.roughness_metallic_texture,
                  mat.normal_texture, mat.occlusion_texture,
                  mat.emission_texture]
    out[18:21] = base[:3]
    out[21:24] = emission
    out[24] = mat.occlusion_strength
    return out


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
                        tri_uv=blas.tri_uv, tri_uvd=blas.shade[:, 27]))
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

    def prepare(self, scene) -> InstancedTables:
        """Build or refresh the instance tables for the scene's current
        entity state.  Each step is an `instances.<step>` span
        (core.profiling), those that launch device work ending in a
        synchronize."""
        from steeljax_torch.scene.material import MaterialFlags

        entries = []   # (blas key, world, material, material id)
        with profiling.named_scope("instances.blas", sync=self.device):
            for ei in scene.renderable_entities():
                world = scene.world_transform(ei)
                for ro in scene.entities[ei].render_objects:
                    bkey, _ = self._get_blas(scene.primitives[ro.primitive])
                    entries.append((bkey, np.asarray(world, np.float32),
                                    scene.materials[ro.material],
                                    ro.material))

        # Fused shading follows the flat path's gate: alpha-tested
        # materials keep the row-gather path (the bounded re-trace reads
        # full rows).
        any_alpha_test = any(
            (m.flags & MaterialFlags.ALPHA_TEST)
            and m.base_color_texture >= 0 for m in scene.materials)
        shade_mode = 0
        if not any_alpha_test:
            shade_mode = 2 if scene.textures else 1

        with profiling.named_scope("instances.pack_blas_tables",
                                   sync=self.device):
            blas_rows, tris_packed, tri_records, blas_shade, fused_rows, \
                offsets = self._pack_blas_tables(shade_mode)
        n_blas_rows = len(blas_rows)

        count = len(entries)
        lo = np.zeros((count, 3), np.float32)
        hi = np.zeros((count, 3), np.float32)
        inst_trace = np.zeros((count, INST_COLS), np.float32)
        inst_shade = np.zeros((count, INST_COLS), np.float32)
        blas_keys = []
        max_blas_depth = 1
        with profiling.named_scope("instances.instance_rows"):
            for i, (bkey, world, mat, mid) in enumerate(entries):
                blas = self._blas[bkey]
                inv = np.linalg.inv(world)[:3, :4]
                inst_trace[i, 0:12] = inv.reshape(-1)
                inst_trace[i, 13] = float(
                    bool(mat.flags & MaterialFlags.DOUBLE_SIDED))
                lin = world[:3, :3]
                nmat = np.linalg.inv(lin).T
                scale = float(np.cbrt(abs(np.linalg.det(lin))))
                inst_trace[i, 14] = float(mid)
                inst_trace[i, 15] = 1.0 / max(scale, 1e-6)
                inst_trace[i, 16:25] = nmat.reshape(-1)
                inst_trace[i, 25:34] = lin.reshape(-1)
                inst_shade[i, 0:9] = nmat.reshape(-1)
                inst_shade[i, 9:18] = lin.reshape(-1)
                inst_shade[i, 18:46] = _pack_inst_material(mat)
                inst_shade[i, 46] = scale
                # World AABB = transformed object AABB corners.
                cs = np.stack(np.meshgrid(
                    [blas.lo[0], blas.hi[0]], [blas.lo[1], blas.hi[1]],
                    [blas.lo[2], blas.hi[2]], indexing="ij"),
                    axis=-1).reshape(-1, 3)
                wc = cs @ lin.T + world[:3, 3]
                lo[i], hi[i] = wc.min(axis=0), wc.max(axis=0)
                blas_keys.append(bkey)
                max_blas_depth = max(max_blas_depth, blas.depth8)

        with profiling.named_scope("instances.build_tlas"):
            tlas_rows, tlas_depth = _build_tlas8(lo, hi)
            n_tlas = len(tlas_rows)
            # Shift every BLAS child reference past the TLAS prefix, and
            # point each instance at its (shifted) BLAS root.
            snode = np.concatenate([tlas_rows, blas_rows.copy()]) \
                if n_blas_rows else tlas_rows
            blas_section = snode[n_tlas:]
            for c in range(8):
                internal = (blas_section[:, 16 * c + 7] == 0) \
                    & (blas_section[:, 16 * c + 6] >= 0)
                blas_section[internal, 16 * c + 6] += n_tlas
            for i, bkey in enumerate(blas_keys):
                inst_trace[i, 12] = float(offsets[bkey][0] + n_tlas)

        sorted_keys = sorted(self._blas)
        blas_index = {k: j for j, k in enumerate(sorted_keys)}
        aabb_lo = lo.min(axis=0) if count else np.zeros(3, np.float32)
        aabb_hi = hi.max(axis=0) if count else np.ones(3, np.float32)
        with profiling.named_scope("instances.upload", sync=self.device):
            def dev(a):
                return torch.from_numpy(a).to(self.device)

            return InstancedTables(
                snode_rows=dev(snode), tris_packed=tris_packed,
                inst_trace=dev(inst_trace), inst_shade=dev(inst_shade),
                blas_shade=blas_shade, tri_records=tri_records, n_tlas=n_tlas,
                shade_rows=fused_rows, shade_mode=shade_mode,
                depth=tlas_depth + 1 + max_blas_depth,
                max_leaf=self.leaf_size,
                aabb_lo=tuple(float(v) for v in aabb_lo),
                aabb_hi=tuple(float(v) for v in aabb_hi),
                cpu_blas=tuple(self._blas[k].cpu for k in sorted_keys),
                inst_blas=tuple(blas_index[k] for k in blas_keys),
                blas_tri_offset=tuple(offsets[k][1] for k in sorted_keys))


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
