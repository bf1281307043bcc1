"""BVH8 traversal: table packers, the CUDA kernels' wrappers and their plain
PyTorch versions.

Port of steeljax/accel/pallas_traverse.py:48-191 (packers) and :249-794
(`_traverse_kernel8`): the nearest-hit query with shade modes 0 and 1 (K1)
and 2 (K3), and the any-hit occlusion query over the 12-record rows or the
dense 14-record rows (K2).  The kernels are `csrc/traverse8.cu`, built by
native.cuda_library() and called through plain C functions.

`trace_nearest_bvh8` and `trace_any_bvh8` launch their kernel for CUDA
tensors and run the plain version only because their tensors lie on the
CPU; mixed devices raise, and a build or launch failure raises — nothing
falls back.  Every launch adds one to the kernel's entry in the module-level
`LAUNCHES`, so a run can show that its path went through the kernel.

Packet size, shared-origin and coherence knobs of the reference change the
TPU's scheduling, not the result, and have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from steeljax_torch.accel.bvh import (BVH8, DENSE_PER_ROW, DENSE_STRIDE,
                                      TRI_PER_ROW, TRI_STRIDE)

LANES = 128
# Fused-shading record layouts (pack_shade_records): mode 1 has
# SHADE1_STRIDE floats per record, TRI_PER_ROW records per row (the triangle
# table's row index); mode 2 has SHADE2_STRIDE floats, SHADE2_PER_ROW per
# row, so three shade rows per triangle row.
SHADE1_STRIDE = 10
SHADE2_STRIDE = 26
SHADE2_PER_ROW = 4
DET_EPS = 1e-12
# Per-thread stack capacity of the kernels (MAX_STACK in csrc/traverse8.cu).
MAX_STACK = 256
# Kernel launches by kernel since the last reset (set the entries to 0 to
# start counting): K1 nearest hit (shade modes 0/1), K3 nearest hit with
# textured shading (mode 2), K2 any-hit on the 12-record rows, K2_dense
# any-hit on the dense rows.
LAUNCHES = {"K1": 0, "K2": 0, "K2_dense": 0, "K3": 0}
# The telemetry a kernel writes per ray when asked (the reference's
# counters=True): supernode pops, triangle-row bodies, leaf pops, triangle
# tests.
COUNTERS = ("supernode_pops", "row_bodies", "leaf_pops", "triangle_tests")
# The plain versions keep each ray chunk's (rays x records) intermediates
# near this many bytes.
_PLAIN_CHUNK_BYTES = 256 << 20


def _pack_rows(records: np.ndarray, per_row: int) -> np.ndarray:
    """(T, S) -> (ceil(T/per_row), 128) rows: record j of a row occupies
    floats [S*j, S*j + S); floats past per_row*S are zero padding."""
    records = np.asarray(records, np.float32)
    t, stride = records.shape
    rows = -(-max(t, 1) // per_row)
    padded = np.zeros((rows * per_row, stride), np.float32)
    padded[:t] = records
    out = np.zeros((rows, LANES), np.float32)
    out[:, :per_row * stride] = padded.reshape(rows, per_row * stride)
    return out


def _edge_records(tri_pos: np.ndarray, stride: int) -> np.ndarray:
    tri_pos = np.asarray(tri_pos, np.float32)
    packed = np.zeros((tri_pos.shape[0], stride), np.float32)
    packed[:, 0:3] = tri_pos[:, 0]
    packed[:, 3:6] = tri_pos[:, 1] - tri_pos[:, 0]
    packed[:, 6:9] = tri_pos[:, 2] - tri_pos[:, 0]
    return packed


def pack_tris(tri_pos: np.ndarray, tri_double_sided: np.ndarray
              ) -> np.ndarray:
    """Flat-packed triangle table: TRI_PER_ROW records of TRI_STRIDE f32
    per 128-float row, [v0.xyz, e1.xyz, e2.xyz, double_sided 0/1]."""
    packed = _edge_records(tri_pos, TRI_STRIDE)
    packed[:, 9] = np.asarray(tri_double_sided).astype(np.float32)
    return _pack_rows(packed, TRI_PER_ROW)


def pack_tris_dense(tri_pos: np.ndarray) -> np.ndarray:
    """Dense any-hit triangle table: DENSE_PER_ROW records of DENSE_STRIDE
    f32 per row, [v0.xyz, e1.xyz, e2.xyz] (occlusion queries need no
    double-sided flag).  Its leaves start at multiples of DENSE_PER_ROW, so
    it goes with its own supernode rows (dispatch.prepare_tables)."""
    return _pack_rows(_edge_records(tri_pos, DENSE_STRIDE), DENSE_PER_ROW)


def pack_shade_records(tri_nrm, tri_mat, textured: bool = False,
                       tri_tan=None, tri_uv=None, tri_uvd=None
                       ) -> np.ndarray:
    """Per-triangle fused-shading records, parallel to pack_tris rows (the
    record count is padded to whole triangle rows).

    Mode 1 (untextured): [n0.xyz, n1.xyz, n2.xyz, mat], TRI_PER_ROW per row.
    Mode 2 (textured): [... as mode 1, t0.xyz, t1.xyz, t2.xyz, uv0.xy,
    uv1.xy, uv2.xy, uv_density], SHADE2_PER_ROW per row; needs tri_tan and
    tri_uv, and tri_uvd (float 25) is zero when not given."""
    if textured and (tri_tan is None or tri_uv is None):
        raise ValueError("textured shade records need tri_tan and tri_uv")
    nrm = np.asarray(tri_nrm, np.float32)
    t = nrm.shape[0]
    t_pad = -(-max(t, 1) // TRI_PER_ROW) * TRI_PER_ROW
    packed = np.zeros((t_pad, SHADE2_STRIDE if textured else SHADE1_STRIDE),
                      np.float32)
    if t:
        packed[:t, 0:9] = nrm.reshape(t, 9)
        packed[:t, 9] = np.asarray(tri_mat, np.float32)
        if textured:
            packed[:t, 10:19] = np.asarray(tri_tan, np.float32).reshape(t, 9)
            packed[:t, 19:25] = np.asarray(tri_uv, np.float32).reshape(t, 6)
            if tri_uvd is not None:
                packed[:t, 25] = np.asarray(tri_uvd, np.float32)
    return _pack_rows(packed, SHADE2_PER_ROW if textured else TRI_PER_ROW)


# ---------------------------------------------------------------------------
# Wrappers: kernel for CUDA tensors, plain version for CPU tensors
# ---------------------------------------------------------------------------

def _rays_and_interval(o, d, t_min, t_max, device):
    """(N, 3) float32 o/d on `device`, and t_min/t_max (scalars or (N,))
    broadcast to contiguous (N,) float32 tensors."""
    for name, x in (("o", o), ("d", d)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(x)}")
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
            raise ValueError(f"{name} must be (N, 3) float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if o.shape != d.shape:
        raise ValueError(f"o {tuple(o.shape)} and d {tuple(d.shape)} differ")
    n = o.shape[0]

    def interval(x, name):
        if isinstance(x, torch.Tensor):
            if x.device != device:
                raise ValueError(f"{name} is on {x.device}, rays on {device}")
            if x.dim() == 1 and x.shape[0] != n:
                raise ValueError(f"{name} has {x.shape[0]} entries for "
                                 f"{n} rays")
            return x.to(torch.float32).expand(n).contiguous()
        return torch.full((n,), float(x), dtype=torch.float32, device=device)

    return (o.contiguous(), d.contiguous(), interval(t_min, "t_min"),
            interval(t_max, "t_max"))


def _one_device(tensors: dict, t_min, t_max) -> torch.device:
    for name, x in (("t_min", t_min), ("t_max", t_max)):
        if isinstance(x, torch.Tensor):
            tensors[name] = x
    devices = {x.device for x in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"trace inputs lie on several devices: "
                         + ", ".join(f"{k} on {v.device}"
                                     for k, v in tensors.items()))
    device = devices.pop()
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no trace path for device {device}")
    return device


def trace_nearest_bvh8(bvh8: BVH8, tris_packed: torch.Tensor,
                       o: torch.Tensor, d: torch.Tensor, t_min, t_max,
                       cull_backface: bool = True,
                       shade_rows: torch.Tensor | None = None,
                       shade_mode: int = 0) -> dict:
    """Nearest hit of each ray over a BVH8; the contract of the reference's
    trace_nearest_packet8 (pallas_traverse.py:752-778).

    Returns a dict of (N,) tensors: t (-1 on a miss), tri (record index,
    -1 on a miss), u, v, hit; with shade_mode 1 or 2 (and shade_rows from
    pack_shade_records in that mode) also n (N, 3), the interpolated normal,
    normalized and flipped when det < 0, and mat (N,) int32; with mode 2
    also tan (N, 3), the interpolated tangent, normalized and not flipped,
    uv (N, 2) and uvd (N,).  A ray with t_max < t_min is dead and misses."""
    tensors = {"bvh8.rows": bvh8.rows, "tris_packed": tris_packed, "o": o,
               "d": d}
    if shade_mode not in (0, 1, 2):
        raise ValueError(f"shade_mode must be 0, 1 or 2, got {shade_mode}")
    if shade_mode:
        if shade_rows is None:
            raise ValueError(f"shade_mode {shade_mode} needs shade_rows")
        tensors["shade_rows"] = shade_rows
    device = _one_device(tensors, t_min, t_max)
    if device.type == "cuda":
        launch, rec = kernel_launcher(bvh8, tris_packed, o, d, t_min, t_max,
                                      cull_backface, shade_rows, shade_mode)
        launch()
        rec["hit"] = rec["tri"] >= 0
        return rec
    return trace_nearest_bvh8_plain(bvh8, tris_packed, o, d, t_min, t_max,
                                    cull_backface, shade_rows, shade_mode)


def trace_any_bvh8(bvh8: BVH8, tris: torch.Tensor, o: torch.Tensor,
                   d: torch.Tensor, t_min, t_max, dense: bool = False
                   ) -> torch.Tensor:
    """Occlusion of each ray over a BVH8: (N,) bool, true when any triangle
    is hit (no culling) with t in [t_min, t_max]; a dead ray (t_max <
    t_min) is never occluded.  `tris` is pack_tris rows, or with dense=True
    pack_tris_dense rows over their own supernode rows (the contracts of
    trace_nearest_packet8(any_hit=True) and trace_anyhit_dense,
    pallas_traverse.py:574-594, :781-794)."""
    device = _one_device({"bvh8.rows": bvh8.rows, "tris": tris, "o": o,
                          "d": d}, t_min, t_max)
    if device.type == "cuda":
        launch, rec = anyhit_launcher(bvh8, tris, o, d, t_min, t_max, dense)
        launch()
        return rec["hit"]
    return trace_any_bvh8_plain(bvh8, tris, o, d, t_min, t_max, dense)


def _check_table(name, x, device):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"{name} must be (R, {LANES}) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device != device or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def _check_launch(bvh8, tris, device):
    if device.type != "cuda":
        raise ValueError(f"the trace kernel needs CUDA tensors, got {device}")
    _check_table("bvh8.rows", bvh8.rows, device)
    _check_table("tris", tris, device)
    if 8 * bvh8.depth + 16 > MAX_STACK:
        raise ValueError(f"BVH8 depth {bvh8.depth} needs a stack of "
                         f"{8 * bvh8.depth + 16} > {MAX_STACK} entries")


def _launch_fn(kernel: str, entry: str, args, tensors):
    """A launch closure: runs `entry` of the kernel library with `args` on
    the current stream and adds one to LAUNCHES[kernel]."""
    from steeljax_torch.native import cuda_library

    lib = cuda_library()
    fn = getattr(lib, entry)
    device = tensors[0].device

    def launch():
        # The kernel library's runtime launches into the context current
        # on this thread, which torch.cuda.device makes the tensors' own.
        with torch.cuda.device(device):
            status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if status != 0:
            raise RuntimeError(f"{entry} launch failed: CUDA error {status}")
        LAUNCHES[kernel] += 1

    # The pointers in `args` stay valid while the launcher holds the
    # tensors they point into.
    launch.tensors = tensors
    return launch


def _telemetry(n: int, bvh8, tris, per_row: int) -> dict:
    """The tensors a counting launch writes: "counters" (N, 4) int32, the
    per-ray telemetry named in COUNTERS; "seen_nodes" (S,) uint8, 1 for
    every supernode row some ray popped; "seen_records" (R * per_row,)
    uint8, 1 for every triangle record some ray tested.  The seen flags are
    set by every launch and never cleared."""
    device = tris.device
    return {"counters": torch.empty((n, len(COUNTERS)), dtype=torch.int32,
                                    device=device),
            "seen_nodes": torch.zeros(bvh8.rows.shape[0], dtype=torch.uint8,
                                      device=device),
            "seen_records": torch.zeros(tris.shape[0] * per_row,
                                        dtype=torch.uint8, device=device)}


def kernel_launcher(bvh8, tris_packed, o, d, t_min, t_max,
                    cull_backface: bool = True, shade_rows=None,
                    shade_mode: int = 0, counters: bool = False):
    """Check the inputs of one nearest-hit kernel call (K1, or K3 for shade
    mode 2) on CUDA tensors and allocate its outputs.  Returns (launch,
    rec): each `launch()` runs the kernel on the current stream into rec's
    tensors and adds one to LAUNCHES.  The wrapper calls it once; a
    benchmark can repeat it without the wrapper's host work.  counters=True
    adds the telemetry of _telemetry."""
    device = o.device
    _check_launch(bvh8, tris_packed, device)
    if shade_mode:
        _check_table("shade_rows", shade_rows, device)
        per_tri_row = 1 if shade_mode == 1 else TRI_PER_ROW // SHADE2_PER_ROW
        if shade_rows.shape[0] < per_tri_row * tris_packed.shape[0]:
            raise ValueError(f"shade_rows has {shade_rows.shape[0]} rows; "
                             f"mode {shade_mode} needs {per_tri_row} per "
                             "triangle row")
    o, d, tmn, tmx = _rays_and_interval(o, d, t_min, t_max, device)
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    rec = {"t": torch.empty(n, **f32), "u": torch.empty(n, **f32),
           "v": torch.empty(n, **f32),
           "tri": torch.empty(n, dtype=torch.int32, device=device)}
    if shade_mode:
        rec["n"] = torch.empty((n, 3), **f32)
        rec["mat"] = torch.empty(n, dtype=torch.int32, device=device)
    if shade_mode == 2:
        rec["tan"] = torch.empty((n, 3), **f32)
        rec["uv"] = torch.empty((n, 2), **f32)
        rec["uvd"] = torch.empty(n, **f32)
    if counters:
        rec.update(_telemetry(n, bvh8, tris_packed, TRI_PER_ROW))

    def ptr(name):
        return rec[name].data_ptr() if name in rec else None

    args = (bvh8.rows.data_ptr(), tris_packed.data_ptr(),
            shade_rows.data_ptr() if shade_mode else None, o.data_ptr(),
            d.data_ptr(), tmn.data_ptr(), tmx.data_ptr(), ptr("t"), ptr("u"),
            ptr("v"), ptr("tri"), ptr("n"), ptr("mat"), ptr("tan"),
            ptr("uv"), ptr("uvd"), ptr("counters"), ptr("seen_nodes"),
            ptr("seen_records"), n, bvh8.max_leaf,
            bvh8.depth, int(bool(cull_backface)), shade_mode)
    return _launch_fn("K3" if shade_mode == 2 else "K1",
                      "steeljax_trace_nearest8", args,
                      (bvh8.rows, tris_packed, shade_rows, o, d, tmn,
                       tmx)), rec


def anyhit_launcher(bvh8, tris, o, d, t_min, t_max, dense: bool = False,
                    counters: bool = False):
    """The any-hit kernel K2's launcher, as kernel_launcher: rec["hit"] is
    (N,) bool; counters=True adds the telemetry of _telemetry."""
    device = o.device
    _check_launch(bvh8, tris, device)
    o, d, tmn, tmx = _rays_and_interval(o, d, t_min, t_max, device)
    n = o.shape[0]
    # The kernel writes one byte, 0 or 1, per ray: a bool tensor's storage.
    rec = {"hit": torch.empty(n, dtype=torch.bool, device=device)}
    if counters:
        rec.update(_telemetry(n, bvh8, tris,
                              DENSE_PER_ROW if dense else TRI_PER_ROW))

    def ptr(name):
        return rec[name].data_ptr() if name in rec else None

    args = (bvh8.rows.data_ptr(), tris.data_ptr(), o.data_ptr(),
            d.data_ptr(), tmn.data_ptr(), tmx.data_ptr(),
            rec["hit"].data_ptr(), ptr("counters"), ptr("seen_nodes"),
            ptr("seen_records"), n, bvh8.max_leaf, bvh8.depth,
            int(bool(dense)))
    return _launch_fn("K2_dense" if dense else "K2", "steeljax_trace_any8",
                      args, (bvh8.rows, tris, o, d, tmn, tmx)), rec


# ---------------------------------------------------------------------------
# Plain versions (brute force over every packed record)
# ---------------------------------------------------------------------------

def _records(tris: torch.Tensor, per_row: int, stride: int):
    """v0, e1, e2 as lists of (K,) columns of every record of the rows."""
    rec = tris[:, :per_row * stride].reshape(-1, stride)
    return ([rec[:, c] for c in range(0, 3)], [rec[:, c] for c in range(3, 6)],
            [rec[:, c] for c in range(6, 9)], rec)


def _candidates(v0, e1, e2, o, d, lo, hi):
    """The kernel's per-candidate arithmetic for a chunk of rays (columns
    (n, 1)) against every record (rows (K,)): (det, det_ok, u, v, t,
    inside), with inside = u >= 0, v >= 0, u + v <= 1, lo <= t <= hi."""
    ox, oy, oz = (o[:, c:c + 1] for c in range(3))
    dx, dy, dz = (d[:, c:c + 1] for c in range(3))
    px = dy * e2[2] - dz * e2[1]
    py = dz * e2[0] - dx * e2[2]
    pz = dx * e2[1] - dy * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    det_ok = det.abs() > DET_EPS
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    tx = ox - v0[0]
    ty = oy - v0[1]
    tz = oz - v0[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    inside = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= lo[:, None])
              & (t <= hi[:, None]))
    return det, det_ok, u, v, t, inside


def trace_nearest_bvh8_plain(bvh8: BVH8, tris_packed: torch.Tensor,
                             o: torch.Tensor, d: torch.Tensor, t_min, t_max,
                             cull_backface: bool = True,
                             shade_rows: torch.Tensor | None = None,
                             shade_mode: int = 0) -> dict:
    """Plain version of the nearest-hit kernels K1 and K3, same signature
    and outputs.

    Brute force: every packed record is tested against every ray with the
    kernel's per-candidate arithmetic, in ray chunks; the nearest accepted
    candidate wins.  Pad records (3e37 positions, or all-zero lanes) fail
    the determinant test on their own, so the BVH is not needed.  It differs
    from the kernel only on exact-t ties (which candidate wins) and on
    grazing box-boundary rays, the cases kernel_parity._compare budgets."""
    if shade_mode not in (0, 1, 2):
        raise ValueError(f"shade_mode must be 0, 1 or 2, got {shade_mode}")
    device = o.device
    o, d, tmn, tmx = _rays_and_interval(o, d, t_min, t_max, device)
    n = o.shape[0]
    v0, e1, e2, rec_all = _records(tris_packed, TRI_PER_ROW, TRI_STRIDE)
    k = rec_all.shape[0]
    ds = rec_all[:, 9] > 0.5

    out_t = torch.empty(n, dtype=torch.float32, device=device)
    out_u = torch.empty_like(out_t)
    out_v = torch.empty_like(out_t)
    out_tri = torch.empty(n, dtype=torch.int32, device=device)
    out_det = torch.empty_like(out_t)
    chunk = max(1, _PLAIN_CHUNK_BYTES // (max(k, 1) * 4 * 24))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        det, det_ok, u, v, t, inside = _candidates(
            v0, e1, e2, o[s:e], d[s:e], tmn[s:e], tmx[s:e])
        if cull_backface:
            facing = (det > DET_EPS) | (ds & det_ok)
        else:
            facing = det_ok
        hit = facing & inside
        t_acc = torch.where(hit, t, torch.full_like(t, float("inf")))
        best_t, best = t_acc.min(dim=1)
        found = torch.isfinite(best_t)
        pick = best[:, None]
        out_t[s:e] = torch.where(found, best_t, torch.full_like(best_t, -1.0))
        zero = torch.zeros_like(best_t)
        out_u[s:e] = torch.where(found, u.gather(1, pick)[:, 0], zero)
        out_v[s:e] = torch.where(found, v.gather(1, pick)[:, 0], zero)
        out_det[s:e] = torch.where(found, det.gather(1, pick)[:, 0],
                                   torch.ones_like(best_t))
        out_tri[s:e] = torch.where(found, best,
                                   torch.full_like(best, -1)).to(torch.int32)
    rec = {"t": out_t, "tri": out_tri, "u": out_u, "v": out_v,
           "hit": out_tri >= 0}
    if shade_mode:
        rec.update(_shade_plain(shade_rows, shade_mode, out_tri, out_u,
                                out_v, out_det))
    return rec


def _shade_plain(shade_rows, shade_mode, tri, u, v, det) -> dict:
    """The nearest kernels' epilogue: interpolate the winner's normal at
    (u, v), normalize, flip when det < 0; misses get n = +z and mat 0.  Mode
    2 adds the tangent (normalized, not flipped; +x on a miss), the uv and
    the uv density (0 on a miss)."""
    per_row, stride = ((TRI_PER_ROW, SHADE1_STRIDE) if shade_mode == 1
                       else (SHADE2_PER_ROW, SHADE2_STRIDE))
    # Record k of the mode-2 table sits at row (k / 12) * 3 + (k % 12) / 4,
    # slot k % 4, which is row k / 4: the rows read in order.
    records = shade_rows[:, :per_row * stride].reshape(-1, stride)
    hit = tri >= 0
    s = records[tri.clamp(min=0).long()]
    wb = (1.0 - u - v)[:, None]
    uu = u[:, None]
    vv = v[:, None]

    def interp(a, b, c):
        return s[:, a] * wb + s[:, b] * uu + s[:, c] * vv

    def on_hit(value, one_at=None):
        """value on hits; on misses zero, or the unit vector along
        axis `one_at`."""
        miss = torch.zeros_like(value)
        if one_at is not None:
            miss[:, one_at] = 1.0
        return torch.where(hit[:, None], value, miss)

    nrm = on_hit(interp(slice(0, 3), slice(3, 6), slice(6, 9)), one_at=2)
    n2 = (nrm * nrm).sum(dim=-1)
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    inv_n = sgn * torch.rsqrt(torch.clamp(n2, min=1e-20))
    out = {"n": nrm * inv_n[:, None],
           "mat": on_hit(s[:, 9:10])[:, 0].to(torch.int32)}
    if shade_mode == 2:
        tan = on_hit(interp(slice(10, 13), slice(13, 16), slice(16, 19)),
                     one_at=0)
        t2 = (tan * tan).sum(dim=-1)
        out["tan"] = tan * torch.rsqrt(torch.clamp(t2, min=1e-20))[:, None]
        out["uv"] = on_hit(interp(slice(19, 21), slice(21, 23),
                                  slice(23, 25)))
        out["uvd"] = on_hit(s[:, 25:26])[:, 0]
    return out


def trace_any_bvh8_plain(bvh8: BVH8, tris: torch.Tensor, o: torch.Tensor,
                         d: torch.Tensor, t_min, t_max, dense: bool = False
                         ) -> torch.Tensor:
    """Plain version of the any-hit kernel K2, same signature and output.

    Brute force, like trace_nearest_bvh8_plain: a ray is occluded when any
    record passes |det| > 1e-12, u >= 0, v >= 0, u + v <= 1 and t_min <= t
    <= t_max, with no culling; a dead ray passes no t test.  `dense` reads
    the 9-float records of pack_tris_dense."""
    device = o.device
    o, d, tmn, tmx = _rays_and_interval(o, d, t_min, t_max, device)
    n = o.shape[0]
    per_row, stride = ((DENSE_PER_ROW, DENSE_STRIDE) if dense
                       else (TRI_PER_ROW, TRI_STRIDE))
    v0, e1, e2, rec_all = _records(tris, per_row, stride)
    k = rec_all.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=device)
    chunk = max(1, _PLAIN_CHUNK_BYTES // (max(k, 1) * 4 * 24))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        _, det_ok, _, _, _, inside = _candidates(
            v0, e1, e2, o[s:e], d[s:e], tmn[s:e], tmx[s:e])
        out[s:e] = (det_ok & inside).any(dim=1)
    return out
