"""BVH8 traversal: table packers, the CUDA kernels' wrappers and their plain
PyTorch versions.  The flat kernels K1-K5 read supernode rows 8 or 16
children wide (BVH8.width); K6 and K7 read 8-wide rows.

Port of steeljax/accel/pallas_traverse.py:48-191 (packers), :249-794
(`_traverse_kernel8`), :812-1138 (`_multihit_kernel`), :1149-1261
(`_trace_packed8_treelet`) and :1283-1801 (`_traverse_kernel8_inst`): the
nearest-hit query with shade modes 0 and 1 (K1) and 2 (K3), the any-hit
occlusion query over the 12-record rows or the dense 14-record rows (K2),
both queries with in-kernel alpha-coverage masks (K4: the coarse mask in the
records' AUX lane, optionally the fine PASS plane of a parallel int32 row
table), the K-nearest multi-hit query (K5), the two-level query over an
instance TLAS and object-space BLAS (K6) and the rounds of the treelet
scheduler, each a flat query over one treelet per ray packet that updates
the scheduler's state in place and picks every packet's next treelet (K7).
The kernels are `csrc/alpha8.cu` (K1-K5: one walk with three candidate
policies), `csrc/instanced8.cu` (K6) and `csrc/treelet8.cu` (K7 and the
scheduler's first pick), all over the Hopper record table of
`hopper_records`; native.cuda_library() builds them, and they are called
through plain C functions.

`trace_nearest_bvh8`, `trace_any_bvh8`, `trace_multihit_bvh8`,
`trace_nearest_bvh8_inst`, `trace_treelet_round` and `treelet_pick` launch
their kernel for CUDA tensors and run the plain version only because their
tensors lie on the CPU; mixed devices raise, and a build or launch failure
raises — nothing falls back.  Every launch adds one to the kernel's entry in
the module-level `LAUNCHES`, so a run can show that its path went through
the kernel.

Packet size, shared-origin and coherence knobs of the reference change the
TPU's scheduling, not the result, and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext

import numpy as np
import torch
from torch.profiler import record_function

from steeljax_torch.accel import alphamask
from steeljax_torch.accel.bvh import (BVH8, DENSE_PER_ROW, DENSE_STRIDE,
                                      SNODE_WIDTHS, TRI_PER_ROW, TRI_STRIDE)
from steeljax_torch.core.constants import RAY_DEAD_T

LANES = 128
# Fused-shading record layouts (pack_shade_records): mode 1 has
# SHADE1_STRIDE floats per record, TRI_PER_ROW records per row (the triangle
# table's row index); mode 2 has SHADE2_STRIDE floats, SHADE2_PER_ROW per
# row, so three shade rows per triangle row.
SHADE1_STRIDE = 10
SHADE2_STRIDE = 26
SHADE2_PER_ROW = 4
DET_EPS = 1e-12
# Per-thread stack capacity of the kernels (MAX_STACK in
# csrc/trace8_common.cuh): a flat tree of supernode width w and depth D
# needs w * D + 16 entries (the reference's bound, pallas_traverse.py:698).
MAX_STACK = 256
# Floats per record of the Hopper record table (hopper_records).
HOPPER_RECORD = 12
# A treelet pick key with no pick yet (csrc/treelet8.cu kEmptyKey); see
# pick_keys_plain for the key's fields.
EMPTY_KEY = (1 << 63) - 1
# Kernel launches by kernel since the last reset (set the entries to 0 to
# start counting): K1 nearest hit (shade modes 0/1), K3 nearest hit with
# textured shading (mode 2), K2 any-hit on the 12-record rows, K2_dense
# any-hit on the dense rows, K4 nearest hit with alpha masks, K4_anyhit
# any-hit with alpha masks, K5 the K-nearest multi-hit query, K6 the two-level
# instanced nearest hit (every shade mode), K6_anyhit its any-hit query, K7
# one treelet round of nearest hits (every shade mode, with or without
# coarse alpha masks), K7_anyhit a treelet round of occlusion flags, K7_pick
# the first packet pick of a treelet trace, R the raster G-buffer's tile
# kernel (render/hybrid/raster.py, csrc/raster.cu).
LAUNCHES = {"K1": 0, "K2": 0, "K2_dense": 0, "K3": 0, "K4": 0,
            "K4_anyhit": 0, "K5": 0, "K6": 0, "K6_anyhit": 0, "K7": 0,
            "K7_anyhit": 0, "K7_pick": 0, "R": 0}
# The profiler range of a launch: this prefix and its LAUNCHES key.
PROFILER_RANGE = "trace_kernel."
# The slot counts the multi-hit kernel is compiled for.
MULTIHIT_K = (2, 4, 8)
# The telemetry a kernel writes per ray when asked (the reference's
# counters=True): supernode pops, triangle-row bodies, leaf pops, triangle
# tests, and of the alpha kernels the candidates that reached the coarse
# mask test and the fine one (0 in the other kernels).
COUNTERS = ("supernode_pops", "row_bodies", "leaf_pops", "triangle_tests",
            "mask_tests", "fine_tests")
# The two-level kernel K6's per-ray telemetry: its last two counters are
# the instances a ray entered (each a ray transform) and, of its supernode
# pops, those of TLAS rows.
INST_COUNTERS = COUNTERS[:4] + ("instance_enters", "tlas_pops")
# Floats per instance row of the two-level tables (instances.INST_COLS).
INST_COLS = 48
# The plain versions keep each ray chunk's (rays x records) intermediates
# near this many bytes: 256 MiB on the host, 4 GiB on the card, whose 80 GB
# let the brute force over a million records take a dozen rays at a time.
_PLAIN_CHUNK_BYTES = {"cpu": 256 << 20, "cuda": 4 << 30}


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


def pack_tris(tri_pos: np.ndarray, tri_double_sided: np.ndarray,
              tri_alpha_mask: np.ndarray | None = None) -> np.ndarray:
    """Flat-packed triangle table: TRI_PER_ROW records of TRI_STRIDE f32
    per 128-float row, [v0.xyz, e1.xyz, e2.xyz, double_sided 0/1].  With
    `tri_alpha_mask` ((T,) uint32, alphamask.compute_alpha_masks) the last
    float is the AUX word ds | mask << 1, an exact integer below 2^22, which
    the alpha-masked kernels decode."""
    packed = _edge_records(tri_pos, TRI_STRIDE)
    ds = np.asarray(tri_double_sided).astype(np.uint32)
    if tri_alpha_mask is None:
        packed[:, 9] = ds.astype(np.float32)
    else:
        aux = ds | (np.asarray(tri_alpha_mask, np.uint32) << 1)
        packed[:, 9] = aux.astype(np.float32)  # exact: < 2^22
    return _pack_rows(packed, TRI_PER_ROW)


def pack_fine_mask_rows(fine_masks: np.ndarray) -> np.ndarray:
    """(T, FINE_STRIDE) int32 two-plane fine masks -> (ceil(T/TRI_PER_ROW),
    128) int32 rows parallel to pack_tris: record j of a row occupies
    words [FINE_STRIDE*j, FINE_STRIDE*j + FINE_STRIDE).  Pad records get
    PASS = 0 (their triangle test never hits anyway)."""
    m = np.asarray(fine_masks, np.int32)
    t, stride = m.shape
    rows = -(-max(t, 1) // TRI_PER_ROW)
    padded = np.zeros((rows * TRI_PER_ROW, stride), np.int32)
    padded[:t] = m
    out = np.zeros((rows, LANES), np.int32)
    out[:, :TRI_PER_ROW * stride] = padded.reshape(
        rows, TRI_PER_ROW * stride)
    return out


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


def hopper_records(tris: torch.Tensor, dense: bool = False) -> torch.Tensor:
    """The Hopper record table of csrc/alpha8.cu, instanced8.cu and
    treelet8.cu, derived from pack_tris rows on their device: (R *
    TRI_PER_ROW, HOPPER_RECORD) float32, record k as three 16-byte float4s
    [v0.xyz, f9], [e1.xyz, 0], [e2.xyz, 0], where f9 is the reference
    record's last float (the AUX word, or the double-sided flag).  With
    `dense`, from pack_tris_dense rows: (R * DENSE_PER_ROW, HOPPER_RECORD),
    f9 = 0 (the dense records have no tenth float).  Record ids are the
    rows', so leaf starts and counts hold."""
    per_row, stride = ((DENSE_PER_ROW, DENSE_STRIDE) if dense
                       else (TRI_PER_ROW, TRI_STRIDE))
    rec = tris[:, :per_row * stride].reshape(-1, stride)
    out = torch.zeros((rec.shape[0], HOPPER_RECORD), dtype=torch.float32,
                      device=tris.device)
    out[:, 0:3] = rec[:, 0:3]
    if not dense:
        out[:, 3] = rec[:, 9]
    out[:, 4:7] = rec[:, 3:6]
    out[:, 8:11] = rec[:, 6:9]
    return out


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

def _alpha_tensors(tensors: dict, alpha_mask: bool, fine_rows,
                   shade_mode: int = 0) -> None:
    """Check the alpha arguments of a trace call and add fine_rows to its
    device check."""
    if fine_rows is not None:
        if not alpha_mask:
            raise ValueError("fine_rows need alpha_mask=True")
        tensors["fine_rows"] = fine_rows
    if alpha_mask and shade_mode:
        raise ValueError("the alpha-masked kernels have no fused shading "
                         f"(shade_mode {shade_mode})")


def _check_shade_rows(shade_rows, shade_mode: int, tri_rows: int) -> None:
    """Shading rows of `shade_mode` for `tri_rows` triangle rows: exactly
    1 row per triangle row in mode 1 and TRI_PER_ROW / SHADE2_PER_ROW in
    mode 2 (pack_shade_records of the same triangles).  Mode-2 rows hold
    three times as many rows as mode-1 ones, so a count that is only large
    enough would let a mode-1 walk read 26-float records as 10-float ones."""
    if shade_mode not in (0, 1, 2):
        raise ValueError(f"shade_mode must be 0, 1 or 2, got {shade_mode}")
    if not shade_mode:
        return
    if shade_rows is None:
        raise ValueError(f"shade_mode {shade_mode} needs shade_rows")
    per_tri_row = 1 if shade_mode == 1 else TRI_PER_ROW // SHADE2_PER_ROW
    if shade_rows.shape[0] != per_tri_row * tri_rows:
        raise ValueError(f"shade_rows has {shade_rows.shape[0]} rows for "
                         f"{tri_rows} triangle rows; shade mode {shade_mode} "
                         f"needs exactly {per_tri_row} per triangle row "
                         "(rows packed in another mode?)")


def trace_nearest_bvh8(bvh8: BVH8, tris_packed: torch.Tensor,
                       o: torch.Tensor, d: torch.Tensor, t_min, t_max,
                       cull_backface: bool = True,
                       shade_rows: torch.Tensor | None = None,
                       shade_mode: int = 0, alpha_mask: bool = False,
                       fine_rows: torch.Tensor | None = None,
                       records: torch.Tensor | None = None) -> dict:
    """Nearest hit of each ray over a BVH8; the contract of the reference's
    trace_nearest_packet8 (pallas_traverse.py:752-778).

    Returns a dict of (N,) tensors: t (-1 on a miss), tri (record index,
    -1 on a miss), u, v, hit; with shade_mode 1 or 2 (and shade_rows from
    pack_shade_records in that mode) also n (N, 3), the interpolated normal,
    normalized and flipped when det < 0, and mat (N,) int32; with mode 2
    also tan (N, 3), the interpolated tangent, normalized and not flipped,
    uv (N, 2) and uvd (N,).  A ray with t_max < t_min is dead and misses.
    alpha_mask=True (K4) decodes the AUX words of tris packed with masks
    and drops candidates whose coverage cell is provably transparent;
    `fine_rows` (pack_fine_mask_rows) adds the fine PASS plane.  `records`
    is hopper_records(tris_packed), the triangle table the kernels read
    (derived anew for the call when None; the plain version reads
    tris_packed)."""
    tensors = {"bvh8.rows": bvh8.rows, "tris_packed": tris_packed, "o": o,
               "d": d}
    if shade_mode not in (0, 1, 2):
        raise ValueError(f"shade_mode must be 0, 1 or 2, got {shade_mode}")
    if shade_mode:
        if shade_rows is None:
            raise ValueError(f"shade_mode {shade_mode} needs shade_rows")
        tensors["shade_rows"] = shade_rows
    if records is not None:
        tensors["records"] = records
    _alpha_tensors(tensors, alpha_mask, fine_rows, shade_mode)
    device = _one_device(tensors, t_min, t_max)
    if device.type == "cuda":
        launch, rec = kernel_launcher(bvh8, tris_packed, o, d, t_min, t_max,
                                      cull_backface, shade_rows, shade_mode,
                                      alpha_mask=alpha_mask,
                                      fine_rows=fine_rows, records=records)
        launch()
        rec["hit"] = rec["tri"] >= 0
        return rec
    return trace_nearest_bvh8_plain(bvh8, tris_packed, o, d, t_min, t_max,
                                    cull_backface, shade_rows, shade_mode,
                                    alpha_mask, fine_rows)


def trace_any_bvh8(bvh8: BVH8, tris: torch.Tensor, o: torch.Tensor,
                   d: torch.Tensor, t_min, t_max, dense: bool = False,
                   alpha_mask: bool = False,
                   fine_rows: torch.Tensor | None = None,
                   records: torch.Tensor | None = None) -> torch.Tensor:
    """Occlusion of each ray over a BVH8: (N,) bool, true when any triangle
    is hit (no culling) with t in [t_min, t_max]; a dead ray (t_max <
    t_min) is never occluded.  `tris` is pack_tris rows, or with dense=True
    pack_tris_dense rows over their own supernode rows (the contracts of
    trace_nearest_packet8(any_hit=True) and trace_anyhit_dense,
    pallas_traverse.py:574-594, :781-794).  alpha_mask and fine_rows as in
    trace_nearest_bvh8 (K4_anyhit; not with dense rows); `records` is
    hopper_records(tris, dense), derived anew for the call when None."""
    tensors = {"bvh8.rows": bvh8.rows, "tris": tris, "o": o, "d": d}
    if records is not None:
        tensors["records"] = records
    _alpha_tensors(tensors, alpha_mask, fine_rows)
    if dense and alpha_mask:
        raise ValueError("the dense any-hit rows carry no alpha masks")
    device = _one_device(tensors, t_min, t_max)
    if device.type == "cuda":
        launch, rec = anyhit_launcher(bvh8, tris, o, d, t_min, t_max, dense,
                                      alpha_mask=alpha_mask,
                                      fine_rows=fine_rows, records=records)
        launch()
        return rec["hit"]
    return trace_any_bvh8_plain(bvh8, tris, o, d, t_min, t_max, dense,
                                alpha_mask, fine_rows)


def _check_k(k_hits: int) -> None:
    if k_hits not in MULTIHIT_K:
        raise ValueError(f"the multi-hit kernel is built for K in "
                         f"{MULTIHIT_K}, got {k_hits}")


def trace_multihit_bvh8(bvh8: BVH8, tris: torch.Tensor, o: torch.Tensor,
                        d: torch.Tensor, t_min, t_max, k_hits: int,
                        cull_backface: bool = True, alpha_mask: bool = False,
                        fine_rows: torch.Tensor | None = None,
                        records: torch.Tensor | None = None) -> dict:
    """The K nearest hits of each ray (K5), the contract of the reference's
    trace_multihit_packet8 (pallas_traverse.py:1117-1138): {"t", "u", "v",
    "tri"}, each (K, N), sorted ascending by t per ray; slot k holds t -1,
    u = v = 0 and tri -1 when the ray has fewer than k + 1 hits with t in
    [t_min, t_max).  alpha_mask drops candidates the coarse masks reject;
    `fine_rows` also applies the fine PASS plane and bounds each ray by its
    nearest OPAQUE-plane hit ob: the slots then hold the K nearest PASS hits
    with t <= ob.  `records` as in trace_nearest_bvh8."""
    _check_k(k_hits)
    tensors = {"bvh8.rows": bvh8.rows, "tris": tris, "o": o, "d": d}
    _alpha_tensors(tensors, alpha_mask, fine_rows)
    device = _one_device(tensors, t_min, t_max)
    if device.type == "cuda":
        launch, rec = multihit_launcher(bvh8, tris, o, d, t_min, t_max,
                                        k_hits, cull_backface,
                                        alpha_mask=alpha_mask,
                                        fine_rows=fine_rows, records=records)
        launch()
        return rec
    return trace_multihit_bvh8_plain(bvh8, tris, o, d, t_min, t_max, k_hits,
                                     cull_backface, alpha_mask, fine_rows)


def _check_table(name, x, device, dtype=torch.float32):
    if x.dtype != dtype or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"{name} must be (R, {LANES}) {dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device != device or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def _check_launch(bvh8, tris, device, fine_rows=None):
    if device.type != "cuda":
        raise ValueError(f"the trace kernel needs CUDA tensors, got {device}")
    _check_table("bvh8.rows", bvh8.rows, device)
    _check_table("tris", tris, device)
    if fine_rows is not None:
        _check_table("fine_rows", fine_rows, device, torch.int32)
        if fine_rows.shape[0] < tris.shape[0]:
            raise ValueError(f"fine_rows has {fine_rows.shape[0]} rows for "
                             f"{tris.shape[0]} triangle rows")
    _check_depth(bvh8.depth, bvh8.width)


def _check_depth(depth: int, width: int = 8) -> None:
    """Refuse a tree whose walk could overrun the kernels' stack: width *
    depth + 16 entries must fit MAX_STACK."""
    if width not in SNODE_WIDTHS:
        raise ValueError(f"supernode width must be one of {SNODE_WIDTHS}, "
                         f"got {width}")
    if width * depth + 16 > MAX_STACK:
        raise ValueError(f"a width-{width} tree of depth {depth} needs a "
                         f"stack of {width * depth + 16} > {MAX_STACK} "
                         "entries")


def _launch_fn(kernel: str, entry: str, args, tensors, launches=LAUNCHES,
               prefix: str = PROFILER_RANGE):
    """A launch closure: runs `entry` of the kernel library with `args` on
    the current stream and adds one to launches[kernel].  Under a profiler
    the launch lies in a range named prefix + kernel, which the kernel's
    device time is attributed to (a range costs host time on every launch,
    so it is entered only then).  The trace kernels count in LAUNCHES
    under PROFILER_RANGE; the path stages (render/pt/stages.py) pass their
    own."""
    from steeljax_torch.native import cuda_library

    lib = cuda_library()
    fn = getattr(lib, entry)
    device = tensors[0].device
    range_name = prefix + kernel

    def launch():
        # The kernel library's runtime launches into the context current
        # on this thread, which torch.cuda.device makes the tensors' own.
        profiled = torch.autograd._profiler_enabled()
        with (record_function(range_name) if profiled else nullcontext()), \
                torch.cuda.device(device):
            status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if status != 0:
            raise RuntimeError(f"{entry} launch failed: CUDA error {status}")
        launches[kernel] += 1

    # The pointers in `args` stay valid while the launcher holds the
    # tensors they point into, its outputs included (a caller may keep the
    # launcher and drop the record).
    launch.tensors = tensors
    return launch


def _telemetry(n: int, bvh8, tris, per_row: int,
               fine: bool = False) -> dict:
    """The tensors a counting launch writes: "counters" (N, 6) int32, the
    per-ray telemetry named in COUNTERS; "seen_nodes" (S,) uint8, 1 for
    every supernode row some ray popped; "seen_records" (R * per_row,)
    uint8, 1 for every triangle record some ray tested, and with `fine` (the
    alpha kernels) "seen_fine", 1 for every record whose fine mask words
    some ray read.  The seen flags are set by every launch and never
    cleared."""
    rec = _telemetry_sized(n, bvh8.rows.shape[0], tris.shape[0] * per_row,
                           tris.device)
    if fine:
        rec["seen_fine"] = torch.zeros_like(rec["seen_records"])
    return rec


def _telemetry_sized(n: int, nodes: int, records: int, device) -> dict:
    """"counters", "seen_nodes" and "seen_records" of _telemetry for tables
    of `nodes` supernode rows and `records` triangle records."""
    u8 = dict(dtype=torch.uint8, device=device)
    return {"counters": torch.empty((n, len(COUNTERS)), dtype=torch.int32,
                                    device=device),
            "seen_nodes": torch.zeros(nodes, **u8),
            "seen_records": torch.zeros(records, **u8)}


def _ptr(x):
    return None if x is None else x.data_ptr()


def kernel_launcher(bvh8, tris_packed, o, d, t_min, t_max,
                    cull_backface: bool = True, shade_rows=None,
                    shade_mode: int = 0, counters: bool = False,
                    alpha_mask: bool = False, fine_rows=None, records=None):
    """Check the inputs of one nearest-hit kernel call on CUDA tensors and
    allocate its outputs: K1 (shade mode 0 or 1), K3 (shade mode 2) or,
    with alpha_mask, K4, all of csrc/alpha8.cu.  Returns (launch, rec):
    each `launch()` runs the kernel on the current stream into rec's
    tensors (t, u, v, tri (N,) and the shading outputs of
    trace_nearest_bvh8) and adds one to LAUNCHES.  The wrapper calls it
    once; a benchmark can repeat it without the wrapper's host work.
    `records` is hopper_records(tris_packed), derived here when None; K1
    and K3 read the winner's shading from `shade_rows` (pack_shade_records
    of `shade_mode`).  counters=True adds the telemetry of _telemetry."""
    _alpha_tensors({}, alpha_mask, fine_rows, shade_mode)
    _check_shade_rows(shade_rows, shade_mode, tris_packed.shape[0])
    kernel = "K4" if alpha_mask else "K3" if shade_mode == 2 else "K1"
    return _alpha8_launcher(kernel, 0, bvh8, tris_packed, o, d, t_min, t_max,
                            cull_backface, counters=counters,
                            alpha_mask=alpha_mask, fine_rows=fine_rows,
                            records=records,
                            shade_rows=shade_rows if shade_mode else None,
                            shade_mode=shade_mode)


def anyhit_launcher(bvh8, tris, o, d, t_min, t_max, dense: bool = False,
                    counters: bool = False, alpha_mask: bool = False,
                    fine_rows=None, records=None):
    """The any-hit kernel's launcher, csrc/alpha8.cu's ANY policy: K2
    (without masks; with `dense`, K2_dense over pack_tris_dense rows and
    their own supernode rows) or K4_anyhit (alpha_mask), as
    kernel_launcher: rec["hit"] is (N,) bool; `records` is
    hopper_records(tris, dense), derived here when None; counters=True adds
    the telemetry of _telemetry."""
    _alpha_tensors({}, alpha_mask, fine_rows)
    if dense and alpha_mask:
        raise ValueError("the dense any-hit rows carry no alpha masks")
    kernel = ("K4_anyhit" if alpha_mask else "K2_dense" if dense
              else "K2")
    return _alpha8_launcher(kernel, 1, bvh8, tris, o, d, t_min, t_max,
                            False, counters=counters, alpha_mask=alpha_mask,
                            fine_rows=fine_rows, records=records,
                            dense=dense)


def multihit_launcher(bvh8, tris, o, d, t_min, t_max, k_hits: int,
                      cull_backface: bool = True, counters: bool = False,
                      alpha_mask: bool = False, fine_rows=None, records=None):
    """The multi-hit kernel K5's launcher (csrc/alpha8.cu), as
    kernel_launcher: rec holds (K, N) "t", "u", "v" and "tri"; counters=True
    adds the telemetry of _telemetry."""
    _alpha_tensors({}, alpha_mask, fine_rows)
    _check_k(k_hits)
    return _alpha8_launcher("K5", 2, bvh8, tris, o, d, t_min, t_max,
                            cull_backface, k_hits=k_hits, counters=counters,
                            alpha_mask=alpha_mask, fine_rows=fine_rows,
                            records=records)


def _alpha8_launcher(kernel: str, mode: int, bvh8, tris, o, d, t_min, t_max,
                     cull_backface: bool, k_hits: int = 1,
                     counters: bool = False, alpha_mask: bool = True,
                     fine_rows=None, records=None, shade_rows=None,
                     shade_mode: int = 0, dense: bool = False):
    """One call of csrc/alpha8.cu's entry, for the public launchers, which
    choose the kernel; the walk reads supernode rows of bvh8.width (8 or
    16) children: `mode` 0 nearest (rec t, u, v, tri (N,) and the
    shading outputs of `shade_mode`), 1 any-hit (rec["hit"] (N,) bool, no
    culling), 2 multi-hit ((k_hits, N) slots).  With alpha_mask the coarse
    masks apply and `fine_rows` adds the fine planes.  `tris` holds
    TRI_PER_ROW records a row, or with `dense` (any-hit without masks)
    DENSE_PER_ROW, and `records` one Hopper record for each of them.
    counters=True adds the telemetry of _telemetry, seen_fine included."""
    _check_depth(bvh8.depth, bvh8.width)
    per_row = DENSE_PER_ROW if dense else TRI_PER_ROW
    n_records = tris.shape[0] * per_row
    if records is not None:
        _check_records(records, n_records)
    device = o.device
    _check_launch(bvh8, tris, device, fine_rows)
    if shade_mode:
        _check_table("shade_rows", shade_rows, device)
    if records is None:
        records = hopper_records(tris, dense)
    _check_records(records, n_records, device)
    o, d, tmn, tmx = _rays_and_interval(o, d, t_min, t_max, device)
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    if mode == 1:
        rec = {"hit": torch.empty(n, dtype=torch.bool, device=device)}
    else:
        shape = (k_hits, n) if mode == 2 else (n,)
        rec = {"t": torch.empty(shape, **f32), "u": torch.empty(shape, **f32),
               "v": torch.empty(shape, **f32),
               "tri": torch.empty(shape, dtype=torch.int32, device=device)}
    if shade_mode:
        rec["n"] = torch.empty((n, 3), **f32)
        rec["mat"] = torch.empty(n, dtype=torch.int32, device=device)
    if shade_mode == 2:
        rec["tan"] = torch.empty((n, 3), **f32)
        rec["uv"] = torch.empty((n, 2), **f32)
        rec["uvd"] = torch.empty(n, **f32)
    if counters:
        rec.update(_telemetry(n, bvh8, tris, per_row, fine=True))

    def ptr(name):
        return rec[name].data_ptr() if name in rec else None

    args = (bvh8.rows.data_ptr(), records.data_ptr(), _ptr(fine_rows),
            _ptr(shade_rows), o.data_ptr(), d.data_ptr(), tmn.data_ptr(),
            tmx.data_ptr(), ptr("t"), ptr("u"), ptr("v"), ptr("tri"),
            ptr("n"), ptr("mat"), ptr("tan"), ptr("uv"), ptr("uvd"),
            ptr("hit"), ptr("counters"), ptr("seen_nodes"),
            ptr("seen_records"), ptr("seen_fine"), n, bvh8.max_leaf,
            bvh8.depth, int(bool(cull_backface)), mode, k_hits,
            int(bool(alpha_mask)), shade_mode, per_row, bvh8.width)
    return _launch_fn(kernel, "steeljax_trace_alpha8", args,
                      (bvh8.rows, records, tris, fine_rows, shade_rows, o, d,
                       tmn, tmx, *rec.values())), rec


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


class _Masks:
    """The alpha kernels' record flags: the double-sided flag (AUX bit 0
    with masks, else the float flag), the coarse masks and the fine words
    of every record."""

    def __init__(self, rec_all, alpha_mask: bool, fine_rows):
        if alpha_mask:
            aux = rec_all[:, 9].to(torch.int32)
            self.ds = (aux & 1) == 1
            self.coarse = (aux >> 1)[None, :]
        else:
            self.ds = rec_all[:, 9] > 0.5
            self.coarse = None
        self.fine = (None if fine_rows is None else
                     fine_rows[:, :TRI_PER_ROW * alphamask.FINE_STRIDE]
                     .reshape(-1, alphamask.FINE_STRIDE)[None])

    def facing(self, det, det_ok, cull: bool):
        if cull:
            return (det > DET_EPS) | (self.ds & det_ok)
        return det_ok

    def keep(self, u, v):
        """(keep, opaque) of every candidate: keep is false where a mask
        rejects it, opaque (None without fine words) where the OPAQUE
        plane proves it kept."""
        keep = torch.ones_like(u, dtype=torch.bool)
        opaque = None
        if self.coarse is not None:
            keep = keep & alphamask.mask_test(self.coarse, u, v)
        if self.fine is not None:
            fine_keep, opaque = alphamask.fine_mask_test(self.fine, u, v)
            keep = keep & fine_keep
        return keep, opaque


def _chunk_rays(k: int, alpha_mask: bool, device: torch.device) -> int:
    """Rays per chunk of a plain version over k records on `device`."""
    temporaries = 40 if alpha_mask else 24
    return max(1, _PLAIN_CHUNK_BYTES[device.type]
               // (max(k, 1) * 4 * temporaries))


def trace_nearest_bvh8_plain(bvh8: BVH8, tris_packed: torch.Tensor,
                             o: torch.Tensor, d: torch.Tensor, t_min, t_max,
                             cull_backface: bool = True,
                             shade_rows: torch.Tensor | None = None,
                             shade_mode: int = 0, alpha_mask: bool = False,
                             fine_rows: torch.Tensor | None = None) -> dict:
    """Plain version of the nearest-hit kernels K1, K3 and K4, same
    signature and outputs.

    Brute force: every packed record is tested against every ray with the
    kernel's per-candidate arithmetic and mask tests, in ray chunks; the
    nearest accepted candidate wins.  Pad records (3e37 positions, or
    all-zero lanes) fail the determinant test on their own, so the BVH is
    not needed.  It differs from the kernel only on exact-t ties (which
    candidate wins), on grazing box-boundary rays and on candidates whose
    last-bit u or v falls on a mask cell boundary, the cases
    kernel_parity._compare budgets."""
    _alpha_tensors({}, alpha_mask, fine_rows, shade_mode)
    _check_shade_rows(shade_rows, shade_mode, tris_packed.shape[0])
    device = o.device
    o, d, tmn, tmx = _rays_and_interval(o, d, t_min, t_max, device)
    n = o.shape[0]
    v0, e1, e2, rec_all = _records(tris_packed, TRI_PER_ROW, TRI_STRIDE)
    k = rec_all.shape[0]
    masks = _Masks(rec_all, alpha_mask, fine_rows)

    out_t = torch.empty(n, dtype=torch.float32, device=device)
    out_u = torch.empty_like(out_t)
    out_v = torch.empty_like(out_t)
    out_tri = torch.empty(n, dtype=torch.int32, device=device)
    out_det = torch.empty_like(out_t)
    chunk = _chunk_rays(k, alpha_mask, device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        det, det_ok, u, v, t, inside = _candidates(
            v0, e1, e2, o[s:e], d[s:e], tmn[s:e], tmx[s:e])
        hit = masks.facing(det, det_ok, cull_backface) & inside
        if alpha_mask:
            hit = hit & masks.keep(u, v)[0]
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


def rotate(m, vec):
    """Row-major 3x3 matrices m (N, 9) applied to vec (N, 3), in the
    kernel's order of sums."""
    return torch.stack([m[:, 3 * r] * vec[:, 0] + m[:, 3 * r + 1] * vec[:, 1]
                        + m[:, 3 * r + 2] * vec[:, 2] for r in range(3)],
                       dim=-1)


def _shade_plain(shade_rows, shade_mode, tri, u, v, det, inst=None) -> dict:
    """The nearest kernels' epilogue: interpolate the winner's normal at
    (u, v), normalize, flip when det < 0; misses get n = +z and mat 0.  Mode
    2 adds the tangent (normalized, not flipped; +x on a miss), the uv and
    the uv density (0 on a miss).  `inst` ((N, 48), the winners' inst_trace
    rows, K6) rotates the interpolated object-space normal by the normal
    matrix and the tangent by the world linear matrix before they are
    normalized, takes the material id from the row and scales the uv
    density by the row's 1 / scale."""
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

    nrm = interp(slice(0, 3), slice(3, 6), slice(6, 9))
    mat = s[:, 9:10]
    if inst is not None:
        nrm = rotate(inst[:, 16:25], nrm)
        mat = inst[:, 14:15]
    nrm = on_hit(nrm, one_at=2)
    n2 = (nrm * nrm).sum(dim=-1)
    sgn = torch.where(det < 0.0, -1.0, 1.0)
    inv_n = sgn * torch.rsqrt(torch.clamp(n2, min=1e-20))
    out = {"n": nrm * inv_n[:, None],
           "mat": on_hit(mat)[:, 0].to(torch.int32)}
    if shade_mode == 2:
        tan = interp(slice(10, 13), slice(13, 16), slice(16, 19))
        uvd = s[:, 25:26]
        if inst is not None:
            tan = rotate(inst[:, 25:34], tan)
            uvd = uvd * inst[:, 15:16]
        tan = on_hit(tan, one_at=0)
        t2 = (tan * tan).sum(dim=-1)
        out["tan"] = tan * torch.rsqrt(torch.clamp(t2, min=1e-20))[:, None]
        out["uv"] = on_hit(interp(slice(19, 21), slice(21, 23),
                                  slice(23, 25)))
        out["uvd"] = on_hit(uvd)[:, 0]
    return out


def trace_any_bvh8_plain(bvh8: BVH8, tris: torch.Tensor, o: torch.Tensor,
                         d: torch.Tensor, t_min, t_max, dense: bool = False,
                         alpha_mask: bool = False,
                         fine_rows: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Plain version of the any-hit kernels K2 and K4_anyhit, same
    signature and output.

    Brute force, like trace_nearest_bvh8_plain: a ray is occluded when any
    record passes |det| > 1e-12, u >= 0, v >= 0, u + v <= 1, t_min <= t
    <= t_max and its masks, with no culling; a dead ray passes no t test.
    `dense` reads the 9-float records of pack_tris_dense."""
    _alpha_tensors({}, alpha_mask, fine_rows)
    device = o.device
    o, d, tmn, tmx = _rays_and_interval(o, d, t_min, t_max, device)
    n = o.shape[0]
    per_row, stride = ((DENSE_PER_ROW, DENSE_STRIDE) if dense
                       else (TRI_PER_ROW, TRI_STRIDE))
    v0, e1, e2, rec_all = _records(tris, per_row, stride)
    k = rec_all.shape[0]
    masks = _Masks(rec_all, alpha_mask, fine_rows) if alpha_mask else None
    out = torch.empty(n, dtype=torch.bool, device=device)
    chunk = _chunk_rays(k, alpha_mask, device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        _, det_ok, u, v, _, inside = _candidates(
            v0, e1, e2, o[s:e], d[s:e], tmn[s:e], tmx[s:e])
        hit = det_ok & inside
        if masks is not None:
            hit = hit & masks.keep(u, v)[0]
        out[s:e] = hit.any(dim=1)
    return out


def trace_multihit_bvh8_plain(bvh8: BVH8, tris: torch.Tensor,
                              o: torch.Tensor, d: torch.Tensor, t_min, t_max,
                              k_hits: int, cull_backface: bool = True,
                              alpha_mask: bool = False,
                              fine_rows: torch.Tensor | None = None) -> dict:
    """Plain version of the multi-hit kernel K5, same signature and
    outputs, by brute force: every accepted candidate with t in [t_min,
    t_max), the k_hits smallest t in ascending order; with fine rows the
    opaque bound ob = min(t_max, the smallest t of an OPAQUE-plane hit),
    and only slots with t <= ob are kept (the reference's oracle,
    steeljax/apps/kernel_parity.py:62-146).  Slots of equal t may come in
    another order than the kernel's walk finds them."""
    _check_k(k_hits)
    _alpha_tensors({}, alpha_mask, fine_rows)
    device = o.device
    o, d, tmn, tmx = _rays_and_interval(o, d, t_min, t_max, device)
    n = o.shape[0]
    v0, e1, e2, rec_all = _records(tris, TRI_PER_ROW, TRI_STRIDE)
    k = rec_all.shape[0]
    masks = _Masks(rec_all, alpha_mask, fine_rows)
    take = min(k_hits, k)
    f32 = dict(dtype=torch.float32, device=device)
    out = {"t": torch.full((k_hits, n), -1.0, **f32),
           "u": torch.zeros((k_hits, n), **f32),
           "v": torch.zeros((k_hits, n), **f32),
           "tri": torch.full((k_hits, n), -1, dtype=torch.int32,
                             device=device)}
    inf = torch.full((n,), float("inf"), **f32)
    chunk = _chunk_rays(k, True, device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        det, det_ok, u, v, t, inside = _candidates(
            v0, e1, e2, o[s:e], d[s:e], tmn[s:e], inf[s:e])
        hit = masks.facing(det, det_ok, cull_backface) & inside
        keep, opaque = masks.keep(u, v)
        hit = hit & keep
        bound = tmx[s:e]
        if opaque is not None:
            t_opq = torch.where(hit & opaque, t, torch.full_like(t, np.inf))
            bound = torch.minimum(bound, t_opq.min(dim=1).values)
        t_acc = torch.where(hit & (t < tmx[s:e, None]), t,
                            torch.full_like(t, np.inf))
        best_t, best = torch.topk(t_acc, take, dim=1, largest=False,
                                  sorted=True)
        found = torch.isfinite(best_t)
        if opaque is not None:
            found = found & (best_t <= bound[:, None])
        out["t"][:take, s:e] = torch.where(found, best_t, -1.0).T
        out["u"][:take, s:e] = torch.where(found, u.gather(1, best),
                                           0.0).T
        out["v"][:take, s:e] = torch.where(found, v.gather(1, best),
                                           0.0).T
        out["tri"][:take, s:e] = torch.where(found, best, -1).to(
            torch.int32).T
    return out


# ---------------------------------------------------------------------------
# K6: the two-level query over instanced tables (accel.instances)
# ---------------------------------------------------------------------------

def _inst_tensors(tables, any_hit: bool) -> tuple[dict, int]:
    """The tensors one two-level trace reads, by name, and its shade mode
    (occlusion queries skip the fused shading)."""
    mode = 0 if any_hit else tables.shade_mode
    tensors = {"snode_rows": tables.snode_rows,
               "tris_packed": tables.tris_packed,
               "tri_records": tables.tri_records,
               "inst_trace": tables.inst_trace}
    _check_shade_rows(tables.shade_rows, mode, tables.tris_packed.shape[0])
    if mode:
        tensors["shade_rows"] = tables.shade_rows
    return tensors, mode


def trace_nearest_bvh8_inst(tables, o: torch.Tensor, d: torch.Tensor,
                            t_min, t_max, cull_backface: bool = True,
                            any_hit: bool = False) -> dict:
    """Nearest hit of each ray over instances.InstancedTables (K6); the
    contract of the reference's trace_nearest_packet8_inst
    (pallas_traverse.py:1788-1801).

    Returns the record of trace_nearest_bvh8 plus "inst" (N,) int32, the
    instance hit (-1 on a miss): t is the world ray parameter, tri indexes
    the pooled BLAS records, u and v are the object-space barycentrics (an
    affine map keeps them), and in the tables' shade mode 1 or 2 n is the
    world normal (the interpolated object-space normal times the
    instance's normal matrix, normalized, flipped where the object-space
    det < 0), mat the instance's material id, and in mode 2 tan the
    world tangent (times the world linear matrix, normalized), uv, and uvd
    the uv density times the instance's 1 / scale.  Facing is decided by
    object-space winding; a triangle is double-sided when its record or
    its instance says so.  With any_hit the record holds only "hit": (N,)
    bool, true when any triangle of any instance is hit (no culling) with
    t in [t_min, t_max]; a dead ray is never occluded."""
    tensors, _ = _inst_tensors(tables, any_hit)
    tensors.update(o=o, d=d)
    device = _one_device(tensors, t_min, t_max)
    if device.type == "cuda":
        launch, rec = inst_launcher(tables, o, d, t_min, t_max,
                                    cull_backface, any_hit)
        launch()
        if not any_hit:
            rec["hit"] = rec["tri"] >= 0
        return rec
    return trace_nearest_bvh8_inst_plain(tables, o, d, t_min, t_max,
                                         cull_backface, any_hit)


def _check_records(records, n_records: int, device=None) -> None:
    """A Hopper record table (hopper_records) of `n_records` records, one
    for each record of the rows it was derived from, and, unless `device`
    is None, contiguous on `device` and 16-byte aligned (the kernels read
    it as float4s)."""
    if (records is None or records.dtype != torch.float32
            or records.dim() != 2 or records.shape[1] != HOPPER_RECORD
            or records.shape[0] != n_records):
        raise ValueError(f"records must be ({n_records}, "
                         f"{HOPPER_RECORD}) float32 (hopper_records), got "
                         + ("None" if records is None else
                            f"{tuple(records.shape)} {records.dtype}"))
    if device is not None and (records.device != device
                               or not records.is_contiguous()
                               or records.data_ptr() % 16):
        raise ValueError(f"records must be contiguous and 16-byte aligned "
                         f"on {device}")


def inst_launcher(tables, o, d, t_min, t_max, cull_backface: bool = True,
                  any_hit: bool = False, counters: bool = False):
    """The two-level kernel K6's launcher, as kernel_launcher.  rec holds
    t, u, v, tri, inst and the shading outputs of the tables' mode, or with
    any_hit only "hit".  counters=True adds "counters" (N, 6) int32, the
    per-ray telemetry named in INST_COUNTERS, and the flags "seen_nodes"
    (S,), "seen_records" (R * 12,) and "seen_inst" (I,) of the supernode
    rows popped, the records tested and the instances entered.  The kernel
    reads the pool's Hopper records (tables.tri_records) and the instance
    rows as float4s."""
    device = o.device
    tensors, mode = _inst_tensors(tables, any_hit)
    if device.type != "cuda":
        raise ValueError(f"the trace kernel needs CUDA tensors, got {device}")
    for name in ("snode_rows", "tris_packed", "shade_rows"):
        if name in tensors:
            _check_table(name, tensors[name], device)
    inst = tables.inst_trace
    if (inst.dtype != torch.float32 or inst.dim() != 2
            or inst.shape[1] != INST_COLS or inst.device != device
            or not inst.is_contiguous() or inst.data_ptr() % 16):
        raise ValueError(f"inst_trace must be contiguous (I, {INST_COLS}) "
                         f"float32 on {device}, 16-byte aligned, got "
                         f"{tuple(inst.shape)} {inst.dtype} on {inst.device}")
    rows = tables.tris_packed.shape[0]
    _check_records(tables.tri_records, rows * TRI_PER_ROW, device)
    if not 1 <= tables.n_tlas <= tables.snode_rows.shape[0]:
        raise ValueError(f"n_tlas {tables.n_tlas} outside the "
                         f"{tables.snode_rows.shape[0]} supernode rows")
    if 8 * tables.depth + 32 > MAX_STACK:
        raise ValueError(f"two-level depth {tables.depth} needs a stack of "
                         f"{8 * tables.depth + 32} > {MAX_STACK} entries")
    o, d, tmn, tmx = _rays_and_interval(o, d, t_min, t_max, device)
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    if any_hit:
        rec = {"hit": torch.empty(n, dtype=torch.bool, device=device)}
    else:
        rec = {"t": torch.empty(n, **f32), "u": torch.empty(n, **f32),
               "v": torch.empty(n, **f32), "tri": torch.empty(n, **i32),
               "inst": torch.empty(n, **i32)}
    if mode:
        rec["n"] = torch.empty((n, 3), **f32)
        rec["mat"] = torch.empty(n, **i32)
    if mode == 2:
        rec["tan"] = torch.empty((n, 3), **f32)
        rec["uv"] = torch.empty((n, 2), **f32)
        rec["uvd"] = torch.empty(n, **f32)
    if counters:
        rec.update(_telemetry_sized(n, tables.snode_rows.shape[0],
                                    rows * TRI_PER_ROW, device))
        rec["seen_inst"] = torch.zeros(inst.shape[0], dtype=torch.uint8,
                                       device=device)

    def ptr(name):
        return rec[name].data_ptr() if name in rec else None

    args = (tables.snode_rows.data_ptr(), tables.tri_records.data_ptr(),
            inst.data_ptr(), _ptr(tables.shade_rows if mode else None),
            o.data_ptr(), d.data_ptr(), tmn.data_ptr(), tmx.data_ptr(),
            ptr("t"), ptr("u"), ptr("v"), ptr("tri"), ptr("inst"), ptr("n"),
            ptr("mat"), ptr("tan"), ptr("uv"), ptr("uvd"), ptr("hit"),
            ptr("counters"), ptr("seen_nodes"), ptr("seen_records"),
            ptr("seen_inst"), n, int(tables.n_tlas), inst.shape[0],
            tables.max_leaf, tables.depth, int(bool(cull_backface)), mode,
            int(bool(any_hit)))
    return _launch_fn("K6_anyhit" if any_hit else "K6",
                      "steeljax_trace_inst8", args,
                      (*tensors.values(), o, d, tmn, tmx,
                       *rec.values())), rec


def trace_nearest_bvh8_inst_plain(tables, o: torch.Tensor, d: torch.Tensor,
                                  t_min, t_max, cull_backface: bool = True,
                                  any_hit: bool = False) -> dict:
    """Plain version of the two-level kernel K6, same signature and
    outputs.

    Brute force over the instances in turn: the ray is moved into the
    instance's object space with the kernel's arithmetic (the inverse 3x4
    of inst_trace, direction not renormalized, so t stays the world
    parameter), tested against every record of the instance's BLAS with
    the per-candidate arithmetic of the flat kernels, and the interval
    shrinks to the best t so far before the next instance.  It differs
    from the kernel as trace_nearest_bvh8_plain does from K1."""
    _, mode = _inst_tensors(tables, any_hit)
    device = o.device
    o, d, tmn, tmx = _rays_and_interval(o, d, t_min, t_max, device)
    n = o.shape[0]
    pool = tables.tris_packed[:, :TRI_PER_ROW * TRI_STRIDE].reshape(
        -1, TRI_STRIDE)
    bounds = list(tables.blas_tri_offset) + [pool.shape[0]]
    f32 = dict(dtype=torch.float32, device=device)
    best_t = tmx.clone()
    best_u = torch.zeros(n, **f32)
    best_v = torch.zeros(n, **f32)
    best_det = torch.ones(n, **f32)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=device)
    best_inst = torch.full((n,), -1, dtype=torch.int32, device=device)
    occluded = torch.zeros(n, dtype=torch.bool, device=device)
    ox, oy, oz = o.unbind(dim=1)
    dx, dy, dz = d.unbind(dim=1)
    for i, blas in enumerate(tables.inst_blas):
        row = tables.inst_trace[i]
        first = bounds[blas]
        rec = pool[first:bounds[blas + 1]]
        v0 = [rec[:, c] for c in range(0, 3)]
        e1 = [rec[:, c] for c in range(3, 6)]
        e2 = [rec[:, c] for c in range(6, 9)]
        o2 = torch.stack([row[4 * r] * ox + row[4 * r + 1] * oy
                          + row[4 * r + 2] * oz + row[4 * r + 3]
                          for r in range(3)], dim=1)
        d2 = torch.stack([row[4 * r] * dx + row[4 * r + 1] * dy
                          + row[4 * r + 2] * dz for r in range(3)], dim=1)
        double_sided = (rec[:, 9] > 0.5) | (row[13] > 0.5)
        chunk = _chunk_rays(rec.shape[0], False, device)
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            det, det_ok, u, v, t, inside = _candidates(
                v0, e1, e2, o2[s:e], d2[s:e], tmn[s:e],
                tmx[s:e] if any_hit else best_t[s:e])
            if any_hit:
                occluded[s:e] |= (det_ok & inside).any(dim=1)
                continue
            facing = ((det > DET_EPS) | (double_sided & det_ok)
                      if cull_backface else det_ok)
            t_acc = torch.where(facing & inside, t,
                                torch.full_like(t, float("inf")))
            found_t, pick = t_acc.min(dim=1)
            found = torch.isfinite(found_t)
            col = pick[:, None]

            def take(new, old):
                return torch.where(found, new, old)

            best_t[s:e] = take(found_t, best_t[s:e])
            best_u[s:e] = take(u.gather(1, col)[:, 0], best_u[s:e])
            best_v[s:e] = take(v.gather(1, col)[:, 0], best_v[s:e])
            best_det[s:e] = take(det.gather(1, col)[:, 0], best_det[s:e])
            best_tri[s:e] = take((pick + first).to(torch.int32),
                                 best_tri[s:e])
            best_inst[s:e] = take(torch.full_like(best_inst[s:e], i),
                                  best_inst[s:e])
    if any_hit:
        return {"hit": occluded}
    hit = best_tri >= 0
    out = {"t": torch.where(hit, best_t, -1.0), "tri": best_tri,
           "u": best_u, "v": best_v, "hit": hit, "inst": best_inst}
    if mode:
        rows = tables.inst_trace[best_inst.clamp(min=0).long()]
        out.update(_shade_plain(tables.shade_rows, mode, best_tri, best_u,
                                best_v, best_det, inst=rows))
    return out


# ---------------------------------------------------------------------------
# K7: the rounds of the treelet scheduler (accel.treelets)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TreeletState:
    """One treelet trace's scheduler state, which its rounds update in
    place (csrc/treelet8.cu): the padded rays o, d (N, 3) and t_min (N,);
    t_far (N,), each ray's running interval end; entry (N, K), the treelet
    entry distances (treelets._entry_distances); visited (N, ceil(K / 32))
    int32 words; keys (3, P) int64, the packets' pick keys (round r reads
    keys[r % 3], fills keys[(r + 1) % 3] and resets keys[(r + 2) % 3]); rec,
    the running record (t, tri with global ids, u, v and the fused shading
    fields of the tables' mode, or "hit"); `block` rays per packet."""
    o: torch.Tensor
    d: torch.Tensor
    t_min: torch.Tensor
    t_far: torch.Tensor
    entry: torch.Tensor
    visited: torch.Tensor
    keys: torch.Tensor
    rec: dict
    block: int

    @property
    def ray_bits(self) -> int:
        return ray_bits(self.block)


def ray_bits(block: int) -> int:
    """Bits of a pick key's packet-local ray index for packets of `block`
    rays; the treelet field has the 32 - ray_bits bits below them."""
    return max(1, (block - 1).bit_length())


def pick_keys_plain(entry: torch.Tensor, visited: torch.Tensor,
                    t_far: torch.Tensor, block: int) -> torch.Tensor:
    """Plain version of the packet pick of csrc/treelet8.cu: (P,) int64, the
    least key of each packet of `block` rays.  A ray's key packs its masked
    nearest entry (not visited, entry < t_far) as an int that orders as the
    float (the bits of a non-negative value; of a negative one, with the
    magnitude bits flipped; -0 as +0) in the high 32 bits, then its index in
    the packet and that entry's treelet (the first on ties; K when no entry
    is left), so the least key is _next_pid's pick: the packet-wide nearest
    entry, the first ray on ties."""
    n, k = entry.shape
    j = torch.arange(k, device=entry.device)
    seen = ((visited[:, j // 32] >> (j % 32).to(torch.int32)) & 1) == 1
    keep = ~seen & (entry < t_far[:, None])
    best, desired = torch.where(keep, entry, float("inf")).min(dim=1)
    desired = torch.where(torch.isfinite(best), desired, k)
    bits = torch.where(best == 0.0, 0.0, best).view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    local = torch.arange(n, device=entry.device) % block
    low = (local << (32 - ray_bits(block))) | desired
    return (bits * (1 << 32) + low).view(-1, block).min(dim=1).values


def key_treelets(keys: torch.Tensor, block: int, k: int) -> torch.Tensor:
    """The treelet of each packet's pick key: (P,) int32 in [0, K], K for a
    finished packet (or an empty key)."""
    mask = (1 << (32 - ray_bits(block))) - 1
    return torch.clamp(keys & mask, max=k).to(torch.int32)


def _treelet_tables(tt, any_hit: bool) -> tuple[dict, int]:
    """The tables one treelet round reads, by name, and its shade mode."""
    mode = 0 if any_hit else tt.shade_mode
    if mode not in (0, 1, 2):
        raise ValueError(f"shade_mode must be 0, 1 or 2, got {mode}")
    if tt.alpha_mask and mode:
        raise ValueError("the alpha-masked kernels have no fused shading "
                         f"(shade_mode {mode})")
    tensors = {"node_stack": tt.node_stack, "tri_records": tt.tri_records,
               "tri_offsets": tt.tri_offsets}
    if mode:
        if tt.shade_stack is None:
            raise ValueError(f"shade_mode {mode} needs a shade stack")
        tensors["shade_stack"] = tt.shade_stack
    return tensors, mode


def _state_tensors(state: TreeletState) -> dict:
    return {"o": state.o, "d": state.d, "t_min": state.t_min,
            "t_far": state.t_far, "entry": state.entry,
            "visited": state.visited, "keys": state.keys,
            **{f"rec.{k}": v for k, v in state.rec.items()}}


def _check_state(tt, state: TreeletState, any_hit: bool) -> None:
    """The state's shapes against the tables and the query."""
    n, k = state.t_far.shape[0], tt.count
    block = state.block
    if block <= 0 or n % block:
        raise ValueError(f"{n} rays are not whole packets of {block}")
    if k >= (1 << (32 - state.ray_bits)) - 1:
        raise ValueError(f"{k} treelets do not fit the pick key's treelet "
                         f"field at {block} rays per packet")
    f32, i32 = torch.float32, torch.int32
    shapes = {"o": ((n, 3), f32), "d": ((n, 3), f32), "t_min": ((n,), f32),
              "t_far": ((n,), f32), "entry": ((n, k), f32),
              "visited": ((n, -(-k // 32)), i32),
              "keys": ((3, n // block), torch.int64)}
    for name, (shape, dtype) in shapes.items():
        x = getattr(state, name)
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"state.{name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if tt.tri_offsets.dtype != i32 or tuple(tt.tri_offsets.shape) != (k,):
        raise ValueError(f"tri_offsets must be ({k},) int32")
    want = ["hit"] if any_hit else ["t", "tri", "u", "v"]
    if any_hit != ("hit" in state.rec) or any(w not in state.rec
                                              for w in want):
        kind = "an any-hit" if any_hit else "a nearest"
        raise ValueError(f"state.rec holds {sorted(state.rec)}, not the "
                         f"record of {kind} trace")


def trace_treelet_round(tt, state: TreeletState, r: int,
                        cull_backface: bool = True,
                        any_hit: bool = False) -> None:
    """Round r of the treelet scheduler (K7), in place: every packet of
    state.block rays whose key in state.keys[r % 3] names a treelet is
    traced against that treelet of treelets.TreeletTables `tt` alone (the
    contract of the reference's _trace_packed8_treelet,
    pallas_traverse.py:1149-1249), and the scheduler's step
    (steeljax/accel/treelets.py:268-305) follows for each of its rays: a hit
    strictly nearer than the ray's t_far (or its first hit) writes the
    record (global triangle id, fused shading of tt.shade_mode; with
    any_hit the occlusion flag, no culling, and the interval dies) and
    t_far; the treelet becomes visited; and the packet's next key goes to
    state.keys[(r + 1) % 3] (which holds EMPTY_KEY), while state.keys[(r +
    2) % 3] is reset.  A finished packet's rays are not touched.  The
    tables' coarse alpha masks apply when tt.alpha_mask."""
    tensors, _ = _treelet_tables(tt, any_hit)
    tensors.update(_state_tensors(state))
    device = _one_device(tensors, None, None)
    if device.type == "cuda":
        treelet_launcher(tt, state, r, cull_backface, any_hit)[0]()
        return
    trace_treelet_round_plain(tt, state, r, cull_backface, any_hit)


def treelet_pick(tt, state: TreeletState) -> None:
    """The first pick of a treelet trace: state.keys[0] (all EMPTY_KEY)
    takes each packet's least key (pick_keys_plain) over its rays' entry
    rows, visited words and t_far.  Launches the pick kernel of
    csrc/treelet8.cu (LAUNCHES["K7_pick"]) for CUDA tensors, runs
    pick_keys_plain for CPU tensors."""
    tensors = {"entry": state.entry, "t_far": state.t_far,
               "visited": state.visited, "keys": state.keys}
    device = _one_device(tensors, None, None)
    if device.type == "cuda":
        treelet_pick_launcher(tt, state)()
        return
    state.keys[0] = torch.minimum(state.keys[0], pick_keys_plain(
        state.entry, state.visited, state.t_far, state.block))


def _check_treelet_launch(tt, state, tensors: dict, any_hit: bool) -> None:
    device = state.t_far.device
    if device.type != "cuda":
        raise ValueError(f"the trace kernel needs CUDA tensors, got {device}")
    if state.block % 32:
        raise ValueError(f"packets of {state.block} rays: the kernel needs "
                         "a multiple of 32")
    for name, x in tensors.items():
        if x is None or x.device != device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")
    _check_state(tt, state, any_hit)


def treelet_launcher(tt, state: TreeletState, r: int,
                     cull_backface: bool = True, any_hit: bool = False,
                     telemetry: dict | None = None):
    """The launch closure of round r of the treelet kernel K7 (as
    kernel_launcher's; `rec` is state.rec, updated in place by every
    launch).  `telemetry` (treelet_telemetry) makes it a counting launch
    that adds to its per-ray counters and sets its flags over the stacked
    tables."""
    tensors, mode = _treelet_tables(tt, any_hit)
    state_tensors = _state_tensors(state)
    _check_treelet_launch(tt, state, {**tensors, **state_tensors}, any_hit)
    k, node_rows = tt.node_stack.shape[:2]
    tri_rows = tt.tri_stack.shape[1]
    for name, x, rows in (("node_stack", tt.node_stack, node_rows),
                          ("tri_stack", tt.tri_stack, tri_rows),
                          ("shade_stack", tt.shade_stack if mode else None,
                           tri_rows * (1 if mode == 1 else 3))):
        if x is not None and (x.dtype != torch.float32
                              or tuple(x.shape) != (k, rows, LANES)):
            raise ValueError(f"{name} must be ({k}, {rows}, {LANES}) "
                             f"float32, got {tuple(x.shape)} {x.dtype}")
    _check_records(tt.tri_records, k * tri_rows * TRI_PER_ROW,
                   state.t_far.device)
    if 8 * tt.depth + 16 > MAX_STACK:
        raise ValueError(f"treelet depth {tt.depth} needs a stack of "
                         f"{8 * tt.depth + 16} > {MAX_STACK} entries")
    rec, keys = state.rec, state.keys
    tel = telemetry or {}

    def ptr(x):
        return None if x is None else x.data_ptr()

    args = (tt.node_stack.data_ptr(), tt.tri_records.data_ptr(),
            ptr(tt.shade_stack if mode else None), tt.tri_offsets.data_ptr(),
            state.entry.data_ptr(), state.o.data_ptr(), state.d.data_ptr(),
            state.t_min.data_ptr(), state.t_far.data_ptr(),
            state.visited.data_ptr(), keys[r % 3].data_ptr(),
            keys[(r + 1) % 3].data_ptr(), keys[(r + 2) % 3].data_ptr(),
            *(ptr(rec.get(name)) for name in (
                "t", "u", "v", "tri", "n", "mat", "tan", "uv", "uvd", "hit")),
            ptr(tel.get("counters")), ptr(tel.get("seen_nodes")),
            ptr(tel.get("seen_records")), state.t_far.shape[0], state.block,
            state.ray_bits, k, node_rows, tri_rows, tt.max_leaf, tt.depth,
            int(bool(cull_backface)), mode, int(bool(tt.alpha_mask)),
            int(bool(any_hit)))
    return _launch_fn("K7_anyhit" if any_hit else "K7",
                      "steeljax_treelet_round8", args,
                      (*tensors.values(), *state_tensors.values(),
                       *tel.values())), rec


def treelet_pick_launcher(tt, state: TreeletState):
    """The launch closure of the first pick of a treelet trace (treelet_pick)
    into state.keys[0]; each launch adds one to LAUNCHES["K7_pick"]."""
    tensors = {"entry": state.entry, "t_far": state.t_far,
               "visited": state.visited, "keys": state.keys}
    _check_treelet_launch(tt, state, tensors, "hit" in state.rec)
    args = (state.entry.data_ptr(), state.t_far.data_ptr(),
            state.visited.data_ptr(), state.keys[0].data_ptr(),
            state.t_far.shape[0], state.block, state.ray_bits, tt.count)
    return _launch_fn("K7_pick", "steeljax_treelet_pick8", args,
                      tuple(tensors.values()))


def treelet_telemetry(tt, state: TreeletState) -> dict:
    """Zeroed telemetry of a counting treelet trace (treelet_launcher's
    `telemetry`): "counters" (N, 6) int32, summed over the rounds (COUNTERS),
    and the flags "seen_nodes" (K * S,) and "seen_records" (K * R * 12,)
    over the stacked tables."""
    k, node_rows = tt.node_stack.shape[:2]
    rec = _telemetry_sized(state.t_far.shape[0], k * node_rows,
                           k * tt.tri_stack.shape[1] * TRI_PER_ROW,
                           state.t_far.device)
    rec["counters"].zero_()
    return rec


def trace_treelet_round_plain(tt, state: TreeletState, r: int,
                              cull_backface: bool = True,
                              any_hit: bool = False, walk=None) -> None:
    """Plain version of trace_treelet_round, same contract: the reference
    scheduler's step (steeljax/accel/treelets.py:268-305) in place.  The
    packets' walks are treelet_walk_plain, or `walk(pid, o, d, t_min,
    t_max)` (the trace_fn of treelets.trace_treelets), called on every
    packet with pid clamped to K - 1 and a finished packet's rays given the
    dead interval, as the reference launches them."""
    k, block, rec = tt.count, state.block, state.rec
    state.keys[(r + 2) % 3] = EMPTY_KEY
    pid = key_treelets(state.keys[r % 3], block, k)
    done = (pid >= k).repeat_interleave(block)
    pid_safe = pid.clamp(max=k - 1)
    if walk is None:
        def walk(pid, o, d, t_min, t_max):
            return treelet_walk_plain(tt, pid, o, d, t_min, t_max, block,
                                      cull_backface, any_hit)
    rk = walk(pid_safe, state.o, state.d, state.t_min,
              torch.where(done, RAY_DEAD_T, state.t_far))
    if any_hit:
        rec["hit"] |= rk["hit"]
        state.t_far[rec["hit"]] = RAY_DEAD_T
    else:
        better = rk["hit"] & ((rec["tri"] < 0) | (rk["t"] < state.t_far))
        off = tt.tri_offsets[pid_safe.long()].repeat_interleave(block)
        new = dict(rk, tri=rk["tri"] + off)
        for key, value in rec.items():
            value[better] = new[key][better].to(value.dtype)
        state.t_far[better] = rk["t"][better]
    # Every ray of a live packet has visited its treelet.
    live = (~done).nonzero()[:, 0]
    treelet = pid_safe.repeat_interleave(block)[live]
    word = (treelet // 32).long()
    state.visited[live, word] |= torch.ones_like(treelet) << (treelet % 32)
    nxt = pick_keys_plain(state.entry, state.visited, state.t_far, block)
    state.keys[(r + 1) % 3] = torch.where(
        pid >= k, state.keys[(r + 1) % 3],
        torch.minimum(state.keys[(r + 1) % 3], nxt))


def treelet_walk_plain(tt, pid: torch.Tensor, o: torch.Tensor,
                       d: torch.Tensor, t_min, t_max, block: int,
                       cull_backface: bool = True,
                       any_hit: bool = False) -> dict:
    """The walks of one round, by brute force: rays [p * block, (p + 1) *
    block) against treelet pid[p] of `tt` alone (pid in [0, K)), through
    the flat kernels' plain versions over that treelet's records (padding
    records are all zero and fail the determinant test).  Returns the
    record of trace_nearest_bvh8 with treelet-LOCAL triangle ids and the
    fused shading of tt.shade_mode, or with any_hit only "hit"; a dead ray
    (t_max < t_min) misses."""
    mode = 0 if any_hit else tt.shade_mode
    packets = -(-o.shape[0] // block)
    if (not isinstance(pid, torch.Tensor) or pid.dtype != torch.int32
            or tuple(pid.shape) != (packets,)):
        raise ValueError(f"pid must be ({packets},) int32: one treelet id "
                         f"per packet of {block} rays")
    device = o.device
    o, d, tmn, tmx = _rays_and_interval(o, d, t_min, t_max, device)
    n = o.shape[0]
    ray_pid = pid.long().repeat_interleave(block)[:n]
    f32 = dict(dtype=torch.float32, device=device)
    if any_hit:
        out = {"hit": torch.zeros(n, dtype=torch.bool, device=device)}
    else:
        out = {"t": torch.full((n,), -1.0, **f32),
               "tri": torch.full((n,), -1, dtype=torch.int32, device=device),
               "u": torch.zeros(n, **f32), "v": torch.zeros(n, **f32),
               "hit": torch.zeros(n, dtype=torch.bool, device=device)}
    for treelet in torch.unique(ray_pid).tolist():
        rays = (ray_pid == treelet).nonzero()[:, 0]
        args = (None, tt.tri_stack[treelet], o[rays], d[rays], tmn[rays],
                tmx[rays])
        if any_hit:
            out["hit"][rays] = trace_any_bvh8_plain(
                *args, alpha_mask=tt.alpha_mask)
            continue
        rec = trace_nearest_bvh8_plain(
            *args, cull_backface, tt.shade_stack[treelet] if mode else None,
            mode, tt.alpha_mask)
        for key, value in rec.items():
            if key not in out:
                out[key] = torch.zeros((n,) + tuple(value.shape[1:]),
                                       dtype=value.dtype, device=device)
            out[key][rays] = value
    return out
