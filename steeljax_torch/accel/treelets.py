"""Streamed-treelet traversal: one global SAH BVH cut into treelets, a
scheduler that sends ray packets to treelets, one kernel launch per round.

Port of steeljax/accel/treelets.py.  The reference built this for scenes
past its chip's on-chip memory; the port keeps the design as the
counterpart of kernel K7 and of `prepare_tables(treelets=True)`:

* ONE global SAH BVH is cut into subtrees of at most TREELET_TRIS
  triangles.  The SAH build partitions triangles in place, so every treelet
  owns a contiguous slice of the permuted triangle arrays, and its node and
  triangle tables stack into dense (K, S, 128) and (K, R, 128) tensors.
* A "top phase" of plain tensor code slab-tests every ray against the K
  treelet AABBs ((N, K) entry distances).
* A round loop then schedules PACKETS of `block` rays onto treelets: each
  packet picks the nearest treelet any of its rays still needs, and one
  launch of K7 (cuda_traverse.trace_treelet_round) per round traverses
  every packet against its chosen treelet.  Hits shrink each ray's t_max,
  which prunes later rounds (entry-distance test) and lets the kernel's
  root test reject finished rays.

The loop ends when no packet wants a treelet, which the host reads from the
device before every round (one synchronization each, and one more to leave
the loop); K rounds is an exact upper bound.  SCHEDULER counts the traces
and those host reads since the last reset; a trace's rounds are the
launches cuda_traverse.LAUNCHES counts for K7.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from steeljax_torch.accel import cuda_traverse
from steeljax_torch.accel.bvh import (TRI_PER_ROW, collapse_bvh8,
                                      subtree_tri_ranges)
from steeljax_torch.core.constants import RAY_DEAD_T

# Target treelet size of the reference.
TREELET_TRIS = 131_072
# Rays per scheduling packet (the reference's 128 lanes x 32 sublanes).
PACKET_RAYS = 4096
# Since the last reset (set the entries to 0): traces through the scheduler
# and the host's reads of the device's "any packet left" flag, each a
# synchronization.  Rounds are not counted here: each is one launch of K7,
# which cuda_traverse.LAUNCHES counts.
SCHEDULER = {"traces": 0, "host_reads": 0}


@dataclasses.dataclass
class TreeletTables:
    node_stack: torch.Tensor    # (K, S, 128) f32 BVH8 rows, local ids
    tri_stack: torch.Tensor     # (K, R, 128) f32 pack_tris slices
    aabb_lo: torch.Tensor       # (K, 3) f32 treelet bounds
    aabb_hi: torch.Tensor       # (K, 3)
    tri_offsets: torch.Tensor   # (K,) int32 global first-triangle index
    shade_stack: torch.Tensor | None = None  # (K, R * {1, 3}, 128) f32
    depth: int = 1
    max_leaf: int = 24
    shade_mode: int = 0
    # tri_stack rows carry AUX-encoded coarse alpha masks.
    alpha_mask: bool = False
    # Host copy of each treelet's row-aligned triangle range (lo, hi):
    # attach_shade_stack slices the global shade table by these.
    ranges: tuple = ()

    @property
    def count(self) -> int:
        return self.node_stack.shape[0]

    def replace(self, **changes) -> "TreeletTables":
        return dataclasses.replace(self, **changes)


def cut_treelets(nodes: np.ndarray, max_tris: int = TREELET_TRIS
                 ) -> tuple[list[int], np.ndarray, np.ndarray]:
    """Pick treelet roots: the shallowest nodes whose subtree holds at
    most `max_tris` triangles.  Returns (roots, range_lo, range_hi) with
    ranges in (row-aligned) permuted-triangle units."""
    nodes = np.asarray(nodes)
    count, lo, hi = subtree_tri_ranges(nodes)
    roots: list[int] = []
    stack = [0]
    while stack:
        i = stack.pop()
        if count[i] <= max_tris or nodes[i, 7] > 0:
            roots.append(i)
        else:
            left = int(nodes[i, 6])
            stack.append(left + 1)
            stack.append(left)
    # Left-first DFS over an in-place-partitioned tree visits treelets in
    # ascending triangle order already.
    return roots, lo[roots], hi[roots]


def build_treelet_tables(nodes: np.ndarray, tris_packed: np.ndarray,
                         max_leaf: int, device: torch.device | str,
                         max_tris: int = TREELET_TRIS) -> TreeletTables:
    """Cut the global binary tree and stack per-treelet BVH8 and triangle
    tables on `device`.

    `tris_packed` is the GLOBAL pack_tris layout (rows of TRI_PER_ROW
    records, host numpy); treelet triangle tables are row slices of it
    (contiguous subtree ranges).  Padding rows of either stack are never
    reached: leaf row reads are gated by the leaf's count."""
    nodes = np.asarray(nodes)
    tris_packed = np.asarray(tris_packed)
    roots, lo, hi = cut_treelets(nodes, max_tris)

    rows_list, depths = [], []
    for r, l in zip(roots, lo):
        rows8, depth8 = collapse_bvh8(nodes, max_leaf, root=r)
        # Localize leaf starts (meta0) to the treelet's triangle range.
        leaf = rows8[:, 7::16] > 0
        starts = rows8[:, 6::16]
        rows8[:, 6::16] = np.where(leaf, starts - float(l), starts)
        rows_list.append(rows8)
        depths.append(depth8)

    k = len(roots)
    s_max = max(r.shape[0] for r in rows_list)
    node_stack = np.zeros((k, s_max, 128), np.float32)
    # Unreachable padding rows; mark children empty anyway.
    node_stack[:, :, 6::16] = -1.0
    node_stack[:, :, 3::16] = -3.0e37
    for i, r in enumerate(rows_list):
        node_stack[i, :r.shape[0]] = r

    r_max = int(max((h - l) // TRI_PER_ROW for l, h in zip(lo, hi)))
    tri_stack = np.zeros((k, r_max, 128), np.float32)
    for i, (l, h) in enumerate(zip(lo, hi)):
        tri_stack[i, :(h - l) // TRI_PER_ROW] = \
            tris_packed[l // TRI_PER_ROW:h // TRI_PER_ROW]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return TreeletTables(
        node_stack=dev(node_stack), tri_stack=dev(tri_stack),
        aabb_lo=dev(nodes[roots, 0:3].astype(np.float32)),
        aabb_hi=dev(nodes[roots, 3:6].astype(np.float32)),
        tri_offsets=dev(np.asarray(lo, np.int32)),
        depth=max(depths), max_leaf=max_leaf,
        ranges=tuple((int(l), int(h)) for l, h in zip(lo, hi)))


def attach_shade_stack(tt: TreeletTables, shade_packed: np.ndarray,
                       shade_mode: int) -> TreeletTables:
    """Stack per-treelet slices of the GLOBAL pack_shade_records table
    (same permuted order as the triangles, `per` rows per triangle row).
    Rows past each treelet's real range are padding the kernel never
    reads."""
    per = 1 if shade_mode == 1 else TRI_PER_ROW // cuda_traverse.SHADE2_PER_ROW
    shade_packed = np.asarray(shade_packed)
    r_max = tt.tri_stack.shape[1]
    stack = np.zeros((tt.count, r_max * per, 128), np.float32)
    for i, (lo, hi) in enumerate(tt.ranges):
        rows = (hi - lo) // TRI_PER_ROW * per
        srow0 = lo // TRI_PER_ROW * per
        stack[i, :rows] = shade_packed[srow0:srow0 + rows]
    return tt.replace(
        shade_stack=torch.from_numpy(stack).to(tt.tri_stack.device),
        shade_mode=shade_mode)


def _entry_distances(tt: TreeletTables, o, d, t_min, t_max) -> torch.Tensor:
    """(N, K) slab entry distance per (ray, treelet); +inf when the ray
    cannot hit it inside [t_min, t_max]."""
    inv = 1.0 / torch.where(d.abs() < 1e-12,
                            torch.where(d < 0, -1e-12, 1e-12), d)
    o = o[:, None, :]
    inv = inv[:, None, :]
    t0 = (tt.aabb_lo[None] - o) * inv
    t1 = (tt.aabb_hi[None] - o) * inv
    near = torch.minimum(t0, t1).max(dim=-1).values
    far = torch.maximum(t0, t1).min(dim=-1).values
    possible = ((near <= far) & (far >= t_min[:, None])
                & (near <= t_max[:, None]))
    return torch.where(possible, near, float("inf"))


def _next_pid(entry, visited, t_far, block: int) -> torch.Tensor:
    """Per-ray nearest wanted treelet -> per-packet NEAREST choice (the
    treelet whose entry distance is the packet-wide minimum, so hits shrink
    t_far before farther treelets are considered).  Returns (P,) int32 in
    [0, K]; K means the packet is done."""
    k = entry.shape[1]
    masked = torch.where(visited | (entry >= t_far[:, None]), float("inf"),
                         entry)
    best, desired = masked.min(dim=1)
    desired = torch.where(torch.isfinite(best), desired, k).to(torch.int32)
    # Packet pick = the desired treelet of the packet's nearest-entry ray
    # (an all-done packet's argmin ray has best = inf, hence desired = K).
    ray_ix = best.reshape(-1, block).argmin(dim=1)
    return desired.reshape(-1, block).gather(1, ray_ix[:, None])[:, 0]


def trace_treelets(tt: TreeletTables, o, d, t_min, t_max,
                   cull_backface: bool = True, any_hit: bool = False,
                   block: int = PACKET_RAYS, trace_fn=None) -> dict:
    """Nearest-hit (or any-hit) trace through the treelet scheduler.

    The record of cuda_traverse.trace_nearest_bvh8 (global triangle ids;
    the fused shade fields when tt.shade_mode > 0); with any_hit only
    "hit", the occlusion flags.  `trace_fn(pid, o, d, t_min, t_max)`
    overrides the round kernel K7 (tests use it to watch the schedule)."""
    device = o.device
    n = o.shape[0]
    padded = -(-n // block) * block
    pad = padded - n

    def prep(x, fill=0.0):
        if pad == 0:
            return x
        tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                          device=device)
        return torch.cat([x, tail])

    def interval(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=device).expand(n)

    o = prep(o.to(torch.float32)).contiguous()
    d = prep(d.to(torch.float32), 1.0).contiguous()
    t_min = prep(interval(t_min))
    t_far = prep(interval(t_max), RAY_DEAD_T)

    k = tt.count
    shade_mode = 0 if any_hit else tt.shade_mode
    entry = _entry_distances(tt, o, d, t_min, t_far)
    visited = ~torch.isfinite(entry)

    if trace_fn is None:
        def trace_fn(pid, o, d, t_min, t_max):
            return cuda_traverse.trace_treelet_round(
                tt, pid, o, d, t_min, t_max, cull_backface=cull_backface,
                any_hit=any_hit, block=block)

    f32 = dict(dtype=torch.float32, device=device)
    rec = {"hit": torch.zeros(padded, dtype=torch.bool, device=device)}
    if not any_hit:
        rec.update(t=torch.full((padded,), -1.0, **f32),
                   tri=torch.full((padded,), -1, dtype=torch.int32,
                                  device=device),
                   u=torch.zeros(padded, **f32), v=torch.zeros(padded, **f32))
    if shade_mode:
        rec["n"] = torch.zeros((padded, 3), **f32)
        rec["mat"] = torch.zeros(padded, dtype=torch.int32, device=device)
    if shade_mode == 2:
        rec["tan"] = torch.zeros((padded, 3), **f32)
        rec["uv"] = torch.zeros((padded, 2), **f32)
        rec["uvd"] = torch.zeros(padded, **f32)

    treelet_ids = torch.arange(k, dtype=torch.int32, device=device)
    pid = _next_pid(entry, visited, t_far, block)
    rounds = 0
    SCHEDULER["traces"] += 1
    # Every round retires at least one treelet per live packet (visited
    # masking), so K rounds is an exact upper bound.
    while rounds < k:
        SCHEDULER["host_reads"] += 1
        if not bool((pid < k).any()):
            break
        pid_safe = pid.clamp(max=k - 1)
        # Finished packets (pid == k) still launch, against treelet k - 1:
        # an inverted interval makes the kernel reject their rays at the
        # root.
        done_ray = (pid >= k).repeat_interleave(block)
        rk = trace_fn(pid_safe, o, d, t_min,
                      torch.where(done_ray, RAY_DEAD_T, t_far))
        if any_hit:
            rec["hit"] = rec["hit"] | rk["hit"]
            # Occluded rays stop scheduling (and are rejected at the root).
            t_far = torch.where(rec["hit"], RAY_DEAD_T, t_far)
        else:
            # Treelet-local -> global triangle ids (per-packet offset).
            off = tt.tri_offsets[pid_safe.long()].repeat_interleave(block)
            rk = dict(rk)
            rk["tri"] = torch.where(rk["hit"], rk["tri"] + off, -1)
            better = rk["hit"] & (~rec["hit"] | (rk["t"] < rec["t"]))
            rec = {key: torch.where(
                better if rec[key].dim() == 1 else better[:, None],
                rk[key], rec[key]) for key in rec}
            t_far = torch.where(better, rk["t"], t_far)
        pid_ray = pid_safe.repeat_interleave(block)
        visited = visited | (pid_ray[:, None] == treelet_ids[None, :])
        pid = _next_pid(entry, visited, t_far, block)
        rounds += 1
    return {key: val[:n] for key, val in rec.items()}
