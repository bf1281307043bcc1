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
  which prunes later rounds.

The scheduler's state (cuda_traverse.TreeletState) stays on the device and
every round updates it in place: the kernel merges its hits into the
running record, marks the treelet visited and picks each packet's next
treelet (csrc/treelet8.cu), so on the card a trace is one pick launch and
exactly K round launches, with no host read; K rounds is the exact upper
bound (every round retires a treelet of every live packet), and a round
whose packets are all done costs one launch of blocks that return at once.
On the CPU the same loop runs with the plain round and pick and leaves once
no packet is left, which it reads for free.  SCHEDULER counts the traces
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
# Rays per scheduling packet: one CUDA block of K7.  The reference's packet
# is 4,096 rays (128 lanes x 32 sublanes); on the H100 one trace of path
# U's primaries takes 1.25 ms of K7 with 4,096-ray packets and 0.99 ms with
# 128 (PERF.md, section 6): a smaller packet walks fewer rays through
# treelets they do not need.  trace_treelets takes either.
PACKET_RAYS = 128
# Since the last reset (set the entries to 0): traces through the scheduler
# and the host's reads of the "any packet left" flag (the plain loop's; on
# the card the loop reads none).  Rounds are not counted here: each is one
# launch of K7, which cuda_traverse.LAUNCHES counts.
SCHEDULER = {"traces": 0, "host_reads": 0}


@dataclasses.dataclass
class TreeletTables:
    node_stack: torch.Tensor    # (K, S, 128) f32 BVH8 rows, local ids
    tri_stack: torch.Tensor     # (K, R, 128) f32 pack_tris slices
    aabb_lo: torch.Tensor       # (K, 3) f32 treelet bounds
    aabb_hi: torch.Tensor       # (K, 3)
    tri_offsets: torch.Tensor   # (K,) int32 global first-triangle index
    shade_stack: torch.Tensor | None = None  # (K, R * {1, 3}, 128) f32
    # (K * R * 12, 12) f32: cuda_traverse.hopper_records of tri_stack, the
    # 48-byte records K7 reads.
    tri_records: torch.Tensor | None = None
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

    tri_stack = dev(tri_stack)
    return TreeletTables(
        node_stack=dev(node_stack), tri_stack=tri_stack,
        tri_records=cuda_traverse.hopper_records(tri_stack.reshape(-1, 128)),
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


def treelet_state(tt: TreeletTables, o, d, t_min, t_max,
                  any_hit: bool = False, block: int = PACKET_RAYS
                  ) -> cuda_traverse.TreeletState:
    """The scheduler state of one trace before its first pick: the rays
    padded to whole packets of `block` (a pad ray has the dead interval),
    t_far = t_max, the (N, K) entry distances, no treelet visited, empty
    keys and the initial record (t -1, tri -1, u = v = 0 and zero shading
    fields; with any_hit a false "hit")."""
    device = o.device
    n = o.shape[0]
    padded = -(-n // block) * block
    f32 = dict(dtype=torch.float32, device=device)

    def padded_copy(x, fill, width=()):
        # A Python scalar is filled in, not copied from the host: a copy
        # from pageable memory waits for the stream.
        out = torch.full((padded,) + width, fill, **f32)
        if isinstance(x, torch.Tensor):
            out[:n] = x.to(torch.float32).expand((n,) + width)
        else:
            out[:n].fill_(float(x))
        return out

    o = padded_copy(o, 0.0, (3,))
    d = padded_copy(d, 1.0, (3,))
    t_min = padded_copy(t_min, 0.0)
    t_far = padded_copy(t_max, RAY_DEAD_T)
    k = tt.count
    if any_hit:
        rec = {"hit": torch.zeros(padded, dtype=torch.bool, device=device)}
    else:
        rec = {"t": torch.full((padded,), -1.0, **f32),
               "tri": torch.full((padded,), -1, dtype=torch.int32,
                                 device=device),
               "u": torch.zeros(padded, **f32),
               "v": torch.zeros(padded, **f32)}
        if tt.shade_mode:
            rec["n"] = torch.zeros((padded, 3), **f32)
            rec["mat"] = torch.zeros(padded, dtype=torch.int32,
                                     device=device)
        if tt.shade_mode == 2:
            rec["tan"] = torch.zeros((padded, 3), **f32)
            rec["uv"] = torch.zeros((padded, 2), **f32)
            rec["uvd"] = torch.zeros(padded, **f32)
    return cuda_traverse.TreeletState(
        o=o, d=d, t_min=t_min, t_far=t_far,
        entry=_entry_distances(tt, o, d, t_min, t_far).contiguous(),
        visited=torch.zeros((padded, -(-k // 32)), dtype=torch.int32,
                            device=device),
        keys=torch.full((3, padded // block), cuda_traverse.EMPTY_KEY,
                        dtype=torch.int64, device=device),
        rec=rec, block=block)


def trace_treelets(tt: TreeletTables, o, d, t_min, t_max,
                   cull_backface: bool = True, any_hit: bool = False,
                   block: int = PACKET_RAYS, trace_fn=None) -> dict:
    """Nearest-hit (or any-hit) trace through the treelet scheduler.

    The record of cuda_traverse.trace_nearest_bvh8 (global triangle ids;
    the fused shade fields when tt.shade_mode > 0; a miss keeps t -1, tri
    -1 and zero fields); with any_hit only "hit", the occlusion flags.  On
    CUDA tensors the trace is one launch of the pick kernel and K launches
    of K7, with no host read.  On CPU tensors, or with `trace_fn`, the plain
    round and pick run, leaving once no packet is left;
    `trace_fn(pid, o, d, t_min, t_max)` then replaces the plain walks of
    each round (cuda_traverse.treelet_walk_plain: a treelet-local record
    per ray; tests use it to watch the schedule)."""
    n = o.shape[0]
    k = tt.count
    state = treelet_state(tt, o, d, t_min, t_max, any_hit, block)
    SCHEDULER["traces"] += 1
    if trace_fn is None and state.t_far.device.type == "cuda":
        cuda_traverse.treelet_pick_launcher(tt, state)()
        rounds = [cuda_traverse.treelet_launcher(
            tt, state, r, cull_backface, any_hit)[0]
            for r in range(min(3, k))]
        for r in range(k):
            rounds[r % 3]()
    else:
        state.keys[0] = cuda_traverse.pick_keys_plain(
            state.entry, state.visited, state.t_far, block)
        for r in range(k):
            SCHEDULER["host_reads"] += 1
            pid = cuda_traverse.key_treelets(state.keys[r % 3], block, k)
            if not bool((pid < k).any()):
                break
            cuda_traverse.trace_treelet_round_plain(
                tt, state, r, cull_backface, any_hit, walk=trace_fn)
    rec = state.rec
    if not any_hit:
        rec = {"hit": rec["tri"] >= 0, **rec}
    return {key: val[:n] for key, val in rec.items()}
