"""BVH construction on the host: binned object SAH, leaf alignment, BVH8.

Port of steeljax/accel/bvh.py:28-387.  The arrays are built by the same
numpy code and the same C++ builder (native.build_bvh_sah), so they equal
the reference's.  Node format:

  nodes[i] = [min.xyz, max.xyz, meta0, meta1]   (8 f32)
    internal: meta0 = left child index (right child = left + 1), meta1 = 0
    leaf:     meta0 = first triangle, meta1 = triangle count (> 0)

Only the object-SAH build is ported (what the reference's "auto" method
uses by default); there is no Morton fallback, because it builds a
different tree.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

_PAD_VALUE = 3.0e37  # padded triangles live here -> never hit

# Packed-triangle row layout shared by the packers and the trace kernel:
# a 128-float row holds TRI_PER_ROW records of TRI_STRIDE f32 each
# ([v0.xyz, e1.xyz, e2.xyz, double_sided]), 8 pad floats.  Leaf starts are
# TRI_PER_ROW-aligned.
TRI_PER_ROW = 12
TRI_STRIDE = 10
# The dense any-hit rows (cuda_traverse.pack_tris_dense): DENSE_PER_ROW
# records of DENSE_STRIDE f32 ([v0.xyz, e1.xyz, e2.xyz]), over leaves
# re-aligned to DENSE_PER_ROW.
DENSE_PER_ROW = 14
DENSE_STRIDE = 9
# BVH8 supernode rows: child c occupies floats [16c, 16c + 8).
SNODE_WIDTH = 8
SNODE_CHILD_STRIDE = 16


@dataclasses.dataclass
class BVH:
    nodes: np.ndarray  # (N, 8) float32 explicit nodes (see module doc)
    depth: int         # max tree depth
    max_leaf: int      # max tris per leaf


@dataclasses.dataclass
class BVH8:
    """8-wide BVH: one (128,) f32 row per supernode, on the render device.

    Child c occupies floats [16c, 16c + 8): [min.xyz, max.xyz, meta0,
    meta1] (+ 8 pad floats).
      meta1 > 0: leaf child (meta0 = TRI_PER_ROW-aligned first triangle,
                 meta1 = count)
      meta1 == 0 and meta0 >= 0: internal child (meta0 = supernode index)
      empty slots have inverted AABBs and meta0 = -1.
    """
    rows: torch.Tensor  # (S, 128) float32
    depth: int
    max_leaf: int


def build_bvh(tri_pos: np.ndarray, leaf_size: int = 64
              ) -> tuple[BVH, np.ndarray, int]:
    """Build a BVH over (T, 3, 3) world-space triangles.

    Returns (bvh, order, padded_count): reorder all per-triangle arrays by
    `order` (entries of -1 are pad slots) and pad to `padded_count`
    (apply_permutation)."""
    from steeljax_torch.native import build_bvh_sah

    tri_pos = np.asarray(tri_pos, np.float32)
    if len(tri_pos) == 0:
        nodes = np.zeros((1, 8), np.float32)
        nodes[0] = [_PAD_VALUE, _PAD_VALUE, _PAD_VALUE,
                    -_PAD_VALUE, -_PAD_VALUE, -_PAD_VALUE, 0.0, 1.0]
        return (BVH(nodes=nodes, depth=1, max_leaf=leaf_size),
                np.zeros(0, np.int64),
                -(-leaf_size // TRI_PER_ROW) * TRI_PER_ROW)
    nodes, perm, depth = build_bvh_sah(tri_pos, leaf_size)
    nodes, perm, padded = _align_leaves(nodes, perm, leaf_size)
    return BVH(nodes=nodes, depth=depth, max_leaf=leaf_size), perm, padded


def _align_leaves(nodes: np.ndarray, perm: np.ndarray, leaf_size: int,
                  align: int = TRI_PER_ROW
                  ) -> tuple[np.ndarray, np.ndarray, int]:
    """Re-layout leaf triangle ranges so every leaf starts at a multiple of
    `align` (the trace kernel reads leaf records by row).  Returns (nodes,
    order-with-pads, padded_count) where order entries of -1 denote pad
    slots."""
    nodes = np.asarray(nodes)
    leaf_mask = nodes[:, 7] > 0
    leaf_idx = np.nonzero(leaf_mask)[0]
    starts = nodes[leaf_idx, 6].astype(np.int64)
    counts = nodes[leaf_idx, 7].astype(np.int64)
    # Process leaves in storage order so output stays partition-contiguous.
    order_of_leaves = np.argsort(starts, kind="stable")
    aligned_counts = -(-counts[order_of_leaves] // align) * align
    new_starts_sorted = np.concatenate(
        [[0], np.cumsum(aligned_counts)[:-1]])
    # One extra max-size leaf of pad slack, rounded to whole rows (kept so
    # the padded layout equals the reference's).
    slack = -(-leaf_size // align) * align
    total = int(aligned_counts.sum()) + slack

    new_order = np.full(total, -1, np.int64)
    new_starts = np.empty(len(leaf_idx), np.int64)
    new_starts[order_of_leaves] = new_starts_sorted
    for li, ns in zip(range(len(leaf_idx)), new_starts):
        s, c = starts[li], counts[li]
        new_order[ns:ns + c] = perm[s:s + c]
    nodes = nodes.copy()
    nodes[leaf_idx, 6] = new_starts.astype(np.float32)
    return nodes, new_order, total


def apply_permutation(bvh_result, arrays: dict[str, np.ndarray]
                      ) -> dict[str, np.ndarray]:
    """Reorder + pad per-triangle arrays to match the BVH leaf layout.

    `order` entries of -1 are pad slots: pad triangles get _PAD_VALUE
    positions (never hit) and zeros elsewhere.
    """
    _, order, padded = bvh_result
    out = {}
    real = order >= 0
    src_idx = order[real]
    dst_idx = np.nonzero(real)[0] if len(order) else order
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        shape = (padded,) + arr.shape[1:]
        if name == "tri_pos":
            dst = np.full(shape, _PAD_VALUE, arr.dtype)
        else:
            dst = np.zeros(shape, arr.dtype)
        if len(order):
            if len(order) <= padded and real.all():
                dst[:len(order)] = arr[order]
            else:
                dst[dst_idx] = arr[src_idx]
        out[name] = dst
    return out


def collapse_bvh8(nodes: np.ndarray, max_leaf: int,
                  root: int = 0) -> tuple[np.ndarray, int]:
    """Collapse a binary explicit-node tree into 8-wide rows.

    Starting from a binary node, repeatedly expand the internal slot with
    the largest surface area until there are 8 slots or only leaves remain.
    Returns (rows (S, 128) f32, depth)."""
    nodes = np.asarray(nodes)
    stride = SNODE_CHILD_STRIDE

    def area(i):
        d = np.maximum(nodes[i, 3:6] - nodes[i, 0:3], 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    rows: list[np.ndarray] = []

    def is_leaf(i):
        return nodes[i, 7] > 0

    def build(binary_root: int) -> tuple[int, int]:
        """Returns (supernode index, subtree depth)."""
        slots = [binary_root]
        while len(slots) < SNODE_WIDTH:
            internal = [s for s in slots if not is_leaf(s)]
            if not internal:
                break
            expand = max(internal, key=area)
            slots.remove(expand)
            left = int(nodes[expand, 6])
            slots.extend([left, left + 1])

        sid = len(rows)
        rows.append(np.zeros(128, np.float32))
        depth = 1
        row = rows[sid]
        for c in range(SNODE_WIDTH):
            off = stride * c
            if c < len(slots):
                s = slots[c]
                row[off:off + 6] = nodes[s, 0:6]
                if is_leaf(s):
                    row[off + 6] = nodes[s, 6]
                    row[off + 7] = nodes[s, 7]
                else:
                    child_sid, child_depth = build(s)
                    row = rows[sid]  # list may have grown; rebind
                    row[off:off + 6] = nodes[s, 0:6]
                    row[off + 6] = float(child_sid)
                    row[off + 7] = 0.0
                    depth = max(depth, 1 + child_depth)
            else:
                row[off:off + 3] = 3.0e37
                row[off + 3:off + 6] = -3.0e37
                row[off + 6] = -1.0
                row[off + 7] = 0.0
        return sid, depth

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        _, depth = build(int(root))
    finally:
        sys.setrecursionlimit(old_limit)
    return np.stack(rows), depth


def subtree_tri_ranges(nodes: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
    """Per-node (count, lo, hi) over the aligned triangle layout.

    The SAH build partitions triangles in place, so every subtree owns a
    contiguous range of the permuted arrays; after _align_leaves each leaf
    range is TRI_PER_ROW-aligned.  `hi` is the exclusive row-aligned end of
    the last leaf.  Iterative post-order (trees reach ~10^5 nodes)."""
    nodes = np.asarray(nodes)
    n = len(nodes)
    count = np.zeros(n, np.int64)
    lo = np.full(n, np.iinfo(np.int64).max)
    hi = np.zeros(n, np.int64)
    is_leaf = nodes[:, 7] > 0
    stack = [(0, False)]
    while stack:
        i, expanded = stack.pop()
        if is_leaf[i]:
            start = int(nodes[i, 6])
            cnt = int(nodes[i, 7])
            count[i] = cnt
            lo[i] = start
            hi[i] = start + -(-cnt // TRI_PER_ROW) * TRI_PER_ROW
        elif not expanded:
            left = int(nodes[i, 6])
            stack.append((i, True))
            stack.append((left, False))
            stack.append((left + 1, False))
        else:
            left = int(nodes[i, 6])
            count[i] = count[left] + count[left + 1]
            lo[i] = min(lo[left], lo[left + 1])
            hi[i] = max(hi[left], hi[left + 1])
    return count, lo, hi
