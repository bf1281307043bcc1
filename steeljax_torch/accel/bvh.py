"""BVH construction on the host: binned SAH with optional spatial splits,
the Morton build, leaf alignment, BVH8.

Port of steeljax/accel/bvh.py:28-387.  The arrays are built by the same
numpy code and the same C++ builder (native.build_bvh_sah), so they equal
the reference's.  Node format:

  nodes[i] = [min.xyz, max.xyz, meta0, meta1]   (8 f32)
    internal: meta0 = left child index (right child = left + 1), meta1 = 0
    leaf:     meta0 = first triangle, meta1 = triangle count (> 0)

build_bvh's methods are the reference's: "sah" (object SAH), "sbvh"
(spatial splits at alpha 1e-5), "morton" (a complete tree over Morton-
sorted leaves) and "auto", the native build at the alpha STEELJAX_SBVH
gives (_spatial_alpha; off by default).  With spatial splits `order` is a
reference list: a triangle id may fill several slots, one record a slot,
and every consumer gathers by slot.  Where the reference's "auto" falls
back to the Morton tree when its native build is unavailable, the port's
always builds its library and raises on a failed build.
"""

from __future__ import annotations

import dataclasses
import os
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
# BVH8 supernode rows: child c occupies floats [16c, 16c + 8) at the
# default width 8; at width 16 (collapse_bvh8(width=16)) floats [8c, 8c + 8).
SNODE_WIDTH = 8
SNODE_WIDTHS = (8, 16)


@dataclasses.dataclass
class BVH:
    nodes: np.ndarray  # (N, 8) float32 explicit nodes (see module doc)
    depth: int         # max tree depth
    max_leaf: int      # max tris per leaf


@dataclasses.dataclass
class BVH8:
    """Wide BVH: one (128,) f32 row per supernode, on the render device.

    Child c occupies floats [stride * c, stride * c + 8), stride = 128 //
    width: [min.xyz, max.xyz, meta0, meta1] (+ 8 pad floats at width 8, none
    at width 16).
      meta1 > 0: leaf child (meta0 = TRI_PER_ROW-aligned first triangle,
                 meta1 = count)
      meta1 == 0 and meta0 >= 0: internal child (meta0 = supernode index)
      empty slots have inverted AABBs and meta0 = -1.
    """
    rows: torch.Tensor  # (S, 128) float32
    depth: int
    max_leaf: int
    width: int = SNODE_WIDTH


def _morton3(x: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of (N, 3) cell coordinates below 1024."""
    def expand(v: np.ndarray) -> np.ndarray:
        v = v.astype(np.uint32)
        v = (v | (v << 16)) & np.uint32(0x030000FF)
        v = (v | (v << 8)) & np.uint32(0x0300F00F)
        v = (v | (v << 4)) & np.uint32(0x030C30C3)
        v = (v | (v << 2)) & np.uint32(0x09249249)
        return v
    return (expand(x[:, 0]) << 2) | (expand(x[:, 1]) << 1) | expand(x[:, 2])


def _build_morton(tri_pos: np.ndarray, leaf_size: int
                  ) -> tuple[np.ndarray, np.ndarray, int]:
    """Morton-ordered complete-tree build -> (nodes, permutation, depth)
    (steeljax/accel/bvh.py:63-117): the centroids' Morton order cut into
    leaves of `leaf_size` slots, 2^k of them (pad slots at 3e37), and a
    complete binary tree over them."""
    count = len(tri_pos)
    centroids = tri_pos.mean(axis=1)
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    extent = np.maximum(hi - lo, 1e-9)
    quantized = np.clip(
        ((centroids - lo) / extent * 1023.0), 0, 1023).astype(np.uint32)
    order = np.argsort(_morton3(quantized), kind="stable").astype(np.int64)

    num_leaves_raw = -(-count // leaf_size)
    num_leaves = 1 << max(0, (num_leaves_raw - 1).bit_length())
    padded = num_leaves * leaf_size

    sorted_pos = np.full((padded, 3, 3), _PAD_VALUE, np.float32)
    sorted_pos[:count] = tri_pos[order]

    chunk = sorted_pos.reshape(num_leaves, leaf_size, 3, 3)
    leaf_min = chunk.min(axis=(1, 2))
    leaf_max = chunk.max(axis=(1, 2))
    pad_leaf = leaf_min[:, 0] >= _PAD_VALUE
    leaf_min[pad_leaf] = _PAD_VALUE
    leaf_max[pad_leaf] = -_PAD_VALUE
    mixed = (leaf_max[:, 0] >= _PAD_VALUE) & ~pad_leaf
    for li in np.nonzero(mixed)[0]:
        tris = chunk[li].reshape(-1, 3)
        real = tris[:, 0] < _PAD_VALUE
        leaf_min[li] = tris[real].min(axis=0)
        leaf_max[li] = tris[real].max(axis=0)

    depth = int(np.log2(num_leaves)) + 1
    first_leaf = num_leaves - 1
    nodes = np.zeros((2 * num_leaves - 1, 8), np.float32)
    nodes[first_leaf:, 0:3] = leaf_min
    nodes[first_leaf:, 3:6] = leaf_max
    nodes[first_leaf:, 6] = (np.arange(num_leaves) * leaf_size).astype(
        np.float32)
    nodes[first_leaf:, 7] = float(leaf_size)
    for level in range(depth - 2, -1, -1):
        first = (1 << level) - 1
        size = 1 << level
        child_first = 2 * first + 1
        cmin = nodes[child_first:child_first + 2 * size, 0:3].reshape(
            size, 2, 3)
        cmax = nodes[child_first:child_first + 2 * size, 3:6].reshape(
            size, 2, 3)
        nodes[first:first + size, 0:3] = cmin.min(axis=1)
        nodes[first:first + size, 3:6] = cmax.max(axis=1)
        nodes[first:first + size, 6] = (
            2 * np.arange(first, first + size) + 1).astype(np.float32)
        nodes[first:first + size, 7] = 0.0
    return nodes, order, depth


BUILD_METHODS = ("auto", "sbvh", "sah", "morton")


def _spatial_alpha(method: str) -> float:
    """The spatial-split alpha of a native build method
    (steeljax/accel/bvh.py:120-143): "sah" 0 (object SAH), "sbvh" 1e-5,
    "auto" from STEELJAX_SBVH, read at the call: unset or "0" off, "1"
    1e-5, another float that alpha, anything else 1e-5."""
    if method == "sah":
        return 0.0
    if method == "sbvh":
        return 1e-5
    env = os.environ.get("STEELJAX_SBVH", "0")
    if env == "0":
        return 0.0
    if env == "1":
        return 1e-5
    try:
        return float(env)
    except ValueError:
        return 1e-5


def build_bvh(tri_pos: np.ndarray, leaf_size: int = 64,
              method: str = "auto") -> tuple[BVH, np.ndarray, int]:
    """Build a BVH over (T, 3, 3) world-space triangles by `method`, one of
    BUILD_METHODS (the module docstring).

    Returns (bvh, order, padded_count): reorder all per-triangle arrays by
    `order` (entries of -1 are pad slots; with spatial splits a triangle id
    may appear in several slots) and pad to `padded_count`
    (apply_permutation)."""
    from steeljax_torch.native import build_bvh_sah

    if method not in BUILD_METHODS:
        raise ValueError(f"build method must be one of {BUILD_METHODS}, "
                         f"got {method!r}")
    tri_pos = np.asarray(tri_pos, np.float32)
    if len(tri_pos) == 0:
        nodes = np.zeros((1, 8), np.float32)
        nodes[0] = [_PAD_VALUE, _PAD_VALUE, _PAD_VALUE,
                    -_PAD_VALUE, -_PAD_VALUE, -_PAD_VALUE, 0.0, 1.0]
        return (BVH(nodes=nodes, depth=1, max_leaf=leaf_size),
                np.zeros(0, np.int64),
                -(-leaf_size // TRI_PER_ROW) * TRI_PER_ROW)
    if method != "morton":
        nodes, perm, depth = build_bvh_sah(
            tri_pos, leaf_size, spatial_alpha=_spatial_alpha(method))
        nodes, perm, padded = _align_leaves(nodes, perm, leaf_size)
        return BVH(nodes=nodes, depth=depth, max_leaf=leaf_size), perm, padded
    nodes, perm, depth = _build_morton(tri_pos, leaf_size)
    # Morton leaves start at multiples of leaf_size, which need not be
    # TRI_PER_ROW-aligned: re-lay them out as the native builds'.
    num_leaves = (len(nodes) + 1) // 2
    perm_full = np.full(num_leaves * leaf_size, -1, np.int64)
    perm_full[:len(perm)] = perm
    nodes, perm, padded = _align_leaves(nodes, perm_full, leaf_size)
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


def collapse_bvh8(nodes: np.ndarray, max_leaf: int, root: int = 0,
                  width: int = SNODE_WIDTH) -> tuple[np.ndarray, int]:
    """Collapse a binary explicit-node tree into `width`-wide rows (8 or
    16; child stride 128 // width floats).

    Starting from a binary node, repeatedly expand the internal slot with
    the largest surface area until there are `width` slots or only leaves
    remain.  Returns (rows (S, 128) f32, depth)."""
    if width not in SNODE_WIDTHS:
        raise ValueError(f"supernode width must be one of {SNODE_WIDTHS}, "
                         f"got {width}")
    nodes = np.asarray(nodes)
    stride = 128 // width

    def area(i):
        d = np.maximum(nodes[i, 3:6] - nodes[i, 0:3], 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    rows: list[np.ndarray] = []

    def is_leaf(i):
        return nodes[i, 7] > 0

    def build(binary_root: int) -> tuple[int, int]:
        """Returns (supernode index, subtree depth)."""
        slots = [binary_root]
        while len(slots) < width:
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
        for c in range(width):
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

    Every build lays its leaves out depth first, so every subtree owns a
    contiguous range of the slots (counts are slots: under spatial splits
    a duplicated triangle counts once per slot); after _align_leaves each
    leaf range is TRI_PER_ROW-aligned.  `hi` is the exclusive row-aligned
    end of the last leaf.  Iterative post-order (trees reach ~10^5 nodes)."""
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
