"""Ray traversal: the brute-force reference and the BVH stack walk.

Port of steeljax/accel/traverse.py, the reference's CPU backend and the
oracle its kernel parity holds every Pallas kernel against.  `trace_nearest`
walks the explicit-node binary BVH (accel.bvh: nodes[i] = [min.xyz,
max.xyz, meta0, meta1]) over the permuted triangle arrays; `trace_any` is
its occlusion query; `trace_nearest_brute` tests every triangle.  They
share no code with the CUDA kernels or their plain versions (the
brute-force tests over the packed records in accel.cuda_traverse), so they
are a second, independent reference for both.

The reference runs one ray's while_loop under vmap, which XLA lowers to a
lockstep batched loop.  Here the loop is explicit: each ray of a batch
holds a stack of depth + 2 node ids, a stack pointer and its best t, tri,
u and v, and every step follows the reference's rules, so that exact-t
ties resolve as they do there:

  * pop one node;
  * at an internal node, slab-test both children against the ray's best t
    (a child is culled when pushed, not when popped), then push the far
    child and the near one on top (`near_r < near_l` swaps, so the left
    child comes first on equal near);
  * at a leaf, test the max_leaf triangles from the leaf's first one,
    clipped so that the slice stays inside the arrays, with lane < count
    and, for masked tables, the coarse alpha mask; the first lane of the
    smallest t wins, and only a t strictly below the best replaces it;
  * any_hit empties the stack at the first hit.

Rays whose stack is empty leave the step's working set (compaction), so
the late steps of a deep walk cost little; a ray at an internal node skips
the leaf test and one at a leaf the slab tests.  Rays go through in
batches of at most BATCH_CANDIDATES[device type] // max_leaf, since a leaf
step holds rays x max_leaf candidates.  The walk is an oracle, not a
render path: it reads the device on the host three times a step (the sizes
of the internal, leaf and still-live sets), and `stats` counts its batches,
steps and host reads.  It runs on the device of its tensors and refuses
mixed devices; every value is a float32 tensor op in the reference's order,
so the CPU and the card give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from steeljax_torch.accel.alphamask import mask_test
from steeljax_torch.accel.bvh import BVH
from steeljax_torch.accel.cuda_traverse import _one_device, _rays_and_interval
from steeljax_torch.accel.intersect import intersect

_INF = 3.0e38
# Candidates (rays x triangles) one step of the walk, or one triangle chunk
# of the brute force, may hold, by device type.
BATCH_CANDIDATES = {"cpu": 1 << 20, "cuda": 1 << 25}


def _pack_tris(tri_pos: torch.Tensor):
    v0 = tri_pos[:, 0, :]
    e1 = tri_pos[:, 1, :] - v0
    e2 = tri_pos[:, 2, :] - v0
    return v0, e1, e2


def _inputs(tri_pos, tri_double_sided, origins, directions, t_min, t_max,
            tri_alpha_mask=None):
    """The tensors on their one device: (tri_pos, double_sided, o, d,
    t_min, t_max, mask or None), the interval as (N,) float32."""
    tensors = {"tri_pos": tri_pos, "tri_double_sided": tri_double_sided,
               "origins": origins, "directions": directions}
    if tri_alpha_mask is not None:
        tensors["tri_alpha_mask"] = tri_alpha_mask
    device = _one_device(tensors, t_min, t_max)
    o, d, tmin, tmax = _rays_and_interval(origins, directions, t_min, t_max,
                                          device)
    mask = (None if tri_alpha_mask is None
            else tri_alpha_mask.to(torch.int32))
    return (tri_pos.to(torch.float32), tri_double_sided.to(torch.bool), o, d,
            tmin, tmax, mask)


def _record(best_t, best_i, best_u, best_v) -> dict:
    hit = best_i >= 0
    return {"t": torch.where(hit, best_t, -1.0), "tri": best_i,
            "u": best_u, "v": best_v, "hit": hit}


def _count(stats, **counts) -> None:
    if stats is not None:
        for key, value in counts.items():
            stats[key] = stats.get(key, 0) + value


def _take_first_min(t, best):
    """The leaf's (or chunk's) winner: the first lane of the smallest t,
    taken only where it is strictly below the ray's best t.  Returns
    (better, lane, its t)."""
    k = t.argmin(dim=1)
    tk = t.gather(1, k[:, None])[:, 0]
    return tk < best, k, tk


def trace_nearest_brute(tri_pos, tri_double_sided, origins, directions,
                        t_min, t_max, cull_backface: bool = True,
                        chunk: int = 2048) -> dict:
    """O(rays x tris) nearest hit in triangle chunks of size `chunk`
    (steeljax/accel/traverse.py:40-81): a chunk's winner replaces the best
    hit only at a strictly smaller t, so the first triangle wins a tie.
    Returns the record of trace_nearest."""
    tri_pos, ds, o, d, tmin, tmax, _ = _inputs(
        tri_pos, tri_double_sided, origins, directions, t_min, t_max)
    v0, e1, e2 = _pack_tris(tri_pos)
    n, count = o.shape[0], tri_pos.shape[0]
    batch = max(1, BATCH_CANDIDATES[o.device.type] // chunk)
    best_t = tmax.clone()
    best_i = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    best_u = torch.zeros((n,), dtype=torch.float32, device=o.device)
    best_v = torch.zeros_like(best_u)
    for s in range(0, n, batch):
        r = slice(s, min(s + batch, n))
        for base in range(0, count, chunk):
            c = slice(base, min(base + chunk, count))
            t, u, v, hit = intersect(o[r], d[r], v0[None, c], e1[None, c],
                                     e2[None, c], ds[None, c], tmin[r],
                                     tmax[r], cull_backface)
            t = torch.where(hit & (t < best_t[r, None]), t, _INF)
            better, k, tk = _take_first_min(t, best_t[r])
            best_t[r] = torch.where(better, tk, best_t[r])
            best_i[r] = torch.where(better, (base + k).to(torch.int32),
                                    best_i[r])
            best_u[r] = torch.where(better, u.gather(1, k[:, None])[:, 0],
                                    best_u[r])
            best_v[r] = torch.where(better, v.gather(1, k[:, None])[:, 0],
                                    best_v[r])
    return _record(best_t, best_i, best_u, best_v)


def _slab(boxes, ray, t_far):
    """The reference's slab test (traverse.py:88-94) of a ray's two child
    boxes: boxes (A, 2, 8) node rows, ray (A, 10) rows of the walk's ray
    table, t_far (A,).  Returns (hit, near), each (A, 2)."""
    o, inv_d = ray[:, None, 0:3], ray[:, None, 6:9]
    t0 = (boxes[..., 0:3] - o) * inv_d
    t1 = (boxes[..., 3:6] - o) * inv_d
    near = torch.minimum(t0, t1).amax(dim=2)
    far = torch.maximum(t0, t1).amin(dim=2)
    hit = ((near <= far) & (far >= ray[:, 9, None])
           & (near <= t_far[:, None]))
    return hit, near


def trace_nearest(bvh: BVH, tri_pos, tri_double_sided, origins, directions,
                  t_min, t_max, cull_backface: bool = True,
                  any_hit: bool = False, tri_alpha_mask=None,
                  stats: dict | None = None) -> dict:
    """Nearest-hit (or first-hit when any_hit) BVH walk
    (steeljax/accel/traverse.py:99-197).

    tri_pos (T, 3, 3) and tri_double_sided (T,) are the arrays permuted by
    the tree's order; origins and directions (N, 3); t_min and t_max
    scalars or (N,).  Returns a dict of (N,) tensors: t (-1 on a miss), tri
    (index into the permuted arrays, -1 on a miss), u, v and hit.
    `tri_alpha_mask` ((T,) int32 coarse masks, accel.alphamask) rejects a
    candidate in the walk as the kernels' alpha_mask mode does.  `stats`,
    a dict, gets "batches", "steps" and "host_reads" added."""
    tri_pos, ds, o, d, tmin, tmax, amask = _inputs(
        tri_pos, tri_double_sided, origins, directions, t_min, t_max,
        tri_alpha_mask)
    device = o.device
    v0, e1, e2 = _pack_tris(tri_pos)
    nodes = torch.as_tensor(np.asarray(bvh.nodes, np.float32), device=device)
    n_nodes, n_tris = nodes.shape[0], tri_pos.shape[0]
    max_leaf = int(bvh.max_leaf)
    stack_size = int(bvh.depth) + 2
    lane = torch.arange(max_leaf, device=device)
    n = o.shape[0]
    batch = max(1, BATCH_CANDIDATES[device.type] // max_leaf)

    safe_d = torch.where(d.abs() < 1e-12, 1e-12, d)
    # One gather a step reads a ray's [o, d, 1 / d, t_min] and a leaf's
    # triangles' [v0, e1, e2, double-sided].
    rays = torch.cat([o, d, 1.0 / safe_d, tmin[:, None]], dim=1)
    tris = torch.cat([v0, e1, e2, ds[:, None].to(torch.float32)], dim=1)
    best = torch.stack([tmax, torch.zeros_like(tmax), torch.zeros_like(tmax)],
                       dim=1)                                  # t, u, v
    best_i = torch.full((n,), -1, dtype=torch.int32, device=device)
    for s in range(0, n, batch):
        m = min(batch, n - s)
        stack = torch.zeros((m, stack_size), dtype=torch.int64,
                            device=device)
        sp = torch.ones((m,), dtype=torch.int64, device=device)
        live = torch.arange(m, device=device)
        steps = reads = 0
        while live.numel():
            steps += 1
            top = sp[live] - 1
            row = nodes[stack[live, top]]
            meta0 = row[:, 6].to(torch.int64)
            cnt = row[:, 7].to(torch.int64)
            is_leaf = cnt > 0

            # Internal: test both children, push far-then-near.
            inner = ~is_leaf
            at, a_top = live[inner], top[inner]
            reads += 1
            if at.numel():
                kids = meta0[inner, None] + torch.arange(2, device=device)
                kids = kids.clamp(0, n_nodes - 1)
                hit, near = _slab(nodes[kids], rays[at + s],
                                  best[at + s, 0])
                swap = near[:, 1] < near[:, 0]
                left, right = kids.unbind(1)
                hit_l, hit_r = hit.unbind(1)
                hit_first = torch.where(swap, hit_r, hit_l)
                hit_second = torch.where(swap, hit_l, hit_r)
                # Slots at and above the stack pointer are free, so both
                # children are written and the pointer counts the pushed.
                stack[at, a_top] = torch.where(swap, left, right)
                slot = a_top + hit_second
                stack[at, slot.clamp(max=stack_size - 1)] = torch.where(
                    swap, right, left)
                sp[at] = slot + hit_first

            # Leaf: the max_leaf triangles from the clipped base, lane <
            # count, the coarse mask.
            lt = live[is_leaf]
            reads += 1
            if lt.numel():
                lr = lt + s
                base = meta0[is_leaf].clamp(0, max(n_tris - max_leaf, 0))
                ids = (base[:, None] + lane).clamp(max=n_tris - 1)
                tri = tris[ids]
                ray = rays[lr]
                best_l = best[lr]
                t, u, v, hit = intersect(
                    ray[:, 0:3], ray[:, 3:6], tri[..., 0:3], tri[..., 3:6],
                    tri[..., 6:9], tri[..., 9] > 0.5, ray[:, 9],
                    best_l[:, 0], cull_backface)
                hit &= lane < cnt[is_leaf, None]
                if amask is not None:
                    hit &= mask_test(amask[ids], u, v)
                t = torch.where(hit, t, _INF)
                better, k, _ = _take_first_min(t, best_l[:, 0])
                won = torch.stack([t, u, v], dim=2).gather(
                    1, k[:, None, None].expand(-1, 1, 3))[:, 0]
                best[lr] = torch.where(better[:, None], won, best_l)
                best_i[lr] = torch.where(better, (base + k).to(torch.int32),
                                         best_i[lr])
                leaf_sp = top[is_leaf]
                if any_hit:
                    leaf_sp = torch.where(best_i[lr] >= 0, 0, leaf_sp)
                sp[lt] = leaf_sp
            live = live[sp[live] > 0]
            reads += 1
        _count(stats, batches=1, steps=steps, host_reads=reads)
    return _record(best[:, 0], best_i, best[:, 1], best[:, 2])


def trace_any(bvh: BVH, tri_pos, tri_double_sided, origins, directions,
              t_min, t_max, tri_alpha_mask=None,
              stats: dict | None = None) -> torch.Tensor:
    """Visibility query (steeljax/accel/traverse.py:200-212): does any
    surface in [t_min, t_max] block the ray?  The walk with any_hit and no
    backface culling; (N,) bool.  With `tri_alpha_mask`, candidates the
    coarse mask rejects never block."""
    return trace_nearest(bvh, tri_pos, tri_double_sided, origins, directions,
                         t_min, t_max, cull_backface=False, any_hit=True,
                         tri_alpha_mask=tri_alpha_mask, stats=stats)["hit"]
