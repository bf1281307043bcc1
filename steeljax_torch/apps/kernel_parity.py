"""Kernel parity gate for the trace kernels K1 to K7: each CUDA kernel
against its plain PyTorch version, on the card, and the variants the
reference judges against its BVH walk against that walk too.

Port of steeljax/apps/kernel_parity.py for the ported kernels: the inputs
(`_soup`, `_rays`, seeded as :242-264), the deterministic grid
(:370-401), the any-hit variants (:302-339), the alpha-mask, fine-mask and
multi-hit variants (:341-370, :446-542) and the judge `_compare` with its
thresholds (:149-222):

  * at most max(2, N/5000) hit mismatches (0 on the exact variant); the
    any-hit variants are judged by this count alone,
  * |delta t| < 2e-3 (1e-5 on the exact variant),
  * normal, tangent and uv deltas < 5e-3 and 0 material mismatches (fused
    shading),
  * tri ids may differ, which they do only on exact-t ties;
  * multi-hit slots: at most max(2, N K / 5000) slots hit in one and not the
    other, |delta t| < 2e-3, and u, v within 5e-3 where the slot's tri ids
    agree (_compare_slots);
  * over spatial-split tables (a triangle in several slots) hits compare
    by source triangle (source_ids), and K-lists without the repeats of
    one triangle, which the walk and the brute-force plain version find in
    different numbers (_compare_slots_by_source).

The kernels compile with FMA contraction and the plain versions run
unfused tensor ops, so the two differ in the last bits of t; the
thresholds above absorb that.  Beyond the reference's variants it checks
the paths' own rays: Cornell primary rays at 1280x720 and their
first-bounce rays (K1), the first-bounce shadow rays of the sunlit stress
scene (K2 on both row layouts, `sunlit_shadow` and `sunlit_shadow_dense`),
the primary rays of the textured stress scene (K3, `stress_tex_primary`),
the hybrid frame's rays on the sunlit stress scene at the JAX bench's
1920x1080 (K1 in shade mode 1 on the G-buffer's pixel-centre rays,
`hybrid_gbuffer_1920x1080`, and K2 on the lighting stage's sun rays, sky
and unlit pixels dead, `hybrid_sun_shadow`),
and path F's, the serrated foliage scene's, primary rays (K4 with fine
masks, `foliage_primary`; K5 with K = 4, `foliage_multihit`) and
first-bounce sun rays (K4 without culling, `foliage_shadow`), each on a
fixed strided subset, since the brute-force plain version costs O(rays x
triangles).

The two-level kernel K6 and the treelet kernel K7 have the reference's
variants (:544-585): `instanced_fused` and `instanced_anyhit` (Cornell at
sphere detail 8, rays of spread 4) and `treelets_shade0` (the soup cut at
max_tris = 4096, through the scheduler); besides, `instanced_shade0` and
`instanced_shade2` (a non-uniformly scaled and a mirrored instance added),
`treelets_shade1`, `treelets_shade2`, `treelets_anyhit` and
`treelets_alpha_mask`, and on the paths' own rays `instanced_primary`,
`instanced_shadow` (path I), `instanced_tex_primary` (path J),
`treelets_primary` (path U), `treelets_lit_primary` and `treelets_shadow`
(path UL: K7 in shade mode 1 and its any-hit query).  Fused
outputs of K6 live in world space per instance, so they are compared
directly between kernel and plain version where both name the same triangle
and instance; `inst` is judged like `tri`: it may differ only on exact-t
ties.

The reference's multi-chunk and 16-wide variants (:403-443) are
`chunked_shade0` and `chunked_anyhit` (K1 and K2 on every chunk of the soup
cut in three, through dispatch's sweep) and `flat_shade0_width16` (K1 over
16-wide supernode rows); the walk serves K2, K4 and K5 at width 16 too,
which `anyhit_width16`, `alpha_width16` and `multihit_width16` hold.

The reference's oracle is its BVH walk (:229-400, tables with
use_pallas=False), the port's accel.traverse: the variants it judges
against the walk (flat_shade0_cull{0,1}, flat_shade0_shared_origin,
flat_shade{1,2}, flat_anyhit, flat_anyhit_dense, flat_alpha_mask,
flat_alpha_mask_anyhit, flat_deterministic_exact, chunked_shade0,
chunked_anyhit, flat_shade0_width16) and the soup-scale instanced ones
(instanced_fused, instanced_anyhit, instanced_shade0, instanced_shade2)
are judged by the same _compare against dispatch.trace_nearest_walk /
trace_any_walk or instances.trace_nearest_instanced_walk as well (_judge,
_judge_hits): a variant passes only if the kernel agrees with both
references, and its entry keeps the walk's under "walk".  The fine-mask
and multi-hit variants have no walk (the reference's has neither a fine
plane nor K slots), and the path-scale ones are held against the walk on
every ray by chip_smoke.py's phase 20.

`flat_shade0_shared_origin` is the reference's variant of K1 on rays that
share one origin (:279-286, the hybrid G-buffer's kind of ray); the port's
kernel has no special path for them, so the variant holds its general one
there.  The reference's `flat_shade0_cull{0,1}_subl{16,32}` variants are
its TPU packet sizes; the port's kernel has none, and
`flat_shade0_cull{0,1}` stand for them.

Usage (needs a CUDA card):
    python -m steeljax_torch.apps.kernel_parity [-o parity.json] \
        [--rays 10240] [--tris 30000]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _soup(n, seed, spread=10.0):
    r = np.random.default_rng(seed)
    base = r.uniform(-spread, spread, (n, 1, 3)).astype(np.float32)
    return (base + r.normal(0, 0.6, (n, 3, 3))).astype(np.float32)


def _rays(n, seed, spread=14.0, shared_origin=False):
    r = np.random.default_rng(seed)
    if shared_origin:
        o = np.tile(r.uniform(-spread, spread, (1, 3)), (n, 1))
    else:
        o = r.uniform(-spread, spread, (n, 3))
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _interp(attr, tri, u, v):
    """Barycentric interpolation of a (T, 3, C) per-vertex attribute."""
    a = attr[np.maximum(tri, 0)]
    w = (1.0 - u - v)[:, None]
    return a[:, 0] * w + a[:, 1] * u[:, None] + a[:, 2] * v[:, None]


def _norm(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-20)


def _numpy(rec):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in rec.items()}


def _compare(name, rec_k, rec_o, tri_pos, results,
             attrs=None, d=None, atol=2e-3, exact=False, direct=False,
             source=None):
    """Record per-field max deltas between kernel and oracle records
    (steeljax/apps/kernel_parity.py:149-222).

    tri ids may legitimately differ on exact-tie hits, so geometry parity
    is judged by |t| and the resolved hit positions, not the id.  `direct`
    compares the fused outputs of the two records with each other where
    both name the same triangle (and instance), for records whose
    attributes are not world-space per-triangle arrays.  `source` (a slot's
    source triangle, source_ids) adds the share of hits on the same source
    triangle: over spatial-split tables two slots of one triangle are one
    hit, which the kernel and the plain version may name by either."""
    rec_k = _numpy(rec_k)
    rec_o = _numpy(rec_o)
    hk = rec_k["hit"]
    ho = rec_o["hit"]
    entry = {"rays": int(hk.shape[0]),
             "hit_mismatches": int((hk != ho).sum()),
             "hits": int(hk.sum())}
    both = hk & ho
    if both.any():
        tk = rec_k["t"][both]
        to = rec_o["t"][both]
        entry["max_t_delta"] = float(np.abs(tk - to).max())
        same_tri = rec_k["tri"][both] == rec_o["tri"][both]
        entry["tri_matches_pct"] = float(same_tri.mean() * 100.0)
        if source is not None:
            entry["source_matches_pct"] = float(
                (source[rec_k["tri"][both]] == source[rec_o["tri"][both]])
                .mean() * 100.0)
        if attrs is not None and same_tri.any():
            # Independent cross-check at the ORACLE's (tri, u, v) where
            # the ids agree.
            bo = np.nonzero(both)[0][same_tri]
            trio = rec_o["tri"][bo]
            no_ref = _norm(_interp(attrs["nrm"], trio, rec_o["u"][bo],
                                   rec_o["v"][bo]))
            e1o = tri_pos[trio, 1] - tri_pos[trio, 0]
            e2o = tri_pos[trio, 2] - tri_pos[trio, 0]
            deto = np.sum(np.cross(d[bo], e2o) * e1o, axis=-1)
            no_ref = np.where((deto < 0)[:, None], -no_ref, no_ref)
            entry["max_normal_delta_at_oracle"] = float(
                np.abs(rec_k["n"][bo] - no_ref).max())
        if attrs is not None:
            # Fused-shading parity against manual interpolation at the
            # KERNEL's own (tri, u, v).
            tri = rec_k["tri"]
            u = rec_k["u"]
            v = rec_k["v"]
            n_ref = _norm(_interp(attrs["nrm"], tri, u, v))
            # Winding flip: det = dot(d, e1 x e2) sign.
            e1 = tri_pos[np.maximum(tri, 0), 1] - tri_pos[
                np.maximum(tri, 0), 0]
            e2 = tri_pos[np.maximum(tri, 0), 2] - tri_pos[
                np.maximum(tri, 0), 0]
            det = np.sum(np.cross(d, e2) * e1, axis=-1)
            n_ref = np.where((det < 0)[:, None], -n_ref, n_ref)
            entry["max_normal_delta"] = float(
                np.abs(rec_k["n"][both] - n_ref[both]).max())
            mk = rec_k["mat"][both]
            m_ref = attrs["mat"][np.maximum(tri, 0)][both]
            entry["mat_mismatches"] = int((mk != m_ref).sum())
            if "uv" in rec_k:
                uv_ref = _interp(attrs["uv"], tri, u, v)
                entry["max_uv_delta"] = float(np.abs(
                    rec_k["uv"][both] - uv_ref[both]).max())
                tan_ref = _norm(_interp(attrs["tan"], tri, u, v))
                entry["max_tan_delta"] = float(np.abs(
                    rec_k["tan"][both] - tan_ref[both]).max())
        if direct:
            # Only the fields both records have: the walk's has no fused
            # outputs.
            same = both & (rec_k["tri"] == rec_o["tri"])
            if "inst" in rec_k and "inst" in rec_o:
                entry["inst_matches_pct"] = float(
                    (rec_k["inst"][both] == rec_o["inst"][both]).mean()
                    * 100.0)
                same &= rec_k["inst"] == rec_o["inst"]
            for field, key in (("n", "max_normal_delta"),
                               ("tan", "max_tan_delta"),
                               ("uv", "max_uv_delta")):
                if field in rec_k and field in rec_o and same.any():
                    entry[key] = float(np.abs(rec_k[field][same]
                                              - rec_o[field][same]).max())
            if "uvd" in rec_k and "uvd" in rec_o and same.any():
                ref = rec_o["uvd"][same]
                entry["max_uvd_rel_delta"] = float(
                    (np.abs(rec_k["uvd"][same] - ref)
                     / np.maximum(np.abs(ref), 1.0)).max())
            if "mat" in rec_k and "mat" in rec_o:
                entry["mat_mismatches"] = int(
                    (rec_k["mat"][same] != rec_o["mat"][same]).sum())
    # Borderline-grazing rays may flip on fp fusion-order differences
    # between the two programs; tolerate <= 0.02% of rays, record all.
    # Deterministic (non-grazing) variants demand exact agreement.
    mismatch_budget = 0 if exact else max(2, hk.shape[0] // 5000)
    ok = (entry["hit_mismatches"] <= mismatch_budget
          and entry.get("max_t_delta", 0.0) < atol
          and entry.get("max_normal_delta", 0.0) < 5e-3
          and entry.get("max_normal_delta_at_oracle", 0.0) < 5e-3
          and entry.get("mat_mismatches", 0) == 0
          and entry.get("max_uv_delta", 0.0) < 5e-3
          and entry.get("max_uvd_rel_delta", 0.0) < 5e-3
          and entry.get("max_tan_delta", 0.0) < 5e-3)
    entry["ok"] = bool(ok)
    results[name] = entry
    print(f"{'PASS' if ok else 'FAIL'} {name}: {entry}")
    return ok


def _judge(name, rec_k, rec_p, rec_w, tri_pos, results, **kw) -> bool:
    """A variant the reference judges against its BVH walk: the kernel's
    record against its plain version's and against the walk's
    (dispatch.trace_nearest_walk, the reference's oracle), each by _compare
    with the same keywords and budgets.  The walk's entry is the field
    "walk" of the variant's entry, and the variant passes only if both
    hold."""
    ok = _compare(name, rec_k, rec_p, tri_pos, results, **kw)
    walk = {}
    ok_w = _compare(f"{name} against the walk", rec_k, rec_w, tri_pos,
                    walk, **kw)
    results[name]["walk"] = walk.popitem()[1]
    results[name]["ok"] = bool(ok and ok_w)
    return results[name]["ok"]


def _judge_hits(name, hit_k, hit_p, hit_w, results) -> bool:
    """_judge for occlusion flags (_compare_hits against the plain version
    and against dispatch.trace_any_walk)."""
    ok = _compare_hits(name, hit_k, hit_p, results)
    walk = {}
    ok_w = _compare_hits(f"{name} against the walk", hit_k, hit_w, walk)
    results[name]["walk"] = walk.popitem()[1]
    results[name]["ok"] = bool(ok and ok_w)
    return results[name]["ok"]


def walk_arrays(pos, ds, device) -> tuple:
    """Permuted (T, 3, 3) positions and (T,) double-sided flags as the
    walk's tensors on `device`."""
    return (torch.as_tensor(np.asarray(pos, np.float32), device=device),
            torch.as_tensor(np.asarray(ds, bool), device=device))


def source_ids(tri_pos) -> np.ndarray:
    """(P,) int64: each slot's source triangle, numbered by its vertices
    ((P, 3, 3) permuted positions, pad slots included).  Spatial splits put
    one triangle in several slots with identical records, so slots with the
    same vertices hold the same triangle (and two source triangles with the
    same vertices are one surface)."""
    rows = np.ascontiguousarray(np.asarray(tri_pos, np.float32).reshape(
        len(tri_pos), 9)).view(np.dtype((np.void, 36)))[:, 0]
    return np.unique(rows, return_inverse=True)[1].reshape(-1).astype(
        np.int64)


def _distinct_slots(slots: dict, source: np.ndarray) -> tuple:
    """Each ray's slots without the repeats of one triangle: a slot whose
    source triangle an earlier slot of the ray holds at the same t
    (relative 1e-6) is dropped, and the rest move up in order.  Returns
    (t, u, v, source id) as (K, N) arrays (-1 source past the distinct
    hits) and the distinct hits per ray."""
    k, n = slots["t"].shape
    src = np.where(slots["tri"] >= 0, source[np.maximum(slots["tri"], 0)],
                   -1)
    keep = src >= 0
    for j in range(1, k):
        for i in range(j):
            keep[j] &= ~((src[i] == src[j]) & (np.abs(
                slots["t"][i] - slots["t"][j]) <= 1e-6 * np.maximum(
                    np.abs(slots["t"][j]), 1.0)))
    order = np.argsort(~keep, axis=0, kind="stable")
    out = tuple(np.take_along_axis(x, order, axis=0)
                for x in (slots["t"], slots["u"], slots["v"],
                          np.where(keep, src, -1)))
    return out, keep.sum(axis=0)


def _compare_slots_by_source(name, slots_k, slots_o, source, results):
    """Multi-hit slots over spatial-split tables: kernel against plain
    version by source triangle.  A hit on a triangle that several slots
    hold fills one slot per copy the walk reaches, and the walk reaches the
    copies whose leaf boxes the ray enters before its bound, while the
    plain version, by brute force, finds every copy.  So each ray's lists
    are compared without repeats (_distinct_slots): over the distinct hits
    both have, in order, the source ids agree (or |delta t| < 2e-3, an
    exact tie) with |delta t| < 2e-3, and u, v within 5e-3 where the ids
    agree; a list that does not fill its K slots (the ray ran out of
    surfaces) must hold at least as many distinct hits as the other.  At
    most max(2, N K / 5000) rays may disagree."""
    slots_k = _numpy(slots_k)
    slots_o = _numpy(slots_o)
    k, n = slots_o["t"].shape
    (tk, uk, vk, sk), mk = _distinct_slots(slots_k, source)
    (to, uo, vo, so), mo = _distinct_slots(slots_o, source)
    common = np.arange(k)[:, None] < np.minimum(mk, mo)[None]
    dt = np.where(common, np.abs(tk - to), 0.0)
    same = common & (sk == so)
    bad = (common & (sk != so) & (dt >= 2e-3)).any(axis=0)
    short_k = slots_k["tri"][k - 1] < 0
    short_o = slots_o["tri"][k - 1] < 0
    bad |= (short_k & (mk < mo)) | (short_o & (mo < mk))
    entry = {"rays": int(n), "k": int(k),
             "ray_mismatches": int(bad.sum()),
             "distinct_hits": int(mk.sum()),
             "distinct_hits_plain": int(mo.sum()),
             "repeats_kernel": int((slots_k["tri"] >= 0).sum() - mk.sum()),
             "repeats_plain": int((slots_o["tri"] >= 0).sum() - mo.sum()),
             "max_t_delta": float(dt[common & ~bad[None]].max())
             if (common & ~bad[None]).any() else 0.0,
             "max_uv_delta_same_tri": (float(max(
                 np.abs(uk - uo)[same].max(), np.abs(vk - vo)[same].max()))
                 if same.any() else 0.0)}
    entry["ok"] = bool(entry["ray_mismatches"] <= max(2, n * k // 5000)
                       and entry["max_t_delta"] < 2e-3
                       and entry["max_uv_delta_same_tri"] < 5e-3)
    results[name] = entry
    print(f"{'PASS' if entry['ok'] else 'FAIL'} {name}: {entry}")
    return entry["ok"]


def _compare_slots(name, slots_k, slots_o, results):
    """Multi-hit slots, kernel against plain version (kernel_parity.py:
    518-542): at most max(2, N K / 5000) slots hit in one and not the other,
    |delta t| < 2e-3 where both hit, u and v within 5e-3 where the slot's
    tri ids agree (tie order and grazing edges may swap slots)."""
    slots_k = _numpy(slots_k)
    slots_o = _numpy(slots_o)
    k, n = slots_o["t"].shape
    hk = slots_k["tri"] >= 0
    ho = slots_o["tri"] >= 0
    both = hk & ho
    same = both & (slots_k["tri"] == slots_o["tri"])
    entry = {"rays": int(n), "k": int(k),
             "slot_mismatches": int((hk != ho).sum()),
             "slots_hit": int(hk.sum()),
             "max_t_delta": (float(np.abs(slots_k["t"][both]
                                          - slots_o["t"][both]).max())
                             if both.any() else 0.0),
             "max_uv_delta_same_tri": (float(max(
                 np.abs(slots_k["u"][same] - slots_o["u"][same]).max(),
                 np.abs(slots_k["v"][same] - slots_o["v"][same]).max()))
                 if same.any() else 0.0)}
    entry["ok"] = bool(entry["slot_mismatches"] <= max(2, n * k // 5000)
                       and entry["max_t_delta"] < 2e-3
                       and entry["max_uv_delta_same_tri"] < 5e-3)
    results[name] = entry
    print(f"{'PASS' if entry['ok'] else 'FAIL'} {name}: {entry}")
    return entry["ok"]


def _compare_hits(name, hit_k, hit_o, results):
    """Occlusion flags, kernel against oracle: at most max(2, N/5000)
    mismatches (kernel_parity.py:308-313)."""
    hit_k = _numpy({"h": hit_k})["h"]
    hit_o = _numpy({"h": hit_o})["h"]
    mm = int((hit_k != hit_o).sum())
    entry = {"rays": int(hit_k.shape[0]), "hit_mismatches": mm,
             "hits": int(hit_k.sum()),
             "ok": mm <= max(2, hit_k.shape[0] // 5000)}
    results[name] = entry
    print(f"{'PASS' if entry['ok'] else 'FAIL'} {name}: {entry}")
    return entry["ok"]


# ---------------------------------------------------------------------------
# Inputs, shared by the CPU tests and the card's parity run
# ---------------------------------------------------------------------------

def _soup_draws(n_tris: int):
    """The soup's (T, 3, 3) positions, its double-sided flags (30%) and
    the generator that drew the flags, positioned for the shading draws
    that follow them in the reference."""
    r = np.random.default_rng(2)
    return _soup(n_tris, 1), r.uniform(size=n_tris) < 0.3, r


def soup_inputs(n_tris: int):
    """The soup's (T, 3, 3) positions and its double-sided flags (30%)."""
    tris, ds, _ = _soup_draws(n_tris)
    return tris, ds


def soup_case(n_tris: int, n_rays: int, device, leaf_size: int = 24,
              textured: bool = False, dense_anyhit: bool = False):
    """The reference's flat soup (kernel_parity.py:242-264): 30% double-
    sided triangles, random normals, tangents, uvs and material ids, random
    rays.  Returns (tables with shade rows of mode 1, or mode 2 when
    `textured`, and dense any-hit tables when `dense_anyhit`; permuted
    arrays; o; d)."""
    from steeljax_torch.accel.bvh import apply_permutation
    from steeljax_torch.accel.dispatch import (attach_shade_tables,
                                               prepare_tables)

    tris, ds, r = _soup_draws(n_tris)
    o, d = _rays(n_rays, 3)
    tables, order, padded = prepare_tables(tris, ds, device,
                                           leaf_size=leaf_size,
                                           dense_anyhit=dense_anyhit)
    perm = apply_permutation((None, order, padded), {
        "pos": tris, "ds": ds,
        "nrm": _norm(r.normal(size=(n_tris, 3, 3))).astype(np.float32),
        "tan": _norm(r.normal(size=(n_tris, 3, 3))).astype(np.float32),
        "uv": r.uniform(size=(n_tris, 3, 2)).astype(np.float32),
        "mat": r.integers(0, 7, n_tris).astype(np.int32)})
    tables = attach_shade_tables(tables, perm["nrm"], perm["mat"], textured,
                                 tri_tan=perm["tan"], tri_uv=perm["uv"])
    return tables, perm, o, d


def alpha_soup_inputs(n_tris: int, fine: bool = False):
    """The inputs of alpha_soup_case: the soup's (T, 3, 3) positions and
    double-sided flags, random coarse alpha masks (every 21-bit value
    equally likely) and, with `fine`, random two-plane fine masks (PASS bits
    set with probability 3/4, OPAQUE 3/8; kernel_parity.py:341-345,
    :446-457), else None."""
    from steeljax_torch.accel.alphamask import MASK_FULL

    tris, ds = soup_inputs(n_tris)
    r = np.random.default_rng(5)
    coarse = r.integers(0, MASK_FULL + 1, n_tris).astype(np.uint32)
    fine_masks = None
    if fine:
        words = (r.integers(0, 1 << 31, (n_tris, 10), dtype=np.int64)
                 | r.integers(0, 1 << 31, (n_tris, 10), dtype=np.int64))
        words[:, 5:] &= r.integers(0, 1 << 31, (n_tris, 5), dtype=np.int64)
        fine_masks = words.astype(np.int32)
    return tris, ds, coarse, fine_masks


def alpha_soup_case(n_tris: int, device, fine: bool = False,
                    snode_width: int = 8):
    """kernel_parity's soup with the masks of alpha_soup_inputs, at
    supernode width `snode_width`.  Returns (tables, permuted {"pos",
    "ds"})."""
    from steeljax_torch.accel.bvh import apply_permutation
    from steeljax_torch.accel.dispatch import prepare_tables

    tris, ds, coarse, fine_masks = alpha_soup_inputs(n_tris, fine)
    tables, order, padded = prepare_tables(
        tris, ds, device, leaf_size=24, tri_alpha_mask=coarse,
        tri_fine_mask=fine_masks, snode_width=snode_width)
    return tables, apply_permutation((None, order, padded),
                                     {"pos": tris, "ds": ds})


def deterministic_case(device):
    """Axis-aligned quad stack and perpendicular interior rays
    (kernel_parity.py:372-401): no grazing hits, so any disagreement is a
    real fault.  Returns (tables, permuted positions, o, d)."""
    from steeljax_torch.accel.bvh import apply_permutation
    from steeljax_torch.accel.dispatch import prepare_tables

    dq = []
    for i in range(48):
        z = -0.5 * i
        dq.append([[-8, -8, z], [8, -8, z], [8, 8, z]])
        dq.append([[-8, -8, z], [8, 8, z], [-8, 8, z]])
    dq = np.asarray(dq, np.float32)
    dds = np.ones(len(dq), bool)
    g = 32
    xs, ys = np.meshgrid(np.linspace(-7, 7, g) + 0.0031,
                         np.linspace(-7, 7, g) + 0.0077)
    o = np.stack([xs.ravel(), ys.ravel(), np.full(g * g, 5.0)],
                 axis=-1).astype(np.float32)
    d = np.tile(np.array([0, 0, -1], np.float32), (g * g, 1))
    tables, order, padded = prepare_tables(dq, dds, device, leaf_size=24)
    perm = apply_permutation((None, order, padded), {"pos": dq})
    return tables, perm["pos"], o, d


def cornell_cases(device, width: int, height: int, sphere_detail: int = 12):
    """The main path's own trace inputs: the Cornell scene's jittered
    primary rays (accumulation index 0) and the first-bounce rays the
    integrator derives from their hits (dead lanes included).  Returns
    (flat, tables, {"primary": (o, d, t_min, t_max), "bounce1": ...})
    with tensors on `device`; the bounce rays come from one trace on
    `device`."""
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.core import rng
    from steeljax_torch.render.pt.integrator import primary_rays
    from steeljax_torch.render.pt.renderer import prepare_scene
    from steeljax_torch.scene.builtin import make_cornell_scene

    scene = make_cornell_scene(sphere_detail=sphere_detail)
    flat, tables = prepare_scene(scene, device, env_resolution=16)
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    px = torch.as_tensor(xs.reshape(-1), device=device)
    py = torch.as_tensor(ys.reshape(-1), device=device)
    seed = rng.make_seed(px, py, 0, 0)
    o, d, seed = primary_rays(frame.inverse_view, frame.inverse_proj,
                              width, height, px, py, seed)
    o = o.contiguous()
    near, far = frame.camera_near, frame.camera_far
    return flat, tables, {"primary": (o, d, near, far),
                          "bounce1": _bounce_rays(flat, tables, o, d, near,
                                                  far, seed)}


def _bounce_rays(flat, tables, o, d, near, far, seed):
    """The rays of the integrator's second bounce from the primaries (o, d)
    and their rng `seed`: one trace, the BRDF sample at each hit (after the
    light sample of next-event estimation, which comes first in the rng
    stream of a lit scene), dead lanes with an inverted interval, and on
    scenes above integrator.REPACK_MIN_TRIS the repack that trace_paths
    applies before that bounce.  Returns (o, d, t_min, t_max)."""
    from steeljax_torch.core.constants import (EPSILON, RAY_DEAD_T,
                                               RAY_MAX_T, RAY_MIN_T)
    from steeljax_torch.render.pt import brdf as brdf_lib
    from steeljax_torch.render.pt import integrator, stages

    rec = integrator.trace_material_ray(flat, tables, o, d, near, far,
                                        cull_backface=True)
    surface, tbn = integrator.unpack_material(flat, tables, rec, d)
    if flat.light_count > 0:
        _, seed = stages.sample_light(flat, tbn[2],
                                      o + d * rec["t"][:, None], seed)
    wo = brdf_lib._normalize(brdf_lib.world_to_tangent(-d, tbn))
    f, wi, pdf, _ = brdf_lib.sample_brdf(brdf_lib.make_surface(**surface),
                                         wo, seed)
    alive = rec["hit"] & (pdf >= EPSILON) & ((f * f).sum(-1) >= EPSILON)
    o1 = (o + d * rec["t"][:, None]).contiguous()
    d1 = torch.where(alive[:, None], brdf_lib.tangent_to_world(wi, tbn), d)
    if integrator._total_triangles(tables) > integrator.REPACK_MIN_TRIS:
        key = (((~alive).to(torch.int32) << 19)
               | ((~rec["hit"]).to(torch.int32) << 18)
               | integrator._ray_sort_key(o1, d1,
                                          *integrator.scene_bounds(tables)))
        key, (o1, d1) = integrator.repack_rays(key, [o1, d1])
        alive = (key >> 19) == 0
    t_min1 = torch.full_like(o1[:, 0], RAY_MIN_T)
    t_max1 = torch.where(alive, RAY_MAX_T, RAY_DEAD_T).to(torch.float32)
    return o1.contiguous(), d1.contiguous(), t_min1, t_max1


def first_bounce_case(scene, flat, tables, width: int, height: int):
    """The second bounce's rays of a prepared path as the integrator traces
    them (_bounce_rays of the tiled primaries of accumulation index 0):
    (o, d, t_min, t_max)."""
    o, d, near, far, seed = tiled_primary(scene, flat.device, width, height)
    return _bounce_rays(flat, tables, o, d, near, far, seed)


def prepare_path_scene(name: str, device):
    """One of the slices' big paths, prepared on `device` as a user would,
    at env_resolution 64: (scene, flat, tables).  "sunlit" is the sunlit
    stress scene (path L: 208,084 triangles and a sun), "sunlit_dense" the
    same with the dense any-hit tables, "stress_tex" the textured stress
    scene (path T, the JAX bench's stress_tex: 1,320,868 triangles);
    "foliage" and "foliage_solid" are the JAX bench's foliage scenes (paths
    F and S: make_foliage_scene(cards=500_000), serrated and solid leaves,
    1,000,002 triangles, coarse and fine alpha masks), "foliage_multihit"
    path F prepared with multihit_k = FOLIAGE_MULTIHIT_K (the K-nearest
    kernel K5 in K4's place).  "sunlit_inst" and "stress_tex_inst" are the
    sunlit and the textured stress scene through the two-level structure
    (paths I and J: kernel K6 over 310 and 490 instances of three BLAS),
    "stress_tex_treelets" and "sunlit_treelets" the same scenes prepared
    with treelets=True (paths U and UL: kernel K7).  "sunlit_chunked" is
    the sunlit stress scene at CHUNKED_INSTANCES instances of sphere detail
    32 (path C: 2,633,508 triangles, two chunks at MAX_CHUNK_TRIS),
    "sunlit_one_chunk" the same scene in one chunk (dispatch.MAX_CHUNK_TRIS
    raised above any triangle count for the call: path C's reference),
    "sunlit_w16" path L's scene with snode_width=16 (path L16)."""
    from steeljax_torch.accel import dispatch
    from steeljax_torch.accel.instances import InstancedAccel
    from steeljax_torch.render.pt.renderer import prepare_scene

    scene = make_path_scene(name)
    max_chunk = dispatch.MAX_CHUNK_TRIS
    if name == "sunlit_one_chunk":
        dispatch.MAX_CHUNK_TRIS = np.iinfo(np.int32).max
    try:
        flat, tables = prepare_scene(
            scene, device, env_resolution=64,
            dense_anyhit=name == "sunlit_dense",
            multihit_k=(FOLIAGE_MULTIHIT_K if name == "foliage_multihit"
                        else 0),
            accel=(InstancedAccel(device=device) if name in INSTANCED_SCENES
                   else None),
            treelets=name in TREELET_SCENES,
            snode_width=16 if name == "sunlit_w16" else 8)
    finally:
        dispatch.MAX_CHUNK_TRIS = max_chunk
    return scene, flat, tables


def make_path_scene(name: str):
    """The scene of one of prepare_path_scene's paths."""
    from steeljax_torch.scene.builtin import (make_foliage_scene,
                                              make_stress_scene,
                                              make_sunlit_stress_scene)

    if name.startswith("stress_tex"):
        return make_stress_scene(instances=480, sphere_detail=32,
                                 textured=True)
    if name in FOLIAGE_SCENES:
        return make_foliage_scene(cards=FOLIAGE_CARDS,
                                  serrated=name != "foliage_solid")
    if name in ("sunlit_chunked", "sunlit_one_chunk"):
        return make_sunlit_stress_scene(instances=CHUNKED_INSTANCES,
                                        sphere_detail=32)
    return make_sunlit_stress_scene()


def move_entity(scene) -> None:
    """The scene edit of the instanced paths: translate the last renderable
    entity by 0.5 along y and bump the scene's revision."""
    entity = scene.entities[scene.renderable_entities()[-1]]
    moved = np.array(entity.local_transform, np.float32)
    moved[1, 3] += 0.5
    entity.local_transform = moved
    scene.revision += 1


PATH_SCENES = ("sunlit", "sunlit_dense", "stress_tex")
FOLIAGE_SCENES = ("foliage", "foliage_solid", "foliage_multihit")
INSTANCED_SCENES = ("sunlit_inst", "stress_tex_inst")
TREELET_SCENES = ("stress_tex_treelets", "sunlit_treelets")
# Path C's scene above one chunk, the same scene in one chunk, and path L
# at supernode width 16.
CHUNKED_SCENES = ("sunlit_chunked", "sunlit_one_chunk", "sunlit_w16")
CHUNKED_INSTANCES = 960
# The JAX bench's foliage configs (bench.py:189-210).
FOLIAGE_CARDS = 500_000
FOLIAGE_MULTIHIT_K = 4


def tiled_primary(scene, device, width: int, height: int):
    """The jittered primary rays of accumulation index 0 in the render
    path's tile order: (o, d, t_min, t_max, seed) on `device`."""
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.core import rng
    from steeljax_torch.render.pt.integrator import primary_rays, tiled_order

    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    px, py, _ = tiled_order(width, height)
    px = torch.as_tensor(px, device=device).to(torch.int64)
    py = torch.as_tensor(py, device=device).to(torch.int64)
    o, d, seed = primary_rays(frame.inverse_view, frame.inverse_proj, width,
                              height, px, py, rng.make_seed(px, py, 0, 0))
    return o.contiguous(), d, frame.camera_near, frame.camera_far, seed


def sunlit_shadow_case(scene, flat, tables, width: int, height: int):
    """The shadow rays the integrator traces at the primary hits of the lit
    scene (bounce 0 of its bounce loop): (o, d, t_min, t_max), every lane
    as the integrator traces it."""
    from steeljax_torch.render.pt.integrator import (trace_material_ray,
                                                     unpack_material)
    from steeljax_torch.render.pt.stages import sample_light, shadow_rays

    o, d, near, far, seed = tiled_primary(scene, flat.device, width, height)
    rec = trace_material_ray(flat, tables, o, d, near, far,
                             cull_backface=True)
    _, tbn = unpack_material(flat, tables, rec, d)
    p = o + d * rec["t"][:, None]
    light, _ = sample_light(flat, tbn[2], p, seed)
    so, sd, t_min, t_max = shadow_rays(p, tbn[2], light)
    return so.contiguous(), sd.contiguous(), t_min, t_max


def foliage_shadow_case(scene, flat, tables, width: int, height: int):
    """The sun rays the integrator traces at the primary hits of an
    alpha-tested scene (bounce 0), each lane as the integrator traces it:
    (o, d, t_min, t_max).  The primaries resolve through the alpha
    re-trace, the shading through tri_shade rows."""
    from steeljax_torch.render.pt.integrator import (trace_material_ray,
                                                     unpack_material)
    from steeljax_torch.render.pt.stages import sample_light, shadow_rays

    o, d, near, far, seed = tiled_primary(scene, flat.device, width, height)
    rec = trace_material_ray(flat, tables, o, d, near, far,
                             cull_backface=True)
    _, tbn = unpack_material(flat, tables, rec, d)
    p = o + d * rec["t"][:, None]
    light, _ = sample_light(flat, tbn[2], p, seed)
    so, sd, t_min, t_max = shadow_rays(p, tbn[2], light)
    return so.contiguous(), sd.contiguous(), t_min, t_max


def strided_subset(rays, limit: int):
    """Every k-th ray of (o, d, t_min, t_max), at most `limit` of them, so
    the subset spans the whole frame."""
    o, d, t_min, t_max = rays
    step = -(-o.shape[0] // limit)

    def take(x):
        return x[::step].contiguous() if isinstance(x, torch.Tensor) else x

    return tuple(take(x) for x in (o, d, t_min, t_max))


# The JAX bench's hybrid frame size (bench.py:213-260).
HYBRID_WIDTH, HYBRID_HEIGHT = 1920, 1080


def hybrid_rays(scene, device, width: int, height: int):
    """The hybrid frame's pixel-centre rays in the renderer's tile order
    and what the G-buffer needs beside them: (o, d, near, far, uv,
    view_proj, camera_position, inverse_proj_view, pixel_spread), tensors
    on `device`."""
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.render.hybrid.renderer import pixel_center_rays
    from steeljax_torch.render.pt.integrator import tiled_order

    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    px, py, _ = tiled_order(width, height)
    iv, ip, vp = (torch.as_tensor(m, device=device) for m in (
        frame.inverse_view, frame.inverse_proj, frame.view_proj))
    o, d, uv = pixel_center_rays(iv, ip, width, height,
                                 torch.as_tensor(px, device=device),
                                 torch.as_tensor(py, device=device))
    return (o.contiguous(), d, frame.camera_near, frame.camera_far, uv, vp,
            iv[:3, 3], iv @ ip, 2.0 * ip[1, 1].abs() / height)


def hybrid_shadow_case(scene, flat, tables, width: int, height: int):
    """The sun rays the hybrid lighting stage traces (lighting.shadow_rays
    of the scene's first light at the G-buffer's positions and normals,
    sky and unlit pixels dead): (o, d, t_min, t_max)."""
    from steeljax_torch.render.hybrid.gbuffer import generate_gbuffer
    from steeljax_torch.render.hybrid.lighting import (light_terms,
                                                       restore_position,
                                                       shadow_rays)

    o, d, near, far, uv, vp, cam, ipv, spread = hybrid_rays(
        scene, flat.device, width, height)
    gb = generate_gbuffer(flat, tables, o, d, near, far, vp, cam,
                          pixel_spread=spread)
    position = restore_position(gb["depth"], uv, ipv)
    n = gb["normal"] * 2.0 - 1.0
    l, distance, _, _, irradiance, _ = light_terms(flat, 0, position, n)
    so, sd, t_min, t_max = shadow_rays(position, n, l, distance, irradiance,
                                       gb["hit"])
    return so.contiguous(), sd.contiguous(), t_min, t_max


# The parity subsets of the big paths' rays (the plain versions are
# brute force).
SHADOW_SUBSET = 32768
TEX_SUBSET = 4096
FOLIAGE_SUBSET = 4096


# ---------------------------------------------------------------------------
# The card's parity run
# ---------------------------------------------------------------------------

def _alpha_variants(device, tables, o, d, n_tris: int, variants) -> bool:
    """K4 (nearest, cull on, and any-hit, with coarse and with coarse and
    fine masks) and K5 (K = 4 on the first 2048 rays: no masks, coarse,
    coarse and fine) on the soup, kernel against plain version
    (kernel_parity.py:341-370, :446-542)."""
    from steeljax_torch.accel.cuda_traverse import (
        trace_any_bvh8, trace_any_bvh8_plain, trace_multihit_bvh8,
        trace_multihit_bvh8_plain, trace_nearest_bvh8,
        trace_nearest_bvh8_plain)
    from steeljax_torch.accel.dispatch import (trace_any_walk,
                                               trace_nearest_walk)

    ok = True
    mtables, mperm = alpha_soup_case(n_tris, device)
    ftables, fperm = alpha_soup_case(n_tris, device, fine=True)
    for label, tab, perm in (("alpha_mask", mtables, mperm),
                             ("fine_mask", ftables, fperm)):
        chunk = tab.chunks[0]
        kw = dict(alpha_mask=True, fine_rows=chunk.fine_mask_rows)
        # The reference's walk has no fine plane: it is the oracle of the
        # coarse variants only (:341-370), as here.
        arrays = (walk_arrays(perm["pos"], perm["ds"], device)
                  if label == "alpha_mask" else None)
        args = (chunk.bvh8, chunk.tris_packed, o, d, 0.001, 1000.0, True,
                None, 0)
        rec_k = trace_nearest_bvh8(*args, **kw)
        rec_p = trace_nearest_bvh8_plain(*args, **kw)
        torch.cuda.synchronize(device)
        if arrays:
            ok &= _judge(f"flat_{label}", rec_k, rec_p, trace_nearest_walk(
                tab, *arrays, o, d, 0.001, 1000.0, True), perm["pos"],
                variants)
        else:
            ok &= _compare(f"flat_{label}", rec_k, rec_p, perm["pos"],
                           variants)
        args = (chunk.bvh8, chunk.tris_packed, o, d, 0.001, 40.0, False)
        hit_k = trace_any_bvh8(*args, **kw)
        hit_p = trace_any_bvh8_plain(*args, **kw)
        torch.cuda.synchronize(device)
        if arrays:
            ok &= _judge_hits(f"flat_{label}_anyhit", hit_k, hit_p,
                              trace_any_walk(tab, *arrays, o, d, 0.001,
                                             40.0), variants)
        else:
            ok &= _compare_hits(f"flat_{label}_anyhit", hit_k, hit_p,
                                variants)
    for label, tab in (("flat_multihit", tables),
                       ("flat_multihit_masked", mtables),
                       ("flat_multihit_fine", ftables)):
        chunk = tab.chunks[0]
        kw = dict(alpha_mask=tab.alpha_masked,
                  fine_rows=chunk.fine_mask_rows)
        args = (chunk.bvh8, chunk.tris_packed, o[:2048], d[:2048], 0.001,
                1000.0, 4, True)
        slots_k = trace_multihit_bvh8(*args, **kw)
        slots_p = trace_multihit_bvh8_plain(*args, **kw)
        torch.cuda.synchronize(device)
        ok &= _compare_slots(label, slots_k, slots_p, variants)
    return ok


def _chunked_width16_variants(device, tables, perm, o, d, n_tris: int,
                              variants, walk, hit_walk) -> bool:
    """The reference's multi-chunk and 16-wide variants (kernel_parity.py:
    403-443) and the 16-wide cases of the port's other instances of the
    walk: `chunked_shade0` (the soup cut into chunks of n_tris // 3, traced
    through dispatch's sweep, K1 on every chunk, against the plain version
    over the one-chunk tables; tri ids index other permutations and are
    blanked, as the reference blanks them), `chunked_anyhit` (K2 on every
    chunk), `flat_shade0_width16` (K1 over 16-wide rows), `anyhit_width16`
    (K2), `alpha_width16` (K4 nearest with coarse and fine masks) and
    `multihit_width16` (K5, K = 4, on the first 2048 rays), each against
    its plain version.  As in the reference, chunked_shade0 and
    chunked_anyhit are judged against the walk over the one-chunk tables
    too (`walk`, `hit_walk`), and flat_shade0_width16 against the walk
    over the 16-wide tables' binary tree."""
    from steeljax_torch.accel.bvh import apply_permutation
    from steeljax_torch.accel.cuda_traverse import (
        trace_any_bvh8, trace_any_bvh8_plain, trace_multihit_bvh8,
        trace_multihit_bvh8_plain, trace_nearest_bvh8,
        trace_nearest_bvh8_plain)
    from steeljax_torch.accel.dispatch import (prepare_tables, trace_any,
                                               trace_nearest,
                                               trace_nearest_walk)

    ok = True
    tris, ds = soup_inputs(n_tris)
    chunk = tables.chunks[0]
    ctables, _, _ = prepare_tables(tris, ds, device, leaf_size=24,
                                   max_chunk=n_tris // 3)
    if len(ctables.chunks) < 2:
        raise RuntimeError("the chunked soup has one chunk")
    rec_k = dict(trace_nearest(ctables, o, d, 0.001, 1000.0, True))
    rec_p = trace_nearest_bvh8_plain(chunk.bvh8, chunk.tris_packed, o, d,
                                     0.001, 1000.0, True)
    torch.cuda.synchronize(device)
    rec_w = dict(walk)
    for rec in (rec_k, rec_p, rec_w):
        rec["tri"] = torch.full_like(rec["tri"], -2)
    ok &= _judge("chunked_shade0", rec_k, rec_p, rec_w, perm["pos"],
                 variants)
    variants["chunked_shade0"]["chunks"] = len(ctables.chunks)
    hit_k = trace_any(ctables, o, d, 0.001, 40.0)
    hit_p = trace_any_bvh8_plain(chunk.bvh8, chunk.tris_packed, o, d, 0.001,
                                 40.0)
    torch.cuda.synchronize(device)
    ok &= _judge_hits("chunked_anyhit", hit_k, hit_p, hit_walk, variants)

    wtables, worder, wpadded = prepare_tables(tris, ds, device, leaf_size=24,
                                              snode_width=16)
    wchunk = wtables.chunks[0]
    if wchunk.bvh8.width != 16:
        raise RuntimeError("the 16-wide soup has other rows")
    wperm = apply_permutation((None, worder, wpadded),
                              {"pos": tris, "ds": ds})
    args = (wchunk.bvh8, wchunk.tris_packed, o, d, 0.001, 1000.0, True)
    rec_k = trace_nearest_bvh8(*args, records=wchunk.tri_records)
    rec_p = trace_nearest_bvh8_plain(*args)
    torch.cuda.synchronize(device)
    rec_w = trace_nearest_walk(wtables, *walk_arrays(wperm["pos"],
                                                     wperm["ds"], device),
                               o, d, 0.001, 1000.0, True)
    ok &= _judge("flat_shade0_width16", rec_k, rec_p, rec_w, wperm["pos"],
                 variants)
    args = (wchunk.bvh8, wchunk.tris_packed, o, d, 0.001, 40.0)
    hit_k = trace_any_bvh8(*args, records=wchunk.tri_records)
    hit_p = trace_any_bvh8_plain(*args)
    torch.cuda.synchronize(device)
    ok &= _compare_hits("anyhit_width16", hit_k, hit_p, variants)

    ftables, fperm = alpha_soup_case(n_tris, device, fine=True,
                                     snode_width=16)
    fchunk = ftables.chunks[0]
    kw = dict(alpha_mask=True, fine_rows=fchunk.fine_mask_rows)
    args = (fchunk.bvh8, fchunk.tris_packed, o, d, 0.001, 1000.0, True,
            None, 0)
    rec_k = trace_nearest_bvh8(*args, **kw)
    rec_p = trace_nearest_bvh8_plain(*args, **kw)
    torch.cuda.synchronize(device)
    ok &= _compare("alpha_width16", rec_k, rec_p, fperm["pos"], variants)
    args = (fchunk.bvh8, fchunk.tris_packed, o[:2048], d[:2048], 0.001,
            1000.0, 4, True)
    slots_k = trace_multihit_bvh8(*args, **kw)
    slots_p = trace_multihit_bvh8_plain(*args, **kw)
    torch.cuda.synchronize(device)
    ok &= _compare_slots("multihit_width16", slots_k, slots_p, variants)
    return ok


def foliage_cases(scene, flat, tables, width: int, height: int):
    """Path F's own trace inputs on a strided subset: its primary rays,
    as the render path tiles them, and its first-bounce sun rays:
    {"primary": (o, d, t_min, t_max), "shadow": ...}."""
    primary = tiled_primary(scene, flat.device, width, height)[:4]
    return {"primary": strided_subset(primary, FOLIAGE_SUBSET),
            "shadow": strided_subset(
                foliage_shadow_case(scene, flat, tables, width, height),
                FOLIAGE_SUBSET)}


def _foliage_variants(device, scenes, width, height, variants) -> bool:
    """K4 with fine masks on path F's primaries (cull on) and first-bounce
    sun rays (cull off), and K5 (K = 4) on its primaries, kernel against
    plain version."""
    from steeljax_torch.accel.cuda_traverse import (
        trace_multihit_bvh8, trace_multihit_bvh8_plain, trace_nearest_bvh8,
        trace_nearest_bvh8_plain)

    scene, flat, tables = scenes["foliage"]
    chunk = tables.chunks[0]
    kw = dict(alpha_mask=True, fine_rows=chunk.fine_mask_rows)
    cases = foliage_cases(scene, flat, tables, width, height)
    ok = True
    for name, cull in (("primary", True), ("shadow", False)):
        args = (chunk.bvh8, chunk.tris_packed, *cases[name], cull, None, 0)
        rec_k = trace_nearest_bvh8(*args, **kw)
        rec_p = trace_nearest_bvh8_plain(*args, **kw)
        torch.cuda.synchronize(device)
        ok &= _compare(f"foliage_{name}", rec_k, rec_p, None, variants)
    args = (chunk.bvh8, chunk.tris_packed, *cases["primary"],
            FOLIAGE_MULTIHIT_K, True)
    slots_k = trace_multihit_bvh8(*args, **kw)
    slots_p = trace_multihit_bvh8_plain(*args, **kw)
    torch.cuda.synchronize(device)
    ok &= _compare_slots("foliage_multihit", slots_k, slots_p, variants)
    return ok


def instanced_case(device, variant: str = "cornell"):
    """Scene and two-level tables of the instanced variants on `device`:
    "cornell" is the reference's (Cornell at sphere detail 8, leaf size 24,
    shade mode 1; its lamp is non-uniformly scaled); "edited" adds a
    non-uniformly scaled sphere and a mirrored one (negative determinant);
    "textured" is the small textured stress scene (27 instances, shade mode
    2) with the same two added.  Returns (scene, tables)."""
    from steeljax_torch.accel.instances import InstancedAccel
    from steeljax_torch.scene.builtin import (_trs, make_cornell_scene,
                                              make_stress_scene)
    from steeljax_torch.scene.scene import Entity, RenderObject

    if variant == "textured":
        scene = make_stress_scene(27, 8, textured=True)
    else:
        scene = make_cornell_scene(sphere_detail=8)
    if variant != "cornell":
        sphere = 2  # make_cornell_scene's primitives: quad, box, sphere
        scene.add_entity(Entity(
            name="squashed", render_objects=[RenderObject(sphere, 5)],
            local_transform=_trs((0.5, 1.0, 0.3), (0, 1, 0), 0.7,
                                 (1.5, 0.5, 0.8))))
        scene.add_entity(Entity(
            name="mirrored", render_objects=[RenderObject(sphere, 4)],
            local_transform=_trs((-0.8, 1.2, 0.0), None, 0.0,
                                 (-0.7, 0.7, 0.7))))
    return scene, InstancedAccel(device=device).prepare(scene)


def treelet_soup_case(n_tris: int, device, textured: bool | None = None,
                      alpha: bool = False):
    """kernel_parity's soup at leaf size 24 cut into treelets of at most
    4,096 triangles (kernel_parity.py:568-585): (treelet tables, permuted
    arrays).
    `textured` None leaves shade mode 0, else attaches the shade stack of
    mode 1 (False) or 2 (True); `alpha` bakes alpha_soup_case's random
    coarse masks into the records."""
    from steeljax_torch.accel import treelets as treelets_lib
    from steeljax_torch.accel.alphamask import MASK_FULL
    from steeljax_torch.accel.bvh import apply_permutation, build_bvh
    from steeljax_torch.accel.cuda_traverse import (pack_shade_records,
                                                    pack_tris)

    tris = _soup(n_tris, 1)
    r = np.random.default_rng(2)
    ds = r.uniform(size=n_tris) < 0.3
    arrays = {"pos": tris, "ds": ds,
              "nrm": _norm(r.normal(size=(n_tris, 3, 3))).astype(np.float32),
              "tan": _norm(r.normal(size=(n_tris, 3, 3))).astype(np.float32),
              "uv": r.uniform(size=(n_tris, 3, 2)).astype(np.float32),
              "mat": r.integers(0, 7, n_tris).astype(np.int32)}
    if alpha:
        arrays["mask"] = np.random.default_rng(5).integers(
            0, MASK_FULL + 1, n_tris).astype(np.uint32)
    bvh, order, padded = build_bvh(tris, 24)
    perm = apply_permutation((None, order, padded), arrays)
    packed = pack_tris(perm["pos"], perm["ds"],
                       tri_alpha_mask=perm.get("mask"))
    tt = treelets_lib.build_treelet_tables(bvh.nodes, packed, 24, device,
                                           max_tris=4096)
    tt = tt.replace(alpha_mask=alpha)
    if textured is not None:
        tt = treelets_lib.attach_shade_stack(tt, pack_shade_records(
            perm["nrm"], perm["mat"], textured, tri_tan=perm["tan"],
            tri_uv=perm["uv"]), 2 if textured else 1)
    return tt, perm


def plain_round(tt, cull_backface: bool = True, any_hit: bool = False,
                block: int | None = None):
    """A `trace_fn` for treelets.trace_treelets: the scheduler then runs the
    plain version of the treelet kernel K7 and of its pick in every round
    (cuda_traverse.trace_treelet_round_plain with the plain walks), on any
    device."""
    from steeljax_torch.accel import cuda_traverse, treelets as treelets_lib

    block = block or treelets_lib.PACKET_RAYS

    def trace(pid, o, d, t_min, t_max):
        return cuda_traverse.treelet_walk_plain(
            tt, pid, o, d, t_min, t_max, block, cull_backface, any_hit)

    return trace


def _instanced_variants(device, n_rays: int, variants) -> bool:
    """K6 against its plain version: the reference's instanced_fused and
    instanced_anyhit, and shade modes 0 and 2 over scenes with a
    non-uniformly scaled and a mirrored instance."""
    import dataclasses

    from steeljax_torch.accel.cuda_traverse import (
        trace_nearest_bvh8_inst, trace_nearest_bvh8_inst_plain)
    from steeljax_torch.accel.instances import trace_nearest_instanced_walk

    def both(tables, o, d, t_max, cull, any_hit=False):
        args = (tables, o, d, 0.001, t_max, cull)
        rec_k = trace_nearest_bvh8_inst(*args, any_hit)
        rec_p = trace_nearest_bvh8_inst_plain(*args, any_hit)
        rec_w = trace_nearest_instanced_walk(*args)
        torch.cuda.synchronize(device)
        return rec_k, rec_p, rec_w

    ok = True
    for spread, cases in (
            (4.0, (("cornell", "instanced_fused", 1),
                   ("edited", "instanced_shade0", 0))),
            (5.0, (("textured", "instanced_shade2", 2),))):
        o_np, d_np = _rays(n_rays, 11, spread=spread)
        o = torch.as_tensor(o_np, device=device)
        d = torch.as_tensor(d_np, device=device)
        for variant, name, mode in cases:
            _, tables = instanced_case(device, variant)
            if tables.shade_mode != max(mode, 1):
                raise RuntimeError(f"{name}: shade mode {tables.shade_mode}")
            if mode == 0:
                tables = dataclasses.replace(tables, shade_mode=0,
                                             shade_rows=None)
            rec_k, rec_p, rec_w = both(tables, o, d, 1000.0, mode != 0)
            ok &= _judge(name, rec_k, rec_p, rec_w, None, variants,
                         direct=True)
            if variant == "cornell":
                rec_k, rec_p, rec_w = both(tables, o, d, 6.0, False,
                                           any_hit=True)
                ok &= _judge_hits("instanced_anyhit", rec_k["hit"],
                                  rec_p["hit"], rec_w["hit"], variants)
    return ok


def _treelet_variants(device, o, d, n_tris: int, variants) -> bool:
    """K7 through the scheduler against its plain version in every round:
    shade modes 0 (the reference's treelets_shade0), 1 and 2, any-hit, and
    coarse alpha masks, on the soup cut at max_tris = 4096."""
    from steeljax_torch.accel.treelets import trace_treelets

    ok = True
    for name, textured, alpha, any_hit in (
            ("treelets_shade0", None, False, False),
            ("treelets_shade1", False, False, False),
            ("treelets_shade2", True, False, False),
            ("treelets_anyhit", None, False, True),
            ("treelets_alpha_mask", None, True, False)):
        tt, perm = treelet_soup_case(n_tris, device, textured=textured,
                                     alpha=alpha)
        t_max, cull = (40.0, False) if any_hit else (1000.0, True)
        rec_k = trace_treelets(tt, o, d, 0.001, t_max, cull, any_hit)
        rec_p = trace_treelets(tt, o, d, 0.001, t_max, cull, any_hit,
                               trace_fn=plain_round(tt, cull, any_hit))
        torch.cuda.synchronize(device)
        if any_hit:
            ok &= _compare_hits(name, rec_k["hit"], rec_p["hit"], variants)
        else:
            ok &= _compare(
                name, rec_k, rec_p, perm["pos"], variants,
                attrs=(None if textured is None else
                       {k: perm[k] for k in (
                           ("nrm", "tan", "uv", "mat") if textured
                           else ("nrm", "mat"))}),
                d=d.cpu().numpy())
        variants[name]["treelets"] = tt.count
    return ok


def _k6_k7_path_variants(device, scenes, width, height, variants) -> bool:
    """K6 and K7 on their paths' own rays, strided subsets: path I's
    primaries (mode 1) and first-bounce shadow rays (any-hit), path J's
    primaries (mode 2), and through the scheduler path U's primaries (mode
    2) and path UL's primaries (mode 1) and first-bounce shadow rays
    (any-hit)."""
    from steeljax_torch.accel.cuda_traverse import (
        trace_nearest_bvh8_inst, trace_nearest_bvh8_inst_plain)
    from steeljax_torch.accel.treelets import trace_treelets

    ok = True
    scene, flat, tables = scenes["sunlit_inst"]
    rays = strided_subset(tiled_primary(scene, device, width, height)[:4],
                          SHADOW_SUBSET)
    rec_k = trace_nearest_bvh8_inst(tables, *rays, True)
    rec_p = trace_nearest_bvh8_inst_plain(tables, *rays, True)
    torch.cuda.synchronize(device)
    ok &= _compare("instanced_primary", rec_k, rec_p, None, variants,
                   direct=True)
    rays = strided_subset(sunlit_shadow_case(scene, flat, tables, width,
                                             height), SHADOW_SUBSET)
    hit_k = trace_nearest_bvh8_inst(tables, *rays, False, True)["hit"]
    hit_p = trace_nearest_bvh8_inst_plain(tables, *rays, False, True)["hit"]
    torch.cuda.synchronize(device)
    ok &= _compare_hits("instanced_shadow", hit_k, hit_p, variants)

    scene, flat, tables = scenes["stress_tex_inst"]
    rays = strided_subset(tiled_primary(scene, device, width, height)[:4],
                          TEX_SUBSET)
    rec_k = trace_nearest_bvh8_inst(tables, *rays, True)
    rec_p = trace_nearest_bvh8_inst_plain(tables, *rays, True)
    torch.cuda.synchronize(device)
    ok &= _compare("instanced_tex_primary", rec_k, rec_p, None, variants,
                   direct=True)

    scene, flat, tables = scenes["stress_tex_treelets"]
    tt = tables.treelets
    rays = strided_subset(tiled_primary(scene, device, width, height)[:4],
                          TEX_SUBSET)
    rec_k = trace_treelets(tt, *rays, True)
    rec_p = trace_treelets(tt, *rays, True, trace_fn=plain_round(tt))
    torch.cuda.synchronize(device)
    ok &= _compare("treelets_primary", rec_k, rec_p,
                   flat.tri_pos.cpu().numpy(), variants,
                   attrs={"nrm": flat.tri_nrm.cpu().numpy(),
                          "tan": flat.tri_tan.cpu().numpy(),
                          "uv": flat.tri_uv.cpu().numpy(),
                          "mat": flat.tri_mat.cpu().numpy()},
                   d=rays[1].cpu().numpy())
    variants["treelets_primary"]["treelets"] = tt.count

    scene, flat, tables = scenes["sunlit_treelets"]
    tt = tables.treelets
    rays = strided_subset(tiled_primary(scene, device, width, height)[:4],
                          SHADOW_SUBSET)
    rec_k = trace_treelets(tt, *rays, True)
    rec_p = trace_treelets(tt, *rays, True, trace_fn=plain_round(tt))
    torch.cuda.synchronize(device)
    ok &= _compare("treelets_lit_primary", rec_k, rec_p,
                   flat.tri_pos.cpu().numpy(), variants,
                   attrs={"nrm": flat.tri_nrm.cpu().numpy(),
                          "mat": flat.tri_mat.cpu().numpy()},
                   d=rays[1].cpu().numpy())
    rays = strided_subset(sunlit_shadow_case(scene, flat, tables, width,
                                             height), SHADOW_SUBSET)
    hit_k = trace_treelets(tt, *rays, False, True)["hit"]
    hit_p = trace_treelets(tt, *rays, False, True,
                           trace_fn=plain_round(tt, False, True))["hit"]
    torch.cuda.synchronize(device)
    ok &= _compare_hits("treelets_shadow", hit_k, hit_p, variants)
    for name in ("treelets_lit_primary", "treelets_shadow"):
        variants[name]["treelets"] = tt.count
    return ok


def run(device, n_rays: int = 10240, n_tris: int = 30000,
        width: int = 1280, height: int = 720, scenes: dict | None = None
        ) -> dict:
    """Every variant of K1 to K7, kernel against plain version, on a CUDA
    `device`.  `scenes` maps names of PATH_SCENES, "foliage",
    INSTANCED_SCENES and TREELET_SCENES to their prepare_path_scene
    results; those not given are built here.  Returns
    {"n_rays", "n_tris", "variants": {...}, "ok"}."""
    from steeljax_torch.accel.cuda_traverse import (trace_any_bvh8,
                                                    trace_any_bvh8_plain,
                                                    trace_nearest_bvh8,
                                                    trace_nearest_bvh8_plain)
    from steeljax_torch.accel.dispatch import (anyhit_tables,
                                               trace_any_walk,
                                               trace_nearest_walk)

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the parity run compares the CUDA kernels; got "
                         f"device {device}")
    variants: dict = {}
    all_ok = True

    def both(tables, o, d, t_min, t_max, cull, mode):
        chunk = tables.chunks[0]
        args = (chunk.bvh8, chunk.tris_packed, o, d, t_min, t_max, cull,
                chunk.shade_packed if mode else None, mode)
        rec_k = trace_nearest_bvh8(*args, records=chunk.tri_records)
        rec_p = trace_nearest_bvh8_plain(*args)
        torch.cuda.synchronize(device)
        return rec_k, rec_p

    def both_any(chunk, o, d, t_min, t_max):
        # The chunk's own tables, as dispatch.trace_any reads them.
        bvh8, tris, records, dense = anyhit_tables(chunk)
        hit_k = trace_any_bvh8(bvh8, tris, o, d, t_min, t_max, dense,
                               records=records)
        hit_p = trace_any_bvh8_plain(bvh8, tris, o, d, t_min, t_max, dense)
        torch.cuda.synchronize(device)
        return hit_k, hit_p

    tables, perm, o_np, d_np = soup_case(n_tris, n_rays, device)
    o = torch.as_tensor(o_np, device=device)
    d = torch.as_tensor(d_np, device=device)
    pos, ds = walk_arrays(perm["pos"], perm["ds"], device)
    attrs = {"nrm": perm["nrm"], "mat": perm["mat"]}
    walks = {}
    for cull in (True, False):
        rec_k, rec_p = both(tables, o, d, 0.001, 1000.0, cull, 0)
        walks[cull] = trace_nearest_walk(tables, pos, ds, o, d, 0.001,
                                         1000.0, cull)
        all_ok &= _judge(f"flat_shade0_cull{int(cull)}", rec_k, rec_p,
                         walks[cull], perm["pos"], variants)
    # K1 on rays with one shared origin (the reference's shared-origin
    # specialization, :279-286).
    o_sh, d_sh = (torch.as_tensor(x, device=device)
                  for x in _rays(n_rays, 7, shared_origin=True))
    rec_k, rec_p = both(tables, o_sh, d_sh, 0.001, 1000.0, True, 0)
    all_ok &= _judge("flat_shade0_shared_origin", rec_k, rec_p,
                     trace_nearest_walk(tables, pos, ds, o_sh, d_sh, 0.001,
                                        1000.0, True),
                     perm["pos"], variants)
    rec_k, rec_p = both(tables, o, d, 0.001, 1000.0, True, 1)
    all_ok &= _judge("flat_shade1", rec_k, rec_p, walks[True], perm["pos"],
                     variants, attrs=attrs, d=d_np)
    chunk = tables.chunks[0]
    hit_w = trace_any_walk(tables, pos, ds, o, d, 0.001, 40.0)
    all_ok &= _judge_hits("flat_anyhit", *both_any(
        chunk, o, d, 0.001, 40.0), hit_w, variants)

    tables2, perm2, _, _ = soup_case(n_tris, n_rays, device, textured=True,
                                     dense_anyhit=True)
    # The textured soup is the same triangles in the same tree: the walk
    # of the first soup is its oracle too, as in the reference.
    if not np.array_equal(perm2["pos"], perm["pos"]):
        raise RuntimeError("the textured soup has another permutation")
    rec_k, rec_p = both(tables2, o, d, 0.001, 1000.0, True, 2)
    all_ok &= _judge("flat_shade2", rec_k, rec_p, walks[True], perm2["pos"],
                     variants, attrs={k: perm2[k] for k in ("nrm", "tan",
                                                             "uv", "mat")},
                     d=d_np)
    chunk2 = tables2.chunks[0]
    all_ok &= _judge_hits("flat_anyhit_dense", *both_any(
        chunk2, o, d, 0.001, 40.0), hit_w, variants)

    dtables, dpos, od, dd = deterministic_case(device)
    od, dd = (torch.as_tensor(x, device=device) for x in (od, dd))
    rec_k, rec_p = both(dtables, od, dd, 0.001, 1000.0, False, 0)
    # Every quad is double-sided; pad slots (at 3e37) never hit.
    rec_w = trace_nearest_walk(
        dtables, *walk_arrays(dpos, dpos[:, 0, 0] < 1e37, device), od, dd,
        0.001, 1000.0, False)
    all_ok &= _judge("flat_deterministic_exact", rec_k, rec_p, rec_w, dpos,
                     variants, atol=1e-5, exact=True)

    flat, ctables, cases = cornell_cases(device, width, height)
    cattrs = {"nrm": flat.tri_nrm.cpu().numpy(),
              "mat": flat.tri_mat.cpu().numpy()}
    cpos = flat.tri_pos.cpu().numpy()
    for name, (co, cd, tmn, tmx) in cases.items():
        rec_k, rec_p = both(ctables, co, cd, tmn, tmx, True, 1)
        all_ok &= _compare(f"cornell_{name}_{width}x{height}"
                           if name == "primary" else f"cornell_{name}",
                           rec_k, rec_p, cpos, variants, attrs=cattrs,
                           d=cd.cpu().numpy())

    scenes = dict(scenes or {})
    for name in (PATH_SCENES + ("foliage",) + INSTANCED_SCENES
                 + TREELET_SCENES):
        if name not in scenes:
            scenes[name] = prepare_path_scene(name, device)
    scene, lflat, ltables = scenes["sunlit"]
    rays = strided_subset(sunlit_shadow_case(scene, lflat, ltables, width,
                                             height), SHADOW_SUBSET)
    lchunk = ltables.chunks[0]
    all_ok &= _compare_hits("sunlit_shadow", *both_any(
        lchunk, *rays), variants)
    dchunk = scenes["sunlit_dense"][2].chunks[0]
    all_ok &= _compare_hits("sunlit_shadow_dense", *both_any(
        dchunk, *rays), variants)

    # The hybrid frame on path L's scene at 1920x1080: K1 in shade mode 1
    # on the G-buffer's rays and K2 on the lighting stage's sun rays.
    hw, hh = HYBRID_WIDTH, HYBRID_HEIGHT
    lattrs = {"nrm": lflat.tri_nrm.cpu().numpy(),
              "mat": lflat.tri_mat.cpu().numpy()}
    o_h, d_h, tmn, tmx = strided_subset(
        hybrid_rays(scene, device, hw, hh)[:4], SHADOW_SUBSET)
    rec_k, rec_p = both(ltables, o_h, d_h, tmn, tmx, True,
                        ltables.shade_mode)
    all_ok &= _compare(f"hybrid_gbuffer_{hw}x{hh}", rec_k, rec_p,
                       lflat.tri_pos.cpu().numpy(), variants, attrs=lattrs,
                       d=d_h.cpu().numpy())
    all_ok &= _compare_hits("hybrid_sun_shadow", *both_any(
        lchunk, *strided_subset(hybrid_shadow_case(scene, lflat, ltables, hw,
                                                   hh), SHADOW_SUBSET)),
        variants)

    scene, tflat, ttables = scenes["stress_tex"]
    o_t, d_t, tmn, tmx = strided_subset(
        tiled_primary(scene, device, width, height)[:4], TEX_SUBSET)
    rec_k, rec_p = both(ttables, o_t, d_t, tmn, tmx, True, 2)
    tattrs = {"nrm": tflat.tri_nrm.cpu().numpy(),
              "tan": tflat.tri_tan.cpu().numpy(),
              "uv": tflat.tri_uv.cpu().numpy(),
              "mat": tflat.tri_mat.cpu().numpy()}
    all_ok &= _compare("stress_tex_primary", rec_k, rec_p,
                       tflat.tri_pos.cpu().numpy(), variants, attrs=tattrs,
                       d=d_t.cpu().numpy())

    all_ok &= _chunked_width16_variants(device, tables, perm, o, d, n_tris,
                                        variants, walks[True], hit_w)
    all_ok &= _alpha_variants(device, tables, o, d, n_tris, variants)
    all_ok &= _foliage_variants(device, scenes, width, height, variants)
    all_ok &= _instanced_variants(device, n_rays, variants)
    all_ok &= _treelet_variants(device, o, d, n_tris, variants)
    all_ok &= _k6_k7_path_variants(device, scenes, width, height, variants)
    return {"n_rays": n_rays, "n_tris": n_tris, "variants": variants,
            "ok": bool(all_ok)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rays", type=int, default=10240,
                    help="rays of the soup variants")
    ap.add_argument("--tris", type=int, default=30000,
                    help="triangles of the soup variants")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_parity needs a CUDA card")
    results = run(args.device, args.rays, args.tris)
    results["device"] = torch.cuda.get_device_name(0)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=1)
    print("ALL PASS" if results["ok"] else "FAILURES")
    return 0 if results["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
