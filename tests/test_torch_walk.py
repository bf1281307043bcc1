"""The port's BVH walk (steeljax_torch.accel.traverse, accel.intersect) and
its oracle branches (dispatch.trace_nearest_walk / trace_any_walk,
instances.trace_nearest_instanced_walk) against the reference's
(steeljax.accel.traverse, intersect, dispatch and instances on
use_pallas=False tables) on the CPU.

Inputs are made with numpy from seeds and fed to both packages.  Hits are
judged by triangle id: at most max(2, N/5000) rays may disagree (a hit
flag or a tri id), and |delta t| < 1e-5 where both hit; the deterministic
quad stack must agree exactly.  The walk rounds as the reference's XLA
program does (accel.intersect), so on these inputs its t, u and v are in
fact bit-equal to the reference's.  Over spatial-split tables hits are
compared by source triangle (order[slot]); instanced records by
(instance, BLAS-local triangle), since two scenes pool their BLAS in the
order of id(primitive)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import steeljax_torch.accel as accel_pkg
from steeljax.accel import dispatch as dispatch_ref
from steeljax.accel import instances as instances_ref
from steeljax.accel import traverse as traverse_ref
from steeljax.accel.bvh import BVH as BVHRef
from steeljax.accel.bvh import build_bvh as build_bvh_ref
from steeljax.accel.intersect import intersect as intersect_ref
from steeljax_torch.accel import dispatch, traverse
from steeljax_torch.accel.bvh import apply_permutation, build_bvh
from steeljax_torch.accel.cuda_traverse import (trace_any_bvh8_plain,
                                                trace_nearest_bvh8_plain)
from steeljax_torch.accel.instances import trace_nearest_instanced_walk
from steeljax_torch.accel.intersect import intersect
from steeljax_torch.apps import kernel_parity as kp
from steeljax_torch.convert import _instanced
from test_torch_instances import _both, _local
from test_torch_sbvh import long_soup
from test_torch_support import one_torch_thread  # noqa: F401


N_TRIS, N_RAYS, LEAF = 3000, 2048, 24
BUDGET = max(2, N_RAYS // 5000)


def _np(rec: dict) -> dict:
    return {k: np.asarray(v) for k, v in kp._numpy(rec).items()}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _agree(rec, rec_r, budget: int = BUDGET, atol: float = 1e-5,
           rtol: float = 0.0) -> None:
    """At most `budget` rays with another hit flag or tri id, and |delta t|
    < atol + rtol |t| where both hit."""
    rec, rec_r = _np(rec), _np(rec_r)
    assert (rec["tri"] != rec_r["tri"]).sum() <= budget
    both = rec["hit"] & rec_r["hit"]
    assert both.sum() > 0
    dt = np.abs(rec["t"][both] - rec_r["t"][both])
    assert (dt < atol + rtol * np.abs(rec_r["t"][both])).all(), dt.max()
    assert (rec["t"][~rec["hit"]] == -1.0).all()


@pytest.fixture(scope="module")
def soup():
    """The reference's parity soup at a small size: the tree (built by both
    packages, equal), the permuted positions and flags, rays."""
    tris, ds = kp.soup_inputs(N_TRIS)
    tree, order, padded = build_bvh(tris, LEAF)
    tree_r, order_r, _ = build_bvh_ref(tris, LEAF)
    np.testing.assert_array_equal(order, order_r)
    perm = apply_permutation((None, order, padded), {"pos": tris, "ds": ds})
    o, d = kp._rays(N_RAYS, 3)
    return tree, tree_r, perm, o, d


def _walk(tree, perm, o, d, t_min, t_max, **kw):
    return traverse.trace_nearest(tree, _t(perm["pos"]), _t(perm["ds"]),
                                  _t(o), _t(d), t_min, t_max, **kw)


def _walk_ref(tree_r, perm, o, d, t_min, t_max, **kw):
    # Per-ray intervals always, so calls of one kind share a compilation.
    n = o.shape[0]
    return traverse_ref.trace_nearest(
        tree_r, jnp.asarray(perm["pos"]), jnp.asarray(perm["ds"]),
        jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(np.broadcast_to(np.float32(t_min), (n,))),
        jnp.asarray(np.broadcast_to(np.float32(t_max), (n,))), **kw)


@pytest.mark.parametrize("cull", [True, False])
def test_intersect_matches_reference(cull):
    """n rays against K triangles each, one ray's row at a time through the
    reference's vmapped intersect."""
    r = np.random.default_rng(7)
    n, k = 256, 16
    o = r.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    v0, e1, e2 = (r.normal(size=(n, k, 3)).astype(np.float32)
                  for _ in range(3))
    ds = r.uniform(size=(n, k)) < 0.5
    t_min = np.full(n, 1e-3, np.float32)
    t_max = r.uniform(1.0, 20.0, n).astype(np.float32)
    out = intersect(_t(o), _t(d), _t(v0), _t(e1), _t(e2), _t(ds),
                    _t(t_min), _t(t_max), cull)
    ref = jax.vmap(lambda *a: intersect_ref(*a, cull))(
        *(jnp.asarray(x) for x in (o, d, v0, e1, e2, ds, t_min, t_max)))
    t, u, v, hit = (x.numpy() for x in out)
    t_r, u_r, v_r, hit_r = (np.asarray(x) for x in ref)
    assert (hit != hit_r).sum() <= 2
    assert hit.sum() > 0
    same = hit & hit_r
    for a, b in ((t, t_r), (u, u_r), (v, v_r)):
        np.testing.assert_allclose(a[same], b[same], rtol=1e-5, atol=1e-6)


def test_brute_matches_reference(soup):
    """XLA fuses the reference's brute-force chunk loop otherwise than its
    walk, so t may differ by a few ulps (1e-6 relative) there."""
    _, _, perm, o, d = soup
    o, d = o[:512], d[:512]
    rec = traverse.trace_nearest_brute(_t(perm["pos"]), _t(perm["ds"]),
                                       _t(o), _t(d), 0.001, 1000.0, False)
    rec_r = traverse_ref.trace_nearest_brute(
        jnp.asarray(perm["pos"]), jnp.asarray(perm["ds"]), jnp.asarray(o),
        jnp.asarray(d), 0.001, 1000.0, False)
    _agree(rec, rec_r, atol=0.0, rtol=1e-6)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("cull", [True, False])
def test_walk_matches_reference(soup, cull, any_hit):
    tree, tree_r, perm, o, d = soup
    stats = {}
    rec = _walk(tree, perm, o, d, 0.001, 1000.0, cull_backface=cull,
                any_hit=any_hit, stats=stats)
    rec_r = _walk_ref(tree_r, perm, o, d, 0.001, 1000.0, cull_backface=cull,
                      any_hit=any_hit)
    _agree(rec, rec_r)
    assert rec["hit"].sum() > N_RAYS // 8
    # Three host reads a step, one batch on the CPU at this size.
    assert stats["batches"] == 1
    assert stats["host_reads"] == 3 * stats["steps"]


def test_walk_batches_give_the_same_record(soup, monkeypatch):
    """Rays walked in batches of 100 give the one-batch record."""
    tree, _, perm, o, d = soup
    o, d = o[:512], d[:512]
    one = _walk(tree, perm, o, d, 0.001, 1000.0)
    monkeypatch.setitem(traverse.BATCH_CANDIDATES, "cpu", 100 * LEAF)
    stats = {}
    many = _walk(tree, perm, o, d, 0.001, 1000.0, stats=stats)
    assert stats["batches"] == 6
    for k in one:
        assert torch.equal(one[k], many[k]), k


@pytest.fixture(scope="module")
def masked_soup():
    tris, ds, coarse, _ = kp.alpha_soup_inputs(N_TRIS)
    tree, order, padded = build_bvh(tris, LEAF)
    tree_r, _, _ = build_bvh_ref(tris, LEAF)
    perm = apply_permutation((None, order, padded),
                             {"pos": tris, "ds": ds, "mask": coarse})
    o, d = kp._rays(N_RAYS, 3)
    return tree, tree_r, perm, o, d


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_with_coarse_masks_matches_reference(masked_soup, any_hit):
    tree, tree_r, perm, o, d = masked_soup
    mask = perm["mask"].astype(np.int32)
    plain = _walk(tree, perm, o, d, 0.001, 1000.0, any_hit=any_hit)
    rec = _walk(tree, perm, o, d, 0.001, 1000.0, any_hit=any_hit,
                tri_alpha_mask=_t(mask))
    rec_r = _walk_ref(tree_r, perm, o, d, 0.001, 1000.0, any_hit=any_hit,
                      tri_alpha_mask=jnp.asarray(mask))
    _agree(rec, rec_r)
    # The masks reject hits: fewer rays hit than without them.
    assert rec["hit"].sum() < plain["hit"].sum()


def test_deterministic_grid_is_exact():
    """kernel_parity's quad stack with perpendicular interior rays: no
    grazing hit, so both walks agree exactly, field by field."""
    tables, pos, o, d = kp.deterministic_case("cpu")
    tree = tables.chunks[0].bvh
    # Every quad is double-sided; pad slots (at 3e37) never hit.
    ds = pos[:, 0, 0] < 1e37
    rec = traverse.trace_nearest(tree, _t(pos), _t(ds), _t(o), _t(d), 0.001,
                                 1000.0, cull_backface=False)
    tree_r = BVHRef(nodes=jnp.asarray(tree.nodes), depth=tree.depth,
                    max_leaf=tree.max_leaf)
    rec_r = traverse_ref.trace_nearest(
        tree_r, jnp.asarray(pos), jnp.asarray(ds), jnp.asarray(o),
        jnp.asarray(d), 0.001, 1000.0, cull_backface=False)
    rec, rec_r = _np(rec), _np(rec_r)
    assert rec["hit"].all()
    for k in rec:
        np.testing.assert_array_equal(rec[k], rec_r[k], err_msg=k)


def test_dead_rays_and_per_ray_t_max(soup):
    """Per-ray intervals: a quarter of the rays dead (t_max < t_min), the
    rest cut at random distances."""
    tree, tree_r, perm, o, d = soup
    r = np.random.default_rng(9)
    t_min = np.full(N_RAYS, 0.001, np.float32)
    t_max = r.uniform(1.0, 30.0, N_RAYS).astype(np.float32)
    dead = r.uniform(size=N_RAYS) < 0.25
    t_max[dead] = -3.0e38
    rec = _walk(tree, perm, o, d, _t(t_min), _t(t_max))
    rec_r = _walk_ref(tree_r, perm, o, d, t_min, t_max)
    _agree(rec, rec_r)
    hit = rec["hit"].numpy()
    assert not hit[dead].any()
    assert (rec["t"].numpy()[hit] <= t_max[hit]).all()


def test_walk_refuses_mixed_devices(soup):
    tree, _, perm, o, d = soup
    with pytest.raises(ValueError, match="several devices"):
        traverse.trace_nearest(tree, _t(perm["pos"]), _t(perm["ds"]),
                               _t(o), _t(d).to("meta"), 0.001, 1000.0)


@pytest.fixture(scope="module")
def chunked():
    """Both packages' three-chunk tables of the soup and the permuted
    arrays (equal in both)."""
    tris, ds = kp.soup_inputs(N_TRIS)
    tables, order, padded = dispatch.prepare_tables(
        tris, ds, "cpu", leaf_size=LEAF, max_chunk=N_TRIS // 3)
    tables_r, order_r, _ = dispatch_ref.prepare_tables(
        tris, ds, leaf_size=LEAF, max_chunk=N_TRIS // 3, use_pallas=False)
    assert len(tables.chunks) == len(tables_r.chunks) == 3
    np.testing.assert_array_equal(order, order_r)
    perm = apply_permutation((None, order, padded), {"pos": tris, "ds": ds})
    o, d = kp._rays(N_RAYS, 3)
    return tables, tables_r, perm, o, d


@pytest.mark.parametrize("any_hit", [False, True])
def test_chunked_walk_matches_reference(chunked, any_hit):
    tables, tables_r, perm, o, d = chunked
    args = (_t(perm["pos"]), _t(perm["ds"]), _t(o), _t(d), 0.001, 40.0)
    args_r = (jnp.asarray(perm["pos"]), jnp.asarray(perm["ds"]),
              jnp.asarray(o), jnp.asarray(d), 0.001, 40.0)
    if any_hit:
        hit = dispatch.trace_any_walk(tables, *args).numpy()
        hit_r = np.asarray(dispatch_ref.trace_any(tables_r, *args_r))
        assert (hit != hit_r).sum() <= BUDGET
        assert hit.sum() > N_RAYS // 8
    else:
        _agree(dispatch.trace_nearest_walk(tables, *args),
               dispatch_ref.trace_nearest(tables_r, *args_r))


@pytest.mark.parametrize("variant", ["cornell", "edited"])
def test_instanced_walk_matches_reference(variant):
    """The two-level walk against InstancedAccel(use_pallas=False)'s CPU
    trace: instance ids equal, BLAS-local triangle ids within the budget,
    t within 1e-5 (the object-space rays may differ in the last bit: the
    reference's eager matrix product rounds its own way)."""
    _, tables, _, tables_r = _both(variant, use_pallas=False)
    assert len(tables.cpu_blas) == len(tables_r.cpu_blas)
    o, d = kp._rays(N_RAYS, 11, spread=4.0)
    rec = _local(trace_nearest_instanced_walk(tables, _t(o), _t(d), 0.001,
                                              1000.0), tables)
    rec_r = _local(instances_ref.trace_nearest_instanced(
        tables_r, jnp.asarray(o), jnp.asarray(d), 0.001, 1000.0), tables_r)
    np.testing.assert_array_equal(rec["inst"], rec_r["inst"])
    _agree(rec, rec_r)


def test_converted_instanced_tables_walk_as_the_reference():
    """convert carries every BLAS's tree and triangles across: the walk
    over the converted tables gives the reference's record, pool ids and
    all (the same pool)."""
    _, _, _, tables_r = _both("edited", use_pallas=False)
    tables = _instanced(tables_r, lambda x: torch.from_numpy(
        np.array(np.asarray(x))))
    assert len(tables.cpu_blas) == len(tables_r.cpu_blas)
    for b, b_r in zip(tables.cpu_blas, tables_r.cpu_blas):
        np.testing.assert_array_equal(b.bvh.nodes, np.asarray(b_r.bvh.nodes))
        np.testing.assert_array_equal(b.tri_pos.numpy(),
                                      np.asarray(b_r.tri_pos))
    o, d = kp._rays(N_RAYS, 11, spread=4.0)
    rec = _np(trace_nearest_instanced_walk(tables, _t(o), _t(d), 0.001,
                                           1000.0))
    rec_r = _np(instances_ref.trace_nearest_instanced(
        tables_r, jnp.asarray(o), jnp.asarray(d), 0.001, 1000.0))
    np.testing.assert_array_equal(rec["inst"], rec_r["inst"])
    _agree(rec, rec_r)


def test_spatial_split_walk_matches_reference_by_source():
    """Over a reference list (a triangle in several slots) the two walks
    visit the same slots; hits are judged by source triangle."""
    tris = long_soup(N_TRIS, 4)
    ds = np.random.default_rng(2).uniform(size=N_TRIS) < 0.3
    tree, order, padded = build_bvh(tris, LEAF, "sbvh")
    tree_r, order_r, _ = build_bvh_ref(tris, LEAF, "sbvh")
    np.testing.assert_array_equal(order, order_r)
    assert int((order >= 0).sum()) > N_TRIS
    perm = apply_permutation((None, order, padded), {"pos": tris, "ds": ds})
    rng = np.random.default_rng(5)
    o = rng.uniform(-12, 12, (N_RAYS, 3)).astype(np.float32)
    aim = tris[rng.integers(0, N_TRIS, N_RAYS)].mean(axis=1)
    d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rec = _np(_walk(tree, perm, o, d, 1e-3, 1e9))
    rec_r = _np(_walk_ref(tree_r, perm, o, d, 1e-3, 1e9))
    src = np.where(rec["hit"], order[np.maximum(rec["tri"], 0)], -1)
    src_r = np.where(rec_r["hit"], order[np.maximum(rec_r["tri"], 0)], -1)
    assert (src != src_r).sum() <= BUDGET
    assert rec["hit"].sum() > N_RAYS // 4
    both = rec["hit"] & rec_r["hit"]
    assert np.abs(rec["t"][both] - rec_r["t"][both]).max() < 1e-5


@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_matches_the_plain_version(any_hit):
    """The walk and the kernels' brute-force plain version, two independent
    references, over the same tables, judged as the card judges a kernel
    (kernel_parity._compare, _compare_hits)."""
    tables, perm, o, d = kp.soup_case(N_TRIS, N_RAYS, "cpu")
    chunk = tables.chunks[0]
    pos, ds = kp.walk_arrays(perm["pos"], perm["ds"], "cpu")
    results = {}
    if any_hit:
        hit = dispatch.trace_any_walk(tables, pos, ds, _t(o), _t(d), 0.001,
                                      40.0)
        plain = trace_any_bvh8_plain(chunk.bvh8, chunk.tris_packed, _t(o),
                                     _t(d), 0.001, 40.0)
        assert kp._compare_hits("walk", hit, plain, results), results
    else:
        rec = dispatch.trace_nearest_walk(tables, pos, ds, _t(o), _t(d),
                                          0.001, 1000.0)
        plain = trace_nearest_bvh8_plain(chunk.bvh8, chunk.tris_packed,
                                         _t(o), _t(d), 0.001, 1000.0)
        assert kp._compare("walk", plain, rec, perm["pos"], results), results
        assert results["walk"]["tri_matches_pct"] == 100.0


def test_judge_needs_both_references():
    """kernel_parity._judge passes a variant only when the kernel agrees
    with the plain version and with the walk, and keeps the walk's entry
    under "walk"."""
    tables, perm, o, d = kp.soup_case(600, 256, "cpu")
    chunk = tables.chunks[0]
    pos, ds = kp.walk_arrays(perm["pos"], perm["ds"], "cpu")
    rec = trace_nearest_bvh8_plain(chunk.bvh8, chunk.tris_packed, _t(o),
                                   _t(d), 0.001, 1000.0)
    walk = dispatch.trace_nearest_walk(tables, pos, ds, _t(o), _t(d), 0.001,
                                       1000.0)
    results = {}
    assert kp._judge("v", rec, rec, walk, perm["pos"], results)
    assert results["v"]["walk"]["ok"]
    wrong = dict(walk, hit=~walk["hit"])
    assert not kp._judge("w", rec, rec, wrong, perm["pos"], results)
    assert results["w"]["walk"]["hit_mismatches"] == 256


def test_accel_package_exports_the_walk():
    assert accel_pkg.trace_nearest is traverse.trace_nearest
    assert accel_pkg.trace_any is traverse.trace_any
    assert accel_pkg.trace_nearest_brute is traverse.trace_nearest_brute


def test_walk_route_renders_the_plain_routes_tile(monkeypatch):
    """apps.walk_route on a small lit scene: the tile traced through the
    walk (shading gathered, STEELJAX_SHADE_MODE=0) equals the CPU route's,
    with equal rays_traced, and the switch and the integrator are put
    back."""
    from steeljax_torch.apps import walk_route
    from steeljax_torch.render.pt import integrator
    from steeljax_torch.scene import builtin

    monkeypatch.delenv("STEELJAX_SHADE_MODE", raising=False)
    monkeypatch.setattr(kp, "make_path_scene",
                        lambda name: builtin.make_sunlit_stress_scene(12, 8))
    traces = (integrator.trace_nearest, integrator.trace_any)
    out = walk_route.run(16, 8, "cpu")
    assert out["pixels_beyond"] == 0 and out["pixels"] == 128
    assert out["walk_rays_traced"] == out["plain_rays_traced"] > 128
    assert (integrator.trace_nearest, integrator.trace_any) == traces
    assert "STEELJAX_SHADE_MODE" not in os.environ
