"""Streamed treelets (steeljax_torch.accel.treelets) and the plain version
of the treelet kernel K7 against the reference on the CPU.

The cut, the stacked tables and the shade stack must equal the reference's
arrays; `_entry_distances` and `_next_pid` must give its values.  The
scheduler with the plain K7 in every round is held against the reference's
`trace_treelets(trace_fn=...)` with the brute-force mock intersector of
tests/test_treelets.py (the Pallas round kernel cannot run on the CPU): equal
hits, t within 1e-5, the same treelet ids for every packet in every round
and the same number of rounds (the reference's loop runs under
jax.disable_jit so the mock sees each round).  The result is also held
against the port's flat plain trace over the whole table.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from steeljax.accel import bvh as bvh_ref
from steeljax.accel import dispatch as dispatch_ref
from steeljax.accel import pallas_traverse as ptv
from steeljax.accel import treelets as treelets_ref
from steeljax_torch.accel import bvh, cuda_traverse, dispatch, treelets
from steeljax_torch.accel.alphamask import MASK_FULL
from steeljax_torch.apps import kernel_parity as kp
from test_torch_support import one_torch_thread  # noqa: F401


LEAF = 8
MAX_TRIS = 256
BLOCK = 256   # rays per packet in most cases (the reference's 2 sublanes)
T_ATOL = 1e-5


def _soup(count, seed=0, spread=10.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (count, 1, 3)).astype(np.float32)
    return base + rng.uniform(-0.4, 0.4, (count, 3, 3)).astype(np.float32)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-14, 14, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def built():
    """A 3,000-triangle single-sided soup: the binary tree, the permuted
    positions, the packed rows, and both packages' treelet tables."""
    tri = _soup(3000)
    tree, order, padded = bvh.build_bvh(tri, LEAF)
    tree_r, order_r, padded_r = bvh_ref.build_bvh(tri, LEAF, method="sah")
    nodes = np.asarray(tree.nodes)
    np.testing.assert_array_equal(nodes, np.asarray(tree_r.nodes))
    permuted = bvh.apply_permutation((None, order, padded), {"pos": tri})[
        "pos"]
    packed = cuda_traverse.pack_tris(permuted, np.zeros(padded, bool))
    np.testing.assert_array_equal(
        packed, ptv.pack_tris(permuted, np.zeros(padded, bool)))
    tt = treelets.build_treelet_tables(nodes, packed, LEAF, "cpu",
                                       max_tris=MAX_TRIS)
    tt_r = treelets_ref.build_treelet_tables(nodes, packed, LEAF,
                                             max_tris=MAX_TRIS)
    return nodes, permuted, packed, tt, tt_r


def _assert_tables_equal(tt, tt_r):
    for name in ("node_stack", "tri_stack", "aabb_lo", "aabb_hi",
                 "tri_offsets", "shade_stack"):
        ours, ref = getattr(tt, name), getattr(tt_r, name)
        if ref is None:
            assert ours is None, name
            continue
        assert str(ours.dtype).split(".")[-1] == str(ref.dtype), name
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref),
                                      err_msg=name)
    for name in ("depth", "max_leaf", "shade_mode", "alpha_mask", "ranges",
                 "count"):
        assert getattr(tt, name) == getattr(tt_r, name), name


def test_subtree_ranges_and_rooted_collapse_equal_reference(built):
    nodes = built[0]
    for ours, ref in zip(bvh.subtree_tri_ranges(nodes),
                         bvh_ref.subtree_tri_ranges(nodes)):
        np.testing.assert_array_equal(ours, ref)
    roots, _, _ = treelets.cut_treelets(nodes, MAX_TRIS)
    for root in (roots[0], roots[len(roots) // 2], roots[-1]):
        rows, depth = bvh.collapse_bvh8(nodes, LEAF, root=root)
        rows_r, depth_r = bvh_ref.collapse_bvh8(nodes, LEAF, root=root)
        np.testing.assert_array_equal(rows, rows_r)
        assert depth == depth_r


@pytest.mark.parametrize("max_tris", [MAX_TRIS, 24, 100_000])
def test_cut_and_tables_equal_reference(built, max_tris):
    nodes, _, packed, _, _ = built
    roots, lo, hi = treelets.cut_treelets(nodes, max_tris)
    roots_r, lo_r, hi_r = treelets_ref.cut_treelets(nodes, max_tris)
    assert list(roots) == list(roots_r)
    np.testing.assert_array_equal(lo, lo_r)
    np.testing.assert_array_equal(hi, hi_r)
    tt = treelets.build_treelet_tables(nodes, packed, LEAF, "cpu",
                                       max_tris=max_tris)
    tt_r = treelets_ref.build_treelet_tables(nodes, packed, LEAF,
                                             max_tris=max_tris)
    _assert_tables_equal(tt, tt_r)
    assert tt.count == {MAX_TRIS: tt.count, 24: tt.count, 100_000: 1}[
        max_tris]
    if max_tris == 24:
        assert tt.count > 64


@pytest.mark.parametrize("mode", [1, 2])
def test_attach_shade_stack_equal_reference(built, mode):
    _, permuted, _, tt, tt_r = built
    padded = len(permuted)
    r = np.random.default_rng(4)
    nrm = r.normal(size=(padded, 3, 3)).astype(np.float32)
    tan = r.normal(size=(padded, 3, 3)).astype(np.float32)
    uv = r.uniform(size=(padded, 3, 2)).astype(np.float32)
    mat = r.integers(0, 7, padded).astype(np.int32)
    shade = cuda_traverse.pack_shade_records(nrm, mat, mode == 2,
                                             tri_tan=tan, tri_uv=uv)
    np.testing.assert_array_equal(
        shade, ptv.pack_shade_records(nrm, tan, uv, mat, mode == 2))
    _assert_tables_equal(treelets.attach_shade_stack(tt, shade, mode),
                         treelets_ref.attach_shade_stack(tt_r, shade, mode))


def test_entry_distances_and_next_pid_equal_reference(built):
    _, _, _, tt, tt_r = built
    n = 4 * BLOCK
    o, d = _rays(n, 7)
    d[::97, 1] = 0.0   # axis-parallel directions take the guarded inverse
    r = np.random.default_rng(8)
    t_min = np.full(n, 1e-3, np.float32)
    t_far = r.uniform(2.0, 40.0, n).astype(np.float32)
    t_far[::13] = -3.0e38
    entry = treelets._entry_distances(
        tt, *(torch.from_numpy(x) for x in (o, d, t_min, t_far)))
    entry_r = np.array(treelets_ref._entry_distances(
        tt_r, *(jnp.asarray(x) for x in (o, d, t_min, t_far))))
    finite = np.isfinite(entry_r)
    np.testing.assert_array_equal(np.isfinite(entry.numpy()), finite)
    # Products and differences only; XLA may contract them differently.
    np.testing.assert_allclose(entry.numpy()[finite], entry_r[finite],
                               rtol=1e-6, atol=1e-6)
    assert 0.05 < finite.mean() < 0.95
    # The packet choice on the reference's own distances, so that the
    # integer result must be equal.
    visited = r.uniform(size=entry_r.shape) < 0.3
    visited |= ~finite
    pid = treelets._next_pid(torch.from_numpy(entry_r),
                             torch.from_numpy(visited),
                             torch.from_numpy(t_far), BLOCK)
    pid_r = np.asarray(treelets_ref._next_pid(
        jnp.asarray(entry_r), jnp.asarray(visited), jnp.asarray(t_far),
        BLOCK))
    assert pid.dtype == torch.int32
    np.testing.assert_array_equal(pid.numpy(), pid_r)
    done = treelets._next_pid(torch.from_numpy(entry_r),
                              torch.ones_like(torch.from_numpy(visited)),
                              torch.from_numpy(t_far), BLOCK)
    assert (done == tt.count).all()


def _mock_trace(permuted, tt_r, block, log):
    """The reference test's brute-force round (tests/test_treelets.py:
    83-124): (pid, o, d, t_min, t_max) -> treelet-local record; appends
    each round's pid to `log`."""
    r8 = tt_r.tri_stack.shape[1] * bvh.TRI_PER_ROW
    tri_dev = jnp.asarray(np.concatenate(
        [permuted, np.full((r8, 3, 3), 3.0e37, np.float32)]))
    offsets = tt_r.tri_offsets

    def one_packet(pid, o, d, tmn, tmx):
        tris = jax.lax.dynamic_slice(tri_dev, (offsets[pid], 0, 0),
                                     (r8, 3, 3))
        v0 = tris[:, 0]
        e1 = tris[:, 1] - tris[:, 0]
        e2 = tris[:, 2] - tris[:, 0]
        p = jnp.cross(d[:, None, :], e2[None])
        det = jnp.sum(e1[None] * p, axis=-1)
        facing = det > 1e-12
        inv = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
        tv = o[:, None, :] - v0[None]
        u = jnp.sum(tv * p, axis=-1) * inv
        q = jnp.cross(tv, e1[None])
        v = jnp.sum(d[:, None, :] * q, axis=-1) * inv
        t = jnp.sum(e2[None] * q, axis=-1) * inv
        ok = (facing & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (t >= tmn[:, None]) & (t <= tmx[:, None]))
        t = jnp.where(ok, t, jnp.inf)
        best = jnp.argmin(t, axis=1)
        bt = jnp.take_along_axis(t, best[:, None], 1)[:, 0]
        hit = jnp.isfinite(bt)
        return {"t": jnp.where(hit, bt, -1.0),
                "tri": jnp.where(hit, best.astype(jnp.int32), -1),
                "u": jnp.zeros_like(bt), "v": jnp.zeros_like(bt),
                "hit": hit}

    def trace(pid, o, d, tmn, tmx):
        log.append(np.asarray(pid))
        rec = jax.vmap(one_packet)(
            pid, o.reshape((-1, block, 3)), d.reshape((-1, block, 3)),
            tmn.reshape((-1, block)), tmx.reshape((-1, block)))
        return {k: v.reshape(-1) for k, v in rec.items()}

    return trace


def _run_both(permuted, tt, tt_r, o, d, t_max, block, any_hit=False,
              cull=True):
    """The port's scheduler with the plain K7 and the reference's with the
    mock: (port record, reference record, port pids, reference pids)."""
    log, log_r = [], []
    plain = kp.plain_round(tt, cull, any_hit, block)

    def watched(pid, *rays):
        log.append(pid.numpy().copy())
        return plain(pid, *rays)

    before = dict(treelets.SCHEDULER)
    rec = treelets.trace_treelets(
        tt, torch.from_numpy(o), torch.from_numpy(d), 1e-3, t_max,
        cull_backface=cull, any_hit=any_hit, block=block, trace_fn=watched)
    assert treelets.SCHEDULER["traces"] - before["traces"] == 1
    # One read of the packets-left flag before every round, and one more to
    # leave the loop unless it ran its bound of K rounds.
    reads = treelets.SCHEDULER["host_reads"] - before["host_reads"]
    assert reads == len(log) + (len(log) < tt.count)
    with jax.disable_jit():
        rec_r = treelets_ref.trace_treelets(
            tt_r, jnp.asarray(o), jnp.asarray(d), 1e-3, t_max,
            cull_backface=cull, any_hit=any_hit,
            packet_sublanes=block // ptv.LANES,
            trace_fn=_mock_trace(permuted, tt_r, block, log_r))
    return rec, {k: np.asarray(v) for k, v in rec_r.items()}, log, log_r


def _assert_same_schedule(log, log_r):
    assert len(log) == len(log_r), "number of rounds"
    for i, (pid, pid_r) in enumerate(zip(log, log_r)):
        np.testing.assert_array_equal(pid, pid_r, err_msg=f"round {i}")


def _flat_plain(packed, o, d, t_max, cull=True):
    return cuda_traverse.trace_nearest_bvh8_plain(
        None, torch.from_numpy(packed), torch.from_numpy(o),
        torch.from_numpy(d), 1e-3, t_max, cull)


@pytest.mark.parametrize("n,block", [(700, BLOCK), (5000, 4096),
                                     (1000, 128)])
def test_scheduler_matches_reference(built, n, block):
    """n = 700 is not a packet multiple (pad lanes); 4,096 is the
    reference's scheduling unit, 128 the port's (one CUDA block of K7,
    measured faster on the H100: PERF.md)."""
    _, permuted, packed, tt, tt_r = built
    assert ptv.LANES * ptv.SUBLANES == 4096
    assert treelets.PACKET_RAYS == ptv.LANES == 128
    o, d = _rays(n, 7)
    rec, rec_r, log, log_r = _run_both(permuted, tt, tt_r, o, d, 1e4, block)
    _assert_same_schedule(log, log_r)
    assert 1 < len(log) <= tt.count
    hit = rec["hit"].numpy()
    np.testing.assert_array_equal(hit, rec_r["hit"])
    assert n // 50 < hit.sum() < n
    np.testing.assert_allclose(rec["t"].numpy()[hit], rec_r["t"][hit],
                               rtol=T_ATOL, atol=T_ATOL)
    np.testing.assert_array_equal(rec["tri"].numpy(), rec_r["tri"])
    assert (rec["t"].numpy()[~hit] == -1.0).all()
    # And against the flat plain trace over the whole table: global ids.
    flat = _flat_plain(packed, o, d, 1e4)
    np.testing.assert_array_equal(hit, flat["hit"].numpy())
    np.testing.assert_array_equal(rec["tri"].numpy(), flat["tri"].numpy())
    for key in ("t", "u", "v"):
        np.testing.assert_allclose(rec[key].numpy(), flat[key].numpy(),
                                   rtol=0, atol=T_ATOL)


def test_scheduler_any_hit_matches_reference(built):
    _, permuted, packed, tt, tt_r = built
    o, d = _rays(512, 11)
    rec, rec_r, log, log_r = _run_both(permuted, tt, tt_r, o, d, 1e4, BLOCK,
                                       any_hit=True)
    # The mock culls back faces where the occlusion query of K7 does not,
    # so the schedules may part after the first round; the flags are held
    # against the nearest queries instead.
    np.testing.assert_array_equal(log[0], log_r[0])
    assert sorted(rec) == ["hit"] and rec["hit"].dtype == torch.bool
    flat = _flat_plain(packed, o, d, 1e4, cull=False)
    np.testing.assert_array_equal(rec["hit"].numpy(), flat["hit"].numpy())
    assert (rec["hit"].numpy() | ~rec_r["hit"]).all()
    assert 10 < rec["hit"].sum() < 512


def test_many_treelet_cut_loses_no_hits(built):
    """More treelets than the reference's old 64-round backstop."""
    nodes, permuted, packed, _, _ = built
    tt = treelets.build_treelet_tables(nodes, packed, LEAF, "cpu",
                                       max_tris=24)
    tt_r = treelets_ref.build_treelet_tables(nodes, packed, LEAF,
                                             max_tris=24)
    assert tt.count > 64
    o, d = _rays(512, 19)
    rec, rec_r, log, log_r = _run_both(permuted, tt, tt_r, o, d, 1e4, BLOCK)
    _assert_same_schedule(log, log_r)
    hit = rec["hit"].numpy()
    np.testing.assert_array_equal(hit, rec_r["hit"])
    np.testing.assert_allclose(rec["t"].numpy()[hit], rec_r["t"][hit],
                               rtol=T_ATOL, atol=T_ATOL)


def test_finished_packets_and_dead_rays_trace_nothing(built):
    """A packet of dead rays is never scheduled, and the round's plain
    version leaves a dead ray's record and interval as they were whatever
    its packet's treelet."""
    _, _, _, tt, _ = built
    o, d = _rays(2 * BLOCK, 23)
    t_max = np.full(2 * BLOCK, 1e4, np.float32)
    t_max[BLOCK:] = -3.0e38
    log = []
    plain = kp.plain_round(tt, block=BLOCK)

    def watched(pid, *rays):
        log.append(pid.numpy().copy())
        return plain(pid, *rays)

    rec = treelets.trace_treelets(tt, torch.from_numpy(o),
                                  torch.from_numpy(d), 1e-3,
                                  torch.from_numpy(t_max), block=BLOCK,
                                  trace_fn=watched)
    assert not rec["hit"][BLOCK:].any() and rec["hit"][:BLOCK].any()
    # The finished packet rides along on treelet K - 1.
    assert all(pid[1] == tt.count - 1 for pid in log)
    # Both packets on treelet 0 (a key whose treelet field is 0).
    state = treelets.treelet_state(tt, torch.from_numpy(o),
                                   torch.from_numpy(d), 1e-3,
                                   torch.from_numpy(t_max), block=BLOCK)
    state.keys[0] = 0
    cuda_traverse.trace_treelet_round(tt, state, 0)
    assert (state.rec["tri"][BLOCK:] == -1).all()
    assert (state.t_far[BLOCK:] == -3.0e38).all()


@pytest.mark.parametrize("mode", [1, 2])
def test_fused_round_matches_flat_plain(built, mode):
    """Shade modes 1 and 2 through the scheduler equal the flat plain trace
    with the same shade rows."""
    _, permuted, packed, tt, _ = built
    padded = len(permuted)
    r = np.random.default_rng(4)
    nrm = kp._norm(r.normal(size=(padded, 3, 3))).astype(np.float32)
    tan = kp._norm(r.normal(size=(padded, 3, 3))).astype(np.float32)
    uv = r.uniform(size=(padded, 3, 2)).astype(np.float32)
    mat = r.integers(0, 7, padded).astype(np.int32)
    shade = cuda_traverse.pack_shade_records(nrm, mat, mode == 2,
                                             tri_tan=tan, tri_uv=uv)
    tt = treelets.attach_shade_stack(tt, shade, mode)
    o, d = _rays(700, 7)
    rec = treelets.trace_treelets(tt, torch.from_numpy(o),
                                  torch.from_numpy(d), 1e-3, 1e4, block=BLOCK)
    flat = cuda_traverse.trace_nearest_bvh8_plain(
        None, torch.from_numpy(packed), torch.from_numpy(o),
        torch.from_numpy(d), 1e-3, 1e4, True, torch.from_numpy(shade), mode)
    assert sorted(rec) == sorted(flat)
    assert ("tan" in rec) == (mode == 2)
    hit = flat["hit"].numpy()
    assert hit.sum() > 10
    for key in flat:
        if flat[key].dtype in (torch.int32, torch.bool):
            assert torch.equal(rec[key], flat[key]), key
        else:
            # A miss keeps the scheduler's initial record (n = tan = 0, as
            # in the reference's loop), where the flat kernel writes +z, +x.
            np.testing.assert_allclose(rec[key].numpy()[hit],
                                       flat[key].numpy()[hit], rtol=0,
                                       atol=T_ATOL, err_msg=key)
    assert (rec["n"].numpy()[~hit] == 0.0).all()


def _treelet_defaults(monkeypatch, max_tris):
    """Cut the reference's prepare_tables(treelets=True) at `max_tris`, which
    it binds as a default of build_treelet_tables; the port takes the cut
    size as prepare_tables' `treelet_tris`."""
    monkeypatch.setattr(treelets_ref.build_treelet_tables, "__defaults__",
                        (max_tris,))


@pytest.mark.parametrize("masked", [False, True])
def test_prepare_tables_treelets_equal_reference(monkeypatch, masked):
    """prepare_tables(treelets=True), with and without coarse alpha masks:
    one metadata chunk and the stacked tables, equal to the reference's;
    attach_shade_tables routes to the treelet shade stack."""
    _treelet_defaults(monkeypatch, MAX_TRIS)
    tri = _soup(2000, seed=3)
    ds = np.random.default_rng(2).uniform(size=len(tri)) < 0.3
    mask = (np.random.default_rng(5).integers(
        0, MASK_FULL + 1, len(tri)).astype(np.uint32) if masked else None)
    tables, order, padded = dispatch.prepare_tables(
        tri, ds, "cpu", leaf_size=LEAF, tri_alpha_mask=mask, treelets=True,
        treelet_tris=MAX_TRIS)
    tables_r, order_r, padded_r = dispatch_ref.prepare_tables(
        tri, ds, leaf_size=LEAF, use_pallas=True, treelets=True,
        tri_alpha_mask=mask)
    np.testing.assert_array_equal(order, order_r)
    assert padded == padded_r
    assert len(tables.chunks) == 1 and tables.treelets.count > 4
    chunk, chunk_r = tables.chunks[0], tables_r.chunks[0]
    assert chunk.tris_packed is None and chunk.bvh8 is None
    assert chunk.rows == chunk_r.rows == padded
    assert chunk.aabb == chunk_r.aabb
    assert tables.alpha_masked == tables_r.alpha_masked == masked
    if masked:
        np.testing.assert_array_equal(
            chunk.tri_mask.numpy().astype(np.uint32), chunk_r.tri_mask)
    _assert_tables_equal(tables.treelets, tables_r.treelets)

    perm = bvh.apply_permutation((None, order, padded), {
        "nrm": np.tile(np.float32([0, 0, 1]), (len(tri), 3, 1)),
        "tan": np.tile(np.float32([1, 0, 0]), (len(tri), 3, 1)),
        "uv": np.zeros((len(tri), 3, 2), np.float32),
        "mat": np.arange(len(tri), dtype=np.int32) % 5})
    if not masked:
        shaded = dispatch.attach_shade_tables(
            tables, perm["nrm"], perm["mat"], False)
        shaded_r = dispatch_ref.attach_shade_tables(
            tables_r, perm["nrm"], perm["tan"], perm["uv"], perm["mat"],
            textured=False)
        assert shaded.shade_mode == shaded_r.shade_mode == 1
        _assert_tables_equal(shaded.treelets, shaded_r.treelets)

    # The two queries route through the scheduler and agree with the flat
    # tables of the same triangles (their masks included).
    flat_tables, flat_order, _ = dispatch.prepare_tables(
        tri, ds, "cpu", leaf_size=LEAF, tri_alpha_mask=mask)
    np.testing.assert_array_equal(order, flat_order)
    assert flat_tables.treelets is None
    o, d = _rays(600, 5)
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    rec = dispatch.trace_nearest(tables, o_t, d_t, 1e-3, 1e4)
    flat = dispatch.trace_nearest(flat_tables, o_t, d_t, 1e-3, 1e4)
    assert torch.equal(rec["hit"], flat["hit"]) and rec["hit"].sum() > 5
    assert torch.equal(rec["tri"], flat["tri"])
    np.testing.assert_allclose(rec["t"].numpy(), flat["t"].numpy(), rtol=0,
                               atol=T_ATOL)
    assert torch.equal(dispatch.trace_any(tables, o_t, d_t, 1e-3, 40.0),
                       dispatch.trace_any(flat_tables, o_t, d_t, 1e-3, 40.0))


def test_wrapper_runs_plain_on_cpu_and_checks_arguments(built):
    _, _, _, tt, _ = built
    o, d = _rays(2 * BLOCK, 3)
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)

    def picked():
        state = treelets.treelet_state(tt, o_t, d_t, 1e-3, 1e4, block=BLOCK)
        cuda_traverse.treelet_pick(tt, state)
        return state

    before = dict(cuda_traverse.LAUNCHES)
    state, plain = picked(), picked()
    assert torch.equal(state.keys, plain.keys)
    cuda_traverse.trace_treelet_round(tt, state, 0)
    cuda_traverse.trace_treelet_round_plain(tt, plain, 0)
    for name in ("t_far", "visited", "keys"):
        assert torch.equal(getattr(state, name), getattr(plain, name)), name
    for key in plain.rec:
        assert torch.equal(state.rec[key], plain.rec[key]), key
    assert cuda_traverse.LAUNCHES == before  # the CPU never launches
    # Triangle ids are global: within the treelet the packet picked.
    pid = cuda_traverse.key_treelets(plain.keys[0], BLOCK, tt.count)
    lo = tt.tri_offsets[pid.long()].repeat_interleave(BLOCK)
    rows = tt.tri_stack.shape[1]
    hit = state.rec["tri"] >= 0
    assert hit.any()
    assert ((state.rec["tri"] >= lo) & (state.rec["tri"] < lo + rows
                                        * bvh.TRI_PER_ROW))[hit].all()
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_traverse.treelet_launcher(tt, state, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_traverse.treelet_pick_launcher(tt, state)
    with pytest.raises(ValueError, match="whole packets"):
        cuda_traverse._check_state(tt, dataclasses.replace(
            state, block=3 * BLOCK), False)
    with pytest.raises(ValueError, match="state.entry"):
        cuda_traverse._check_state(tt, dataclasses.replace(
            state, entry=state.entry[:, :1]), False)
    with pytest.raises(ValueError, match="needs a shade stack"):
        cuda_traverse.trace_treelet_round(
            dataclasses.replace(tt, shade_mode=1), state, 1)
