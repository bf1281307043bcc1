"""The treelet scheduler's in-place rounds and key-packed pick
(steeljax_torch.accel.treelets, cuda_traverse.trace_treelet_round_plain and
pick_keys_plain, the plain versions of csrc/treelet8.cu) against the
reference on the CPU.

Trace: kernel_parity's soup cut at 4,096 triangles, leaf size 24.  The
port's plain round runs through the K-round loop the card runs (one pick,
then exactly K rounds, no early exit) and is held against the reference's
`steeljax.accel.treelets.trace_treelets` with its own plain round: a
brute-force JAX intersector per packet over the packet's treelet records
(the reference's Pallas round cannot run on the CPU, pallas_traverse.py:
68-72), with the culling rule, the coarse masks of the AUX words
(`steeljax.accel.alphamask.mask_test`) and the fused shading of modes 1 and
2.  Shade modes 0, 1 and 2, any-hit and coarse alpha: equal hits (and
flags), |delta t| < 2e-3, triangle ids differing only on exact-t ties, the
shading fields within 5e-3 where the ids agree.  The loop that leaves once
no packet is left gives the same record.

Pick: the key-packed minimum against the reference's `_next_pid` on
entry distances with ties across rays and treelets, negative distances,
-0 beside +0, an all-inf packet and a packet that is partly padding, for K
in one and in two 32-bit visited words.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from steeljax.accel import alphamask as alphamask_ref
from steeljax.accel import pallas_traverse as ptv
from steeljax.accel import treelets as treelets_ref
from steeljax_torch.accel import cuda_traverse, treelets
from steeljax_torch.accel.bvh import TRI_PER_ROW, apply_permutation, build_bvh
from steeljax_torch.apps import kernel_parity as kp
from steeljax_torch.core.constants import RAY_DEAD_T
from test_torch_support import one_torch_thread  # noqa: F401

N_TRIS = 12_000
N_RAYS = 768
BLOCK = 256
T_ATOL = 2e-3
ATTR_ATOL = 5e-3
CASES = {  # name: (textured, alpha, any_hit)
    "shade0": (None, False, False),
    "shade1": (False, False, False),
    "shade2": (True, False, False),
    "anyhit": (None, False, True),
    "alpha": (None, True, False),
}


def _reference_tables(tt, alpha: bool):
    """The reference's treelet tables of the soup treelet_soup_case cut:
    the same global tree and packed rows through the reference's cut and
    stacking (and shade stack), held equal to the port's."""
    tris = kp._soup(N_TRIS, 1)
    r = np.random.default_rng(2)
    ds = r.uniform(size=N_TRIS) < 0.3
    arrays = {"pos": tris, "ds": ds,
              "nrm": kp._norm(r.normal(size=(N_TRIS, 3, 3))).astype(
                  np.float32),
              "tan": kp._norm(r.normal(size=(N_TRIS, 3, 3))).astype(
                  np.float32),
              "uv": r.uniform(size=(N_TRIS, 3, 2)).astype(np.float32),
              "mat": r.integers(0, 7, N_TRIS).astype(np.int32)}
    if alpha:
        arrays["mask"] = np.random.default_rng(5).integers(
            0, alphamask_ref.MASK_FULL + 1, N_TRIS).astype(np.uint32)
    bvh, order, padded = build_bvh(tris, 24)
    perm = apply_permutation((None, order, padded), arrays)
    packed = cuda_traverse.pack_tris(perm["pos"], perm["ds"],
                                     tri_alpha_mask=perm.get("mask"))
    tt_r = treelets_ref.build_treelet_tables(bvh.nodes, packed, 24,
                                             max_tris=4096)
    tt_r = tt_r.replace(alpha_mask=alpha)
    if tt.shade_mode:
        textured = tt.shade_mode == 2
        shade = ptv.pack_shade_records(perm["nrm"], perm["tan"], perm["uv"],
                                       perm["mat"], textured)
        tt_r = treelets_ref.attach_shade_stack(tt_r, shade, tt.shade_mode)
    for name in ("node_stack", "tri_stack", "tri_offsets", "shade_stack"):
        if name == "shade_stack" and not tt.shade_mode:
            continue
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(tt_r, name)))
    return tt_r


def _reference_round(tt_r, block: int, cull: bool, any_hit: bool):
    """The reference scheduler's plain round: per packet, every record of
    its treelet (the reference's packed rows) against every ray, the
    nearest accepted candidate (or any, for occlusion), with the fused
    shading of tt_r.shade_mode at the winner.  Returns treelet-local ids."""
    tri_rows = np.asarray(tt_r.tri_stack)
    k, r = tri_rows.shape[:2]
    rec = jnp.asarray(tri_rows[:, :, :TRI_PER_ROW * 10].reshape(
        k, r * TRI_PER_ROW, 10))
    mode = 0 if any_hit else int(tt_r.shade_mode)
    if mode:
        per, stride = (TRI_PER_ROW, 10) if mode == 1 else (4, 26)
        shade = jnp.asarray(np.asarray(tt_r.shade_stack)[
            :, :, :per * stride].reshape(k, -1, stride))

    def one_packet(pid, o, d, tmn, tmx):
        recs = rec[pid]
        v0, e1, e2, f9 = recs[:, 0:3], recs[:, 3:6], recs[:, 6:9], recs[:, 9]
        p = jnp.cross(d[:, None, :], e2[None])
        det = jnp.sum(e1[None] * p, axis=-1)
        det_ok = jnp.abs(det) > 1e-12
        inv = 1.0 / jnp.where(det_ok, det, 1.0)
        tv = o[:, None, :] - v0[None]
        u = jnp.sum(tv * p, axis=-1) * inv
        q = jnp.cross(tv, e1[None])
        v = jnp.sum(d[:, None, :] * q, axis=-1) * inv
        t = jnp.sum(e2[None] * q, axis=-1) * inv
        if tt_r.alpha_mask:
            aux = f9.astype(jnp.int32)
            ds, mask = (aux & 1) == 1, aux >> 1
        else:
            ds, mask = f9 > 0.5, None
        facing = det_ok
        if cull and not any_hit:
            facing = (det > 1e-12) | (ds[None] & det_ok)
        ok = (facing & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (t >= tmn[:, None]) & (t <= tmx[:, None]))
        if mask is not None:
            ok = ok & alphamask_ref.mask_test(mask[None], u, v)
        t = jnp.where(ok, t, jnp.inf)
        best = jnp.argmin(t, axis=1)
        pick = best[:, None]
        bt = jnp.take_along_axis(t, pick, 1)[:, 0]
        hit = jnp.isfinite(bt)
        out = {"t": jnp.where(hit, bt, -1.0),
               "tri": jnp.where(hit, best.astype(jnp.int32), -1),
               "u": jnp.take_along_axis(u, pick, 1)[:, 0],
               "v": jnp.take_along_axis(v, pick, 1)[:, 0], "hit": hit}
        if mode:
            s = shade[pid][best]
            bu, bv = out["u"][:, None], out["v"][:, None]
            wb = 1.0 - bu - bv

            def interp(a, b, c):
                return s[:, a] * wb + s[:, b] * bu + s[:, c] * bv

            n = interp(slice(0, 3), slice(3, 6), slice(6, 9))
            bdet = jnp.take_along_axis(det, pick, 1)
            sgn = jnp.where(bdet < 0.0, -1.0, 1.0)
            out["n"] = n * sgn * jax.lax.rsqrt(jnp.maximum(
                jnp.sum(n * n, -1, keepdims=True), 1e-20))
            out["mat"] = s[:, 9].astype(jnp.int32)
            if mode == 2:
                tan = interp(slice(10, 13), slice(13, 16), slice(16, 19))
                out["tan"] = tan * jax.lax.rsqrt(jnp.maximum(
                    jnp.sum(tan * tan, -1, keepdims=True), 1e-20))
                out["uv"] = interp(slice(19, 21), slice(21, 23),
                                   slice(23, 25))
                out["uvd"] = s[:, 25]
        return out

    def trace(pid, o, d, tmn, tmx):
        out = jax.vmap(one_packet)(
            pid, o.reshape((-1, block, 3)), d.reshape((-1, block, 3)),
            tmn.reshape((-1, block)), tmx.reshape((-1, block)))
        return {key: val.reshape((-1,) + val.shape[2:])
                for key, val in out.items()}

    return trace


def _k_rounds(tt, o, d, t_max, cull, any_hit):
    """The card's loop on the CPU: one pick, then exactly K rounds through
    the wrappers (the plain versions for CPU tensors)."""
    state = treelets.treelet_state(tt, o, d, 1e-3, t_max, any_hit, BLOCK)
    cuda_traverse.treelet_pick(tt, state)
    for r in range(tt.count):
        cuda_traverse.trace_treelet_round(tt, state, r, cull, any_hit)
    rec = state.rec
    if not any_hit:
        rec = {"hit": rec["tri"] >= 0, **rec}
    return {key: val[:o.shape[0]] for key, val in rec.items()}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    textured, alpha, any_hit = CASES[request.param]
    tt, perm = kp.treelet_soup_case(N_TRIS, "cpu", textured=textured,
                                    alpha=alpha)
    return request.param, tt, _reference_tables(tt, alpha), any_hit


def test_k_round_loop_matches_reference(case):
    name, tt, tt_r, any_hit = case
    assert tt.count >= 3
    o, d = kp._rays(N_RAYS, 11)
    t_max, cull = (40.0, False) if any_hit else (1000.0, True)
    rec = _k_rounds(tt, torch.from_numpy(o), torch.from_numpy(d), t_max,
                    cull, any_hit)
    with jax.disable_jit():
        ref = treelets_ref.trace_treelets(
            tt_r, jnp.asarray(o), jnp.asarray(d), 1e-3, t_max,
            cull_backface=cull, any_hit=any_hit,
            packet_sublanes=BLOCK // ptv.LANES,
            trace_fn=_reference_round(tt_r, BLOCK, cull, any_hit))
    ref = {key: np.asarray(val) for key, val in ref.items()}
    hit = rec["hit"].numpy()
    np.testing.assert_array_equal(hit, ref["hit"])
    assert N_RAYS // 20 < hit.sum() < N_RAYS
    if any_hit:
        assert sorted(rec) == ["hit"]
        return
    t, t_ref = rec["t"].numpy(), ref["t"]
    assert np.abs(t - t_ref).max() < T_ATOL
    same = rec["tri"].numpy() == ref["tri"]
    # Where the ids differ, both candidates lie at the same t: a tie the
    # two walks settle otherwise.
    assert (~same).sum() <= 2
    assert np.abs(t - t_ref)[~same].max(initial=0.0) < 1e-6
    for key in ("u", "v", "n", "tan", "uv", "uvd"):
        if key in ref:
            err = np.abs(rec[key].numpy() - ref[key])[same & hit]
            assert err.max(initial=0.0) < ATTR_ATOL, (name, key)
    if "mat" in ref:
        np.testing.assert_array_equal(rec["mat"].numpy()[same & hit],
                                      ref["mat"][same & hit])


def test_early_exit_loop_gives_the_k_round_record(case):
    """The CPU loop leaves once no packet is left: the same record as the
    K rounds, with one host read per round it ran and one to leave."""
    _, tt, _, any_hit = case
    o, d = kp._rays(N_RAYS, 13)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    t_max, cull = (40.0, False) if any_hit else (1000.0, True)
    before = treelets.SCHEDULER["host_reads"]
    rec = treelets.trace_treelets(tt, o, d, 1e-3, t_max, cull, any_hit,
                                  block=BLOCK)
    reads = treelets.SCHEDULER["host_reads"] - before
    assert 1 < reads <= tt.count + 1
    full = _k_rounds(tt, o, d, t_max, cull, any_hit)
    assert sorted(rec) == sorted(full)
    for key in rec:
        assert torch.equal(rec[key], full[key]), key


def _visited_words(visited: np.ndarray) -> torch.Tensor:
    """(N, K) bool -> (N, ceil(K / 32)) int32 words, treelet j at bit j % 32
    of word j // 32."""
    n, k = visited.shape
    words = np.zeros((n, -(-k // 32)), np.uint32)
    for j in range(k):
        words[:, j // 32] |= visited[:, j].astype(np.uint32) << (j % 32)
    return torch.from_numpy(words.view(np.int32))


def _pick_inputs(k: int, seed: int):
    """Entry distances of 4 packets of BLOCK rays: packet 0 general (ties
    across rays and treelets, negative distances, -0 beside +0), packet 1
    all inf, packet 2 partly padding (dead intervals, inf entries), packet
    3 one finite entry on its last ray."""
    r = np.random.default_rng(seed)
    n = 4 * BLOCK
    entry = r.choice(np.float32([-2.5, -1.0, -0.0, 0.0, 0.5, 3.0, 7.0,
                                 np.inf]), size=(n, k)).astype(np.float32)
    t_far = r.uniform(1.0, 9.0, n).astype(np.float32)
    visited = r.uniform(size=(n, k)) < 0.3
    entry[BLOCK:2 * BLOCK] = np.inf
    entry[2 * BLOCK + 100:3 * BLOCK] = np.inf
    t_far[2 * BLOCK + 100:3 * BLOCK] = RAY_DEAD_T
    entry[3 * BLOCK:] = np.inf
    entry[4 * BLOCK - 1, k - 1] = 2.0
    visited[4 * BLOCK - 1, k - 1] = False
    t_far[4 * BLOCK - 1] = 9.0
    return entry, visited, t_far


@pytest.mark.parametrize("k", [3, 15, 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_key_packed_pick_equals_next_pid(k, seed):
    entry, visited, t_far = _pick_inputs(k, seed)
    visited |= ~np.isfinite(entry)  # the reference's initial visited set
    keys = cuda_traverse.pick_keys_plain(
        torch.from_numpy(entry), _visited_words(visited),
        torch.from_numpy(t_far), BLOCK)
    assert keys.dtype == torch.int64 and keys.shape == (4,)
    pid = cuda_traverse.key_treelets(keys, BLOCK, k)
    pid_r = np.asarray(treelets_ref._next_pid(
        jnp.asarray(entry), jnp.asarray(visited), jnp.asarray(t_far), BLOCK))
    np.testing.assert_array_equal(pid.numpy(), pid_r)
    assert pid[1] == k and pid[3] == k - 1
    # The key's ray field is the reference's packet-wide argmin ray.
    masked = np.where(visited | (entry >= t_far[:, None]), np.inf, entry)
    ray_ix = np.argmin(masked.min(axis=1).reshape(-1, BLOCK), axis=1)
    tb = 32 - cuda_traverse.ray_bits(BLOCK)
    np.testing.assert_array_equal(((keys & 0xFFFFFFFF) >> tb).numpy(),
                                  ray_ix)


def test_pick_orders_negative_zero_and_ties_as_argmin():
    """-0 and +0 tie (the first ray wins, as argmin), a negative distance
    beats both, and an empty key decodes as a finished packet."""
    k = 4
    entry = np.full((BLOCK, k), np.inf, np.float32)
    entry[5, 2] = 0.0
    entry[3, 1] = -0.0
    t_far = np.full(BLOCK, 5.0, np.float32)
    none = torch.zeros((BLOCK, 1), dtype=torch.int32)
    pid = cuda_traverse.key_treelets(cuda_traverse.pick_keys_plain(
        torch.from_numpy(entry), none, torch.from_numpy(t_far), BLOCK),
        BLOCK, k)
    assert pid.tolist() == [1]
    entry[200, 3] = -1e-30
    pid = cuda_traverse.key_treelets(cuda_traverse.pick_keys_plain(
        torch.from_numpy(entry), none, torch.from_numpy(t_far), BLOCK),
        BLOCK, k)
    assert pid.tolist() == [3]
    empty = torch.tensor([cuda_traverse.EMPTY_KEY])
    assert cuda_traverse.key_treelets(empty, BLOCK, k).tolist() == [k]


def test_treelet_records_equal_their_stack_rows(case):
    """K7 reads tri_records: record j of treelet i is the 48-byte copy of
    row j // 12 of tri_stack[i], [v0, f9], [e1, 0], [e2, 0]."""
    _, tt, _, _ = case
    k, rows = tt.tri_stack.shape[:2]
    recs = tt.tri_records.reshape(k, rows * TRI_PER_ROW, 12)
    src = tt.tri_stack[:, :, :TRI_PER_ROW * 10].reshape(
        k, rows * TRI_PER_ROW, 10)
    assert torch.equal(recs[..., 0:3], src[..., 0:3])
    assert torch.equal(recs[..., 3], src[..., 9])
    assert torch.equal(recs[..., 4:7], src[..., 3:6])
    assert torch.equal(recs[..., 8:11], src[..., 6:9])
    assert not recs[..., 7].any() and not recs[..., 11].any()
