"""The port's raster G-buffer against the reference on the CPU.

At 128x72 on the Cornell box (sphere detail 8, as tests/test_raster.py) the
port's render/hybrid/raster.py is held to steeljax's on the same scene and
camera: supported() and to_tiled(), prepare_raster's arrays, the piece
records and keys, raster_stats, raster_rec within kernel_parity's _compare
budgets (at most max(2, N/5000) hit mismatches, triangle ids differing only
where the depths agree, |dt| < 2e-3, |du|, |dv| < 5e-3), the tie rule
(WINDOW 16 and 256 identical), the near-plane clipper, a small foliage scene
through raster_or_trace_opaque, and the port's raster against the port's
own traced visibility.  Then the hybrid frame at 64x48 with
STEELJAX_RASTER=1.

On the CPU the tile stage runs its plain version (_raster_tiles_plain);
chip_smoke.py holds the kernel csrc/raster.cu to it on the card.  Here a
Python model of the kernel's order (slice tags, chunks of candidates culled
by bounding box and compacted in walk order, the strips' reject, the
winner's attributes at the end) is held bit-equal to the plain version on
tie-heavy records at WINDOW 1, 3, 16 and 256 and on the Cornell frame, the
plain version is held to the reference's _raster_tiles on those records
(the same depths and triangles at every pixel), and the strips' corner
bound, which the kernel's culls rest on, is held on
random forms.

The reference evaluates the linear forms with a (768, 3) @ (3, 7 * WINDOW)
product, the port element by element in float32; at grazing pixels of a
large triangle the reference's product is the less exact of the two
(foliage, 128x72: w_eye 16.812454 in the reference, 16.808817 in the port,
16.808829 in float64).  So a pixel whose |dt| passes 2e-3 counts against
the same max(2, N/5000) budget as a hit mismatch.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax.core import camera as camera_ref
from steeljax.env.environment import load_environment as load_env_ref
from steeljax.env.sky import procedural_sky_cube as sky_cube_ref
from steeljax.render.hybrid import gbuffer as gbuffer_ref
from steeljax.render.hybrid import raster as raster_ref
from steeljax.render.hybrid.renderer import HybridRenderer as HybridRef
from steeljax.render.pt import renderer as renderer_ref
from steeljax.render.pt.integrator import tiled_order as tiled_order_ref
from steeljax.scene import builtin as builtin_ref
from steeljax.core.config import RenderConfig as RenderConfigRef
from steeljax_torch.convert import from_jax_environment
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.render.hybrid import gbuffer
from steeljax_torch.render.hybrid import raster
from steeljax_torch.render.hybrid.renderer import HybridRenderer
from steeljax_torch.render.pt import renderer
from steeljax_torch.render.pt.integrator import detile, tiled_order
from steeljax_torch.scene import builtin
from test_raster import _compare as compare_traced
from test_raster import _rays
from test_torch_hybrid import TINY_ENV
from test_torch_support import one_torch_thread  # noqa: F401

W, H = 128, 72
N = W * H


def _np(rec):
    return {k: np.asarray(v) for k, v in rec.items()}


def parity(ours: dict, ref: dict, label: str) -> None:
    """kernel_parity._compare's budgets between two records of the same
    rays: at most max(2, N/5000) pixels with another hit flag or, where
    both hit, |dt| >= 2e-3; triangle ids differ only where the depths
    agree; |du|, |dv| < 5e-3 where the triangle is the same."""
    ours, ref = _np(ours), _np(ref)
    n = ours["hit"].shape[0]
    both = ours["hit"] & ref["hit"]
    dt = np.abs(ours["t"] - ref["t"])
    far = both & (dt >= 2e-3)
    mismatches = int((ours["hit"] != ref["hit"]).sum() + far.sum())
    print(f"{label}: {int((ours['hit'] != ref['hit']).sum())} hit "
          f"mismatches, {int(far.sum())} |dt| >= 2e-3 (max "
          f"{float(dt[both].max()):.3e}) of {n}")
    assert mismatches <= max(2, n // 5000), mismatches
    assert both.sum() > n // 10
    # A triangle id that differs is held by the |dt| budget: only a tie
    # of depths passes it.
    same = both & (ours["tri"] == ref["tri"])
    for k in ("u", "v"):
        assert np.abs(ours[k] - ref[k])[same].max() < 5e-3, k


@pytest.fixture(scope="module")
def cornell():
    """Both packages' Cornell box at W x H: (port flat, tables, raster
    scene), (reference ...), frame, tile, o, d (numpy, tiled order)."""
    scene_r = builtin_ref.make_cornell_scene(sphere_detail=8)
    flat_r, tables_r = renderer_ref.prepare_scene(scene_r, env_resolution=16)
    scene = builtin.make_cornell_scene(sphere_detail=8)
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16)
    frame = camera_ref.make_frame(scene_r.camera_location,
                                  scene_r.camera_projection)
    px, py, tile = tiled_order_ref(W, H)
    o, d = (np.array(x) for x in _rays(frame, W, H, px, py))
    return ((flat, tables, raster.prepare_raster(flat, tables)),
            (flat_r, tables_r, raster_ref.prepare_raster(flat_r, tables_r)),
            frame, tile, o, d)


def _rec(cornell):
    (_, _, rscene), _, frame, tile, _, d = cornell
    return raster.raster_rec(rscene, torch.from_numpy(frame.view_proj), W,
                             H, tile, torch.from_numpy(d),
                             frame.camera_near)


def _rec_ref(cornell):
    _, (_, _, rscene), frame, tile, _, d = cornell
    return raster_ref.raster_rec(rscene, jnp.asarray(frame.view_proj), W, H,
                                 tile, jnp.asarray(d), frame.camera_near)


@pytest.mark.parametrize("size", [(1920, 1080), (1280, 720), (W, H),
                                  (128, 64), (100, 72), (128, 30)])
def test_supported_agrees(size):
    assert raster.supported(*size) == raster_ref.supported(*size)


def test_to_tiled_agrees():
    _, _, tile = tiled_order(W, H)
    values = np.arange(W * H * 2, dtype=np.int32).reshape(-1, 2)
    ours = raster.to_tiled(torch.from_numpy(values), W, H, tile).numpy()
    ref = np.asarray(raster_ref.to_tiled(jnp.asarray(values), W, H, tile))
    np.testing.assert_array_equal(ours, ref)
    # The inverse of the tiled order: raster order back to rows.
    frame = detile(raster.to_tiled(torch.from_numpy(values), W, H, tile),
                   W, H, tile).numpy()
    rows = values.reshape(H // raster.TILE_H, W // raster.TILE_W,
                          raster.TILE_H, raster.TILE_W, 2).transpose(
        0, 2, 1, 3, 4).reshape(H, W, 2)
    np.testing.assert_array_equal(frame, rows)


def test_prepare_raster_arrays_equal(cornell):
    (_, _, ours), (_, _, ref), *_ = cornell
    for name in ("v0", "e1", "e2", "double_sided", "in_raster"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)


def test_prepare_raster_none_for_instanced_and_treelets():
    from steeljax_torch.accel.instances import InstancedAccel

    scene = builtin.make_parity_scene(4)
    for kwargs in ({"accel": InstancedAccel(device="cpu")},
                   {"treelets": True}):
        flat, tables = renderer.prepare_scene(scene, "cpu",
                                              env_resolution=16, **kwargs)
        assert raster.prepare_raster(flat, tables) is None


def test_piece_records_match(cornell):
    """The same clipped pieces (the reference's) through both
    _piece_records: equal keys, records within 1e-5."""
    _, (_, _, rscene), frame, *_ = cornell
    verts = jnp.stack([rscene.v0, rscene.v0 + rscene.e1,
                       rscene.v0 + rscene.e2], axis=1)
    clip = jnp.concatenate([verts, jnp.ones(verts.shape[:2] + (1,))],
                           -1) @ jnp.asarray(frame.view_proj).T
    bary = jnp.broadcast_to(jnp.eye(3)[None], clip.shape[:1] + (3, 3))
    w_eps = max(frame.camera_near * 0.5, 1e-4)
    (pa, ba, va), (pb, bb, vb) = raster_ref._clip_near(clip, bary, w_eps)
    pieces = (np.concatenate([pa, pb]), np.concatenate([ba, bb]),
              np.concatenate([va, vb]) & np.concatenate(
                  [rscene.in_raster] * 2),
              np.concatenate([rscene.double_sided] * 2))
    ntx, nty = W // raster.TILE_W, H // raster.TILE_H
    recs_r, key_r = raster_ref._piece_records(
        *(jnp.asarray(x) for x in pieces), W, H, ntx, nty)
    recs, key = raster._piece_records(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in pieces), W, H,
        ntx, nty)
    np.testing.assert_array_equal(key.numpy(), np.asarray(key_r))
    np.testing.assert_allclose(recs.numpy(), np.asarray(recs_r), rtol=1e-5,
                               atol=1e-5)
    assert (key.numpy() < raster._KEY_CULL).sum() > 100


def test_raster_stats_equal(cornell):
    (_, _, ours), (_, _, ref), frame, *_ = cornell
    stats = raster.raster_stats(ours, torch.from_numpy(frame.view_proj), W,
                                H, frame.camera_near)
    stats_r = raster_ref.raster_stats(ref, jnp.asarray(frame.view_proj), W,
                                      H, frame.camera_near)
    assert stats == stats_r
    assert stats["big_count"] > 0


def test_raster_rec_matches_reference(cornell):
    rec = _rec(cornell)
    assert float(rec["hit"].float().mean()) > 0.3
    parity(rec, _rec_ref(cornell), "Cornell raster_rec")


def test_dense_segments_slice_correctly(cornell, monkeypatch):
    """WINDOW 16 forces many slices a segment: the tie rule (last of the
    greatest z within a slice, strictly greater across slices) gives the
    records of WINDOW 256 exactly, as in the reference's test."""
    rec_a = _rec(cornell)
    monkeypatch.setattr(raster, "WINDOW", 16)
    rec_b = _rec(cornell)
    for k in ("hit", "tri", "t", "u", "v"):
        np.testing.assert_array_equal(rec_a[k].numpy(), rec_b[k].numpy())


def test_tile_stage_tie_rule():
    """Two coplanar pieces covering one subtile at the same z: within a
    slice the later one wins; split over two slices, the earlier one keeps
    the pixel (a later slice needs a strictly greater z)."""
    ntx = 1
    rec = np.zeros((2, 24), np.float32)
    for i, row in enumerate(rec):
        row[0:9] = [0, 0, 1] * 3      # every edge form = 1: inside
        row[9:12] = [0, 0, 0.5]       # Fw
        row[12:15] = [0, 0, 0.1 * (i + 1)]
        row[18:21] = [0, 0, 0.25]     # Z
        row[21] = 7 + i
    recs = torch.from_numpy(np.concatenate([rec, np.zeros((16, 24),
                                                          np.float32)]))
    one = torch.ones(1, dtype=torch.int32)
    zero = torch.zeros(1, dtype=torch.int32)
    segs = (zero, zero, zero, 2 * one, zero, zero)
    out = raster._raster_tiles(recs, zero, segs, ntx)
    assert (out[4] == 8).all() and (out[0] == 0.25).all()
    segs = (zero, one, one, one, zero, zero)   # piece 0, then piece 1
    out = raster._raster_tiles(recs, zero, segs, ntx)
    assert (out[4] == 7).all()
    np.testing.assert_allclose(out[1].numpy(), 0.1)


def test_clip_near_matches_reference():
    """Random triangles straddling w = eps (0, 1, 2 or 3 vertices
    inside)."""
    rng = np.random.default_rng(3)
    p = rng.normal(size=(400, 3, 4)).astype(np.float32)
    eps = 0.05
    p[..., 3] = eps + rng.normal(scale=0.5, size=(400, 3)).astype(np.float32)
    bary = np.broadcast_to(np.eye(3, dtype=np.float32), (400, 3, 3))
    ours = raster._clip_near(torch.from_numpy(p),
                             torch.from_numpy(bary.copy()), eps)
    ref = raster_ref._clip_near(jnp.asarray(p), jnp.asarray(bary),
                                jnp.float32(eps))
    counts = (p[..., 3] >= eps).sum(-1)
    assert set(counts.tolist()) == {0, 1, 2, 3}
    for piece, piece_r in zip(ours, ref):
        for a, b in zip(piece, piece_r):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)


def test_foliage_raster_or_trace_opaque_matches_reference():
    """A small foliage scene (60 alpha-tested double-sided cards): the
    raster and the bounded alpha re-trace against the reference's."""
    scene_r = builtin_ref.make_foliage_scene(cards=60)
    flat_r, tables_r = renderer_ref.prepare_scene(scene_r, env_resolution=16)
    scene = builtin.make_foliage_scene(cards=60)
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16)
    assert flat.any_alpha_test
    frame = camera_ref.make_frame(scene_r.camera_location,
                                  scene_r.camera_projection)
    px, py, tile = tiled_order_ref(W, H)
    o, d = _rays(frame, W, H, px, py)
    ref = gbuffer_ref.raster_or_trace_opaque(
        flat_r, tables_r, o, d, frame.camera_near, frame.camera_far, 4,
        (raster_ref.prepare_raster(flat_r, tables_r), W, H, tile),
        jnp.asarray(frame.view_proj))
    ours = gbuffer.raster_or_trace_opaque(
        flat, tables, torch.from_numpy(np.array(o)),
        torch.from_numpy(np.array(d)), frame.camera_near, frame.camera_far,
        4, (raster.prepare_raster(flat, tables), W, H, tile),
        torch.from_numpy(frame.view_proj))
    parity(ours, ref, "foliage raster_or_trace_opaque")


@pytest.mark.parametrize("name,budget", [("cornell", 0.02),
                                         ("stress", 0.03)])
def test_raster_matches_port_trace(name, budget):
    """The port's raster against the port's traced visibility, within
    tests/test_raster.py's budgets: Cornell (2%) and its stress scene (12
    instances of sphere detail 10, 3%; the reference's own stress test
    runs only with RUN_SLOW, for its trace's sake)."""
    scene = (builtin.make_cornell_scene(sphere_detail=8) if name == "cornell"
             else builtin.make_stress_scene(instances=12, sphere_detail=10))
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16)
    frame = camera_ref.make_frame(scene.camera_location,
                                  scene.camera_projection)
    px, py, tile = tiled_order(W, H)
    o, d = (torch.from_numpy(np.array(x)) for x in _rays(frame, W, H, px,
                                                          py))
    rec = raster.raster_rec(raster.prepare_raster(flat, tables),
                            torch.from_numpy(frame.view_proj), W, H, tile, d,
                            frame.camera_near)
    assert float(rec["hit"].float().mean()) > 0.3
    rec_t = gbuffer.trace_opaque(flat, tables, o, d, frame.camera_near,
                                 frame.camera_far, 4)
    compare_traced(_np(rec), _np(rec_t), d.numpy(), budget=budget)


# The hybrid frame with STEELJAX_RASTER=1.
FW, FH = 64, 48


@pytest.fixture(scope="module")
def frames():
    """The Cornell frame at FW x FH with the raster: the port's, the
    port's traced one, the reference's, and both raster records in row
    order."""
    mp = pytest.MonkeyPatch()
    mp.setenv("STEELJAX_RASTER", "1")
    try:
        env_r = load_env_ref(cube=sky_cube_ref(16), **TINY_ENV)
        scene_r = builtin_ref.make_cornell_scene(sphere_detail=8)
        ref = HybridRef(scene_r, FW, FH, RenderConfigRef(width=FW, height=FH),
                        environment=env_r, prepared=tuple(
                            renderer_ref.prepare_scene(scene_r,
                                                       env_resolution=16)))
        assert ref.raster_scene is not None
        scene = builtin.make_cornell_scene(sphere_detail=8)
        ours = HybridRenderer(scene, FW, FH,
                              RenderConfig(width=FW, height=FH),
                              environment=from_jax_environment(env_r, "cpu"),
                              prepared=renderer.prepare_scene(
                                  scene, "cpu", env_resolution=16),
                              device="cpu")
    finally:
        mp.undo()
    raster_frame = ours.render_frame()
    engaged = ours.raster_scene is not None
    ref_frame = np.asarray(ref.render_frame())
    px, py, tile = tiled_order(FW, FH)
    o, d = _rays(ref.frame, FW, FH, px, py)
    rec = raster.raster_rec(ours.raster_scene, ours.matrices[2], FW, FH,
                            tile, torch.from_numpy(np.array(d)),
                            ours.frame.camera_near)
    rec_r = raster_ref.raster_rec(ref.raster_scene,
                                  jnp.asarray(ref.frame.view_proj), FW, FH,
                                  tile, d, ref.frame.camera_near)
    rows = {}
    for name, r in (("ours", rec), ("ref", rec_r)):
        rows[name] = {k: detile(torch.as_tensor(np.array(r[k]))[:, None],
                                FW, FH, tile).reshape(-1).numpy()
                      for k in ("hit", "tri", "t", "u", "v")}
    ours.raster_scene = None
    traced_frame = ours.render_frame()
    return engaged, raster_frame, traced_frame, ref_frame, rows


def test_hybrid_renderer_engages_raster(frames):
    engaged, raster_frame, traced_frame, _, _ = frames
    assert engaged
    assert raster_frame.shape == (FH, FW, 3)
    assert np.isfinite(raster_frame).all() and raster_frame.std() > 0.0
    rmse = float(np.sqrt(np.mean((raster_frame - traced_frame) ** 2)))
    assert rmse < 0.02, rmse


def test_hybrid_raster_frame_matches_reference(frames):
    """Within 1e-4 of the reference's raster frame wherever the two raster
    records agree (the same hit and triangle, t within 1e-5 relative, u and
    v within 1e-5), but for tests/test_torch_hybrid.py's budget: the
    G-buffer quantizes to 8 and 10 bits, and a last-bit difference can move
    a value across a rounding boundary, so at most max(2, N/500) of those
    pixels may pass 1e-4, none 2e-2 (measured at 64x48: one sphere pixel,
    1.1e-4).  The reference's product moves u and v by up to about 5e-5 at
    some pixels (the module's docstring): those pixels' records differ."""
    _, raster_frame, _, ref_frame, rows = frames
    ours, ref = rows["ours"], rows["ref"]
    agree = ((ours["hit"] == ref["hit"]) & (ours["tri"] == ref["tri"])
             & (np.abs(ours["t"] - ref["t"])
                <= 1e-5 * np.maximum(np.abs(ref["t"]), 1.0))
             & (np.abs(ours["u"] - ref["u"]) <= 1e-5)
             & (np.abs(ours["v"] - ref["v"]) <= 1e-5))
    assert agree.mean() > 0.99
    delta = np.abs(raster_frame - ref_frame).max(axis=-1).reshape(-1)
    beyond = int((delta[agree] > 1e-4).sum())
    print(f"raster frame: {int((~agree).sum())} of {agree.size} pixels' "
          f"records differ; {beyond} agreeing pixels beyond 1e-4, max "
          f"{float(delta[agree].max()):.3e}")
    assert beyond <= max(2, agree.size // 500), beyond
    assert float(delta[agree].max()) <= 2e-2


def test_hybrid_renderer_keeps_trace_without_the_variable(monkeypatch):
    monkeypatch.delenv("STEELJAX_RASTER", raising=False)
    scene = builtin.make_cornell_scene(sphere_detail=4)
    env = from_jax_environment(load_env_ref(cube=sky_cube_ref(16),
                                            **TINY_ENV), "cpu")
    def prepared():
        return renderer.prepare_scene(scene, "cpu", env_resolution=16)

    r = HybridRenderer(scene, FW, FH, RenderConfig(width=FW, height=FH),
                       environment=env, prepared=prepared(), device="cpu")
    assert r.raster_scene is None
    monkeypatch.setenv("STEELJAX_RASTER", "1")
    r.refresh_scene(prepared())
    assert r.raster_scene is not None


# The raster kernel's order (csrc/raster.cu), modelled in Python.


def kernel_model(recs, tile_ids, segments, ntx, chunk, shares=1):
    """_raster_tiles as csrc/raster.cu computes it: each candidate tagged
    with its slice (segment base, then offset // WINDOW); `chunk`
    candidates at a time culled by bounding box and the covering ones kept
    in walk order; a strip's `shares` warps take the chunk's staged pieces
    32 at a time in turn (piece j of the chunk to warp (j // 32) % shares),
    each skipping the pieces strip_rejects names for the strip; a warp's
    pixel takes an inside piece on z > bz, or on z == bz with the tag of
    its winner; then the greatest (z, -tag, row) of the warps' winners;
    the winner's Fu, Fv, Fw and triangle evaluated once at the end."""
    idx = torch.arange(raster.PX)
    sub, lane = idx // raster.TILE_W, idx % raster.TILE_W
    strip = sub // raster.STRIP_ROWS
    strips = torch.arange(raster.TILE_H // raster.STRIP_ROWS)
    n = tile_ids.shape[0]
    outs = [np.full((n, raster.PX), v, np.float32)
            for v in (-1.0, 0.0, 0.0, 1.0, -1.0)]
    for i in range(n):
        tile = int(tile_ids[i])
        ty, tx = divmod(tile, ntx)
        px = (tx * raster.TILE_W + lane).to(torch.float32) + 0.5
        py = (ty * raster.TILE_H + sub).to(torch.float32) + 0.5
        rows, tags, base = [], [], 0
        for s in range(3):
            start = int(segments[2 * s][i])
            length = max(int(segments[2 * s + 1][i]), 0)
            rows += range(start, start + length)
            tags += [base + off // raster.WINDOW for off in range(length)]
            base += -(-length // raster.WINDOW)
        bz = np.full((shares, raster.PX), -1.0, np.float32)
        btag = np.full((shares, raster.PX), -1)
        brow = np.full((shares, raster.PX), -1)
        for c0 in range(0, len(rows), chunk):
            part = torch.tensor(rows[c0:c0 + chunk], dtype=torch.int64)
            part_tags = np.array(tags[c0:c0 + chunk])
            if part.numel() == 0:
                continue
            bmin = recs[part, raster._BMIN].to(torch.int64)
            bmax = recs[part, raster._BMAX].to(torch.int64)
            covers = ((tx >= bmin % 4096) & (tx <= bmax % 4096)
                      & (ty >= bmin // 4096) & (ty <= bmax // 4096))
            staged = part[covers]
            staged_tags = part_tags[covers.numpy()]
            if staged.numel() == 0:
                continue
            r = recs[staged][:, None, :]                       # (m, 1, 24)
            skip = raster.strip_rejects(r, torch.tensor(tx), torch.tensor(ty),
                                        strips)[:, strip]      # (m, PX)
            z = raster._form(r, raster._Z, px, py)              # (m, PX)
            inside = ((raster._form(r, raster._E0, px, py) >= 0.0)
                      & (raster._form(r, raster._E1, px, py) >= 0.0)
                      & (raster._form(r, raster._E2, px, py) >= 0.0)
                      & (z > 0.0) & (z <= 1.0) & ~skip).numpy()
            z = z.numpy()
            for j, (row, tag) in enumerate(zip(staged.tolist(),
                                               staged_tags)):
                w = (j // 32) % shares
                take = inside[j] & ((z[j] > bz[w]) | ((z[j] == bz[w])
                                                      & (tag == btag[w])))
                bz[w] = np.where(take, z[j], bz[w])
                btag[w] = np.where(take, tag, btag[w])
                brow[w] = np.where(take, row, brow[w])
        for w in range(1, shares):
            take = (bz[w] > bz[0]) | ((bz[w] == bz[0]) & (
                (btag[w] < btag[0]) | ((btag[w] == btag[0])
                                       & (brow[w] > brow[0]))))
            bz[0] = np.where(take, bz[w], bz[0])
            btag[0] = np.where(take, btag[w], btag[0])
            brow[0] = np.where(take, brow[w], brow[0])
        bz, brow = bz[0], brow[0]
        win = torch.from_numpy(brow >= 0)
        rw = recs[torch.from_numpy(brow).clamp(min=0)]          # (PX, 24)
        outs[0][i] = bz
        for k, base_col in ((1, raster._FU), (2, raster._FV),
                            (3, raster._FW)):
            outs[k][i] = torch.where(win, raster._form(rw, base_col, px, py),
                                     outs[k][i][0]).numpy()
        outs[4][i] = torch.where(win, rw[:, raster._TRI], -1.0).numpy()
    return tuple(torch.from_numpy(o) for o in outs)


def tie_records(seed: int, pieces: int = 360, ntx: int = 3, nty: int = 3):
    """Tie-heavy piece records over a frame of ntx x nty subtiles, from a
    seeded numpy generator: screen triangles from a pixel to the whole
    frame, each triangle's edge forms as _piece_records makes them (a
    fifth of them wound backwards: outside everywhere); depths from three
    constant values and two shared planes (coplanar pieces), so equal z
    at a pixel is common; random Fu, Fv, Fw; the bounding box of the
    triangle's subtiles, or for a fifth of them a random one (candidates
    that do not cover their subtile, and some that cover it but miss).
    Returns records (pieces + 16, 24) float32, the last 16 rows zero."""
    rng = np.random.default_rng(seed)
    w, h = ntx * raster.TILE_W, nty * raster.TILE_H
    recs = np.zeros((pieces + 16, 24), np.float32)
    planes = [(0.0, 0.0, 0.25), (0.0, 0.0, 0.5), (0.0, 0.0, 0.75),
              (2.0 ** -10, -2.0 ** -11, 0.375), (-2.0 ** -9, 0.0, 0.875)]
    for i in range(pieces):
        size = rng.choice([2.0, 12.0, 40.0, 160.0])
        centre = rng.uniform(0.0, [w, h])
        xy = (centre + rng.uniform(-size, size, (3, 2))).astype(np.float32)
        (x0, y0), (x1, y1), (x2, y2) = xy
        area2 = np.float32((x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0))
        if abs(area2) < 1e-3:
            continue
        inv = np.float32(1.0) / area2 * np.float32(rng.choice([1.0, -1.0],
                                                              p=[0.8, 0.2]))
        for k, (xa, ya, xb, yb) in enumerate(((x1, y1, x2, y2),
                                              (x2, y2, x0, y0),
                                              (x0, y0, x1, y1))):
            recs[i, 3 * k:3 * k + 3] = ((ya - yb) * inv, (xb - xa) * inv,
                                        (xa * yb - xb * ya) * inv)
        recs[i, raster._Z:raster._Z + 3] = planes[rng.integers(len(planes))]
        recs[i, raster._FW:raster._FV + 3] = rng.normal(size=9)
        recs[i, raster._FW + 2] += 2.0
        recs[i, raster._TRI] = i
        if rng.random() < 0.2:
            t0 = rng.integers(0, [ntx, nty])
            t1 = np.minimum(t0 + rng.integers(0, 3, 2), [ntx - 1, nty - 1])
        else:
            lo = np.clip((xy.min(0) - 0.5) // [raster.TILE_W, raster.TILE_H],
                         0, [ntx - 1, nty - 1])
            hi = np.clip((xy.max(0) - 0.5) // [raster.TILE_W, raster.TILE_H],
                         0, [ntx - 1, nty - 1])
            t0, t1 = lo.astype(int), hi.astype(int)
        recs[i, raster._BMIN] = t0[0] + 4096 * t0[1]
        recs[i, raster._BMAX] = t1[0] + 4096 * t1[1]
    return torch.from_numpy(recs)


def tie_segments(seed: int, pieces: int, tiles: int):
    """Random candidate segments of `tiles` subtiles inside `pieces`
    records: the two local segments anywhere (so they cross slice
    boundaries at any WINDOW, and may overlap), each up to a third of the
    records, and one big segment, longer than 256, for every subtile."""
    rng = np.random.default_rng(seed)
    sa = rng.integers(0, pieces // 2, tiles)
    la = rng.integers(0, pieces // 3, tiles)
    sb = rng.integers(0, pieces // 2, tiles)
    lb = rng.integers(0, pieces // 3, tiles)
    la[0], lb[1] = 0, 0
    gs = np.full(tiles, pieces - 300)
    gl = np.full(tiles, 300)
    return tuple(torch.from_numpy(x.astype(np.int32))
                 for x in (sa, la, sb, lb, gs, gl))


@pytest.mark.parametrize("window", [1, 3, 16, 256])
@pytest.mark.parametrize("chunk,shares", [(7, 1), (256, 1), (512, 2),
                                          (100, 3)])
def test_kernel_order_equals_plain_on_tie_records(monkeypatch, window, chunk,
                                                  shares):
    """The kernel's order gives _raster_tiles_plain's outputs bit for bit
    on tie-heavy records at every WINDOW, for chunks unrelated to it and
    for one to three warps a strip."""
    monkeypatch.setattr(raster, "WINDOW", window)
    recs = tie_records(11)
    tile_ids = torch.arange(9, dtype=torch.int32)
    segs = tie_segments(12, recs.shape[0] - 16, 9)
    plain = raster._raster_tiles_plain(recs, tile_ids, segs, 3)
    model = kernel_model(recs, tile_ids, segs, 3, chunk, shares)
    for name, a, b in zip(("bz", "fu", "fv", "fw", "ft"), model, plain):
        assert torch.equal(a, b), name
    assert (plain[0] > 0.0).float().mean() > 0.5


@pytest.mark.parametrize("window", [1, 3, 16, 256])
def test_plain_matches_reference_on_tie_records(monkeypatch, window):
    """On the same tie-heavy records the plain version, which the kernel is
    held to bit for bit, picks the reference's winners: depths and triangle
    ids equal at every pixel, at every WINDOW in both.  The reference
    evaluates Fu, Fv and Fw with its matrix product, which rounds
    otherwise: they are held to 4 float32 ulps of |a| px + |b| py + |c| of
    the winner's form (tie_records' triangle id is its row).  (The
    reference slices WINDOW rows from each start, so its records carry
    WINDOW zero rows more: a zero record's z = 0 is never inside.)"""
    monkeypatch.setattr(raster, "WINDOW", window)
    monkeypatch.setattr(raster_ref, "WINDOW", window)
    recs = tie_records(11)
    tile_ids = torch.arange(9, dtype=torch.int32)
    segs = tie_segments(12, recs.shape[0] - 16, 9)
    plain = raster._raster_tiles_plain(recs, tile_ids, segs, 3)
    padded = np.concatenate([recs.numpy(), np.zeros((window, 24),
                                                    np.float32)])
    ref = [torch.from_numpy(np.array(x)) for x in raster_ref._raster_tiles(
        jnp.asarray(padded), jnp.asarray(tile_ids.numpy()),
        tuple(jnp.asarray(s.numpy()) for s in segs), 3)]
    assert torch.equal(plain[0], ref[0])
    assert torch.equal(plain[4], ref[4])
    hit = plain[0] > 0.0
    assert hit.float().mean() > 0.5
    win = recs[plain[4].long().clamp(min=0)]                   # (9, PX, 24)
    idx = torch.arange(raster.PX)
    px = (tile_ids[:, None] % 3 * raster.TILE_W
          + idx % raster.TILE_W).float() + 0.5
    py = (tile_ids[:, None] // 3 * raster.TILE_H
          + idx // raster.TILE_W).float() + 0.5
    for k, col in ((1, raster._FU), (2, raster._FV), (3, raster._FW)):
        scale = (win[..., col].abs() * px + win[..., col + 1].abs() * py
                 + win[..., col + 2].abs())
        err = (plain[k] - ref[k]).abs() / (scale * np.finfo(np.float32).eps)
        print(f"WINDOW {window} column {col}: at most "
              f"{float(err[hit].max()):.2f} ulps of the form's scale")
        assert (err[hit] <= 4.0).all()


def test_tie_records_are_tie_heavy():
    """The records of tie_records put several inside pieces of one depth
    on many pixels, so the slices decide winners (WINDOW 1, where the
    first piece of the greatest z wins, and one slice a segment, where the
    last does: no segment here is longer than 512, part on many
    pixels), and candidates that do not cover
    their subtile among the segments."""
    recs = tie_records(11)
    tile_ids = torch.arange(9, dtype=torch.int32)
    segs = tie_segments(12, recs.shape[0] - 16, 9)
    winners = []
    for window in (1, 512):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(raster, "WINDOW", window)
            winners.append(raster._raster_tiles_plain(recs, tile_ids, segs,
                                                      3)[4])
    assert int((winners[0] != winners[1]).sum()) > 1000
    tile_ids = torch.arange(9, dtype=torch.int32)
    segs = tie_segments(12, recs.shape[0] - 16, 9)
    work = {"covering": 0, "candidates": 0}
    ties = 0
    for i in range(9):
        ty, tx = divmod(i, 3)
        rows = torch.cat([torch.arange(int(segs[2 * s][i]),
                                       int(segs[2 * s][i])
                                       + int(segs[2 * s + 1][i]))
                          for s in range(3)])
        r = recs[rows]
        bmin, bmax = r[:, raster._BMIN].long(), r[:, raster._BMAX].long()
        cov = ((tx >= bmin % 4096) & (tx <= bmax % 4096)
               & (ty >= bmin // 4096) & (ty <= bmax // 4096))
        work["covering"] += int(cov.sum())
        work["candidates"] += rows.numel()
        idx = torch.arange(raster.PX)
        px = (tx * 32 + idx % 32).float() + 0.5
        py = (ty * 24 + idx // 32).float() + 0.5
        rc = r[cov][:, None, :]
        z = raster._form(rc, raster._Z, px, py)
        inside = ((raster._form(rc, raster._E0, px, py) >= 0)
                  & (raster._form(rc, raster._E1, px, py) >= 0)
                  & (raster._form(rc, raster._E2, px, py) >= 0))
        zm = torch.where(inside, z, -1.0)
        best = zm.max(dim=0).values
        ties += int((((zm == best) & (best > 0)).sum(0) > 1).sum())
    assert 0 < work["covering"] < work["candidates"]
    assert ties > 1000


def test_kernel_order_equals_plain_on_cornell(cornell):
    """The same on the Cornell frame's binned records, all 12 subtiles."""
    (_, _, rscene), _, frame, *_ = cornell
    recs, _, tile_ids, segs = raster._binned(
        rscene, torch.from_numpy(frame.view_proj), W, H, frame.camera_near)
    ntx = W // raster.TILE_W
    plain = raster._raster_tiles_plain(recs, tile_ids, segs, ntx)
    model = kernel_model(recs, tile_ids, segs, ntx, 512, 2)
    for a, b in zip(model, plain):
        assert torch.equal(a, b)
    assert (plain[0] > 0.0).float().mean() > 0.3


def _edge_forms(regime: str, n: int, rng):
    """n edge forms (a, b, c) float32 and a strip (tx, ty, strip) each, in
    a 1920x1080 frame: "random" (|a|, |b| from 1e-8 to 1e3, |c| to 1e4),
    "large_c" (|c| from 1e4 to 1e30), "near_zero" (c set so that the form
    at the strip's corner where it is largest rounds to within a few units
    in the last place of 0, on either side: the edge grazes the strip) and
    "sliver" (as near_zero, with |a| or |b| 1e-7 to 1e-3 of the other: a
    near-degenerate edge, almost parallel to the strip's rows or columns,
    whose pixels differ by less than the rounding of the sum)."""
    tx = rng.integers(0, 60, n)
    ty = rng.integers(0, 45, n)
    strip = rng.integers(0, 8, n)
    sign = lambda: rng.choice([-1.0, 1.0], n)  # noqa: E731
    a = sign() * 10.0 ** rng.uniform(-8, 3, n)
    b = sign() * 10.0 ** rng.uniform(-8, 3, n)
    if regime == "sliver":
        small = rng.random(n) < 0.5
        ratio = 10.0 ** rng.uniform(-7, -3, n)
        a = np.where(small, np.abs(b) * ratio * np.sign(a), a)
        b = np.where(small, b, np.abs(a) * ratio * np.sign(b))
    a[rng.random(n) < 0.05] = 0.0
    b[rng.random(n) < 0.05] = 0.0
    a, b = a.astype(np.float32), b.astype(np.float32)
    if regime == "random":
        c = (sign() * 10.0 ** rng.uniform(-3, 4, n)).astype(np.float32)
    elif regime == "large_c":
        c = (sign() * 10.0 ** rng.uniform(4, 30, n)).astype(np.float32)
    else:
        x_lo = (tx * 32).astype(np.float32) + np.float32(0.5)
        y_lo = (ty * 24 + 3 * strip).astype(np.float32) + np.float32(0.5)
        c = -(np.where(a >= 0, x_lo + np.float32(31), x_lo) * a
              + np.where(b >= 0, y_lo + np.float32(2), y_lo) * b)
        for _ in range(3):
            step = rng.integers(-4, 5, n)
            c = np.where(step > 0, np.nextafter(c, np.float32(np.inf)),
                         np.where(step < 0, np.nextafter(
                             c, np.float32(-np.inf)), c))
        c = c.astype(np.float32)
    return (torch.from_numpy(np.stack([a, b, c], -1)),
            *(torch.from_numpy(t) for t in (tx, ty, strip)))


def _rejected_but_inside(forms, tx, ty, strip):
    """(rejected count, count of rejected forms that evaluate >= 0 at some
    pixel centre of their strip), the forms as E0 of records otherwise
    inside everywhere (E1 = E2 = 1, Z = 0.5)."""
    recs = torch.zeros((forms.shape[0], 24), dtype=torch.float32)
    recs[:, raster._E0:raster._E0 + 3] = forms
    recs[:, raster._E1 + 2] = 1.0
    recs[:, raster._E2 + 2] = 1.0
    recs[:, raster._Z + 2] = 0.5
    rej = raster.strip_rejects(recs, tx, ty, strip)
    f = forms[rej]
    col = torch.arange(raster.TILE_W)
    row = torch.arange(raster.STRIP_ROWS)
    px = ((tx[rej] * raster.TILE_W)[:, None, None] + col[None, None, :]
          ).to(torch.float32) + 0.5
    py = ((ty[rej] * raster.TILE_H + raster.STRIP_ROWS * strip[rej])
          [:, None, None] + row[None, :, None]).to(torch.float32) + 0.5
    value = raster._form(f[:, None, None, :], 0, px, py)   # (m, 3, 32)
    return int(rej.sum()), int((value >= 0.0).flatten(1).any(1).sum())


@pytest.mark.parametrize("regime", ["random", "large_c", "near_zero",
                                    "sliver"])
def test_strip_reject_is_sound(regime):
    """A record the strip test rejects evaluates the rejecting edge below 0
    at every pixel centre of the strip, under the rounded evaluation: the
    test has no margin, and needs none (strip_rejects)."""
    rng = np.random.default_rng({"random": 1, "large_c": 2, "near_zero": 3,
                                 "sliver": 4}[regime])
    rejected, wrong = _rejected_but_inside(*_edge_forms(regime, 200_000,
                                                        rng))
    assert rejected > 20_000
    assert wrong == 0


@pytest.mark.parametrize("regime", ["random", "large_c", "near_zero",
                                    "sliver"])
def test_corner_max_bounds_the_strip(regime):
    """corner_max is at least the form's rounded value at every pixel centre
    of the strip, for every form (test_strip_reject_is_sound sees only
    those below 0 there), on the same kinds of forms, in two columns."""
    rng = np.random.default_rng({"random": 5, "large_c": 6, "near_zero": 7,
                                 "sliver": 8}[regime])
    forms, tx, ty, strip = _edge_forms(regime, 50_000, rng)
    recs = torch.zeros((forms.shape[0], 24), dtype=torch.float32)
    recs[:, raster._Z:raster._Z + 3] = forms
    recs[:, raster._E1:raster._E1 + 3] = forms
    col = torch.arange(raster.TILE_W)
    row = torch.arange(raster.STRIP_ROWS)
    px = ((tx * raster.TILE_W)[:, None, None] + col[None, None, :]
          ).to(torch.float32) + 0.5
    py = ((ty * raster.TILE_H + raster.STRIP_ROWS * strip)[:, None, None]
          + row[None, :, None]).to(torch.float32) + 0.5
    for base in (raster._Z, raster._E1):
        top = raster.corner_max(recs, base, tx, ty, strip)
        value = raster._form(recs[:, None, None, :], base, px, py)
        finite = torch.isfinite(top)
        assert finite.float().mean() > 0.99
        assert (value[finite] <= top[finite, None, None]).all()


def test_density_order():
    """The kernel's blocks take the rows by descending la + lb: a
    permutation of the rows in int32."""
    la = torch.tensor([3, 0, 9, 4, 4], dtype=torch.int32)
    lb = torch.tensor([1, 0, 2, 8, 0], dtype=torch.int32)
    order = raster.density_order(la, lb)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(5))
    dens = (la + lb)[order.long()]
    assert (dens[:-1] >= dens[1:]).all()
    assert order[0] == 3 and order[-1] == 1


def test_raster_tiles_launcher_refuses_cpu_tensors():
    recs = torch.zeros((20, 24), dtype=torch.float32)
    zero = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        raster.raster_tiles_launcher(recs, zero, (zero,) * 6, 1)
