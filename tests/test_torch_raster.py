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
chip_smoke.py holds the kernel csrc/raster.cu to it on the card.

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
