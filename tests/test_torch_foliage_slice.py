"""The alpha-tested slice end to end against the reference on the CPU.

render_pixels on a 32x18 tile (1 spp, accumulation index 0, near 0.01, far
100, env_resolution 16) of a small foliage scene (make_foliage_scene(300,
region=3), serrated leaves, a camera of its own inside the canopy) and of
the two-quad alpha scene (tests/test_multihit.py:24-42).  The port's tables
are prepared with fine_masks=False, so they hold exactly the reference's
CPU tables (coarse masks only); the reference takes its binary-BVH path
with the same masks.  At most max(2, N/200) pixels may differ by more than
1e-4, as in the lit and textured slice, and rays_traced, shadow rays
included, must be equal.

The fine masks and the multi-hit kernel change only how many passes a ray
needs before its exact alpha test keeps a hit.  With a budget no ray
exhausts (max_alpha_retrace = 16), the tiles with fine masks, and with
multihit_k = 4, are identical to the single-hit tile.  The rejected-first
compaction of the re-trace (forced by patching REPACK_MIN_TRIS) reorders
work only, so its records are bit-identical to the uncompacted ones."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax.core import camera as camera_ref
from steeljax.core.config import RenderConfig as RenderConfigRef
from steeljax.render.pt import integrator as integrator_ref
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax_torch.core import camera as camera_lib
from steeljax_torch.core import rng
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.render.pt import integrator, renderer
from steeljax_torch.scene import builtin

from test_torch_alpha_trace import two_quad_scenes
from test_torch_support import one_torch_thread  # noqa: F401


W, H = 32, 18
PIXEL_ATOL = 1e-4
CARDS, REGION = 300, 3.0


def _foliage(module):
    scene = module.make_foliage_scene(cards=CARDS, region=REGION)
    scene.camera_location = type(scene.camera_location)(
        position=np.array([0.0, 1.5, 6.0], np.float32),
        direction=np.array([0.0, 0.0, -1.0], np.float32),
        up=np.array([0.0, 1.0, 0.0], np.float32))
    return scene


SCENES = {
    "foliage": (lambda: _foliage(builtin), lambda: _foliage(builtin_ref)),
    "two_quads": (lambda: two_quad_scenes()[0],
                  lambda: two_quad_scenes()[1]),
}


def _pixels():
    ys, xs = np.meshgrid(np.arange(H, dtype=np.int32),
                         np.arange(W, dtype=np.int32), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _render_ref(name):
    scene = SCENES[name][1]()
    flat, tables = renderer_ref.prepare_scene(scene, env_resolution=16)
    # The two quads' coarse masks are all full (every cell's footprint
    # meets an opaque texel), so only the foliage tables are masked.
    assert flat.any_alpha_test and tables.alpha_masked == (name == "foliage")
    frame = camera_ref.make_frame(scene.camera_location,
                                  scene.camera_projection)
    px, py = _pixels()
    result, stats = integrator_ref.render_pixels(
        flat, tables, jnp.asarray(frame.inverse_view),
        jnp.asarray(frame.inverse_proj), 0.01, 100.0, W, H, jnp.asarray(px),
        jnp.asarray(py), 0, 0, RenderConfigRef(width=W, height=H),
        return_stats=True)
    return np.asarray(result), float(stats["rays_traced"])


def _render(name, config=RenderConfig(width=W, height=H), **prepare):
    scene = SCENES[name][0]()
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16,
                                          **prepare)
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    px, py = _pixels()
    result, stats = integrator.render_pixels(
        flat, tables, frame.inverse_view, frame.inverse_proj, 0.01, 100.0,
        W, H, px, py, 0, 0, config, return_stats=True)
    log = [(label, [int(c) for c in counts])
           for label, counts in stats["alpha_retrace"]]
    return result, float(stats["rays_traced"]), log


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tile_matches_reference(name):
    ref, rays_ref = _render_ref(name)
    ours, rays, _ = _render(name, fine_masks=False)
    ours = ours.numpy()
    assert ours.shape == (W * H, 3) and np.isfinite(ours).all()
    diverging = int((np.abs(ours - ref).max(axis=-1) > PIXEL_ATOL).sum())
    print(f"{name}: {diverging} of {W * H} pixels differ by more than "
          f"{PIXEL_ATOL} (max {float(np.abs(ours - ref).max()):.3e}); "
          f"rays_traced {rays} vs {rays_ref}")
    assert diverging <= max(2, W * H // 200)
    assert rays == rays_ref
    assert float(ours.std()) > 0.0


def test_fine_masks_and_multihit_tiles_equal_single_hit():
    config = RenderConfig(width=W, height=H, max_alpha_retrace=16)
    single, rays, log = _render("foliage", config, fine_masks=False)
    # The tile re-traces: rays start out rejected, the set only shrinks,
    # and no ray is left rejected after the last pass.  Each bounce logs
    # its material trace, then its shadow trace (the scene has a sun).
    assert [label for label, _ in log] == ["material", "shadow"] * 4
    for _, counts in log:
        assert len(counts) == 17
        assert all(a >= b for a, b in zip(counts, counts[1:]))
    assert sum(c[0] for _, c in log) > W * H // 4
    assert sum(c[-1] for _, c in log) == 0
    for prepare in (dict(fine_masks=True),
                    dict(fine_masks=True, multihit_k=4),
                    dict(fine_masks=False, multihit_k=4)):
        other, other_rays, _ = _render("foliage", config, **prepare)
        assert torch.equal(other, single), prepare
        assert other_rays == rays, prepare


@pytest.mark.parametrize("multihit_k", [0, 4])
def test_compacted_retrace_is_bit_identical(monkeypatch, multihit_k):
    """trace_material_ray on 8192 primary rays of the foliage scene (the
    compaction's batch floor), with and without the compaction, for the
    material rays and for shadow-style rays without culling."""
    scene = SCENES["foliage"][0]()
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16,
                                          multihit_k=multihit_k)
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    ys, xs = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    px = torch.as_tensor(xs.reshape(-1))
    py = torch.as_tensor(ys.reshape(-1))
    o, d, _ = integrator.primary_rays(frame.inverse_view, frame.inverse_proj,
                                      128, 64, px, py,
                                      rng.make_seed(px, py, 0, 0))
    sorts = [0]
    original = integrator.repack_rays

    def counting(*args):
        sorts[0] += 1
        return original(*args)

    monkeypatch.setattr(integrator, "repack_rays", counting)
    threshold = integrator.REPACK_MIN_TRIS
    for cull in (True, False):
        plain = integrator.trace_material_ray(flat, tables, o, d, 0.01,
                                              100.0, cull_backface=cull)
        assert sorts[0] == 0
        monkeypatch.setattr(integrator, "REPACK_MIN_TRIS", -1)
        compact = integrator.trace_material_ray(flat, tables, o, d, 0.01,
                                                100.0, cull_backface=cull)
        monkeypatch.setattr(integrator, "REPACK_MIN_TRIS", threshold)
        assert sorts[0] == 1
        sorts[0] = 0
        assert plain.keys() == compact.keys()
        for k in plain:
            assert torch.equal(plain[k], compact[k]), k
        assert 0 < int(plain["hit"].sum()) < o.shape[0]


def test_from_jax_prepared_carries_alpha_tables():
    """The reference's prepared foliage scene carried across
    (convert.from_jax_prepared) equals the port's own preparation: AUX
    rows, coarse masks, no shade rows; with fine_masks the fine rows built
    from the reference's permuted arrays equal the port's on every real
    record (pad records are never hit and may differ)."""
    from steeljax_torch.convert import from_jax_prepared

    flat_r, tables_r = renderer_ref.prepare_scene(_foliage(builtin_ref),
                                                  env_resolution=16)
    scene = _foliage(builtin)
    _, own = renderer.prepare_scene(scene, "cpu", env_resolution=16)
    for fine in (False, True):
        flat, tables = from_jax_prepared(flat_r, tables_r, "cpu",
                                         fine_masks=fine, scene=scene)
        chunk, own_chunk = tables.chunks[0], own.chunks[0]
        assert tables.alpha_masked and tables.shade_mode == 0
        assert chunk.shade_packed is None
        assert torch.equal(chunk.tris_packed, own_chunk.tris_packed)
        assert torch.equal(chunk.tri_mask, own_chunk.tri_mask)
        if not fine:
            assert chunk.fine_mask_rows is None
            continue
        real = (flat.tri_pos[:, 0, 0] < 1e30).numpy()
        words = chunk.fine_mask_rows[:, :120].reshape(-1, 10)[:len(real)]
        own_words = own_chunk.fine_mask_rows[:, :120].reshape(-1, 10)[
            :len(real)]
        assert torch.equal(words[real], own_words[real])
