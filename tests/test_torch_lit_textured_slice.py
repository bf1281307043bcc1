"""The slice end to end against the reference on the CPU: render_pixels on a
32x18 tile (1 spp, accumulation index 0, near 0.01, far 100,
env_resolution 16) of the lit parity scene (make_parity_scene(4):
next-event estimation with its shadow rays) and of the small textured
stress scene (make_stress_scene(8, 4, textured=True): texture sampling and
normal-mapping frames), and the textured tile with the per-bounce ray
repack forced on in both packages.

The reference takes its unfused CPU path (binary-BVH any-hit, tri_shade row
shading); the port its fused path.  At most max(2, N/200) pixels may differ
by more than 1e-4 (a last-bit difference can flip a roulette or shadow
decision on a grazing hit), and rays_traced, shadow rays included, must be
equal.  On these tiles no pixel differs.  The repack is a reordering of
per-ray work, so the port's repacked tile is bit-identical to its
unrepacked one."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax.core import camera as camera_ref
from steeljax.core.config import RenderConfig as RenderConfigRef
from steeljax.render.pt import integrator as integrator_ref
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.render.pt import integrator, renderer
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401


W, H = 32, 18
PIXEL_ATOL = 1e-4

SCENES = {
    "lit": (lambda: builtin.make_parity_scene(4),
            lambda: builtin_ref.make_parity_scene(4)),
    "textured": (lambda: builtin.make_stress_scene(8, 4, textured=True),
                 lambda: builtin_ref.make_stress_scene(8, 4, textured=True)),
}


def _pixels():
    ys, xs = np.meshgrid(np.arange(H, dtype=np.int32),
                         np.arange(W, dtype=np.int32), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _render_ref(name):
    scene = SCENES[name][1]()
    flat, tables = renderer_ref.prepare_scene(scene, env_resolution=16)
    frame = camera_ref.make_frame(scene.camera_location,
                                  scene.camera_projection)
    px, py = _pixels()
    result, stats = integrator_ref.render_pixels(
        flat, tables, jnp.asarray(frame.inverse_view),
        jnp.asarray(frame.inverse_proj), 0.01, 100.0, W, H, jnp.asarray(px),
        jnp.asarray(py), 0, 0, RenderConfigRef(width=W, height=H),
        return_stats=True)
    return np.asarray(result), float(stats["rays_traced"])


def _render(name):
    scene = SCENES[name][0]()
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16)
    frame = camera_ref.make_frame(scene.camera_location,
                                  scene.camera_projection)
    px, py = _pixels()
    result, stats = integrator.render_pixels(
        flat, tables, frame.inverse_view, frame.inverse_proj, 0.01, 100.0,
        W, H, px, py, 0, 0, RenderConfig(width=W, height=H),
        return_stats=True)
    return result, float(stats["rays_traced"])


def _check(ours, ref, rays, rays_ref, label):
    ours = ours.numpy()
    assert ours.shape == (W * H, 3) and np.isfinite(ours).all()
    diverging = int((np.abs(ours - ref).max(axis=-1) > PIXEL_ATOL).sum())
    print(f"{label}: {diverging} of {W * H} pixels differ by more than "
          f"{PIXEL_ATOL} (max {float(np.abs(ours - ref).max()):.3e}); "
          f"rays_traced {rays} vs {rays_ref}")
    assert diverging <= max(2, W * H // 200)
    assert rays == rays_ref
    assert float(ours.std()) > 0.0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tile_matches_reference(name):
    ref, rays_ref = _render_ref(name)
    ours, rays = _render(name)
    _check(ours, ref, rays, rays_ref, name)
    # Shadow rays are counted: the lit tile traces more rays than segments.
    if name == "lit":
        assert rays_ref == 1244.0


def test_repacked_textured_tile(monkeypatch):
    """REPACK_MIN_TRIS = -1 in both packages: the port's repacked tile is
    bit-identical to its unrepacked one and matches the reference's
    repacked tile.  The reference's jit cache is cleared with
    clear_cache(), which makes it trace anew (its _clear_cache() alone
    reuses the traced program that read the old threshold), and a spy
    shows that both packages' repacks ran."""
    unrepacked, rays_plain = _render("textured")
    sorts = {"ours": 0, "ref": 0}

    def spy(module, key):
        original = module.repack_rays

        def counting(*args):
            sorts[key] += 1
            return original(*args)

        monkeypatch.setattr(module, "repack_rays", counting)
        monkeypatch.setattr(module, "REPACK_MIN_TRIS", -1)

    spy(integrator_ref, "ref")
    spy(integrator, "ours")
    integrator_ref.render_pixels.clear_cache()
    try:
        ref, rays_ref = _render_ref("textured")
    finally:
        integrator_ref.render_pixels.clear_cache()
    repacked, rays = _render("textured")
    # Bounces 1 to 3 each repack; the reference also sorts frame order
    # back with one more.
    assert sorts == {"ours": 3, "ref": 4}
    assert torch.equal(repacked, unrepacked)
    assert rays == rays_plain
    _check(repacked, ref, rays, rays_ref, "textured, repacked")
