"""The port's path-tracing slice against the reference on the CPU.

Elementwise pieces (BRDF, sky, primary rays, tone map) agree with the
reference within 1e-5 absolute on seeded inputs: both run fp32, and the
remaining difference is operation order (XLA may fuse or reorder where
PyTorch evaluates op by op), a few ulp of values of order 1.  BRDF values
and pdfs also get 1e-4 relative: they reach ~1e3 at sharp GGX peaks, and
d_ggx's denominator (noh * a2 - noh) * noh + 1 cancels near noh = 1, which
amplifies an ulp of noh (one of 4096 seeded samples differs by 2.2e-5
relative).

The slice as a whole: `render_pixels` on the `__graft_entry__` tile (Cornell
sphere detail 6, 32x18, 1 spp, accumulation index 0, near 0.01, far 100,
env_resolution 16) against steeljax's render_pixels.  The reference takes
its unfused CPU path (normal flipped by geom_n . d > 0) and the port the
fused path (flipped by det < 0); the two agree except on grazing or
degenerate hits.  Every pixel agrees within 1e-4 except at most
max(2, N/200) pixels, where a last-bit difference can flip a roulette or
culling decision; on this tile that count is 0 and rays_traced is equal
(1122 in both)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax.core import camera as camera_ref
from steeljax.core.colors import tone_map as tone_map_ref
from steeljax.core.colors import to_linear as to_linear_ref
from steeljax.core.config import RenderConfig as RenderConfigRef
from steeljax.env.sky import sky_radiance as sky_ref
from steeljax.render.pt import brdf as brdf_ref
from steeljax.render.pt import integrator as integrator_ref
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax_torch.core.colors import to_linear, tone_map
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.env.sky import sky_radiance
from steeljax_torch.render.pt import brdf
from steeljax_torch.render.pt import integrator
from steeljax_torch.render.pt import renderer
from steeljax_torch.scene import builtin

ATOL = 1e-5
RTOL = 1e-4
PIXEL_ATOL = 1e-4
W, H = 32, 18
N_RAYS = 4096


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    r = np.random.default_rng(0)
    n = N_RAYS
    normal = _unit(r, n)
    wo = _unit(r, n)
    wo[:, 2] = np.abs(wo[:, 2])  # tangent-space outgoing, upper hemisphere
    surface_args = (r.uniform(0, 1, (n, 3)).astype(np.float32),
                    r.uniform(0.05, 1, n).astype(np.float32),
                    (r.uniform(size=n) < 0.5).astype(np.float32),
                    r.uniform(0, 2, (n, 3)).astype(np.float32))
    seed = r.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)
    return normal, wo, surface_args, seed


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


def test_make_tbn(inputs):
    normal = inputs[0]
    normal[:7] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, 1], [0, 0, -1],
                  [1e-4, 1, 0], [0, 0.6, 0.8]]  # degenerate-tangent cases
    ours = brdf.make_tbn(torch.from_numpy(normal))
    ref = brdf_ref.make_tbn(jnp.asarray(normal))
    for a, b in zip(ours, ref):
        _close(a, b)


def test_sample_evaluate_and_pdf_brdf(inputs):
    _, wo, surface_args, seed = inputs
    surface = brdf.make_surface(*(torch.from_numpy(a) for a in surface_args))
    surface_r = brdf_ref.make_surface(*(jnp.asarray(a) for a in surface_args))
    for key in surface:
        _close(surface[key], surface_r[key])

    f, wi, pdf, s = brdf.sample_brdf(surface, torch.from_numpy(wo),
                                     torch.from_numpy(seed.astype(np.int64)))
    f_r, wi_r, pdf_r, s_r = brdf_ref.sample_brdf(surface_r, jnp.asarray(wo),
                                                 jnp.asarray(seed))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    _close(wi, wi_r)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(pdf_r), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_r), rtol=RTOL,
                               atol=ATOL)

    wh = wo + wi.numpy()
    wh /= np.maximum(np.linalg.norm(wh, axis=-1, keepdims=True), 1e-20)
    args = (torch.from_numpy(wo), wi, torch.from_numpy(wh))
    args_r = (jnp.asarray(wo), jnp.asarray(wi.numpy()), jnp.asarray(wh))
    np.testing.assert_allclose(
        brdf.evaluate_brdf(surface, *args).numpy(),
        np.asarray(brdf_ref.evaluate_brdf(surface_r, *args_r)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        brdf.pdf_brdf(surface, *args).numpy(),
        np.asarray(brdf_ref.pdf_brdf(surface_r, *args_r)),
        rtol=RTOL, atol=ATOL)


def test_sky_radiance_tone_map_and_to_linear(inputs):
    dirs = inputs[0]
    dirs[0] = np.array([0.35, 0.65, 0.25]) / np.linalg.norm([0.35, 0.65,
                                                             0.25])
    _close(sky_radiance(torch.from_numpy(dirs)), sky_ref(jnp.asarray(dirs)))
    hdr = np.random.default_rng(1).uniform(0, 8, (N_RAYS, 3)).astype(
        np.float32)
    _close(tone_map(torch.from_numpy(hdr)), tone_map_ref(jnp.asarray(hdr)))
    srgb = np.random.default_rng(2).uniform(-0.1, 1.2, (N_RAYS, 3)).astype(
        np.float32)
    _close(to_linear(torch.from_numpy(srgb)), to_linear_ref(jnp.asarray(srgb)))


def test_primary_rays(inputs):
    seed = inputs[3].astype(np.int64)
    scene = builtin.make_cornell_scene(6)
    frame = camera_ref.make_frame(scene.camera_location,
                                  scene.camera_projection)
    r = np.random.default_rng(4)
    px = r.integers(0, 1280, N_RAYS)
    py = r.integers(0, 720, N_RAYS)
    o, d, s = integrator.primary_rays(
        frame.inverse_view, frame.inverse_proj, 1280, 720,
        torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(seed))
    o_r, d_r, s_r = integrator_ref.primary_rays(
        jnp.asarray(frame.inverse_view), jnp.asarray(frame.inverse_proj),
        1280, 720, jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(inputs[3]))
    _close(o, o_r)
    _close(d, d_r)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))


def _count_diverging(ours, ref):
    bad = np.abs(ours - ref).max(axis=-1) > PIXEL_ATOL
    return int(bad.sum())


def test_render_pixels_graft_tile_matches_reference():
    """The slice end to end on the __graft_entry__ tile."""
    ys, xs = np.meshgrid(np.arange(H, dtype=np.int32),
                         np.arange(W, dtype=np.int32), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)

    scene_r = builtin_ref.make_cornell_scene(sphere_detail=6)
    flat_r, tables_r = renderer_ref.prepare_scene(scene_r, env_resolution=16)
    frame = camera_ref.make_frame(scene_r.camera_location,
                                  scene_r.camera_projection)
    ref, stats_r = integrator_ref.render_pixels(
        flat_r, tables_r, jnp.asarray(frame.inverse_view),
        jnp.asarray(frame.inverse_proj), 0.01, 100.0, W, H,
        jnp.asarray(px), jnp.asarray(py), 0, 0,
        RenderConfigRef(width=W, height=H), return_stats=True)

    flat, tables = renderer.prepare_scene(
        builtin.make_cornell_scene(sphere_detail=6), "cpu",
        env_resolution=16)
    ours, stats = integrator.render_pixels(
        flat, tables, frame.inverse_view, frame.inverse_proj, 0.01, 100.0,
        W, H, px, py, 0, 0, RenderConfig(width=W, height=H),
        return_stats=True)

    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == (W * H, 3) and np.isfinite(ours).all()
    diverging = _count_diverging(ours, ref)
    print(f"graft tile: {diverging} of {W * H} pixels differ by more than "
          f"{PIXEL_ATOL}; rays_traced {float(stats['rays_traced'])} vs "
          f"{float(stats_r['rays_traced'])}")
    assert diverging <= max(2, W * H // 200)
    # A diverging pixel may trace up to 4 segments more or fewer.
    assert abs(float(stats["rays_traced"])
               - float(stats_r["rays_traced"])) <= 4 * diverging
    assert float(stats_r["rays_traced"]) == 1122.0
    assert float(ours.std()) > 0.0


def test_renderer_two_frame_accumulation_matches_reference():
    """PathTracingRenderer.render_frame twice (running mean, tone map)."""
    scene_r = builtin_ref.make_cornell_scene(sphere_detail=6)
    ref_renderer = renderer_ref.PathTracingRenderer(
        scene_r, W, H, RenderConfigRef(width=W, height=H),
        prepared=renderer_ref.prepare_scene(scene_r, env_resolution=16))
    ours_renderer = renderer.PathTracingRenderer(
        builtin.make_cornell_scene(sphere_detail=6), W, H,
        RenderConfig(width=W, height=H), device="cpu",
        prepared=renderer.prepare_scene(
            builtin.make_cornell_scene(sphere_detail=6), "cpu",
            env_resolution=16))
    for frame in range(2):
        ours = ours_renderer.render_frame()
        ref = np.asarray(ref_renderer.render_frame())
        diverging = _count_diverging(ours, ref.reshape(ours.shape))
        print(f"frame {frame}: {diverging} of {W * H} pixels differ")
        assert diverging <= max(2, W * H // 200)
    assert ours_renderer.state.index == 2


@pytest.mark.parametrize("make,item", [
    (lambda: _with_environment_cube(builtin.make_parity_scene(4)),
     "ROADMAP item 14"),
    (lambda: _with_alpha_test(builtin.make_cornell_scene(4)),
     "ROADMAP item 16"),
])
def test_out_of_slice_scenes_raise(make, item):
    with pytest.raises(NotImplementedError, match=item):
        renderer.PathTracingRenderer(make(), 8, 8, device="cpu")


@pytest.mark.parametrize("make", [
    lambda: builtin.make_parity_scene(4),
    lambda: _with_texture(builtin.make_cornell_scene(4)),
], ids=["lit", "textured"])
def test_lit_and_textured_scenes_render(make):
    """Scenes the first slice refused (a punctual light; a texture) now
    render."""
    image = renderer.PathTracingRenderer(make(), 8, 8,
                                         device="cpu").render_frame()
    assert image.shape == (8, 8, 3) and np.isfinite(image).all()
    assert image.std() > 0.0


def _with_environment_cube(scene):
    scene.environment_cube = np.ones((6, 4, 4, 3), np.float32)
    return scene


def test_instancing_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP item 17"):
        renderer.PathTracingRenderer(builtin.make_cornell_scene(4), 8, 8,
                                     instancing=True, device="cpu")


def _with_alpha_test(scene):
    from steeljax_torch.scene.material import MaterialFlags
    scene.materials[0].flags |= MaterialFlags.ALPHA_TEST
    scene.materials[0].base_color_texture = 0
    return scene


def _with_texture(scene):
    scene.textures.append(np.zeros((2, 2, 4), np.uint8))
    return scene


def test_render_cli_writes_a_png_on_the_cpu(tmp_path):
    from PIL import Image

    from steeljax_torch.apps import render_cli

    out = tmp_path / "cli.png"
    assert render_cli.main(["builtin:cornell", "-o", str(out), "--size",
                            "16x9", "--spp", "2", "--device", "cpu"]) == 0
    image = np.asarray(Image.open(out))
    assert image.shape == (9, 16, 3) and image.std() > 0


def test_tiled_render_sample_equals_row_major():
    """render_sample's tile-ordered path (64x16 tiles), undone by detile,
    gives every pixel the row-major render's value: seeds depend only on
    the pixel, so the order of rays changes nothing."""
    flat, tables = renderer.prepare_scene(builtin.make_cornell_scene(4),
                                          "cpu", env_resolution=8)
    scene = builtin.make_cornell_scene(4)
    frame = camera_ref.make_frame(scene.camera_location,
                                  scene.camera_projection)
    w, h = 64, 16
    assert integrator.tiled_order(w, h) is not None
    tiled = integrator.render_sample(flat, tables, frame.inverse_view,
                                     frame.inverse_proj, 0.01, 100.0, w, h,
                                     3, 0, RenderConfig(width=w, height=h))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    rows = integrator.render_pixels(
        flat, tables, frame.inverse_view, frame.inverse_proj, 0.01, 100.0,
        w, h, xs.reshape(-1), ys.reshape(-1), 3, 0,
        RenderConfig(width=w, height=h)).reshape(h, w, 3)
    assert torch.equal(tiled, rows)
