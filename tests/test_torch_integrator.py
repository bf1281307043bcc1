"""The port's path-tracing slice against the reference on the CPU.

Elementwise pieces (BRDF, sky, primary rays, tone map) agree with the
reference within 1e-5 absolute on seeded inputs: both run fp32, and the
remaining difference is operation order (XLA may fuse or reorder where
PyTorch evaluates op by op), a few ulp of values of order 1.  BRDF values
and pdfs also get 1e-4 relative: they reach ~1e3 at sharp GGX peaks, and
d_ggx's denominator (noh * a2 - noh) * noh + 1 cancels near noh = 1, which
amplifies an ulp of noh (one of 4096 seeded samples differs by 2.2e-5
relative).  The sampled BRDF direction is held to 1e-5 only where its
conditioning allows; elsewhere both packages are held to a float64
evaluation (test_sample_evaluate_and_pdf_brdf).

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
from steeljax_torch.core import rng
from steeljax_torch.core.colors import to_linear, tone_map
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.env.sky import sky_radiance
from steeljax_torch.render.pt import brdf
from steeljax_torch.render.pt import integrator
from steeljax_torch.render.pt import renderer
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401


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


F32_EPS = float(np.finfo(np.float32).eps)


def _sample_f64(e, a2, spec, wo):
    """sample_brdf's direction in float64 from the same uniforms, and the
    bound on an fp32 evaluation's error in each component of wi.

    GGX lobe: cos_t = sqrt(num / den) with num = 1 - e1 and den = 1 + (a2 -
    1) e1, which cancels for small a2 and e1 near 1, so its fp32 rounding
    (eps times 1 + |a2 - 1| e1) is a relative error of q = num / den of
    eps (1 + |a2 - 1| e1) / den; three more roundings (num, the division,
    the square root) add 3 eps.  Then sin_t = sqrt(1 - cos_t^2) turns an
    error dc of cos_t into (cos_t dc + eps) / sin_t, large where sin_t is
    small (low roughness).  The half vector's components err by at most dc
    + ds, and wi = 2 (wo . h) h - wo by at most 4 times that.  Cosine lobe:
    cos_t = sqrt(e1), the same sin_t step.  The float64 result stands in for
    the exact value."""
    e = e.astype(np.float64)
    wo = wo.astype(np.float64)
    phi = 2.0 * np.pi * e[:, 0]
    num = 1.0 - e[:, 1]
    den = 1.0 + (a2 - 1.0) * e[:, 1]
    c_s = np.sqrt(num / den)
    s_s = np.sqrt(np.maximum(1.0 - c_s * c_s, 0.0))
    h = np.stack([s_s * np.cos(phi), s_s * np.sin(phi), c_s], axis=-1)
    wi_s = 2.0 * (wo * h).sum(-1, keepdims=True) * h - wo
    c_d = np.sqrt(e[:, 1])
    s_d = np.sqrt(np.maximum(1.0 - e[:, 1], 0.0))
    wi_d = np.stack([s_d * np.cos(phi), s_d * np.sin(phi), c_d], axis=-1)

    dq = F32_EPS * (3.0 + (1.0 + np.abs(a2 - 1.0) * e[:, 1]) / den)
    dc_s = 0.5 * c_s * dq + F32_EPS * c_s
    ds_s = (c_s * dc_s + F32_EPS) / np.maximum(s_s, 1e-12) + F32_EPS * s_s
    ds_d = F32_EPS / np.maximum(s_d, 1e-12) + F32_EPS
    tol = 4.0 * np.where(spec, dc_s + ds_s, F32_EPS + ds_d)
    return np.where(spec[:, None], wi_s, wi_d), tol


def _evaluate_f64(surface, wo, wi, wh):
    """evaluate_brdf and pdf_brdf in float64 at the given directions, and
    the relative error bound of an fp32 evaluation: d_ggx's denominator d =
    (noh a2 - noh) noh + 1 rounds to eps (2 + noh^2) absolute and cancels
    near noh = 1, and D = a2 / (pi d^2) doubles its relative error."""
    g = {k: v.numpy().astype(np.float64) for k, v in surface.items()}
    wo, wi, wh = (x.astype(np.float64) for x in (wo, wi, wh))
    nov, nol, noh = (np.maximum(x[:, 2], 0.0) for x in (wo, wi, wh))
    voh = np.maximum((wo * wh).sum(-1), 0.0)
    dd = (noh * g["a2"] - noh) * noh + 1.0
    d = g["a2"] / (np.pi * dd * dd)
    fr = g["f0"] + (1.0 - g["f0"]) * ((1.0 - voh) ** 5)[:, None]
    k = g["a"] * 0.5
    vis = 0.25 / ((nov * (1.0 - k) + k) * (nol * (1.0 - k) + k))
    f = ((1.0 - fr) * (1.0 - g["metallic"])[:, None] * g["base_color"]
         / np.pi + d[:, None] * fr * vis[:, None])
    spec = noh * d / np.maximum(4.0 * (wi * wh).sum(-1), 1e-6)
    pdf = nol / np.pi * (1.0 - g["sw"]) + spec * g["sw"]
    return f, pdf, 4.0 * F32_EPS * (2.0 + noh * noh) / dd


def test_sample_evaluate_and_pdf_brdf(inputs):
    """The sampled direction is ill-conditioned where sin_t is small (GGX
    at low roughness, and the cosine lobe near its pole): there an ulp of
    cos_t, which XLA's fused and approximate fp32 arithmetic (an FMA in den,
    its own sqrt) and PyTorch's round differently, becomes up to ~2e-4 in
    wi, so two correct fp32 programs disagree beyond 1e-5.  Each sample's
    error bound comes from that conditioning (_sample_f64).  Where it is
    below 1e-5, wi, f and pdf are held to the reference at 1e-5 as before;
    where it is above, the port's wi and the reference's are each held to
    the float64 evaluation within the bound, and the port's f and pdf to
    float64 at the port's own directions, within 1e-4 relative or d_ggx's
    own conditioning where that is larger (_evaluate_f64)."""
    _, wo, surface_args, seed = inputs
    surface = brdf.make_surface(*(torch.from_numpy(a) for a in surface_args))
    surface_r = brdf_ref.make_surface(*(jnp.asarray(a) for a in surface_args))
    for key in surface:
        _close(surface[key], surface_r[key])

    seed_t = torch.from_numpy(seed.astype(np.int64))
    f, wi, pdf, s = brdf.sample_brdf(surface, torch.from_numpy(wo), seed_t)
    f_r, wi_r, pdf_r, s_r = brdf_ref.sample_brdf(surface_r, jnp.asarray(wo),
                                                 jnp.asarray(seed))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    f_r, wi_r, pdf_r = (np.asarray(x) for x in (f_r, wi_r, pdf_r))

    e = rng.next_vec3(seed_t)[0].numpy()
    spec = e[:, 2] < surface["sw"].numpy()
    wi64, tol = _sample_f64(e, surface["a2"].numpy().astype(np.float64),
                            spec, wo)
    ill = tol > ATOL
    assert 0 < ill.sum() < N_RAYS // 2
    well = ~ill
    _close(wi[well], wi_r[well])
    np.testing.assert_allclose(pdf.numpy()[well], pdf_r[well], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(f.numpy()[well], f_r[well], rtol=RTOL,
                               atol=ATOL)
    for ours in (wi.numpy(), wi_r):
        assert (np.abs(ours - wi64).max(-1)[ill] <= tol[ill]).all()
    wh = np.where(spec[:, None],
                  brdf.importance_sample_ggx(torch.from_numpy(e[:, :2]),
                                             surface["a2"]).numpy(),
                  wo + wi.numpy())
    wh /= np.linalg.norm(wh, axis=-1, keepdims=True)
    f64, pdf64, rtol = _evaluate_f64(surface, wo, wi.numpy(), wh)
    rtol = np.maximum(rtol, RTOL)[ill]
    f_err = np.abs(f.numpy()[ill] - f64[ill])
    assert (f_err <= ATOL + rtol[:, None] * np.abs(f64[ill])).all()
    pdf_err = np.abs(pdf.numpy()[ill] - pdf64[ill])
    assert (pdf_err <= ATOL + rtol * np.abs(pdf64[ill])).all()

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


def _two_chunks():
    """The parity scene's prepared tables with its chunk twice: a
    multi-chunk scene, as one above MAX_CHUNK_TRIS would prepare."""
    scene = builtin.make_parity_scene(4)
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=4)
    return scene, (flat, tables.replace(chunks=tables.chunks * 2))


@pytest.mark.parametrize("make,item", [
    (_two_chunks, "ROADMAP item 13"),
])
def test_out_of_slice_scenes_raise(make, item):
    """What the port still refuses raises, naming its ROADMAP item (an
    environment cube, item 14, renders since the hybrid slice)."""
    scene, prepared = make()
    with pytest.raises(NotImplementedError, match=item):
        renderer.PathTracingRenderer(scene, 8, 8, prepared=prepared,
                                     device="cpu")


@pytest.mark.parametrize("make", [
    lambda: builtin.make_parity_scene(4),
    lambda: _with_texture(builtin.make_cornell_scene(4)),
    lambda: _with_alpha_test(_with_texture(builtin.make_cornell_scene(4))),
], ids=["lit", "textured", "alpha-tested"])
def test_lit_and_textured_scenes_render(make):
    """Scenes earlier slices refused (a punctual light; a texture; an
    alpha-tested material) now render."""
    image = renderer.PathTracingRenderer(make(), 8, 8,
                                         device="cpu").render_frame()
    assert image.shape == (8, 8, 3) and np.isfinite(image).all()
    assert image.std() > 0.0


def _with_environment_cube(scene):
    scene.environment_cube = np.ones((6, 4, 4, 3), np.float32)
    return scene


def test_instancing_raises():
    """instancing=True renders (it raised until the two-level structure was
    ported), with an environment cube too, and an alpha-tested instanced
    scene takes the unfused rows."""
    image = renderer.PathTracingRenderer(
        builtin.make_cornell_scene(4), 8, 8, instancing=True,
        device="cpu").render_frame()
    assert image.shape == (8, 8, 3) and np.isfinite(image).all()
    assert image.std() > 0.0
    # An environment cube (it raised until the environments were ported)
    # renders through the two-level structure as through the flat tables.
    cubed = [renderer.PathTracingRenderer(
        _with_environment_cube(builtin.make_cornell_scene(4)), 8, 8,
        instancing=instancing, device="cpu").render_frame()
        for instancing in (True, False)]
    np.testing.assert_allclose(cubed[0], cubed[1], rtol=0, atol=1e-4)
    alpha = renderer.PathTracingRenderer(
        _with_alpha_test(_with_texture(builtin.make_cornell_scene(4))), 8, 8,
        instancing=True, device="cpu")
    assert alpha.tables.shade_mode == 0
    assert np.isfinite(alpha.render_frame()).all()


def _with_alpha_test(scene):
    from steeljax_torch.scene.material import MaterialFlags
    scene.materials[0].flags |= MaterialFlags.ALPHA_TEST
    scene.materials[0].base_color_texture = 0
    return scene


def _with_texture(scene):
    """A 2x2 texture, opaque in its left column, transparent in its
    right."""
    texture = np.zeros((2, 2, 4), np.uint8)
    texture[:, 0, 3] = 255
    scene.textures.append(texture)
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
