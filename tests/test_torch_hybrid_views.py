"""The hybrid frame's switches, its forward stage and its cross-check with
the path tracer, on the CPU.

Every debug view, kForceForward, the material override and the switch
that turns shadow rays off render the lit parity scene (a sun: direct,
indirect, diffuse and specular terms all present), or, for the metallic
and emission views, the Cornell box (a chrome sphere and an emissive lamp;
the parity scene has neither), at 48x27 through both packages, the port's tables in shade mode 0
and the same carried-across environment, held as the frames of
tests/test_torch_hybrid.py: within 1e-4 on all but max(2, N/500) pixels and
within 2e-2 everywhere.

The forward stage on the two overlapping alpha-blend quads of
tests/test_forward.py:34-52 is held to the blend arithmetic, as that test
holds the reference (its run is RUN_SLOW there; the port's is cheap): the
two layers at t = 5 and 7 with alphas 0.5 and 0.4, composited far to near
over the background within 1e-5, a single layer dropping the back quad, and
a layer behind the opaque depth hidden.  kForceForward matches the deferred
frame on the opaque Cornell box within an RMSE of 0.03 (G-buffer
quantization and the depth round trip), as tests/test_forward.py holds the
reference.  Last, tests/test_crosscheck.py's PT-vs-hybrid checks on the port
alone: the same silhouette, correlated brightness, the wall tints, an RMSE
in (0, 0.35)."""

import functools

import numpy as np
import pytest
import torch

from steeljax.env.environment import load_environment as load_env_ref
from steeljax.env.sky import procedural_sky_cube as sky_cube_ref
from steeljax_torch.convert import from_jax_environment
from steeljax_torch.core.colors import tone_map
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.env.cubemap import sample_cube_quads
from steeljax_torch.env.environment import load_environment
from steeljax_torch.gi.light_volume import generate_light_volume
import steeljax_torch.render.hybrid.renderer as hybrid_mod
from steeljax_torch.render.hybrid.forward import (forward_stage,
                                                  shade_forward, trace_blend)
from steeljax_torch.render.hybrid.renderer import (GBUFFER_VIEWS,
                                                   HybridRenderer)
from steeljax_torch.render.pt.renderer import (PathTracingRenderer,
                                               prepare_scene)
from steeljax_torch.scene.builtin import make_cornell_scene, make_quad
from steeljax_torch.scene.material import Material, MaterialFlags
from steeljax_torch.scene.scene import Entity, RenderObject, Scene
from test_torch_hybrid import (TINY_ENV, W, H, check_frame, render,
                               render_ref)
from test_torch_support import one_torch_thread  # noqa: F401

CONFIGS = ([{"debug_view": v} for v in GBUFFER_VIEWS
            + ("direct", "indirect", "diffuse", "specular")]
           + [{"force_forward": True},
              {"override_material": (0.2, 1.0)},
              {"ray_tracing_enabled": False}])


def _scene_for(config):
    return ("cornell" if config.get("debug_view") in ("metallic", "emission")
            else "lit")


@pytest.fixture(scope="module")
def envs():
    ref = load_env_ref(cube=sky_cube_ref(16), **TINY_ENV)
    return from_jax_environment(ref, "cpu"), ref


@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_switches_match_reference(config, envs):
    name = _scene_for(config)
    ours = render(name, envs, True, **config)
    ref = render_ref(name, envs, **config)
    check_frame(ours, ref, str(config))


def test_switches_change_the_frame(envs):
    """Each switch renders something else than the full frame."""
    full = {name: render(name, envs, True) for name in ("lit", "cornell")}
    for config in CONFIGS:
        name = _scene_for(config)
        assert np.abs(render(name, envs, True, **config)
                      - full[name]).max() > 1e-3, config


def _two_blend_scene():
    """Two overlapping alpha-blend quads (alpha 0.5 red at z=0, alpha 0.4
    blue at z=-2), both 10x10 facing +Z, nothing opaque behind."""
    scene = Scene()
    scene.materials.append(Material(
        base_color_factor=np.asarray([0.8, 0.1, 0.1, 0.5], np.float32),
        flags=MaterialFlags.ALPHA_BLEND | MaterialFlags.DOUBLE_SIDED))
    scene.materials.append(Material(
        base_color_factor=np.asarray([0.1, 0.1, 0.8, 0.4], np.float32),
        flags=MaterialFlags.ALPHA_BLEND | MaterialFlags.DOUBLE_SIDED))
    scene.primitives.append(make_quad(10.0))
    front = Entity(name="front", render_objects=[RenderObject(0, 0)])
    scene.add_entity(front)
    back = Entity(name="back", render_objects=[RenderObject(0, 1)])
    back.local_transform[:3, 3] = [0, 0, -2.0]
    scene.add_entity(back)
    return scene


@pytest.fixture(scope="module")
def blend(envs):
    flat, tables = prepare_scene(_two_blend_scene(), "cpu",
                                 env_resolution=8,
                                 use_default_environment=False)
    assert flat.any_alpha_blend
    n = 4
    o = torch.tensor([[0.0, 0.0, 5.0]]).expand(n, 3)
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(n, 3)
    cam = torch.tensor([0.0, 0.0, 5.0])
    return flat, tables, envs[0], o, d, cam


def test_two_layer_blend_matches_the_blend_arithmetic(blend):
    flat, tables, env, o, d, cam = blend
    n = o.shape[0]
    gbuffer = {"hit": torch.zeros(n, dtype=torch.bool)}
    lit = torch.zeros(n, 3)
    opaque_t = torch.full((n,), 1000.0)
    out = forward_stage(flat, tables, env, lit, gbuffer, o, d, opaque_t,
                        0.001, cam)

    rec1 = trace_blend(flat, tables, o, d, 0.001, 1000.0)
    assert bool(rec1["hit"].all())
    np.testing.assert_allclose(rec1["t"].numpy(), 5.0, atol=1e-3)
    c1, a1 = shade_forward(flat, tables, env, rec1, o, d, cam)
    rec2 = trace_blend(flat, tables, o, d, rec1["t"] + 1e-4, 1000.0)
    assert bool(rec2["hit"].all())
    np.testing.assert_allclose(rec2["t"].numpy(), 7.0, atol=1e-3)
    c2, a2 = shade_forward(flat, tables, env, rec2, o, d, cam)

    bg = tone_map(sample_cube_quads(env.cube_quads, d))
    a1c = torch.clamp(a1, 0, 1)[..., None]
    a2c = torch.clamp(a2, 0, 1)[..., None]
    display = tone_map(c2) * a2c + bg * (1.0 - a2c)
    display = tone_map(c1) * a1c + display * (1.0 - a1c)
    np.testing.assert_allclose(out.numpy(), display.numpy(), atol=1e-5)
    np.testing.assert_allclose(a1.numpy(), 0.5, atol=1e-6)
    np.testing.assert_allclose(a2.numpy(), 0.4, atol=1e-6)

    # A single-layer composite drops the back quad.
    single = forward_stage(flat, tables, env, lit, gbuffer, o, d, opaque_t,
                           0.001, cam, max_blend_layers=1)
    only_front = tone_map(c1) * a1c + bg * (1.0 - a1c)
    np.testing.assert_allclose(single.numpy(), only_front.numpy(),
                               atol=1e-5)
    assert float((out - single).abs().max()) > 1e-3


def test_blend_layers_depth_tested_against_opaque(blend):
    """Blend surfaces behind the opaque depth are invisible."""
    flat, tables, env, o, d, cam = blend
    n = o.shape[0]
    gbuffer = {"hit": torch.ones(n, dtype=torch.bool)}
    lit = torch.full((n, 3), 0.25)
    opaque_t = torch.full((n,), 6.0)
    out = forward_stage(flat, tables, env, lit, gbuffer, o, d, opaque_t,
                        0.001, cam)
    rec1 = trace_blend(flat, tables, o, d, 0.001, opaque_t)
    c1, a1 = shade_forward(flat, tables, env, rec1, o, d, cam)
    a1c = torch.clamp(a1, 0, 1)[..., None]
    expected = tone_map(c1) * a1c + tone_map(lit) * (1.0 - a1c)
    np.testing.assert_allclose(out.numpy(), expected.numpy(), atol=1e-5)


def test_force_forward_matches_deferred_on_opaque_scene(envs):
    scene = make_cornell_scene(sphere_detail=4)
    prepared = prepare_scene(scene, "cpu", env_resolution=16)

    def frame(force):
        return HybridRenderer(
            scene, W, H, RenderConfig(width=W, height=H, force_forward=force),
            environment=envs[0], prepared=prepared,
            device="cpu").render_frame()

    deferred, forward = frame(False), frame(True)
    assert forward.shape == (H, W, 3) and np.isfinite(forward).all()
    rmse = float(np.sqrt(np.mean((forward - deferred) ** 2)))
    assert rmse < 0.03, rmse


@pytest.fixture(scope="module")
def both_images():
    """tests/test_crosscheck.py's images, on the port: Cornell at 48x27,
    24 path-traced frames against one hybrid frame, the environment baked
    from the prepared scene's cube."""
    scene = make_cornell_scene(sphere_detail=4)
    prepared = prepare_scene(scene, "cpu", env_resolution=16)
    env = load_environment(
        cube=prepared[0].env_cube, irradiance_resolution=8,
        reflection_resolution=16, lut_resolution=16, lut_samples=64,
        reflection_samples=32, irradiance_delta=0.3, device="cpu")
    config = RenderConfig(width=W, height=H)
    pt_img = PathTracingRenderer(scene, W, H, config, prepared=prepared,
                                 device="cpu").render(24)
    hy_img = HybridRenderer(scene, W, H, config, environment=env,
                            prepared=prepared, device="cpu").render_frame()
    return pt_img, hy_img


def test_crosscheck_silhouette_and_brightness(both_images):
    pt_img, hy_img = both_images
    assert abs(pt_img[:, 0].mean() - hy_img[:, 0].mean()) < 0.25
    a = pt_img.reshape(-1, 3).mean(axis=1)
    b = hy_img.reshape(-1, 3).mean(axis=1)
    assert np.corrcoef(a, b)[0, 1] > 0.6


def test_crosscheck_wall_tints_and_rmse(both_images):
    for img in both_images:
        assert img[:, :W // 2, 1].mean() >= img[:, :W // 2, 0].mean() - 0.1
        assert img[:, W // 2:, 0].mean() >= img[:, W // 2:, 1].mean() - 0.1
    pt_img, hy_img = both_images
    value = float(np.sqrt(np.mean((pt_img.astype(np.float64)
                                   - hy_img.astype(np.float64)) ** 2)))
    assert 0.0 < value < 0.35, value


def test_light_volume_gi_raises(envs, monkeypatch):
    """(Named when a GI config raised.)  Now it raises nothing: the
    renderer bakes the light volume when it is built (here at
    tests/test_torch_gi_frame.py's small budgets, min edge 4 at resolution
    4, for the CPU) and its frame takes the volume's irradiance."""
    monkeypatch.setattr(hybrid_mod, "generate_light_volume",
                        functools.partial(generate_light_volume,
                                          resolution=4, min_edge=4.0))
    scene = make_cornell_scene(sphere_detail=2)
    renderer = HybridRenderer(scene, 8, 8, RenderConfig(
        global_illumination_enabled=True), environment=envs[0],
        device="cpu")
    assert renderer.light_volume.tet_vertices.shape[0] > 0
    lit = renderer.render_frame()
    renderer.light_volume = None
    assert np.isfinite(lit).all()
    assert np.abs(lit - renderer.render_frame()).max() > 1e-2


def test_render_cli_hybrid_writes_a_png_on_the_cpu(tmp_path, monkeypatch):
    """`render_cli --mode hybrid` renders the Cornell box and writes a PNG
    (its default environment baked at the test budgets here: the full
    budgets are the card's)."""
    from PIL import Image

    from steeljax_torch.apps import render_cli
    from steeljax_torch.render.hybrid import renderer as hybrid_renderer

    def tiny(panorama_path=None, cube=None, *, device):
        return load_environment(panorama_path, cube, cube_resolution=16,
                                device=device, **TINY_ENV)

    monkeypatch.setattr(hybrid_renderer, "load_environment", tiny)
    out = tmp_path / "hybrid.png"
    assert render_cli.main(["builtin:cornell", "--mode", "hybrid", "-o",
                            str(out), "--size", "32x18", "--device",
                            "cpu"]) == 0
    image = np.asarray(Image.open(out))
    assert image.shape == (18, 32, 3) and image.std() > 0
