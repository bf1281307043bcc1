"""The port's GI hybrid frame against the reference on the CPU, at 48x27.

Both renderers light from one environment (the reference's bake at
tests/test_torch_hybrid.py's tiny budgets, carried across by
convert.from_jax_environment) and from a light volume: the reference's tiny
bake carried across by convert.from_jax_light_volume, or each package's own
tiny bake of the same scene (min edge 4.0, resolution 4, 1 spp, at most 64
probes).  Scenes: the Cornell box (sphere detail 4) and the lit parity
scene (a sun: K2 sun rays in the frame, next-event estimation in the
capture).  Every frame has 0 pixels beyond 1e-4 of the reference's.

The port's tables are brought to shade mode 0, the reference's CPU path,
as tests/test_torch_hybrid.py does: the fused G-buffer branch differs from
the reference's on purpose at a few pixels (one of Cornell's 1,296, 4.4e-3
without a volume), which is that file's subject, not this one's.  The
frames through SceneRenderer(config=RenderConfig(global_illumination_
enabled=True)) bake inside the hybrid renderer, each package at the tiny
budgets above (the tests patch the bake's budgets, as tests/test_torch_
apps.py patches load_environment's).

render_cli --gi --show-probes --lv-checkpoint F runs twice (the second run
loads F) at 32x18: the PNGs are equal, and within one 8-bit level of the
reference CLI's."""

import numpy as np
import pytest
import torch
from PIL import Image

import steeljax.gi as gi_ref
import steeljax.render.hybrid.renderer as hybrid_ref_mod
from steeljax.apps import render_cli as render_cli_ref
from steeljax.core.config import RenderConfig as RenderConfigRef
from steeljax.env.environment import load_environment as load_env_ref
from steeljax.env.sky import procedural_sky_cube as sky_cube_ref
from steeljax.gi.light_volume import generate_light_volume as generate_ref
from steeljax.render.hybrid.renderer import HybridRenderer as HybridRef
from steeljax.render.pt import renderer as renderer_ref
from steeljax.render.scene_renderer import RenderMode as RenderModeRef
from steeljax.render.scene_renderer import SceneRenderer as SceneRendererRef
from steeljax.scene import builtin as builtin_ref
import steeljax_torch.render.hybrid.renderer as hybrid_mod
import steeljax_torch.render.scene_renderer as scene_renderer_mod
from steeljax_torch.apps import render_cli
from steeljax_torch.convert import (from_jax_environment,
                                    from_jax_light_volume)
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.engine import Engine
from steeljax_torch.gi.light_volume import generate_light_volume
from steeljax_torch.io import checkpoint
from steeljax_torch.render.hybrid.renderer import HybridRenderer
from steeljax_torch.render.pt import renderer
from steeljax_torch.render.scene_renderer import RenderMode, SceneRenderer
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401

W, H = 48, 27
PIXEL_ATOL = 1e-4
TINY_ENV = dict(irradiance_resolution=4, reflection_resolution=8,
                lut_resolution=16, lut_samples=32, reflection_samples=16,
                irradiance_delta=0.4)
TINY_BAKE = dict(spp=1, resolution=4, min_edge=4.0, max_probes=64)
SCENES = {
    "cornell": lambda m: m.make_cornell_scene(sphere_detail=4),
    "lit": lambda m: m.make_parity_scene(4),
}


@pytest.fixture(scope="module")
def envs():
    ref = load_env_ref(cube=sky_cube_ref(16), **TINY_ENV)
    return from_jax_environment(ref, "cpu"), ref


def shade_mode0(tables):
    return tables.replace(shade_mode=0, chunks=tuple(
        c.replace(shade_packed=None) for c in tables.chunks))


@pytest.fixture(scope="module")
def baked():
    """{name: (reference (scene, flat, tables, volume), port (scene, flat,
    tables in shade mode 0, volume))}, each volume its package's tiny
    bake."""
    out = {}
    for name, make in SCENES.items():
        scene_r = make(builtin_ref)
        flat_r, tables_r = renderer_ref.prepare_scene(scene_r,
                                                      env_resolution=16)
        scene = make(builtin)
        flat, tables = renderer.prepare_scene(scene, "cpu",
                                              env_resolution=16)
        tables = shade_mode0(tables)
        out[name] = (
            (scene_r, flat_r, tables_r,
             generate_ref(flat_r, tables_r, **TINY_BAKE)),
            (scene, flat, tables,
             generate_light_volume(flat, tables, **TINY_BAKE)))
    return out


def check_frame(ours: np.ndarray, ref: np.ndarray, label: str,
                height: int = H, width: int = W) -> None:
    assert ours.shape == (height, width, 3) and np.isfinite(ours).all()
    delta = np.abs(ours - np.asarray(ref)).max(axis=-1)
    over = int((delta > PIXEL_ATOL).sum())
    print(f"{label}: max |delta| {delta.max():.3e}, {over} pixels beyond "
          f"{PIXEL_ATOL}")
    assert over == 0, label


@pytest.mark.parametrize("volume", ["carried", "own"])
@pytest.mark.parametrize("name", list(SCENES))
def test_hybrid_gi_frame_matches_reference(name, volume, envs, baked):
    (scene_r, flat_r, tables_r, lv_ref), (scene, flat, tables, lv) = (
        baked[name])
    ref = HybridRef(scene_r, W, H, RenderConfigRef(width=W, height=H),
                    environment=envs[1], prepared=(flat_r, tables_r))
    ref.light_volume = lv_ref
    want = np.asarray(ref.render_frame())
    ours = HybridRenderer(scene, W, H, RenderConfig(width=W, height=H),
                          environment=envs[0], prepared=(flat, tables),
                          device="cpu")
    ours.light_volume = (from_jax_light_volume(lv_ref, "cpu")
                         if volume == "carried" else lv)
    got = ours.render_frame()
    check_frame(got, want, f"{name} {volume}")
    # The volume reaches the frame: without it the frame differs.
    ours.light_volume = None
    assert np.abs(ours.render_frame() - got).max() > 1e-2
    # refresh_scene keeps the volume, as the reference does.
    ours.light_volume = lv
    ours.refresh_scene((flat, tables))
    assert ours.light_volume is lv


def _tiny_bake(generate):
    """A bake at TINY_BAKE's budgets whatever spp the caller passes (the
    renderers' bake_light_volume passes spp=8)."""
    def bake(flat, tables, spp=8, **kwargs):
        return generate(flat, tables, **TINY_BAKE)
    return bake


@pytest.fixture
def tiny_bakes(monkeypatch, envs):
    """Both packages' renderers bake at TINY_BAKE's budgets and light from
    the tiny environment; the port's SceneRenderer prepares shade-mode-0
    tables."""
    monkeypatch.setattr(hybrid_mod, "generate_light_volume",
                        _tiny_bake(generate_light_volume))
    monkeypatch.setattr(gi_ref, "generate_light_volume",
                        _tiny_bake(generate_ref))
    prepare = scene_renderer_mod.prepare_scene

    def prepare_mode0(scene, device, **kwargs):
        flat, tables = prepare(scene, device, **kwargs)
        return flat, shade_mode0(tables)
    monkeypatch.setattr(scene_renderer_mod, "prepare_scene", prepare_mode0)
    env, env_ref = envs
    for module in (hybrid_mod, scene_renderer_mod):
        monkeypatch.setattr(module, "load_environment",
                            lambda *a, device, **k: env)
    monkeypatch.setattr(hybrid_ref_mod, "load_environment",
                        lambda *a, **k: env_ref)


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_renderer_gi_config_bakes_and_matches_reference(
        name, envs, tiny_bakes):
    config = dict(width=W, height=H, global_illumination_enabled=True)
    ref = SceneRendererRef(SCENES[name](builtin_ref), W, H,
                           RenderConfigRef(**config), environment=envs[1],
                           mode=RenderModeRef.HYBRID)
    ours = SceneRenderer(SCENES[name](builtin), W, H, RenderConfig(**config),
                         environment=envs[0], mode=RenderMode.HYBRID,
                         device="cpu")
    lv = ours.hybrid.light_volume
    assert lv is not None and lv.tet_vertices.shape[0] > 0
    np.testing.assert_array_equal(
        lv.positions.numpy(), np.asarray(ref.hybrid.light_volume.positions))
    check_frame(ours.render_frame(), ref.render_frame(), f"{name} scene")
    if name == "cornell":
        # The Engine builds its SceneRenderer from the same config.
        engine = Engine(SCENES[name](builtin), W, H,
                        RenderConfig(path_tracing_enabled=False, **config),
                        environment=envs[0], device="cpu")
        assert engine.renderer.hybrid.light_volume is not None
        np.testing.assert_array_equal(engine.renderer.render_frame(),
                                      ours.render_frame())


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path)).astype(np.int32)


def test_render_cli_gi_show_probes_and_lv_checkpoint(tmp_path, envs,
                                                     monkeypatch):
    env, env_ref = envs
    for module in (hybrid_mod, scene_renderer_mod):
        monkeypatch.setattr(module, "load_environment",
                            lambda *a, device, **k: env)
    monkeypatch.setattr(hybrid_ref_mod, "load_environment",
                        lambda *a, **k: env_ref)
    flags = ["--mode", "hybrid", "--gi", "--show-probes", "--gi-min-edge",
             "4", "--gi-spp", "1", "--gi-resolution", "4", "--size", "32x18"]
    volume = tmp_path / "lv.npz"
    pngs = []
    for run in range(2):
        out = tmp_path / f"gi{run}.png"
        assert render_cli.main(["builtin:cornell", "-o", str(out),
                                "--device", "cpu", "--lv-checkpoint",
                                str(volume)] + flags) == 0
        assert volume.exists()
        pngs.append(_png(out))
    ref_png = tmp_path / "ref.png"
    assert render_cli_ref.main(["builtin:cornell", "-o", str(ref_png),
                                "--cpu", "--lv-checkpoint",
                                str(tmp_path / "lv_ref.npz")] + flags) == 0
    np.testing.assert_array_equal(pngs[0], pngs[1])
    assert pngs[0].shape == (18, 32, 3) and pngs[0].std() > 0
    assert int(np.abs(pngs[0] - _png(ref_png)).max()) <= 1
    lv = checkpoint.load_light_volume(volume, "cpu")
    assert lv.positions.shape[0] >= 8
    # --show-probes drew the splats: the same frame without them differs.
    plain = tmp_path / "plain.png"
    assert render_cli.main(["builtin:cornell", "-o", str(plain), "--device",
                            "cpu", "--lv-checkpoint", str(volume)]
                           + [f for f in flags if f != "--show-probes"]) == 0
    assert (pngs[0] != _png(plain)).any()


def test_bake_light_volume_passes_its_arguments(baked):
    _, (scene, flat, tables, lv) = baked["cornell"]
    ours = HybridRenderer(scene, W, H, RenderConfig(width=W, height=H),
                          environment=object(), prepared=(flat, tables),
                          device="cpu")
    ours.bake_light_volume(**TINY_BAKE)
    for key in ("positions", "tet_vertices", "coefficients"):
        np.testing.assert_array_equal(getattr(ours.light_volume, key),
                                      getattr(lv, key))
    assert isinstance(ours.light_volume.coefficients, torch.Tensor)
    assert ours.light_volume.coefficients.shape == (27, 9, 3)
