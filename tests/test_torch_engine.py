"""The port's engine against the reference's on the CPU: CameraSystem,
TestSystem, the Engine's frames through a scripted session, checkpoints,
the `R` key and SceneRenderer's device.

Both engines light their hybrid frames from one environment baked at
tests/test_engine.py's `tiny_env` budgets (the reference's bake, carried
across by convert.from_jax_environment).  Every frame the engines return
must agree within 1e-4 everywhere, and each path-traced frame must trace
as many rays on both sides: `rays_traced` is read by putting, in each
package's PathTracingRenderer module, a render_sample that renders the
same pixels through render_pixels(return_stats=True) and logs the count.
"""

import functools
import types

import numpy as np
import pytest
import torch

import steeljax.render.pt.renderer as pt_renderer_ref
from steeljax.core.config import RenderConfig as RenderConfigRef
from steeljax.engine import CameraSystem as CameraSystemRef
from steeljax.engine import Engine as EngineRef
from steeljax.engine import EventBus as EventBusRef
from steeljax.engine import TestSystem as TestSystemRef
from steeljax.engine.events import EventType as EventTypeRef
from steeljax.engine.events import KeyInput as KeyInputRef
from steeljax.engine.events import MouseInput as MouseInputRef
from steeljax.env.environment import load_environment as load_env_ref
from steeljax.env.sky import procedural_sky_cube as sky_cube_ref
from steeljax.io import checkpoint as checkpoint_ref
from steeljax.render.pt import integrator as integrator_ref
from steeljax.scene import builtin as builtin_ref
from steeljax.scene import material as material_ref
from steeljax.scene import scene as scene_ref
import steeljax_torch.render.hybrid.renderer as hybrid_mod
import steeljax_torch.render.pt.renderer as pt_renderer
from steeljax_torch import native
from steeljax_torch.convert import from_jax_environment
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.engine import CameraSystem, Engine, EventBus, TestSystem
from steeljax_torch.engine.events import EventType, KeyInput, MouseInput
from steeljax_torch.gi.light_volume import generate_light_volume
from steeljax_torch.io import checkpoint
from steeljax_torch.render.pt import integrator
from steeljax_torch.render.scene_renderer import RenderMode, SceneRenderer
from steeljax_torch.scene import builtin
from steeljax_torch.scene import material as material_mod
from steeljax_torch.scene import scene as scene_mod
from test_torch_support import one_torch_thread  # noqa: F401

W, H = 16, 9
PIXEL_ATOL = 1e-4
TINY_ENV = dict(irradiance_resolution=4, reflection_resolution=8,
                lut_resolution=16, lut_samples=32, reflection_samples=16,
                irradiance_delta=0.4)

OURS = types.SimpleNamespace(
    builtin=builtin, scene=scene_mod, material=material_mod,
    EventBus=EventBus, EventType=EventType, KeyInput=KeyInput,
    MouseInput=MouseInput, CameraSystem=CameraSystem, TestSystem=TestSystem)
REF = types.SimpleNamespace(
    builtin=builtin_ref, scene=scene_ref, material=material_ref,
    EventBus=EventBusRef, EventType=EventTypeRef, KeyInput=KeyInputRef,
    MouseInput=MouseInputRef, CameraSystem=CameraSystemRef,
    TestSystem=TestSystemRef)


@pytest.fixture(scope="module")
def envs():
    ref = load_env_ref(cube=sky_cube_ref(16), **TINY_ENV)
    return from_jax_environment(ref, "cpu"), ref


def _prefab(m):
    """The TestSystem's `damaged_helmet` stand-in: a small metal box."""
    sub = m.scene.Scene()
    sub.materials.append(m.material.Material(
        base_color_factor=np.array([0.9, 0.6, 0.3, 1.0], np.float32),
        roughness_factor=0.3, metallic_factor=1.0))
    sub.primitives.append(m.builtin.make_box(1.5))
    sub.add_entity(m.scene.Entity(
        name="helmet_root", render_objects=[m.scene.RenderObject(0, 0)]))
    return sub


def _scene_with_prefab(m):
    """The Cornell box with the prefab and its spawn point in view (as
    tests/test_engine.py's _scene_with_prefab, inside the box)."""
    scene = m.builtin.make_cornell_scene(sphere_detail=4)
    scene.emplace_scene_prefab(_prefab(m), "damaged_helmet")
    scene.add_entity(m.scene.Entity(
        name="damaged_helmet_spawn",
        local_transform=m.builtin._trs((0.5, -1.5, 1.0))))
    return scene


# ---- CameraSystem -------------------------------------------------------

# Scripted input, one batch a process step: key events (key, action),
# mouse buttons ("mouse", button, action) and mouse moves ("move", x, y).
CAMERA_SCRIPT = [
    [("w", "press")],
    [("3", "press"), ("a", "press")],
    [("w", "release"), ("space", "press")],
    [("mouse", "right", "press"), ("move", 0.0, 0.0), ("move", 140.0, -60.0)],
    [("move", 200.0, 40.0), ("s", "press"), ("ctrl", "press")],
    [("mouse", "right", "release"), ("move", 500.0, 500.0),
     ("a", "release"), ("d", "press")],
    [("5", "press"), ("mouse", "left", "press"), ("move", 10.0, 10.0)],
    [("mouse", "right", "press"), ("move", 0.0, 0.0),
     ("move", 0.0, -3000.0)],   # pitch past the +-89 degree clamp
    [],
]


def _feed(m, bus, batch):
    for event in batch:
        if event[0] == "mouse":
            bus.trigger(m.EventType.MOUSE_INPUT,
                        m.MouseInput(event[1], event[2]))
        elif event[0] == "move":
            bus.trigger(m.EventType.MOUSE_MOVE, (event[1], event[2]))
        else:
            bus.trigger(m.EventType.KEY_INPUT, m.KeyInput(*event))


@pytest.mark.parametrize("dt", [0.25, 1.0 / 30.0])
def test_camera_system_matches_reference(dt):
    """The same scripted keys and mouse moves move both cameras alike:
    location and direction within 1e-6 after every process, and
    CAMERA_UPDATE fires on the same steps."""
    sides = []
    for m in (OURS, REF):
        bus = m.EventBus()
        fired = []
        bus.add_handler(m.EventType.CAMERA_UPDATE,
                        lambda _, f=fired: f.append(1))
        scene = m.builtin.make_cornell_scene(sphere_detail=4)
        sides.append((m, bus, m.CameraSystem(bus), scene, fired))
    for step, batch in enumerate(CAMERA_SCRIPT):
        states = []
        for m, bus, camera, scene, fired in sides:
            _feed(m, bus, batch)
            camera.process(scene, dt)
            loc = scene.camera_location
            states.append((np.asarray(loc.position),
                           np.asarray(loc.direction), len(fired)))
        (p, d, n), (p_ref, d_ref, n_ref) = states
        np.testing.assert_allclose(p, p_ref, atol=1e-6, err_msg=str(step))
        np.testing.assert_allclose(d, d_ref, atol=1e-6, err_msg=str(step))
        assert n == n_ref, step
    assert states[0][2] >= 6


# ---- TestSystem ---------------------------------------------------------

def _census(scene) -> tuple:
    return (len(scene.renderable_entities()),
            int(scene.gather_lights()[0].shape[0]),
            tuple(sorted(scene.prefabs)), len(scene.primitives),
            len(scene.materials))


@pytest.mark.parametrize("steps", [(9.0, 4.0, 2.0, 4.0),
                                   (1.0,) * 19, (3.0, 5.5, 4.0, 6.5)],
                         ids=["edges", "seconds", "uneven"])
def test_test_system_matches_reference(steps):
    """The timeline on both sides: after every step equal renderable
    entity, light, prefab, primitive and material counts, and at t = 9,
    13, 15 and 19 the reference test's expectations."""
    sides = []
    for m in (OURS, REF):
        scene = _scene_with_prefab(m)
        sides.append((scene, m.TestSystem(prefab_loader=lambda m=m:
                                          _prefab(m))))
    base = _census(sides[0][0])
    seen = {}
    t = 0.0
    for dt in steps:
        t += dt
        for scene, system in sides:
            system.process(scene, dt)
        ours, ref = (_census(scene) for scene, _ in sides)
        assert ours == ref, (t, ours, ref)
        seen[round(t)] = ours
    assert seen[19][2] == ()
    assert seen[19][1] == 1
    if 9 in seen:
        assert seen[9][0] == base[0] + 1
    if 13 in seen:
        assert seen[13][2] == () and seen[13][1] == 1
    if 15 in seen:
        assert seen[15][2] == ("damaged_helmet",) and seen[15][1] == 0


# ---- the Engine ---------------------------------------------------------

class RayLog:
    """A render_sample for one package's PathTracingRenderer module that
    renders every pixel through render_pixels(return_stats=True) and logs
    rays_traced."""

    def __init__(self, render_pixels, to_float):
        self.render_pixels = render_pixels
        self.to_float = to_float
        self.rays = []

    def __call__(self, scene, tables, inverse_view, inverse_proj,
                 camera_near, camera_far, width, height, accumulation_index,
                 sample_index, config):
        ys, xs = np.meshgrid(np.arange(height, dtype=np.int32),
                             np.arange(width, dtype=np.int32), indexing="ij")
        result, stats = self.render_pixels(
            scene, tables, inverse_view, inverse_proj, camera_near,
            camera_far, width, height, xs.reshape(-1), ys.reshape(-1),
            accumulation_index, sample_index, config, return_stats=True)
        self.rays.append(self.to_float(stats["rays_traced"]))
        return result.reshape(height, width, 3)


@pytest.fixture
def ray_logs(monkeypatch):
    import jax.numpy as jnp

    ours = RayLog(integrator.render_pixels, float)
    ref = RayLog(lambda s, t, iv, ip, n, f, w, h, px, py, *rest, **kw:
                 integrator_ref.render_pixels(
                     s, t, iv, ip, n, f, w, h, jnp.asarray(px),
                     jnp.asarray(py), *rest, **kw), float)
    monkeypatch.setattr(pt_renderer, "render_sample", ours)
    monkeypatch.setattr(pt_renderer_ref, "render_sample", ref)
    return ours, ref


def _engines(envs, instancing):
    ours = Engine(_scene_with_prefab(OURS), W, H,
                  RenderConfig(width=W, height=H), environment=envs[0],
                  instancing=instancing, device="cpu")
    ref = EngineRef(_scene_with_prefab(REF), W, H,
                    RenderConfigRef(width=W, height=H), environment=envs[1],
                    instancing=instancing)
    for engine, m in ((ours, OURS), (ref, REF)):
        engine.add_system(m.TestSystem(prefab_loader=lambda m=m:
                                       _prefab(m)))
        engine.add_system(m.CameraSystem(engine.bus))
    return ours, ref


# The scripted session: (label, keys pressed before the tick, keys
# released after it, resize before the tick or None, tick seconds).  It
# crosses every TestSystem edge, toggles the mode both ways (hybrid frames
# over the session's tables, instanced ones too), moves the camera, resizes,
# minimizes and restores.  The resize comes with the t = 19 edit and the
# restore keeps its extent, so that the reference compiles its frame
# functions no more often than the edits make it.
SESSION = [
    ("t7 pt", [], [], None, 7.0),
    ("t9 pt instance", [], [], None, 2.0),
    ("t9 pt accumulated", [], [], None, 0.1),
    ("t13 hybrid erase+light", ["t"], [], None, 4.0),
    ("t15 hybrid remerge", [], [], None, 2.0),
    ("t19 pt remove+light, move, resize 24x12", ["t", "w"], ["w"],
     (24, 12), 4.0),
    ("pt minimized", [], [], (0, 0), 0.1),
    ("pt restored 24x12", [], [], (24, 12), 0.1),
    ("pt accumulated", [], [], None, 0.1),
]


@pytest.mark.parametrize("instancing", [False, True],
                         ids=["flat", "instanced"])
def test_engine_session_matches_reference(instancing, envs, ray_logs):
    """Every frame of the scripted session within 1e-4 of the reference
    Engine's, with equal rays_traced in path tracing; the states the
    session passes through (mode, accumulation, suspension) equal."""
    ours, ref = _engines(envs, instancing)
    log, log_ref = ray_logs
    previous = None
    shown = {}
    for label, presses, releases, resize, dt in SESSION:
        for engine in (ours, ref):
            if resize is not None:
                engine.inject_resize(*resize)
            for key in presses:
                engine.inject_key(key)
        frames = []
        for engine in (ours, ref):
            frames.append(np.asarray(engine.tick(dt)))
            for key in releases:
                engine.inject_key(key, "release")
        frame, frame_ref = frames
        delta = float(np.abs(frame - frame_ref).max())
        print(f"{label}: max |delta| {delta:.3e}")
        assert frame.shape == frame_ref.shape, label
        assert np.isfinite(frame).all() and frame.std() > 0, label
        assert delta <= PIXEL_ATOL, label
        assert ours.renderer.mode.name == ref.renderer.mode.name, label
        assert ours.draw_suspended == ref.draw_suspended, label
        assert ours.frame_index == ref.frame_index, label
        assert ours.renderer.path_tracer.state.index == int(
            ref.renderer.path_tracer.state.index), label
        assert log.rays == log_ref.rays, label
        if resize == (0, 0):
            assert frame is previous, label
        previous = shown[label] = frame
    # Path tracing drew 6 frames (not the minimized tick); the instance at
    # t = 9 shows in the frame, the light at t = 19 in the shadow rays.
    assert len(log.rays) == 6 and all(r > 0 for r in log.rays)
    assert np.abs(shown["t9 pt instance"] - shown["t7 pt"]).max() > 0.05
    assert log.rays[3] > log.rays[2]   # t = 19: 24x12, and shadow rays
    if instancing:
        assert ours.renderer._accel.blas_builds == \
            ref.renderer._accel.blas_builds


def test_engine_overlay_burns_into_frames(envs):
    """overlay=True burns the frame-time line into the returned frame, as
    tests/test_overlay.py's engine test asks of the reference (here at
    16x9)."""
    scene = builtin.make_cornell_scene(sphere_detail=4)
    config = RenderConfig(width=W, height=H)
    on = Engine(scene, W, H, config, environment=envs[0], overlay=True,
                device="cpu")
    off = Engine(scene, W, H, config, environment=envs[0], device="cpu")
    on.add_text_binding(lambda: f"frame {on.frame_index}")
    f_on, f_off = on.tick(0.1), off.tick(0.1)
    assert f_on.shape == f_off.shape
    assert np.abs(f_on - f_off).max() > 0.05
    lines = on.overlay_lines()
    assert lines[0].startswith("Frame time: ") and lines[1] == "frame 1"


# ---- checkpoints --------------------------------------------------------

@pytest.fixture(scope="module")
def renderers():
    """A factory of fresh path tracers of the Cornell box, ours (on the
    CPU) and the reference's, over prepared tables made once."""
    scene = builtin.make_cornell_scene(sphere_detail=4)
    scene_ref = builtin_ref.make_cornell_scene(sphere_detail=4)
    prepared = pt_renderer.prepare_scene(scene, "cpu", env_resolution=16)
    prepared_ref = pt_renderer_ref.prepare_scene(scene_ref,
                                                 env_resolution=16)

    def make(ours: bool):
        if ours:
            return pt_renderer.PathTracingRenderer(
                scene, W, H, RenderConfig(width=W, height=H),
                prepared=prepared, device="cpu")
        return pt_renderer_ref.PathTracingRenderer(
            scene_ref, W, H, RenderConfigRef(width=W, height=H),
            prepared=prepared_ref)
    return make


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_continues_across_packages(writer, renderers, tmp_path):
    """A checkpoint written by one package after 2 frames loads into the
    other, whose next 2 frames are within 1e-4 of the writer's own
    continuation; the file holds the reference's keys."""
    path = tmp_path / "accum.npz"
    first = renderers(writer == "port")
    first.render(2)
    (checkpoint if writer == "port" else checkpoint_ref).save_accumulation(
        path, first.state)
    with np.load(path) as data:
        assert sorted(data.files) == ["accumulated", "index"]
        assert int(data["index"]) == 2
    continued = np.asarray(first.render(2))
    second = renderers(writer != "port")
    if writer == "port":
        second.state = checkpoint_ref.load_accumulation(path)
    else:
        second.state = checkpoint.load_accumulation(path, "cpu")
        assert second.state.index == 2
        assert second.state.accumulated.device.type == "cpu"
    resumed = np.asarray(second.render(2))
    assert int(second.state.index) == 4
    delta = float(np.abs(resumed - continued).max())
    print(f"{writer} checkpoint: max |delta| {delta:.3e}")
    assert delta <= PIXEL_ATOL


def test_checkpoint_round_trip_keeps_state(renderers, tmp_path):
    """save then load gives the same accumulation, bit for bit, and an
    integer index."""
    r = renderers(True)
    r.render(3)
    path = tmp_path / "accum.npz"
    checkpoint.save_accumulation(path, r.state)
    loaded = checkpoint.load_accumulation(path, "cpu")
    assert loaded.index == 3 and isinstance(loaded.index, int)
    assert torch.equal(loaded.accumulated, r.state.accumulated)


# ---- the R key, GI and the device ---------------------------------------

def test_reload_pipelines_is_per_mode(envs, monkeypatch):
    """The R key resets the path tracer's accumulation in path tracing and
    leaves the hybrid renderer as it is; the next tick renders.  With no
    kernel library loaded (the CPU) nothing is rebuilt."""
    built = []
    monkeypatch.setattr(native, "build_cuda", built.append)
    engine = Engine(builtin.make_cornell_scene(sphere_detail=4), W, H,
                    RenderConfig(width=W, height=H), environment=envs[0],
                    device="cpu")
    engine.tick(0.1)
    engine.tick(0.1)
    assert engine.renderer.path_tracer.state.index == 2
    engine.inject_key("r")
    assert engine.renderer.path_tracer.state.index == 0
    assert engine.tick(0.1).shape == (H, W, 3)
    engine.inject_key("t")
    hybrid = engine.tick(0.1)
    tables = engine.renderer.hybrid.tables
    engine.inject_key("r")   # the hybrid reload leaves the path tracer be
    assert engine.renderer.mode is RenderMode.HYBRID
    assert engine.renderer.hybrid.tables is tables
    assert engine.renderer.path_tracer.state.index == 1
    np.testing.assert_array_equal(engine.tick(0.1), hybrid)
    assert built == []


def test_reload_rebinds_a_stale_kernel_library(monkeypatch, tmp_path):
    """native.reload_cuda_library: nothing happens while the loaded build
    is current; once a source is newer, the library is rebuilt and opened
    under a new name, and launches call the new handle."""
    import ctypes

    loaded = {}
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {native.CUDA_LIBRARY: "old"})
    monkeypatch.setattr(native, "_loaded_mtime",
                        {native.CUDA_LIBRARY: 4e9})   # newer than sources
    monkeypatch.setattr(native, "_declare_cuda", lambda lib: None)
    monkeypatch.setattr(ctypes, "CDLL",
                        lambda path: loaded.setdefault("path", path))
    builds = []

    def build(target):
        builds.append(target)
        target.write_bytes(b"library")
    monkeypatch.setattr(native, "build_cuda", build)
    assert native.reload_cuda_library() is False
    assert builds == [] and native._libs[native.CUDA_LIBRARY] == "old"

    native._loaded_mtime[native.CUDA_LIBRARY] = 0.0   # sources are newer
    assert native.reload_cuda_library() is True
    assert builds == [tmp_path / native.CUDA_LIBRARY]
    opened = loaded["path"]
    assert opened != str(builds[0]) and opened.startswith(str(tmp_path))
    assert native._libs[native.CUDA_LIBRARY] == opened
    # The copy opened is unlinked once open.
    assert [p.name for p in tmp_path.iterdir()] == [native.CUDA_LIBRARY]


def test_scene_renderer_gi_config_raises(envs, monkeypatch):
    """(Named when a GI config raised.)  Now it raises nothing: the
    SceneRenderer's hybrid renderer bakes the light volume (here at
    tests/test_torch_gi_frame.py's small budgets, min edge 4 at resolution
    4, for the CPU) and its frame takes the volume's irradiance."""
    monkeypatch.setattr(hybrid_mod, "generate_light_volume",
                        functools.partial(generate_light_volume,
                                          resolution=4, min_edge=4.0))
    config = dict(width=W, height=H)
    frames = []
    for gi in (True, False):
        renderer = SceneRenderer(
            builtin.make_cornell_scene(sphere_detail=4), W, H,
            RenderConfig(global_illumination_enabled=gi, **config),
            environment=envs[0], mode=RenderMode.HYBRID, device="cpu")
        frames.append(renderer.render_frame())
        if gi:
            volume = renderer.hybrid.light_volume
            assert volume.positions.shape[0] == 27
            assert volume.tet_vertices.shape[0] > 0
        else:
            assert renderer.hybrid.light_volume is None
    assert np.isfinite(frames[0]).all()
    assert np.abs(frames[0] - frames[1]).max() > 1e-2


@pytest.mark.parametrize("entry", ["scene_renderer", "engine"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """SceneRenderer and Engine render on CUDA unless asked for the CPU,
    and raise where there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = builtin.make_cornell_scene(sphere_detail=4)
    make = SceneRenderer if entry == "scene_renderer" else Engine
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make(scene, W, H, RenderConfig(width=W, height=H))
