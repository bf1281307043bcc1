"""The path stages' kernels (csrc/pathstage.cu) on the card: each against its
plain version (render/pt/stages.py, the torch code the integrator ran, run
here on the card) on the state of bounces 0 and 2 of 1280x720 frames,
921,600 rays: of the sunlit benchmark scene (one sun, untextured surfaces
read as column views of the shading rows) and of a lit textured scene (the
textured stress scene, whose Cornell lamp emits, under a sun and two point
lights), the latter also with the diffuse or the specular term alone and
with the material overridden.  Flags and seeds equal, the float outputs
bit-equal (the differing share and the largest ulp gap of each printed);
the stages launching once each a bounce; and frames of the sunlit scene,
flat and through the two-level structure, replayed as a CUDA graph equal
to eager ones, every row counting its bounces as the kernels'.  Every test
skips without a CUDA device.  This file imports no JAX; on the card's
machine, which has none, run it without the suite's conftest:
`python -m pytest --noconftest -p no:cacheprovider -q -m card -s
tests/test_torch_stages_card.py`."""

import inspect

import numpy as np
import pytest
import torch

from steeljax_torch.accel import instances
from steeljax_torch.core import camera as camera_lib
from steeljax_torch.core import profiling
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.core.constants import RAY_MAX_T
from steeljax_torch.render.pt import frame_graphs, integrator, renderer
from steeljax_torch.render.pt import stages
from steeljax_torch.scene import builtin
from steeljax_torch.scene import scene as scene_lib

W, H = 1280, 720
BOUNCES = (0, 2)
# The largest gap, in units in the last place, a float output of a kernel
# may have from its plain version: none.
ULP_BUDGET = 0
# (scene, compose, override_material) of the frames whose stage calls the
# kernels are held on.
CASES = [("sunlit", "both", None), ("lit_textured", "both", None),
         ("lit_textured", "diffuse", None),
         ("lit_textured", "specular", (0.35, 0.8))]


def _lit_textured_scene():
    """The textured stress scene under the sunlit scene's sun and two
    point lights inside the box."""
    scene = builtin.make_stress_scene(instances=300, sphere_detail=16,
                                      textured=True)
    lights = [("sun", builtin._trs((0, 0, 0), (0, 0, 1), -2.0),
               scene_lib.LightType.DIRECTIONAL, (3.0, 2.9, 2.7)),
              ("lamp_a", builtin._trs((0.0, 4.0, 2.0)),
               scene_lib.LightType.POINT, (6.0, 5.0, 4.0)),
              ("lamp_b", builtin._trs((-3.5, 1.0, 3.5)),
               scene_lib.LightType.POINT, (1.0, 2.0, 3.0))]
    for name, transform, kind, color in lights:
        entity = scene_lib.Entity(name=name, local_transform=transform)
        entity.light = scene_lib.Light(type=kind,
                                       color=np.array(color, np.float32))
        scene.add_entity(entity)
    return scene


SCENES = {"sunlit": builtin.make_sunlit_stress_scene,
          "lit_textured": _lit_textured_scene}


@pytest.fixture(scope="module")
def prepared():
    """{name: (scene, flat, tables, frame)}, each scene prepared on first
    use."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda:0")
    cache = {}

    def get(name):
        if name not in cache:
            scene = SCENES[name]()
            flat, tables = renderer.prepare_scene(scene, device,
                                                  env_resolution=64)
            cache[name] = (scene, flat, tables, camera_lib.make_frame(
                scene.camera_location, scene.camera_projection))
        return cache[name]
    return get


@pytest.fixture(scope="module")
def sunlit(prepared):
    return (*prepared("sunlit"), torch.device("cuda:0"))


def _render(flat, tables, frame, index: int, graphs=None, config=None):
    if graphs is not None:
        integrator.FRAME_GRAPHS, kept = graphs, integrator.FRAME_GRAPHS
    try:
        px, py, _ = integrator.tiled_order(W, H)
        return integrator.render_pixels(
            flat, tables, frame.inverse_view, frame.inverse_proj,
            frame.camera_near, frame.camera_far, W, H, px, py, index, 7,
            config or RenderConfig(width=W, height=H), return_stats=True)
    finally:
        if graphs is not None:
            integrator.FRAME_GRAPHS = kept


@pytest.fixture(scope="module")
def calls(prepared):
    """calls(case): each stage's arguments at bounces 0 and 2 of one eager
    frame of the case, recorded on first use."""
    cache = {}

    def get(case):
        if case in cache:
            return cache[case]
        name, compose, override = case
        _, flat, tables, frame = prepared(name)
        config = RenderConfig(
            width=W, height=H,
            debug_view=None if compose == "both" else compose,
            override_material=override)
        seen = {"nee": [], "sample": []}
        real = {"nee": stages.nee_stage, "sample": stages.sample_stage}

        def recording(stage):
            def run(*args, **kwargs):
                seen[stage].append((args, kwargs))
                return real[stage](*args, **kwargs)
            return run

        stages.nee_stage = recording("nee")
        stages.sample_stage = recording("sample")
        try:
            _render(flat, tables, frame, 0,
                    frame_graphs.FrameGraphs(frame_graphs.Eager()), config)
        finally:
            stages.nee_stage = real["nee"]
            stages.sample_stage = real["sample"]
        torch.cuda.synchronize()
        cache[case] = {stage: [seen[stage][b] for b in BOUNCES]
                       for stage in seen}
        return cache[case]
    return get


def _bound(stage, args, kwargs) -> dict:
    """A stage call's arguments by name, defaults included (the plain
    versions take the same names)."""
    bound = inspect.signature(stage).bind(*args, **kwargs)
    bound.apply_defaults()
    return dict(bound.arguments)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in units in the last place, over the float32 order."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def _compare(name: str, bounce: int, got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key in sorted(want):
        pairs = list(zip(got[key], want[key])) if key == "shadow" else \
            [(got[key], want[key])]
        for k, (a, b) in enumerate(pairs):
            label = f"{name} bounce {bounce} {key}" + (
                f"[{k}]" if key == "shadow" else "")
            if not torch.is_tensor(b):
                assert a == b, label
                continue
            assert a.shape == b.shape and a.dtype == b.dtype, label
            if b.dtype != torch.float32:
                assert torch.equal(a, b), label
                continue
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            gap = _ulps(a, b)[~same]
            share = float((~same).float().mean())
            worst = int(gap.max()) if gap.numel() else 0
            print(f"{label}: {share:.6%} of values differ, largest gap "
                  f"{worst} ulp")
            assert worst <= ULP_BUDGET, label


def _case_id(case) -> str:
    name, compose, override = case
    return f"{name}-{compose}" + ("-override" if override else "")


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("at", range(len(BOUNCES)))
def test_nee_kernel_equals_plain(prepared, calls, case, at):
    args = _bound(stages.nee_stage, *calls(case)["nee"][at])
    assert args["d"].is_cuda and args["d"].shape[0] == W * H
    assert args["compose"] == case[1]
    if case[2] is not None:
        assert torch.all(args["surface"]["roughness"] == case[2][0])
    before = stages.LAUNCHES["nee"]
    got = stages.nee_stage(**args)
    assert stages.LAUNCHES["nee"] == before + 1
    want = stages._nee_stage_plain(**args)
    torch.cuda.synchronize()
    assert "contrib" in want  # every scene here has a light
    if case[0] == "lit_textured":
        flat = prepared(case[0])[1]
        assert flat.light_count == 3 and flat.has_textures
        # Lanes that picked the sun and lanes that picked a point light.
        t_far = want["shadow"][3][want["has_light"]]
        assert (t_far == RAY_MAX_T).any() and (t_far < RAY_MAX_T).any()
    _compare("nee", BOUNCES[at], got, want)


@pytest.mark.card
@pytest.mark.parametrize("case", CASES, ids=_case_id)
@pytest.mark.parametrize("at", range(len(BOUNCES)))
def test_sample_kernel_equals_plain(calls, case, at):
    args = _bound(stages.sample_stage, *calls(case)["sample"][at])
    roulette = BOUNCES[at] >= RenderConfig().min_bounce_count
    assert args["roulette"] == roulette
    before = stages.LAUNCHES["sample"]
    got = stages.sample_stage(**args)
    assert stages.LAUNCHES["sample"] == before + 1
    want = stages._sample_stage_plain(**args)
    torch.cuda.synchronize()
    _compare("sample", BOUNCES[at], got, want)


@pytest.mark.card
def test_a_frame_launches_each_stage_once_a_bounce(sunlit):
    _, flat, tables, frame, _ = sunlit
    before = dict(stages.LAUNCHES)
    _render(flat, tables, frame, 1,
            frame_graphs.FrameGraphs(frame_graphs.Eager()))
    bounces = RenderConfig().max_bounce_count
    assert {k: v - before[k] for k, v in stages.LAUNCHES.items()} == \
        {"nee": bounces, "sample": bounces}


@pytest.mark.card
@pytest.mark.parametrize("layout", ["flat", "instanced"])
def test_replayed_frames_equal_eager_frames(sunlit, layout):
    scene, flat, tables, frame, device = sunlit
    if layout == "instanced":
        flat, tables = renderer.prepare_scene(
            scene, device, env_resolution=64,
            accel=instances.InstancedAccel(device=device))
    eager = frame_graphs.FrameGraphs(frame_graphs.Eager())
    graphs = frame_graphs.FrameGraphs(frame_graphs.CudaGraphs())
    profiling.reset()
    got = [_render(flat, tables, frame, i, graphs) for i in range(4)]
    rows = profiling.record()["rows"]
    assert [row["ran"] for row in rows] == ["eager", "capture", "replay",
                                            "replay"]
    bounces = RenderConfig().max_bounce_count
    for row in rows:
        assert row["counters"]["integrator.stage_bounces"] == bounces
        assert row["counters"]["integrator.bounces"] == bounces
    for i, (image, stats) in enumerate(got):
        want, want_stats = _render(flat, tables, frame, i, eager)
        assert torch.equal(image, want), i
        assert torch.equal(stats["rays_traced"], want_stats["rays_traced"])
