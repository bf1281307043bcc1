"""The path stages (render/pt/stages.py) on the CPU: the plain `nee_stage`
and `sample_stage` bit-equal to the torch composition of the integrator's
bounce they replace, on seeded batches with dead lanes, 0, 1 and 3 lights
(directional and point), every compose mode and bounces below and at
min_bounce_count; their seeds advanced by exactly the draws of that
composition; the wrappers refusing mixed devices, wrong shapes, dtypes and
modes; their profiler ranges apart from the trace kernels'; and a frame's
row counting its bounces and those that ran the stage kernels, which the
benchmark's stage_kernel_pct readers turn into a share.  The kernels of
csrc/pathstage.cu themselves are held to these plain versions on the card
(tests/test_torch_stages_card.py)."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from steeljax_torch.accel import cuda_traverse
from steeljax_torch.core import profiling, rng
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.core.constants import (EPSILON, RAY_DEAD_T, RAY_MAX_T,
                                           RAY_MIN_T)
from steeljax_torch.entry import _tiny_setup
from steeljax_torch.render.pt import brdf, frame_graphs, integrator, stages
from test_torch_support import one_torch_thread  # noqa: F401

N = 4096
METRICS = Path(__file__).resolve().parents[1] / "portbench" / "metrics"


def _lights(count: int):
    """A stand-in for the flat scene's light rows: a sun, then point
    lights."""
    r = np.random.default_rng(count)
    loc = np.zeros((16, 4), np.float32)
    col = np.zeros((16, 4), np.float32)
    for i in range(count):
        if i == 0:
            v = r.normal(size=3)
            loc[i, :3] = v / np.linalg.norm(v)
        else:
            loc[i, :3] = r.uniform(-3, 3, 3)
            loc[i, 3] = 1.0
        col[i, :3] = r.uniform(0.5, 4.0, 3)
    return SimpleNamespace(light_location=torch.from_numpy(loc),
                           light_color=torch.from_numpy(col),
                           light_count=count)


def _batch(seed: int) -> dict:
    """A seeded bounce: surfaces, frames, rays, hits and path state, about a
    third of the lanes dead or missing."""
    r = np.random.default_rng(seed)

    def f32(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy(r.uniform(lo, hi, shape).astype(np.float32))

    def unit(n):
        v = r.normal(size=(n, 3))
        return torch.from_numpy(
            (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32))

    metallic = f32(N)
    metallic[: N // 4] = 0.0
    metallic[N // 4: N // 2] = 1.0
    return {
        "surface": {"base_color": f32(N, 3), "roughness": f32(N, lo=0.02),
                    "metallic": metallic, "emission": f32(N, 3, hi=0.2)},
        "tbn": brdf.make_tbn(unit(N)),
        "o": f32(N, 3, lo=-2.0, hi=2.0), "d": unit(N),
        "t_hit": f32(N, lo=0.01, hi=5.0),
        "hit": torch.from_numpy(r.uniform(size=N) < 0.8),
        "throughput": f32(N, 3, lo=0.05, hi=1.0),
        "ray_pdf": f32(N, lo=0.01, hi=4.0),
        "alive": torch.from_numpy(r.uniform(size=N) < 0.75),
        "miss": torch.from_numpy(r.uniform(size=N) < 0.1),
        "irradiance": f32(N, 3, hi=0.5),
        "seed": torch.from_numpy(
            r.integers(0, 1 << 32, (N, 2), dtype=np.uint64).astype(
                np.int64)),
        "occluded": torch.from_numpy(r.uniform(size=N) < 0.3),
    }


def _composition(scene, b, compose, roulette, rr_min):
    """The integrator's bounce after its shading unpack, as it ran before the
    stages (the visibility trace's verdict handed in as b["occluded"])."""
    surface = brdf.make_surface(**b["surface"])
    tbn, o, d = b["tbn"], b["o"], b["d"]
    throughput, ray_pdf, seed = b["throughput"], b["ray_pdf"], b["seed"]
    irradiance = b["irradiance"]
    weight = throughput / torch.clamp(ray_pdf, min=1e-30)[..., None]
    miss = b["miss"] | (b["alive"] & ~b["hit"])
    alive = b["alive"] & b["hit"]
    irradiance = irradiance + torch.where(
        alive[..., None], surface["emission"] * weight, 0.0)
    p = o + d * b["t_hit"][..., None]
    wo = stages.normalize(brdf.world_to_tangent(-d, tbn))
    shadow = None
    if scene.light_count > 0:
        n = tbn[2]
        light, seed = stages.sample_light(scene, n, p, seed)
        wi = brdf.world_to_tangent(light["direction"], tbn)
        wh = stages.normalize(wo + wi)
        shadow = stages.shadow_rays(p, n, light)
        f = brdf.evaluate_brdf(surface, wo, wi, wh, compose=compose)
        contrib = (f * brdf.cos_theta(wi)[..., None] * light["color"]
                   * (light["attenuation"]
                      / torch.clamp(light["pdf"], min=1e-20))[..., None])
        visible = light["has_light"] & ~b["occluded"]
        direct = torch.where(visible[..., None], contrib, 0.0)
        irradiance = irradiance + torch.where(alive[..., None],
                                              direct * weight, 0.0)
    f, wi, pdf, seed = brdf.sample_brdf(surface, wo, seed)
    black = (f * f).sum(dim=-1) < EPSILON
    alive = alive & (pdf >= EPSILON) & ~black
    throughput = torch.where(
        alive[..., None], throughput * f * brdf.cos_theta(wi)[..., None],
        throughput)
    ray_pdf = torch.where(alive, ray_pdf * pdf, ray_pdf)
    if roulette:
        threshold = torch.clamp(1.0 - throughput.max(dim=-1).values,
                                min=rr_min)
        r, seed = rng.next_float(seed)
        alive = alive & ~(r < threshold)
        throughput = torch.where(
            alive[..., None],
            throughput / torch.clamp(1.0 - threshold, min=1e-20)[..., None],
            throughput)
    d = torch.where(alive[..., None], brdf.tangent_to_world(wi, tbn), d)
    return {"o": p, "d": d, "t_min": torch.full((N,), RAY_MIN_T),
            "t_max": torch.where(alive, RAY_MAX_T, RAY_DEAD_T).float(),
            "throughput": throughput, "ray_pdf": ray_pdf, "alive": alive,
            "miss": miss, "irradiance": irradiance, "seed": seed,
            "shadow": shadow}


def _stages(scene, b, compose, roulette, rr_min):
    nee = stages.nee_stage(scene, b["surface"], b["tbn"], b["o"], b["d"],
                           b["t_hit"], b["hit"], b["throughput"],
                           b["ray_pdf"], b["alive"], b["miss"],
                           b["irradiance"], b["seed"], compose)
    direct = None
    if scene.light_count > 0:
        direct = (nee["contrib"], nee["has_light"], b["occluded"])
    out = stages.sample_stage(b["surface"], b["tbn"], nee["p"], nee["wo"],
                              b["d"], b["throughput"], b["ray_pdf"],
                              nee["alive"], nee["irradiance"], nee["seed"],
                              direct, roulette=roulette,
                              rr_min_threshold=rr_min)
    return nee, out


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        ((a == b) | (a != a) & (b != b)).all())


@pytest.mark.parametrize("lights", [0, 1, 3])
@pytest.mark.parametrize("compose", ["both", "diffuse", "specular"])
@pytest.mark.parametrize("bounce", [1, 2])
def test_plain_stages_equal_the_composition(lights, compose, bounce):
    """Bounce 1 is below the traffic's min_bounce_count (2), so no
    roulette; bounce 2 is at it."""
    config = RenderConfig()
    roulette = bounce >= config.min_bounce_count
    scene = _lights(lights)
    b = _batch(10 * lights + bounce)
    want = _composition(scene, b, compose, roulette, config.rr_min_threshold)
    nee, got = _stages(scene, b, compose, roulette, config.rr_min_threshold)
    assert _equal(nee["miss"], want["miss"])
    for key in ("o", "d", "t_min", "t_max", "throughput", "ray_pdf", "alive",
                "irradiance", "seed"):
        assert _equal(got[key], want[key]), key
    assert ("shadow" in nee) == (lights > 0)
    if lights:
        for a, w in zip(nee["shadow"], want["shadow"]):
            assert _equal(a, w) if torch.is_tensor(w) else a == w
        assert bool(nee["has_light"].any())
    # Dead lanes stay dead, with the dead interval and their direction.
    dead = ~nee["alive"]
    assert dead.any() and not bool(got["alive"][dead].any())
    assert bool((got["t_max"][dead] == RAY_DEAD_T).all())
    assert _equal(got["d"][~got["alive"]], b["d"][~got["alive"]])


def _advanced(seed, draws: int):
    for _ in range(draws):
        _, seed = rng.rand_uint32(seed)
    return seed


@pytest.mark.parametrize("lights", [0, 1, 3])
@pytest.mark.parametrize("roulette", [False, True])
def test_seeds_advance_by_the_compositions_draws(lights, roulette):
    """3 draws in nee_stage with lights (none without), 3 in sample_stage
    and one more for roulette, on every lane, alive or not."""
    scene = _lights(lights)
    b = _batch(lights + 7)
    nee, got = _stages(scene, b, "both", roulette, 0.05)
    nee_draws = 3 if lights else 0
    assert _equal(nee["seed"], _advanced(b["seed"], nee_draws))
    assert _equal(got["seed"],
                  _advanced(b["seed"], nee_draws + 3 + int(roulette)))


def test_wrappers_refuse_mixed_devices_shapes_dtypes_and_modes():
    scene = _lights(1)
    b = _batch(3)

    def nee(**change):
        args = dict(scene=scene, surface=b["surface"], tbn=b["tbn"],
                    o=b["o"], d=b["d"], t_hit=b["t_hit"], hit=b["hit"],
                    throughput=b["throughput"], ray_pdf=b["ray_pdf"],
                    alive=b["alive"], miss=b["miss"],
                    irradiance=b["irradiance"], seed=b["seed"])
        args.update(change)
        return stages.nee_stage(**args)

    def sample(**change):
        args = dict(surface=b["surface"], tbn=b["tbn"], p=b["o"],
                    wo=b["d"], d=b["d"], throughput=b["throughput"],
                    ray_pdf=b["ray_pdf"], alive=b["alive"],
                    irradiance=b["irradiance"], seed=b["seed"])
        args.update(change)
        return stages.sample_stage(**args)

    meta = b["d"].to("meta")
    with pytest.raises(ValueError, match="one device"):
        nee(d=meta)
    with pytest.raises(ValueError, match="one device"):
        sample(wo=meta)
    with pytest.raises(ValueError):
        nee(t_hit=b["t_hit"][:-1])
    with pytest.raises(ValueError):
        nee(o=b["o"].double())
    with pytest.raises(ValueError):
        sample(alive=b["alive"].to(torch.uint8))
    with pytest.raises(ValueError):
        sample(seed=b["seed"].to(torch.int32))
    with pytest.raises(ValueError):
        sample(seed=b["seed"][:, :1])
    with pytest.raises(ValueError):
        sample(direct=(b["d"], b["hit"], b["alive"][: N // 2]))
    with pytest.raises(ValueError, match="compose"):
        nee(compose="normals")


def test_kernel_views_take_strided_floats_and_adjacent_flags():
    """The kernels read float inputs at a row and a value stride (the
    primary rays' broadcast origin is a column of the camera matrix), and
    refuse seeds whose words are not adjacent."""
    m = torch.zeros((4, 4))
    origin = m[:3, 3].expand(N, 3)
    assert stages._strides(origin) == (0, 4)
    assert stages._strides(torch.zeros(N, 16)[:, 13:16]) == (16, 1)
    assert stages._strides(torch.zeros(N, 16)[:, 7]) == (16, 1)
    with pytest.raises(ValueError, match="contiguous"):
        stages._strides(torch.zeros((N, 4), dtype=torch.int64)[:, ::2])


def test_stage_ranges_are_not_trace_kernel_ranges():
    assert stages.PROFILER_RANGE != cuda_traverse.PROFILER_RANGE
    assert not stages.PROFILER_RANGE.startswith(cuda_traverse.PROFILER_RANGE)
    assert set(stages.LAUNCHES) == {"nee", "sample"}
    assert stages.LAUNCHES in frame_graphs.COUNTERS
    assert not stages.runs_kernels(torch.device("cpu"))


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "stage_metric_" + name.replace(".", "_"), METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_frame_rows_count_stage_bounces():
    """A frame through FrameGraphs(Eager()) on the CPU: its row counts its
    bounces, none of them on the kernels; the benchmark's reader turns rows
    into a share, and reads nothing where rows carry no such counters."""
    flat, tables, frame = _tiny_setup("cpu")
    px, py, _ = integrator.frame_pixels(32, 16, "cpu")
    config = RenderConfig(width=32, height=16, sample_count=2)
    kept = integrator.FRAME_GRAPHS
    integrator.FRAME_GRAPHS = frame_graphs.FrameGraphs(frame_graphs.Eager())
    profiling.reset()
    try:
        integrator.render_pixels(flat, tables, frame.inverse_view,
                                 frame.inverse_proj, frame.camera_near,
                                 frame.camera_far, 32, 16, px, py, 0, 0,
                                 config)
    finally:
        integrator.FRAME_GRAPHS = kept
    record = profiling.record()
    profiling.reset()
    (row,) = record["rows"]
    assert row["counters"] == {
        "integrator.stage_bounces": 0,
        "integrator.bounces": config.sample_count * config.max_bounce_count,
        "integrator.alpha_tests": 0, "integrator.alpha_kernel_tests": 0}
    read = _reader("stage_kernel_pct.pt")
    ctx = {"mode": "pt", "window": {"frames": 1}, "program_record": record}
    assert read(ctx) == 0.0
    on_card = {"frame": row["frame"], "profiled": False, "counters": {
        "integrator.stage_bounces": 4, "integrator.bounces": 4}}
    for name, mode in (("stage_kernel_pct.pt", "pt"),
                       ("stage_kernel_pct.inst", "pt_instanced")):
        ctx = {"mode": mode, "window": {"frames": 2},
               "program_record": {"rows": [row, on_card, on_card]}}
        assert _reader(name)(ctx) == 100.0
        ctx["program_record"] = {"rows": [
            {k: v for k, v in on_card.items() if k != "counters"}]}
        assert _reader(name)(ctx) is None
        other = "pt" if mode == "pt_instanced" else "pt_instanced"
        assert _reader(name)({"mode": other, "program_record": record}) \
            is None


class _KeptCapture:
    """A stand-in capturer: a capture runs the frame once and keeps its
    tensors, a replay runs nothing (the host launches nothing then, as in
    a CUDA graph's replay)."""

    def accepts(self, device) -> bool:
        return True

    def capture(self, fn, device):
        return (lambda: None), fn()


@pytest.mark.parametrize("launched", [("nee", "sample"), ("nee",)])
def test_stage_bounces_count_the_kernel_launches(monkeypatch, launched):
    """A frame's stage_bounces are the bounces in which the host launched
    both stage kernels (here stand-ins that count as the wrappers do),
    counted when the host ran the frame and carried to its replays."""
    flat, tables, frame = _tiny_setup("cpu")
    px, py, _ = integrator.frame_pixels(16, 8, "cpu")
    config = RenderConfig(width=16, height=8)
    for name in launched:
        real = getattr(stages, f"{name}_stage")

        def counting(*args, _real=real, _name=name, **kwargs):
            stages.LAUNCHES[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(stages, f"{name}_stage", counting)
    monkeypatch.setattr(integrator, "FRAME_GRAPHS",
                        frame_graphs.FrameGraphs(_KeptCapture()))
    profiling.reset()
    try:
        for i in range(4):
            integrator.render_pixels(flat, tables, frame.inverse_view,
                                     frame.inverse_proj, frame.camera_near,
                                     frame.camera_far, 16, 8, px, py, i, 0,
                                     config)
        rows = profiling.record()["rows"]
    finally:
        profiling.reset()
    bounces = config.sample_count * config.max_bounce_count
    assert [row["ran"] for row in rows] == ["eager", "capture", "replay",
                                            "replay"]
    for row in rows:
        assert row["counters"] == {
            "integrator.stage_bounces": bounces if len(launched) == 2 else 0,
            "integrator.bounces": bounces, "integrator.alpha_tests": 0,
            "integrator.alpha_kernel_tests": 0}
