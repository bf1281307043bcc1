"""The port's spans and their in-memory record (core.profiling): host time,
nesting and self time, the profiler ranges entered only while a profiler
collects, the frame rows, the waits, the set-up synchronize, the re-trace
counts, and the spans a path-traced tile and a hybrid frame leave."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from steeljax_torch.core import camera as camera_lib
from steeljax_torch.core import profiling
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.entry import entry
from steeljax_torch.env.environment import load_environment
from steeljax_torch.render.hybrid import renderer as hybrid_renderer
from steeljax_torch.render.pt import integrator, renderer
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401

PACKAGE = Path(__file__).resolve().parents[1] / "steeljax_torch"
PT_SPANS = {"integrator.render_pixels", "integrator.upload_pixels",
            "integrator.primary_rays", "integrator.bounce",
            "integrator.trace_material", "integrator.shade_fused",
            "integrator.sample", "integrator.environment"}
HYBRID_SPANS = {"hybrid.render_frame_device", "gbuffer_stage",
                "lighting_stage", "lighting_stage.direct",
                "lighting_stage.indirect", "forward_stage",
                "forward_stage.background"}
ENVIRONMENT_SPANS = {"environment.load", "environment.cube",
                     "environment.reflection_mips", "environment.irradiance",
                     "environment.brdf_lut"}
TINY_ENV = dict(cube_resolution=16, irradiance_resolution=4,
                reflection_resolution=8, lut_resolution=16, lut_samples=32,
                reflection_samples=16, irradiance_delta=0.4)


@pytest.fixture(autouse=True)
def fresh_record():
    profiling.reset()
    yield
    profiling.reset()


def _fake_clock(monkeypatch, readings):
    it = iter(readings)
    monkeypatch.setattr(profiling, "_clock", lambda: next(it))


def _only_row(frame_name):
    rows = profiling.record()["rows"]
    assert [r["frame"] for r in rows] == [frame_name]
    return rows[0]


def test_span_records_host_time_nesting_and_self_time(monkeypatch):
    """Clock readings in ns: frame 0..1000; a 100..700, in it b 200..300
    and b again 400..600; c 800..900 outside a."""
    _fake_clock(monkeypatch, [0, 100, 200, 300, 400, 600, 700, 800, 900,
                              1000])
    with profiling.frame("f"):
        with profiling.named_scope("a"):
            for _ in range(2):
                with profiling.named_scope("b"):
                    pass
        with profiling.named_scope("c"):
            pass
    row = _only_row("f")
    assert row["ms"] == 1000 / 1e6
    assert row["spans"] == {"f": 1000 / 1e6, "a": 600 / 1e6,
                            "b": 300 / 1e6, "c": 100 / 1e6}
    assert row["self_ms"] == {"f": 300 / 1e6, "a": 300 / 1e6,
                              "b": 300 / 1e6, "c": 100 / 1e6}
    assert row["wait_ms"] == 0.0 and row["profiled"] is False
    totals = profiling.record()["totals"]
    assert totals["b"] == {"calls": 2, "ms": 300 / 1e6, "self_ms": 300 / 1e6}
    assert totals["a"]["self_ms"] == 300 / 1e6


def test_spans_outside_frames_count_in_the_totals_only(monkeypatch):
    _fake_clock(monkeypatch, [0, 50, 70, 100])
    with profiling.named_scope("setup"):
        with profiling.named_scope("setup.step"):
            pass
    record = profiling.record()
    assert record["rows"] == []
    assert record["totals"]["setup"] == {"calls": 1, "ms": 100 / 1e6,
                                         "self_ms": 80 / 1e6}


def test_waits_count_once_and_only_inside_the_frame(monkeypatch):
    """A wait span inside another counts once; a wait outside any frame
    adds to no row."""
    _fake_clock(monkeypatch, [0, 10, 20, 30, 40, 50, 60, 70, 80, 1000])
    with profiling.named_scope("before", wait=True):
        pass
    with profiling.frame("f"):
        with profiling.named_scope("outer", wait=True):
            with profiling.named_scope("inner", wait=True):
                pass
        with profiling.named_scope("work"):
            pass
    row = _only_row("f")
    assert row["wait_ms"] == 30 / 1e6
    assert row["spans"]["inner"] == 10 / 1e6


def test_nested_frames_count_once():
    with profiling.frame("outer"):
        with profiling.frame("inner"):
            pass
        with profiling.frame("inner"):
            pass
    row = _only_row("outer")
    assert set(row["spans"]) == {"outer", "inner"}
    assert profiling.record()["totals"]["inner"]["calls"] == 2


def test_record_keeps_the_last_rows_and_every_total():
    frames = profiling.ROW_LIMIT + 8
    for i in range(frames):
        with profiling.frame(f"f{i % 2}"):
            with profiling.named_scope("work"):
                pass
    record = profiling.record()
    assert len(record["rows"]) == profiling.ROW_LIMIT
    assert record["rows"][-1]["frame"] == f"f{(frames - 1) % 2}"
    assert record["totals"]["work"]["calls"] == frames
    assert (record["totals"]["f0"]["calls"]
            + record["totals"]["f1"]["calls"]) == frames


def test_record_function_is_entered_only_while_a_profiler_collects(
        monkeypatch):
    entered = []
    real = profiling.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", counting)
    with profiling.frame("f"):
        with profiling.named_scope("a", wait=True):
            pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.frame("g"):
            with profiling.named_scope("a"):
                pass
    assert entered == ["g", "a"]
    assert [r["profiled"] for r in profiling.record()["rows"]] == [False,
                                                                   True]


def test_profiled_flag_follows_the_schedule():
    """torch.profiler collects in a schedule's active steps only, not in its
    warm-up step."""
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=2,
                                   repeat=1)) as prof:
        for _ in range(3):
            with profiling.frame("f"):
                pass
            prof.step()
    with profiling.frame("f"):
        pass
    assert [r["profiled"] for r in profiling.record()["rows"]] == [
        False, True, True, False]


def test_setup_spans_synchronize_a_cuda_device_only(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: synced.append(device))
    with profiling.named_scope("setup.cpu", sync="cpu"):
        pass
    with profiling.named_scope("setup.plain"):
        pass
    assert synced == []
    with profiling.named_scope("setup.card", sync="cuda"):
        pass
    assert synced == [torch.device("cuda")]


def test_upload_waits_only_for_host_data():
    with profiling.frame("f"):
        on_device = profiling.upload(torch.ones(3), "copy",
                                     dtype=torch.float32, device="cpu")
        copied = profiling.upload(np.ones(3), "copy", dtype=torch.float32,
                                  device="cpu")
    assert torch.equal(on_device, copied) and copied.dtype == torch.float32
    row = _only_row("f")
    assert profiling.record()["totals"]["copy"]["calls"] == 1
    assert row["wait_ms"] == row["spans"]["copy"] > 0.0


def test_no_record_function_outside_the_helper_and_the_launch():
    """Every profiler range of the port goes through core.profiling, except
    the trace kernels' launch ranges (cuda_traverse._launch_fn)."""
    users = sorted(
        str(path.relative_to(PACKAGE)) for path in PACKAGE.rglob("*.py")
        if re.search(r"record_function\(", path.read_text()))
    assert users == ["accel/cuda_traverse.py", "core/profiling.py"]
    launch = (PACKAGE / "accel" / "cuda_traverse.py").read_text()
    assert launch.count("record_function(") == 1


def test_path_traced_tile_leaves_one_row():
    """The Cornell 32x18 tile of the entry point: one row, the integrator's
    spans in it, the pixel upload its only wait."""
    fn, args = entry("cpu")
    profiling.reset()
    fn(*args)
    row = _only_row("integrator.render_pixels")
    assert PT_SPANS <= set(row["spans"])
    assert row["wait_ms"] == row["spans"]["integrator.upload_pixels"] > 0.0
    assert row["ms"] == row["spans"]["integrator.render_pixels"]
    assert profiling.record()["totals"]["integrator.bounce"]["calls"] == 4
    assert row["profiled"] is False and "retrace" not in row


def test_path_traced_tile_is_bit_equal_under_a_profiler():
    fn, args = entry("cpu")
    plain = fn(*args)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = fn(*args)
    assert torch.equal(plain, traced)
    rows = profiling.record()["rows"]
    assert [r["profiled"] for r in rows[-2:]] == [False, True]


def test_hybrid_frame_leaves_one_row(monkeypatch):
    """A lit scene's hybrid renderer, its default environment baked at tiny
    budgets: the set-up spans in the totals, one row a frame with the
    stages and their pieces."""
    def tiny(panorama_path=None, cube=None, *, device):
        return load_environment(panorama_path, cube, device=device,
                                **TINY_ENV)

    monkeypatch.setattr(hybrid_renderer, "load_environment", tiny)
    scene = builtin.make_parity_scene(4)
    hybrid = hybrid_renderer.HybridRenderer(
        scene, 16, 9, RenderConfig(width=16, height=9), device="cpu")
    totals = profiling.record()["totals"]
    assert ENVIRONMENT_SPANS | {"dispatch.prepare_tables",
                                "prepare_tables.build_bvh"} <= set(totals)
    assert totals["environment.load"]["ms"] >= sum(
        totals[name]["ms"] for name in ENVIRONMENT_SPANS
        if name != "environment.load")
    out = hybrid.render_frame_device()
    assert out.shape == (16 * 9, 3)
    row = _only_row("hybrid.render_frame_device")
    assert HYBRID_SPANS <= set(row["spans"])
    assert row["wait_ms"] == 0.0


def test_retrace_live_share_matches_the_counts():
    """The foliage tile's share of live re-trace rows, worked out from its
    alpha_retrace counts: the rays entering passes 1..4 of every material
    and shadow trace over 4 times the tile's rays a trace."""
    scene = builtin.make_foliage_scene(cards=300, region=3.0)
    scene.camera_location = type(scene.camera_location)(
        position=np.array([0.0, 1.5, 6.0], np.float32),
        direction=np.array([0.0, 0.0, -1.0], np.float32),
        up=np.array([0.0, 1.0, 0.0], np.float32))
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16)
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    width, height = 32, 18
    ys, xs = np.meshgrid(np.arange(height, dtype=np.int32),
                         np.arange(width, dtype=np.int32), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    profiling.reset()
    _, stats = integrator.render_pixels(
        flat, tables, frame.inverse_view, frame.inverse_proj, 0.01, 100.0,
        width, height, px, py, 0, 0,
        RenderConfig(width=width, height=height), return_stats=True)
    log = stats["alpha_retrace"]
    assert [label for label, _ in log] == ["material", "shadow"] * 4
    pending = sum(int(c) for _, counts in log for c in counts[:4])
    slots = len(log) * 4 * width * height
    assert 0 < pending < slots
    row = _only_row("integrator.render_pixels")
    assert row["retrace"] == {"pending": pending, "slots": slots}
    assert row["spans"]["integrator.retrace_pass"] > 0.0
    assert "integrator.nee" in row["spans"]
