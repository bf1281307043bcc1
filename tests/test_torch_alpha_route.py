"""The exact alpha test's routing and counts on the CPU (render/surface.py,
render/pt/integrator.py): CPU records, over flat and instanced tables, take
the plain version (alpha_rejected over shade_rows) and never the kernel;
the kernel reads the rows' columns at the places flatten.TriShade,
TriGeometry and instances.InstShade name, over flat tables the tri_shade
rows and over instanced tables the blas_shade and inst_shade rows that
world_shade_rows composes; its launcher refuses what the kernel does not
take before any launch; a frame's row counts its exact tests
(40 in a 4-bounce lit alpha-tested frame at max_alpha_retrace = 4, none in
an opaque scene) and those that ran the kernel (none on the CPU), replayed
rows too, which the benchmark's alpha_kernel_pct.pt reader turns into a
share.  The kernel itself is held to the plain version on the card
(tests/test_torch_alpha_card.py)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from steeljax_torch.accel import cuda_traverse, dispatch, instances
from steeljax_torch.core import camera as camera_lib
from steeljax_torch.core import profiling
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.render import surface
from steeljax_torch.render.pt import frame_graphs, integrator, renderer
from steeljax_torch.scene import builtin
from steeljax_torch.scene.flatten import (TRI_SHADE_COLS, TRI_SHADE_GEOMETRY,
                                          TRI_SHADE_MATERIAL, TriShade)
from test_torch_support import one_torch_thread  # noqa: F401

W, H = 16, 8
METRICS = Path(__file__).resolve().parents[1] / "portbench" / "metrics"


def _foliage():
    scene = builtin.make_foliage_scene(cards=300, region=3.0)
    scene.camera_location = type(scene.camera_location)(
        position=np.array([0.0, 1.5, 6.0], np.float32),
        direction=np.array([0.0, 0.0, -1.0], np.float32),
        up=np.array([0.0, 1.0, 0.0], np.float32))
    return scene


def _prepared(scene, **prepare):
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16,
                                          **prepare)
    return flat, tables, camera_lib.make_frame(scene.camera_location,
                                               scene.camera_projection)


@pytest.fixture(scope="module")
def foliage():
    return _prepared(_foliage())


@pytest.fixture(scope="module")
def instanced():
    return _prepared(builtin.make_cornell_scene(sphere_detail=6),
                     accel=instances.InstancedAccel(device="cpu"))


def _primaries(flat, tables, frame, count: int = 512):
    """The nearest hits of `count` primary rays of a 32x16 view."""
    px = torch.arange(count) % 32
    py = torch.arange(count) // 32
    seed = torch.zeros((count, 2), dtype=torch.int64)
    o, d, _ = integrator.primary_rays(frame.inverse_view, frame.inverse_proj,
                                      32, 16, px, py, seed)
    return dispatch.trace_nearest(tables, o.contiguous(), d, 0.01, 100.0,
                                  cull_backface=False)


def _no_kernel(monkeypatch):
    def refuse(*args):
        raise AssertionError("the alpha kernel was asked for")
    monkeypatch.setattr(surface, "alpha_launcher", refuse)


def _launched_over(monkeypatch, flat, tables, rec):
    """The tensors an alpha kernel launch over `tables` would read, in its
    pointers' order, taken from the launcher with the launch stubbed."""
    seen = {}

    def launch_fn(kernel, entry, args, tensors, launches, prefix):
        seen["tensors"] = tensors
        return lambda: None
    monkeypatch.setattr(cuda_traverse, "_launch_fn", launch_fn)
    surface.alpha_launcher(flat, tables, rec)
    return seen["tensors"]


def test_kernel_runs_on_cuda_devices_over_uncomposed_rows(foliage,
                                                          instanced,
                                                          monkeypatch):
    """The launcher hands the kernel the rows world_shade_rows composes,
    not a composed row: over instanced tables the uvs' blas_shade rows,
    the material's inst_shade rows and the hits' instances; over flat
    tables tri_shade for both, and the triangle ids in the instances'
    place."""
    flat, tables, frame = instanced
    rec = _primaries(flat, tables, frame)
    hit, tri, inst, u, v, geo, mats, *_ = _launched_over(
        monkeypatch, flat, tables, rec)
    assert inst is rec["inst"] and tri is rec["tri"]
    assert geo is tables.blas_shade and mats is tables.inst_shade
    flat, tables, frame = foliage
    rec = _primaries(flat, tables, frame)
    hit, tri, inst, u, v, geo, mats, *_ = _launched_over(
        monkeypatch, flat, tables, rec)
    assert inst is rec["tri"] and geo is mats is flat.tri_shade


@pytest.mark.parametrize("layout", ["flat", "instanced"])
def test_cpu_records_take_the_plain_test(foliage, instanced, layout,
                                         monkeypatch):
    flat, tables, frame = foliage if layout == "flat" else instanced
    rec = _primaries(flat, tables, frame)
    _no_kernel(monkeypatch)
    counts = dict(surface.COUNTS)
    got = surface.alpha_test(flat, tables, rec)
    assert surface.COUNTS == {"tests": counts["tests"] + 1,
                              "alpha": counts["alpha"]}
    want = surface.alpha_rejected(flat, rec,
                                  surface.shade_rows(flat, tables, rec))
    assert torch.equal(got, want)
    if layout == "flat":
        # Leaves rejected and kept, so the test is not trivially constant.
        assert got.any() and (rec["hit"] & ~got).any()


def test_kernel_reads_the_columns_the_row_names():
    """csrc/alphatest.cu reads the 56-float row at fixed places: these; on
    instanced tables the uvs at the same places of the 28-float blas_shade
    row and the material's columns 10 before them in the 48-float
    inst_shade row."""
    assert TRI_SHADE_COLS == 56
    assert TriShade.UVS == slice(18, 24)
    assert (TriShade.ALPHA, TriShade.ALPHA_CUTOFF, TriShade.FLAGS) == \
        (35, 38, 40)
    assert TriShade.TEX_IDS.start == 41
    assert TRI_SHADE_GEOMETRY.stop == 28 and instances.INST_COLS == 48
    assert TRI_SHADE_MATERIAL.start == TriShade.MAT_ID == 28
    assert instances.InstShade.MATERIAL.start == 18
    assert (instances.InstShade.MATERIAL.stop
            - instances.InstShade.MATERIAL.start) == \
        TRI_SHADE_MATERIAL.stop - TRI_SHADE_MATERIAL.start


@pytest.mark.parametrize("field, value", [
    ("tri", lambda r: r["tri"].long()),
    ("hit", lambda r: r["hit"].to(torch.uint8)),
    ("u", lambda r: r["u"].double()),
    ("v", lambda r: r["v"][:-1]),
])
def test_launcher_refuses_what_the_kernel_does_not_take(foliage, field,
                                                        value):
    flat, tables, frame = foliage
    rec = _primaries(flat, tables, frame)
    rec[field] = value(rec)
    with pytest.raises(ValueError, match="alpha test"):
        surface.alpha_launcher(flat, tables, rec)


@pytest.mark.parametrize("value", [
    lambda r: r["inst"].long(),
    lambda r: r["inst"][:-1],
])
def test_launcher_refuses_instances_the_kernel_does_not_take(instanced,
                                                            value):
    flat, tables, frame = instanced
    rec = _primaries(flat, tables, frame)
    rec["inst"] = value(rec)
    with pytest.raises(ValueError, match="alpha test"):
        surface.alpha_launcher(flat, tables, rec)


def test_launcher_refuses_a_strided_shading_table(foliage):
    flat, tables, frame = foliage
    rec = _primaries(flat, tables, frame)
    wide = torch.zeros((flat.tri_shade.shape[0], 2 * TRI_SHADE_COLS))
    with pytest.raises(ValueError, match="scene tables"):
        surface.alpha_launcher(
            flat.replace(tri_shade=wide[:, :TRI_SHADE_COLS]), tables, rec)


def test_alpha_ranges_and_counters_stand_apart():
    assert surface.PROFILER_RANGE != cuda_traverse.PROFILER_RANGE
    assert not surface.PROFILER_RANGE.startswith(
        cuda_traverse.PROFILER_RANGE)
    assert set(surface.COUNTS) == {"tests", "alpha"}
    assert surface.COUNTS in frame_graphs.COUNTERS


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "alpha_metric_" + name.replace(".", "_"), METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _frames(flat, tables, frame, graphs, count: int):
    kept = integrator.FRAME_GRAPHS
    integrator.FRAME_GRAPHS = graphs
    px, py, _ = integrator.frame_pixels(W, H, "cpu")
    config = RenderConfig(width=W, height=H, max_bounce_count=4,
                          max_alpha_retrace=4)
    profiling.reset()
    try:
        images = [integrator.render_pixels(
            flat, tables, frame.inverse_view, frame.inverse_proj,
            frame.camera_near, frame.camera_far, W, H, px, py, i, 0, config)
            for i in range(count)]
        record = profiling.record()
    finally:
        integrator.FRAME_GRAPHS = kept
        profiling.reset()
    return images, record


@pytest.mark.parametrize("scene, tests", [("foliage", 40), ("opaque", 0)])
def test_frame_rows_count_alpha_tests(foliage, scene, tests, monkeypatch):
    """A 4-bounce lit frame on the CPU: 40 exact tests in the alpha-tested
    scene ((1 trace + 4 re-trace passes) x (material + shadow) x 4
    bounces), none in an opaque one; none on the kernel.  The benchmark's
    reader reads 0 of the former and nothing of the latter."""
    if scene == "foliage":
        flat, tables, frame = foliage
        assert flat.any_alpha_test and flat.light_count > 0
    else:
        flat, tables, frame = _prepared(
            builtin.make_cornell_scene(sphere_detail=6))
        assert not flat.any_alpha_test
    _no_kernel(monkeypatch)
    _, record = _frames(flat, tables, frame,
                        frame_graphs.FrameGraphs(frame_graphs.Eager()), 1)
    (row,) = record["rows"]
    assert row["counters"]["integrator.alpha_tests"] == tests
    assert row["counters"]["integrator.alpha_kernel_tests"] == 0
    ctx = {"mode": "pt", "window": {"frames": 1}, "program_record": record}
    assert _reader("alpha_kernel_pct.pt")(ctx) == (0.0 if tests else None)


class _KeptCapture:
    """A stand-in capturer: a capture runs the frame once and keeps its
    tensors, a replay runs nothing (the host launches nothing then, as in
    a CUDA graph's replay)."""

    def accepts(self, device) -> bool:
        return True

    def capture(self, fn, device):
        return (lambda: None), fn()


def test_kernel_tests_are_counted_when_the_host_runs_the_frame(
        foliage, monkeypatch):
    """With a stand-in kernel that counts its launches as the real one
    does, each row counts its 40 tests as the kernel's, replayed rows
    too, and the frames equal those of the plain test."""
    flat, tables, frame = foliage

    def launcher(scene, tables_, rec):
        out = torch.empty(rec["tri"].shape, dtype=torch.bool)

        def launch():
            out.copy_(surface.alpha_rejected(
                scene, rec, surface.shade_rows(scene, tables_, rec)))
            surface.COUNTS["alpha"] += 1
        return launch, out

    def kernel_route(scene, tables_, rec):
        """alpha_test's route for CUDA tensors, over the stand-in."""
        surface.COUNTS["tests"] += 1
        launch, rejected = surface.alpha_launcher(scene, tables_, rec)
        launch()
        return rejected

    plain, _ = _frames(flat, tables, frame,
                       frame_graphs.FrameGraphs(frame_graphs.Eager()), 1)
    monkeypatch.setattr(surface, "alpha_launcher", launcher)
    monkeypatch.setattr(integrator, "alpha_test", kernel_route)
    images, record = _frames(flat, tables, frame,
                             frame_graphs.FrameGraphs(_KeptCapture()), 4)
    rows = record["rows"]
    assert [row["ran"] for row in rows] == ["eager", "capture", "replay",
                                            "replay"]
    for row in rows:
        assert row["counters"]["integrator.alpha_tests"] == 40
        assert row["counters"]["integrator.alpha_kernel_tests"] == 40
    assert torch.equal(images[0], plain[0])
    ctx = {"mode": "pt", "window": {"frames": 4}, "program_record": record}
    assert _reader("alpha_kernel_pct.pt")(ctx) == 100.0
