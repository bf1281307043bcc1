"""Path-traced frames replayed as CUDA graphs, on the card: graph frames
against eager ones, bit for bit, over a rising accumulation index and a
camera moved once, in a lit scene (next-event estimation, and the repack
above its threshold) and an alpha-tested one (the bounded re-trace and its
counts), and over treelet tables (the scheduler's rounds), the launch
counters counting the frames the host ran and no replay; the returned
tensors of consecutive frames apart; a frame under a collecting profiler
eager, with its kernels' ranges; and a frame that reads the device on the
host, whose capture raises, eager throughout.  Every test skips
without a CUDA device.  This file imports no JAX; on the card's machine,
which has none, run it without the suite's conftest:
`python -m pytest --noconftest -p no:cacheprovider -q -m card
tests/test_torch_frame_graphs_card.py`."""

import numpy as np
import pytest
import torch

from steeljax_torch.accel import cuda_traverse, treelets
from steeljax_torch.core import camera as camera_lib
from steeljax_torch.core import profiling
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.render.pt import frame_graphs, integrator, renderer
from steeljax_torch.scene import builtin

W, H = 320, 192
FRAMES = 6
MOVED_AT = 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    profiling.reset()
    yield torch.device("cuda:0")
    profiling.reset()


def _sunlit():
    return builtin.make_sunlit_stress_scene(instances=24, sphere_detail=8)


def _foliage():
    scene = builtin.make_foliage_scene(cards=3000, region=3.0)
    scene.camera_location = type(scene.camera_location)(
        position=np.array([0.0, 1.5, 6.0], np.float32),
        direction=np.array([0.0, 0.0, -1.0], np.float32),
        up=np.array([0.0, 1.0, 0.0], np.float32))
    return scene


def _prepared(make, device, **prepare):
    scene = make()
    flat, tables = renderer.prepare_scene(scene, device, env_resolution=64,
                                          **prepare)
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    moved = np.array(frame.inverse_view, np.float32, copy=True)
    moved[:3, 3] += np.float32(0.1)
    views = [torch.as_tensor(v, device=device)
             for v in (frame.inverse_view, moved)]
    proj = torch.as_tensor(frame.inverse_proj, device=device)
    return flat, tables, views, proj, frame


def _frames(graphs, monkeypatch, flat, tables, views, proj, frame):
    """FRAMES frames through `graphs` at accumulation indices 0, 1, ...,
    the camera moved from frame MOVED_AT on: each frame's (image, stats)
    and what it added to the launch and scheduler counters."""
    monkeypatch.setattr(integrator, "FRAME_GRAPHS", graphs)
    px, py, _ = integrator.tiled_order(W, H)
    out = []
    for i in range(FRAMES):
        counters = {**cuda_traverse.LAUNCHES, **treelets.SCHEDULER}
        image, stats = integrator.render_pixels(
            flat, tables, views[i >= MOVED_AT], proj, frame.camera_near,
            frame.camera_far, W, H, px, py, i, 0,
            RenderConfig(width=W, height=H), return_stats=True)
        launched = {k: v - counters[k] for k, v in
                    {**cuda_traverse.LAUNCHES, **treelets.SCHEDULER}.items()
                    if v != counters[k]}
        out.append((image, stats, launched))
    torch.cuda.synchronize()
    return out


def _ran():
    return [row["ran"] for row in profiling.record()["rows"]]


@pytest.mark.card
@pytest.mark.parametrize("scene, repack, treelet_tables", [
    ("sunlit", False, False), ("sunlit", True, False),
    ("foliage", False, False), ("sunlit", False, True)])
def test_graph_frames_equal_eager_frames(card, monkeypatch, scene, repack,
                                         treelet_tables):
    if repack:
        monkeypatch.setattr(integrator, "REPACK_MIN_TRIS", -1)
    prepared = _prepared(_sunlit if scene == "sunlit" else _foliage, card,
                         treelets=treelet_tables)
    eager = _frames(frame_graphs.FrameGraphs(frame_graphs.Eager()),
                    monkeypatch, *prepared)
    profiling.reset()
    graphed = _frames(frame_graphs.FrameGraphs(frame_graphs.CudaGraphs()),
                      monkeypatch, *prepared)
    ran = _ran()
    assert ran == ["eager", "capture"] + ["replay"] * (FRAMES - 2)
    for (a, sa, la), (b, sb, lb), how in zip(graphed, eager, ran):
        assert torch.equal(a, b)
        assert torch.equal(sa["rays_traced"], sb["rays_traced"])
        # The host launches a replay's kernels in one graph launch, which
        # no counter sees; the eager frame and the capture launch them.
        assert lb and la == ({} if how == "replay" else lb)
        assert [label for label, _ in sa["alpha_retrace"]] == \
            [label for label, _ in sb["alpha_retrace"]]
        for (_, ca), (_, cb) in zip(sa["alpha_retrace"],
                                    sb["alpha_retrace"]):
            assert [int(x) for x in ca] == [int(x) for x in cb]
    assert bool(graphed[0][1]["alpha_retrace"]) == (scene == "foliage")
    assert not torch.equal(graphed[MOVED_AT - 1][0], graphed[MOVED_AT][0])


@pytest.mark.card
def test_returned_tensors_of_consecutive_frames_are_apart(card,
                                                          monkeypatch):
    prepared = _prepared(_sunlit, card)
    graphs = frame_graphs.FrameGraphs(frame_graphs.CudaGraphs())
    first = _frames(graphs, monkeypatch, *prepared)
    kept = [(image.clone(), stats["rays_traced"].clone())
            for image, stats, _ in first]
    _frames(graphs, monkeypatch, *prepared)
    assert len({image.data_ptr() for image, _, _ in first}) == FRAMES
    for (image, stats, _), (image0, rays0) in zip(first, kept):
        assert torch.equal(image, image0)
        assert torch.equal(stats["rays_traced"], rays0)


@pytest.mark.card
def test_a_profiled_frame_runs_eagerly_with_its_ranges(card, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    flat, tables, views, proj, frame = _prepared(_sunlit, card)
    graphs = frame_graphs.FrameGraphs(frame_graphs.CudaGraphs())
    graphed = _frames(graphs, monkeypatch, flat, tables, views, proj, frame)
    px, py, _ = integrator.tiled_order(W, H)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        image = integrator.render_pixels(
            flat, tables, views[1], proj, frame.camera_near,
            frame.camera_far, W, H, px, py, FRAMES - 1, 0,
            RenderConfig(width=W, height=H))
        torch.cuda.synchronize()
    row = profiling.record()["rows"][-1]
    assert row["ran"] == "eager" and row["profiled"]
    names = {evt.name for evt in prof.events()}
    assert {cuda_traverse.PROFILER_RANGE + k for k in ("K1", "K2")} <= names
    assert torch.equal(image, graphed[-1][0])


@pytest.mark.card
def test_a_frame_that_reads_the_device_runs_eagerly(card, monkeypatch):
    """A repack that reads a device value on the host (a stand-in for code
    no CUDA path has): the capture raises, and that frame and the later
    ones run eagerly, equal to the eager reference."""
    repack = integrator.repack_rays

    def reading(key, columns):
        int(key.max())
        return repack(key, columns)

    monkeypatch.setattr(integrator, "REPACK_MIN_TRIS", -1)
    monkeypatch.setattr(integrator, "repack_rays", reading)
    prepared = _prepared(_sunlit, card)
    eager = _frames(frame_graphs.FrameGraphs(frame_graphs.Eager()),
                    monkeypatch, *prepared)
    profiling.reset()
    got = _frames(frame_graphs.FrameGraphs(frame_graphs.CudaGraphs()),
                  monkeypatch, *prepared)
    assert _ran() == ["eager"] * FRAMES
    for (a, sa, la), (b, sb, lb) in zip(got, eager):
        assert torch.equal(a, b)
        assert torch.equal(sa["rays_traced"], sb["rays_traced"])
        assert la == lb
