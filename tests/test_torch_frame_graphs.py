"""Path-traced frames replayed as CUDA graphs (render/pt/frame_graphs.py),
on the CPU through a stand-in capturer: which changes capture a new graph
and which replay the old one, a replay's image against the frame as the
CPU runs it, the CPU's own frames never captured, a capture that raises
falling back to eager once, the launch counters left to what the host
launched, tiled_order's pixels uploaded once, and the seed word the
replays read."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from steeljax_torch.core import profiling, rng
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.entry import _tiny_setup
from steeljax_torch.render.pt import frame_graphs, integrator
from test_torch_support import one_torch_thread  # noqa: F401

W, H = 16, 8


class StandIn:
    """Accepts every device.  A capture runs fn once and keeps its tensors;
    a replay runs fn again and writes its tensors into those, as a CUDA
    graph's replay rewrites the buffers it captured.  With `fail`, every
    capture raises as one over a host read does."""

    def __init__(self, fail: bool = False):
        self.fail = fail
        self.captures = 0

    def accepts(self, device) -> bool:
        return True

    def capture(self, fn, device):
        self.captures += 1
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        outputs = fn()

        def replay():
            for out, new in zip(outputs, fn()):
                out.copy_(new)

        return replay, outputs


class Kept(StandIn):
    """A stand-in whose replay keeps nothing of the frame (as a CUDA
    graph's, which holds no reference to the tables it reads): it leaves
    the outputs as the capture wrote them."""

    def capture(self, fn, device):
        return (lambda: None), super().capture(fn, device)[1]


@pytest.fixture(scope="module")
def cornell():
    flat, tables, frame = _tiny_setup("cpu")
    ys, xs = np.meshgrid(np.arange(H, dtype=np.int32),
                         np.arange(W, dtype=np.int32), indexing="ij")
    return {"flat": flat, "tables": tables, "view": frame.inverse_view,
            "proj": frame.inverse_proj, "px": xs.reshape(-1),
            "py": ys.reshape(-1)}


@pytest.fixture(autouse=True)
def fresh_record():
    profiling.reset()
    yield
    profiling.reset()


def _frame(c, accumulation=0, sample=0, **changes):
    args = dict(c, near=0.01, far=100.0,
                config=RenderConfig(width=W, height=H))
    args.update(changes)
    result, stats = integrator.render_pixels(
        args["flat"], args["tables"], args["view"], args["proj"],
        args["near"], args["far"], W, H, args["px"], args["py"],
        accumulation, sample, args["config"], return_stats=True)
    return result, stats


def _cpu_frame(c, monkeypatch, **changes):
    """The frame as the CPU runs it, whatever FRAME_GRAPHS is."""
    with monkeypatch.context() as m:
        m.setattr(integrator, "FRAME_GRAPHS", frame_graphs.FrameGraphs(
            frame_graphs.CudaGraphs()))
        return _frame(c, **changes)


def _ran():
    return [row["ran"] for row in profiling.record()["rows"]]


def _stand_in(monkeypatch, **kw):
    capturer = StandIn(**kw)
    monkeypatch.setattr(integrator, "FRAME_GRAPHS",
                        frame_graphs.FrameGraphs(capturer))
    return capturer


def _moved(view):
    moved = np.array(view, np.float32, copy=True)
    moved[:3, 3] += np.float32(0.05)
    return moved


def _recapture_change(name, c, monkeypatch):
    """The frame arguments after the change `name`, with the environment
    or module attribute it needs set through monkeypatch."""
    if name == "tables":
        return {"tables": c["tables"].replace()}
    if name == "scene":
        return {"flat": c["flat"].replace()}
    if name == "config":
        return {"config": RenderConfig(width=W, height=H,
                                       max_irradiance=7.0)}
    if name == "pixel_arrays":
        # Another number of pixels: the graph's buffers have another shape.
        return {"px": c["px"][W:].copy(), "py": c["py"][W:].copy()}
    if name == "near":
        return {"near": 0.02}
    if name == "far":
        return {"far": 50.0}
    if name == "STEELJAX_REPACK":
        monkeypatch.setenv("STEELJAX_REPACK", "live")
    elif name == "STEELJAX_SHADE_MODE":
        monkeypatch.setenv("STEELJAX_SHADE_MODE", "0")
    elif name == "REPACK_MIN_TRIS":
        monkeypatch.setattr(integrator, "REPACK_MIN_TRIS", -1)
    return {}


@pytest.mark.parametrize("name", [
    "tables", "scene", "config", "pixel_arrays", "near", "far",
    "STEELJAX_REPACK", "STEELJAX_SHADE_MODE", "REPACK_MIN_TRIS"])
def test_a_change_the_graph_bakes_in_captures_anew(name, cornell,
                                                   monkeypatch):
    """Three frames of one key run eager, capture, replay; after the
    change the next frame is a new key's first (eager), the one after it
    a capture, and its image is the CPU's own frame of the changed
    arguments."""
    capturer = _stand_in(monkeypatch)
    for i in range(3):
        _frame(cornell, accumulation=i)
    changed = _recapture_change(name, cornell, monkeypatch)
    got = [_frame(cornell, **changed) for _ in range(3)]
    expected, stats = _cpu_frame(cornell, monkeypatch, **changed)
    assert _ran()[:6] == ["eager", "capture", "replay",
                          "eager", "capture", "replay"]
    assert capturer.captures == 2
    for result, got_stats in got:
        assert torch.equal(result, expected)
        assert torch.equal(got_stats["rays_traced"], stats["rays_traced"])


@pytest.mark.parametrize("name", ["accumulation", "sample", "matrices",
                                  "matrices_as_tensors", "pixels",
                                  "pixels_as_tensors",
                                  "pixels_changed_in_place"])
def test_what_changes_each_frame_replays(name, cornell, monkeypatch):
    """A rising accumulation index, a new sample index, a moved camera or
    other pixels of the same number (host arrays, tensors, or one array
    written between frames) replay the key's graph, which reads them from
    its buffers: every replayed image is the CPU's own frame."""
    shared = (cornell["px"].copy(), cornell["py"].copy())

    def frame_args(i):
        if name == "accumulation":
            return {"accumulation": i}
        if name == "sample":
            return {"sample": 3 * i + 1}
        if name.startswith("pixels"):
            px = np.roll(cornell["px"], 5 * i)
            py = np.roll(cornell["py"], 5 * i)
            if name == "pixels_as_tensors":
                return {"px": torch.as_tensor(px), "py": torch.as_tensor(py)}
            if name == "pixels_changed_in_place":
                shared[0][:], shared[1][:] = px, py
                return {"px": shared[0], "py": shared[1]}
            return {"px": px, "py": py}
        view = _moved(cornell["view"]) if i % 2 else cornell["view"]
        if name == "matrices_as_tensors":
            return {"view": torch.as_tensor(view),
                    "proj": torch.as_tensor(cornell["proj"])}
        return {"view": view}

    expected = [_frame(cornell, **frame_args(i))[0].clone()
                for i in range(5)]
    capturer = _stand_in(monkeypatch)
    profiling.reset()
    got = [_frame(cornell, **frame_args(i))[0] for i in range(5)]
    assert _ran() == ["eager", "capture", "replay", "replay", "replay"]
    assert capturer.captures == 1
    for a, b in zip(got, expected):
        assert torch.equal(a, b)
    assert not torch.equal(expected[2], expected[3])


def test_replayed_outputs_are_the_callers_own(cornell, monkeypatch):
    """The tensors a replay returns are copies: the next replay, which
    rewrites the graph's outputs, leaves them as they were."""
    _stand_in(monkeypatch)
    frames = [_frame(cornell, accumulation=i) for i in range(4)]
    first, stats = frames[2]
    kept = first.clone(), stats["rays_traced"].clone()
    later, later_stats = frames[3]
    assert first.data_ptr() != later.data_ptr()
    assert stats["rays_traced"].data_ptr() != \
        later_stats["rays_traced"].data_ptr()
    _frame(cornell, accumulation=9)
    assert torch.equal(first, kept[0])
    assert torch.equal(stats["rays_traced"], kept[1])


def test_a_cpu_frame_never_captures(cornell, monkeypatch):
    """The default capturer takes CUDA devices only: CPU frames run as
    written, each with its pixel upload."""
    captured = []
    graphs = frame_graphs.FrameGraphs(frame_graphs.CudaGraphs())
    monkeypatch.setattr(graphs.capturer, "capture",
                        lambda fn, device: captured.append(device))
    monkeypatch.setattr(integrator, "FRAME_GRAPHS", graphs)
    for i in range(4):
        _frame(cornell, accumulation=i)
    rows = profiling.record()["rows"]
    assert captured == [] and _ran() == ["eager"] * 4
    assert all(row["spans"]["integrator.upload_pixels"] > 0.0
               for row in rows)
    assert graphs.graphs() == 0


def test_a_failed_capture_falls_back_to_eager_once(cornell, monkeypatch):
    """A capture that raises is tried once: that frame and every later one
    of the key run eagerly, with the CPU's own image."""
    expected = [_frame(cornell, accumulation=i)[0] for i in range(4)]
    capturer = _stand_in(monkeypatch, fail=True)
    profiling.reset()
    got = [_frame(cornell, accumulation=i)[0] for i in range(4)]
    assert capturer.captures == 1
    assert _ran() == ["eager"] * 4
    assert all(torch.equal(a, b) for a, b in zip(got, expected))
    assert integrator.FRAME_GRAPHS.graphs() == 0


def test_replays_add_nothing_to_the_launch_counters(cornell, monkeypatch):
    """The launch counters count what the host launched: the eager frame
    and the capture each add a frame's launches, a replay (here one that
    runs nothing, as a CUDA graph's runs no Python) nothing."""
    def counted(graphs):
        monkeypatch.setattr(integrator, "FRAME_GRAPHS", graphs)
        added = []
        for i in range(4):
            before = dict(frame_graphs.COUNTERS[0])
            _frame(cornell, accumulation=i)
            added.append({k: v - before[k] for k, v in
                          frame_graphs.COUNTERS[0].items() if v != before[k]})
        return added

    launched = []
    monkeypatch.setattr(integrator, "trace_nearest", _counting(
        integrator.trace_nearest, launched))
    eager = counted(frame_graphs.FrameGraphs(frame_graphs.Eager()))
    graphed = counted(frame_graphs.FrameGraphs(Kept()))
    bounces = RenderConfig().max_bounce_count
    assert _ran()[-4:] == ["eager", "capture", "replay", "replay"]
    assert eager == [{"K1": bounces}] * 4
    assert graphed == [{"K1": bounces}] * 2 + [{}, {}]
    assert len(launched) == 6 * bounces


def _counting(fn, calls):
    """fn, adding one to COUNTERS[0]["K1"] and to `calls` a call, as a
    kernel's launch wrapper counts its launches."""
    def wrapped(*args, **kw):
        calls.append(1)
        frame_graphs.COUNTERS[0]["K1"] += 1
        return fn(*args, **kw)
    return wrapped


@pytest.mark.parametrize("width, height", [(32, 16), (20, 6)],
                         ids=["tiles", "row_major"])
def test_whole_frames_upload_their_pixels_once(width, height, cornell):
    """render_sample's pixels (frame_pixels: tiled_order's where the extent
    tiles) go to the device once per extent and device, and render_pixels
    takes tiled_order's own arrays from there without an upload; a copy
    of them is uploaded each frame.  tiled_order's arrays stay as numpy
    makes them (writable, so torch.as_tensor takes them quietly)."""
    integrator.frame_pixels.cache_clear()
    device = cornell["flat"].device
    config = RenderConfig(width=width, height=height)
    images = [integrator.render_sample(
        cornell["flat"], cornell["tables"], cornell["view"],
        cornell["proj"], 0.01, 100.0, width, height, i, 0, config)
        for i in range(2)]
    px, py, tile = integrator.frame_pixels(width, height, device)
    assert integrator.frame_pixels.cache_info().misses == 1
    assert px.dtype == py.dtype == torch.int64
    tiled = integrator.tiled_order(width, height)
    assert (tile is None) == (tiled is None)
    host = tiled[:2] if tiled else (px.numpy(), py.numpy())
    profiling.reset()
    for arrays in (host, tuple(a.copy() for a in host)):
        result = integrator.render_pixels(
            cornell["flat"], cornell["tables"], cornell["view"],
            cornell["proj"], 0.01, 100.0, width, height, *arrays, 1, 0,
            config)
        image = result.reshape(height, width, 3) if tile is None else \
            integrator.detile(result, width, height, tile)
        assert torch.equal(image, images[1])
    uploads = ["integrator.upload_pixels" in row["spans"]
               for row in profiling.record()["rows"]]
    assert uploads == [tiled is None, True]
    if tiled is not None:
        assert tiled[0].flags.writeable and tiled[1].flags.writeable


def test_graphs_go_with_their_tables_and_stay_bounded(cornell, monkeypatch):
    """Each device keeps at most GRAPHS_PER_DEVICE graphs, and a graph
    goes with the tables it reads."""
    monkeypatch.setattr(integrator, "FRAME_GRAPHS",
                        frame_graphs.FrameGraphs(Kept()))
    tables = [cornell["tables"].replace() for _ in range(3)]
    for t in tables:
        for i in range(2):
            _frame(cornell, accumulation=i, tables=t)
    assert integrator.FRAME_GRAPHS.graphs() == \
        frame_graphs.GRAPHS_PER_DEVICE
    del t
    tables.pop()
    assert integrator.FRAME_GRAPHS.graphs() == \
        frame_graphs.GRAPHS_PER_DEVICE - 1


def test_retrace_counts_of_a_replay_are_in_its_row(monkeypatch):
    """An alpha-tested tile: a replayed frame's re-trace counts are its
    own (equal to the CPU's frame's) and registered in its row."""
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.render.pt import renderer
    from steeljax_torch.scene import builtin

    scene = builtin.make_foliage_scene(cards=60, region=2.0)
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16)
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.int32),
                         np.arange(W, dtype=np.int32), indexing="ij")
    c = {"flat": flat, "tables": tables, "view": frame.inverse_view,
         "proj": frame.inverse_proj, "px": xs.reshape(-1),
         "py": ys.reshape(-1)}
    _, expected = _frame(c, accumulation=2)
    _stand_in(monkeypatch)
    for i in range(3):
        _, stats = _frame(c, accumulation=i)
    log = stats["alpha_retrace"]
    assert [label for label, _ in log] == \
        [label for label, _ in expected["alpha_retrace"]]
    counts = [int(x) for _, cs in log for x in cs]
    assert counts == [int(x) for _, cs in expected["alpha_retrace"]
                      for x in cs]
    row = profiling.record()["rows"][-1]
    assert row["ran"] == "replay"
    assert row["retrace"]["pending"] == sum(
        int(x) for _, cs in log for x in cs[:-1])
    assert row["retrace"]["slots"] == len(log) * 4 * W * H


@pytest.mark.parametrize("sample, accumulation", [
    (0, 0), (1, 0), (0, 7), (5, 3), ((1 << 24) - 1, 255),
    (123_456, (1 << 32) - 1), (1 << 31, 1 << 20)])
def test_make_seed_from_a_device_word_is_bit_equal(sample, accumulation):
    px = torch.arange(0, 4096, 7, dtype=torch.int64) % 1280
    py = torch.arange(0, 4096, 7, dtype=torch.int64) // 1280
    word = torch.tensor(rng.seed_word(sample, accumulation),
                        dtype=torch.int64)
    assert torch.equal(rng.make_seed(px, py, word=word),
                       rng.make_seed(px, py, sample, accumulation))



def _graph_frames_pct():
    path = (Path(__file__).resolve().parents[1] / "portbench" / "metrics"
            / "graph_frames_pct.pt.py")
    spec = importlib.util.spec_from_file_location("graph_frames_pct", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _row(ran, profiled=False, frame="integrator.render_pixels"):
    row = {"frame": frame, "ms": 1.0, "wait_ms": 0.0, "spans": {},
           "self_ms": {}, "profiled": profiled}
    if ran is not None:
        row["ran"] = ran
    return row


@pytest.mark.parametrize("rows, frames, expected", [
    # Set-up's eager and capture frames fall outside the window's count.
    (["eager", "capture", "replay", "replay", "replay"], 3, 100.0),
    (["eager", "capture", "replay", "eager", "replay"], 3, 200.0 / 3),
    (["eager", "eager", "eager", "eager"], 2, 0.0),
    (["eager", "capture", "replay", "replay"], None, 50.0),
    ([None, None, None], 2, None),
], ids=["all_replays", "one_eager", "never_captured", "no_window",
        "program_without_graphs"])
def test_graph_frames_pct_reads_the_windows_replays(rows, frames, expected):
    """The reader of graph_frames_pct.pt (portbench/metrics): the share of
    replays among the last `frames` unprofiled path-traced rows; profiled
    and hybrid rows are left out."""
    record = {"rows": [_row(ran) for ran in rows]
              + [_row("eager", profiled=True),
                 _row(None, frame="hybrid.render_frame_device")],
              "totals": {}}
    ctx = {"mode": "pt", "program_record": record}
    if frames is not None:
        ctx["window"] = {"frames": frames}
    got = _graph_frames_pct()(ctx)
    assert got == (None if expected is None else pytest.approx(expected))
    assert _graph_frames_pct()({"mode": "hybrid",
                                "program_record": record}) is None
