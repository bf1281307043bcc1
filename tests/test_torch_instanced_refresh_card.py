"""The instanced tables' per-frame refresh on the card: a small sunlit scene
prepared with the two-level structure (`InstancedAccel`, kernel K6), every
grid instance moved before each of 6 frames and the tables refreshed in
place (`InstancedAccel.refresh`, copies queued behind the frames in
flight, nothing synchronized between frames).  The frames run eager,
capture, then replay the one CUDA graph, and each is bit-equal to the same
frame run eagerly over tables prepared afresh, with and without the
repack (whose sort keys read the instances' bounds from the tables).
Every test skips without a CUDA device.  This file imports no JAX; on the
card's machine, which has none, run it without the suite's conftest:
`python -m pytest --noconftest -p no:cacheprovider -q -m card
tests/test_torch_instanced_refresh_card.py`."""

import numpy as np
import pytest
import torch

from steeljax_torch.accel import cuda_traverse, instances
from steeljax_torch.core import camera as camera_lib
from steeljax_torch.core import profiling
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.render.pt import frame_graphs, integrator, renderer
from steeljax_torch.scene import builtin

W, H = 320, 192
FRAMES = 6
GRID = 24
FIRST = 10  # make_stress_scene's room entities come first


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    profiling.reset()
    yield torch.device("cuda:0")
    profiling.reset()


def _move(scene, base, step: int) -> None:
    """Every grid instance turned about y and moved, by a step's own
    amount."""
    for k, m in enumerate(base):
        angle = 0.3 * step + 0.1 * k
        c, s = np.cos(angle), np.sin(angle)
        moved = m.copy()
        moved[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                                 np.float32) @ m[:3, :3]
        moved[:3, 3] += np.float32([0.2 * np.sin(step + k), 0.1 * step, 0])
        scene.entities[FIRST + k].local_transform = moved


def _prepared(scene, device, accel=None):
    return renderer.prepare_scene(
        scene, device, env_resolution=64,
        accel=accel or instances.InstancedAccel(device=device))


def _frame(flat, tables, frame, index: int):
    px, py, _ = integrator.tiled_order(W, H)
    return integrator.render_pixels(
        flat, tables, frame.inverse_view, frame.inverse_proj,
        frame.camera_near, frame.camera_far, W, H, px, py, index, 0,
        RenderConfig(width=W, height=H), return_stats=True)


@pytest.mark.card
@pytest.mark.parametrize("repack", [False, True])
def test_edited_frames_replay_bit_equal(card, monkeypatch, repack):
    if repack:
        monkeypatch.setattr(integrator, "REPACK_MIN_TRIS", -1)
    scene = builtin.make_sunlit_stress_scene(instances=GRID, sphere_detail=8)
    base = [scene.entities[k].local_transform.copy()
            for k in range(FIRST, FIRST + GRID)]
    accel = instances.InstancedAccel(device=card)
    flat, tables = _prepared(scene, card, accel)
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    monkeypatch.setattr(integrator, "FRAME_GRAPHS", frame_graphs.FrameGraphs(
        frame_graphs.CudaGraphs()))
    launches = dict(cuda_traverse.LAUNCHES)
    graphed = []
    for i in range(FRAMES):
        _move(scene, base, i)
        new_flat, new_tables = accel.refresh(scene, flat, tables)
        assert new_flat is flat and new_tables is tables
        graphed.append(_frame(flat, tables, frame, i))
    torch.cuda.synchronize()
    rows = profiling.record()["rows"]
    assert [row["ran"] for row in rows
            if row["frame"] == "integrator.render_pixels"] == \
        ["eager", "capture"] + ["replay"] * (FRAMES - 2)
    refreshes = [row for row in rows if row["frame"] == "instances.refresh"]
    assert len(refreshes) == FRAMES
    assert all(row["counters"]["instances.in_place"] == 1
               for row in refreshes)
    # K6 ran: the eager frame's and the capture's launches.
    assert any(k.startswith("K6") and v > launches.get(k, 0)
               for k, v in cuda_traverse.LAUNCHES.items())
    monkeypatch.setattr(integrator, "FRAME_GRAPHS", frame_graphs.FrameGraphs(
        frame_graphs.Eager()))
    eager = []
    for i, (image, stats) in enumerate(graphed):
        _move(scene, base, i)
        expected, expected_stats = _frame(*_prepared(scene, card), frame, i)
        assert torch.equal(image, expected), i
        assert torch.equal(stats["rays_traced"],
                           expected_stats["rays_traced"]), i
        eager.append(expected)
    assert not torch.equal(eager[2], eager[3])
