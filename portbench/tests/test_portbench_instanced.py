"""The instanced cells (mode pt_instanced) on the CPU at a tiny size: the
static and the moving cell agree with the plain reference; the control
(the reference in bfloat16 in the program's place) fails their limits; a
run whose refresh leaves the previous frame's TLAS in place (the TLAS rows
and the instance rows that hold the transforms, as the reference's TLAS
holds them), and one that skips the refresh, come out not correct; the
motion repeats from the seed; and the instanced count gives fixed bytes
for fixed shapes.  On the card, each cell runs end to end through run.py
(one short run), correct, with the instanced metrics in a traced line.

The CPU's plain two-level trace visits every instance, so the faults are
judged from a tiny frame that looks closely at one instance: there a frame
of motion spans pixels, as it does at 1280x720 (about 4 pixels)."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import checks, motion, roofline_inst, run
from portbench.modes import pt_instanced
from portbench.scenes import sunlit_stress
from portbench.tests.helpers import BENCH, frames_window

CELLS = {"sunlit_stress.pt_720p_instanced": "pt_720p_instanced",
         "sunlit_stress.pt_720p_moving": "pt_720p_moving"}
TINY = {"generator": "sunlit_stress",
        "params": {"instances": 8, "sphere_detail": 6}}
SEED = 2_147_483_659
# A close view of the grid's cube at (-4, 4, 4), 48x32 pixels of about
# 0.04 world units, every pixel checked.
CLOSE = {"position": (-4.0, 4.0, 8.5), "y_fov": 0.3}
CLOSE_SIZE = (48, 32)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _traffic(workload, width=32, height=16, check_pixels=128):
    traffic = json.loads((Path(run.HERE) / "traffic"
                          / f"{CELLS[workload]}.json").read_text())
    traffic.update(width=width, height=height, check_pixels=check_pixels,
                   warm_frames=1, check_frames=[1, 1])
    if traffic["move_instances"]:
        traffic["move_instances"] = TINY["params"]["instances"]
    return traffic


def _run(workload, **size):
    loaded = (BENCH, {"name": workload, "chips": 1}, TINY,
              _traffic(workload, **size))
    return run.run_cell(workload, SEED, 1.0, False, torch.device("cpu"),
                        torch, time.perf_counter(), window_fn=frames_window,
                        loaded=loaded, cell_limits=checks.limits(workload))


def _close_view(monkeypatch):
    def make(params, placement_seed):
        arrays = sunlit_stress.make(params, placement_seed)
        return dataclasses.replace(arrays, camera=dataclasses.replace(
            arrays.camera, **CLOSE))

    monkeypatch.setattr(pt_instanced, "load_generator",
                        lambda name: type("Close", (), {"make": make}))


@pytest.mark.parametrize("workload", list(CELLS))
def test_program_agrees_with_reference(workload):
    result, numbers, limits, session = _run(workload)
    assert result["correct"], (numbers, limits)
    assert result["attempted"] == 2
    # Warm frame, then the window's two: the checked frame is the third.
    moving = CELLS[workload] == "pt_720p_moving"
    assert session.rendered == 3
    assert session.captured["motion_frame"] == (2 if moving else None)


@pytest.mark.parametrize("workload", list(CELLS))
def test_control_fails(workload):
    _, _, limits, session = _run(workload)
    control = session.control(torch.bfloat16)
    assert not checks.verdict(control, limits), (control, limits)


def _stale_refresh(monkeypatch):
    """The refresh of frame n writes frame n - 1's TLAS: its rows and the
    instance rows."""
    from steeljax_torch.accel import instances

    refresh = instances.InstancedAccel.refresh
    kept = {}

    def stale(self, scene, flat, tables, materials=False):
        out = refresh(self, scene, flat, tables, materials)
        parts = (tables.snode_rows[:tables.n_tlas], tables.inst_trace,
                 tables.inst_shade)
        now = [t.clone() for t in parts]
        for part, previous in zip(parts, kept.get("previous", ())):
            part.copy_(previous)
        kept["previous"] = now
        return out

    monkeypatch.setattr(instances.InstancedAccel, "refresh", stale)


def _skipped_refresh(monkeypatch):
    """The mode moves the instances and calls no refresh."""
    monkeypatch.setattr(pt_instanced.Session, "_refresh", lambda self: None)


@pytest.mark.parametrize("fault", [_stale_refresh, _skipped_refresh])
def test_a_stale_scene_is_not_correct(fault, monkeypatch):
    """Correct in the close view, not correct there with the fault."""
    _close_view(monkeypatch)
    width, height = CLOSE_SIZE
    close = dict(width=width, height=height, check_pixels=width * height)
    result, numbers, limits, _ = _run("sunlit_stress.pt_720p_moving",
                                      **close)
    assert result["correct"], (numbers, limits)
    fault(monkeypatch)
    result, numbers, limits, _ = _run("sunlit_stress.pt_720p_moving",
                                      **close)
    assert not result["correct"], (numbers, limits)


def test_motion_repeats_from_the_seed():
    arrays = sunlit_stress.make({"instances": 300, "sphere_detail": 4}, 7)
    a, b = (motion.Motion(arrays, 300, SEED) for _ in range(2))
    other = motion.Motion(arrays, 300, SEED + 1)
    assert a.entities == list(range(10, 310))
    for frame in (0, 5, 47):
        np.testing.assert_array_equal(a.transforms(frame),
                                      b.transforms(frame))
        assert not np.array_equal(a.transforms(frame),
                                  other.transforms(frame))
    step = np.linalg.norm(a.transforms(1)[:, :3, 3]
                          - a.transforms(0)[:, :3, 3], axis=-1)
    assert 0.0 < step.max() <= motion.AMPLITUDE * 2 * np.pi \
        / motion.SWAY_FRAMES
    # The scale is kept: each column's length is the base's.
    np.testing.assert_allclose(
        np.linalg.norm(a.transforms(3)[:, :3, :3], axis=1),
        np.linalg.norm(a.linear, axis=1), rtol=1e-6)
    moved = a.arrays_at(arrays, 3)
    assert moved.entities[9] is arrays.entities[9]
    np.testing.assert_array_equal(moved.entities[10].transform,
                                  a.transforms(3)[0])
    assert motion.moved_entities(arrays, 0) == []


def test_instanced_count_repeats_exactly():
    arrays = sunlit_stress.make({"instances": 300, "sphere_detail": 16}, 7)
    counted = roofline_inst.scene_shapes(arrays)
    assert counted == {"distinct_triangles": 1038, "instances": 310}
    assert roofline_inst.trace_bytes(counted) == 52_248
    shapes = {"rays_per_frame": 3_000_000.0, "traces_per_frame": 8,
              **counted}
    assert roofline_inst.least_bytes(shapes) == 3_000_000 * 48 \
        + 8 * 52_248
    assert roofline_inst.least_ms(shapes) == \
        roofline_inst.least_bytes(dict(shapes)) / 3.35e12 * 1000.0


@pytest.mark.card
@pytest.mark.parametrize("workload", list(CELLS))
def test_cell_runs_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "3141592653", "--seconds", "2", "--trace", "1"],
        cwd=Path(run.ROOT), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert metrics["graph_frames_pct.inst"]["value"] == 100.0
    assert 0.0 < metrics["trace_roofline.inst"]["value"] < 100.0
    assert ("refresh_ms.inst" in metrics) == \
        (CELLS[workload] == "pt_720p_moving")
