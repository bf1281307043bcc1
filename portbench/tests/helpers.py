"""A tiny cell for the CPU tests: the same harness, configurations' scene
generators and check as a run on the card, at a size a test can hold, with
a fixed count of frames in place of the timed window."""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from portbench import checks, run

TRAFFIC = {mix: json.loads((Path(run.HERE) / "traffic" / f"{mix}.json")
                           .read_text())
           for mix in ("pt_720p", "hybrid_1080p")}
# The environment bakes at a size the CPU holds, the same in the program
# and the reference.
TINY_ENV = {"cube_resolution": 32, "irradiance_resolution": 8,
            "reflection_resolution": 16, "reflection_samples": 64,
            "irradiance_delta": 0.2}
TINY = {
    "foliage_alpha.pt_720p": {"generator": "foliage", "params": {
        "cards": 120, "region": 2.0, "card_size": 0.55, "serrated": True}},
    "sunlit_stress.pt_720p": {"generator": "sunlit_stress", "params": {
        "instances": 8, "sphere_detail": 6}},
    "sunlit_stress.hybrid_1080p": {"generator": "sunlit_stress", "params": {
        "instances": 8, "sphere_detail": 6}},
}
BENCH = {"end_to_end": [{"name": "setup_s", "unit": "s"},
                        {"name": "rays_per_s", "unit": "rays/s"}],
         "per_layer": []}


def tiny_traffic(workload: str) -> dict:
    traffic = dict(TRAFFIC[workload.split(".")[1]])
    traffic.update(width=32, height=16, check_pixels=128, warm_frames=1,
                   check_frames=[1, 1])
    return traffic


def tiny_environment(monkeypatch):
    """Shrink the program's and the reference's environment bakes alike."""
    from portbench.reference import environment as ref_env
    from steeljax_torch.env import environment
    from steeljax_torch.render.hybrid import renderer

    bake = environment.load_environment
    monkeypatch.setattr(renderer, "load_environment", lambda **kw: bake(
        **{**kw, **TINY_ENV, "lut_resolution": 8, "lut_samples": 16}))
    init = ref_env.Environment.__init__
    monkeypatch.setattr(ref_env.Environment, "__init__",
                        lambda self, device, dtype: init(self, device, dtype,
                                                         **TINY_ENV))


def frames_window(step, seconds, in_flight, min_frames):
    for n in range(min_frames):
        step(n)
    return {"frames": min_frames, "wall_s": 1.0,
            "frame_ms": [1.0] * min_frames}


def run_tiny(workload: str, seed: int = 2_147_483_659):
    """run.run_cell on the CPU for the tiny form of `workload`, judged by
    the cell's own limits: (result, numbers, limits, session)."""
    cell = {"name": workload, "chips": 1}
    loaded = (BENCH, cell, TINY[workload], tiny_traffic(workload))
    return run.run_cell(workload, seed, 1.0, False, torch.device("cpu"),
                        torch, time.perf_counter(), window_fn=frames_window,
                        loaded=loaded, cell_limits=checks.limits(workload))
