"""Hybrid frames: the traffic mode "hybrid".

Set-up builds the configuration's scene from the seed, hands it to the
program through its public scene API and builds
`steeljax_torch.render.hybrid.renderer.HybridRenderer` (scene preparation
and the environment bakes at `load_environment`'s defaults), then renders
warm frames.  A frame is `HybridRenderer.render_frame_device()`: the
display image left on the card.

The check: on one frame of the window, drawn from the seed, the frame's
colour at pixels drawn from the seed is copied aside on the card; after
the window the reference hybrid frame (portbench.reference.hybrid) renders
the same pixels, its environment baked again.  A hybrid frame has no
accumulation and no random numbers.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import checks
from portbench.reference import environment as ref_env
from portbench.reference import hybrid as ref_hybrid
from portbench.reference import scene as ref_scene
from portbench.reference import trace as ref_trace
from portbench.scenes import load_generator
from portbench.scenes.common import placement_seed

SPANS = ("gbuffer_stage", "lighting_stage", "forward_stage")


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 torch):
        from portbench import port_scene
        from steeljax_torch.core.config import RenderConfig
        from steeljax_torch.render.hybrid.renderer import HybridRenderer

        self.torch = torch
        self.device = device
        self.width, self.height = traffic["width"], traffic["height"]
        rng = np.random.default_rng(placement_seed(seed, 2))
        self.capture_frame = int(rng.integers(traffic["check_frames"][0],
                                              traffic["check_frames"][1] + 1))
        self.min_frames = self.capture_frame + 1
        rows = np.sort(rng.choice(self.width * self.height,
                                  traffic["check_pixels"], replace=False))
        self.check_px, self.check_py = rows % self.width, rows // self.width
        self._rows = torch.as_tensor(rows, device=device, dtype=torch.int64)

        t = time.perf_counter()
        generator = load_generator(config["generator"])
        self.arrays = generator.make(config["params"],
                                     placement_seed(seed, 1))
        scene = port_scene.build(self.arrays)
        self.setup_steps = {"scene": time.perf_counter() - t}
        t = time.perf_counter()
        self.renderer = HybridRenderer(
            scene, self.width, self.height,
            RenderConfig(width=self.width, height=self.height),
            device=device)
        self._sync()
        self.prepare_s = time.perf_counter() - t
        self.lights = sum(e.light_color is not None
                          for e in self.arrays.entities)
        self.triangles = self.arrays.triangle_count()
        t = time.perf_counter()
        for _ in range(traffic["warm_frames"]):
            self.renderer.render_frame_device()
        self._sync()
        self.setup_steps["warm"] = time.perf_counter() - t
        self.captured = None
        self.hit_share = None

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def step(self, n: int) -> None:
        out = self.renderer.render_frame_device()
        if n == self.capture_frame:
            self.captured = out.index_select(0, self._rows).clone()

    def end_to_end(self, window: dict) -> dict:
        return {}

    def shapes(self, first: int, frames: int) -> dict:
        """The roofline count's inputs: one G-buffer ray a pixel and one
        shadow ray a light for each pixel whose G-buffer ray hit (the share
        of the check pixels the reference found hit, over the frame)."""
        pixels = self.width * self.height
        if self.hit_share is None:
            return None
        return {"rays_per_frame": pixels * (1.0 + self.lights
                                            * self.hit_share),
                "traces_per_frame": 1 + self.lights,
                "triangles": self.triangles}

    def release(self) -> None:
        """Drop the program's renderer: its tables, environment and
        frames."""
        self.renderer = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def render_reference(self, dtype):
        torch = self.torch
        scene = ref_scene.build(self.arrays, self.device, dtype)
        tris = ref_trace.Triangles(scene)
        with torch.no_grad():
            env = ref_env.Environment(self.device, dtype)
            dev = {"device": self.device, "dtype": torch.int64}
            out, hit = ref_hybrid.render_pixels(
                scene, tris, env, self.width, self.height,
                torch.as_tensor(self.check_px, **dev),
                torch.as_tensor(self.check_py, **dev))
        return out.float(), hit

    def judge(self) -> dict:
        torch = self.torch
        if self.captured is None:
            raise RuntimeError("the window ended before the checked frame")
        t = time.perf_counter()
        expected, hit = self.render_reference(torch.float32)
        print(f"reference: {time.perf_counter() - t:.3f} s", file=sys.stderr)
        self.hit_share = float(hit.float().mean())
        return checks.frame_numbers(torch, self.captured, expected)

    def control(self, dtype) -> dict:
        """The compared numbers of the control: the reference computed in
        `dtype` put in the program's place."""
        torch = self.torch
        expected = self.render_reference(torch.float32)[0]
        low = self.render_reference(dtype)[0]
        return checks.frame_numbers(torch, low, expected)
