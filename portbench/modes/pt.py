"""Path-traced frames: the traffic mode "pt".

Set-up builds the configuration's scene from the seed, hands it to the
program through its public scene API, prepares it
(`steeljax_torch.render.pt.renderer.prepare_scene`) and renders warm frames.
A frame is what `render_sample` and `PathTracingRenderer.render_frame`
do: `integrator.render_pixels(..., return_stats=True)` over
`tiled_order(width, height)`'s pixels, the detile, and
`renderer.accumulate` into the accumulation image on the card.

The check: on one frame of the window, drawn from the seed, the frame's
radiance at pixels drawn from the seed and the accumulation image at those
pixels before and after the frame are copied aside on the card.  After the
window the reference path tracer (portbench.reference.path) renders the
same pixels with the same sample sequence, and the accumulation is worked
out again from the copies.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import checks
from portbench.reference import path as ref_path
from portbench.reference import scene as ref_scene
from portbench.reference import trace as ref_trace
from portbench.scenes import load_generator
from portbench.scenes.common import placement_seed

SPANS = ()


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 torch):
        from portbench import port_scene
        from steeljax_torch.core import camera as camera_lib
        from steeljax_torch.core.config import RenderConfig
        from steeljax_torch.render.pt import integrator
        from steeljax_torch.render.pt import renderer

        self.torch = torch
        self.device = device
        self.width, self.height = traffic["width"], traffic["height"]
        rng = np.random.default_rng(placement_seed(seed, 2))
        self.sample_index = int(rng.integers(0, 1 << 24))
        self.capture_frame = int(rng.integers(traffic["check_frames"][0],
                                              traffic["check_frames"][1] + 1))
        self.min_frames = self.capture_frame + 1
        pixels = self.width * self.height
        self.check_slots = np.sort(rng.choice(pixels, traffic["check_pixels"],
                                              replace=False))

        t = time.perf_counter()
        generator = load_generator(config["generator"])
        self.arrays = generator.make(config["params"],
                                     placement_seed(seed, 1))
        scene = port_scene.build(self.arrays)
        self.setup_steps = {"scene": time.perf_counter() - t}
        t = time.perf_counter()
        self.flat, self.tables = renderer.prepare_scene(scene, device)
        self._sync()
        self.prepare_s = time.perf_counter() - t
        frame = camera_lib.make_frame(scene.camera_location,
                                      scene.camera_projection)
        self.near, self.far = frame.camera_near, frame.camera_far
        self.inverse_view = torch.as_tensor(frame.inverse_view,
                                            device=device)
        self.inverse_proj = torch.as_tensor(frame.inverse_proj,
                                            device=device)
        self.config = RenderConfig(
            width=self.width, height=self.height,
            sample_count=traffic["spp"],
            min_bounce_count=traffic["min_bounce_count"],
            max_bounce_count=traffic["max_bounce_count"],
            rr_min_threshold=traffic["rr_min_threshold"],
            max_irradiance=traffic["max_irradiance"])
        self.integrator = integrator
        self.renderer = renderer
        tiled = integrator.tiled_order(self.width, self.height)
        if tiled is None:
            ys, xs = np.meshgrid(np.arange(self.height, dtype=np.int32),
                                 np.arange(self.width, dtype=np.int32),
                                 indexing="ij")
            self.px, self.py, self.tile = xs.reshape(-1), ys.reshape(-1), None
        else:
            self.px, self.py, self.tile = tiled
        self.check_px = self.px[self.check_slots]
        self.check_py = self.py[self.check_slots]
        dev = {"device": device, "dtype": torch.int64}
        self._slots = torch.as_tensor(self.check_slots, **dev)
        self._cy = torch.as_tensor(self.check_py, **dev)
        self._cx = torch.as_tensor(self.check_px, **dev)
        self.triangles = self.arrays.triangle_count()
        self.lit = any(e.light_color is not None
                       for e in self.arrays.entities)

        t = time.perf_counter()
        for _ in range(traffic["warm_frames"]):
            self._frame(renderer.init_accumulation(self.width, self.height,
                                                   device))
        self._sync()
        self.setup_steps["warm"] = time.perf_counter() - t
        self.state = renderer.init_accumulation(self.width, self.height,
                                                device)
        self.rays = []
        self.captured = None

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def _frame(self, state):
        result, stats = self.integrator.render_pixels(
            self.flat, self.tables, self.inverse_view, self.inverse_proj,
            self.near, self.far, self.width, self.height, self.px, self.py,
            state.index, self.sample_index, self.config, return_stats=True)
        image = result if self.tile is None else self.integrator.detile(
            result, self.width, self.height, self.tile)
        image = image.reshape(self.height, self.width, 3)
        return result, stats, self.renderer.accumulate(state, image)

    def step(self, n: int) -> None:
        before = self.state
        result, stats, self.state = self._frame(before)
        self.rays.append(stats["rays_traced"])
        if n == self.capture_frame:
            self.captured = {
                "index": before.index,
                "result": result.index_select(0, self._slots).clone(),
                "before": before.accumulated[self._cy, self._cx].clone(),
                "after": self.state.accumulated[self._cy, self._cx].clone(),
                "retrace": stats["alpha_retrace"]}

    def rays_of(self, first: int, last: int) -> float:
        """Rays traced by frames first .. last - 1, read once."""
        return float(self.torch.stack(self.rays[first:last]).sum())

    def end_to_end(self, window: dict) -> dict:
        rays = self.rays_of(0, window["frames"])
        return {"rays": rays, "rays_per_s": rays / window["wall_s"]}

    def shapes(self, first: int, frames: int) -> dict:
        """What the roofline count reads for frames first .. first +
        frames - 1: the rays the frames needed traced (the integrator's
        rays_traced), the trace calls a frame makes (a nearest trace a
        bounce, a shadow trace a bounce in a lit scene) and the scene's
        triangles."""
        traces = self.config.max_bounce_count * (2 if self.lit else 1)
        return {"rays_per_frame": self.rays_of(first, first + frames)
                / frames, "traces_per_frame": traces,
                "triangles": self.triangles}

    def release(self) -> None:
        """Drop the program's scene, tables and images."""
        self.flat = self.tables = self.state = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def reference(self, dtype):
        scene = ref_scene.build(self.arrays, self.device, dtype)
        return scene, ref_trace.Triangles(scene)

    def judge(self) -> dict:
        """The compared numbers: the program's radiance and accumulation at
        the check pixels against the reference's."""
        torch = self.torch
        if self.captured is None:
            raise RuntimeError("the window ended before the checked frame")
        cap = self.captured
        for label, counts in cap["retrace"]:
            print(f"alpha re-trace {label}: "
                  f"{[int(c) for c in counts]} rays pending by pass",
                  file=sys.stderr)
        t = time.perf_counter()
        expected = self.render_reference(torch.float32)
        print(f"reference: {time.perf_counter() - t:.3f} s", file=sys.stderr)
        numbers = checks.frame_numbers(torch, cap["result"], expected)
        numbers["accum_gap"] = checks.accum_gap(
            torch, cap["result"], cap["before"], cap["after"], cap["index"])
        return numbers

    def control(self, dtype) -> dict:
        """The compared numbers of the control: the reference computed in
        `dtype` put in the program's place for the radiance, and the
        accumulation computed in `dtype` (over the float32 reference's
        radiance, which also stands in for the image before the frame)."""
        torch = self.torch
        expected = self.render_reference(torch.float32)
        low = self.render_reference(dtype)
        index = self.captured["index"]
        numbers = checks.frame_numbers(torch, low, expected)
        after = ((expected.to(dtype) + index * expected.to(dtype))
                 / (index + 1.0)).float()
        numbers["accum_gap"] = checks.accum_gap(torch, expected, expected,
                                                after, index)
        return numbers

    def render_reference(self, dtype):
        torch = self.torch
        scene, tris = self.reference(dtype)
        dev = {"device": self.device, "dtype": torch.int64}
        config = {"max_bounce_count": self.config.max_bounce_count,
                  "min_bounce_count": self.config.min_bounce_count,
                  "rr_min_threshold": self.config.rr_min_threshold,
                  "max_irradiance": self.config.max_irradiance,
                  "backface_culling": self.config.backface_culling}
        with torch.no_grad():
            out = ref_path.render_pixels(
                scene, tris, self.width, self.height,
                torch.as_tensor(self.check_px, **dev),
                torch.as_tensor(self.check_py, **dev),
                self.captured["index"], self.sample_index, config)
        return out.float()
