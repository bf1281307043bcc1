"""Path-traced frames over the two-level structure: the traffic mode
"pt_instanced".

The frames are mode "pt"'s (`portbench/modes/pt.py`): `integrator.
render_pixels(..., return_stats=True)` over `tiled_order`'s pixels, the
detile and `renderer.accumulate`, checked the same way against the plain
reference.  The difference is the preparation: `prepare_scene(...,
accel=InstancedAccel(device=...))`, a BLAS per primitive and a TLAS over
the instances (the reference renderer's layout, kernel K6).

With the mix's `move_instances` above 0, before every frame the session
renders (warm, window and traced frames alike) the last `move_instances`
instances take their transforms of that frame (`portbench.motion`, a
function of the seed and the frame's number), and the program's refresh
brings its tables up to date: `InstancedAccel.refresh(scene, flat,
tables)` where the program has it, else the older path
(`InstancedAccel.prepare` and `flatten.refresh_lights`, as
`PathTracingRenderer.refresh_scene` did).  The refresh resets the
accumulation, as `refresh_scene` does.  The reference renders the checked
frame's transforms: the generator's arrays with the moved entities'
transforms of that frame, handed to `reference.scene.build` as they are.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import motion, roofline_inst
from portbench.modes import pt
from portbench.reference import scene as ref_scene
from portbench.reference import trace as ref_trace
from portbench.scenes import load_generator
from portbench.scenes.common import placement_seed

SPANS = ()


class Session(pt.Session):
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 torch):
        from portbench import port_scene
        from steeljax_torch.accel import instances
        from steeljax_torch.core import camera as camera_lib
        from steeljax_torch.core.config import RenderConfig
        from steeljax_torch.render.pt import integrator
        from steeljax_torch.render.pt import renderer
        from steeljax_torch.scene import flatten

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
        self.scene = port_scene.build(self.arrays)
        self.motion = motion.Motion(self.arrays, traffic["move_instances"],
                                    seed)
        self.setup_steps = {"scene": time.perf_counter() - t}
        t = time.perf_counter()
        self.accel = instances.InstancedAccel(device=device)
        self.flat, self.tables = renderer.prepare_scene(
            self.scene, device, accel=self.accel)
        self._sync()
        self.prepare_s = time.perf_counter() - t
        self._refresh_lights = flatten.refresh_lights
        frame = camera_lib.make_frame(self.scene.camera_location,
                                      self.scene.camera_projection)
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
        # Frames rendered so far, warm frames included: the motion's clock.
        self.rendered = 0
        self.edited = None

        t = time.perf_counter()
        for _ in range(traffic["warm_frames"]):
            self._edit()
            self._frame(renderer.init_accumulation(self.width, self.height,
                                                   device))
        self._sync()
        self.setup_steps["warm"] = time.perf_counter() - t
        self.state = renderer.init_accumulation(self.width, self.height,
                                                device)
        self.rays = []
        self.captured = None

    def _edit(self) -> None:
        """Move the instances to this frame's transforms and refresh the
        program's tables (nothing without motion); count the frame."""
        frame = self.rendered
        self.rendered += 1
        if not self.motion.entities:
            return
        for i, m in zip(self.motion.entities,
                        self.motion.transforms(frame)):
            self.scene.entities[i].local_transform = m
        self.scene.revision += 1
        self._refresh()
        self.edited = frame

    def _refresh(self) -> None:
        """The program's refresh after the edit."""
        refresh = getattr(self.accel, "refresh", None)
        if refresh is not None:
            self.flat, self.tables = refresh(self.scene, self.flat,
                                             self.tables)
        else:
            self.tables = self.accel.prepare(self.scene)
            self.flat = self._refresh_lights(self.flat, self.scene)

    def step(self, n: int) -> None:
        self._edit()
        if self.motion.entities:
            # The refresh resets the accumulation (refresh_scene).
            self.state = self.renderer.init_accumulation(
                self.width, self.height, self.device)
        super().step(n)
        if n == self.capture_frame:
            self.captured["motion_frame"] = self.edited

    def shapes(self, first: int, frames: int) -> dict:
        """pt's shapes and what the instanced count reads: the distinct
        meshes' triangles and the instances (roofline_inst)."""
        return {**super().shapes(first, frames),
                **roofline_inst.scene_shapes(self.arrays)}

    def release(self) -> None:
        self.scene = self.accel = None
        super().release()

    def checked_arrays(self):
        """The generator's arrays as the checked frame saw them."""
        frame = self.captured.get("motion_frame")
        if frame is None:
            return self.arrays
        return self.motion.arrays_at(self.arrays, frame)

    def reference(self, dtype):
        scene = ref_scene.build(self.checked_arrays(), self.device, dtype)
        return scene, ref_trace.Triangles(scene)
