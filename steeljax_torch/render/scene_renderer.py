"""SceneRenderer: both renderers over one prepared scene, and the switch.

Port of steeljax/render/scene_renderer.py (SceneRenderer.{hpp,cpp}): it
owns the path tracer and the hybrid renderer over one `prepare_scene` on
the render device, dispatches each frame by mode, and implements the `T`
toggle (SceneRenderer.cpp:375-397): entering path tracing resets the
accumulation.  As in the reference, the environment the hybrid renderer
lights with is `load_environment(panorama_path=scene.environment_path)`
unless one is passed; the scene's constant `environment_color` reaches the
path tracer (through prepare_scene) but not this environment.  A config
with `global_illumination_enabled` bakes the light volume through the
hybrid renderer it builds.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from steeljax_torch import native
from steeljax_torch.accel.instances import InstancedAccel
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.env.environment import Environment, load_environment
from steeljax_torch.render.hybrid.renderer import HybridRenderer
from steeljax_torch.render.pt.renderer import (PathTracingRenderer,
                                               prepare_scene)
from steeljax_torch.scene.scene import Scene


class RenderMode(enum.Enum):
    """EngineHelpers.hpp kRenderModeCount=2."""
    PATH_TRACING = 0
    HYBRID = 1


def render_device(device: torch.device | str) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA card is available "
                           "(ask for the device cpu to render on the CPU)")
    return device


class SceneRenderer:
    """`instancing=True` prepares the two-level structure (a BLAS per
    primitive, kept across edits, and an instance TLAS rebuilt by each
    refresh_scene), the reference's choice for dynamic scenes."""

    def __init__(self, scene: Scene, width: int, height: int,
                 config: RenderConfig = RenderConfig(),
                 environment: Environment | None = None,
                 mode: RenderMode | None = None,
                 instancing: bool = False, *,
                 device: torch.device | str = "cuda"):
        self.device = render_device(device)
        self.scene = scene
        self.width = width
        self.height = height
        self.config = config
        self.mode = mode or (RenderMode.PATH_TRACING
                             if config.path_tracing_enabled
                             else RenderMode.HYBRID)
        self._accel = (InstancedAccel(device=self.device) if instancing
                       else None)
        prepared = prepare_scene(scene, self.device, accel=self._accel)
        env = environment or load_environment(
            panorama_path=scene.environment_path, device=self.device)
        self.path_tracer = PathTracingRenderer(
            scene, width, height, config, prepared=prepared,
            device=self.device)
        self.hybrid = HybridRenderer(
            scene, width, height, config, environment=env,
            prepared=prepared, device=self.device)

    def toggle_render_mode(self) -> RenderMode:
        """The `T` key: flips the mode; entering path tracing resets its
        accumulation."""
        if self.mode is RenderMode.PATH_TRACING:
            self.mode = RenderMode.HYBRID
        else:
            self.mode = RenderMode.PATH_TRACING
            self.path_tracer.reset_accumulation()
        return self.mode

    def reload_pipelines(self) -> None:
        """The `R` key, a per-pipeline shader reload
        (HybridRenderer.cpp:117-129, PathTracingRenderer.cpp:328-349).

        The frame functions are eager torch, which the next tick runs as
        the code now stands; the kernels sit in one library that both modes
        share.  When its CUDA sources changed since it was loaded, it is
        rebuilt and rebound (native.reload_cuda_library), else nothing
        changes.  Path tracing also resets its accumulation, as the
        reference's reload does; the hybrid frame keeps no state."""
        native.reload_cuda_library()
        if self.mode is RenderMode.PATH_TRACING:
            self.path_tracer.reset_accumulation()

    def refresh_scene(self) -> None:
        """New device tables after a scene edit (the reference's
        every-frame TLAS rebuild, SceneRenderer.cpp:318-358, on demand).
        With instancing only the O(instances) instance tables, the light
        rows and the material tables are rewritten
        (InstancedAccel.refresh), in place while the instances keep their
        count."""
        if self._accel is not None:
            prepared = self._accel.refresh(
                self.scene, self.path_tracer.flat, self.path_tracer.tables,
                materials=True)
        else:
            prepared = prepare_scene(self.scene, self.device)
        self.path_tracer.refresh_scene(prepared)
        self.hybrid.refresh_scene(prepared)

    def resize(self, width: int, height: int) -> None:
        """Swapchain recreation (Engine.cpp:135-149, SceneRenderer.cpp:
        360-373): both renderers take the new extent; path tracing restarts
        its accumulation."""
        self.width = width
        self.height = height
        self.path_tracer.resize(width, height)
        self.hybrid.width = width
        self.hybrid.height = height
        self.hybrid.refresh_scene((self.hybrid.flat, self.hybrid.tables))

    def update_camera(self) -> None:
        """The CAMERA_UPDATE handler: new matrices, accumulation reset."""
        self.path_tracer._set_camera_arrays()
        self.path_tracer.reset_accumulation()
        self.hybrid.refresh_scene((self.hybrid.flat, self.hybrid.tables))

    def render_frame(self) -> np.ndarray:
        """One frame of the current mode as (H, W, 3) host numpy."""
        if self.mode is RenderMode.PATH_TRACING:
            return self.path_tracer.render_frame()
        return self.hybrid.render_frame()
