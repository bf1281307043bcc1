"""HybridRenderer: G-buffer -> deferred lighting -> forward composite.

Port of steeljax/render/hybrid/renderer.py (HybridRenderer.cpp:79-91,
GBufferStage -> LightingStage -> ForwardStage).  There is no
accumulation: a hybrid frame is deterministic (the engine's real-time
mode).  A frame is the span `hybrid.render_frame_device` (core.profiling)
and each stage a span named as the reference's scopes: `gbuffer_stage`,
`lighting_stage` (its pieces `lighting_stage.direct`, with the shadow
rays, and `lighting_stage.indirect`), `forward_stage` (`.background`,
`.peel` a blend layer, `.composite`).
A config with `global_illumination_enabled` bakes the light volume
(gi.generate_light_volume) when the renderer is built, and the deferred
lighting samples it.  With STEELJAX_RASTER=1 (the reference's opt-in)
the G-buffer's primary visibility is rasterized (render/hybrid/raster.py,
the tile kernel csrc/raster.cu on the card) on frames that tile into
32x24-pixel subtiles, with a perspective camera, reverse depth and flat
tables; every other frame keeps the traced G-buffer.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from steeljax_torch.core import camera as camera_lib
from steeljax_torch.core import profiling
from steeljax_torch.core.colors import tone_map
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.env.environment import Environment, load_environment
from steeljax_torch.render.hybrid.forward import forward_stage
from steeljax_torch.render.hybrid.gbuffer import generate_gbuffer
from steeljax_torch.render.hybrid.raster import prepare_raster, supported
from steeljax_torch.gi.light_volume import generate_light_volume
from steeljax_torch.render.hybrid.lighting import (deferred_lighting,
                                                   restore_position)
from steeljax_torch.render.pt.integrator import detile, tiled_order
from steeljax_torch.render.pt.renderer import prepare_scene
from steeljax_torch.scene.scene import Scene

# G-buffer channels a debug view shows before lighting (Common/Debug.glsl).
GBUFFER_VIEWS = ("normals", "albedo", "roughness", "metallic", "occlusion",
                 "emission", "depth")


def _gbuffer_view(gbuffer: dict, debug_view: str) -> torch.Tensor:
    bco = gbuffer["base_color_occlusion"]
    rm = gbuffer["rough_metal"]
    channel = {
        "normals": lambda: gbuffer["normal"],
        "albedo": lambda: bco[..., :3],
        "roughness": lambda: rm[..., 0:1].expand(-1, 3),
        "metallic": lambda: rm[..., 1:2].expand(-1, 3),
        "occlusion": lambda: bco[..., 3:4].expand(-1, 3),
        "emission": lambda: tone_map(gbuffer["emission"]),
        "depth": lambda: (gbuffer["depth"][..., None] * 50.0).expand(-1, 3),
    }[debug_view]()
    return torch.clamp(channel, 0.0, 1.0)


def pixel_center_rays(inverse_view, inverse_proj, width: int, height: int,
                      px, py):
    """The hybrid's primary rays: one through each pixel centre (the
    rasterizer's fragment positions), no jitter.  Returns (origin (N, 3),
    unit direction (N, 3), screen uv (N, 2))."""
    u = (px.to(torch.float32) + 0.5) / width
    v = (py.to(torch.float32) + 0.5) / height
    uv = torch.stack([u, v], dim=-1)
    xy = uv * 2.0 - 1.0
    target = torch.cat([xy, torch.ones_like(xy)], dim=-1) @ inverse_proj.T
    direction = target[..., :3] / torch.linalg.vector_norm(
        target[..., :3], dim=-1, keepdim=True)
    direction = (torch.cat([direction, torch.zeros_like(direction[..., :1])],
                           dim=-1) @ inverse_view.T)[..., :3]
    direction = direction / torch.linalg.vector_norm(direction, dim=-1,
                                                     keepdim=True)
    return inverse_view[:3, 3].expand(direction.shape), direction, uv


def render_hybrid_pixels(scene, tables, env: Environment,
                         inverse_view, inverse_proj, view_proj,
                         camera_near, camera_far, width: int, height: int,
                         px, py, light_volume=None,
                         ray_tracing_enabled: bool = True,
                         force_forward: bool = False,
                         max_blend_layers: int = 4,
                         debug_view: str | None = None,
                         override_material: tuple | None = None,
                         raster_scene=None, tile=None) -> torch.Tensor:
    """One hybrid frame for the pixels (px, py) (int tensors on the scene's
    device); the matrices are (4, 4) float32 tensors there.  Returns (N, 3)
    display colour in [0, 1] (tone-mapped).  `light_volume` (a
    gi.LightVolume on the scene's device) replaces the environment's
    diffuse irradiance.  The G-buffer is rasterized only when the caller
    passes `raster_scene` (raster.prepare_raster) and `tile`, which says
    that (px, py) is the whole frame in tiled_order of that tile; sharded
    and partial pixel batches keep the traced path."""
    origin, direction, uv = pixel_center_rays(inverse_view, inverse_proj,
                                              width, height, px, py)
    camera_position = inverse_view[:3, 3]

    n = direction.shape[0]
    if force_forward:
        # kForceForward (Config.hpp:41): the G-buffer predicate excludes
        # every material, so the G-buffer and lighting stages drop out and
        # the forward stage draws everything.
        gbuffer = {"hit": torch.zeros((n,), dtype=torch.bool,
                                      device=direction.device)}
        lit = torch.zeros_like(direction)
        opaque_t = torch.full((n,), 1000.0, device=direction.device)
    else:
        # Vertical pixel spread 2 tan(fovy / 2) / H: inverse_proj[1][1] is
        # tan(fovy / 2) (with the Vulkan flip).
        pixel_spread = 2.0 * inverse_proj[1, 1].abs() / height
        raster = None
        if raster_scene is not None and tile is not None:
            raster = (raster_scene, width, height, tile)
        with profiling.named_scope("gbuffer_stage"):
            gbuffer = generate_gbuffer(scene, tables, origin, direction,
                                       camera_near, camera_far, view_proj,
                                       camera_position,
                                       pixel_spread=pixel_spread,
                                       raster=raster)
        if debug_view in GBUFFER_VIEWS:
            return _gbuffer_view(gbuffer, debug_view)

        inverse_proj_view = inverse_view @ inverse_proj
        with profiling.named_scope("lighting_stage"):
            lit = deferred_lighting(scene, tables, env, gbuffer, uv,
                                    inverse_proj_view, camera_position,
                                    light_volume=light_volume,
                                    ray_tracing_enabled=ray_tracing_enabled,
                                    debug_view=debug_view,
                                    override_material=override_material)
        if debug_view in ("direct", "indirect"):
            return tone_map(lit)
        # The opaque distance for the blend layers' depth test, from the
        # stored depth as the raster pipeline would z-test.
        position = restore_position(gbuffer["depth"], uv, inverse_proj_view)
        opaque_t = torch.linalg.vector_norm(position - origin, dim=-1)

    with profiling.named_scope("forward_stage"):
        return forward_stage(scene, tables, env, lit, gbuffer, origin,
                             direction, opaque_t, camera_near,
                             camera_position, ray_tracing_enabled,
                             max_blend_layers=max_blend_layers,
                             all_materials=force_forward,
                             override_material=override_material)


class HybridRenderer:
    """The stage composition, run from the host on `device`.

    Without `environment` the renderer bakes the scene's own at the full
    budgets of load_environment (its constant colour as a 64-texel cube,
    else its panorama, else the procedural sky).  With
    `config.global_illumination_enabled` it then bakes the light volume at
    the reference's defaults (bake_light_volume)."""

    def __init__(self, scene: Scene, width: int, height: int,
                 config: RenderConfig = RenderConfig(),
                 environment: Environment | None = None, prepared=None, *,
                 device: torch.device | str):
        self.scene = scene
        self.width = width
        self.height = height
        self.config = config
        self.device = torch.device(device)
        self.flat, self.tables = prepared or prepare_scene(scene,
                                                           self.device)
        if environment is None:
            env_cube = None
            if scene.environment_color is not None:
                env_cube = np.broadcast_to(
                    np.asarray(scene.environment_color, np.float32),
                    (6, 64, 64, 3)).copy()
            environment = load_environment(
                panorama_path=scene.environment_path, cube=env_cube,
                device=self.device)
        self.env = environment
        self.light_volume = None
        self._set_camera_arrays()
        self.raster_scene = self._prepare_raster()
        if config.global_illumination_enabled:
            self.bake_light_volume()

    def _set_camera_arrays(self) -> None:
        frame = camera_lib.make_frame(
            self.scene.camera_location, self.scene.camera_projection,
            reverse_depth=self.config.reverse_depth)
        self.frame = frame
        self.matrices = tuple(
            torch.as_tensor(m, device=self.device)
            for m in (frame.inverse_view, frame.inverse_proj,
                      frame.view_proj))
        tiled = tiled_order(self.width, self.height)
        if tiled is not None:
            px, py, self.tile = tiled
        else:
            ys, xs = np.meshgrid(np.arange(self.height, dtype=np.int32),
                                 np.arange(self.width, dtype=np.int32),
                                 indexing="ij")
            px, py, self.tile = xs.reshape(-1), ys.reshape(-1), None
        self.pixels = (torch.as_tensor(px, device=self.device),
                       torch.as_tensor(py, device=self.device))

    def _prepare_raster(self):
        """The raster inputs of the rasterized G-buffer, or None (the
        default) where the traced G-buffer stays: opt-in with
        STEELJAX_RASTER=1, and only for frames that tile into subtiles, a
        perspective camera (an orthographic w_clip carries no eye depth),
        reverse depth (the raster's z test assumes reverse-z NDC) and flat
        tables (raster.prepare_raster)."""
        if os.environ.get("STEELJAX_RASTER", "0") != "1":
            return None
        if not supported(self.width, self.height):
            return None
        if self.scene.camera_projection.y_fov == 0.0:
            return None
        if not self.config.reverse_depth:
            return None
        return prepare_raster(self.flat, self.tables)

    def refresh_scene(self, prepared=None) -> None:
        """New device tables after a scene edit, the camera's matrices and
        the raster inputs anew; the light volume stays as baked, as in the
        reference."""
        self.flat, self.tables = prepared or prepare_scene(self.scene,
                                                           self.device)
        self._set_camera_arrays()
        self.raster_scene = self._prepare_raster()

    def bake_light_volume(self, spp: int = 8, **kwargs) -> None:
        """Run the light-volume GI bake (GlobalIllumination::
        GenerateLightVolume) on the render device and light the frames with
        it (LIGHT_VOLUME_ENABLED sampling); `kwargs` go to
        gi.generate_light_volume."""
        self.light_volume = generate_light_volume(
            self.flat, self.tables, spp=spp, **kwargs)

    def render_frame_device(self) -> torch.Tensor:
        """One hybrid frame left on the device as (H*W, 3), row-major: the
        engine's frame ends at the swapchain image, not a host copy."""
        config = self.config
        with profiling.frame("hybrid.render_frame_device"):
            out = render_hybrid_pixels(
                self.flat, self.tables, self.env, *self.matrices,
                self.frame.camera_near, self.frame.camera_far, self.width,
                self.height, *self.pixels, light_volume=self.light_volume,
                ray_tracing_enabled=config.ray_tracing_enabled,
                force_forward=config.force_forward,
                max_blend_layers=config.max_blend_layers,
                debug_view=config.debug_view,
                override_material=config.override_material,
                raster_scene=self.raster_scene,
                tile=self.tile if self.raster_scene is not None else None)
            if self.tile is not None:
                out = detile(out, self.width, self.height,
                             self.tile).reshape(-1, 3)
        return out

    def render_frame(self) -> np.ndarray:
        """One frame as (H, W, 3) float in [0, 1], numpy."""
        out = self.render_frame_device()
        with profiling.named_scope("hybrid.download", wait=True):
            out = out.cpu()
        return out.numpy().reshape(self.height, self.width, 3)
