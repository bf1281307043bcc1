"""PathTracingRenderer: scene preparation, accumulation state and the frame
step around the integrator.

Port of steeljax/render/pt/renderer.py:34-264 (PathTracingRenderer.cpp):
owns the accumulation image as a tensor on the render device, resets it on
camera, scene and resize events, and applies the filmic tone map for
display output (RayGen.rgen:420-424).  Every entry point takes the render
device explicitly.  `PathTracingRenderer(instancing=True)` renders through
the two-level structure (accel.instances), whose `refresh_scene` after a
scene edit rewrites only the instance tables (InstancedAccel.refresh).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np
import torch

from steeljax_torch.accel.alphamask import (compute_alpha_masks,
                                             compute_fine_masks)
from steeljax_torch.accel.bvh import SNODE_WIDTH, apply_permutation
from steeljax_torch.accel.cuda_traverse import MULTIHIT_K
from steeljax_torch.accel.dispatch import (TraceTables, attach_shade_tables,
                                           prepare_tables)
from steeljax_torch.accel.instances import InstancedAccel, InstancedTables
from steeljax_torch.accel.treelets import TREELET_TRIS
from steeljax_torch.core import camera as camera_lib
from steeljax_torch.core import profiling
from steeljax_torch.core import validate as validate_lib
from steeljax_torch.core.colors import tone_map
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.env.panorama import panorama_to_cube
from steeljax_torch.io.image import load_hdr
from steeljax_torch.render.pt.integrator import render_sample
from steeljax_torch.scene.flatten import FlatScene, TriShade, flatten_scene
from steeljax_torch.scene.scene import Scene


@dataclasses.dataclass
class AccumulationState:
    accumulated: torch.Tensor  # (H, W, 3) float32 running mean
    index: int                 # samples accumulated so far


def init_accumulation(width: int, height: int,
                      device: torch.device | str) -> AccumulationState:
    return AccumulationState(
        accumulated=torch.zeros((height, width, 3), dtype=torch.float32,
                                device=device),
        index=0)


def accumulate(state: AccumulationState,
               result: torch.Tensor) -> AccumulationState:
    """Running mean (AccumulateResult, RayGen.rgen:307-320)."""
    idx = float(state.index)
    merged = (result + idx * state.accumulated) / (idx + 1.0)
    return AccumulationState(accumulated=merged, index=state.index + 1)


def _alpha_masks(flat: FlatScene, scene: Scene, fine_masks: bool):
    """The coarse masks, and the fine masks when asked, of an alpha-tested
    scene's unpermuted triangles (alphamask.compute_alpha_masks,
    compute_fine_masks), computed on the scene's device."""
    args = tuple(getattr(flat, name).cpu().numpy() for name in (
        "tri_uv", "tri_mat", "mat_base_color", "mat_params", "mat_tex",
        "mat_flags")) + (scene.textures,)
    with profiling.named_scope("prepare_scene.alpha_masks", sync=flat.device):
        coarse = compute_alpha_masks(*args, device=flat.device)
    fine = None
    if fine_masks:
        with profiling.named_scope("prepare_scene.fine_masks",
                                   sync=flat.device):
            fine = compute_fine_masks(*args, device=flat.device)
    return coarse, fine


def prepare_scene(scene: Scene, device: torch.device | str,
                  env_resolution: int = 256,
                  use_default_environment: bool = True,
                  leaf_size: int | None = None, dense_anyhit: bool = False,
                  fine_masks: bool = True, multihit_k: int = 0,
                  accel: InstancedAccel | None = None, treelets: bool = False,
                  treelet_tris: int = TREELET_TRIS,
                  snode_width: int = SNODE_WIDTH, validate: bool = False
                  ) -> tuple[FlatScene, TraceTables | InstancedTables]:
    """Flatten, build the acceleration tables and the environment, on
    `device`.

    An accel.instances.InstancedAccel as `accel` selects the two-level
    structure: per-primitive BLAS (cached inside `accel`) and an instance
    TLAS, so a later `accel.prepare(scene)` re-prepares in O(instances); the
    flat scene then keeps the flatten order and serves only its material,
    texture, light and environment tensors.  `treelets` builds the
    streamed-treelet tables (dispatch.prepare_tables(treelets=True), the
    reference's STEELJAX_TREELETS=1), cut at `treelet_tris` triangles: with
    coarse masks in alpha-tested scenes, without fine mask rows, dense
    any-hit tables or the multi-hit path.

    The environment is, in this order, the scene's `environment_cube`, its
    constant colour, the Radiance panorama at its `environment_path`, else
    the procedural sky when `use_default_environment`, else none; a
    panorama is converted on `device`.  Leaf size follows the reference:
    STEELJAX_LEAF_SIZE when it is set and `leaf_size` is None, else 48 at
    up to 50k triangles, else 24.  The trees follow the reference's
    STEELJAX_SBVH (bvh.build_bvh's "auto" method; spatial splits off by
    default), for the flat, treelet and instanced tables alike.
    `dense_anyhit` builds the dense any-hit tables, which shadow rays then
    read (the reference's STEELJAX_DENSE_ANYHIT=1, off by default; the
    reference's prepare_scene reaches them through that variable, the port's
    through this argument).

    A scene with alpha-tested materials gets coarse alpha masks in its
    triangle records and, with `fine_masks` (the reference's
    STEELJAX_FINEMASK, on by default), the fine mask rows, which the
    reference builds only for its TPU kernels; `fine_masks=False` gives the
    reference's CPU tables.  It gets no fused shading tables: its shading
    reads tri_shade rows.  `multihit_k` (0, 2, 4 or 8; the reference's
    STEELJAX_MULTIHIT_K, 0 by default) traces its material and shadow rays
    with the K-nearest kernel K5 instead of the single-hit re-trace (on a
    scene of one chunk: one above dispatch.MAX_CHUNK_TRIS triangles is cut
    into chunks and re-traces hit by hit, as the reference's does).
    `snode_width` (8 or 16) is the flat tables' supernode width, the
    reference's STEELJAX_BVH_WIDTH (8 by default there and here); treelet
    and instanced tables stay at 8.  `validate` runs the structural checks
    of core.validate on the prepared scene and tables, the reference's
    STEELJAX_VALIDATE=1 (off by default there and here).  Each step is a
    `prepare_scene.<step>` or `prepare_tables.<step>` span (core.profiling),
    those that launch device work ending in a synchronize."""
    if multihit_k and multihit_k not in MULTIHIT_K:
        raise ValueError(f"multihit_k must be 0 or one of {MULTIHIT_K}, "
                         f"got {multihit_k}")
    env_cube = None
    env_analytic = False
    if scene.environment_cube is not None:
        # A cube handed in directly (e.g. docs/golden/surrogate_env.npz).
        env_cube = np.asarray(scene.environment_cube, np.float32)
    elif scene.environment_color is not None:
        env_cube = np.broadcast_to(
            np.asarray(scene.environment_color, np.float32),
            (6, env_resolution, env_resolution, 3)).copy()
    elif scene.environment_path and Path(scene.environment_path).exists():
        with profiling.named_scope("prepare_scene.environment", sync=device):
            panorama = load_hdr(scene.environment_path)
            # On the render device, as the reference converts on its
            # accelerator; flatten_scene packs the cube on the host.
            env_cube = panorama_to_cube(panorama, env_resolution,
                                        device=device).cpu().numpy()
    elif use_default_environment:
        from steeljax_torch.env.sky import procedural_sky_cube
        with profiling.named_scope("prepare_scene.environment"):
            env_cube = procedural_sky_cube(env_resolution)
        env_analytic = True
    with profiling.named_scope("prepare_scene.flatten_scene", sync=device):
        flat = flatten_scene(scene, device, env_cube,
                             env_analytic=env_analytic)
    if accel is not None:
        with profiling.named_scope("prepare_scene.instanced_accel",
                                   sync=device):
            tables = accel.prepare(scene)
        if tables.inst_trace.device != flat.device:
            raise ValueError(f"accel is on {tables.inst_trace.device}, the "
                             f"scene on {flat.device}")
        return flat, tables

    tri_pos = flat.tri_pos.cpu().numpy()
    coarse = fine = None
    if flat.any_alpha_test:
        coarse, fine = _alpha_masks(flat, scene,
                                    fine_masks and not treelets)
    if leaf_size is None:
        env_leaf = os.environ.get("STEELJAX_LEAF_SIZE")
        leaf_size = (int(env_leaf) if env_leaf is not None
                     else 48 if len(tri_pos) <= 50_000 else 24)
    tables, order, total_padded = prepare_tables(
        tri_pos, flat.tri_double_sided.cpu().numpy(), device,
        leaf_size=leaf_size, dense_anyhit=dense_anyhit,
        tri_alpha_mask=coarse, tri_fine_mask=fine, treelets=treelets,
        treelet_tris=treelet_tris, snode_width=snode_width)
    tables = tables.replace(multihit_k=multihit_k)
    with profiling.named_scope("prepare_scene.apply_permutation"):
        permuted = apply_permutation((None, order, total_padded), {
            name: getattr(flat, name).cpu().numpy()
            for name in ("tri_pos", "tri_nrm", "tri_tan", "tri_uv",
                         "tri_mat", "tri_double_sided", "tri_shade")})
    if not flat.any_alpha_test:
        with profiling.named_scope("prepare_scene.attach_shade_tables",
                                   sync=device):
            tables = attach_shade_tables(
                tables, permuted["tri_nrm"], permuted["tri_mat"],
                textured=flat.has_textures, tri_tan=permuted["tri_tan"],
                tri_uv=permuted["tri_uv"],
                tri_uvd=permuted["tri_shade"][:, TriShade.UV_DENSITY])
    with profiling.named_scope("prepare_scene.upload_permuted", sync=device):
        flat = flat.replace(**{name: torch.from_numpy(arr).to(device)
                               for name, arr in permuted.items()})
    if validate:
        with profiling.named_scope("prepare_scene.validate"):
            validate_lib.validate_flat_scene(flat)
            validate_lib.validate_tables(tables, int(flat.tri_pos.shape[0]))
    return flat, tables


class PathTracingRenderer:
    """Host-side renderer: owns the prepared scene and accumulation state on
    `device`."""

    def __init__(self, scene: Scene, width: int, height: int,
                 config: RenderConfig = RenderConfig(), prepared=None,
                 instancing: bool = False, *,
                 device: torch.device | str):
        self.scene = scene
        self.width = width
        self.height = height
        self.config = config
        self.device = torch.device(device)
        self._accel = None
        if instancing and prepared is None:
            self._accel = InstancedAccel(device=self.device)
        self.flat, self.tables = prepared or prepare_scene(
            scene, self.device, accel=self._accel)
        self.state = init_accumulation(width, height, self.device)
        self._set_camera_arrays()

    def refresh_scene(self, prepared=None) -> None:
        """Refresh the device tables after a scene mutation and reset the
        accumulation.  With instancing only the O(instances) instance
        tables, the TLAS and the light rows are rewritten
        (InstancedAccel.refresh): the BLAS and triangle tensors stay on the
        device, and while the instances keep their count the tables and the
        flat scene stay the same objects, so the frames replay."""
        if prepared is not None:
            self.flat, self.tables = prepared
        elif self._accel is not None:
            self.flat, self.tables = self._accel.refresh(
                self.scene, self.flat, self.tables)
        else:
            self.flat, self.tables = prepare_scene(self.scene, self.device)
        self.reset_accumulation()

    def _set_camera_arrays(self) -> None:
        frame = camera_lib.make_frame(
            self.scene.camera_location, self.scene.camera_projection,
            reverse_depth=self.config.reverse_depth)
        self.inverse_view = torch.as_tensor(frame.inverse_view,
                                            device=self.device)
        self.inverse_proj = torch.as_tensor(frame.inverse_proj,
                                            device=self.device)
        self.camera_near = frame.camera_near
        self.camera_far = frame.camera_far

    def reset_accumulation(self) -> None:
        """The camera-update, resize and scene-register reset
        (PathTracingRenderer.cpp:346-349)."""
        self.state = init_accumulation(self.width, self.height, self.device)

    def resize(self, width: int, height: int) -> None:
        """New render and accumulation extent; accumulation restarts
        (PathTracingRenderer.cpp:293-311)."""
        self.width = width
        self.height = height
        self.reset_accumulation()

    def set_camera(self, location=None, projection=None) -> None:
        if location is not None:
            self.scene.camera_location = location
        if projection is not None:
            self.scene.camera_projection = projection
        self._set_camera_arrays()
        self.reset_accumulation()

    def render_frame(self) -> np.ndarray:
        """One frame of config.sample_count samples folded into the
        accumulator; returns the tone-mapped display image (H, W, 3) float
        in [0, 1] as numpy."""
        result = render_sample(
            self.flat, self.tables, self.inverse_view, self.inverse_proj,
            self.camera_near, self.camera_far, self.width, self.height,
            accumulation_index=self.state.index, sample_index=0,
            config=self.config)
        if self.config.accumulation:
            self.state = accumulate(self.state, result)
            shown = self.state.accumulated
        else:
            shown = result
        if not self.config.render_to_hdr:
            shown = tone_map(shown)
        with profiling.named_scope("renderer.download", wait=True):
            shown = shown.cpu()
        return shown.numpy()

    def render(self, spp: int) -> np.ndarray:
        """Accumulate `spp` frames and return the final display image."""
        image = None
        for _ in range(spp):
            image = self.render_frame()
        return image
