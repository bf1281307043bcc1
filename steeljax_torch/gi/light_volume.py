"""Light-volume bake orchestration (GlobalIllumination.cpp:174-243).

Port of steeljax/gi/light_volume.py.  Pipeline: probe positions (octree +
geometry oracle) -> Delaunay tets -> per-probe path-traced cubemap (the
ProbeRenderer: 6 faces through the shared bounce loop with RENDER_TO_CUBE
ray setup and HDR output) -> SH-9 projection -> LightVolume, which the
deferred lighting samples (LIGHT_VOLUME_ENABLED paths).

Every probe-face-pixel ray of a sample goes through one call of the port's
trace_paths, so on the card each bounce is one launch of the nearest-hit
kernel (K1 on opaque flat tables) and, in a lit scene, one of the any-hit
kernel (K2) for the shadow rays; the loop over samples reads nothing back
to the host.  The rays split into one contiguous block per device
(parallel.mesh; one block on the scene's device unless `devices` names
more), as under the reference's shard_map.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from steeljax_torch.core import rng
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.core.constants import CUBE_FACES_B, CUBE_FACES_T
from steeljax_torch.env.cubemap import face_directions
from steeljax_torch.gi import probes as probes_lib
from steeljax_torch.gi import sh as sh_lib
from steeljax_torch.gi import tets as tets_lib
from steeljax_torch.parallel.mesh import (device_context, replicate,
                                          split_rows)
from steeljax_torch.render.pt.integrator import trace_paths

PROBE_RESOLUTION = 32  # ProbeRenderer.cpp:8-10 (32x32 RGBA16F faces)
CAPTURE_T_MIN, CAPTURE_T_MAX = 0.001, 1000.0  # the probe rays' interval


@dataclasses.dataclass
class LightVolume:
    positions: torch.Tensor      # (P, 3) float32
    tet_vertices: torch.Tensor   # (T, 4) int32
    tet_neighbors: torch.Tensor  # (T, 4) int32, -1 at hull
    tet_matrices: torch.Tensor   # (T, 3, 3) float32 inverse barycentric
    coefficients: torch.Tensor   # (P, 9, 3) float32 SH-9 RGB

    def to(self, device: torch.device | str) -> "LightVolume":
        """The same volume on `device`."""
        return LightVolume(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})


def empty_light_volume(device: torch.device | str) -> LightVolume:
    """The volume of a scene with fewer than 4 probes (no tets): sampling
    it gives black."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return LightVolume(
        positions=torch.zeros((0, 3), **f32),
        tet_vertices=torch.zeros((0, 4), **i32),
        tet_neighbors=torch.zeros((0, 4), **i32),
        tet_matrices=torch.zeros((0, 3, 3), **f32),
        coefficients=torch.zeros((0, 9, 3), **f32))


def probe_rays(positions: np.ndarray, res: int, device):
    """Per probe-face-pixel ray (origin, base direction, face T and B axes,
    ray id), (P * 6 * R * R, ...) on `device` (light_volume.py:61-76)."""
    p = len(positions)
    n_rays = p * 6 * res * res
    dirs = torch.as_tensor(face_directions(res), device=device)
    base_dirs = dirs.reshape(1, -1, 3).expand(p, -1, -1).reshape(-1, 3)
    origins = torch.as_tensor(np.asarray(positions, np.float32),
                              device=device).repeat_interleave(
        6 * res * res, dim=0)
    ids = torch.arange(n_rays, dtype=torch.int64, device=device)
    face_index = (ids // (res * res)) % 6
    t_axis = torch.as_tensor(np.asarray(CUBE_FACES_T, np.float32),
                             device=device)[face_index]
    b_axis = torch.as_tensor(np.asarray(CUBE_FACES_B, np.float32),
                             device=device)[face_index]
    return origins, base_dirs, t_axis, b_axis, ids


def sample_directions(base_d, t_ax, b_ax, ids, s: int, texel: float):
    """The directions and rng seeds of sample `s` of the probe rays: the
    seed of the global ray id, the sub-texel jitter along the face's T and
    B axes (light_volume.py:78-86)."""
    seed = rng.make_seed(ids & 0xFFFF, ids >> 16, s, 0)
    jitter, seed = rng.next_vec2(seed)
    # Displace directions by up to one texel along the face tangents.
    d = (base_d + (jitter[:, 0:1] - 0.5) * texel * t_ax
         + (jitter[:, 1:2] - 0.5) * texel * b_ax)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True), seed


def _sample_once(flat, tables, o, base_d, t_ax, b_ax, ids, s: int,
                 texel: float, config: RenderConfig) -> torch.Tensor:
    """One sample of every ray through the bounce loop."""
    d, seed = sample_directions(base_d, t_ax, b_ax, ids, s, texel)
    sample, _, _ = trace_paths(flat, tables, o, d, seed, CAPTURE_T_MIN,
                               CAPTURE_T_MAX, config)
    return sample


def capture_probes(flat, tables, positions: np.ndarray,
                   resolution: int = PROBE_RESOLUTION, spp: int = 8,
                   config: RenderConfig | None = None,
                   devices=None) -> torch.Tensor:
    """Path-trace (P, 6, R, R, 3) probe cubemaps, on the scene's device.

    Rays go straight through the cube-face basis (GetCubeDirection) with
    sub-texel jitter; output is linear HDR (RENDER_TO_HDR=1, no tone map,
    no accumulation image — the mean over spp is computed here).

    The probe-face-pixel rays split into one contiguous block per device
    of `devices` (a list of torch devices, or a parallel.mesh.Mesh; by
    default the scene's device alone), padded to a multiple of the device
    count with +Z rays; the scene and tables are copied to each device.  Per-ray seeds depend only on the
    global ray id, so the split capture equals the one-device capture."""
    config = config or RenderConfig()
    probe_config = dataclasses.replace(config, sample_count=1)
    p = len(positions)
    res = resolution
    texel = 2.0 / res
    device = flat.device
    o, base_d, t_ax, b_ax, ids = probe_rays(positions, res, device)
    n_rays = o.shape[0]
    devices = ([device] if devices is None else
               [torch.device(d) for d in getattr(devices, "devices",
                                                 devices)])
    # Pad rays get the +Z direction (a zero direction would NaN the
    # normalize); their results are cut off below.
    pad = -n_rays % len(devices)
    base_d = torch.cat([base_d, base_d.new_tensor(
        [0.0, 0.0, 1.0]).expand(pad, 3)])
    shards = list(zip(*(split_rows(x, len(devices))
                        for x in (o, base_d, t_ax, b_ax, ids))))
    shards = [[x.to(dev) for x in shard]
              for dev, shard in zip(devices, shards)]
    replicas = [(replicate(flat, dev), replicate(tables, dev))
                for dev in devices]
    totals = [torch.zeros((shard[0].shape[0], 3), dtype=torch.float32,
                          device=dev)
              for dev, shard in zip(devices, shards)]
    for s in range(spp):
        for i, (dev, shard, (flat_d, tables_d)) in enumerate(
                zip(devices, shards, replicas)):
            with device_context(dev):
                totals[i] = totals[i] + _sample_once(
                    flat_d, tables_d, *shard, s, texel, probe_config)
    total = torch.cat([t.to(device) for t in totals])[:n_rays]
    return (total / spp).reshape(p, 6, res, res, 3)


def generate_light_volume(flat, tables, spp: int = 8,
                          resolution: int = PROBE_RESOLUTION,
                          min_edge: float = probes_lib.MIN_EDGE,
                          max_probes: int = 1024,
                          config: RenderConfig | None = None,
                          devices=None) -> LightVolume:
    """Full GI bake (probes -> cubes -> SH9 -> tets) on the scene's
    device.  `devices` splits the probe capture (capture_probes)."""
    device = flat.device
    positions = probes_lib.generate_probe_positions(
        flat.tri_pos, min_edge=min_edge, max_probes=max_probes)
    vertices, neighbors, matrices, positions = tets_lib.tetrahedralize(
        positions)
    if len(positions) == 0 or len(vertices) == 0:
        return empty_light_volume(device)
    cubes = capture_probes(flat, tables, positions, resolution, spp,
                           config, devices=devices)
    return LightVolume(
        positions=torch.as_tensor(positions, device=device),
        tet_vertices=torch.as_tensor(vertices, device=device),
        tet_neighbors=torch.as_tensor(neighbors, device=device),
        tet_matrices=torch.as_tensor(matrices, device=device),
        coefficients=sh_lib.project_sh9(cubes))
