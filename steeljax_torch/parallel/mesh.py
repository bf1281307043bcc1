"""Pixel data-parallelism over a list of torch devices.

Port of steeljax/parallel/mesh.py.  The reference lays the flat pixel batch
across a 1-D `jax.sharding.Mesh` and runs the frame under shard_map with
the scene replicated and zero per-frame collectives.  Here a Mesh is the
list of devices: the scene, tables, environment and light volume are
copied to each device, each device renders its contiguous block of the
padded pixel batch through render_pixels (or render_hybrid_pixels), so the
big-scene ray repack stays per shard as under shard_map, and the blocks
are gathered on the host with the pad cut off.  Work is queued on every
device before the first block is read back, so distinct cards run at once.

Per-ray seeds depend only on the pixel (or, in a probe capture, the global
ray id), and each ray's path is independent of how rays are grouped, so a
sharded frame equals the one-device frame.

`make_mesh(host_shape=)`, the reference's 2-D (hosts, tiles) mesh whose
outer axis is the DCN between TPU hosts, has no meaning for CUDA devices
of one process and raises.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from steeljax_torch.core import profiling
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.render.pt.integrator import _matrix, render_pixels


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple  # tuple[torch.device, ...], one shard each

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, host_shape: int | None = None) -> Mesh:
    """A mesh over `devices` (torch devices or their names), by default
    every visible CUDA card.  Without a card it raises: a CPU mesh is asked
    for by naming `cpu` devices."""
    if host_shape is not None:
        raise ValueError("host_shape (the reference's multi-host DCN axis) "
                         "has no meaning for the CUDA devices of one "
                         "process; pass the devices of a 1-D mesh")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA card is available (name "
                               "cpu devices to shard over the CPU)")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(devices)


def replicate(obj, device: torch.device | str):
    """`obj` (a tensor, or a dataclass or tuple holding tensors, as
    FlatScene, TraceTables, Environment and LightVolume do) with every
    tensor on `device`; `obj` itself when nothing moves."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {}
        for f in dataclasses.fields(obj):
            value = getattr(obj, f.name)
            moved = replicate(value, device)
            if moved is not value:
                changes[f.name] = moved
        return dataclasses.replace(obj, **changes) if changes else obj
    if type(obj) is tuple:
        items = tuple(replicate(x, device) for x in obj)
        return obj if all(a is b for a, b in zip(items, obj)) else items
    return obj


def split_rows(x: torch.Tensor, count: int) -> list:
    """`x` padded with zero rows to a multiple of `count` and cut into
    `count` contiguous blocks (views)."""
    pad = -x.shape[0] % count
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return list(torch.chunk(x, count))


def device_context(device: torch.device):
    """The device's context (the current CUDA device for kernel launches
    and for tensors made on `cuda` without an index)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_pixels(mesh: Mesh, width: int, height: int):
    """Flat row-major pixel coordinates, padded with pixel (0, 0) to a
    multiple of the device count and cut into one contiguous block per
    device: (px blocks, py blocks, pad), each block an int32 tensor on its
    device."""
    count = width * height
    ys, xs = np.meshgrid(np.arange(height, dtype=np.int32),
                         np.arange(width, dtype=np.int32), indexing="ij")
    px = split_rows(torch.from_numpy(xs.reshape(-1)), mesh.size)
    py = split_rows(torch.from_numpy(ys.reshape(-1)), mesh.size)
    pad = mesh.size * px[0].shape[0] - count
    return ([x.to(d) for x, d in zip(px, mesh.devices)],
            [y.to(d) for y, d in zip(py, mesh.devices)], pad)


def _gather(blocks: list, pad: int, width: int, height: int) -> np.ndarray:
    with profiling.named_scope("parallel.gather", wait=True):
        flat = torch.cat([b.cpu() for b in blocks]).numpy()
    if pad:
        flat = flat[:-pad]
    return flat.reshape(height, width, 3)


def render_frame_sharded(scene, tables, inverse_view, inverse_proj,
                         camera_near, camera_far, width: int, height: int,
                         mesh: Mesh, accumulation_index=0, sample_index=0,
                         config: RenderConfig = RenderConfig()) -> np.ndarray:
    """One path-traced frame split over the mesh; returns the (H, W, 3)
    host image (linear, as render_pixels)."""
    px, py, pad = shard_pixels(mesh, width, height)
    blocks = []
    for device, x, y in zip(mesh.devices, px, py):
        with device_context(device):
            blocks.append(render_pixels(
                replicate(scene, device), replicate(tables, device),
                _matrix(inverse_view, device), _matrix(inverse_proj, device),
                camera_near, camera_far, width, height, x, y,
                accumulation_index, sample_index, config))
    return _gather(blocks, pad, width, height)


def render_hybrid_frame_sharded(scene, tables, env, inverse_view,
                                inverse_proj, view_proj, camera_near,
                                camera_far, width: int, height: int,
                                mesh: Mesh, light_volume=None,
                                ray_tracing_enabled: bool = True
                                ) -> np.ndarray:
    """One hybrid frame (G-buffer -> deferred -> forward) split over the
    mesh; returns the (H, W, 3) host image.  Every stage is per pixel, so
    the split needs no exchange between devices."""
    from steeljax_torch.render.hybrid.renderer import render_hybrid_pixels

    px, py, pad = shard_pixels(mesh, width, height)
    blocks = []
    for device, x, y in zip(mesh.devices, px, py):
        with device_context(device):
            blocks.append(render_hybrid_pixels(
                replicate(scene, device), replicate(tables, device),
                replicate(env, device), _matrix(inverse_view, device),
                _matrix(inverse_proj, device), _matrix(view_proj, device),
                camera_near, camera_far, width, height, x, y,
                light_volume=replicate(light_volume, device),
                ray_tracing_enabled=ray_tracing_enabled))
    return _gather(blocks, pad, width, height)
