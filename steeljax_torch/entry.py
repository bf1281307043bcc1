"""Entry points of the port (the counterparts of the repo's
`__graft_entry__.py`).

`entry(device)` returns a forward step (one path-traced sample batch on the
built-in Cornell scene, a 32x18 tile at 1 spp) plus its example args, on
the card unless the caller asks for the CPU.  `dryrun_multichip(n,
devices)` renders over an n-shard pixel split (parallel.mesh) the
path-traced frame, the hybrid frame and a probe capture, and holds each to
the same work on one device within 1e-5.  Without `devices` it takes the
first n CUDA cards and raises when there are fewer.
"""

from __future__ import annotations

import numpy as np
import torch

from steeljax_torch.render.scene_renderer import render_device

ATOL = 1e-5


def _tiny_setup(device, sphere_detail: int = 6, env_res: int = 16):
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.render.pt.renderer import prepare_scene
    from steeljax_torch.scene.builtin import make_cornell_scene

    scene = make_cornell_scene(sphere_detail=sphere_detail)
    flat, tables = prepare_scene(scene, device, env_resolution=env_res)
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    return flat, tables, frame


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args): one 1-spp path-traced frame tile of the Cornell
    scene; fn(*example_args) is its (576, 3) linear irradiance."""
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.render.pt.integrator import render_pixels

    device = render_device(device)
    flat, tables, frame = _tiny_setup(device)
    width, height = 32, 18
    ys, xs = np.meshgrid(np.arange(height, dtype=np.int32),
                         np.arange(width, dtype=np.int32), indexing="ij")
    config = RenderConfig(width=width, height=height)

    def fn(scene, tables, inverse_view, inverse_proj, px, py):
        return render_pixels(scene, tables, inverse_view, inverse_proj,
                             0.01, 100.0, width, height, px, py,
                             0, 0, config)

    def dev(x):
        return torch.as_tensor(x, device=device)

    example_args = (flat, tables, dev(frame.inverse_view),
                    dev(frame.inverse_proj), dev(xs.reshape(-1)),
                    dev(ys.reshape(-1)))
    return fn, example_args


def _check(label: str, sharded: np.ndarray, single: np.ndarray) -> None:
    if sharded.shape != single.shape or not np.isfinite(sharded).all():
        raise AssertionError(f"sharded {label}: shape {sharded.shape} "
                             f"(one device {single.shape}) or not finite")
    delta = float(np.abs(sharded - single).max())
    if not delta <= ATOL:
        raise AssertionError(f"sharded {label} diverges from the "
                             f"one-device run: max |delta| = {delta}")


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Render over an n-device pixel split and hold each result to one
    device (the first): the path-traced frame, the hybrid frame (a tiny
    IBL bake) and a two-probe capture, each within 1e-5.  Returns the
    largest |delta| of each."""
    from steeljax_torch.env.environment import load_environment
    from steeljax_torch.env.sky import procedural_sky_cube
    from steeljax_torch.gi.light_volume import capture_probes
    from steeljax_torch.parallel import (make_mesh, render_frame_sharded,
                                         render_hybrid_frame_sharded)
    from steeljax_torch.render.hybrid.renderer import render_hybrid_pixels
    from steeljax_torch.render.pt.integrator import render_sample

    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n_devices:
            raise RuntimeError(f"dryrun_multichip: need {n_devices} CUDA "
                               f"cards, have {count}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = list(devices)[:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devices)}")
    mesh = make_mesh(devices)
    device = mesh.devices[0]

    flat, tables, frame = _tiny_setup(device)
    width, height = 16, n_devices  # one pixel row per device
    deltas = {}
    image = render_frame_sharded(
        flat, tables, frame.inverse_view, frame.inverse_proj,
        frame.camera_near, frame.camera_far, width, height, mesh)
    single = render_sample(
        flat, tables, frame.inverse_view, frame.inverse_proj,
        frame.camera_near, frame.camera_far, width, height, 0,
        0).cpu().numpy()
    _check("path-traced frame", image, single)
    deltas["pt"] = float(np.abs(image - single).max())

    # The second render mode (G-buffer -> deferred -> forward) over the
    # same mesh, with a tiny IBL bake.
    env = load_environment(
        cube=procedural_sky_cube(16), irradiance_resolution=4,
        reflection_resolution=8, lut_resolution=16, lut_samples=32,
        reflection_samples=16, irradiance_delta=0.4, device=device)
    hybrid = render_hybrid_frame_sharded(
        flat, tables, env, frame.inverse_view, frame.inverse_proj,
        frame.view_proj, frame.camera_near, frame.camera_far, width, height,
        mesh)
    ys, xs = np.meshgrid(np.arange(height, dtype=np.int32),
                         np.arange(width, dtype=np.int32), indexing="ij")

    def dev(x):
        return torch.as_tensor(x, device=device)

    single_h = render_hybrid_pixels(
        flat, tables, env, dev(frame.inverse_view), dev(frame.inverse_proj),
        dev(frame.view_proj), frame.camera_near, frame.camera_far, width,
        height, dev(xs.reshape(-1)), dev(ys.reshape(-1))).cpu().numpy()
    single_h = single_h.reshape(height, width, 3)
    _check("hybrid frame", hybrid, single_h)
    deltas["hybrid"] = float(np.abs(hybrid - single_h).max())

    # The GI probe capture over the same devices (probes are embarrassingly
    # parallel, GlobalIllumination.cpp:210-234; global-ray-id seeds).
    probe_pos = np.array([[0.0, 1.0, 0.0], [0.4, 1.4, 0.4]], np.float32)
    cubes_single = capture_probes(flat, tables, probe_pos, resolution=4,
                                  spp=1).cpu().numpy()
    cubes_sharded = capture_probes(flat, tables, probe_pos, resolution=4,
                                   spp=1, devices=mesh).cpu().numpy()
    if cubes_sharded.shape != (2, 6, 4, 4, 3):
        raise AssertionError(f"sharded capture shape {cubes_sharded.shape}")
    _check("probe capture", cubes_sharded, cubes_single)
    deltas["capture"] = float(np.abs(cubes_sharded - cubes_single).max())
    return deltas
