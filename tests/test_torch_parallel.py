"""The port's pixel split across devices (parallel.mesh) and its entry
points (entry.py) on the CPU.

A mesh of 4 CPU devices (the same device four times: each shard is its own
render_pixels call on its own block of pixels) renders the path-traced
frame and the hybrid frame, without and with a light volume, and splits a
probe capture.  Each is held within 1e-5 of the port's one-device run and
within 1e-4 (0 pixels beyond) of the reference's sharded run on its
8-device CPU mesh (tests/conftest.py); the split capture is held to the
reference's one-device capture (its mesh capture takes minutes to trace on
the CPU, and tests/test_multidevice.py holds it to that).  The port's
tables are brought to shade mode 0, the reference's CPU path
(tests/test_torch_hybrid.py says why); the volume is the reference's tiny
Cornell bake carried across.
dryrun_multichip(4, devices=[cpu] * 4) passes, and entry() on the CPU
reproduces __graft_entry__.entry()'s tile within 1e-4."""

import importlib.util
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from steeljax.env.environment import load_environment as load_env_ref
from steeljax.env.sky import procedural_sky_cube as sky_cube_ref
from steeljax.gi.light_volume import capture_probes as capture_ref
from steeljax.gi.light_volume import generate_light_volume as generate_ref
from steeljax.parallel import make_mesh as make_mesh_ref
from steeljax.parallel import render_frame_sharded as pt_sharded_ref
from steeljax.parallel import render_hybrid_frame_sharded as hybrid_sharded_ref
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax_torch import entry as entry_mod
from steeljax_torch.convert import (from_jax_environment,
                                    from_jax_light_volume)
from steeljax_torch.core import camera
from steeljax_torch.gi.light_volume import capture_probes
from steeljax_torch.parallel import (Mesh, make_mesh, render_frame_sharded,
                                     render_hybrid_frame_sharded,
                                     shard_pixels)
from steeljax_torch.render.hybrid.renderer import render_hybrid_pixels
from steeljax_torch.render.pt import integrator, renderer
from steeljax_torch.render.pt.integrator import render_sample
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401

W, H = 32, 16
SHARD_ATOL = 1e-5
PIXEL_ATOL = 1e-4
CPU4 = ["cpu"] * 4
TINY_ENV = dict(irradiance_resolution=4, reflection_resolution=8,
                lut_resolution=16, lut_samples=32, reflection_samples=16,
                irradiance_delta=0.4)
PROBES = np.array([[0.0, 1.0, 0.0], [0.5, 1.5, 0.5]], np.float32)
REPO = Path(__file__).resolve().parent.parent


def shade_mode0(tables):
    return tables.replace(shade_mode=0, chunks=tuple(
        c.replace(shade_packed=None) for c in tables.chunks))


@pytest.fixture(scope="module")
def setup():
    """The reference's and the port's Cornell box (sphere detail 4), the
    camera, the tiny environment and the reference's tiny light volume."""
    scene_r = builtin_ref.make_cornell_scene(sphere_detail=4)
    flat_r, tables_r = renderer_ref.prepare_scene(scene_r,
                                                  env_resolution=16)
    scene = builtin.make_cornell_scene(sphere_detail=4)
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16)
    frame = camera.make_frame(scene.camera_location, scene.camera_projection)
    env_r = load_env_ref(cube=sky_cube_ref(16), **TINY_ENV)
    lv_r = generate_ref(flat_r, tables_r, spp=1, resolution=4, min_edge=4.0,
                        max_probes=64)
    return dict(ref=(flat_r, tables_r, env_r, lv_r),
                ours=(flat, shade_mode0(tables),
                      from_jax_environment(env_r, "cpu"),
                      from_jax_light_volume(lv_r, "cpu")),
                frame=frame)


def _close(ours, want, atol, label):
    delta = np.abs(np.asarray(ours) - np.asarray(want))
    print(f"{label}: max |delta| {delta.max():.3e}")
    assert ours.shape == want.shape and np.isfinite(ours).all()
    assert float(delta.max()) <= atol, label


def test_make_mesh_and_shard_pixels(monkeypatch):
    mesh = make_mesh(CPU4)
    assert isinstance(mesh, Mesh) and mesh.size == 4
    assert mesh.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError):
        make_mesh(CPU4, host_shape=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        make_mesh()
    px, py, pad = shard_pixels(mesh, 10, 3)   # 30 pixels over 4 devices
    assert [len(x) for x in px] == [8] * 4 and pad == 2
    ys, xs = np.meshgrid(np.arange(3), np.arange(10), indexing="ij")
    np.testing.assert_array_equal(torch.cat(px).numpy()[:30],
                                  xs.reshape(-1))
    np.testing.assert_array_equal(torch.cat(py).numpy()[:30],
                                  ys.reshape(-1))
    assert (torch.cat(px)[30:] == 0).all() and (torch.cat(py)[30:] == 0).all()


@pytest.mark.parametrize("width, height", [(W, H), (13, 7)])
def test_sharded_pt_frame(width, height, setup):
    flat, tables, _, _ = setup["ours"]
    frame = setup["frame"]
    sharded = render_frame_sharded(
        flat, tables, frame.inverse_view, frame.inverse_proj,
        frame.camera_near, frame.camera_far, width, height,
        make_mesh(CPU4))
    single = render_sample(flat, tables, frame.inverse_view,
                           frame.inverse_proj, frame.camera_near,
                           frame.camera_far, width, height, 0, 0).numpy()
    _close(sharded, single, SHARD_ATOL, "pt sharded vs one device")
    flat_r, tables_r, _, _ = setup["ref"]
    ref = pt_sharded_ref(flat_r, tables_r, frame.inverse_view,
                         frame.inverse_proj, frame.camera_near,
                         frame.camera_far, width, height, make_mesh_ref())
    _close(sharded, ref, PIXEL_ATOL, "pt sharded vs reference sharded")


def test_sharded_pt_frame_repacks_per_shard(setup, monkeypatch):
    """With the per-bounce repack forced on, each shard sorts its own rays
    (as under shard_map) and the frame stays the one-device frame."""
    flat, tables, _, _ = setup["ours"]
    frame = setup["frame"]
    monkeypatch.setattr(integrator, "REPACK_MIN_TRIS", -1)
    sharded = render_frame_sharded(
        flat, tables, frame.inverse_view, frame.inverse_proj,
        frame.camera_near, frame.camera_far, W, H, make_mesh(CPU4))
    single = render_sample(flat, tables, frame.inverse_view,
                           frame.inverse_proj, frame.camera_near,
                           frame.camera_far, W, H, 0, 0).numpy()
    _close(sharded, single, SHARD_ATOL, "pt repack sharded vs one device")


@pytest.mark.parametrize("volume", ["none", "light volume"])
def test_sharded_hybrid_frame(volume, setup):
    flat, tables, env, lv = setup["ours"]
    flat_r, tables_r, env_r, lv_r = setup["ref"]
    if volume == "none":
        lv = lv_r = None
    frame = setup["frame"]
    matrices = (frame.inverse_view, frame.inverse_proj, frame.view_proj,
                frame.camera_near, frame.camera_far, W, H)
    sharded = render_hybrid_frame_sharded(flat, tables, env, *matrices,
                                          make_mesh(CPU4), light_volume=lv)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    single = render_hybrid_pixels(
        flat, tables, env, *(torch.as_tensor(m) for m in matrices[:3]),
        *matrices[3:], torch.as_tensor(xs.reshape(-1)),
        torch.as_tensor(ys.reshape(-1)), light_volume=lv).numpy()
    _close(sharded, single.reshape(H, W, 3), SHARD_ATOL,
           f"hybrid ({volume}) sharded vs one device")
    ref = hybrid_sharded_ref(flat_r, tables_r, env_r, *matrices,
                             make_mesh_ref(), light_volume=lv_r)
    _close(sharded, ref, PIXEL_ATOL,
           f"hybrid ({volume}) sharded vs reference sharded")


@pytest.mark.parametrize("devices", [4, 3])
def test_capture_probes_split_across_devices(devices, setup):
    flat, tables, _, _ = setup["ours"]
    single = capture_probes(flat, tables, PROBES, resolution=4,
                            spp=1).numpy()
    split = capture_probes(flat, tables, PROBES, resolution=4, spp=1,
                           devices=["cpu"] * devices).numpy()
    assert split.shape == single.shape == (2, 6, 4, 4, 3)
    _close(split, single, SHARD_ATOL, "capture split vs one device")
    flat_r, tables_r, _, _ = setup["ref"]
    ref = np.asarray(capture_ref(flat_r, tables_r, PROBES, resolution=4,
                                 spp=1))
    _close(split, ref, PIXEL_ATOL, "capture split vs reference")


def test_dryrun_multichip_on_cpu_devices(monkeypatch):
    deltas = entry_mod.dryrun_multichip(4, devices=CPU4)
    assert set(deltas) == {"pt", "hybrid", "capture"}
    assert max(deltas.values()) <= SHARD_ATOL
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        entry_mod.dryrun_multichip(2)


def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_on_cpu_reproduces_graft_entry(monkeypatch):
    fn, args = entry_mod.entry("cpu")
    ours = fn(*args).numpy()
    fn_ref, args_ref = _graft_entry().entry()
    ref = np.asarray(jax.jit(fn_ref)(*args_ref))
    assert ours.shape == ref.shape == (32 * 18, 3)
    delta = np.abs(ours - ref).max(axis=-1)
    print(f"entry tile: max |delta| {delta.max():.3e}")
    assert int((delta > PIXEL_ATOL).sum()) == 0
    assert args[0].device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        entry_mod.entry()
