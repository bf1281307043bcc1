"""The instanced tables' per-frame refresh (InstancedAccel.refresh) on the
CPU: after every instance moves, the refreshed tables and flat scene are
the same objects over the same storage, and every tensor equals a fresh
`prepare`'s; the instance rows of one numpy pass equal the reference's
per-instance loop and the reference package's arrays; a spawn or an
erase prepares new tables; and a path-traced frame over the refreshed
tables keeps its key, replays through the stand-in capturer and is
bit-equal to an eager frame over freshly prepared tables."""

import numpy as np
import pytest
import torch

from steeljax.accel import instances as instances_ref
from steeljax.scene import builtin as builtin_ref
from steeljax_torch.accel import instances
from steeljax_torch.core import camera as camera_lib
from steeljax_torch.core import profiling
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.render.pt import frame_graphs, integrator, renderer
from steeljax_torch.scene import builtin
from steeljax_torch.scene import scene as scene_lib
from test_torch_frame_graphs import StandIn
from test_torch_instances import _canonical
from test_torch_support import one_torch_thread  # noqa: F401

W, H = 16, 8
GRID = 16
FIRST = 10  # make_stress_scene's room entities come first
TENSORS = ("snode_rows", "inst_trace", "inst_shade", "sort_bounds",
           "tris_packed", "tri_records", "blas_shade", "shade_rows")
FLAT_TENSORS = ("light_location", "light_color", "mat_base_color",
                "mat_params", "mat_packed", "mat_emission_linear")


@pytest.fixture(autouse=True)
def fresh_record():
    profiling.reset()
    yield
    profiling.reset()


def _sunlit():
    return builtin.make_sunlit_stress_scene(instances=GRID, sphere_detail=6)


def _move(scene, step: int) -> None:
    """Every grid instance moved and turned, by an amount of its own that
    depends on `step` (the first call keeps the base transforms aside)."""
    base = scene.__dict__.setdefault("base_transforms", [
        scene.entities[k].local_transform.copy()
        for k in range(FIRST, FIRST + GRID)])
    for k, m in enumerate(base):
        angle = 0.3 * step + 0.1 * k
        c, s = np.cos(angle), np.sin(angle)
        turn = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        moved = m.copy()
        moved[:3, :3] = turn @ m[:3, :3]
        moved[:3, 3] += np.float32([0.2 * np.sin(step + k), 0.1 * step,
                                    0.0])
        scene.entities[FIRST + k].local_transform = moved


def _prepared(scene, accel=None):
    return renderer.prepare_scene(
        scene, "cpu", env_resolution=16,
        accel=accel or instances.InstancedAccel(device="cpu"))


def _counters():
    return profiling.record()["rows"][-1]["counters"]


def test_refresh_in_place_equals_a_fresh_prepare():
    scene = _sunlit()
    accel = instances.InstancedAccel(device="cpu")
    flat, tables = _prepared(scene, accel)
    storage = {name: getattr(tables, name).data_ptr() for name in TENSORS}
    flat_storage = {name: getattr(flat, name).data_ptr()
                    for name in FLAT_TENSORS}
    before = tables.inst_trace.clone()
    _move(scene, 1)
    scene.entities[scene.find_entity("sun")].light.color = np.float32(
        [1.0, 2.0, 0.5])
    scene.materials[4].roughness_factor = 0.3
    new_flat, new_tables = accel.refresh(scene, flat, tables,
                                         materials=True)
    assert new_tables is tables and new_flat is flat
    assert accel.blas_builds == 3
    assert {name: getattr(tables, name).data_ptr()
            for name in TENSORS} == storage
    assert {name: getattr(flat, name).data_ptr()
            for name in FLAT_TENSORS} == flat_storage
    assert not torch.equal(tables.inst_trace, before)
    counters = _counters()
    assert counters["instances.in_place"] == 1
    assert "instances.rebuilt" not in counters
    assert counters["instances.upload_bytes"] == sum(
        a.numel() * 4 for a in (
            tables.snode_rows[:tables.n_tlas], tables.inst_trace,
            tables.inst_shade, tables.sort_bounds, flat.light_location,
            flat.light_color)) + sum(
        getattr(flat, name).numel() * getattr(flat, name).element_size()
        for name in ("mat_base_color", "mat_emission", "mat_params",
                     "mat_tex", "mat_flags", "mat_packed",
                     "mat_emission_linear"))
    fresh_flat, fresh = _prepared(scene)
    for name in TENSORS:
        assert torch.equal(getattr(tables, name), getattr(fresh, name)), name
    for name in ("n_tlas", "depth", "aabb_lo", "aabb_hi", "inst_blas",
                 "blas_tri_offset", "shade_mode"):
        assert getattr(tables, name) == getattr(fresh, name), name
    for name in FLAT_TENSORS:
        assert torch.equal(getattr(flat, name), getattr(fresh_flat, name)), \
            name


def _loop_rows(world, blas_lo, blas_hi, double_sided, material_ids,
               material_rows):
    """The reference's per-instance loop (steeljax/accel/instances.py:
    329-356), instance by instance."""
    count = len(world)
    inst_trace = np.zeros((count, instances.INST_COLS), np.float32)
    inst_shade = np.zeros((count, instances.INST_COLS), np.float32)
    lo = np.zeros((count, 3), np.float32)
    hi = np.zeros((count, 3), np.float32)
    for i in range(count):
        inst_trace[i, 0:12] = np.linalg.inv(world[i])[:3, :4].reshape(-1)
        inst_trace[i, 13] = float(double_sided[i])
        lin = world[i, :3, :3]
        nmat = np.linalg.inv(lin).T
        scale = float(np.cbrt(abs(np.linalg.det(lin))))
        inst_trace[i, 14] = float(material_ids[i])
        inst_trace[i, 15] = 1.0 / max(scale, 1e-6)
        inst_trace[i, 16:25] = nmat.reshape(-1)
        inst_trace[i, 25:34] = lin.reshape(-1)
        inst_shade[i, 0:9] = nmat.reshape(-1)
        inst_shade[i, 9:18] = lin.reshape(-1)
        inst_shade[i, 18:46] = material_rows[i]
        inst_shade[i, 46] = scale
        cs = np.stack(np.meshgrid(
            [blas_lo[i, 0], blas_hi[i, 0]], [blas_lo[i, 1], blas_hi[i, 1]],
            [blas_lo[i, 2], blas_hi[i, 2]], indexing="ij"),
            axis=-1).reshape(-1, 3)
        wc = cs @ lin.T + world[i, :3, 3]
        lo[i], hi[i] = wc.min(axis=0), wc.max(axis=0)
    return inst_trace, inst_shade, lo, hi


@pytest.mark.parametrize("count", [0, 1, 7, 310])
def test_instance_rows_equal_the_loop(count):
    """Random transforms, mirrored and sheared ones among them."""
    r = np.random.default_rng(count)
    world = np.zeros((count, 4, 4), np.float32)
    world[:, :3, :3] = r.normal(size=(count, 3, 3))
    world[:, :3, 3] = r.uniform(-5, 5, (count, 3))
    world[:, 3, 3] = 1.0
    blas_lo = r.uniform(-2, 0, (count, 3)).astype(np.float32)
    blas_hi = blas_lo + r.uniform(0.1, 2, (count, 3)).astype(np.float32)
    args = (world, blas_lo, blas_hi, r.random(count) < 0.5,
            r.integers(0, 6, count),
            r.normal(size=(count, 28)).astype(np.float32))
    for ours, loop in zip(instances._instance_rows(*args), _loop_rows(*args)):
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, loop)


def test_refreshed_tables_equal_the_reference():
    """After every instance moved, the refreshed tables equal the reference
    package's prepare of the same edited scene, array for array."""
    scene = builtin.make_stress_scene(instances=GRID, sphere_detail=6)
    scene_r = builtin_ref.make_stress_scene(instances=GRID, sphere_detail=6)
    accel = instances.InstancedAccel(device="cpu")
    flat, tables = _prepared(scene, accel)
    for s in (scene, scene_r):
        _move(s, 2)
    _, refreshed = accel.refresh(scene, flat, tables)
    assert refreshed is tables
    tables_r = instances_ref.InstancedAccel(use_pallas=True).prepare(scene_r)
    assert tables.n_tlas == int(tables_r.n_tlas)
    assert tables.depth == tables_r.depth
    np.testing.assert_array_equal(np.float32(tables.aabb_lo),
                                  np.asarray(tables_r.aabb_lo))
    np.testing.assert_array_equal(np.float32(tables.aabb_hi),
                                  np.asarray(tables_r.aabb_hi))
    ours, ref = _canonical(tables, scene), _canonical(tables_r, scene_r)
    assert sorted(ours) == sorted(ref)
    for name in ours:
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)


@pytest.mark.parametrize("edit", ["spawn", "erase", "new_primitive"])
def test_a_change_of_instances_rebuilds(edit):
    """A spawn, an erase or a new primitive prepares new tables (the
    reference recreates its TLAS when the instance count changes), equal to
    a fresh prepare; the flat scene keeps its objects."""
    scene = _sunlit()
    accel = instances.InstancedAccel(device="cpu")
    flat, tables = _prepared(scene, accel)
    if edit == "erase":
        scene.remove_entity(FIRST + 3)
    else:
        primitive = 2
        if edit == "new_primitive":
            scene.primitives.append(builtin.make_box(0.5))
            primitive = len(scene.primitives) - 1
        scene.add_entity(scene_lib.Entity(
            name="spawned", local_transform=builtin._trs((0.5, 1.0, 0.0)),
            render_objects=[scene_lib.RenderObject(primitive, 4)]))
    new_flat, new_tables = accel.refresh(scene, flat, tables)
    assert new_tables is not tables and new_flat is flat
    assert new_tables.instance_count == tables.instance_count + (
        -1 if edit == "erase" else 1)
    assert accel.blas_builds == (4 if edit == "new_primitive" else 3)
    assert new_tables.tris_packed is tables.tris_packed or \
        edit == "new_primitive"
    assert _counters()["instances.rebuilt"] == 1
    fresh = accel.prepare(scene)
    for name in TENSORS:
        assert torch.equal(getattr(new_tables, name),
                           getattr(fresh, name)), name


def _frame(flat, tables, view, proj, frame, index):
    ys, xs = np.meshgrid(np.arange(H, dtype=np.int32),
                         np.arange(W, dtype=np.int32), indexing="ij")
    return integrator.render_pixels(
        flat, tables, view, proj, frame.camera_near, frame.camera_far, W, H,
        xs.reshape(-1), ys.reshape(-1), index, 0,
        RenderConfig(width=W, height=H), return_stats=True)


@pytest.mark.parametrize("repack", [False, True])
def test_an_edited_frame_replays_bit_equal(repack, monkeypatch):
    """Five frames, every instance moved before each: the refreshed tables
    keep the frame's key, so the frames run eager, capture, then replay,
    and each equals an eager frame over freshly prepared tables (with the
    repack, whose sort keys read the instances' bounds, forced on)."""
    if repack:
        monkeypatch.setattr(integrator, "REPACK_MIN_TRIS", -1)
    scene = _sunlit()
    accel = instances.InstancedAccel(device="cpu")
    flat, tables = _prepared(scene, accel)
    cam = camera_lib.make_frame(scene.camera_location,
                                scene.camera_projection)
    view, proj = cam.inverse_view, cam.inverse_proj
    capturer = StandIn()
    monkeypatch.setattr(integrator, "FRAME_GRAPHS",
                        frame_graphs.FrameGraphs(capturer))
    got = []
    for i in range(5):
        _move(scene, i)
        new_flat, new_tables = accel.refresh(scene, flat, tables)
        assert new_flat is flat and new_tables is tables
        got.append(_frame(flat, tables, view, proj, cam, i))
    ran = [row["ran"] for row in profiling.record()["rows"]
           if row["frame"] == "integrator.render_pixels"]
    assert ran == ["eager", "capture", "replay", "replay", "replay"]
    assert capturer.captures == 1
    monkeypatch.setattr(integrator, "FRAME_GRAPHS",
                        frame_graphs.FrameGraphs(frame_graphs.Eager()))
    images = []
    for i, (image, stats) in enumerate(got):
        _move(scene, i)
        expected, expected_stats = _frame(*_prepared(scene), view, proj,
                                          cam, i)
        assert torch.equal(image, expected), i
        assert torch.equal(stats["rays_traced"],
                           expected_stats["rays_traced"])
        images.append(expected)
    assert not torch.equal(images[1], images[2])
