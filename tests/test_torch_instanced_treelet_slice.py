"""The instanced and the treelet slice end to end against the reference on
the CPU, on 32x18 tiles (1 spp, accumulation index 0).

Instanced: `PathTracingRenderer(scene, ..., instancing=True)` of both
packages on the lit parity scene (make_parity_scene(4): next-event
estimation, so the two-level any-hit query runs too).  The reference takes
its CPU path (a loop of binary-BVH traversals over the instances, shading
rows composed per hit); the port the plain version of kernel K6 with fused
shading.  No pixel may differ by more than 1e-4 and rays_traced, shadow rays
included, must be equal.  Then one entity is moved in both scenes and
`refresh_scene()` is called: no BLAS is rebuilt, the triangle tensor is the
same object, and the image equals the reference's again.

Treelets: `prepare_scene(..., treelets=True)` with the cut size brought down
to 16 triangles at leaf size 8 (so the tile's rays cross many treelets):
the tile must equal the port's own flat tile and the reference's flat tile
under the same bound, on the lit scene (shade mode 1 and the treelet any-hit query), the
small textured stress scene (shade mode 2) and a small foliage scene (coarse
alpha masks, the bounded re-trace).

`convert.from_jax_prepared` carries the reference's instanced tables (fused,
as `InstancedAccel(use_pallas=True)` packs them on the host, and unfused)
and its treelet tables across: equal arrays, and the same tiles.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax.core import camera as camera_ref
from steeljax.core.config import RenderConfig as RenderConfigRef
from steeljax.render.pt import integrator as integrator_ref
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax_torch.accel import treelets
from steeljax_torch.accel.instances import InstancedTables
from steeljax_torch.apps import kernel_parity as kp
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.render.pt import integrator, renderer
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401


W, H = 32, 18
PIXEL_ATOL = 1e-4


def _pixels():
    ys, xs = np.meshgrid(np.arange(H, dtype=np.int32),
                         np.arange(W, dtype=np.int32), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _tile(scene, flat, tables):
    frame = camera_ref.make_frame(scene.camera_location,
                                  scene.camera_projection)
    px, py = _pixels()
    result, stats = integrator.render_pixels(
        flat, tables, frame.inverse_view, frame.inverse_proj, 0.01, 100.0,
        W, H, px, py, 0, 0, RenderConfig(width=W, height=H),
        return_stats=True)
    return result.numpy(), float(stats["rays_traced"])


def _tile_ref(scene, flat, tables):
    frame = camera_ref.make_frame(scene.camera_location,
                                  scene.camera_projection)
    px, py = _pixels()
    result, stats = integrator_ref.render_pixels(
        flat, tables, jnp.asarray(frame.inverse_view),
        jnp.asarray(frame.inverse_proj), 0.01, 100.0, W, H, jnp.asarray(px),
        jnp.asarray(py), 0, 0, RenderConfigRef(width=W, height=H),
        return_stats=True)
    return np.asarray(result), float(stats["rays_traced"])


def _check(ours, ref, rays, rays_ref, label):
    assert ours.shape == (W * H, 3) and np.isfinite(ours).all()
    diverging = int((np.abs(ours - ref).max(axis=-1) > PIXEL_ATOL).sum())
    print(f"{label}: {diverging} of {W * H} pixels differ by more than "
          f"{PIXEL_ATOL} (max {float(np.abs(ours - ref).max()):.3e}); "
          f"rays_traced {rays} vs {rays_ref}")
    assert diverging == 0
    assert rays == rays_ref
    assert float(ours.std()) > 0.0


def _move_ref(scene):
    """kernel_parity.move_entity on the reference's scene."""
    entity = scene.entities[scene.renderable_entities()[-1]]
    moved = np.array(entity.local_transform, np.float32)
    moved[1, 3] += 0.5
    entity.local_transform = moved
    scene.revision += 1


def test_instanced_renderer_matches_reference_and_refreshes():
    scene = builtin.make_parity_scene(4)
    scene_r = builtin_ref.make_parity_scene(4)
    ours = renderer.PathTracingRenderer(
        scene, W, H, RenderConfig(width=W, height=H), instancing=True,
        device="cpu")
    ref = renderer_ref.PathTracingRenderer(
        scene_r, W, H, RenderConfigRef(width=W, height=H), instancing=True)
    assert isinstance(ours.tables, InstancedTables)
    assert ours.tables.shade_mode == 1 and ref.tables.shade_mode == 0
    tile, rays = _tile(scene, ours.flat, ours.tables)
    tile_r, rays_r = _tile_ref(scene_r, ref.flat, ref.tables)
    _check(tile, tile_r, rays, rays_r, "instanced")
    assert rays > W * H  # shadow rays are counted

    # The flat path of the same scene gives the same tile.
    flat_tile, flat_rays = _tile(
        scene, *renderer.prepare_scene(scene, "cpu", env_resolution=16))
    _check(tile, flat_tile, rays, flat_rays, "instanced vs flat")

    frame = ours.render_frame()
    frame_r = np.asarray(ref.render_frame())
    assert frame.shape == (H, W, 3)
    assert np.abs(frame - frame_r).max() <= PIXEL_ATOL
    assert ours.state.index == 1

    # Move one entity: the instance tables alone are rebuilt.
    builds = ours._accel.blas_builds
    tables, inst_before = ours.tables, ours.tables.inst_trace.clone()
    kp.move_entity(scene)
    _move_ref(scene_r)
    ours.refresh_scene()
    ref.refresh_scene()
    assert ours._accel.blas_builds == builds == 2   # quad and sphere
    # The same instance count: rewritten in place, the same tables.
    assert ours.tables is tables
    assert ours.tables.shade_rows is not None
    assert not torch.equal(ours.tables.inst_trace, inst_before)
    assert ours.state.index == 0
    moved, moved_rays = _tile(scene, ours.flat, ours.tables)
    moved_r, moved_rays_r = _tile_ref(scene_r, ref.flat, ref.tables)
    _check(moved, moved_r, moved_rays, moved_rays_r, "instanced, moved")
    assert np.abs(moved - tile).max() > 1e-3  # the edit shows


def test_instanced_renderer_camera_and_resize():
    """set_camera, resize and reset_accumulation restart the accumulation
    and keep the tables (renderer.py:212-240)."""
    scene = builtin.make_cornell_scene(4)
    r = renderer.PathTracingRenderer(scene, 8, 8, instancing=True,
                                     device="cpu")
    first = r.render_frame()
    r.render_frame()
    assert r.state.index == 2
    tables = r.tables
    here = scene.camera_location
    r.set_camera(location=dataclasses.replace(
        here, position=here.position + np.float32([0.3, 0.0, 0.0])))
    assert r.state.index == 0 and r.tables is tables
    assert np.abs(r.render_frame() - first).max() > 1e-3
    r.resize(12, 6)
    assert r.state.index == 0
    assert r.render_frame().shape == (6, 12, 3)
    r.reset_accumulation()
    assert r.state.index == 0
    assert tuple(r.state.accumulated.shape[:2]) == (6, 12)


def test_prepare_scene_accel_device_must_match():
    from steeljax_torch.accel.instances import InstancedAccel

    scene = builtin.make_cornell_scene(4)
    flat, tables = renderer.prepare_scene(
        scene, "cpu", env_resolution=16, accel=InstancedAccel(device="cpu"))
    assert isinstance(tables, InstancedTables)
    with pytest.raises(ValueError, match="accel is on"):
        renderer.prepare_scene(scene, "cpu", env_resolution=16,
                               accel=InstancedAccel(device="meta"))


TREELET_SCENES = {
    "lit": (lambda: builtin.make_parity_scene(4),
            lambda: builtin_ref.make_parity_scene(4), 1),
    "textured": (lambda: builtin.make_stress_scene(8, 4, textured=True),
                 lambda: builtin_ref.make_stress_scene(8, 4, textured=True),
                 2),
    "foliage": (lambda: builtin.make_foliage_scene(cards=300, region=2.0),
                None, 0),
}


@pytest.mark.parametrize("name", sorted(TREELET_SCENES))
def test_treelet_tile_matches_flat_tiles(name):
    make, make_ref, mode = TREELET_SCENES[name]
    scene = make()
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16,
                                          leaf_size=8, treelets=True,
                                          treelet_tris=16)
    tt = tables.treelets
    assert tt is not None and tt.count > 4
    assert tables.chunks[0].tris_packed is None
    assert tables.shade_mode == tt.shade_mode == mode
    assert tt.alpha_mask == (name == "foliage")
    before = treelets.SCHEDULER["traces"]
    tile, rays = _tile(scene, flat, tables)
    # Every material ray goes through the scheduler, and with a light every
    # shadow ray too.
    traces = treelets.SCHEDULER["traces"] - before
    assert traces > 0
    if name == "lit":
        assert traces % 2 == 0

    # The port's flat tile: coarse masks only, as the treelet tables.
    plain_tile, plain_rays = _tile(scene, *renderer.prepare_scene(
        scene, "cpu", env_resolution=16, fine_masks=False))
    _check(tile, plain_tile, rays, plain_rays, f"{name}: treelets vs flat")
    if make_ref is not None:
        scene_r = make_ref()
        tile_r, rays_r = _tile_ref(scene_r, *renderer_ref.prepare_scene(
            scene_r, env_resolution=16))
        _check(tile, tile_r, rays, rays_r, f"{name}: treelets vs reference")


def test_render_cli_instancing_on_the_cpu(tmp_path):
    """--instancing renders builtin:cornell through the two-level structure
    and writes the picture the flat path writes (8-bit, within one step)."""
    from PIL import Image

    from steeljax_torch.apps import render_cli

    out, out_flat = tmp_path / "inst.png", tmp_path / "flat.png"
    common = ["builtin:cornell", "--size", "16x9", "--spp", "1", "--device",
              "cpu"]
    assert render_cli.main(common + ["-o", str(out), "--instancing"]) == 0
    assert render_cli.main(common + ["-o", str(out_flat)]) == 0
    image = np.asarray(Image.open(out)).astype(np.int32)
    image_flat = np.asarray(Image.open(out_flat)).astype(np.int32)
    assert image.shape == (9, 16, 3) and image.std() > 0
    assert np.abs(image - image_flat).max() <= 1


@pytest.mark.parametrize("use_pallas", [True, False])
def test_from_jax_prepared_carries_instanced_tables(use_pallas):
    """The reference's instanced tables through convert.from_jax_prepared:
    the arrays are carried as they are; fused tables (use_pallas=True) trace
    in shade mode 1, the reference's CPU tables (no fused rows) in mode 0,
    where the port composes the shading rows per hit as the reference does.
    Both render the reference's tile."""
    from steeljax.accel.instances import InstancedAccel as InstancedAccelRef
    from steeljax_torch.convert import from_jax_prepared

    scene_r = builtin_ref.make_parity_scene(4)
    flat_r, tables_r = renderer_ref.prepare_scene(
        scene_r, env_resolution=16,
        accel=InstancedAccelRef(use_pallas=use_pallas))
    flat, tables = from_jax_prepared(flat_r, tables_r, "cpu")
    assert isinstance(tables, InstancedTables)
    assert tables.shade_mode == (1 if use_pallas else 0)
    assert (tables.shade_rows is not None) == use_pallas
    for name in ("snode_rows", "tris_packed", "inst_trace", "inst_shade",
                 "blas_shade"):
        np.testing.assert_array_equal(getattr(tables, name).numpy(),
                                      np.asarray(getattr(tables_r, name)),
                                      err_msg=name)
    assert tables.n_tlas == int(tables_r.n_tlas)
    assert tables.depth == tables_r.depth
    assert tables.inst_blas == tuple(tables_r.inst_blas)
    tile, rays = _tile(builtin.make_parity_scene(4), flat, tables)
    cpu_tables = tables_r if not use_pallas else InstancedAccelRef(
        use_pallas=False).prepare(scene_r)
    tile_r, rays_r = _tile_ref(scene_r, flat_r, cpu_tables)
    _check(tile, tile_r, rays, rays_r, f"converted, use_pallas={use_pallas}")


def test_from_jax_prepared_carries_treelet_tables(monkeypatch):
    """The reference's prepare_scene with STEELJAX_TREELETS=1 (tables packed
    on the host) through convert.from_jax_prepared: the port's own
    treelet preparation gives the same arrays, and the converted tables
    render the reference's flat tile."""
    from steeljax.accel import treelets as treelets_ref
    from steeljax_torch.convert import from_jax_prepared

    monkeypatch.setenv("STEELJAX_TREELETS", "1")
    monkeypatch.setattr(treelets_ref.build_treelet_tables, "__defaults__",
                        (16,))
    scene_r = builtin_ref.make_parity_scene(4)
    flat_r, tables_r = renderer_ref.prepare_scene(
        scene_r, env_resolution=16, use_pallas=True, leaf_size=8)
    assert tables_r.treelets is not None and tables_r.treelets.count > 4
    flat, tables = from_jax_prepared(flat_r, tables_r, "cpu")
    scene = builtin.make_parity_scene(4)
    own_flat, own = renderer.prepare_scene(scene, "cpu", env_resolution=16,
                                           leaf_size=8, treelets=True,
                                           treelet_tris=16)
    assert tables.shade_mode == own.shade_mode == 1
    assert tables.chunks[0].tris_packed is None
    assert tables.chunks[0].rows == own.chunks[0].rows
    for name in ("node_stack", "tri_stack", "shade_stack", "aabb_lo",
                 "aabb_hi", "tri_offsets"):
        assert torch.equal(getattr(tables.treelets, name),
                           getattr(own.treelets, name)), name
    assert tables.treelets.ranges == own.treelets.ranges
    assert tables.treelets.depth == own.treelets.depth
    monkeypatch.setenv("STEELJAX_TREELETS", "0")
    tile, rays = _tile(scene, flat, tables)
    tile_r, rays_r = _tile_ref(scene_r, *renderer_ref.prepare_scene(
        scene_r, env_resolution=16))
    _check(tile, tile_r, rays, rays_r, "converted treelets")


def test_refresh_lights_and_materials_equal_reference():
    """flatten.refresh_lights and refresh_materials re-pack the light rows
    and the material tables alone, equal to the reference's
    (flatten.py:204-257) and to a fresh flatten of the edited scene, into
    the flat scene's own tensors (the counts are unchanged)."""
    from steeljax.scene import flatten as flatten_ref
    from steeljax_torch.scene import flatten

    scene = builtin.make_parity_scene(4)
    scene_r = builtin_ref.make_parity_scene(4)
    flat = flatten.flatten_scene(scene, "cpu")
    flat_r = flatten_ref.flatten_scene(scene_r)
    for s in (scene, scene_r):
        sun = s.entities[s.find_entity("sun")]
        sun.light.color = np.float32([1.0, 2.0, 0.5])
        s.materials[0].roughness_factor = 0.25
        s.materials[0].base_color_factor = np.float32([0.2, 0.4, 0.6, 1.0])
    light_color, mat_params = flat.light_color.clone(), flat.mat_params.clone()
    lit, lit_r = (flatten.refresh_lights(flat, scene),
                  flatten_ref.refresh_lights(flat_r, scene_r))
    fresh = flatten.flatten_scene(scene, "cpu")
    for name in ("light_location", "light_color"):
        np.testing.assert_array_equal(getattr(lit, name).numpy(),
                                      np.asarray(getattr(lit_r, name)))
        assert torch.equal(getattr(lit, name), getattr(fresh, name))
        assert not torch.equal(lit.light_color, light_color)
    assert lit.light_count == lit_r.light_count == fresh.light_count
    assert lit is flat
    mats, mats_r = (flatten.refresh_materials(flat, scene),
                    flatten_ref.refresh_materials(flat_r, scene_r))
    for name in ("mat_base_color", "mat_emission", "mat_params", "mat_tex",
                 "mat_flags", "mat_packed", "mat_emission_linear"):
        np.testing.assert_array_equal(getattr(mats, name).numpy(),
                                      np.asarray(getattr(mats_r, name)),
                                      err_msg=name)
        assert torch.equal(getattr(mats, name), getattr(fresh, name)), name
    assert not torch.equal(mats.mat_params, mat_params)
    assert mats is flat
