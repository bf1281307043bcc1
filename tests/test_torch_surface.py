"""The shading-row layouts against their writers.

flatten.TriShade and flatten.MatPacked name the columns of the per-triangle
shading row (pack_tri_shade) and of the per-material row (pack_materials),
flatten.TriGeometry those of the instanced tables' object-space geometric
rows (blas_shade, pack_tri_shade's first columns in _Blas), and
instances.InstShade those of their per-instance rows (_instance_rows).
Every reader outside those two modules and render/surface.py reads the rows
by these names.  Each layout must name every column of its row once, with
no two names sharing a column, and its writer must fill exactly the named
columns other than PAD; each name must hold the value it names, taken from
the scene's materials and triangles, not from the packing code.
"""

import types

import numpy as np
import pytest
import torch

from steeljax_torch.accel import instances
from steeljax_torch.accel.instances import InstShade
from steeljax_torch.scene import builtin, flatten
from steeljax_torch.scene.flatten import (TRI_SHADE_COLS, TRI_SHADE_GEOMETRY,
                                          TRI_SHADE_MATERIAL, MatPacked,
                                          TriGeometry, TriShade)
from steeljax_torch.scene.material import MaterialFlags
from steeljax_torch.scene.primitive import Primitive
from test_torch_support import one_torch_thread  # noqa: F401


def _columns(layout) -> dict:
    """{name: set of columns} of a layout class, its bases' names too."""
    out = {}
    for name in dir(layout):
        value = getattr(layout, name)
        if isinstance(value, int) and not name.startswith("_"):
            out[name] = {value}
        elif isinstance(value, slice):
            out[name] = set(range(value.start, value.stop))
    return out


def _scene():
    """The textured stress scene with every material field set to a
    distinct non-zero value, every texture slot bound to a texture of its
    own (ids 1 to 5)."""
    scene = builtin.make_stress_scene(8, 2, textured=True)
    scene.textures += [np.full((4, 4, 4), 40 * k, np.uint8)
                       for k in range(1, 6)]
    for m, mat in enumerate(scene.materials):
        k = np.float32(m + 1)
        mat.base_color_factor = np.array([0.1, 0.2, 0.3, 0.4], np.float32) * k
        mat.emission_factor = np.array([0.5, 0.6, 0.7, 0.0], np.float32) * k
        mat.base_color_texture = 1
        mat.roughness_metallic_texture = 2
        mat.normal_texture = 3
        mat.occlusion_texture = 4
        mat.emission_texture = 5
        mat.roughness_factor = 0.11 * k
        mat.metallic_factor = 0.12 * k
        mat.normal_scale = 0.13 * k
        mat.occlusion_strength = 0.14 * k
        mat.alpha_cutoff = 0.15 * k
        mat.flags = MaterialFlags.DOUBLE_SIDED | MaterialFlags.NORMAL_MAPPING
    return scene


def _to_linear(srgb):
    srgb = np.asarray(srgb, np.float64)
    return np.where(srgb < 0.04045, srgb / 12.92,
                    ((srgb + 0.055) / 1.055) ** 2.4)


def _material_values(mat) -> dict:
    """{name: value} of the material columns, from the Material's fields."""
    base = np.asarray(mat.base_color_factor, np.float32)
    emission = np.asarray(mat.emission_factor, np.float32)[:3]
    return {"BASE_COLOR": base[:3], "ALPHA": base[3], "EMISSION": emission,
            "ROUGHNESS": mat.roughness_factor,
            "METALLIC": mat.metallic_factor,
            "NORMAL_SCALE": mat.normal_scale,
            "OCCLUSION": mat.occlusion_strength,
            "ALPHA_CUTOFF": mat.alpha_cutoff, "FLAGS": int(mat.flags),
            "TEX_IDS": [mat.base_color_texture,
                        mat.roughness_metallic_texture, mat.normal_texture,
                        mat.occlusion_texture, mat.emission_texture],
            "BASE_LINEAR": _to_linear(base[:3]),
            "EMISSION_LINEAR": _to_linear(emission)}


def _check_material(row, layout, mat, names) -> None:
    """Each of `names` of `layout` holds its value in one row."""
    expected = _material_values(mat)
    for name in names:
        cols = sorted(_columns(layout)[name])
        np.testing.assert_allclose(
            row[cols], np.atleast_1d(np.asarray(expected[name], np.float64)),
            rtol=1e-6, err_msg=name)


# The material names of each layout: every one but the geometric columns,
# MAT_ID and PAD.
MAT_PACKED_NAMES = set(_columns(MatPacked))
TRI_SHADE_NAMES = {name for name, cols in _columns(TriShade).items()
                   if min(cols) >= TRI_SHADE_MATERIAL.start} - {"MAT_ID",
                                                                "PAD"}


def _blas():
    rng = np.random.default_rng(3)
    vertices = 12
    prim = Primitive.create(
        np.arange(vertices), rng.uniform(-1.0, 1.0, (vertices, 3)),
        rng.uniform(0.1, 1.0, (vertices, 3)),
        rng.uniform(0.1, 1.0, (vertices, 3)),
        rng.uniform(0.1, 1.0, (vertices, 2)))
    return instances._Blas(prim, 2, "cpu")


def _instance_rows():
    rng = np.random.default_rng(4)
    count = 5
    world = np.tile(np.eye(4, dtype=np.float32), (count, 1, 1))
    world[:, :3, :] += rng.uniform(0.1, 0.5, (count, 3, 4)).astype(
        np.float32)
    material_rows = rng.uniform(0.1, 1.0, (count, 28)).astype(np.float32)
    lo = rng.uniform(-1.0, 0.0, (count, 3)).astype(np.float32)
    _, inst_shade, _, _ = instances._instance_rows(
        world, lo, lo + 1.0, np.ones(count, bool), np.arange(count),
        material_rows)
    return world, material_rows, inst_shade


def _written(name):
    """(layout, row width, the writer's rows) of one layout."""
    if name == "tri_shade":
        flat = flatten.flatten_scene(_scene(), "cpu")
        return TriShade, TRI_SHADE_COLS, flat.tri_shade.numpy()
    if name == "mat_packed":
        flat = flatten.flatten_scene(_scene(), "cpu")
        return MatPacked, 16, flat.mat_packed.numpy()
    if name == "inst_shade":
        return InstShade, instances.INST_COLS, _instance_rows()[2]
    return TriGeometry, 28, _blas().shade


@pytest.mark.parametrize("name", ["tri_shade", "mat_packed", "inst_shade",
                                  "blas_shade"])
def test_layout_names_every_written_column_once(name):
    layout, width, rows = _written(name)
    assert rows.shape[1] == width
    cols = _columns(layout)
    named = [c for s in cols.values() for c in s]
    assert len(named) == len(set(named)), "two names share a column"
    assert set(named) == set(range(width)), "a column has no name"
    filled = set(np.nonzero(np.any(rows != 0.0, axis=0))[0].tolist())
    assert filled == set(named) - cols.get("PAD", set())


def test_tri_shade_and_mat_packed_names_hold_their_values():
    scene = _scene()
    flat = flatten.flatten_scene(scene, "cpu")
    shade = flat.tri_shade.numpy()
    tri_mat = flat.tri_mat.numpy()
    for m, mat in enumerate(scene.materials):
        _check_material(flat.mat_packed.numpy()[m], MatPacked, mat,
                        MAT_PACKED_NAMES)
        rows = np.nonzero(tri_mat == m)[0]
        if len(rows):
            _check_material(shade[rows[0]], TriShade, mat, TRI_SHADE_NAMES)
            assert (shade[rows, TriShade.MAT_ID] == m).all()
    t = shade.shape[0]
    pos = flat.tri_pos.numpy()
    np.testing.assert_array_equal(shade[:, TriShade.NORMALS],
                                  flat.tri_nrm.numpy().reshape(t, 9))
    np.testing.assert_array_equal(shade[:, TriShade.TANGENTS],
                                  flat.tri_tan.numpy().reshape(t, 9))
    np.testing.assert_array_equal(shade[:, TriShade.UVS],
                                  flat.tri_uv.numpy().reshape(t, 6))
    np.testing.assert_allclose(
        shade[:, TriShade.GEOM_NORMAL],
        np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0]), rtol=1e-6)
    assert (shade[:, TriShade.UV_DENSITY] >= 0.0).all()


def test_instance_rows_names_hold_their_values():
    scene = _scene()
    for mat in scene.materials:
        row = np.zeros(TRI_SHADE_COLS, np.float32)
        row[TRI_SHADE_MATERIAL] = instances._pack_inst_material(mat)
        _check_material(row, TriShade, mat, TRI_SHADE_NAMES)
        assert row[TriShade.MAT_ID] == 0.0
    world, material_rows, inst_shade = _instance_rows()
    lin = world[:, :3, :3]
    np.testing.assert_allclose(
        inst_shade[:, InstShade.NORMAL_MATRIX],
        np.linalg.inv(lin).transpose(0, 2, 1).reshape(-1, 9), rtol=1e-5)
    np.testing.assert_array_equal(inst_shade[:, InstShade.WORLD_LINEAR],
                                  lin.reshape(-1, 9))
    np.testing.assert_array_equal(inst_shade[:, InstShade.MATERIAL],
                                  material_rows)
    np.testing.assert_allclose(inst_shade[:, InstShade.SCALE],
                               np.cbrt(np.abs(np.linalg.det(lin))),
                               rtol=1e-6)
    blas = _blas()
    t = blas.padded
    np.testing.assert_array_equal(blas.shade[:, TriGeometry.NORMALS],
                                  blas.tri_nrm.reshape(t, 9))
    np.testing.assert_array_equal(blas.shade[:, TriGeometry.TANGENTS],
                                  blas.tri_tan.reshape(t, 9))
    np.testing.assert_array_equal(blas.shade[:, TriGeometry.UVS],
                                  blas.tri_uv.reshape(t, 6))


def test_world_shade_rows_place_columns_by_name():
    """The instanced composition concatenates its parts in TriShade's
    order: under identity instances each lands on its own columns."""
    rng = np.random.default_rng(5)
    geo = torch.from_numpy(rng.uniform(0.1, 1.0, (6, 28)).astype(np.float32))
    inst_shade = torch.zeros((2, instances.INST_COLS))
    eye = torch.eye(3).reshape(9)
    inst_shade[:, InstShade.NORMAL_MATRIX] = eye
    inst_shade[:, InstShade.WORLD_LINEAR] = eye
    inst_shade[:, InstShade.SCALE] = 1.0
    inst_shade[:, InstShade.MATERIAL] = torch.from_numpy(
        rng.uniform(0.1, 1.0, (2, 28)).astype(np.float32))
    tables = types.SimpleNamespace(blas_shade=geo, inst_shade=inst_shade)
    tri = torch.tensor([0, 3, 5, 2])
    inst = torch.tensor([1, 0, 1, 0])
    rows = instances.world_shade_rows(tables, tri, inst)
    assert rows.shape == (4, TRI_SHADE_COLS)
    assert torch.equal(rows[:, TRI_SHADE_GEOMETRY], geo[tri])
    assert torch.equal(rows[:, TRI_SHADE_MATERIAL],
                       inst_shade[inst][:, InstShade.MATERIAL])
