"""The frozen scene generators against the port's, and the reference's own
scene tables against the port's flattening: at the port's placement seeds
the benchmark's arrays are the port's scene, array for array."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import port_scene
from portbench.reference import scene as ref_scene
from portbench.scenes import load_generator


def _port_scene(name):
    from steeljax_torch.scene import builtin

    if name == "foliage":
        return (builtin.make_foliage_scene(cards=400, region=3.0),
                {"cards": 400, "region": 3.0, "card_size": 0.55,
                 "serrated": True}, 11)
    return (builtin.make_sunlit_stress_scene(instances=300,
                                              sphere_detail=16),
            {"instances": 300, "sphere_detail": 16}, 7)


@pytest.mark.parametrize("name", ["foliage", "sunlit_stress"])
def test_frozen_generator_gives_the_port_scene(name):
    original, params, seed = _port_scene(name)
    arrays = load_generator(name).make(params, seed)
    built = port_scene.build(arrays)
    assert len(built.primitives) == len(original.primitives)
    for a, b in zip(built.primitives, original.primitives):
        for field in ("indices", "positions", "normals", "tangents",
                      "tex_coords"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
    assert [m.__dict__.keys() for m in built.materials] == \
        [m.__dict__.keys() for m in original.materials]
    for a, b in zip(built.materials, original.materials):
        for key, value in a.__dict__.items():
            np.testing.assert_array_equal(value, b.__dict__[key])
    for a, b in zip(built.textures, original.textures):
        np.testing.assert_array_equal(a, b)
    assert len(built.entities) == len(original.entities)
    for a, b in zip(built.entities, original.entities):
        np.testing.assert_array_equal(a.local_transform, b.local_transform)
        assert [(r.primitive, r.material) for r in a.render_objects] == \
            [(r.primitive, r.material) for r in b.render_objects]
    for a, b in zip(built.gather_lights(), original.gather_lights()):
        np.testing.assert_array_equal(a, b)
    for field in ("position", "direction", "up"):
        np.testing.assert_array_equal(
            getattr(built.camera_location, field),
            getattr(original.camera_location, field))
    assert built.camera_projection == original.camera_projection


@pytest.mark.parametrize("name", ["foliage", "sunlit_stress"])
def test_reference_tables_match_the_port_flattening(name):
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.scene.flatten import flatten_scene

    original, params, seed = _port_scene(name)
    arrays = load_generator(name).make(params, seed)
    flat = flatten_scene(original, "cpu")
    pos, nrm, uv, mat = ref_scene.world_triangles(arrays)
    np.testing.assert_array_equal(pos, flat.tri_pos.numpy())
    np.testing.assert_array_equal(nrm, flat.tri_nrm.numpy())
    np.testing.assert_array_equal(uv, flat.tri_uv.numpy())
    np.testing.assert_array_equal(mat, flat.tri_mat.numpy())
    assert arrays.triangle_count() == len(pos)
    location, color = ref_scene.lights(arrays)
    np.testing.assert_array_equal(location,
                                  flat.light_location[:flat.light_count])
    np.testing.assert_array_equal(color,
                                  flat.light_color[:flat.light_count, :3])
    frame = camera_lib.make_frame(original.camera_location,
                                  original.camera_projection)
    inverse_view, inverse_proj = ref_scene.camera_matrices(arrays)
    np.testing.assert_array_equal(inverse_view, frame.inverse_view)
    np.testing.assert_array_equal(inverse_proj, frame.inverse_proj)
    built = ref_scene.build(arrays, "cpu")
    assert built.any_alpha_test == flat.any_alpha_test
    assert torch.equal(built.double_sided, flat.tri_double_sided)


@pytest.mark.parametrize("name", ["foliage", "sunlit_stress"])
def test_sizes_do_not_change_with_the_seed(name):
    _, params, _ = _port_scene(name)
    generator = load_generator(name)
    a, b = generator.make(params, 1), generator.make(params, 2**62 + 5)
    assert a.triangle_count() == b.triangle_count()
    assert [m.positions.shape for m in a.meshes] == \
        [m.positions.shape for m in b.meshes]
    pos_a = ref_scene.world_triangles(a)[0]
    pos_b = ref_scene.world_triangles(b)[0]
    assert pos_a.shape == pos_b.shape
    assert not np.array_equal(pos_a, pos_b)
