"""The port's host build equals the reference's exactly: flattened scene
arrays, BVH permutation and padding, binary nodes, BVH8 rows and depth,
packed triangle rows and mode-1 shade rows.  Both packages compile the same
C++ builder source, so the trees are identical, not merely equivalent."""

import dataclasses

import numpy as np
import pytest
import torch

from steeljax.accel import dispatch as dispatch_ref
from steeljax.accel.bvh import apply_permutation as apply_permutation_ref
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax.scene.flatten import flatten_scene as flatten_ref
from steeljax_torch.accel import dispatch
from steeljax_torch.accel.bvh import apply_permutation
from steeljax_torch.convert import from_jax_prepared
from steeljax_torch.render.pt import renderer
from steeljax_torch.scene import builtin
from steeljax_torch.scene.flatten import FlatScene, flatten_scene
from test_torch_support import one_torch_thread  # noqa: F401


STATIC = ("light_count", "env_enabled", "env_analytic", "any_alpha_test",
          "any_alpha_blend", "has_textures", "source_tri_count")


def _assert_flat_equal(ours: FlatScene, ref):
    for field in dataclasses.fields(FlatScene):
        a = getattr(ours, field.name)
        b = getattr(ref, field.name)
        if field.name in STATIC:
            assert a == b, field.name
        else:
            np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b),
                                          err_msg=field.name)


def _assert_chunk_equal(ours, ref):
    np.testing.assert_array_equal(ours.bvh.nodes, np.asarray(ref.bvh.nodes))
    assert ours.bvh.depth == ref.bvh.depth
    assert ours.bvh.max_leaf == ref.bvh.max_leaf
    np.testing.assert_array_equal(ours.bvh8.rows.cpu().numpy(),
                                  np.asarray(ref.bvh8.rows))
    assert ours.bvh8.depth == ref.bvh8.depth
    assert ours.bvh8.max_leaf == ref.bvh8.max_leaf
    np.testing.assert_array_equal(ours.tris_packed.cpu().numpy(),
                                  np.asarray(ref.tris_packed))
    assert (ours.row_offset, ours.rows) == (ref.row_offset, ref.rows)
    assert ours.aabb == ref.aabb


@pytest.mark.parametrize("sphere_detail", [6, 12])
def test_cornell_flatten_equal(sphere_detail):
    ours = flatten_scene(builtin.make_cornell_scene(sphere_detail), "cpu")
    ref = flatten_ref(builtin_ref.make_cornell_scene(sphere_detail))
    _assert_flat_equal(ours, ref)


@pytest.mark.parametrize("sphere_detail,padded,rows8,depth8", [
    (6, 420, 4, 2), (12, 1320, 8, 3)])
def test_cornell_prepare_scene_equal(sphere_detail, padded, rows8, depth8):
    """prepare_scene: permuted arrays, tables and mode-1 shade rows equal
    the reference's pallas-layout tables (pure numpy packing on the CPU;
    never traced in JAX)."""
    flat, tables = renderer.prepare_scene(
        builtin.make_cornell_scene(sphere_detail), "cpu", env_resolution=16)
    flat_ref, tables_ref = renderer_ref.prepare_scene(
        builtin_ref.make_cornell_scene(sphere_detail), env_resolution=16,
        use_pallas=True)
    _assert_flat_equal(flat, flat_ref)
    assert len(tables.chunks) == len(tables_ref.chunks) == 1
    _assert_chunk_equal(tables.chunks[0], tables_ref.chunks[0])
    assert tables.shade_mode == tables_ref.shade_mode == 1
    np.testing.assert_array_equal(
        tables.chunks[0].shade_packed.numpy(),
        np.asarray(tables_ref.chunks[0].shade_packed))
    assert flat.tri_pos.shape[0] == padded
    assert tables.bvh8.rows.shape[0] == rows8
    assert tables.bvh8.depth == depth8


def test_soup_tables_and_permutation_equal():
    """A seeded soup, 30% double-sided: order, padding, nodes, rows and
    the shade rows built by attach_shade_tables."""
    r = np.random.default_rng(11)
    n = 3000
    tris = (r.uniform(-10, 10, (n, 1, 3))
            + r.normal(0, 0.6, (n, 3, 3))).astype(np.float32)
    ds = r.uniform(size=n) < 0.3
    nrm = r.normal(size=(n, 3, 3)).astype(np.float32)
    mat = r.integers(0, 7, n).astype(np.int32)

    tables, order, padded = dispatch.prepare_tables(tris, ds, "cpu",
                                                    leaf_size=24)
    tables_ref, order_ref, padded_ref = dispatch_ref.prepare_tables(
        tris, ds, leaf_size=24, use_pallas=True)
    np.testing.assert_array_equal(order, order_ref)
    assert padded == padded_ref
    _assert_chunk_equal(tables.chunks[0], tables_ref.chunks[0])

    arrays = {"tri_pos": tris, "nrm": nrm, "mat": mat, "ds": ds}
    perm = apply_permutation((None, order, padded), arrays)
    perm_ref = apply_permutation_ref((None, order_ref, padded_ref), arrays)
    for k in arrays:
        np.testing.assert_array_equal(perm[k], perm_ref[k])
    shaded = dispatch.attach_shade_tables(tables, perm["nrm"], perm["mat"])
    shaded_ref = dispatch_ref.attach_shade_tables(
        tables_ref, perm_ref["nrm"], np.zeros_like(perm_ref["nrm"]),
        np.zeros(perm_ref["nrm"].shape[:2] + (2,), np.float32),
        perm_ref["mat"], textured=False)
    np.testing.assert_array_equal(
        shaded.chunks[0].shade_packed.numpy(),
        np.asarray(shaded_ref.chunks[0].shade_packed))


def test_from_jax_prepared_gives_the_same_tables():
    """The reference's CPU prepare_scene (no shade rows attached off the
    TPU) carried across equals the port's own preparation."""
    flat_ref, tables_ref = renderer_ref.prepare_scene(
        builtin_ref.make_cornell_scene(6), env_resolution=16)
    assert tables_ref.chunks[0].shade_packed is None
    flat_c, tables_c = from_jax_prepared(flat_ref, tables_ref, "cpu")
    flat, tables = renderer.prepare_scene(builtin.make_cornell_scene(6),
                                          "cpu", env_resolution=16)
    for field in dataclasses.fields(FlatScene):
        a, b = getattr(flat_c, field.name), getattr(flat, field.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), field.name
        else:
            assert a == b, field.name
    a, b = tables_c.chunks[0], tables.chunks[0]
    np.testing.assert_array_equal(a.bvh.nodes, b.bvh.nodes)
    assert (a.bvh8.depth, a.bvh8.max_leaf) == (b.bvh8.depth, b.bvh8.max_leaf)
    for name in ("tris_packed", "shade_packed"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.bvh8.rows, b.bvh8.rows)
    assert (a.row_offset, a.rows, a.aabb) == (b.row_offset, b.rows, b.aabb)
    assert tables_c.shade_mode == tables.shade_mode == 1


def test_more_than_one_chunk_raises():
    tris = np.random.default_rng(0).normal(size=(64, 3, 3)).astype(
        np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        dispatch.prepare_tables(tris, np.zeros(64, bool), "cpu",
                                max_chunk=32)
