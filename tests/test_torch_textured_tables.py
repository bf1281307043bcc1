"""The port's host build of lit and textured scenes equals the reference's
exactly: the texture pool (atlas, tex_offset, tex_size), the mode-2 shade
rows, the dense any-hit tables (pack_tris_dense rows and the supernode rows
of the leaves re-aligned to 14), on the small textured stress scene
(make_stress_scene(8, 4, textured=True), 520 triangles) and the lit parity
scene (make_parity_scene(4))."""

import dataclasses

import numpy as np
import pytest

from steeljax.accel import dispatch as dispatch_ref
from steeljax.accel import pallas_traverse as ptv_ref
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax.scene.flatten import flatten_scene as flatten_ref
from steeljax_torch.accel import cuda_traverse, dispatch
from steeljax_torch.convert import from_jax_prepared
from steeljax_torch.render.pt import renderer
from steeljax_torch.scene import builtin
from steeljax_torch.scene.flatten import FlatScene, flatten_scene

STATIC = ("light_count", "env_enabled", "env_analytic", "any_alpha_test",
          "any_alpha_blend", "has_textures", "source_tri_count")

SCENES = {
    "stress_tex": (lambda: builtin.make_stress_scene(8, 4, textured=True),
                   lambda: builtin_ref.make_stress_scene(8, 4,
                                                         textured=True)),
    "parity": (lambda: builtin.make_parity_scene(4),
               lambda: builtin_ref.make_parity_scene(4)),
}


def _assert_flat_equal(ours: FlatScene, ref):
    for field in dataclasses.fields(FlatScene):
        a = getattr(ours, field.name)
        b = getattr(ref, field.name)
        if field.name in STATIC:
            assert a == b, field.name
        else:
            np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b),
                                          err_msg=field.name)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_flatten_equal_with_texture_pool(name):
    ours = flatten_scene(SCENES[name][0](), "cpu")
    ref = flatten_ref(SCENES[name][1]())
    _assert_flat_equal(ours, ref)
    if name == "stress_tex":
        # The 256x256 brick texture and its 8 smaller mips, quad-packed.
        assert ours.has_textures
        assert ours.atlas.shape == (sum(4 ** k for k in range(9)), 16)
        assert ours.tex_size.tolist() == [[256, 256]]
    else:
        assert ours.light_count == 1 and not ours.has_textures


@pytest.mark.parametrize("name", sorted(SCENES))
def test_prepare_scene_equal(name):
    """prepare_scene: permuted arrays, tables and the shade rows (mode 2 on
    the textured scene, mode 1 on the parity scene) equal the reference's
    pallas-layout preparation."""
    flat, tables = renderer.prepare_scene(SCENES[name][0](), "cpu",
                                          env_resolution=16)
    flat_ref, tables_ref = renderer_ref.prepare_scene(
        SCENES[name][1](), env_resolution=16, use_pallas=True)
    _assert_flat_equal(flat, flat_ref)
    chunk, chunk_ref = tables.chunks[0], tables_ref.chunks[0]
    np.testing.assert_array_equal(chunk.bvh8.rows.numpy(),
                                  np.asarray(chunk_ref.bvh8.rows))
    np.testing.assert_array_equal(chunk.tris_packed.numpy(),
                                  np.asarray(chunk_ref.tris_packed))
    assert tables.shade_mode == tables_ref.shade_mode == (
        2 if name == "stress_tex" else 1)
    np.testing.assert_array_equal(chunk.shade_packed.numpy(),
                                  np.asarray(chunk_ref.shade_packed))
    if name == "stress_tex":
        assert flat.source_tri_count == 520


@pytest.mark.parametrize("name", sorted(SCENES))
def test_dense_anyhit_tables_equal(name, monkeypatch):
    """prepare_tables(dense_anyhit=True) builds the reference's
    STEELJAX_DENSE_ANYHIT=1 tables: pack_tris_dense rows and the
    supernode rows of the leaves re-aligned to 14."""
    flat = flatten_scene(SCENES[name][0](), "cpu")
    pos = flat.tri_pos.numpy()
    ds = flat.tri_double_sided.numpy()
    tables, order, padded = dispatch.prepare_tables(pos, ds, "cpu",
                                                    leaf_size=24,
                                                    dense_anyhit=True)
    monkeypatch.setenv("STEELJAX_DENSE_ANYHIT", "1")
    tables_ref, order_ref, padded_ref = dispatch_ref.prepare_tables(
        pos, ds, leaf_size=24, use_pallas=True)
    np.testing.assert_array_equal(order, order_ref)
    assert padded == padded_ref
    chunk, chunk_ref = tables.chunks[0], tables_ref.chunks[0]
    np.testing.assert_array_equal(chunk.anyhit_bvh8.rows.numpy(),
                                  np.asarray(chunk_ref.anyhit_bvh8.rows))
    assert chunk.anyhit_bvh8.depth == chunk_ref.anyhit_bvh8.depth
    assert chunk.anyhit_bvh8.max_leaf == chunk_ref.anyhit_bvh8.max_leaf
    np.testing.assert_array_equal(chunk.anyhit_tris.numpy(),
                                  np.asarray(chunk_ref.anyhit_tris))
    # Dense leaves start at multiples of 14 records.
    rows = chunk.anyhit_bvh8.rows.numpy().reshape(-1, 8, 16)
    leaf = rows[..., 7] > 0
    assert leaf.any() and (rows[..., 6][leaf] % 14 == 0).all()
    # Without the option no dense tables are built.
    plain, _, _ = dispatch.prepare_tables(pos, ds, "cpu", leaf_size=24)
    assert plain.chunks[0].anyhit_tris is None


def test_packers_equal_on_seeded_arrays():
    """pack_tris_dense and both shade-record modes, on seeded arrays of a
    size that is not a whole number of rows."""
    r = np.random.default_rng(3)
    n = 61
    pos = r.normal(size=(n, 3, 3)).astype(np.float32)
    nrm = r.normal(size=(n, 3, 3)).astype(np.float32)
    tan = r.normal(size=(n, 3, 3)).astype(np.float32)
    uv = r.uniform(size=(n, 3, 2)).astype(np.float32)
    mat = r.integers(0, 9, n).astype(np.int32)
    uvd = r.uniform(size=n).astype(np.float32)
    np.testing.assert_array_equal(cuda_traverse.pack_tris_dense(pos),
                                  ptv_ref.pack_tris_dense(pos))
    for textured in (False, True):
        for tri_uvd in (None, uvd):
            np.testing.assert_array_equal(
                cuda_traverse.pack_shade_records(
                    nrm, mat, textured, tri_tan=tan, tri_uv=uv,
                    tri_uvd=tri_uvd),
                ptv_ref.pack_shade_records(nrm, tan, uv, mat, textured,
                                           tri_uvd=tri_uvd))
    with pytest.raises(ValueError, match="tri_tan and tri_uv"):
        cuda_traverse.pack_shade_records(nrm, mat, True)


def test_from_jax_prepared_textured_gives_the_same_tables():
    """The reference's CPU preparation of the textured scene (no shade rows
    off the TPU) carried across: mode-2 rows equal the port's own."""
    flat_ref, tables_ref = renderer_ref.prepare_scene(
        SCENES["stress_tex"][1](), env_resolution=16)
    flat_c, tables_c = from_jax_prepared(flat_ref, tables_ref, "cpu")
    flat, tables = renderer.prepare_scene(SCENES["stress_tex"][0](), "cpu",
                                          env_resolution=16)
    assert tables_c.shade_mode == tables.shade_mode == 2
    np.testing.assert_array_equal(tables_c.chunks[0].shade_packed.numpy(),
                                  tables.chunks[0].shade_packed.numpy())
    np.testing.assert_array_equal(flat_c.atlas.numpy(), flat.atlas.numpy())
