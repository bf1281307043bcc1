"""The port's alpha-coverage masks and their packing against the reference
on the CPU: compute_alpha_masks and compute_fine_masks give the reference's
masks bit for bit (both leaf textures, wrapped uvs, and the degenerate
materials: no cutoff, zero alpha factor, a cutoff no texel reaches, no
texture, no ALPHA_TEST flag); mask_test and fine_mask_test equal their jnp
counterparts, cell boundaries and the u + v > 1 edge included; pack_tris
with masks and pack_fine_mask_rows give the reference's rows; and
prepare_tables threads the masks through the BVH permutation as the
reference does."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax.accel import alphamask as alphamask_ref
from steeljax.accel import dispatch as dispatch_ref
from steeljax.accel import pallas_traverse as ptv_ref
from steeljax.scene import builtin as builtin_ref
from steeljax.scene.material import MaterialFlags
from steeljax_torch.accel import alphamask, cuda_traverse
from steeljax_torch.accel.bvh import TRI_PER_ROW
from steeljax_torch.accel.dispatch import prepare_tables
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401


N_TRIS = 3000


def _materials():
    """Material arrays (base colour, params, texture ids, flags) of seven
    materials: 0 and 1 alpha-tested with textures 0 and 1, 2 with a cutoff
    of 0, 3 with alpha factor 0, 4 with a cutoff above the factor, 5
    alpha-tested without a texture, 6 textured but not alpha-tested."""
    m = 7
    base = np.ones((m, 4), np.float32)
    params = np.tile(np.array([0.8, 0.0, 1.0, 1.0, 0.5], np.float32), (m, 1))
    tex = np.full((m, 5), -1, np.int32)
    flags = np.full(m, int(MaterialFlags.ALPHA_TEST
                           | MaterialFlags.DOUBLE_SIDED), np.int32)
    tex[[0, 2, 3, 4, 6], 0] = [0, 0, 1, 0, 1]
    tex[1, 0] = 1
    base[1, 3] = 0.8          # cutoff 0.5 / 0.8
    params[2, 4] = 0.0
    base[3, 3] = 0.0
    base[4, 3] = 0.4          # 0.5 / 0.4 > 1: no texel reaches it
    flags[6] = int(MaterialFlags.DOUBLE_SIDED)
    return base, params, tex, flags


def _mask_inputs(seed=0):
    r = np.random.default_rng(seed)
    # Per-vertex uvs, some of them wrapping past [0, 1].
    uv = r.uniform(-0.3, 1.3, (N_TRIS, 3, 2)).astype(np.float32)
    mat = r.integers(0, 7, N_TRIS).astype(np.int32)
    return uv, mat


@pytest.mark.parametrize("serrated", [True, False],
                         ids=["serrated", "solid"])
def test_masks_equal_reference(serrated):
    """Texture 0 is the leaf of the given kind, texture 1 the other kind;
    the foliage scene's own cards are included."""
    textures = [builtin._leaf_texture(serrated=serrated),
                builtin._leaf_texture(serrated=not serrated)]
    np.testing.assert_array_equal(
        textures[0], builtin_ref._leaf_texture(serrated=serrated))
    uv, mat = _mask_inputs()
    scene = builtin.make_foliage_scene(cards=200, serrated=serrated)
    card_uv = np.asarray(scene.primitives[0].tex_coords)[
        np.asarray(scene.primitives[0].indices).reshape(-1, 3)]
    uv = np.concatenate([uv, card_uv])
    mat = np.concatenate([mat, np.zeros(len(card_uv), np.int32)])
    args = (uv, mat, *_materials(), textures)
    coarse = alphamask.compute_alpha_masks(*args, device="cpu")
    fine = alphamask.compute_fine_masks(*args, device="cpu")
    np.testing.assert_array_equal(coarse,
                                  alphamask_ref.compute_alpha_masks(*args))
    np.testing.assert_array_equal(fine,
                                  alphamask_ref.compute_fine_masks(*args))
    # Every kind of mask occurs: full, empty and partial.
    assert (coarse == alphamask.MASK_FULL).any() and (coarse == 0).any()
    assert ((coarse != 0) & (coarse != alphamask.MASK_FULL)).any()
    # Degenerate materials: all-ones for no cutoff, no texture or no flag;
    # zero where no texel can reach the cutoff.
    for m in (2, 5, 6):
        assert (coarse[mat == m] == alphamask.MASK_FULL).all()
        assert (fine[mat == m] == -1).all()
    for m in (3, 4):
        assert (coarse[mat == m] == 0).all() and (fine[mat == m] == 0).all()


def test_masks_without_textures_are_full():
    uv, mat = _mask_inputs(1)
    args = (uv, mat, *_materials(), [])
    assert (alphamask.compute_alpha_masks(*args, device="cpu")
            == alphamask.MASK_FULL).all()
    assert (alphamask.compute_fine_masks(*args, device="cpu") == -1).all()


def test_mask_tests_equal_reference():
    r = np.random.default_rng(2)
    n = 20000
    u = r.uniform(0, 1, n).astype(np.float32)
    v = r.uniform(0, 1, n).astype(np.float32)
    # Exact cell boundaries of both grids, and the u + v > 1 edge.
    k = np.arange(n) % 18
    u[:2000] = (k[:2000] / 17.0).astype(np.float32)
    v[2000:4000] = (k[2000:4000] % 7 / 6.0).astype(np.float32)
    u[4000:6000] = np.nextafter(1.0 - v[4000:6000], 2.0)
    masks = r.integers(0, alphamask.MASK_FULL + 1, n).astype(np.int32)
    words = r.integers(-(1 << 31), 1 << 31, (n, alphamask.FINE_STRIDE),
                       dtype=np.int64).astype(np.int32)
    ut, vt = torch.from_numpy(u), torch.from_numpy(v)
    keep = alphamask.mask_test(torch.from_numpy(masks), ut, vt)
    keep_ref = alphamask_ref.mask_test(jnp.asarray(masks), jnp.asarray(u),
                                       jnp.asarray(v))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_ref))
    fk, fo = alphamask.fine_mask_test(torch.from_numpy(words), ut, vt)
    fk_ref, fo_ref = alphamask_ref.fine_mask_test(
        jnp.asarray(words), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_array_equal(fk.numpy(), np.asarray(fk_ref))
    np.testing.assert_array_equal(fo.numpy(), np.asarray(fo_ref))
    assert 0 < keep.sum() < n and 0 < fo.sum() < fk.sum() < n
    cell, in_dom = alphamask.fine_cell(ut, vt)
    cell_ref, in_dom_ref = alphamask_ref.fine_cell(jnp.asarray(u),
                                                   jnp.asarray(v))
    np.testing.assert_array_equal(cell.numpy(), np.asarray(cell_ref))
    np.testing.assert_array_equal(in_dom.numpy(), np.asarray(in_dom_ref))
    assert (~in_dom).any()


def test_packed_rows_equal_reference():
    r = np.random.default_rng(3)
    t = 1001  # not a whole number of rows
    pos = r.normal(size=(t, 3, 3)).astype(np.float32)
    ds = r.uniform(size=t) < 0.4
    mask = r.integers(0, alphamask.MASK_FULL + 1, t).astype(np.uint32)
    fine = r.integers(-(1 << 31), 1 << 31, (t, alphamask.FINE_STRIDE),
                      dtype=np.int64).astype(np.int32)
    packed = cuda_traverse.pack_tris(pos, ds, tri_alpha_mask=mask)
    np.testing.assert_array_equal(
        packed, ptv_ref.pack_tris(pos, ds, tri_alpha_mask=mask))
    # The AUX word is exact: ds | mask << 1.
    aux = packed[:, :TRI_PER_ROW * 10].reshape(-1, 10)[:t, 9]
    np.testing.assert_array_equal(aux.astype(np.int64),
                                  ds.astype(np.int64) | (mask.astype(
                                      np.int64) << 1))
    np.testing.assert_array_equal(cuda_traverse.pack_tris(pos, ds),
                                  ptv_ref.pack_tris(pos, ds))
    rows = cuda_traverse.pack_fine_mask_rows(fine)
    np.testing.assert_array_equal(rows, ptv_ref.pack_fine_mask_rows(fine))
    assert rows.dtype == np.int32 and rows.shape == (-(-t // 12), 128)


def test_prepare_tables_threads_masks_like_reference():
    """Coarse masks and fine rows follow the BVH permutation (the
    reference's TPU tables, use_pallas=True, also hold fine rows); all-full
    masks are dropped; masked tables get no dense any-hit tables."""
    r = np.random.default_rng(4)
    tris = r.uniform(-1, 1, (40, 3, 3)).astype(np.float32)
    ds = np.ones(40, bool)
    coarse = r.integers(0, 1 << 21, 40).astype(np.uint32)
    fine = r.integers(-(1 << 31), 1 << 31, (40, alphamask.FINE_STRIDE),
                      dtype=np.int64).astype(np.int32)
    ours, order, padded = prepare_tables(tris, ds, "cpu", leaf_size=12,
                                         dense_anyhit=True,
                                         tri_alpha_mask=coarse,
                                         tri_fine_mask=fine)
    ref, order_ref, _ = dispatch_ref.prepare_tables(
        tris, ds, leaf_size=12, use_pallas=True, tri_alpha_mask=coarse,
        tri_fine_mask=fine)
    np.testing.assert_array_equal(order, order_ref)
    chunk, chunk_ref = ours.chunks[0], ref.chunks[0]
    assert ours.alpha_masked and ref.alpha_masked
    np.testing.assert_array_equal(chunk.tris_packed.numpy(),
                                  np.asarray(chunk_ref.tris_packed))
    np.testing.assert_array_equal(chunk.fine_mask_rows.numpy(),
                                  np.asarray(chunk_ref.fine_mask_rows))
    np.testing.assert_array_equal(chunk.tri_mask.numpy(),
                                  np.asarray(chunk_ref.tri_mask).astype(
                                      np.int32))
    assert chunk.anyhit_tris is None
    assert chunk.fine_mask_rows.shape == (padded // TRI_PER_ROW, 128)

    full = np.full(40, alphamask.MASK_FULL, np.uint32)
    plain, _, _ = prepare_tables(tris, ds, "cpu", leaf_size=12,
                                 tri_alpha_mask=full, tri_fine_mask=fine)
    assert not plain.alpha_masked
    assert plain.chunks[0].tri_mask is None
    assert plain.chunks[0].fine_mask_rows is None
    coarse_only, _, _ = prepare_tables(tris, ds, "cpu", leaf_size=12,
                                       tri_alpha_mask=coarse)
    assert coarse_only.alpha_masked
    assert coarse_only.chunks[0].fine_mask_rows is None
