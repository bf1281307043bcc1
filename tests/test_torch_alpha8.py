"""The CPU side of csrc/alpha8.cu, the alpha-masked kernels K4 and K5: the
Hopper record table that prepare_tables derives from the reference's rows,
and the launcher's checks that need no card.

hopper_records is held, for every record id, to the reference's packed
triangle rows (steeljax's prepare_tables on the same inputs) on the soups
of test_torch_alpha_trace.py (no masks, coarse masks,
coarse and fine masks), and to the triangle arrays of a small foliage scene
prepared through the port's prepare_scene: record k is [v0.xyz, f9],
[e1.xyz, 0], [e2.xyz, 0], f9 the reference record's last float (ds | mask
<< 1 in masked tables), pad records zero.  The launcher's checks: the
per-thread stack against the tree's depth, K outside {2, 4, 8}, a record
table of the wrong shape, K4 without masks, and CPU tensors, each refused
before a kernel is built."""

import numpy as np
import pytest
import torch

from steeljax.accel import dispatch as dispatch_ref
from steeljax_torch.accel import cuda_traverse
from steeljax_torch.accel.bvh import BVH8
from steeljax_torch.accel.dispatch import prepare_tables
from steeljax_torch.apps import kernel_parity as kp
from steeljax_torch.render.pt.renderer import prepare_scene
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401


N_TRIS = 3000


def _reference_records(rows: np.ndarray) -> np.ndarray:
    """(R * 12, 10) records of (R, 128) packed triangle rows."""
    return rows[:, :120].reshape(-1, 10)


def _assert_records(records: torch.Tensor, rows: np.ndarray) -> None:
    """Every record of `records` against record k of the reference rows."""
    ref = _reference_records(rows)
    got = records.numpy()
    assert got.shape == (ref.shape[0], cuda_traverse.HOPPER_RECORD)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 0:3], ref[:, 0:3])   # v0
    np.testing.assert_array_equal(got[:, 3], ref[:, 9])       # AUX / ds
    np.testing.assert_array_equal(got[:, 4:7], ref[:, 3:6])   # e1
    np.testing.assert_array_equal(got[:, 8:11], ref[:, 6:9])  # e2
    np.testing.assert_array_equal(got[:, 7], 0.0)
    np.testing.assert_array_equal(got[:, 11], 0.0)


@pytest.mark.parametrize("masks", ["none", "coarse", "fine"])
def test_hopper_records_match_reference_rows(masks):
    """The soup's tables against the reference's (steeljax's prepare_tables
    with use_pallas=True) on the same inputs: the rows are equal, and every
    record of the derived table holds its row record's floats."""
    tris, ds, coarse, fine = kp.alpha_soup_inputs(N_TRIS, masks == "fine")
    if masks == "none":
        coarse = None
    ours, order, _ = prepare_tables(tris, ds, "cpu", leaf_size=24,
                                    tri_alpha_mask=coarse, tri_fine_mask=fine)
    ref, order_ref, _ = dispatch_ref.prepare_tables(
        tris, ds, leaf_size=24, use_pallas=True, tri_alpha_mask=coarse,
        tri_fine_mask=fine)
    np.testing.assert_array_equal(order, order_ref)
    chunk = ours.chunks[0]
    rows = np.asarray(ref.chunks[0].tris_packed)
    np.testing.assert_array_equal(chunk.tris_packed.numpy(), rows)
    records = chunk.tri_records  # every flat chunk carries one
    if masks != "none":
        # The AUX word of every real record decodes to ds | mask << 1.
        real = order >= 0
        aux = records[:len(order)][torch.from_numpy(real), 3]
        np.testing.assert_array_equal(
            aux.numpy().astype(np.int64),
            ds[order[real]].astype(np.int64)
            | (coarse[order[real]].astype(np.int64) << 1))
    _assert_records(records, rows)


def test_hopper_records_of_a_foliage_scene():
    """prepare_scene's records against the scene's permuted triangles: v0,
    e1 = v1 - v0, e2 = v2 - v0 and the AUX word, for every record id."""
    scene = builtin.make_foliage_scene(cards=60, region=2.0)
    flat, tables = prepare_scene(scene, "cpu", env_resolution=8)
    chunk = tables.chunks[0]
    assert tables.alpha_masked and chunk.fine_mask_rows is not None
    records = chunk.tri_records.numpy()
    pos = flat.tri_pos.numpy()
    t = pos.shape[0]
    assert records.shape == (chunk.tris_packed.shape[0] * 12,
                             cuda_traverse.HOPPER_RECORD)
    np.testing.assert_array_equal(records[:t, 0:3], pos[:, 0])
    np.testing.assert_array_equal(records[:t, 4:7], pos[:, 1] - pos[:, 0])
    np.testing.assert_array_equal(records[:t, 8:11], pos[:, 2] - pos[:, 0])
    aux = (flat.tri_double_sided.numpy().astype(np.int64)
           | (chunk.tri_mask.numpy().astype(np.int64) << 1))
    np.testing.assert_array_equal(records[:t, 3].astype(np.int64), aux)
    np.testing.assert_array_equal(records[t:], 0.0)
    _assert_records(chunk.tri_records, chunk.tris_packed.numpy())


@pytest.fixture(scope="module")
def masked():
    """A fine-masked soup and 64 of its rays, on the CPU."""
    tables, _ = kp.alpha_soup_case(600, "cpu", fine=True)
    _, _, o, d = kp.soup_case(600, 64, "cpu")
    return tables.chunks[0], torch.from_numpy(o), torch.from_numpy(d)


def _launch(chunk, o, d, query="nearest", bvh8=None, k_hits=4, **kw):
    """The launcher of `query` ("nearest" K4, "any" K4_anyhit, "multihit"
    K5) over the masked chunk."""
    kw.setdefault("alpha_mask", True)
    kw.setdefault("fine_rows", chunk.fine_mask_rows)
    kw.setdefault("records", chunk.tri_records)
    args = (bvh8 or chunk.bvh8, chunk.tris_packed, o, d, 0.001, 1000.0)
    if query == "nearest":
        return cuda_traverse.kernel_launcher(*args, **kw)
    if query == "any":
        return cuda_traverse.anyhit_launcher(*args, **kw)
    return cuda_traverse.multihit_launcher(*args, k_hits, **kw)


@pytest.mark.parametrize("query", ["nearest", "any", "multihit"])
@pytest.mark.parametrize("depth", [31, 80])
def test_launcher_refuses_a_tree_too_deep(masked, query, depth):
    """Each thread's stack holds MAX_STACK entries, enough for the
    reference's bound 8 * depth + 16 up to depth 30; a deeper tree is
    refused before a kernel is built."""
    chunk, o, d = masked
    assert 8 * 30 + 16 == cuda_traverse.MAX_STACK
    deep = BVH8(rows=chunk.bvh8.rows, depth=depth,
                max_leaf=chunk.bvh8.max_leaf)
    with pytest.raises(ValueError, match="stack"):
        _launch(chunk, o, d, query, bvh8=deep)


@pytest.mark.parametrize("k", [0, 1, 3, 16])
def test_multihit_launcher_refuses_slot_counts(masked, k):
    chunk, o, d = masked
    with pytest.raises(ValueError, match="K in"):
        cuda_traverse.multihit_launcher(
            chunk.bvh8, chunk.tris_packed, o, d, 0.001, 1000.0, k,
            alpha_mask=True, fine_rows=chunk.fine_mask_rows,
            records=chunk.tri_records)
    with pytest.raises(ValueError, match="K in"):
        _launch(chunk, o, d, "multihit", k_hits=k)


@pytest.mark.parametrize("shape", [(0, 12), (100, 12), (None, 10)])
def test_launcher_refuses_records_of_another_shape(masked, shape):
    chunk, o, d = masked
    rows = chunk.tri_records.shape[0] if shape[0] is None else shape[0]
    with pytest.raises(ValueError, match="records"):
        _launch(chunk, o, d, records=torch.zeros((rows, shape[1])))


def test_k4_launcher_needs_masks(masked):
    """K4's queries apply masks: without alpha_mask the nearest launcher is
    K1 and the any-hit launcher K2, and neither takes fine mask planes."""
    chunk, o, d = masked
    for query in ("nearest", "any"):
        with pytest.raises(ValueError, match="alpha_mask"):
            _launch(chunk, o, d, query, alpha_mask=False)


@pytest.mark.parametrize("query", ["nearest", "any", "multihit"])
def test_launcher_raises_on_cpu_tensors(masked, query):
    """A CPU tensor reaches the plain version through the wrapper, never
    the launcher: the launcher raises rather than fall back."""
    chunk, o, d = masked
    with pytest.raises(ValueError, match="CUDA"):
        _launch(chunk, o, d, query, k_hits=4)
