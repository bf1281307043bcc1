"""The record tables the any-hit kernels K2 and K2-dense (csrc/alpha8.cu's
ANY policy without masks) read, and the launcher's checks that need no
card.

prepare_tables(dense_anyhit=True) derives a 48-byte Hopper record table
from the dense 14-record rows (pack_tris_dense) on the tables' device and
attaches it as `anyhit_records`; from_jax_prepared does the same for the
reference's dense rows.  It is held, record id for record id, to the dense
rows it came from (v0, e1, e2, a zero fourth float, the re-alignment's pad
records) and to the rows of the JAX package's own dense packer on the same
permuted positions (steeljax's prepare_tables and prepare_scene with
STEELJAX_DENSE_ANYHIT=1, on the CPU), on a seeded soup and on the Cornell
box.  The launcher refuses a record table whose length is not one record
for each record of the rows, flat or dense, before a kernel is built.
dispatch.trace_any hands each chunk's own table to the wrapper, and answers
as steeljax.accel.traverse.trace_any on the CPU (flags equal) on flat and
dense tables."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steeljax.accel import dispatch as dispatch_ref
from steeljax.accel import traverse as traverse_ref
from steeljax.core.constants import RAY_DEAD_T
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax_torch.accel import cuda_traverse, dispatch
from steeljax_torch.accel.bvh import DENSE_PER_ROW, DENSE_STRIDE
from steeljax_torch.apps import kernel_parity as kp
from steeljax_torch.convert import from_jax_prepared
from steeljax_torch.render.pt.renderer import prepare_scene
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401

N_TRIS, N_RAYS = 3000, 2048


@pytest.fixture(scope="module")
def soup(monkeypatch_module):
    """The soup's port tables with dense any-hit tables (kernel_parity's
    soup_case), the reference's on the same inputs with its dense tables
    (use_pallas=True, STEELJAX_DENSE_ANYHIT=1) and its CPU tables for the
    oracle, the permuted arrays and the rays."""
    tables, perm, o, d = kp.soup_case(N_TRIS, N_RAYS, "cpu",
                                      dense_anyhit=True)
    tris = kp._soup(N_TRIS, 1)
    ds = np.random.default_rng(2).uniform(size=N_TRIS) < 0.3
    monkeypatch_module.setenv("STEELJAX_DENSE_ANYHIT", "1")
    dense_ref, _, _ = dispatch_ref.prepare_tables(tris, ds, leaf_size=24,
                                                  use_pallas=True)
    oracle_ref, _, _ = dispatch_ref.prepare_tables(tris, ds, leaf_size=24,
                                                   use_pallas=False)
    return tables, dense_ref, oracle_ref, perm, o, d


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module")
def cornell(monkeypatch_module):
    """The Cornell box prepared by the port with dense any-hit tables, and
    by the reference with its dense tables, converted for the port."""
    _, tables = prepare_scene(builtin.make_cornell_scene(4), "cpu",
                              env_resolution=8, dense_anyhit=True)
    monkeypatch_module.setenv("STEELJAX_DENSE_ANYHIT", "1")
    flat_ref, tables_ref = renderer_ref.prepare_scene(
        builtin_ref.make_cornell_scene(4), env_resolution=8,
        use_pallas=True)
    _, converted = from_jax_prepared(flat_ref, tables_ref, "cpu")
    return tables, tables_ref, converted


def _dense_records(rows: np.ndarray) -> np.ndarray:
    """The (R * 14, 9) records of (R, 128) dense rows."""
    return rows[:, :DENSE_PER_ROW * DENSE_STRIDE].reshape(-1, DENSE_STRIDE)


def _assert_dense_table(records: torch.Tensor, rows: np.ndarray) -> None:
    """Record k of the table is record k of the dense rows: [v0, 0] [e1, 0]
    [e2, 0] as three float4s, contiguous and 16-byte aligned."""
    assert records.dtype == torch.float32 and records.is_contiguous()
    assert records.data_ptr() % 16 == 0
    ref = _dense_records(rows)
    f4 = records.numpy().reshape(-1, 3, 4)
    assert f4.shape[0] == ref.shape[0] == rows.shape[0] * DENSE_PER_ROW
    np.testing.assert_array_equal(f4[:, 0, :3], ref[:, 0:3])  # v0
    np.testing.assert_array_equal(f4[:, 1, :3], ref[:, 3:6])  # e1
    np.testing.assert_array_equal(f4[:, 2, :3], ref[:, 6:9])  # e2
    np.testing.assert_array_equal(f4[:, :, 3], 0.0)


def test_dense_records_of_prepare_tables(soup):
    """prepare_tables' dense table against the dense rows it came from,
    with the re-alignment's pad records (v0 3e37, zero edges) and the
    last row's zero padding in their places."""
    tables = soup[0]
    chunk = tables.chunks[0]
    rows = chunk.anyhit_tris.numpy()
    _assert_dense_table(chunk.anyhit_records, rows)
    leaves = chunk.anyhit_bvh8.rows.numpy().reshape(-1, 8, 16)
    leaf = leaves[..., 7] > 0
    starts = leaves[..., 6][leaf].astype(np.int64)
    assert (starts % DENSE_PER_ROW == 0).all()
    rec = _dense_records(rows)
    pads = rec[:, 0] == np.float32(3.0e37)
    assert pads.any() and (rec[pads, 3:9] == 0.0).all()
    f4 = chunk.anyhit_records.numpy().reshape(-1, 3, 4)
    assert (f4[pads, 0, :3] == np.float32(3.0e37)).all()


def test_dense_records_match_the_reference_rows(soup):
    """The port's dense rows equal the JAX package's (its own
    pack_tris_dense on the same permuted positions), and the table derived
    from the reference's rows is the port's, record for record."""
    tables, dense_ref = soup[0], soup[1]
    chunk, chunk_ref = tables.chunks[0], dense_ref.chunks[0]
    ref_rows = np.array(chunk_ref.anyhit_tris)
    np.testing.assert_array_equal(chunk.anyhit_tris.numpy(), ref_rows)
    np.testing.assert_array_equal(chunk.anyhit_bvh8.rows.numpy(),
                                  np.asarray(chunk_ref.anyhit_bvh8.rows))
    _assert_dense_table(chunk.anyhit_records, ref_rows)
    assert torch.equal(chunk.anyhit_records, cuda_traverse.hopper_records(
        torch.from_numpy(ref_rows), dense=True))


def test_cornell_dense_records_match_the_reference(cornell):
    """On the Cornell box: the port's own dense tables, the reference's
    converted by from_jax_prepared and the reference's rows give one record
    table."""
    tables, tables_ref, converted = cornell
    chunk, chunk_conv = tables.chunks[0], converted.chunks[0]
    ref_rows = np.asarray(tables_ref.chunks[0].anyhit_tris)
    np.testing.assert_array_equal(chunk.anyhit_tris.numpy(), ref_rows)
    _assert_dense_table(chunk.anyhit_records, ref_rows)
    _assert_dense_table(chunk_conv.anyhit_records, ref_rows)
    assert torch.equal(chunk.anyhit_records, chunk_conv.anyhit_records)


def test_from_jax_prepared_carries_no_dense_table_without_dense_rows(
        monkeypatch):
    """A reference preparation without dense rows converts to a chunk
    without a dense record table; the flat table is there."""
    monkeypatch.delenv("STEELJAX_DENSE_ANYHIT", raising=False)
    flat_ref, tables_ref = renderer_ref.prepare_scene(
        builtin_ref.make_cornell_scene(4), env_resolution=8,
        use_pallas=True)
    assert tables_ref.chunks[0].anyhit_tris is None
    _, tables = from_jax_prepared(flat_ref, tables_ref, "cpu")
    chunk = tables.chunks[0]
    assert chunk.anyhit_tris is None and chunk.anyhit_records is None
    assert chunk.tri_records is not None


def _rays(n=16):
    r = np.random.default_rng(7)
    o = torch.from_numpy(r.normal(size=(n, 3)).astype(np.float32))
    d = torch.from_numpy(r.normal(size=(n, 3)).astype(np.float32))
    return o, d


@pytest.mark.parametrize("dense", [False, True], ids=["flat", "dense"])
@pytest.mark.parametrize("change", ["short", "long", "other_layout"])
def test_anyhit_launcher_refuses_records_of_another_length(soup, dense,
                                                           change):
    """One Hopper record for each record of the rows, 12 or 14 a row: a
    table a record short or long, or the other layout's table, is refused
    before a kernel is built."""
    chunk = soup[0].chunks[0]
    bvh8, tris, records = ((chunk.anyhit_bvh8, chunk.anyhit_tris,
                            chunk.anyhit_records) if dense
                           else (chunk.bvh8, chunk.tris_packed,
                                 chunk.tri_records))
    per_row = DENSE_PER_ROW if dense else cuda_traverse.TRI_PER_ROW
    assert records.shape[0] == tris.shape[0] * per_row
    if change == "short":
        records = records[:-1]
    elif change == "long":
        records = torch.cat([records, records[:1]])
    else:
        records = chunk.tri_records if dense else chunk.anyhit_records
        assert records.shape[0] != tris.shape[0] * per_row
    before = dict(cuda_traverse.LAUNCHES)
    with pytest.raises(ValueError, match="records"):
        cuda_traverse.anyhit_launcher(bvh8, tris, *_rays(), 0.001, 40.0,
                                      dense=dense, records=records)
    assert cuda_traverse.LAUNCHES == before


@pytest.mark.parametrize("dense", [False, True], ids=["flat", "dense"])
def test_anyhit_launcher_raises_on_cpu_tensors(soup, dense):
    """A CPU tensor reaches the plain version through the wrapper, never
    the launcher: with a table of the right length it raises rather than
    fall back."""
    chunk = soup[0].chunks[0]
    args = ((chunk.anyhit_bvh8, chunk.anyhit_tris) if dense
            else (chunk.bvh8, chunk.tris_packed))
    records = chunk.anyhit_records if dense else chunk.tri_records
    with pytest.raises(ValueError, match="CUDA"):
        cuda_traverse.anyhit_launcher(*args, *_rays(), 0.001, 40.0,
                                      dense=dense, records=records)


@pytest.mark.parametrize("dense", [False, True], ids=["flat", "dense"])
def test_trace_any_passes_the_chunk_records(soup, monkeypatch, dense):
    """dispatch.trace_any hands the wrapper the chunk's own record table of
    the rows it traces, so a frame never derives one per call."""
    tables = soup[0]
    chunk = tables.chunks[0]
    if not dense:
        chunk = chunk.replace(anyhit_bvh8=None, anyhit_tris=None,
                              anyhit_records=None)
        tables = tables.replace(chunks=(chunk,))
    seen = {}

    def spy(bvh8, tris, *args, **kwargs):
        seen.update(kwargs, tris=tris)
        return torch.zeros(args[0].shape[0], dtype=torch.bool)

    monkeypatch.setattr(cuda_traverse, "trace_any_bvh8", spy)
    dispatch.trace_any(tables, *_rays(), 0.001, 40.0)
    if dense:
        assert seen["records"] is chunk.anyhit_records
        assert seen["tris"] is chunk.anyhit_tris and seen["dense"]
    else:
        assert seen["records"] is chunk.tri_records
        assert seen["tris"] is chunk.tris_packed


@pytest.mark.parametrize("dense", [False, True], ids=["flat", "dense"])
def test_trace_any_matches_the_reference(soup, dense):
    """dispatch.trace_any on the port's tables against the reference's CPU
    oracle (steeljax.accel.traverse.trace_any) on the same permuted
    triangles: every flag equal, with finite cut-offs and a quarter of the
    rays dead (t_max = RAY_DEAD_T, never occluded)."""
    tables, _, oracle_ref, perm, o, d = soup
    if not dense:
        chunk = tables.chunks[0]
        tables = tables.replace(chunks=(chunk.replace(
            anyhit_bvh8=None, anyhit_tris=None, anyhit_records=None),))
    r = np.random.default_rng(11)
    t_max = r.uniform(0.5, 30.0, N_RAYS).astype(np.float32)
    dead = r.uniform(size=N_RAYS) < 0.25
    t_max[dead] = RAY_DEAD_T
    t_min = np.full(N_RAYS, 0.001, np.float32)
    occ_ref = np.asarray(traverse_ref.trace_any(
        oracle_ref.bvh, jnp.asarray(perm["pos"]), jnp.asarray(perm["ds"]),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
        jnp.asarray(t_max)))
    occ = dispatch.trace_any(tables, torch.from_numpy(o),
                             torch.from_numpy(d), torch.from_numpy(t_min),
                             torch.from_numpy(t_max))
    assert occ.dtype == torch.bool and occ.shape == (N_RAYS,)
    np.testing.assert_array_equal(occ.numpy(), occ_ref)
    assert not occ.numpy()[dead].any()
    assert N_RAYS // 16 < int(occ.sum()) < int((~dead).sum())
