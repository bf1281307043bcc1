"""The record table the nearest kernels K1 and K3 (csrc/alpha8.cu, the
NEAREST walk without masks) read on flat scenes, and the launcher's checks
that need no card.

prepare_tables derives the 48-byte Hopper record table for every flat chunk
(not only alpha-masked ones) on the tables' device.  It is held, for every
record id, against the port's reference-format rows and against the
reference's own packer (steeljax's pack_tris) on the prepared scene's
permuted triangles, through 16-byte (float4) views: the Cornell box, the
sunlit stress scene (a sun) and the textured stress scene, at small sizes;
their shade rows (shade modes 1 and 2), which K1 and K3 read once per ray,
against the reference's pack_shade_records.  from_jax_prepared carries the
record table for scenes without masks; the render path's trace passes the
chunk's table to the kernel wrapper; and the launcher refuses record tables
of another shape and CPU tensors before a kernel is built."""

import numpy as np
import pytest
import torch

from steeljax.accel import pallas_traverse as ptv_ref
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax_torch.accel import cuda_traverse, dispatch
from steeljax_torch.convert import from_jax_prepared
from steeljax_torch.render.pt.renderer import prepare_scene
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401

SCENES = {
    "cornell": lambda: builtin.make_cornell_scene(4),
    "sunlit": lambda: builtin.make_sunlit_stress_scene(4, 4),
    "stress_tex": lambda: builtin.make_stress_scene(8, 4, textured=True),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def prepared(request):
    """(name, flat, tables) of a scene prepared on the CPU."""
    flat, tables = prepare_scene(SCENES[request.param](), "cpu",
                                 env_resolution=8)
    return request.param, flat, tables


def _float4(table: torch.Tensor, per_record: int) -> np.ndarray:
    """The (K, per_record, 4) float4 view the kernels read: contiguous,
    16-byte aligned, one record after another."""
    assert table.dtype == torch.float32 and table.is_contiguous()
    assert table.data_ptr() % 16 == 0
    return table.numpy().reshape(-1, per_record, 4)


def _records(rows: np.ndarray, per_row: int, stride: int) -> np.ndarray:
    """The (R * per_row, stride) records of (R, 128) reference rows."""
    return rows[:, :per_row * stride].reshape(-1, stride)


def test_tri_records_of_every_flat_chunk(prepared):
    """prepare_tables' Hopper records: R * TRI_PER_ROW records of three
    float4s [v0.xyz, ds] [e1.xyz, 0] [e2.xyz, 0], equal, column for column,
    to the port's triangle rows and to the reference's pack_tris of the
    permuted triangles."""
    name, flat, tables = prepared
    chunk = tables.chunks[0]
    assert not tables.alpha_masked
    rows = chunk.tris_packed.numpy()
    ref_rows = ptv_ref.pack_tris(flat.tri_pos.numpy(),
                                 flat.tri_double_sided.numpy())
    np.testing.assert_array_equal(rows, ref_rows)
    assert chunk.tri_records.shape == (
        rows.shape[0] * cuda_traverse.TRI_PER_ROW,
        cuda_traverse.HOPPER_RECORD)
    f4 = _float4(chunk.tri_records, 3)
    for source in (rows, ref_rows):
        ref = _records(source, cuda_traverse.TRI_PER_ROW,
                       cuda_traverse.TRI_STRIDE)
        np.testing.assert_array_equal(f4[:, 0, :3], ref[:, 0:3])  # v0
        np.testing.assert_array_equal(f4[:, 0, 3], ref[:, 9])     # ds
        np.testing.assert_array_equal(f4[:, 1, :3], ref[:, 3:6])  # e1
        np.testing.assert_array_equal(f4[:, 2, :3], ref[:, 6:9])  # e2
    np.testing.assert_array_equal(f4[:, 1:, 3], 0.0)
    # Every real triangle's double-sided flag, 0 or 1.
    t = flat.tri_pos.shape[0]
    np.testing.assert_array_equal(
        f4[:t, 0, 3], flat.tri_double_sided.numpy().astype(np.float32))


def test_shade_rows_of_every_flat_chunk(prepared):
    """The shade rows K1 and K3 read the winner's record from are the
    reference's pack_shade_records rows of the tables' mode (1 on the
    untextured scenes, 2 on the textured one), three rows a triangle row in
    mode 2."""
    name, flat, tables = prepared
    chunk = tables.chunks[0]
    mode = tables.shade_mode
    assert mode == (2 if name == "stress_tex" else 1)
    ref_rows = ptv_ref.pack_shade_records(
        flat.tri_nrm.numpy(), flat.tri_tan.numpy(), flat.tri_uv.numpy(),
        flat.tri_mat.numpy(), mode == 2,
        tri_uvd=flat.tri_shade.numpy()[:, 27])
    np.testing.assert_array_equal(chunk.shade_packed.numpy(), ref_rows)
    assert chunk.shade_packed.shape[0] == (
        chunk.tris_packed.shape[0] * (3 if mode == 2 else 1))


@pytest.mark.parametrize("name", ["cornell", "stress_tex"])
def test_from_jax_prepared_carries_the_tables(name):
    """The reference's preparation converted for the port carries the
    Hopper records of a scene without masks, equal to the port's own
    derivation from the converted rows."""
    make = {"cornell": lambda: builtin_ref.make_cornell_scene(4),
            "stress_tex": lambda: builtin_ref.make_stress_scene(
                8, 4, textured=True)}[name]
    flat_ref, tables_ref = renderer_ref.prepare_scene(make(),
                                                      env_resolution=8,
                                                      use_pallas=True)
    _, tables = from_jax_prepared(flat_ref, tables_ref, "cpu")
    chunk = tables.chunks[0]
    assert not tables.alpha_masked
    assert torch.equal(chunk.tri_records,
                       cuda_traverse.hopper_records(chunk.tris_packed))
    assert chunk.shade_packed is not None and tables.shade_mode == (
        2 if name == "stress_tex" else 1)


def test_trace_passes_the_chunk_tables(prepared, monkeypatch):
    """dispatch.trace_nearest hands the chunk's own record table and shade
    rows to the kernel wrapper, so a frame never derives the table per
    call."""
    _, _, tables = prepared
    chunk = tables.chunks[0]
    seen = {}

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return {}

    monkeypatch.setattr(cuda_traverse, "trace_nearest_bvh8", spy)
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3).contiguous()
    dispatch.trace_nearest(tables, o, d, 0.001, 100.0)
    assert seen["records"] is chunk.tri_records
    assert seen["shade_rows"] is chunk.shade_packed
    assert seen["shade_mode"] == tables.shade_mode


def _launch(tables, o, d, **kw):
    chunk = tables.chunks[0]
    kw.setdefault("records", chunk.tri_records)
    return cuda_traverse.kernel_launcher(
        chunk.bvh8, chunk.tris_packed, o, d, 0.001, 1000.0, True,
        chunk.shade_packed, tables.shade_mode, **kw)


def _rays(n=16):
    r = np.random.default_rng(7)
    o = torch.from_numpy(r.normal(size=(n, 3)).astype(np.float32))
    d = torch.from_numpy(r.normal(size=(n, 3)).astype(np.float32))
    return o, d


@pytest.mark.parametrize("shape", [(0, 12), (100, 12), (None, 10)])
def test_launcher_refuses_records_of_another_shape(prepared, shape):
    _, _, tables = prepared
    rows = tables.chunks[0].tri_records.shape[0] if shape[0] is None \
        else shape[0]
    with pytest.raises(ValueError, match="records"):
        _launch(tables, *_rays(), records=torch.zeros((rows, shape[1])))


def test_launcher_refuses_shade_rows_of_another_shape(prepared):
    """Shade rows short of the triangle rows (mode 2: three a row) are
    refused before a kernel is built."""
    _, _, tables = prepared
    chunk = tables.chunks[0]
    with pytest.raises(ValueError, match="shade_rows"):
        cuda_traverse.kernel_launcher(
            chunk.bvh8, chunk.tris_packed, *_rays(), 0.001, 1000.0, True,
            chunk.shade_packed[:-1], tables.shade_mode,
            records=chunk.tri_records)


@pytest.mark.parametrize("shade_mode", [0, None])
def test_launcher_raises_on_cpu_tensors(prepared, shade_mode):
    """A CPU tensor reaches the plain version through the wrapper, never
    the launcher: the launcher raises rather than fall back (shade mode 0,
    and the tables' own mode)."""
    _, _, tables = prepared
    chunk = tables.chunks[0]
    mode = tables.shade_mode if shade_mode is None else shade_mode
    before = dict(cuda_traverse.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_traverse.kernel_launcher(
            chunk.bvh8, chunk.tris_packed, *_rays(), 0.001, 1000.0, True,
            chunk.shade_packed if mode else None, mode,
            records=chunk.tri_records)
    assert cuda_traverse.LAUNCHES == before
