"""The tables the two-level kernel K6 reads as 16-byte loads
(csrc/instanced8.cu), on the CPU.

K6 reads an instance row of `inst_trace` as four float4s (the inverse 3x4
as three, then the BLAS root, the double-sided flag, the material id and 1
/ scale) and the pool's records from the Hopper record table
(`InstancedTables.tri_records`, cuda_traverse.hopper_records of the pooled
rows).  The float4 views must equal the columns they stand for, the rows
must start on 16 bytes, and the records must equal their source rows, which
are the reference's (`steeljax.accel.instances`, compared per BLAS since
both packages pool in the order of id(primitive)).  The records are derived
once per pool: a refresh after an edit keeps them.
"""

import numpy as np
import pytest
import torch

from steeljax.accel import instances as instances_ref
from steeljax.scene import builtin as builtin_ref
from steeljax_torch.accel import cuda_traverse, instances
from steeljax_torch.accel.bvh import TRI_PER_ROW
from steeljax_torch.apps import kernel_parity as kp
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401

VARIANTS = ("cornell", "edited", "textured")


@pytest.fixture(scope="module", params=VARIANTS)
def case(request):
    return kp.instanced_case("cpu", request.param)


def test_instance_rows_as_float4(case):
    scene, tables = case
    inst = tables.inst_trace
    count = tables.instance_count
    assert inst.is_contiguous() and inst.data_ptr() % 16 == 0
    assert inst.stride(0) * inst.element_size() % 16 == 0
    rows = inst.view(count, cuda_traverse.INST_COLS // 4, 4)
    # The inverse world 3x4, row by row, from the scene's transforms.
    worlds = [np.asarray(scene.world_transform(ei), np.float64)
              for ei in scene.renderable_entities()
              for _ in scene.entities[ei].render_objects]
    assert len(worlds) == count
    for i, world in enumerate(worlds):
        np.testing.assert_allclose(rows[i, 0:3].numpy(),
                                   np.linalg.inv(world)[:3, :4], rtol=1e-5,
                                   atol=1e-5)
    # (BLAS root, double-sided, material, 1 / scale).
    assert torch.equal(rows[:, 3], inst[:, 12:16])
    roots = rows[:, 3, 0]
    assert (roots == roots.round()).all()
    assert ((roots >= tables.n_tlas)
            & (roots < tables.snode_rows.shape[0])).all()
    assert set(rows[:, 3, 1].tolist()) <= {0.0, 1.0}


def test_pool_records_equal_their_rows(case):
    _, tables = case
    recs = tables.tri_records
    assert recs.is_contiguous() and recs.data_ptr() % 16 == 0
    assert torch.equal(recs, cuda_traverse.hopper_records(tables.tris_packed))
    src = tables.tris_packed[:, :TRI_PER_ROW * 10].reshape(-1, 10)
    assert recs.shape == (src.shape[0], cuda_traverse.HOPPER_RECORD)
    assert torch.equal(recs[:, 0:3], src[:, 0:3])
    assert torch.equal(recs[:, 3], src[:, 9])
    assert torch.equal(recs[:, 4:7], src[:, 3:6])
    assert torch.equal(recs[:, 8:11], src[:, 6:9])
    assert not recs[:, 7].any() and not recs[:, 11].any()


@pytest.mark.parametrize("textured", [False, True])
def test_pool_records_equal_the_reference_rows(textured):
    """The pool's records hold the reference's pooled rows, BLAS by BLAS
    (the two packages' scenes are built alike by their own modules and may
    pool in other orders: blocks are matched by their first records)."""
    def make(builtin_mod):
        if textured:
            return builtin_mod.make_stress_scene(27, 8, textured=True)
        return builtin_mod.make_cornell_scene(sphere_detail=8)

    tables = instances.InstancedAccel(device="cpu").prepare(make(builtin))
    tables_r = instances_ref.InstancedAccel(use_pallas=True).prepare(
        make(builtin_ref))
    rows_r = np.asarray(tables_r.tris_packed)[:, :TRI_PER_ROW * 10]
    rows_r = rows_r.reshape(-1, 10)
    offsets = list(tables.blas_tri_offset) + [tables.tri_records.shape[0]]
    offsets_r = list(tables_r.blas_tri_offset) + [rows_r.shape[0]]
    # The same BLAS set; each BLAS's block of records against the
    # reference's block of the same size and content.
    blocks = {tuple(np.asarray(tables.tri_records[a:b, 0:3]).ravel()[:9]):
              (a, b) for a, b in zip(offsets, offsets[1:])}
    assert len(blocks) == len(offsets_r) - 1
    for a, b in zip(offsets_r, offsets_r[1:]):
        key = tuple(rows_r[a:b, 0:3].ravel()[:9])
        lo, hi = blocks[key]
        recs = tables.tri_records[lo:hi].numpy()
        assert hi - lo == b - a
        np.testing.assert_array_equal(recs[:, 0:3], rows_r[a:b, 0:3])
        np.testing.assert_array_equal(recs[:, 4:7], rows_r[a:b, 3:6])
        np.testing.assert_array_equal(recs[:, 8:11], rows_r[a:b, 6:9])
        np.testing.assert_array_equal(recs[:, 3], rows_r[a:b, 9])


def test_refresh_keeps_the_records():
    """An edit that moves an entity re-prepares instance rows and the TLAS
    only: the triangle rows and their records are the same tensors."""
    scene, _ = kp.instanced_case("cpu", "cornell")
    accel = instances.InstancedAccel(device="cpu")
    first = accel.prepare(scene)
    kp.move_entity(scene)
    again = accel.prepare(scene)
    assert again.tris_packed is first.tris_packed
    assert again.tri_records is first.tri_records
    assert not torch.equal(again.inst_trace, first.inst_trace)
