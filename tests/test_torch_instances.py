"""The two-level structure (steeljax_torch.accel.instances) and the plain
version of its kernel K6 against the reference on the CPU.

Tables: `InstancedAccel(device="cpu").prepare(scene)` must give the arrays
of the reference's `InstancedAccel(use_pallas=True).prepare(scene)` (the
fused rows are packed on the host there, no TPU needed), bit for bit.  Both
packages pool their BLAS in the order of `id(primitive)`, which differs from
process to process and between the two packages' scenes, so the comparison
first brings both pools into the order of the scene's primitives
(`_canonical`); everything else is compared as it is.

Trace: the plain K6 against the reference's CPU path
(`trace_nearest_instanced` of `InstancedAccel(use_pallas=False)`, a loop of
binary-BVH traversals over the instances; the Pallas kernel itself cannot
run on the CPU, pallas_traverse.py:68-72), under kernel_parity._compare's
budgets: at most max(2, N/5000) hit mismatches, |delta t| < 2e-3, fused
normal, tangent and uv deltas < 5e-3, uv density within 5e-3 relative, no
material mismatch.  The fused outputs are judged against the reference's
instanced `shade_rows` interpolated at the oracle's hit.  The scenes include
a non-uniformly scaled instance and a mirrored one (negative determinant).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax.accel import instances as instances_ref
from steeljax.render.pt import integrator as integrator_ref
from steeljax.scene import builtin as builtin_ref
from steeljax.scene import scene as scene_ref
from steeljax_torch.accel import cuda_traverse, instances
from steeljax_torch.accel.bvh import TRI_PER_ROW
from steeljax_torch.accel.dispatch import trace_any, trace_nearest
from steeljax_torch.apps import kernel_parity as kp
from steeljax_torch.scene import builtin
from steeljax_torch.scene import scene as scene_lib
from test_torch_support import one_torch_thread  # noqa: F401


LEAF = 16
N_RAYS = 2048
VARIANTS = ("cornell", "edited", "textured")


def _scene(variant, builtin_mod, scene_mod):
    """Cornell at sphere detail 6 ("cornell"), the same with a squashed and
    a mirrored sphere ("edited"), or the small textured stress scene with
    those two ("textured"), built with one package's modules."""
    if variant == "textured":
        scene = builtin_mod.make_stress_scene(8, 4, textured=True)
    else:
        scene = builtin_mod.make_cornell_scene(sphere_detail=6)
    if variant != "cornell":
        sphere = 2  # make_cornell_scene's primitives: quad, box, sphere
        scene.add_entity(scene_mod.Entity(
            name="squashed",
            local_transform=builtin_mod._trs((0.5, 1.0, 0.3), (0, 1, 0), 0.7,
                                             (1.5, 0.5, 0.8)),
            render_objects=[scene_mod.RenderObject(sphere, 5)]))
        scene.add_entity(scene_mod.Entity(
            name="mirrored",
            local_transform=builtin_mod._trs((-0.8, 1.2, 0.0), None, 0.0,
                                             (-0.7, 0.7, 0.7)),
            render_objects=[scene_mod.RenderObject(sphere, 4)]))
    return scene


def _both(variant, use_pallas):
    scene = _scene(variant, builtin, scene_lib)
    scene_r = _scene(variant, builtin_ref, scene_ref)
    tables = instances.InstancedAccel(LEAF, device="cpu").prepare(scene)
    tables_r = instances_ref.InstancedAccel(
        LEAF, use_pallas=use_pallas).prepare(scene_r)
    return scene, tables, scene_r, tables_r


def _pool(tables, scene):
    """Per pooled BLAS j: (primitive index, first supernode row, first
    record), from the instance rows."""
    prims = [ro.primitive for ei in scene.renderable_entities()
             for ro in scene.entities[ei].render_objects]
    inst_trace = np.asarray(tables.inst_trace)
    pool = {}
    for i, j in enumerate(tables.inst_blas):
        pool[j] = (prims[i], int(inst_trace[i, 12]),
                   int(tables.blas_tri_offset[j]))
    assert sorted(pool) == list(range(len(tables.blas_tri_offset)))
    return pool


def _canonical(tables, scene) -> dict:
    """The tables' arrays with the BLAS pool keyed by primitive index and
    every pool offset (child rows, leaf records, BLAS roots) taken out."""
    snode = np.array(np.asarray(tables.snode_rows))
    tris = np.asarray(tables.tris_packed)
    blas_shade = np.asarray(tables.blas_shade)
    fused = (None if tables.shade_rows is None
             else np.asarray(tables.shade_rows))
    per = {0: 0, 1: 1, 2: 3}[int(tables.shade_mode)]
    n_tlas = int(tables.n_tlas)
    pool = _pool(tables, scene)
    row_ends = sorted(r for _, r, _ in pool.values()) + [len(snode)]
    tri_ends = sorted(t for _, _, t in pool.values()) + [
        len(tris) * TRI_PER_ROW]
    out = {"tlas": snode[:n_tlas],
           "inst_shade": np.asarray(tables.inst_shade)}
    inst_trace = np.array(np.asarray(tables.inst_trace))
    for i, j in enumerate(tables.inst_blas):
        inst_trace[i, 12] = pool[j][0]
    out["inst_trace"] = inst_trace
    for j, (prim, row0, tri0) in pool.items():
        row1 = row_ends[row_ends.index(row0) + 1]
        tri1 = tri_ends[tri_ends.index(tri0) + 1]
        rows = snode[row0:row1].copy()
        for c in range(8):
            meta0, meta1 = rows[:, 16 * c + 6], rows[:, 16 * c + 7]
            internal = (meta1 == 0) & (meta0 >= 0)
            assert (meta0[internal] >= row0).all()
            meta0[internal] -= row0
            meta0[meta1 > 0] -= tri0
        out[f"rows_{prim}"] = rows
        r0, r1 = tri0 // TRI_PER_ROW, tri1 // TRI_PER_ROW
        out[f"tris_{prim}"] = tris[r0:r1]
        out[f"blas_shade_{prim}"] = blas_shade[tri0:tri1]
        if fused is not None:
            out[f"fused_{prim}"] = fused[r0 * per:r1 * per]
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_prepare_tables_equal_reference(variant):
    scene, tables, scene_r, tables_r = _both(variant, use_pallas=True)
    assert tables.shade_mode == tables_r.shade_mode == (
        2 if variant == "textured" else 1)
    assert tables.n_tlas == int(tables_r.n_tlas)
    assert tables.depth == tables_r.depth
    assert tables.max_leaf == tables_r.max_leaf == LEAF
    assert tables.instance_count == tables_r.instance_count
    np.testing.assert_array_equal(np.float32(tables.aabb_lo),
                                  np.asarray(tables_r.aabb_lo))
    np.testing.assert_array_equal(np.float32(tables.aabb_hi),
                                  np.asarray(tables_r.aabb_hi))
    for name in ("snode_rows", "tris_packed", "inst_trace", "inst_shade",
                 "blas_shade", "shade_rows"):
        ours, ref = getattr(tables, name), getattr(tables_r, name)
        assert ours.dtype == torch.float32
        assert tuple(ours.shape) == tuple(ref.shape), name
    ours, ref = _canonical(tables, scene), _canonical(tables_r, scene_r)
    assert sorted(ours) == sorted(ref)
    for name in ours:
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)
    # The mirrored and the squashed instance are in the tables.
    if variant != "cornell":
        lin = ours["inst_trace"][:, 25:34].reshape(-1, 3, 3)
        assert (np.linalg.det(lin) < 0).sum() == 1


def test_alpha_tested_scene_gets_shade_mode_0():
    """An alpha-tested material keeps the row-gather path
    (instances.py:307-315)."""
    scene = builtin.make_foliage_scene(cards=40)
    scene_r = builtin_ref.make_foliage_scene(cards=40)
    tables = instances.InstancedAccel(LEAF, device="cpu").prepare(scene)
    tables_r = instances_ref.InstancedAccel(
        LEAF, use_pallas=True).prepare(scene_r)
    assert tables.shade_mode == tables_r.shade_mode == 0
    assert tables.shade_rows is None and tables_r.shade_rows is None
    ours, ref = _canonical(tables, scene), _canonical(tables_r, scene_r)
    for name in ours:
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)


@pytest.mark.parametrize("count", [0, 1, 8, 9, 100])
def test_build_tlas8_equal_reference(count):
    r = np.random.default_rng(count)
    lo = r.uniform(-10, 10, (count, 3)).astype(np.float32)
    hi = lo + r.uniform(0.1, 3.0, (count, 3)).astype(np.float32)
    rows, depth = instances._build_tlas8(lo, hi)
    rows_r, depth_r = instances_ref._build_tlas8(lo, hi)
    np.testing.assert_array_equal(rows, rows_r)
    assert depth == depth_r
    assert rows.dtype == np.float32 and rows.shape[1] == 128


def test_pack_inst_material_equal_reference():
    scene = builtin.make_stress_scene(8, 4, textured=True)
    scene_r = builtin_ref.make_stress_scene(8, 4, textured=True)
    for mat, mat_r in zip(scene.materials, scene_r.materials):
        np.testing.assert_array_equal(instances._pack_inst_material(mat),
                                      instances_ref._pack_inst_material(mat_r))


def _rays(seed=11, spread=4.0):
    o, d = kp._rays(N_RAYS, seed, spread=spread)
    return o, d


def _local(rec, tables):
    """A trace record with tri as (instance's BLAS-local id), so records of
    pools in different orders compare."""
    rec = {k: np.asarray(v) for k, v in kp._numpy(rec).items()}
    inst = np.maximum(rec["inst"], 0)
    offsets = np.asarray(tables.blas_tri_offset)[
        np.asarray(tables.inst_blas)[inst]]
    rec["tri"] = np.where(rec["hit"], rec["tri"] - offsets, -1)
    return rec


def _oracle(tables_r, o, d, t_min, t_max, cull, any_hit=False):
    return instances_ref.trace_nearest_instanced(
        tables_r, jnp.asarray(o), jnp.asarray(d), t_min, t_max,
        cull_backface=cull, any_hit=any_hit)


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_k6_matches_oracle(variant, cull):
    """Hits, t and instance ids of the plain K6 against the reference's CPU
    path, and its fused outputs against the reference's instanced
    shade_rows interpolated at the oracle's (inst, tri, u, v)."""
    scene, tables, scene_r, tables_r = _both(variant, use_pallas=False)
    o, d = _rays()
    raw_o = _oracle(tables_r, o, d, 0.001, 1000.0, cull)
    rec_o = _local(raw_o, tables_r)
    rec_p = _local(trace_nearest(tables, torch.from_numpy(o),
                                 torch.from_numpy(d), 0.001, 1000.0,
                                 cull_backface=cull), tables)
    results = {}
    assert kp._compare(variant, rec_p, rec_o, None, results), results
    assert results[variant]["hits"] > N_RAYS // 2
    both = rec_p["hit"] & rec_o["hit"]
    same = both & (rec_p["tri"] == rec_o["tri"]) & (
        rec_p["inst"] == rec_o["inst"])
    # Instance and triangle ids may differ only on exact-t ties.
    assert same.sum() >= 0.99 * both.sum()
    tie = both & ~same
    assert np.abs(rec_p["t"][tie] - rec_o["t"][tie]).max(initial=0.0) < 1e-5
    assert (rec_p["inst"][~rec_p["hit"]] == -1).all()

    # Fused outputs at the oracle's hit.
    rows = np.asarray(integrator_ref.shade_rows(None, tables_r, raw_o))
    u, v = rec_o["u"][:, None], rec_o["v"][:, None]
    w = 1.0 - u - v

    def interp(cols, k):
        a = rows[:, cols].reshape(-1, 3, k)
        return a[:, 0] * w + a[:, 1] * u + a[:, 2] * v

    nrm = kp._norm(interp(slice(0, 9), 3))
    # Back-face flip: det < 0 exactly where d . geometric normal > 0.
    back = (d * rows[:, 24:27]).sum(axis=-1) > 0
    nrm = np.where(back[:, None], -nrm, nrm)
    assert np.abs(rec_p["n"][same] - nrm[same]).max() < 5e-3
    mat = np.asarray(tables_r.inst_trace)[np.maximum(rec_o["inst"], 0), 14]
    assert (rec_p["mat"][same] == mat[same].astype(np.int32)).all()
    if variant == "textured":
        tan = kp._norm(interp(slice(9, 18), 3))
        assert np.abs(rec_p["tan"][same] - tan[same]).max() < 5e-3
        uv = interp(slice(18, 24), 2)
        assert np.abs(rec_p["uv"][same] - uv[same]).max() < 5e-3
        uvd = rows[:, 27]
        rel = np.abs(rec_p["uvd"][same] - uvd[same]) / np.maximum(
            np.abs(uvd[same]), 1.0)
        assert rel.max() < 5e-3
    else:
        assert "tan" not in rec_p


@pytest.mark.parametrize("variant", ("cornell", "edited"))
def test_plain_k6_any_hit_matches_oracle(variant):
    """Occlusion flags over a finite interval, dead rays included."""
    scene, tables, scene_r, tables_r = _both(variant, use_pallas=False)
    o, d = _rays(seed=5)
    t_max = np.full(N_RAYS, 6.0, np.float32)
    t_max[::7] = -3.0e38
    hit_o = np.asarray(_oracle(tables_r, o, d, 0.001, jnp.asarray(t_max),
                               False, any_hit=True)["hit"])
    hit_p = trace_any(tables, torch.from_numpy(o), torch.from_numpy(d), 0.001,
                      torch.from_numpy(t_max))
    assert hit_p.dtype == torch.bool and not hit_p[::7].any()
    results = {}
    assert kp._compare_hits(variant, hit_p, hit_o, results), results
    assert N_RAYS // 8 < results[variant]["hits"] < N_RAYS


def test_shade_mode_0_and_interval_cutoff():
    """Mode 0 gives the same hits as mode 1 without the fused fields; a
    finite t_max cuts where the oracle cuts."""
    scene, tables, scene_r, tables_r = _both("edited", use_pallas=False)
    o, d = _rays(seed=3)
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    fused = trace_nearest(tables, o_t, d_t, 0.001, 1000.0)
    plain0 = trace_nearest(
        dataclasses.replace(tables, shade_mode=0, shade_rows=None), o_t, d_t,
        0.001, 1000.0)
    assert sorted(plain0) == ["hit", "inst", "t", "tri", "u", "v"]
    for key in plain0:
        assert torch.equal(plain0[key], fused[key]), key
    t_max = np.random.default_rng(1).uniform(0.5, 8.0, N_RAYS).astype(
        np.float32)
    rec_o = _local(_oracle(tables_r, o, d, 0.001, jnp.asarray(t_max), True),
                   tables_r)
    rec_p = _local(trace_nearest(tables, o_t, d_t, 0.001,
                                 torch.from_numpy(t_max)), tables)
    results = {}
    assert kp._compare("cutoff", rec_p, rec_o, None, results), results
    hit = rec_p["hit"]
    assert (rec_p["t"][hit] <= t_max[hit]).all() and 0 < hit.sum() < N_RAYS


def test_wrapper_runs_plain_on_cpu_and_checks_tables():
    tables = instances.InstancedAccel(LEAF, device="cpu").prepare(
        builtin.make_cornell_scene(sphere_detail=4))
    o, d = _rays()
    o_t, d_t = torch.from_numpy(o[:64]), torch.from_numpy(d[:64])
    before = dict(cuda_traverse.LAUNCHES)
    rec = cuda_traverse.trace_nearest_bvh8_inst(tables, o_t, d_t, 0.001,
                                                1000.0)
    plain = cuda_traverse.trace_nearest_bvh8_inst_plain(tables, o_t, d_t,
                                                        0.001, 1000.0)
    for key in plain:
        assert torch.equal(rec[key], plain[key]), key
    assert cuda_traverse.LAUNCHES == before  # the CPU never launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_traverse.inst_launcher(tables, o_t, d_t, 0.001, 1000.0)
    with pytest.raises(ValueError, match="several devices"):
        cuda_traverse.trace_nearest_bvh8_inst(
            dataclasses.replace(tables,
                                inst_trace=tables.inst_trace.to("meta")),
            o_t, d_t, 0.001, 1000.0)
    with pytest.raises(ValueError, match="needs shade_rows"):
        cuda_traverse.trace_nearest_bvh8_inst(
            dataclasses.replace(tables, shade_rows=None), o_t, d_t, 0.001,
            1000.0)


def test_reprepare_reuses_blas_and_device_tensors():
    """A transform edit and a new instance of a known primitive build no
    BLAS and keep the triangle, shading-row and fused-record tensors; a new
    primitive builds one BLAS and re-packs them."""
    scene = builtin.make_cornell_scene(sphere_detail=6)
    accel = instances.InstancedAccel(LEAF, device="cpu")
    t0 = accel.prepare(scene)
    assert accel.blas_builds == 3  # quad, box, sphere
    kp.move_entity(scene)
    t1 = accel.prepare(scene)
    assert accel.blas_builds == 3
    for name in ("tris_packed", "blas_shade", "shade_rows"):
        assert getattr(t1, name) is getattr(t0, name), name
    assert not torch.equal(t1.inst_trace, t0.inst_trace)
    scene.add_entity(scene_lib.Entity(
        name="extra", local_transform=builtin._trs((1.0, 2.0, 0.0)),
        render_objects=[scene_lib.RenderObject(2, 4)]))
    t2 = accel.prepare(scene)
    assert accel.blas_builds == 3
    assert t2.instance_count == t1.instance_count + 1
    assert t2.tris_packed is t0.tris_packed
    scene.primitives.append(builtin.make_box(0.5))
    scene.add_entity(scene_lib.Entity(
        name="new_box", local_transform=builtin._trs((0.0, 1.0, 0.0)),
        render_objects=[scene_lib.RenderObject(len(scene.primitives) - 1,
                                               4)]))
    t3 = accel.prepare(scene)
    assert accel.blas_builds == 4
    assert t3.tris_packed.shape[0] > t0.tris_packed.shape[0]
