"""The plain versions of the alpha-masked trace kernel K4 and the multi-hit
kernel K5 against the reference's CPU oracles, on numpy-seeded inputs (the
soup of kernel_parity with random masks), and the port's multi-hit winner
selection against the reference's.

K4 with coarse masks is held to steeljax.accel.traverse (tri_alpha_mask=)
in both cull modes, and its any-hit query to traverse.trace_any; with fine
rows it is held to kernel_parity._multihit_oracle(k=1, fine=...), the
reference's oracle for its fine kernel.  K5 at K = 4 is held to
_multihit_oracle without masks, with the coarse masks, and with fine masks
and the opaque bound (use_opaque=True).  The judges are the reference's:
_compare for nearest records (at most max(2, N/5000) hit mismatches, |dt| <
2e-3), max(2, N/5000) occlusion mismatches, and for slots at most
max(2, N K/5000) slot mismatches, |dt| < 2e-3 and u, v within 5e-3 where
the tri ids agree.  The oracles take t < t_max, the kernels t <= t_max;
random rays never land on the bound."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax.accel import dispatch as dispatch_ref
from steeljax.accel import traverse as traverse_ref
from steeljax.apps import kernel_parity as kp_ref
from steeljax.render.pt import integrator as integrator_ref
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax.scene.material import Material as MaterialRef
from steeljax.scene.material import MaterialFlags as MaterialFlagsRef
from steeljax.scene.scene import Entity as EntityRef
from steeljax.scene.scene import RenderObject as RenderObjectRef
from steeljax.scene.scene import Scene as SceneRef
from steeljax_torch.accel import cuda_traverse
from steeljax_torch.apps import kernel_parity as kp
from steeljax_torch.render.pt import integrator, renderer
from steeljax_torch.scene import builtin
from steeljax_torch.scene.material import Material, MaterialFlags
from steeljax_torch.scene.scene import Entity, RenderObject, Scene
from test_torch_support import one_torch_thread  # noqa: F401


N_TRIS, N_RAYS = 3000, 2048
K = 4


@pytest.fixture(scope="module")
def soups():
    """The soup's rays, and its coarse-masked and fine-masked tables with
    their permuted positions, double-sided flags, masks and fine words."""
    _, _, o, d = kp.soup_case(N_TRIS, N_RAYS, "cpu")
    out = {"o": o, "d": d}
    for fine in (False, True):
        tables, perm = kp.alpha_soup_case(N_TRIS, "cpu", fine=fine)
        chunk = tables.chunks[0]
        entry = {"tables": tables, "pos": perm["pos"], "ds": perm["ds"],
                 "mask": chunk.tri_mask.numpy()}
        if fine:
            entry["fine"] = chunk.fine_mask_rows.numpy()[:, :120].reshape(
                -1, 10)[:len(perm["pos"])]
        out["fine" if fine else "coarse"] = entry
    return out


def _rays(soups):
    return torch.from_numpy(soups["o"]), torch.from_numpy(soups["d"])


def _budget(n):
    return max(2, n // 5000)


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "nocull"])
def test_k4_coarse_nearest_matches_traverse(soups, cull):
    s = soups["coarse"]
    chunk = s["tables"].chunks[0]
    o, d = _rays(soups)
    ours = cuda_traverse.trace_nearest_bvh8(
        chunk.bvh8, chunk.tris_packed, o, d, 0.001, 1000.0, cull,
        alpha_mask=True)
    bvh_ref = _ref_bvh()
    ref = traverse_ref.trace_nearest(
        bvh_ref, jnp.asarray(s["pos"]), jnp.asarray(s["ds"]),
        jnp.asarray(soups["o"]), jnp.asarray(soups["d"]), 0.001, 1000.0,
        cull_backface=cull, tri_alpha_mask=jnp.asarray(s["mask"]))
    results = {}
    assert kp_ref._compare("k4", {k: v.numpy() for k, v in ours.items()},
                           {k: np.asarray(v) for k, v in ref.items()},
                           s["pos"], results), results
    # The masks reject: fewer hits than the unmasked trace.
    unmasked = cuda_traverse.trace_nearest_bvh8_plain(
        chunk.bvh8, chunk.tris_packed, o, d, 0.001, 1000.0, cull)
    assert N_RAYS // 16 < ours["hit"].sum() < unmasked["hit"].sum()


def _ref_bvh():
    """The reference's binary BVH over the same soup (both packages
    compile one C++ SAH source, so the permutation is the same)."""
    tris = kp._soup(N_TRIS, 1)
    ds = np.random.default_rng(2).uniform(size=N_TRIS) < 0.3
    tables_ref, _, _ = dispatch_ref.prepare_tables(tris, ds, leaf_size=24,
                                                   use_pallas=False)
    return tables_ref.chunks[0].bvh


def test_k4_coarse_anyhit_matches_traverse(soups):
    s = soups["coarse"]
    chunk = s["tables"].chunks[0]
    o, d = _rays(soups)
    ours = cuda_traverse.trace_any_bvh8(chunk.bvh8, chunk.tris_packed, o, d,
                                        0.001, 40.0, alpha_mask=True)
    bvh_ref = _ref_bvh()
    ref = np.asarray(traverse_ref.trace_any(
        bvh_ref, jnp.asarray(s["pos"]), jnp.asarray(s["ds"]),
        jnp.asarray(soups["o"]), jnp.asarray(soups["d"]), 0.001, 40.0,
        tri_alpha_mask=jnp.asarray(s["mask"])))
    assert int((ours.numpy() != ref).sum()) <= _budget(N_RAYS)
    assert N_RAYS // 16 < ref.sum() < N_RAYS


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "nocull"])
def test_k4_fine_matches_oracle(soups, cull):
    """Nearest (cull on and off) and any-hit with the fine PASS plane
    against the reference's fine oracle at k = 1."""
    s = soups["fine"]
    chunk = s["tables"].chunks[0]
    o, d = _rays(soups)
    kw = dict(alpha_mask=True, fine_rows=chunk.fine_mask_rows)
    ours = cuda_traverse.trace_nearest_bvh8(
        chunk.bvh8, chunk.tris_packed, o, d, 0.001, 1000.0, cull, **kw)
    slots = kp_ref._multihit_oracle(s["pos"], s["ds"], soups["o"],
                                    soups["d"], 0.001, 1000.0, 1, cull,
                                    s["mask"], fine=s["fine"])
    ref = {"t": slots["t"][0], "u": slots["u"][0], "v": slots["v"][0],
           "tri": slots["tri"][0], "hit": slots["tri"][0] >= 0}
    results = {}
    ours = {k: v.numpy() for k, v in ours.items()}
    assert kp_ref._compare("k4_fine", ours, ref, s["pos"], results), results
    coarse_only = cuda_traverse.trace_nearest_bvh8(
        chunk.bvh8, chunk.tris_packed, o, d, 0.001, 1000.0, cull,
        alpha_mask=True)
    assert N_RAYS // 16 < ours["hit"].sum() < coarse_only["hit"].sum()

    occluded = cuda_traverse.trace_any_bvh8(chunk.bvh8, chunk.tris_packed,
                                            o, d, 0.001, 40.0, **kw)
    occ_ref = kp_ref._multihit_oracle(
        s["pos"], s["ds"], soups["o"], soups["d"], 0.001, 40.0, 1, False,
        s["mask"], fine=s["fine"])["tri"][0] >= 0
    assert int((occluded.numpy() != occ_ref).sum()) <= _budget(N_RAYS)


@pytest.mark.parametrize("masks", ["none", "coarse", "fine"])
def test_k5_matches_oracle(soups, masks):
    if masks == "none":
        tables, perm, _, _ = kp.soup_case(N_TRIS, N_RAYS, "cpu")
        pos, ds, mask, fine = perm["pos"], perm["ds"], None, None
        kw = {}
    else:
        s = soups[masks]
        tables, pos, ds, mask = s["tables"], s["pos"], s["ds"], s["mask"]
        fine = s.get("fine")
        kw = dict(alpha_mask=True,
                  fine_rows=tables.chunks[0].fine_mask_rows)
    chunk = tables.chunks[0]
    o, d = _rays(soups)
    slots = cuda_traverse.trace_multihit_bvh8(
        chunk.bvh8, chunk.tris_packed, o, d, 0.001, 1000.0, K, True, **kw)
    assert slots["t"].shape == (K, N_RAYS)
    ref = kp_ref._multihit_oracle(pos, ds, soups["o"], soups["d"], 0.001,
                                  1000.0, K, True, mask, fine=fine,
                                  use_opaque=fine is not None)
    results = {}
    assert kp._compare_slots("k5", slots, ref, results), results
    assert results["k5"]["slots_hit"] > N_RAYS // 8
    # Sorted ascending, empty slots last.
    t = slots["t"].numpy()
    filled = t >= 0
    assert (filled[1:] <= filled[:-1]).all()
    assert (t[1:][filled[1:]] >= t[:-1][filled[1:]]).all()


def test_k5_wrapper_refuses_other_slot_counts(soups):
    chunk = soups["coarse"]["tables"].chunks[0]
    o, d = _rays(soups)
    with pytest.raises(ValueError, match="built for K"):
        cuda_traverse.trace_multihit_bvh8(chunk.bvh8, chunk.tris_packed, o,
                                          d, 0.001, 1000.0, 3)
    with pytest.raises(ValueError, match="fine_rows need alpha_mask"):
        cuda_traverse.trace_nearest_bvh8(
            chunk.bvh8, chunk.tris_packed, o, d, 0.001, 1000.0,
            fine_rows=soups["fine"]["tables"].chunks[0].fine_mask_rows)
    before = dict(cuda_traverse.LAUNCHES)
    cuda_traverse.trace_multihit_bvh8(chunk.bvh8, chunk.tris_packed, o[:8],
                                      d[:8], 0.001, 1000.0, 2,
                                      alpha_mask=True)
    assert cuda_traverse.LAUNCHES == before  # the CPU never launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_traverse.multihit_launcher(chunk.bvh8, chunk.tris_packed, o, d,
                                        0.001, 1000.0, 4)


def _two_quads(scene_cls, entity_cls, object_cls, material_cls, flags,
               make_quad):
    """The alpha-test quad (left half cut out) at z = 0 over an opaque quad
    at z = -2 (tests/test_multihit.py:24-42), built with either package's
    classes."""
    scene = scene_cls()
    tex = np.full((8, 8, 4), 255, np.uint8)
    tex[:, :4, 3] = 0
    scene.textures.append(tex)
    scene.materials.append(material_cls(
        base_color_texture=0, flags=flags.ALPHA_TEST | flags.DOUBLE_SIDED))
    scene.materials.append(material_cls(flags=flags.DOUBLE_SIDED))
    scene.primitives.append(make_quad(10.0))
    scene.add_entity(entity_cls(name="front",
                                render_objects=[object_cls(0, 0)]))
    back = entity_cls(name="back", render_objects=[object_cls(0, 1)])
    back.local_transform[:3, 3] = [0, 0, -2.0]
    scene.add_entity(back)
    return scene


def two_quad_scenes():
    """(the port's scene, the reference's scene)."""
    return (_two_quads(Scene, Entity, RenderObject, Material, MaterialFlags,
                       builtin.make_quad),
            _two_quads(SceneRef, EntityRef, RenderObjectRef, MaterialRef,
                       MaterialFlagsRef, builtin_ref.make_quad))


def test_resolve_multihit_matches_reference():
    """Slots built from the two-quad scene's front and back hits: ray 0
    through the cut-out (front rejected, back wins), ray 1 on the opaque
    half (front wins), ray 2 with both slots the rejected front hit
    (exhausted), ray 3 with empty slots (a resolved miss)."""
    ours_scene, ref_scene = two_quad_scenes()
    flat, tables = renderer.prepare_scene(ours_scene, "cpu",
                                          env_resolution=8,
                                          use_default_environment=False)
    flat_r, tables_r = renderer_ref.prepare_scene(
        ref_scene, env_resolution=8, use_default_environment=False)
    o = torch.tensor([[-2.5, 0, 5.0], [2.5, 0, 5.0], [-2.5, 0, 5.0],
                      [-2.5, 0, 5.0]])
    d = torch.tensor([[0, 0, -1.0]] * 4)
    front = cuda_traverse.trace_nearest_bvh8_plain(
        tables.bvh8, tables.chunks[0].tris_packed, o, d, 0.001, 6.0, False,
        alpha_mask=tables.alpha_masked)
    back = cuda_traverse.trace_nearest_bvh8_plain(
        tables.bvh8, tables.chunks[0].tris_packed, o, d, 6.0, 100.0, False,
        alpha_mask=tables.alpha_masked)
    assert front["hit"].all() and back["hit"].all()
    slots = {f: torch.stack([front[f], back[f]]) for f in ("t", "u", "v",
                                                           "tri")}
    for f in slots:
        slots[f][1, 2] = slots[f][0, 2]       # ray 2: front twice
        slots[f][:, 3] = -1 if f in ("t", "tri") else 0
    rec, exhausted = integrator._resolve_multihit(flat, tables, slots)
    rec_r, exhausted_r = integrator_ref._resolve_multihit(
        flat_r, tables_r, {f: jnp.asarray(v.numpy())
                           for f, v in slots.items()})
    for f in rec:
        np.testing.assert_array_equal(rec[f].numpy(), np.asarray(rec_r[f]),
                                      err_msg=f)
    np.testing.assert_array_equal(exhausted.numpy(),
                                  np.asarray(exhausted_r))
    assert rec["hit"].tolist() == [True, True, False, False]
    assert exhausted.tolist() == [False, False, True, False]
    assert abs(float(rec["t"][0]) - 7.0) < 1e-3
    assert abs(float(rec["t"][1]) - 5.0) < 1e-3
