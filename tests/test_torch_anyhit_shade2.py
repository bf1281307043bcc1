"""The plain versions of the any-hit kernel K2 (both row layouts) and of the
textured-shading kernel K3 against the reference's CPU oracle
(steeljax.accel.traverse), on numpy-seeded inputs.

K2: occlusion flags may disagree on at most max(2, N/5000) rays, the budget
of the reference's kernel_parity (:308-313), which absorbs grazing hits that
fp operation order can flip.  K3: the reference's own judge
(steeljax.apps.kernel_parity._compare) holds the port's mode-2 record
against the oracle's hits and the reference's interpolation of the
permuted normals and uvs: |delta t| < 2e-3, normal and uv deltas < 5e-3,
no material mismatches.  The tangent is held to the normalized
interpolation of the permuted tangents within 5e-3, and the uv density to
the permuted tri_shade column 27 exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax.accel import dispatch as dispatch_ref
from steeljax.accel import traverse as traverse_ref
from steeljax.apps import kernel_parity as kp_ref
from steeljax.core.constants import RAY_DEAD_T
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax_torch.accel import cuda_traverse
from steeljax_torch.accel.dispatch import trace_any, trace_nearest
from steeljax_torch.apps import kernel_parity as kp
from steeljax_torch.render.pt import renderer
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401


N_TRIS, N_RAYS = 3000, 2048


@pytest.fixture(scope="module")
def soup():
    """kernel_parity's soup with mode-2 rows and dense any-hit tables, and
    the reference's CPU tables of the same soup."""
    tables, perm, o, d = kp.soup_case(N_TRIS, N_RAYS, "cpu", textured=True,
                                      dense_anyhit=True)
    tris = kp._soup(N_TRIS, 1)
    ds = np.random.default_rng(2).uniform(size=N_TRIS) < 0.3
    tables_ref, _, _ = dispatch_ref.prepare_tables(tris, ds, leaf_size=24,
                                                   use_pallas=False)
    return tables, tables_ref, perm, o, d


def _occluded_ref(tables_ref, perm, o, d, t_min, t_max):
    return np.asarray(traverse_ref.trace_any(
        tables_ref.bvh, jnp.asarray(perm["pos"]), jnp.asarray(perm["ds"]),
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
        jnp.asarray(t_max)))


def _budget(n):
    return max(2, n // 5000)


@pytest.mark.parametrize("dense", [False, True], ids=["rows12", "dense14"])
def test_anyhit_plain_matches_oracle(soup, dense):
    tables, tables_ref, perm, o, d = soup
    chunk = tables.chunks[0]
    bvh8, tris = ((chunk.anyhit_bvh8, chunk.anyhit_tris) if dense
                  else (chunk.bvh8, chunk.tris_packed))
    occ_o = _occluded_ref(tables_ref, perm, o, d, 0.001, 40.0)
    occ_p = cuda_traverse.trace_any_bvh8(bvh8, tris, torch.from_numpy(o),
                                         torch.from_numpy(d), 0.001, 40.0,
                                         dense=dense)
    assert occ_p.dtype == torch.bool and occ_p.shape == (N_RAYS,)
    mismatches = int((occ_p.numpy() != occ_o).sum())
    print(f"any-hit {'dense' if dense else 'rows12'}: {mismatches} of "
          f"{N_RAYS} flags differ, {int(occ_o.sum())} occluded")
    assert mismatches <= _budget(N_RAYS)
    assert N_RAYS // 8 < occ_o.sum() < N_RAYS


def test_anyhit_dead_lanes_and_finite_t_max(soup):
    """A dead ray (t_max = RAY_DEAD_T) is never occluded; finite t_max
    cut-offs occlude exactly where the oracle does."""
    tables, tables_ref, perm, o, d = soup
    r = np.random.default_rng(6)
    t_max = r.uniform(0.5, 30.0, N_RAYS).astype(np.float32)
    dead = r.uniform(size=N_RAYS) < 0.25
    t_max[dead] = RAY_DEAD_T
    t_min = np.full(N_RAYS, 0.001, np.float32)
    occ_o = _occluded_ref(tables_ref, perm, o, d, t_min, t_max)
    for dense in (False, True):
        chunk = tables.chunks[0]
        occ_p = cuda_traverse.trace_any_bvh8_plain(
            chunk.anyhit_bvh8 if dense else chunk.bvh8,
            chunk.anyhit_tris if dense else chunk.tris_packed,
            torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_min), torch.from_numpy(t_max), dense)
        assert not occ_p.numpy()[dead].any() and not occ_o[dead].any()
        assert int((occ_p.numpy() != occ_o).sum()) <= _budget(N_RAYS)
        assert 0 < occ_p.sum() < (~dead).sum()


def test_dispatch_trace_any_reads_dense_tables_when_attached(soup):
    """trace_any answers from the dense tables when prepare_tables built
    them; both layouts hold the same triangles, so the brute-force plain
    versions agree exactly."""
    tables, _, _, o, d = soup
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    chunk = tables.chunks[0]
    without = tables.replace(chunks=(chunk.replace(anyhit_bvh8=None,
                                                   anyhit_tris=None),))
    assert torch.equal(trace_any(tables, o, d, 0.001, 40.0),
                       trace_any(without, o, d, 0.001, 40.0))


def test_shade_mode2_plain_matches_reference(soup):
    tables, tables_ref, perm, o, d = soup
    assert tables.shade_mode == 2
    rec_o = dispatch_ref.trace_nearest(
        tables_ref, jnp.asarray(perm["pos"]), jnp.asarray(perm["ds"]),
        jnp.asarray(o), jnp.asarray(d), 0.001, 1000.0, cull_backface=True)
    rec_o = {k: np.asarray(v) for k, v in rec_o.items()}
    rec_p = trace_nearest(tables, torch.from_numpy(o), torch.from_numpy(d),
                          0.001, 1000.0)
    rec_p = {k: v.numpy() for k, v in rec_p.items()}
    results = {}
    assert kp_ref._compare("shade2", rec_p, rec_o, perm["pos"], results,
                           attrs={k: perm[k] for k in ("nrm", "uv", "mat")},
                           d=d), results
    assert "max_uv_delta" in results["shade2"]
    hit = rec_p["hit"]
    assert hit.sum() > N_RAYS // 8
    tri = rec_p["tri"][hit]
    tan = kp._norm(kp._interp(perm["tan"], tri, rec_p["u"][hit],
                              rec_p["v"][hit]))
    assert np.abs(rec_p["tan"][hit] - tan).max() < 5e-3
    # The soup has no uv densities: the records carry zero.
    assert (rec_p["uvd"] == 0.0).all()


def test_textured_scene_uv_density_and_miss_record():
    """On the textured stress scene the record's uv density is the hit
    triangle's tri_shade column 27; a miss reports n = +z, mat 0, tan = +x,
    uv = 0, uvd = 0 (the reference kernel's initial values)."""
    scene = builtin.make_stress_scene(8, 4, textured=True)
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16)
    flat_ref, _ = renderer_ref.prepare_scene(
        builtin_ref.make_stress_scene(8, 4, textured=True),
        env_resolution=16)
    o, d, t_min, t_max, _ = kp.tiled_primary(scene, "cpu", 64, 16)
    rec = trace_nearest(tables, o, d, t_min, t_max)
    hit = rec["hit"]
    assert 0 < int(hit.sum()) < hit.shape[0] or bool(hit.all())
    uvd_ref = np.asarray(flat_ref.tri_shade)[rec["tri"][hit].numpy(), 27]
    np.testing.assert_array_equal(rec["uvd"][hit].numpy(), uvd_ref)
    assert (uvd_ref > 0).any()

    miss = trace_nearest(tables, torch.tensor([[100.0, 100.0, 100.0]]),
                         torch.tensor([[0.0, 0.0, 1.0]]), 0.001, 1000.0)
    assert not miss["hit"].item()
    assert miss["n"].tolist() == [[0.0, 0.0, 1.0]] and miss["mat"].item() == 0
    assert miss["tan"].tolist() == [[1.0, 0.0, 0.0]]
    assert miss["uv"].tolist() == [[0.0, 0.0]] and miss["uvd"].item() == 0.0


def test_anyhit_wrapper_runs_plain_on_cpu_and_refuses_mixed_devices(soup):
    tables, _, _, o, d = soup
    chunk = tables.chunks[0]
    before = dict(cuda_traverse.LAUNCHES)
    o_t, d_t = torch.from_numpy(o[:64]), torch.from_numpy(d[:64])
    occ = cuda_traverse.trace_any_bvh8(chunk.bvh8, chunk.tris_packed, o_t,
                                       d_t, 0.001, 40.0)
    plain = cuda_traverse.trace_any_bvh8_plain(chunk.bvh8,
                                               chunk.tris_packed, o_t, d_t,
                                               0.001, 40.0)
    assert torch.equal(occ, plain)
    assert cuda_traverse.LAUNCHES == before  # the CPU never launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_traverse.anyhit_launcher(chunk.bvh8, chunk.tris_packed, o_t,
                                      d_t, 0.001, 40.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_traverse.kernel_launcher(chunk.bvh8, chunk.tris_packed, o_t,
                                      d_t, 0.001, 40.0, True,
                                      chunk.shade_packed, 2)
    with pytest.raises(ValueError, match="several devices"):
        cuda_traverse.trace_any_bvh8(chunk.bvh8,
                                     chunk.tris_packed.to("meta"), o_t, d_t,
                                     0.001, 40.0)
    with pytest.raises(ValueError, match="several devices"):
        cuda_traverse.trace_any_bvh8(chunk.bvh8, chunk.tris_packed, o_t,
                                     d_t, 0.001,
                                     torch.zeros(64, device="meta"))
