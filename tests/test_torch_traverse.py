"""The plain version of the trace kernel K1 against the reference's CPU
oracle (steeljax.accel.traverse.trace_nearest, reached through
steeljax.accel.dispatch.trace_nearest on tables built with
use_pallas=False), judged by the port's kernel_parity._compare with the
reference's thresholds: at most max(2, N/5000) hit mismatches, |delta t| <
2e-3, normal deltas < 5e-3, no material mismatches; the deterministic grid
must agree exactly (no mismatches, |delta t| < 1e-5).  The reference's
Pallas kernel itself cannot run on the CPU (pallas_traverse.py:68-72).

Inputs are made with numpy from seeds and fed to both packages; both
packages build identical tables (test_torch_tables.py), so triangle ids
index the same permuted arrays."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax.accel import dispatch as dispatch_ref
from steeljax.accel.bvh import apply_permutation as apply_permutation_ref
from steeljax.core.constants import RAY_DEAD_T
from steeljax.render.pt.renderer import prepare_scene as prepare_scene_ref
from steeljax.scene.builtin import make_cornell_scene as cornell_ref
from steeljax_torch.accel import cuda_traverse
from steeljax_torch.accel.dispatch import trace_nearest
from steeljax_torch.apps import kernel_parity as kp
from test_torch_support import one_torch_thread  # noqa: F401


N_TRIS, N_RAYS = 3000, 2048


def _oracle(tables_ref, pos, ds, o, d, t_min, t_max, cull):
    rec = dispatch_ref.trace_nearest(
        tables_ref, jnp.asarray(pos), jnp.asarray(ds), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(t_min), jnp.asarray(t_max),
        cull_backface=cull)
    return {k: np.asarray(v) for k, v in rec.items()}


@pytest.fixture(scope="module")
def soup():
    """kernel_parity's soup at a small size, both packages' tables."""
    tables, perm, o, d = kp.soup_case(N_TRIS, N_RAYS, "cpu")
    tris = kp._soup(N_TRIS, 1)
    ds = np.random.default_rng(2).uniform(size=N_TRIS) < 0.3
    tables_ref, order, padded = dispatch_ref.prepare_tables(
        tris, ds, leaf_size=24, use_pallas=False)
    perm_ref = apply_permutation_ref((None, order, padded),
                                     {"pos": tris, "ds": ds})
    np.testing.assert_array_equal(perm["pos"], perm_ref["pos"])
    return tables, tables_ref, perm, o, d


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("mode", [0, 1])
def test_soup_plain_matches_oracle(soup, cull, mode):
    tables, tables_ref, perm, o, d = soup
    rec_o = _oracle(tables_ref, perm["pos"], perm["ds"], o, d, 0.001,
                    1000.0, cull)
    if mode == 0:
        tables = tables.replace(shade_mode=0)
    rec_p = trace_nearest(tables, torch.from_numpy(o), torch.from_numpy(d),
                          0.001, 1000.0, cull_backface=cull)
    assert ("n" in rec_p) == (mode == 1)
    results = {}
    attrs = {"nrm": perm["nrm"], "mat": perm["mat"]} if mode else None
    assert kp._compare("soup", rec_p, rec_o, perm["pos"], results,
                       attrs=attrs, d=d), results
    assert results["soup"]["hits"] > N_RAYS // 8


def test_cornell_primary_and_bounce_rays_match_oracle():
    """Cornell sd 6 primary rays (64x36) and the first-bounce rays the
    integrator samples from their hits, dead lanes included."""
    flat, tables, cases = kp.cornell_cases("cpu", 64, 36, sphere_detail=6)
    flat_ref, tables_ref = prepare_scene_ref(cornell_ref(6),
                                             env_resolution=16)
    pos = np.asarray(flat_ref.tri_pos)
    np.testing.assert_array_equal(flat.tri_pos.numpy(), pos)
    attrs = {"nrm": flat.tri_nrm.numpy(), "mat": flat.tri_mat.numpy()}
    results = {}
    for name, (o, d, t_min, t_max) in cases.items():
        n = o.shape[0]
        tmn = np.broadcast_to(np.asarray(t_min, np.float32), (n,))
        tmx = np.broadcast_to(np.asarray(t_max, np.float32), (n,))
        rec_o = _oracle(tables_ref, pos, np.asarray(flat_ref.tri_double_sided),
                        o.numpy(), d.numpy(), tmn, tmx, True)
        rec_p = trace_nearest(tables, o, d, t_min, t_max)
        assert kp._compare(name, rec_p, rec_o, pos, results, attrs=attrs,
                           d=d.numpy()), results[name]
    assert results["primary"]["hits"] > 0.5 * 64 * 36
    assert 0 < results["bounce1"]["hits"] < results["primary"]["hits"] + 1


def test_deterministic_grid_exact():
    """kernel_parity's axis-aligned quad stack with perpendicular rays: no
    grazing hits, so the two must agree exactly."""
    tables, pos, o, d = kp.deterministic_case("cpu")
    tables_ref, order, padded = dispatch_ref.prepare_tables(
        _quad_stack(), np.ones(96, bool), leaf_size=24, use_pallas=False)
    perm_ref = apply_permutation_ref((None, order, padded),
                                     {"pos": _quad_stack(),
                                      "ds": np.ones(96, bool)})
    np.testing.assert_array_equal(pos, perm_ref["pos"])
    rec_o = _oracle(tables_ref, perm_ref["pos"], perm_ref["ds"], o, d,
                    0.001, 1000.0, False)
    rec_p = trace_nearest(tables, torch.from_numpy(o), torch.from_numpy(d),
                          0.001, 1000.0, cull_backface=False)
    results = {}
    assert kp._compare("exact", rec_p, rec_o, pos, results, atol=1e-5,
                       exact=True), results
    assert results["exact"]["hits"] == len(o)


def _quad_stack():
    dq = []
    for i in range(48):
        z = -0.5 * i
        dq.append([[-8, -8, z], [8, -8, z], [8, 8, z]])
        dq.append([[-8, -8, z], [8, 8, z], [-8, 8, z]])
    return np.asarray(dq, np.float32)


def test_dead_lanes_and_finite_t_max(soup):
    """Dead lanes (t_max = RAY_DEAD_T) miss; finite t_max cut-offs cut
    exactly where the oracle cuts."""
    tables, tables_ref, perm, o, d = soup
    r = np.random.default_rng(5)
    t_max = r.uniform(0.5, 30.0, N_RAYS).astype(np.float32)
    dead = r.uniform(size=N_RAYS) < 0.25
    t_max[dead] = RAY_DEAD_T
    t_min = np.full(N_RAYS, 0.001, np.float32)
    rec_o = _oracle(tables_ref, perm["pos"], perm["ds"], o, d, t_min,
                    t_max, True)
    rec_p = trace_nearest(tables, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(t_min), torch.from_numpy(t_max))
    hit = rec_p["hit"].numpy()
    assert not hit[dead].any() and not rec_o["hit"][dead].any()
    assert (rec_p["t"].numpy()[dead] == -1.0).all()
    assert (rec_p["tri"].numpy()[dead] == -1).all()
    results = {}
    assert kp._compare("cutoff", rec_p, rec_o, perm["pos"], results,
                       exact=True), results
    assert (rec_p["t"].numpy()[hit] <= t_max[hit]).all()
    assert 0 < hit.sum() < (~dead).sum()


def test_wrapper_runs_plain_on_cpu_and_refuses_mixed_devices(soup):
    tables, _, _, o, d = soup
    chunk = tables.chunks[0]
    before = dict(cuda_traverse.LAUNCHES)
    o_t, d_t = torch.from_numpy(o[:64]), torch.from_numpy(d[:64])
    rec = cuda_traverse.trace_nearest_bvh8(chunk.bvh8, chunk.tris_packed,
                                           o_t, d_t, 0.001, 1000.0)
    plain = cuda_traverse.trace_nearest_bvh8_plain(
        chunk.bvh8, chunk.tris_packed, o_t, d_t, 0.001, 1000.0)
    for k in ("t", "u", "v", "tri", "hit"):
        assert torch.equal(rec[k], plain[k]), k
    assert cuda_traverse.LAUNCHES == before  # the CPU never launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_traverse.kernel_launcher(chunk.bvh8, chunk.tris_packed, o_t,
                                      d_t, 0.001, 1000.0)
    with pytest.raises(ValueError, match="several devices"):
        cuda_traverse.trace_nearest_bvh8(
            chunk.bvh8, chunk.tris_packed.to("meta"), o_t, d_t, 0.001,
            1000.0)
    with pytest.raises(ValueError, match="several devices"):
        cuda_traverse.trace_nearest_bvh8(
            chunk.bvh8, chunk.tris_packed, o_t, d_t,
            torch.zeros(64, device="meta"), 1000.0)


def test_miss_record_values(soup):
    """A miss reports t = -1, tri = -1, u = v = 0, n = +z, mat = 0."""
    tables, _, _, _, _ = soup
    o = torch.tensor([[100.0, 100.0, 100.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    rec = trace_nearest(tables, o, d, 0.001, 1000.0)
    assert rec["t"].item() == -1.0 and rec["tri"].item() == -1
    assert rec["u"].item() == 0.0 and rec["v"].item() == 0.0
    assert rec["n"].tolist() == [[0.0, 0.0, 1.0]]
    assert rec["mat"].item() == 0 and not rec["hit"].item()
