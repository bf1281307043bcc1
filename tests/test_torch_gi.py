"""The port's light-volume GI modules against the reference on the CPU.

Same inputs, made from seeds with numpy, go through steeljax.gi and
steeljax_torch.gi:
  * probe placement (gi.probes) and the tets (gi.tets) give equal arrays:
    the single-triangle cases of tests/test_gi.py, the tiny Cornell box at
    min edge 4.0 and 0.5, and with the max_probes stride engaged;
  * sh_basis and eval_irradiance agree within 1e-6 absolute on 4,096 unit
    directions; project_sh9 within 1e-5 of the coefficients' scale (the
    largest |coefficient|) on random (3, 6, 8, 8, 3) cubes at delta 0.05 and
    0.1 (the higher bands of a random cube nearly cancel, so an elementwise
    relative bound would measure the summation order of those near-zero
    sums, not the projection);
  * the tet walk (gi.sample) on tests/test_gi.py's `_walk_volume` (with
    seeded SH coefficients) and on the tiny Cornell bake carried across by
    convert.from_jax_light_volume, at 4,096 seeded points inside and outside
    the hull plus the hull's probes: irradiance within 1e-5, exactly 0
    wherever the reference's is (outside the hull);
  * the probe capture (gi.light_volume.capture_probes) of two probes at
    resolution 4 and 2 spp, on the tiny Cornell box and on the lit parity
    scene (next-event estimation in the capture), flat and through the
    two-level structure, within 1e-4 (PIXEL_ATOL);
  * the whole bake (generate_light_volume) at tests/test_gi.py's
    test_end_to_end_bake size (27 probes): equal positions and tets,
    coefficients within 1e-4;
  * the light-volume checkpoints round-trip bit-equal and load across the
    two packages; the probe overlay equals the reference's.
The port's own tables carry fused shading, the reference's CPU tables do
not: the captures agree all the same (measured: 1.2e-7)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax.accel.instances import InstancedAccel as InstancedAccelRef
from steeljax.gi import probes as probes_ref
from steeljax.gi import sh as sh_ref
from steeljax.gi import tets as tets_ref
from steeljax.gi.debug import overlay_probes as overlay_ref
from steeljax.gi.light_volume import LightVolume as LightVolumeRef
from steeljax.gi.light_volume import capture_probes as capture_ref
from steeljax.gi.light_volume import generate_light_volume as generate_ref
from steeljax.gi.sample import sample_light_volume as sample_ref
from steeljax.io import checkpoint as checkpoint_ref
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax_torch.accel.instances import InstancedAccel
from steeljax_torch.convert import from_jax_light_volume
from steeljax_torch.gi import probes, sh, tets
from steeljax_torch.gi.debug import overlay_probes
from steeljax_torch.gi.light_volume import (LightVolume, capture_probes,
                                            empty_light_volume,
                                            generate_light_volume)
from steeljax_torch.gi.sample import sample_light_volume
from steeljax_torch.io import checkpoint
from steeljax_torch.render.pt import renderer
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401

PIXEL_ATOL = 1e-4
WALK_ATOL = 1e-5
SH_ATOL = 1e-6
SH_RTOL = 1e-5
PROBES = np.array([[0.0, 1.0, 0.0], [0.4, 1.4, 0.4]], np.float32)
BAKE = dict(spp=1, resolution=8, min_edge=4.0, max_probes=64)

SCENES = {
    "cornell": lambda m: m.make_cornell_scene(sphere_detail=4),
    "lit": lambda m: m.make_parity_scene(4),
}


@pytest.fixture(scope="module")
def prepared():
    """{name: ((flat, tables) of the reference, (flat, tables) of the
    port)}, both from the same scene at env_resolution 16; "lit
    instanced" is the lit scene through the two-level structure (the
    capture of `render_cli --instancing --gi`)."""
    out = {}
    for name, make in SCENES.items():
        ref = renderer_ref.prepare_scene(make(builtin_ref),
                                         env_resolution=16)
        ours = renderer.prepare_scene(make(builtin), "cpu",
                                      env_resolution=16)
        out[name] = (ref, ours)
    out["lit instanced"] = (
        renderer_ref.prepare_scene(SCENES["lit"](builtin_ref),
                                   env_resolution=16,
                                   accel=InstancedAccelRef()),
        renderer.prepare_scene(SCENES["lit"](builtin), "cpu",
                               env_resolution=16,
                               accel=InstancedAccel(device="cpu")))
    return out


@pytest.fixture(scope="module")
def bakes(prepared):
    """The tiny Cornell bake of both packages (BAKE's budgets)."""
    (flat_r, tables_r), (flat, tables) = prepared["cornell"]
    return (generate_ref(flat_r, tables_r, **BAKE),
            generate_light_volume(flat, tables, **BAKE))


def _triangle():
    return np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)


PLACEMENTS = {
    "triangle min edge 0.5": (_triangle, dict(min_edge=0.5)),
    "triangle min edge 0.1": (_triangle, dict(min_edge=0.1)),
    "cornell min edge 4.0": ("cornell", dict(min_edge=4.0, max_probes=64)),
    "cornell min edge 0.5": ("cornell", dict(min_edge=0.5)),
    "cornell max_probes stride": ("cornell", dict(min_edge=0.5,
                                                  max_probes=300)),
}


def _tri_pos(source, prepared):
    if callable(source):
        return source()
    return np.array(prepared[source][0][0].tri_pos)


@pytest.mark.parametrize("case", list(PLACEMENTS))
def test_probe_positions_equal_reference(case, prepared):
    source, kwargs = PLACEMENTS[case]
    tri_pos = _tri_pos(source, prepared)
    ref = probes_ref.generate_probe_positions(tri_pos, **kwargs)
    ours = probes.generate_probe_positions(torch.as_tensor(tri_pos),
                                           **kwargs)
    assert ours.dtype == np.float32 and len(ours) >= 8
    np.testing.assert_array_equal(ours, ref)
    if "stride" in case:
        assert len(ref) <= kwargs["max_probes"]
        assert len(probes_ref.generate_probe_positions(
            tri_pos, min_edge=kwargs["min_edge"])) > kwargs["max_probes"]


def test_geometry_oracle_answers_as_reference():
    r = np.random.default_rng(3)
    tris = r.uniform(-2.0, 2.0, (40, 3, 3)).astype(np.float32)
    ref = probes_ref.GeometryOracle(tris)
    ours = probes.GeometryOracle(torch.as_tensor(tris))
    lo = r.uniform(-3.0, 2.0, (256, 3)).astype(np.float32)
    hi = lo + r.uniform(0.0, 1.5, (256, 3)).astype(np.float32)
    want = [ref.contains_geometry(a, b) for a, b in zip(lo, hi)]
    np.testing.assert_array_equal(ours.overlaps(lo, hi), want)
    assert ours.contains_geometry(lo[0], hi[0]) == want[0]
    assert 0 < sum(want) < len(want)


@pytest.mark.parametrize("case", ["unit cube", "cornell min edge 4.0",
                                  "cornell min edge 0.5"])
def test_tets_equal_reference(case, prepared):
    if case == "unit cube":
        positions = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                              for z in (0, 1)], np.float32)
    else:
        source, kwargs = PLACEMENTS[case]
        positions = probes_ref.generate_probe_positions(
            _tri_pos(source, prepared), **kwargs)
    ref = tets_ref.tetrahedralize(positions)
    ours = tets.tetrahedralize(positions)
    assert len(ours[0]) >= 5
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["unit cube", "cornell min edge 4.0"])
def test_tet_barycentric_equals_reference(case, prepared):
    """tets.barycentric at every tet's centroid and at seeded points: equal
    to the reference's; at a centroid inside (positive, summing to 1), and
    on the unit cube 1/4 each (tests/test_gi.py; the Cornell box's grid
    corners make near-flat tets, whose inverse matrices amplify the float32
    rounding of the positions and matrices, both packages alike)."""
    if case == "unit cube":
        positions = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                              for z in (0, 1)], np.float32)
    else:
        source, kwargs = PLACEMENTS[case]
        positions = probes_ref.generate_probe_positions(
            _tri_pos(source, prepared), **kwargs)
    vertices, _, matrices, used = tets.tetrahedralize(positions)
    points = np.random.default_rng(7).uniform(
        used.min(0), used.max(0), (len(vertices), 3))
    for t in range(len(vertices)):
        centroid = used[vertices[t]].mean(axis=0)
        for p in (centroid, points[t]):
            ours = tets.barycentric(used, vertices, matrices, t, p)
            np.testing.assert_array_equal(
                ours, tets_ref.barycentric(used, vertices, matrices, t, p))
        bary = tets.barycentric(used, vertices, matrices, t, centroid)
        assert (bary > 0).all()
        np.testing.assert_allclose(bary.sum(), 1.0, atol=1e-3)
        if case == "unit cube":
            np.testing.assert_allclose(bary, 0.25, atol=2e-3)


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_sh_basis_and_irradiance_match_reference():
    r = np.random.default_rng(5)
    n = _unit(r, 4096)
    coeffs = r.normal(size=(4096, 9, 3)).astype(np.float32)
    np.testing.assert_allclose(
        sh.sh_basis(torch.as_tensor(n)).numpy(),
        np.asarray(sh_ref.sh_basis(jnp.asarray(n))), rtol=0, atol=SH_ATOL)
    np.testing.assert_allclose(
        sh.eval_irradiance(torch.as_tensor(coeffs), torch.as_tensor(n))
        .numpy(),
        np.asarray(sh_ref.eval_irradiance(jnp.asarray(coeffs),
                                          jnp.asarray(n))),
        rtol=0, atol=SH_ATOL)


@pytest.mark.parametrize("delta", [0.05, 0.1])
def test_project_sh9_matches_reference(delta):
    cubes = np.random.default_rng(7).uniform(
        0.0, 2.0, (3, 6, 8, 8, 3)).astype(np.float32)
    dirs, sin_t = sh._sphere_grid(delta)
    dirs_ref, sin_ref = sh_ref._sphere_grid(delta)
    np.testing.assert_array_equal(dirs, dirs_ref)
    np.testing.assert_array_equal(sin_t, sin_ref)
    if delta == 0.05:
        assert len(dirs) == 126 * 63
    ref = np.asarray(sh_ref.project_sh9(jnp.asarray(cubes), delta=delta))
    ours = sh.project_sh9(torch.as_tensor(cubes), delta=delta).numpy()
    assert ours.shape == (3, 9, 3)
    scale = float(np.abs(ref).max())
    assert float(np.abs(ours - ref).max()) <= SH_RTOL * scale


def _walk_volume_ref():
    """tests/test_gi.py's _walk_volume (a 2-unit cube of 8 probes), with
    seeded coefficients in every band."""
    corners = np.array([[x, y, z] for x in (0, 2) for y in (0, 2)
                        for z in (0, 2)], np.float64)
    vertices, neighbors, matrices, used = tets_ref.tetrahedralize(corners)
    coeffs = np.random.default_rng(11).normal(
        0.0, 0.5, (8, 9, 3)).astype(np.float32)
    coeffs[:, 0] += 2.0
    return LightVolumeRef(
        positions=jnp.asarray(used, jnp.float32),
        tet_vertices=jnp.asarray(vertices),
        tet_neighbors=jnp.asarray(neighbors),
        tet_matrices=jnp.asarray(matrices),
        coefficients=jnp.asarray(coeffs))


@pytest.mark.parametrize("volume", ["walk volume", "cornell bake"])
def test_tet_walk_matches_reference(volume, bakes):
    lv_ref = _walk_volume_ref() if volume == "walk volume" else bakes[0]
    positions = np.asarray(lv_ref.positions)
    lo, hi = positions.min(axis=0), positions.max(axis=0)
    r = np.random.default_rng(13)
    span = hi - lo
    points = np.concatenate([
        r.uniform(lo - 0.25 * span, hi + 0.25 * span, (4096, 3)),
        positions]).astype(np.float32)
    normals = _unit(r, len(points))
    ref = np.asarray(sample_ref(lv_ref, jnp.asarray(points),
                                jnp.asarray(normals)))
    ours = sample_light_volume(from_jax_light_volume(lv_ref, "cpu"),
                               torch.as_tensor(points),
                               torch.as_tensor(normals)).numpy()
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    black = (ref == 0.0).all(axis=-1)
    assert 0 < black.sum() < len(points) - len(positions)
    np.testing.assert_array_equal(ours[black], 0.0)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=WALK_ATOL)


def test_tet_walk_of_an_empty_volume_is_black():
    lv = empty_light_volume("cpu")
    out = sample_light_volume(lv, torch.ones((5, 3)), torch.ones((5, 3)))
    assert out.shape == (5, 3) and not out.any()


@pytest.mark.parametrize("name", list(SCENES) + ["lit instanced"])
def test_capture_probes_matches_reference(name, prepared):
    (flat_r, tables_r), (flat, tables) = prepared[name]
    ref = np.asarray(capture_ref(flat_r, tables_r, PROBES, resolution=4,
                                 spp=2))
    ours = capture_probes(flat, tables, PROBES, resolution=4,
                          spp=2).numpy()
    assert ours.shape == (2, 6, 4, 4, 3) and np.isfinite(ours).all()
    assert ours.std() > 0
    np.testing.assert_allclose(ours, ref, rtol=0, atol=PIXEL_ATOL)
    if name.startswith("lit"):
        assert flat.light_count > 0


def test_generate_light_volume_matches_reference(bakes):
    ref, ours = bakes
    assert ours.positions.shape[0] == 27
    for key in ("positions", "tet_vertices", "tet_neighbors",
                "tet_matrices"):
        np.testing.assert_array_equal(getattr(ours, key).numpy(),
                                      np.asarray(getattr(ref, key)))
    np.testing.assert_allclose(ours.coefficients.numpy(),
                               np.asarray(ref.coefficients), rtol=0,
                               atol=PIXEL_ATOL)


def test_bake_of_too_few_probes_is_empty(prepared):
    """Fewer than 4 probes make no tet: the reference's empty volume."""
    (flat_r, tables_r), (flat, tables) = prepared["cornell"]
    ref = generate_ref(flat_r, tables_r, spp=1, resolution=2, min_edge=4.0,
                       max_probes=3)
    ours = generate_light_volume(flat, tables, spp=1, resolution=2,
                                 min_edge=4.0, max_probes=3)
    for key in ("positions", "tet_vertices", "tet_neighbors",
                "tet_matrices", "coefficients"):
        assert getattr(ours, key).shape == np.asarray(getattr(ref, key)).shape
    assert ours.tet_vertices.shape[0] == 0


def test_light_volume_checkpoints_cross_load(bakes, tmp_path):
    ref, ours = bakes
    ours_path, ref_path = tmp_path / "ours.npz", tmp_path / "ref.npz"
    checkpoint.save_light_volume(ours_path, ours)
    checkpoint_ref.save_light_volume(ref_path, ref)
    again = checkpoint.load_light_volume(ours_path, "cpu")
    in_ref = checkpoint_ref.load_light_volume(ours_path)
    from_ref = checkpoint.load_light_volume(ref_path, "cpu")
    carried = from_jax_light_volume(ref, "cpu")
    assert isinstance(again, LightVolume)
    for key in ("positions", "tet_vertices", "tet_neighbors",
                "tet_matrices", "coefficients"):
        mine = getattr(ours, key).numpy()
        np.testing.assert_array_equal(getattr(again, key).numpy(), mine)
        np.testing.assert_array_equal(np.asarray(getattr(in_ref, key)),
                                      mine)
        theirs = np.asarray(getattr(ref, key))
        np.testing.assert_array_equal(getattr(from_ref, key).numpy(),
                                      theirs)
        np.testing.assert_array_equal(getattr(carried, key).numpy(), theirs)
        assert getattr(from_ref, key).dtype == getattr(ours, key).dtype


def test_overlay_probes_matches_reference(bakes):
    from steeljax.core import camera as camera_ref

    ref, _ = bakes
    scene = builtin_ref.make_cornell_scene(sphere_detail=4)
    frame = camera_ref.make_frame(scene.camera_location,
                                  scene.camera_projection)
    image = np.random.default_rng(17).uniform(0, 1, (27, 48, 3)).astype(
        np.float32)
    want = overlay_ref(image, ref, frame.view_proj)
    got = overlay_probes(image, from_jax_light_volume(ref, "cpu"),
                         torch.as_tensor(np.asarray(frame.view_proj)))
    np.testing.assert_array_equal(got, want)
    assert (got != image).any()
