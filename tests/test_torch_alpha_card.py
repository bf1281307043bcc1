"""The exact alpha test's kernel (csrc/alphatest.cu, surface.alpha_test) on
the card: `torch.equal` to its plain version (surface.alpha_rejected over
surface.shade_rows, run on the card) on every ray of the tests of one
eager 1280x720 frame of the benchmark's foliage scene (500,000 serrated
leaf cards, a sun): the primaries, the first-bounce material rays, the
shadow rays (culling off) and a re-trace pass whose resolved rays carry
the dead interval and miss (tri = -1); on the same rays over shading rows
whose materials were changed to alpha-tested ones without a texture and
to opaque ones, and over a scene without textures; on the K nearest slots
of the multi-hit kernel K5 through integrator._resolve_multihit; over
two-chunk tables, whose records carry global triangle ids; over instanced
tables (the uvs of the pool triangles' blas_shade rows, the material of
the instances' inst_shade rows), their materials also changed as above;
and captured in a CUDA graph and replayed on other rays.  A frame through
the kernel, over flat and over instanced tables, is bit-equal to the same
frame through the plain test, and counts its 40 tests as the kernel's.  Every test skips without a CUDA device.  This file
imports no JAX; on the card's machine, which has none, run it without the
suite's conftest: `python -m pytest --noconftest -p no:cacheprovider -q -m
card tests/test_torch_alpha_card.py`."""

import dataclasses

import pytest
import torch

from steeljax_torch.accel import dispatch, instances
from steeljax_torch.core import camera as camera_lib
from steeljax_torch.core import profiling
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.render import surface
from steeljax_torch.render.pt import frame_graphs, integrator, renderer
from steeljax_torch.scene import builtin
from steeljax_torch.scene.flatten import TriShade
from steeljax_torch.scene.material import MaterialFlags

W, H = 1280, 720
# A lit frame's exact tests: (1 trace + 4 re-trace passes) x (material +
# shadow) x 4 bounces, in that order.
TESTS_PER_BOUNCE = 10
# The recorded calls of the benchmark scene's frame held by name: bounce
# 0's first material test (the primaries), its second re-trace pass, its
# first shadow test, and bounce 1's first material test.
CALLS = {"primaries": 0, "retrace_pass": 2, "shadow": 5, "first_bounce": 10}


def _plain(flat, tables, rec):
    return surface.alpha_rejected(flat, rec,
                                  surface.shade_rows(flat, tables, rec))


def _render(flat, tables, scene, index: int = 0):
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    px, py, _ = integrator.tiled_order(W, H)
    return integrator.render_pixels(
        flat, tables, frame.inverse_view, frame.inverse_proj,
        frame.camera_near, frame.camera_far, W, H, px, py, index, 3,
        RenderConfig(width=W, height=H), return_stats=True)


def _recorded(flat, tables, scene, what="tests"):
    """One eager frame: the records of its alpha_test calls (what="tests")
    or the slots of its _resolve_multihit calls (what="slots"), copied."""
    seen = []
    name = "alpha_test" if what == "tests" else "_resolve_multihit"
    real = getattr(integrator, name)

    def recording(scene_, tables_, arg):
        seen.append({k: v.clone() for k, v in arg.items()})
        return real(scene_, tables_, arg)

    kept = integrator.FRAME_GRAPHS
    setattr(integrator, name, recording)
    integrator.FRAME_GRAPHS = frame_graphs.FrameGraphs(frame_graphs.Eager())
    try:
        _render(flat, tables, scene)
    finally:
        setattr(integrator, name, real)
        integrator.FRAME_GRAPHS = kept
    torch.cuda.synchronize()
    return seen


@pytest.fixture(scope="module")
def foliage():
    """(scene, flat, tables, records of the frame's 40 tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = builtin.make_foliage_scene()
    flat, tables = renderer.prepare_scene(scene, torch.device("cuda:0"),
                                          env_resolution=64)
    return scene, flat, tables, _recorded(flat, tables, scene)


def _held(flat, tables, rec) -> torch.Tensor:
    """The kernel's answer on `rec`, asserted equal to the plain one."""
    before = surface.COUNTS["alpha"]
    got = surface.alpha_test(flat, tables, rec)
    assert surface.COUNTS["alpha"] == before + 1
    want = _plain(flat, tables, rec)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got, want)
    return want


@pytest.mark.card
@pytest.mark.parametrize("call", sorted(CALLS))
def test_kernel_equals_plain_on_the_frames_rays(foliage, call):
    _, flat, tables, recs = foliage
    assert len(recs) == 4 * TESTS_PER_BOUNCE
    rec = recs[CALLS[call]]
    assert rec["tri"].shape[0] == W * H
    want = _held(flat, tables, rec)
    assert want.any() and (rec["hit"] & ~want).any()
    if call == "retrace_pass":
        # Resolved rays carry the dead interval: most miss, with tri -1.
        missed = ~rec["hit"]
        assert missed.float().mean() > 0.5
        assert torch.all(rec["tri"][missed] == -1)


@pytest.mark.card
def test_kernel_equals_plain_on_every_test_of_the_frame(foliage):
    _, flat, tables, recs = foliage
    for rec in recs:
        _held(flat, tables, rec)


@pytest.mark.card
def test_misses_are_never_rejected(foliage):
    _, flat, tables, recs = foliage
    rec = dict(recs[0])
    rec["hit"] = torch.zeros_like(rec["hit"])
    rec["tri"] = torch.full_like(rec["tri"], -1)
    assert not _held(flat, tables, rec).any()


def _materials_changed(flat, seed: int):
    """The scene with each triangle's shading row given, by a draw from
    `seed`, an alpha-tested material without a texture (texture id -1), an
    opaque one (flags without ALPHA_TEST), or its own textured material,
    each with an alpha factor drawn from [0, 1)."""
    g = torch.Generator(device=flat.device)
    g.manual_seed(seed)
    rows = flat.tri_shade.clone()
    n = rows.shape[0]
    kind = torch.randint(0, 3, (n,), generator=g, device=flat.device)
    rows[:, TriShade.ALPHA] = torch.rand(n, generator=g, device=flat.device)
    rows[kind == 0, TriShade.TEX_IDS.start] = -1.0
    rows[kind == 1, TriShade.FLAGS] = float(MaterialFlags.DOUBLE_SIDED)
    return flat.replace(tri_shade=rows), kind


@pytest.mark.card
def test_untextured_and_opaque_materials(foliage):
    _, flat, tables, recs = foliage
    changed, kind = _materials_changed(flat, 5)
    for call in ("primaries", "shadow", "first_bounce"):
        rec = recs[CALLS[call]]
        want = _held(changed, tables, rec)
        tri = rec["tri"].clamp(min=0).long()
        hit = rec["hit"]
        assert want[hit & (kind[tri] == 0)].any()
        assert not want[hit & (kind[tri] == 1)].any()


@pytest.mark.card
def test_a_scene_without_textures(foliage):
    _, flat, tables, recs = foliage
    changed, _ = _materials_changed(flat, 7)
    device = flat.device
    bare = changed.replace(
        has_textures=False,
        atlas=torch.zeros((1, 16), dtype=torch.uint8, device=device),
        tex_offset=torch.zeros((1, flat.tex_offset.shape[1]),
                               dtype=torch.int32, device=device),
        tex_size=torch.ones((1, 2), dtype=torch.int32, device=device))
    for call in ("primaries", "retrace_pass"):
        want = _held(bare, tables, recs[CALLS[call]])
        assert want.any()


@pytest.mark.card
def test_a_call_captured_in_a_cuda_graph(foliage):
    _, flat, tables, recs = foliage
    buffers = {k: v.clone() for k, v in recs[CALLS["primaries"]].items()}
    surface.alpha_test(flat, tables, buffers)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = surface.alpha_test(flat, tables, buffers)
    for call in ("shadow", "retrace_pass", "first_bounce"):
        rec = recs[CALLS[call]]
        for k in buffers:
            buffers[k].copy_(rec[k])
        graph.replay()
        want = _plain(flat, tables, rec)
        torch.cuda.synchronize()
        assert torch.equal(out, want), call


def _frame_against_plain(scene, flat, tables):
    """A frame through the kernel equals the same frame through the plain
    test, and its row counts its 40 tests as the kernel's."""
    kept = integrator.FRAME_GRAPHS
    integrator.FRAME_GRAPHS = frame_graphs.FrameGraphs(frame_graphs.Eager())
    profiling.reset()
    try:
        got, got_stats = _render(flat, tables, scene, 1)
        row = profiling.record()["rows"][-1]
        integrator.alpha_test = lambda s, t, rec: _plain(s, t, rec)
        try:
            want, want_stats = _render(flat, tables, scene, 1)
        finally:
            integrator.alpha_test = surface.alpha_test
    finally:
        integrator.FRAME_GRAPHS = kept
        profiling.reset()
    assert row["counters"]["integrator.alpha_tests"] == 4 * TESTS_PER_BOUNCE
    assert row["counters"]["integrator.alpha_kernel_tests"] == \
        4 * TESTS_PER_BOUNCE
    assert torch.equal(got, want)
    assert torch.equal(got_stats["rays_traced"], want_stats["rays_traced"])
    for (_, a), (_, b) in zip(got_stats["alpha_retrace"],
                              want_stats["alpha_retrace"]):
        assert [int(x) for x in a] == [int(x) for x in b]


@pytest.mark.card
def test_a_frame_equals_the_plain_tests_frame(foliage):
    scene, flat, tables, _ = foliage
    _frame_against_plain(scene, flat, tables)


def _small_foliage():
    """A foliage scene of 100,000 cards (200,002 triangles)."""
    return builtin.make_foliage_scene(cards=100_000)


@pytest.mark.card
def test_the_multihit_kernels_slots(foliage):
    device = foliage[1].device
    scene = _small_foliage()
    flat, tables = renderer.prepare_scene(scene, device, env_resolution=64,
                                          multihit_k=4)
    slots = _recorded(flat, tables, scene, what="slots")
    assert len(slots) == 4 * TESTS_PER_BOUNCE
    for at in (0, 5):
        for k in range(tables.multihit_k):
            rec = {f: slots[at][f][k] for f in ("t", "u", "v", "tri")}
            rec["hit"] = rec["tri"] >= 0
            _held(flat, tables, rec)
        got = integrator._resolve_multihit(flat, tables, slots[at])
        integrator.alpha_test = lambda s, t, rec: _plain(s, t, rec)
        try:
            want = integrator._resolve_multihit(flat, tables, slots[at])
        finally:
            integrator.alpha_test = surface.alpha_test
        torch.cuda.synchronize()
        for f in want[0]:
            assert torch.equal(got[0][f], want[0][f]), f
        assert torch.equal(got[1], want[1])


@pytest.mark.card
def test_two_chunk_tables_with_global_ids(foliage):
    device = foliage[1].device
    scene = _small_foliage()
    kept = dispatch.MAX_CHUNK_TRIS
    dispatch.MAX_CHUNK_TRIS = 120_000
    try:
        flat, tables = renderer.prepare_scene(scene, device,
                                              env_resolution=64)
    finally:
        dispatch.MAX_CHUNK_TRIS = kept
    assert len(tables.chunks) == 2
    recs = _recorded(flat, tables, scene)
    assert len(recs) == 4 * TESTS_PER_BOUNCE
    top = 0
    for rec in recs:
        _held(flat, tables, rec)
        top = max(top, int(rec["tri"].max()))
    # Hits in the second chunk carry ids past the first chunk's rows.
    assert top >= tables.chunks[1].row_offset


@pytest.fixture(scope="module")
def instanced(foliage):
    """(scene, flat, instanced tables, records of the frame's 40 tests) of
    the smaller foliage scene through the two-level structure."""
    device = foliage[1].device
    scene = _small_foliage()
    flat, tables = renderer.prepare_scene(
        scene, device, env_resolution=64,
        accel=instances.InstancedAccel(device=device))
    assert isinstance(tables, instances.InstancedTables)
    return scene, flat, tables, _recorded(flat, tables, scene)


@pytest.mark.card
def test_instanced_tables_on_every_test_of_the_frame(instanced):
    _, flat, tables, recs = instanced
    assert len(recs) == 4 * TESTS_PER_BOUNCE
    rejected = kept = 0
    for rec in recs:
        assert rec["inst"].dtype == torch.int32
        want = _held(flat, tables, rec)
        rejected += int(want.sum())
        kept += int((rec["hit"] & ~want).sum())
    assert rejected and kept


def _inst_col(column: int) -> int:
    """The inst_shade column of TriShade's material column `column`."""
    return instances.InstShade.MATERIAL.start + column - TriShade.MAT_ID


def _instance_materials(tables, columns: dict):
    """The tables with each of TriShade's material `columns` set to its
    value in every instance's inst_shade row."""
    rows = tables.inst_shade.clone()
    for column, value in columns.items():
        rows[:, _inst_col(column)] = value
    return dataclasses.replace(tables, inst_shade=rows)


@pytest.mark.card
def test_instanced_untextured_and_opaque_materials(instanced):
    """Every instance's material without a texture, at an alpha below its
    cutoff, rejects every alpha-tested hit; at its cutoff none; without
    the ALPHA_TEST flag none."""
    _, flat, tables, recs = instanced
    rows = tables.inst_shade
    tested = (rows[:, _inst_col(TriShade.FLAGS)].to(torch.int32)
              & int(MaterialFlags.ALPHA_TEST)) != 0
    cutoff = rows[:, _inst_col(TriShade.ALPHA_CUTOFF)]
    assert tested.any()
    bare = {TriShade.TEX_IDS.start: -1.0}
    low = _instance_materials(tables, {**bare, TriShade.ALPHA: cutoff * 0.5})
    at_cutoff = _instance_materials(tables, {**bare, TriShade.ALPHA: cutoff})
    opaque = _instance_materials(
        tables, {**bare, TriShade.ALPHA: cutoff * 0.5,
                 TriShade.FLAGS: float(MaterialFlags.DOUBLE_SIDED)})
    for call in ("primaries", "shadow", "first_bounce"):
        rec = recs[CALLS[call]]
        hit_tested = rec["hit"] & tested[rec["inst"].clamp(min=0).long()]
        assert hit_tested.any()
        assert torch.equal(_held(flat, low, rec), hit_tested)
        assert not _held(flat, at_cutoff, rec).any()
        assert not _held(flat, opaque, rec).any()


@pytest.mark.card
def test_an_instanced_frame_equals_the_plain_tests_frame(instanced):
    scene, flat, tables, _ = instanced
    _frame_against_plain(scene, flat, tables)
