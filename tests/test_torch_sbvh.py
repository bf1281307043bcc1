"""The BVH build methods of the port against the reference on the CPU.

Builds: native.build_bvh_sah at alpha 1e-5 and bvh.build_bvh by every
method ("auto" with STEELJAX_SBVH unset and set to "1", "sah", "sbvh",
"morton") give the reference's arrays on three scenes that split:
make_foliage_scene(cards=2000), make_sunlit_stress_scene(20, 8) and
tests/test_sbvh.py's soup of long triangles.  _spatial_alpha reads
STEELJAX_SBVH by the reference's rules, and a failed native build raises.

Traces: over spatial-split tables (`order` a reference list, a triangle in
several slots) the plain versions of the nearest-hit, any-hit and
K-nearest kernels agree with steeljax.accel.traverse and with the
reference's exhaustive K-nearest oracle.  Hits are compared through
order[slot], the source triangle: two slots of one triangle are the same
hit, so a slot id that differs where the source ids agree is no mismatch.

Frames under STEELJAX_SBVH=1 (set for both packages): 32x18 path-traced
tiles (1 spp, accumulation index 0, 2 bounces) of a foliage scene (coarse
masks, the alpha re-trace), the same at multihit_k = 4 (the plain K5 over
the reference list, which keeps both slots of a duplicated hit; the
reference has no multi-hit path on the CPU, so its single-hit tile, at a
re-trace budget no ray exhausts), the sunlit stress scene (NEE; also with
the dense any-hit tables and with 16-wide rows), the textured stress
scene, instanced tables (the foliage cards' BLAS split), treelets and
forced chunks; no pixel differs by more than 1e-4 and rays_traced is
equal.  make_trace_tables builds prepare_tables' chunk from a reference
list.  The hybrid frame at 48x27 and, with
STEELJAX_RASTER=1, at 32x24 (the raster engages only on frames that tile
into 32x24 subtiles; 48x27 does not), are held to the reference's in the
same way.  A Morton-table tile, STEELJAX_LEAF_SIZE and
STEELJAX_REPACK=force|live tiles equal the reference's too.  Every split
case asserts that its tables hold more slots than source triangles."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax import native as native_ref
from steeljax.accel import bvh as bvh_ref
from steeljax.accel import dispatch as dispatch_ref
from steeljax.accel import traverse as traverse_ref
from steeljax.apps.kernel_parity import _multihit_oracle
from steeljax.core import camera as camera_ref
from steeljax.core.config import RenderConfig as RenderConfigRef
from steeljax.env.environment import load_environment as load_env_ref
from steeljax.env.sky import procedural_sky_cube as sky_cube_ref
from steeljax.render.hybrid.renderer import HybridRenderer as HybridRef
from steeljax.render.pt import integrator as integrator_ref
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax.scene import scene as scene_lib_ref
from steeljax_torch import native
from steeljax_torch.accel import bvh, dispatch
from steeljax_torch.accel.instances import InstancedAccel
from steeljax_torch.apps import kernel_parity
from steeljax_torch.convert import from_jax_environment
from steeljax_torch.core import camera as camera_lib
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.render.hybrid.renderer import HybridRenderer
from steeljax_torch.render.pt import integrator, renderer
from steeljax_torch.scene import builtin
from steeljax_torch.scene import scene as scene_lib
from steeljax_torch.scene.flatten import flatten_scene
from test_torch_hybrid import TINY_ENV, shade_mode0
from test_torch_support import one_torch_thread  # noqa: F401


W, H = 32, 18
PIXEL_ATOL = 1e-4


def long_soup(n: int, seed: int) -> np.ndarray:
    """tests/test_sbvh.py's soup with long_tris=True: thin triangles up to
    about 10 units long, the textbook case for spatial splits."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 3.0, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.1, (n, 3)).astype(np.float32)
    return np.stack([c, c + e1, c + e2], axis=1)


def _tri_pos(scene) -> np.ndarray:
    return flatten_scene(scene, "cpu", None).tri_pos.numpy()


BUILD_SCENES = {
    "foliage": (lambda: _tri_pos(builtin.make_foliage_scene(cards=2000)),
                48),
    "sunlit": (lambda: _tri_pos(builtin.make_sunlit_stress_scene(20, 8)),
               48),
    "soup": (lambda: long_soup(3000, 4), 24),
}


@functools.lru_cache(maxsize=None)
def build_input(name: str):
    make, leaf = BUILD_SCENES[name]
    return make(), leaf


@pytest.mark.parametrize("name", list(BUILD_SCENES))
def test_native_sbvh_equals_reference(name):
    tris, leaf = build_input(name)
    nodes, refs, depth = native.build_bvh_sah(tris, leaf, spatial_alpha=1e-5)
    nodes_r, refs_r, depth_r = native_ref.build_bvh_sah(
        tris, leaf, spatial_alpha=1e-5)
    np.testing.assert_array_equal(nodes, nodes_r)
    np.testing.assert_array_equal(refs, refs_r)
    assert depth == depth_r
    assert len(tris) < len(refs) <= int(len(tris) * 1.5) + 16
    assert np.isin(np.arange(len(tris)), refs).all()


@pytest.mark.parametrize("method", ["auto", "auto_sbvh1", "sah", "sbvh",
                                    "morton"])
@pytest.mark.parametrize("name", list(BUILD_SCENES))
def test_build_bvh_equals_reference(name, method, monkeypatch):
    tris, leaf = build_input(name)
    monkeypatch.delenv("STEELJAX_SBVH", raising=False)
    if method == "auto_sbvh1":
        monkeypatch.setenv("STEELJAX_SBVH", "1")
        method = "auto"
    tree, order, padded = bvh.build_bvh(tris, leaf, method)
    tree_r, order_r, padded_r = bvh_ref.build_bvh(tris, leaf, method)
    np.testing.assert_array_equal(tree.nodes, np.asarray(tree_r.nodes))
    np.testing.assert_array_equal(order, order_r)
    assert padded == padded_r
    assert (tree.depth, tree.max_leaf) == (tree_r.depth, tree_r.max_leaf)
    leaf_nodes = tree.nodes[:, 7] > 0
    assert (tree.nodes[leaf_nodes, 6] % bvh.TRI_PER_ROW == 0).all()
    slots = int((order >= 0).sum())
    split = method != "morton" and bvh._spatial_alpha(method) > 0
    assert (slots > len(tris)) == split
    # The scene splits: with spatial splits it holds more slots than
    # triangles (Cornell would not, and would prove nothing).
    _, sbvh_order, _ = bvh.build_bvh(tris, leaf, "sbvh")
    assert int((sbvh_order >= 0).sum()) > len(tris)


@pytest.mark.parametrize("env", [None, "0", "1", "0.01", "junk"])
def test_spatial_alpha_reads_the_switch(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("STEELJAX_SBVH", raising=False)
    else:
        monkeypatch.setenv("STEELJAX_SBVH", env)
    want = {None: 0.0, "0": 0.0, "1": 1e-5, "0.01": 0.01, "junk": 1e-5}[env]
    assert bvh._spatial_alpha("auto") == want == bvh_ref._spatial_alpha(
        "auto")
    assert bvh._spatial_alpha("sah") == 0.0 == bvh_ref._spatial_alpha("sah")
    assert bvh._spatial_alpha("sbvh") == 1e-5 == bvh_ref._spatial_alpha(
        "sbvh")


class _FailingBuilder:
    """A stand-in for the builder's library whose build returns status
    1."""

    @staticmethod
    def steeljax_build_sbvh(*args):
        return 1


@pytest.mark.parametrize("method", ["auto", "auto_sbvh1", "sah", "sbvh"])
def test_failed_native_build_raises(method, monkeypatch):
    monkeypatch.setattr(native, "bvh_library", lambda: _FailingBuilder)
    if method == "auto_sbvh1":
        monkeypatch.setenv("STEELJAX_SBVH", "1")
        method = "auto"
    with pytest.raises(RuntimeError, match="failed with status 1"):
        bvh.build_bvh(long_soup(64, 1), 24, method)
    with pytest.raises(ValueError, match="build method"):
        bvh.build_bvh(long_soup(64, 1), 24, "fastest")


# ---------------------------------------------------------------------------
# Plain traces over spatial-split tables, by source triangle
# ---------------------------------------------------------------------------

N_RAYS = 512


@pytest.fixture(scope="module")
def sbvh_soup():
    """Both packages' one-chunk tables of the long soup with splits, the
    permuted positions and flags (one per slot), the reference list and
    rays aimed at its triangles."""
    tris = long_soup(3000, 4)
    ds = np.random.default_rng(2).uniform(size=len(tris)) < 0.3
    tables, order, padded = dispatch.prepare_tables(
        tris, ds, "cpu", leaf_size=24, method="sbvh")
    tables_r, order_r, padded_r = dispatch_ref.prepare_tables(
        tris, ds, leaf_size=24, use_pallas=False, method="sbvh")
    np.testing.assert_array_equal(order, order_r)
    assert padded == padded_r
    assert int((order >= 0).sum()) > len(tris)
    perm = bvh.apply_permutation((None, order, padded),
                                 {"tri_pos": tris, "ds": ds})
    # Each ray aimed at a random triangle's centroid.
    rng = np.random.default_rng(5)
    o = rng.uniform(-12, 12, (N_RAYS, 3)).astype(np.float32)
    aim = tris[rng.integers(0, len(tris), N_RAYS)].mean(axis=1)
    d = (aim - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tables, tables_r, perm, order, o, d


def _source(order, slot):
    return np.where(slot >= 0, order[np.maximum(slot, 0)], -1)


@pytest.mark.parametrize("cull", [True, False])
def test_plain_nearest_matches_reference_by_source(sbvh_soup, cull):
    tables, tables_r, perm, order, o, d = sbvh_soup
    rec = dispatch.trace_nearest(tables, torch.from_numpy(o),
                                 torch.from_numpy(d), 1e-3, 1e9,
                                 cull_backface=cull)
    rec_r = traverse_ref.trace_nearest(
        tables_r.bvh, jnp.asarray(perm["tri_pos"]), jnp.asarray(perm["ds"]),
        jnp.asarray(o), jnp.asarray(d), 1e-3, 1e9, cull_backface=cull)
    hit, hit_r = rec["hit"].numpy(), np.asarray(rec_r["hit"])
    np.testing.assert_array_equal(hit, hit_r)
    assert hit.sum() > N_RAYS // 4
    np.testing.assert_allclose(rec["t"].numpy()[hit],
                               np.asarray(rec_r["t"])[hit], rtol=1e-5)
    src = _source(order, rec["tri"].numpy())[hit]
    src_r = _source(order, np.asarray(rec_r["tri"]))[hit]
    np.testing.assert_array_equal(src, src_r)
    for k in ("u", "v"):
        np.testing.assert_allclose(rec[k].numpy()[hit],
                                   np.asarray(rec_r[k])[hit], atol=5e-3)


def test_plain_anyhit_matches_reference(sbvh_soup):
    tables, tables_r, perm, order, o, d = sbvh_soup
    t_max = 6.0
    occ = dispatch.trace_any(tables, torch.from_numpy(o), torch.from_numpy(d),
                             1e-3, t_max).numpy()
    occ_r = np.asarray(traverse_ref.trace_any(
        tables_r.bvh, jnp.asarray(perm["tri_pos"]), jnp.asarray(perm["ds"]),
        jnp.asarray(o), jnp.asarray(d), 1e-3, t_max))
    np.testing.assert_array_equal(occ, occ_r)
    assert 0 < occ.sum() < N_RAYS


def test_make_trace_tables_over_a_reference_list(sbvh_soup):
    """dispatch.make_trace_tables from the tree and the permuted arrays
    (one record a slot) gives prepare_tables' chunk: equal rows, records
    and box, and equal traces."""
    tables, _, perm, order, o, d = sbvh_soup
    chunk = tables.chunks[0]
    made = dispatch.make_trace_tables(chunk.bvh, perm["tri_pos"], perm["ds"],
                                      "cpu").chunks[0]
    for name in ("tris_packed", "tri_records"):
        assert torch.equal(getattr(made, name), getattr(chunk, name)), name
    assert torch.equal(made.bvh8.rows, chunk.bvh8.rows)
    assert (made.rows, made.aabb) == (chunk.rows, chunk.aabb)
    rays = (torch.from_numpy(o), torch.from_numpy(d), 1e-3, 1e9)
    rec = dispatch.trace_nearest(dispatch.TraceTables(chunks=(made,)), *rays)
    rec_0 = dispatch.trace_nearest(tables, *rays)
    for k in rec_0:
        assert torch.equal(rec[k], rec_0[k]), k


def _by_source(slots, order):
    """(K, N) slots as each ray's (t, source id) list sorted by t, then
    source id: two slots of one triangle give equal entries."""
    t = np.asarray(slots["t"])
    src = _source(order, np.asarray(slots["tri"]))
    t_key = np.where(src >= 0, t, np.inf)
    idx = np.lexsort((src, t_key), axis=0)
    return (np.take_along_axis(t, idx, axis=0),
            np.take_along_axis(src, idx, axis=0))


@pytest.mark.parametrize("cull", [True, False])
def test_plain_multihit_matches_reference_oracle(sbvh_soup, cull):
    """The plain K5 over the reference list keeps every slot of a
    duplicated hit, as the reference's kernel and oracle do: each ray's
    four nearest hits are equal as (t, source id) multisets, and some rays
    hold one triangle twice."""
    tables, _, perm, order, o, d = sbvh_soup
    k = 4
    slots = dispatch.trace_multihit(tables, torch.from_numpy(o),
                                    torch.from_numpy(d), 1e-3, 1e9, k,
                                    cull_backface=cull)
    slots_r = _multihit_oracle(perm["tri_pos"], perm["ds"], o, d, 1e-3, 1e9,
                               k, cull, None)
    t, src = _by_source({f: v.numpy() for f, v in slots.items()}, order)
    t_r, src_r = _by_source(slots_r, order)
    np.testing.assert_array_equal(src, src_r)
    np.testing.assert_allclose(t[src >= 0], t_r[src_r >= 0], rtol=1e-5)
    twice = (src[1:] == src[:-1]) & (src[1:] >= 0)
    assert twice.any()


def test_parity_judges_slots_by_source(sbvh_soup):
    """kernel_parity.source_ids numbers the slots as the reference list
    does, and _compare_slots_by_source, which the card's run judges K5 over
    spatial-split tables by, passes a K-list that holds a duplicated hit
    once where the plain version holds it twice (a walk that reaches one
    copy), and fails one that misses a hit."""
    tables, _, perm, order, o, d = sbvh_soup
    src = kernel_parity.source_ids(perm["tri_pos"])
    real = order >= 0
    # Two real slots hold one triangle exactly when their ids agree.
    pairs = np.unique(np.stack([order[real], src[real]]), axis=1)
    assert (len(np.unique(pairs[0])) == len(np.unique(pairs[1]))
            == pairs.shape[1] == len(long_soup(3000, 4)))
    wide = {f: v.numpy() for f, v in dispatch.trace_multihit(
        tables, torch.from_numpy(o), torch.from_numpy(d), 1e-3, 1e9, 8,
        cull_backface=False).items()}
    plain = {f: v[:4] for f, v in wide.items()}
    (t, u, v, s), _ = kernel_parity._distinct_slots(wide, src)
    # The walk's list: each hit once, the slot its first copy holds.
    first_slot = np.full(src.max() + 1, -1)
    first_slot[src[::-1]] = np.arange(len(src))[::-1]
    walk = {"t": t[:4], "u": u[:4], "v": v[:4],
            "tri": np.where(s[:4] >= 0, first_slot[np.maximum(s[:4], 0)],
                            -1).astype(np.int32)}
    results = {}
    assert kernel_parity._compare_slots_by_source("walk", walk, plain, src,
                                                  results)
    assert results["walk"]["repeats_plain"] > 0
    assert results["walk"]["repeats_kernel"] == 0
    # A walk that misses the second distinct hit of many rays fails.
    missed = {f: x.copy() for f, x in walk.items()}
    for f in missed:
        missed[f][1:3] = walk[f][2:4]
    assert not kernel_parity._compare_slots_by_source("missed", missed,
                                                      plain, src, results)


# ---------------------------------------------------------------------------
# Frames under STEELJAX_SBVH=1
# ---------------------------------------------------------------------------

def _pixels():
    ys, xs = np.meshgrid(np.arange(H, dtype=np.int32),
                         np.arange(W, dtype=np.int32), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _tile(scene, flat, tables, config):
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    px, py = _pixels()
    result, stats = integrator.render_pixels(
        flat, tables, frame.inverse_view, frame.inverse_proj, 0.01, 100.0,
        W, H, px, py, 0, 0, config, return_stats=True)
    return result.numpy(), float(stats["rays_traced"])


def _tile_ref(scene, flat, tables, config):
    frame = camera_ref.make_frame(scene.camera_location,
                                  scene.camera_projection)
    px, py = _pixels()
    result, stats = integrator_ref.render_pixels(
        flat, tables, jnp.asarray(frame.inverse_view),
        jnp.asarray(frame.inverse_proj), 0.01, 100.0, W, H, jnp.asarray(px),
        jnp.asarray(py), 0, 0, config, return_stats=True)
    return np.asarray(result), float(stats["rays_traced"])


def _check(ours, ref, rays, rays_ref, label):
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    delta = np.abs(ours - ref).max(axis=-1).reshape(-1)
    diverging = int((delta > PIXEL_ATOL).sum())
    print(f"{label}: {diverging} of {delta.size} pixels differ by more "
          f"than {PIXEL_ATOL} (max {float(delta.max()):.3e}); rays_traced "
          f"{rays} vs {rays_ref}")
    assert diverging == 0
    assert rays == rays_ref
    assert float(ours.std()) > 0.0


def _foliage(module, cards=300):
    scene = module.make_foliage_scene(cards=cards, region=3.0)
    scene.camera_location = type(scene.camera_location)(
        position=np.array([0.0, 1.5, 6.0], np.float32),
        direction=np.array([0.0, 0.0, -1.0], np.float32),
        up=np.array([0.0, 1.0, 0.0], np.float32))
    return scene


def _slots(tables) -> int:
    """Real slots of flat or treelet tables (pad slots excluded)."""
    return sum(int(c.bvh.nodes[c.bvh.nodes[:, 7] > 0, 7].sum())
               for c in tables.chunks)


def _sunlit(module, scene_module):
    """make_sunlit_stress_scene(20, 8): the stress scene's 20 instances at
    sphere detail 8 and the path L sun (the reference's builtin has no
    maker of its own)."""
    scene = module.make_stress_scene(20, 8)
    sun = scene_module.Entity(name="sun", local_transform=module._trs(
        (0, 0, 0), (0, 0, 1), -2.0))
    sun.light = scene_module.Light(type=scene_module.LightType.DIRECTIONAL,
                                   color=np.array([3.0, 2.9, 2.7],
                                                  np.float32))
    scene.add_entity(sun)
    return scene


def _textured(module):
    return module.make_stress_scene(8, 4, textured=True)


SCENE_MODULES = {"ours": (builtin, scene_lib),
                 "ref": (builtin_ref, scene_lib_ref)}
# The scenes of the tiles, by the package ("ours" or "ref") they are built
# for.
TILE_SCENES = {
    "foliage": lambda m, s: _foliage(m),
    "sunlit": lambda m, s: _sunlit(m, s),
    "textured": lambda m, s: _textured(m),
}


def tile_config(config_type, scene_name: str):
    """The tiles' RenderConfig: 2 bounces (the primary and one secondary
    bounce, each with its shadow rays and re-traces; the reference compiles
    in half the time of 4), the foliage tile at a re-trace budget no ray of
    it exhausts (7 passes suffice; at the default 4 one ray ends on a
    rejected leaf, which a K-nearest walk resolves), so that the K-nearest
    path must give the single-hit path's tile."""
    extra = dict(max_alpha_retrace=8) if scene_name == "foliage" else {}
    return config_type(width=W, height=H, max_bounce_count=2, **extra)


def _make(name: str, package: str):
    return TILE_SCENES[name](*SCENE_MODULES[package])


@pytest.fixture(scope="module")
def sbvh_refs():
    """The reference's tile of each of TILE_SCENES under STEELJAX_SBVH=1,
    rendered once for the module: (tile, rays_traced) by scene."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STEELJAX_SBVH", "1")
        for name in TILE_SCENES:
            scene = _make(name, "ref")
            out[name] = _tile_ref(
                scene, *renderer_ref.prepare_scene(scene, env_resolution=16),
                tile_config(RenderConfigRef, name))
    return out


# name: (scene of TILE_SCENES, the port's prepare_scene arguments, the
# chunk size of the port's tables or None).  The reference renders each
# scene once, by its own defaults (sbvh_refs): the image does not depend on
# the structure, so the port's instanced, treelet and chunked tables and
# its K-nearest path are held to the reference's one-chunk single-hit tile
# of the same scene.  The instanced tables are the foliage scene's, whose
# cards BLAS splits.
TILE_CASES = {
    "foliage": ("foliage", dict(fine_masks=False), None),
    "foliage_multihit": ("foliage", dict(multihit_k=4), None),
    "sunlit_nee": ("sunlit", {}, None),
    "sunlit_dense_anyhit": ("sunlit", dict(dense_anyhit=True), None),
    "sunlit_width16": ("sunlit", dict(snode_width=16), None),
    "textured": ("textured", {}, None),
    "instanced": ("foliage", {}, None),
    "treelets": ("textured", dict(leaf_size=8, treelets=True,
                                  treelet_tris=64), None),
    "chunks": ("textured", {}, 300),
}


@pytest.mark.parametrize("name", list(TILE_CASES))
def test_sbvh_tile_matches_reference(name, sbvh_refs, monkeypatch):
    scene_name, prepare, max_chunk = TILE_CASES[name]
    monkeypatch.setenv("STEELJAX_SBVH", "1")
    if max_chunk is not None:
        monkeypatch.setattr(dispatch, "MAX_CHUNK_TRIS", max_chunk)
    scene = _make(scene_name, "ours")
    accel = InstancedAccel(device="cpu") if name == "instanced" else None
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16,
                                          accel=accel, **prepare)
    if accel is not None:
        slots = sum(int((b.tri_pos[:, 0, 0] < 1e37).sum())
                    for b in accel._blas.values())
        assert slots > sum(len(p.indices) // 3 for p in scene.primitives)
    else:
        assert _slots(tables) > flat.source_tri_count
    if name == "treelets":
        assert tables.treelets is not None and tables.treelets.count > 4
    if max_chunk is not None:
        assert len(tables.chunks) > 1
    ours, rays = _tile(scene, flat, tables,
                       tile_config(RenderConfig, scene_name))
    ref, rays_r = sbvh_refs[scene_name]
    _check(ours, ref, rays, rays_r, f"{name} under STEELJAX_SBVH=1")


def test_morton_tile_matches_reference(monkeypatch):
    """prepare_tables(method="morton") in both packages' prepare_scene (the
    reference's renderer has no method argument, so the test binds it)."""
    monkeypatch.setattr(renderer, "prepare_tables", functools.partial(
        dispatch.prepare_tables, method="morton"))
    monkeypatch.setattr(renderer_ref, "prepare_tables", functools.partial(
        dispatch_ref.prepare_tables, method="morton"))
    scene, scene_r = _textured(builtin), _textured(builtin_ref)
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16)
    flat_r, tables_r = renderer_ref.prepare_scene(scene_r, env_resolution=16)
    nodes = tables.chunks[0].bvh.nodes
    np.testing.assert_array_equal(nodes, np.asarray(tables_r.bvh.nodes))
    assert (len(nodes) + 1) & len(nodes) == 0  # a complete tree
    ours, rays = _tile(scene, flat, tables,
                       tile_config(RenderConfig, "textured"))
    ref, rays_r = _tile_ref(scene_r, flat_r, tables_r,
                            tile_config(RenderConfigRef, "textured"))
    _check(ours, ref, rays, rays_r, "Morton tables")


def test_leaf_size_switch_tile_matches_reference(monkeypatch):
    monkeypatch.setenv("STEELJAX_LEAF_SIZE", "8")
    scene, scene_r = _textured(builtin), _textured(builtin_ref)
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16)
    flat_r, tables_r = renderer_ref.prepare_scene(scene_r, env_resolution=16)
    assert tables.chunks[0].bvh.max_leaf == tables_r.bvh.max_leaf == 8
    np.testing.assert_array_equal(tables.chunks[0].bvh.nodes,
                                  np.asarray(tables_r.bvh.nodes))
    ours, rays = _tile(scene, flat, tables,
                       tile_config(RenderConfig, "textured"))
    ref, rays_r = _tile_ref(scene_r, flat_r, tables_r,
                            tile_config(RenderConfigRef, "textured"))
    _check(ours, ref, rays, rays_r, "STEELJAX_LEAF_SIZE=8")


@pytest.mark.parametrize("mode", ["force", "live"])
def test_repack_switch_tile_matches_reference(mode, monkeypatch):
    """STEELJAX_REPACK below REPACK_MIN_TRIS in both packages: the port's
    repack runs before bounce 1 (a spy counts it), by the full key
    or by liveness alone, and the tile equals the reference's.  The
    reference reads the switch while it traces its program, so its jit
    cache is cleared around the call."""
    monkeypatch.setenv("STEELJAX_REPACK", mode)
    keys = []
    original = integrator.repack_rays

    def spy(key, columns):
        keys.append(key)
        return original(key, columns)

    monkeypatch.setattr(integrator, "repack_rays", spy)
    scene, scene_r = _textured(builtin), _textured(builtin_ref)
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16)
    assert integrator._total_triangles(tables) < integrator.REPACK_MIN_TRIS
    ours, rays = _tile(scene, flat, tables,
                       tile_config(RenderConfig, "textured"))
    assert len(keys) == 1
    # The live key holds the dead and missed bits alone.
    assert all(bool(((k & ((1 << 18) - 1)) == 0).all()) == (mode == "live")
               for k in keys)
    integrator_ref.render_pixels.clear_cache()
    try:
        ref, rays_r = _tile_ref(
            scene_r, *renderer_ref.prepare_scene(scene_r, env_resolution=16),
            tile_config(RenderConfigRef, "textured"))
    finally:
        integrator_ref.render_pixels.clear_cache()
    _check(ours, ref, rays, rays_r, f"STEELJAX_REPACK={mode}")


# ---------------------------------------------------------------------------
# Hybrid frames under STEELJAX_SBVH=1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def envs():
    ref = load_env_ref(cube=sky_cube_ref(16), **TINY_ENV)
    return from_jax_environment(ref, "cpu"), ref


@pytest.mark.parametrize("raster", [False, True])
def test_sbvh_hybrid_frame_matches_reference(raster, envs, monkeypatch):
    """The foliage scene's hybrid frame (the alpha re-trace of the G-buffer
    and of the sun's shadow rays) with the port's tables in shade mode 0
    and coarse masks alone, the reference's path on the CPU
    (tests/test_torch_hybrid.py): at 48x27 traced, at 32x24 with
    STEELJAX_RASTER=1, where the raster reads flat.tri_pos with its
    duplicated slots."""
    monkeypatch.setenv("STEELJAX_SBVH", "1")
    if raster:
        monkeypatch.setenv("STEELJAX_RASTER", "1")
    fw, fh = (32, 24) if raster else (48, 27)
    scene, scene_r = _make("foliage", "ours"), _make("foliage", "ref")
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16,
                                          fine_masks=False)
    assert _slots(tables) > flat.source_tri_count
    ours = HybridRenderer(scene, fw, fh, RenderConfig(width=fw, height=fh),
                          environment=envs[0],
                          prepared=(flat, shade_mode0(tables)), device="cpu")
    ref = HybridRef(scene_r, fw, fh, RenderConfigRef(width=fw, height=fh),
                    environment=envs[1], prepared=tuple(
                        renderer_ref.prepare_scene(scene_r,
                                                   env_resolution=16)))
    assert (ours.raster_scene is not None) == raster
    assert (ref.raster_scene is not None) == raster
    _check(ours.render_frame(), np.asarray(ref.render_frame()), 0.0, 0.0,
           f"hybrid {fw}x{fh}{' raster' if raster else ''}")


def test_parity_app_flags_parse():
    args = kernel_parity.parser().parse_args(["--rays", "64", "--tris",
                                              "100", "-o", "p.json"])
    assert (args.rays, args.tris, args.output) == (64, 100, "p.json")
    args = kernel_parity.parser().parse_args([])
    assert (args.rays, args.tris, args.device) == (10240, 30000, "cuda")
