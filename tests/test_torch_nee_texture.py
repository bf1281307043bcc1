"""The slice's new elementwise pieces against the reference on seeded
inputs: texture sampling, the supplied-tangent frame, the composed BRDF,
next-event estimation (light estimates, light distortion, the whole
direct-lighting term with its shadow rays) and the ray-repack sort.

Tolerances, as in test_torch_integrator.py: 1e-5 absolute (fp32 operation
order, a few ulp of values of order 1), plus 1e-4 relative where the value
passes through the BRDF (up to ~1e3 at sharp GGX peaks, d_ggx's
cancellation).  RNG streams, sort keys and permutations are exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax.render import texture as texture_ref
from steeljax.render.pt import brdf as brdf_ref
from steeljax.render.pt import integrator as integrator_ref
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax.scene import scene as scene_ref
from steeljax.scene.flatten import flatten_scene as flatten_ref
from steeljax_torch.render import texture
from steeljax_torch.render.pt import brdf, integrator, renderer, stages
from steeljax_torch.scene import builtin
from steeljax_torch.scene import scene as scene_lib
from steeljax_torch.scene.flatten import flatten_scene
from test_torch_support import one_torch_thread  # noqa: F401


ATOL = 1e-5
RTOL = 1e-4
N = 4096


def _unit(r, n):
    v = r.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _close(ours, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


def _seeds(r, n):
    return r.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)


def test_sample_bilinear():
    """Three textures of odd sizes (mip chains included) and the brick
    texture, sampled at uvs outside [0, 1) (repeat wrap) with ids of
    -1 (clamped to texture 0, as the reference does)."""
    r = np.random.default_rng(0)
    textures = [r.integers(0, 256, (h, w, 4)).astype(np.uint8)
                for h, w in ((5, 7), (16, 16), (1, 3))]
    textures.append(builtin._brick_texture())
    flats = []
    for make, flatten in ((scene_lib.Scene, lambda s: flatten_scene(s, "cpu")),
                          (scene_ref.Scene, flatten_ref)):
        scene = make()
        scene.textures.extend(textures)
        flats.append(flatten(scene))
    ours, ref = flats
    tex_id = r.integers(-1, len(textures), N).astype(np.int32)
    uv = r.uniform(-2.5, 3.5, (N, 2)).astype(np.float32)
    got = texture.sample_bilinear(ours.atlas, ours.tex_offset, ours.tex_size,
                                  torch.from_numpy(tex_id),
                                  torch.from_numpy(uv))
    want = texture_ref.sample_bilinear(ref.atlas, ref.tex_offset,
                                       ref.tex_size, jnp.asarray(tex_id),
                                       jnp.asarray(uv))
    assert got.shape == (N, 4)
    _close(got, want)


def test_make_tbn_with_tangent():
    r = np.random.default_rng(1)
    n, t = _unit(r, N), _unit(r, N)
    t[:3] = n[:3]  # a tangent along the normal degenerates to zero
    ours = brdf.make_tbn_with_tangent(torch.from_numpy(n), torch.from_numpy(t))
    ref = brdf_ref.make_tbn_with_tangent(jnp.asarray(n), jnp.asarray(t))
    for a, b in zip(ours, ref):
        _close(a, b)


@pytest.mark.parametrize("compose", ["both", "diffuse", "specular"])
def test_evaluate_brdf_compose(compose):
    r = np.random.default_rng(2)
    args = (r.uniform(0, 1, (N, 3)).astype(np.float32),
            r.uniform(0.05, 1, N).astype(np.float32),
            (r.uniform(size=N) < 0.5).astype(np.float32),
            np.zeros((N, 3), np.float32))
    wo, wi = _unit(r, N), _unit(r, N)
    wo[:, 2] = np.abs(wo[:, 2])
    wh = wo + wi
    wh /= np.maximum(np.linalg.norm(wh, axis=-1, keepdims=True), 1e-20)
    ours = brdf.evaluate_brdf(
        brdf.make_surface(*(torch.from_numpy(a) for a in args)),
        torch.from_numpy(wo), torch.from_numpy(wi), torch.from_numpy(wh),
        compose=compose)
    ref = brdf_ref.evaluate_brdf(
        brdf_ref.make_surface(*(jnp.asarray(a) for a in args)),
        jnp.asarray(wo), jnp.asarray(wi), jnp.asarray(wh), compose=compose)
    _close(ours, ref, rtol=RTOL)


def _two_light_scenes():
    """The parity scene (directional sun) plus a point light, in both
    packages."""
    scenes = []
    for lib, bl in ((scene_lib, builtin), (scene_ref, builtin_ref)):
        scene = bl.make_parity_scene(4)
        lamp = lib.Entity(name="lamp",
                          local_transform=bl._trs((1.0, 2.5, 0.5)))
        lamp.light = lib.Light(type=lib.LightType.POINT,
                               color=np.array([2.0, 1.5, 1.0], np.float32))
        scene.add_entity(lamp)
        scenes.append(scene)
    return scenes


def _points_and_normals(r, n):
    p = r.uniform([-3, -1, -3], [3, 2, 2], (n, 3)).astype(np.float32)
    nrm = _unit(r, n)
    nrm[:, 1] = np.abs(nrm[:, 1])  # mostly facing the sky
    return p, nrm


def test_estimate_lights_and_light_distortion():
    ours_scene, ref_scene = _two_light_scenes()
    ours = flatten_scene(ours_scene, "cpu")
    ref = flatten_ref(ref_scene)
    assert ours.light_count == ref.light_count == 2
    r = np.random.default_rng(3)
    p, nrm = _points_and_normals(r, N)
    p[0] = np.asarray(ours.light_location[1, :3])  # on the point light
    _close(stages._estimate_lights(ours, torch.from_numpy(nrm),
                                   torch.from_numpy(p)),
           integrator_ref._estimate_lights(ref, jnp.asarray(nrm),
                                           jnp.asarray(p)), rtol=RTOL)

    w = (r.uniform(size=N) < 0.5).astype(np.float32)
    n_in = (_unit(r, N) * r.uniform(0.5, 20, (N, 1))).astype(np.float32)
    n_in[:2] = [[0, 0, 1], [0, 0, -2]]  # u degenerates: falls back to +x
    seed = _seeds(r, N)
    off, s = stages._light_distortion(
        torch.from_numpy(n_in), torch.from_numpy(w),
        torch.from_numpy(seed.astype(np.int64)))
    off_r, s_r = integrator_ref._light_distortion(
        jnp.asarray(n_in), jnp.asarray(w), jnp.asarray(seed))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    _close(off, off_r)


@pytest.mark.parametrize("compose", ["both", "diffuse"])
def test_direct_lighting(compose):
    """The whole NEE term on seeded points, normals, surfaces and seeds
    in the two-light parity scene, as a bounce computes it: the plain
    stages.nee_stage (the light pick, the jittered direction and the BRDF;
    no emission, every lane alive and hit at t = 0 from its point), its
    shadow ray through the port's any-hit trace (trace_visibility) and the
    contribution of the lanes the ray reached, against the reference's
    direct_lighting with its binary-BVH oracle.  Seeds advance exactly as
    the reference's (pick, then two distortion floats)."""
    ours_scene, ref_scene = _two_light_scenes()
    flat, tables = renderer.prepare_scene(ours_scene, "cpu",
                                          env_resolution=8)
    flat_r, tables_r = renderer_ref.prepare_scene(ref_scene,
                                                  env_resolution=8)
    r = np.random.default_rng(4)
    p, nrm = _points_and_normals(r, N)
    wo = _unit(r, N)
    wo[:, 2] = np.abs(wo[:, 2])
    surface_args = (r.uniform(0, 1, (N, 3)).astype(np.float32),
                    r.uniform(0.05, 1, N).astype(np.float32),
                    (r.uniform(size=N) < 0.5).astype(np.float32),
                    np.zeros((N, 3), np.float32))
    seed = _seeds(r, N)

    tbn = brdf.make_tbn(torch.from_numpy(nrm))
    surface = dict(zip(("base_color", "roughness", "metallic", "emission"),
                       (torch.from_numpy(a) for a in surface_args)))
    # The ray that reached p travels against wo.
    d = -brdf.tangent_to_world(torch.from_numpy(wo), tbn)
    lanes = torch.ones(N, dtype=torch.bool)
    nee = stages.nee_stage(
        flat, surface, tbn, torch.from_numpy(p), d, torch.zeros(N), lanes,
        torch.ones((N, 3)), torch.ones(N), lanes, ~lanes,
        torch.zeros((N, 3)), torch.from_numpy(seed.astype(np.int64)),
        compose=compose)
    assert torch.equal(nee["p"], torch.from_numpy(p))
    occluded = integrator.trace_visibility(flat, tables, *nee["shadow"])
    got = torch.where((nee["has_light"] & ~occluded)[:, None],
                      nee["contrib"], 0.0)
    tbn_r = brdf_ref.make_tbn(jnp.asarray(nrm))
    want, s_r = integrator_ref.direct_lighting(
        flat_r, tables_r, brdf_ref.make_surface(*(jnp.asarray(a)
                                                  for a in surface_args)),
        tbn_r, jnp.asarray(p), jnp.asarray(nee["wo"].numpy()),
        jnp.asarray(seed), 4, compose=compose)
    np.testing.assert_array_equal(nee["seed"].numpy(), np.asarray(s_r))
    want = np.asarray(want)
    lit = (want != 0).any(axis=-1)
    print(f"direct lighting: {int(lit.sum())} of {N} points lit")
    assert N // 8 < lit.sum() < N  # both lit and shadowed points
    _close(got, want, rtol=RTOL)


def test_ray_sort_key_and_repack():
    """The 18-bit Morton/octant key and the stable repack give the
    reference's keys and order exactly (ties included: half the origins sit
    on a coarse lattice, which makes many equal keys)."""
    flat, tables = renderer.prepare_scene(builtin.make_parity_scene(4),
                                          "cpu", env_resolution=8)
    _, tables_r = renderer_ref.prepare_scene(builtin_ref.make_parity_scene(4),
                                             env_resolution=8)
    lo, inv = integrator.scene_bounds(tables)
    lo_r, inv_r = integrator_ref.scene_bounds(tables_r)
    np.testing.assert_array_equal(np.float32(lo), np.asarray(lo_r))
    np.testing.assert_array_equal(np.float32(inv), np.asarray(inv_r))

    r = np.random.default_rng(5)
    o = r.uniform(-12, 12, (N, 3)).astype(np.float32)
    o[N // 2:] = np.round(o[N // 2:] / 12.0) * 12.0  # many equal keys
    d = _unit(r, N)
    d[:8, 0] = 0.0  # a zero component counts as not positive
    alive = r.uniform(size=N) < 0.6
    miss = ~alive & (r.uniform(size=N) < 0.5)
    key = integrator._ray_sort_key(torch.from_numpy(o), torch.from_numpy(d),
                                   lo, inv)
    key_r = integrator_ref._ray_sort_key(jnp.asarray(o), jnp.asarray(d),
                                         lo_r, inv_r)
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(key.numpy(), np.asarray(key_r))

    full = (((~torch.from_numpy(alive)).to(torch.int32) << 19)
            | (torch.from_numpy(miss).to(torch.int32) << 18) | key)
    full_r = (((~jnp.asarray(alive)).astype(jnp.int32) << 19)
              | (jnp.asarray(miss).astype(jnp.int32) << 18) | key_r)
    seed = _seeds(r, N)
    cols = [o, d, r.uniform(size=N).astype(np.float32), seed,
            np.arange(N, dtype=np.int32)]
    sk, got = integrator.repack_rays(
        full, [torch.from_numpy(c.astype(np.int64) if c.dtype == np.uint32
                                else c) for c in cols])
    sk_r, want = integrator_ref.repack_rays(full_r,
                                            [jnp.asarray(c) for c in cols])
    np.testing.assert_array_equal(sk.numpy(), np.asarray(sk_r))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert len(np.unique(np.asarray(sk_r))) < 3 * N // 4  # ties kept stable
