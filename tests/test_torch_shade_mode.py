"""STEELJAX_SHADE_MODE, the cap on the flat nearest trace's fused shading
mode, against the reference on the CPU.

The reference reads the switch at import and caps only its kernel path
(steeljax/accel/dispatch.py:27-32, :476-478); its CPU path has no fused
shading, so its integrator and G-buffer always gather the hits' tri_shade
rows there.  The port caps the flat tables' mode on every device (its plain
versions run the kernels' fused path), so on the CPU:
  * under a cap of 0 the record of mode-1 and mode-2 tables has no fused
    field, and its t, tri, u, v and hit are torch.equal to the uncapped
    trace's; a cap at or above the tables' mode changes nothing; a cap of 1
    over textured (mode-2) tables raises, as do values that are not
    integers >= 0; instanced and treelet tables keep their fused shading
    under any cap, and the occlusion query has none to cap;
  * a path-traced frame under the cap is torch.equal to the frame of the
    same tables with their fused rows dropped (the gather branch), and
    within 1e-4 of the reference's CPU frame on every pixel with equal
    rays_traced (Cornell at sphere detail 6, the __graft_entry__ tile: 32x18,
    1 spp; and the small textured stress scene);
  * against the port's uncapped (fused) frame, the capped one is held to the
    path tracer's budget (tests/test_torch_integrator.py): at most
    max(2, N/200) pixels beyond 1e-4, rays_traced within 4 segments a
    diverging pixel; on these tiles no pixel diverges and rays_traced is
    equal.  chip_smoke.py's phase 19 holds the card's frames to this;
  * a hybrid frame under the cap takes the G-buffer's gather branch, so the
    fused branch's documented deviation (10 of 1,296 textured pixels' base
    colour, tests/test_torch_hybrid.py) is gone: the G-buffer is
    torch.equal to the gather branch's, and the frame is within 1e-4 of the
    reference's on every pixel (48x27, the reference's environment carried
    across); on untextured Cornell it is held to the port's fused frame
    with the path tracer's budget (no pixel measured), as phase 19 holds
    path H.
A shade-mode / row-layout mismatch raises on the CPU as on the card."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax.core import camera as camera_ref
from steeljax.core.config import RenderConfig as RenderConfigRef
from steeljax.env.environment import load_environment as load_env_ref
from steeljax.env.sky import procedural_sky_cube as sky_cube_ref
from steeljax.render.hybrid.renderer import HybridRenderer as HybridRef
from steeljax.render.pt import integrator as integrator_ref
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax_torch.accel import cuda_traverse, dispatch
from steeljax_torch.accel.instances import InstancedAccel
from steeljax_torch.convert import from_jax_environment
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.render.hybrid import gbuffer
from steeljax_torch.render.hybrid.renderer import HybridRenderer
from steeljax_torch.render.pt import integrator, renderer
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401

SWITCH = "STEELJAX_SHADE_MODE"
HIT_FIELDS = ("t", "tri", "u", "v", "hit")
PIXEL_ATOL = 1e-4
W, H = 32, 18
HW, HH = 48, 27
TINY_ENV = dict(irradiance_resolution=4, reflection_resolution=8,
                lut_resolution=16, lut_samples=32, reflection_samples=16,
                irradiance_delta=0.4)

SCENES = {
    "cornell": lambda m: m.make_cornell_scene(sphere_detail=6),
    "textured": lambda m: m.make_stress_scene(8, 4, textured=True),
}


def _prepared(name, **kwargs):
    return renderer.prepare_scene(SCENES[name](builtin), "cpu",
                                  env_resolution=16, **kwargs)


@pytest.fixture(scope="module")
def flat_tables():
    return {name: _prepared(name) for name in SCENES}


def _rays(scene, seed: int = 5):
    """The camera's pixel-centre rays at W x H, and as many from seeded
    points inside the scene's bounds in seeded directions (back faces
    included), in numpy."""
    frame = camera_ref.make_frame(scene.camera_location,
                                  scene.camera_projection)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    xy = np.stack([(xs.reshape(-1) + 0.5) / W,
                   (ys.reshape(-1) + 0.5) / H], -1) * 2.0 - 1.0
    target = np.concatenate([xy, np.ones_like(xy)], -1) @ frame.inverse_proj.T
    d = np.concatenate([target[:, :3], np.zeros_like(xy[:, :1])], -1)
    d = (d @ frame.inverse_view.T)[:, :3]
    o = np.broadcast_to(frame.inverse_view[:3, 3], d.shape)
    r = np.random.default_rng(seed)
    o2 = r.uniform(-1.0, 1.0, (W * H, 3)) * np.array([0.9, 0.9, 0.9]) \
        + np.array([0.0, 1.0, 0.0])
    d2 = r.normal(size=(W * H, 3))
    o = np.concatenate([o, o2]).astype(np.float32)
    d = np.concatenate([d, d2])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.fixture(scope="module")
def rays():
    return {name: _rays(SCENES[name](builtin)) for name in SCENES}


def _trace(tables, o, d, monkeypatch, cap=None):
    if cap is None:
        monkeypatch.delenv(SWITCH, raising=False)
    else:
        monkeypatch.setenv(SWITCH, cap)
    return dispatch.trace_nearest(tables, o, d, 1e-4, 1e30)


def _equal(a: dict, b: dict, keys) -> None:
    for key in keys:
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("name,mode", [("cornell", 1), ("textured", 2)])
def test_cap_zero_drops_the_fused_fields(name, mode, flat_tables, rays,
                                         monkeypatch):
    _, tables = flat_tables[name]
    assert tables.shade_mode == mode
    fused = _trace(tables, *rays[name], monkeypatch)
    capped = _trace(tables, *rays[name], monkeypatch, "0")
    assert "n" in fused and ("uv" in fused) == (mode == 2)
    assert set(capped) == set(HIT_FIELDS)
    _equal(capped, fused, HIT_FIELDS)
    assert 0.2 < float(capped["hit"].float().mean()) < 1.0


@pytest.mark.parametrize("name,cap", [("cornell", "1"), ("cornell", "2"),
                                      ("cornell", "5"), ("textured", "2"),
                                      ("textured", "5")])
def test_cap_at_or_above_the_mode_changes_nothing(name, cap, flat_tables,
                                                  rays, monkeypatch):
    _, tables = flat_tables[name]
    fused = _trace(tables, *rays[name], monkeypatch)
    capped = _trace(tables, *rays[name], monkeypatch, cap)
    assert set(capped) == set(fused)
    _equal(capped, fused, fused)


def test_cap_one_over_textured_tables_raises(flat_tables, rays,
                                             monkeypatch):
    _, tables = flat_tables["textured"]
    with pytest.raises(ValueError, match=f"{SWITCH}=1 over textured"):
        _trace(tables, *rays["textured"], monkeypatch, "1")


@pytest.mark.parametrize("value", ["-1", "x", "", "1.5"])
def test_values_that_are_not_non_negative_integers_raise(
        value, flat_tables, rays, monkeypatch):
    _, tables = flat_tables["cornell"]
    with pytest.raises(ValueError, match=SWITCH):
        _trace(tables, *rays["cornell"], monkeypatch, value)


@pytest.mark.parametrize("name,kind,cap", [
    ("cornell", "instanced", "0"), ("textured", "instanced", "0"),
    ("textured", "instanced", "1"), ("cornell", "treelets", "0"),
    ("textured", "treelets", "0"), ("textured", "treelets", "1")])
def test_instanced_and_treelet_tables_keep_fused_shading(name, kind, cap,
                                                         rays, monkeypatch):
    """The reference returns before its cap for InstancedTables and
    treelets (steeljax/accel/dispatch.py:456-463): K6 and K7 keep their
    fused shading under any cap."""
    kwargs = ({"accel": InstancedAccel(device="cpu")} if kind == "instanced"
              else {"treelets": True})
    _, tables = _prepared(name, **kwargs)
    fused = _trace(tables, *rays[name], monkeypatch)
    capped = _trace(tables, *rays[name], monkeypatch, cap)
    assert "n" in fused and set(capped) == set(fused)
    _equal(capped, fused, fused)


def test_the_occlusion_query_is_not_capped(flat_tables, rays, monkeypatch):
    _, tables = flat_tables["textured"]
    o, d = rays["textured"]
    monkeypatch.delenv(SWITCH, raising=False)
    occluded = dispatch.trace_any(tables, o, d, 1e-4, 1e30)
    monkeypatch.setenv(SWITCH, "0")
    assert torch.equal(dispatch.trace_any(tables, o, d, 1e-4, 1e30),
                       occluded)


def test_shade_row_layout_mismatch_raises(flat_tables, rays):
    """Mode-2 rows are three to a triangle row, mode-1 rows one: a trace in
    one mode over the other's rows raises on the CPU (and in the kernels'
    launchers) instead of reading records of the wrong width."""
    o, d = rays["textured"]
    chunk = flat_tables["textured"][1].chunks[0]
    args = (chunk.bvh8, chunk.tris_packed, o, d, 1e-4, 1e30)
    with pytest.raises(ValueError, match="shade_rows has"):
        cuda_traverse.trace_nearest_bvh8(*args, shade_mode=1,
                                         shade_rows=chunk.shade_packed)
    mode1 = flat_tables["cornell"][1].chunks[0]
    with pytest.raises(ValueError, match="shade_rows has"):
        cuda_traverse.trace_nearest_bvh8(
            mode1.bvh8, mode1.tris_packed, *rays["cornell"], 1e-4, 1e30,
            shade_mode=2, shade_rows=torch.cat([mode1.shade_packed] * 2))
    _, inst = _prepared("textured", accel=InstancedAccel(device="cpu"))
    assert inst.shade_mode == 2
    with pytest.raises(ValueError, match="shade_rows has"):
        cuda_traverse.trace_nearest_bvh8_inst(
            dataclasses.replace(inst, shade_mode=1), o, d, 1e-4, 1e30)


def test_two_chunk_sweep_under_the_cap_matches_one_chunk(flat_tables, rays,
                                                         monkeypatch):
    """sweep_nearest over two chunks inherits the cap: its record has no
    fused field and hits the one chunk's triangles at the same t."""
    flat1, one = flat_tables["cornell"]
    monkeypatch.setattr(dispatch, "MAX_CHUNK_TRIS",
                        -(-flat1.source_tri_count // 2))
    flat2, two = _prepared("cornell")
    assert len(two.chunks) == 2 and two.shade_mode == 1
    o, d = rays["cornell"]
    rec1 = _trace(one, o, d, monkeypatch, "0")
    rec2 = _trace(two, o, d, monkeypatch, "0")
    assert set(rec2) == set(HIT_FIELDS)
    _equal(rec2, rec1, ("t", "hit"))
    hit = rec1["hit"]
    pos1 = flat1.tri_pos[rec1["tri"][hit].long()]
    pos2 = flat2.tri_pos[rec2["tri"][hit].long()]
    assert torch.equal(pos1, pos2)
    _equal(rec2, rec1, ("u", "v"))


def _shade_mode0(tables):
    """The tables without fused shading: the gather branch."""
    return tables.replace(shade_mode=0, chunks=tuple(
        c.replace(shade_packed=None) for c in tables.chunks))


def _pt_frame(flat, tables, frame):
    ys, xs = np.meshgrid(np.arange(H, dtype=np.int32),
                         np.arange(W, dtype=np.int32), indexing="ij")
    image, stats = integrator.render_pixels(
        flat, tables, frame.inverse_view, frame.inverse_proj, 0.01, 100.0,
        W, H, xs.reshape(-1), ys.reshape(-1), 0, 0,
        RenderConfig(width=W, height=H), return_stats=True)
    return image.numpy(), float(stats["rays_traced"])


def _pt_frame_ref(name, frame):
    scene = SCENES[name](builtin_ref)
    flat, tables = renderer_ref.prepare_scene(scene, env_resolution=16)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.int32),
                         np.arange(W, dtype=np.int32), indexing="ij")
    image, stats = integrator_ref.render_pixels(
        flat, tables, jnp.asarray(frame.inverse_view),
        jnp.asarray(frame.inverse_proj), 0.01, 100.0, W, H,
        jnp.asarray(xs.reshape(-1)), jnp.asarray(ys.reshape(-1)), 0, 0,
        RenderConfigRef(width=W, height=H), return_stats=True)
    return np.asarray(image), float(stats["rays_traced"])


def _beyond(a, b) -> int:
    return int((np.abs(a - b).max(axis=-1) > PIXEL_ATOL).sum())


@pytest.mark.parametrize("name", list(SCENES))
def test_pt_frame_under_the_cap_matches_reference(name, flat_tables,
                                                  monkeypatch):
    flat, tables = flat_tables[name]
    scene = SCENES[name](builtin)
    frame = camera_ref.make_frame(scene.camera_location,
                                  scene.camera_projection)
    monkeypatch.delenv(SWITCH, raising=False)
    fused, fused_rays = _pt_frame(flat, tables, frame)
    gathered, gathered_rays = _pt_frame(flat, _shade_mode0(tables), frame)
    monkeypatch.setenv(SWITCH, "0")
    capped, capped_rays = _pt_frame(flat, tables, frame)
    ref, ref_rays = _pt_frame_ref(name, frame)
    assert np.array_equal(capped, gathered) and capped_rays == gathered_rays
    n = W * H
    beyond_ref, beyond_fused = _beyond(capped, ref), _beyond(capped, fused)
    print(f"{name}: capped against the reference {beyond_ref} of {n} "
          f"pixels beyond {PIXEL_ATOL}, against the fused frame "
          f"{beyond_fused}; rays_traced {capped_rays} capped, {ref_rays} "
          f"reference, {fused_rays} fused")
    assert np.isfinite(capped).all() and capped.std() > 0.0
    assert beyond_ref == 0 and capped_rays == ref_rays
    # The card's budget (chip_smoke.py phase 19), met here with no pixel.
    assert beyond_fused <= max(2, n // 200)
    assert abs(capped_rays - fused_rays) <= 4 * beyond_fused


@pytest.fixture(scope="module")
def envs():
    ref = load_env_ref(cube=sky_cube_ref(16), **TINY_ENV)
    return from_jax_environment(ref, "cpu"), ref


def _pixel_rays(scene):
    frame = camera_ref.make_frame(scene.camera_location,
                                  scene.camera_projection)
    ys, xs = np.meshgrid(np.arange(HH), np.arange(HW), indexing="ij")
    xy = np.stack([(xs.reshape(-1) + 0.5) / HW,
                   (ys.reshape(-1) + 0.5) / HH], -1) * 2.0 - 1.0
    target = np.concatenate([xy, np.ones_like(xy)], -1) @ frame.inverse_proj.T
    d = target[:, :3] / np.linalg.norm(target[:, :3], axis=-1, keepdims=True)
    d = (np.concatenate([d, np.zeros_like(d[:, :1])], -1)
         @ frame.inverse_view.T)[:, :3]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(frame.inverse_view[:3, 3], d.shape).astype(
        np.float32)
    spread = np.float32(2.0) * np.abs(frame.inverse_proj[1, 1]) / np.float32(
        HH)
    return frame, torch.from_numpy(o), torch.from_numpy(d), float(spread)


@pytest.mark.parametrize("name", list(SCENES))
def test_hybrid_frame_under_the_cap_matches_reference(name, flat_tables,
                                                      envs, monkeypatch):
    flat, tables = flat_tables[name]
    scene = SCENES[name](builtin)
    frame, o, d, spread = _pixel_rays(scene)
    args = (o, d, frame.camera_near, frame.camera_far,
            torch.from_numpy(frame.view_proj),
            torch.from_numpy(frame.camera_position))
    monkeypatch.setenv(SWITCH, "0")
    capped = gbuffer.generate_gbuffer(flat, tables, *args,
                                      pixel_spread=spread)
    gathered = gbuffer.generate_gbuffer(flat, _shade_mode0(tables), *args,
                                        pixel_spread=spread)
    _equal(capped, gathered, gathered)

    def frame():
        return HybridRenderer(
            scene, HW, HH, RenderConfig(width=HW, height=HH),
            environment=envs[0], prepared=(flat, tables),
            device="cpu").render_frame()

    image = frame()
    scene_r = SCENES[name](builtin_ref)
    ref = np.asarray(HybridRef(
        scene_r, HW, HH, RenderConfigRef(width=HW, height=HH),
        environment=envs[1],
        prepared=renderer_ref.prepare_scene(scene_r, env_resolution=16)
    ).render_frame())
    beyond = _beyond(image.reshape(-1, 3), ref.reshape(-1, 3))
    print(f"{name} hybrid under the cap: {beyond} of {HW * HH} pixels "
          f"beyond {PIXEL_ATOL}, max "
          f"{float(np.abs(image - ref).max()):.3e}")
    assert np.isfinite(image).all() and image.std() > 0.0
    assert beyond == 0
    if name == "cornell":
        # Against the port's fused frame of an untextured scene, the budget
        # chip_smoke.py's phase 19 holds path H to (the fused branch's
        # flip by winding is the only difference; no pixel here).
        monkeypatch.delenv(SWITCH)
        fused = _beyond(image.reshape(-1, 3), frame().reshape(-1, 3))
        print(f"cornell hybrid capped against fused: {fused} pixels")
        assert fused <= max(2, HW * HH // 200)
