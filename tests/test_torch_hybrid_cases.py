"""The inputs of the hybrid frame's kernel-parity variants, on the CPU.

`flat_shade0_shared_origin` draws the reference's rays (kernel_parity._rays
with one shared origin, steeljax/apps/kernel_parity.py:279-286): equal
arrays, and the port's plain K1 on them agrees with the reference's
brute-force oracle under `_compare`'s tolerances.  `hybrid_gbuffer_*` and
`hybrid_sun_shadow` take the hybrid renderer's own rays: hybrid_rays gives the renderer's
pixel-centre rays in its tile order (their G-buffer is the frame's), and
hybrid_shadow_case's sun rays are the lighting stage's: live exactly on the
lit G-buffer hits, and a pixel's direct light is zero exactly where its ray
is occluded (the lit parity scene at 64x32, the `direct` debug view)."""

import numpy as np
import pytest
import torch

from steeljax.accel import traverse as traverse_ref
from steeljax.apps import kernel_parity as kp_ref
from steeljax_torch.accel.cuda_traverse import (trace_any_bvh8_plain,
                                                trace_nearest_bvh8_plain)
from steeljax_torch.apps import kernel_parity as kp
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.core.constants import EPSILON
from steeljax_torch.env.environment import load_environment
from steeljax_torch.render.hybrid.renderer import HybridRenderer
from steeljax_torch.render.pt.integrator import tiled_order
from steeljax_torch.render.pt.renderer import prepare_scene
from steeljax_torch.scene.builtin import make_parity_scene
from test_torch_hybrid import TINY_ENV
from test_torch_support import one_torch_thread  # noqa: F401

W, H = 64, 32


def test_shared_origin_rays_and_plain_k1():
    o, d = kp._rays(2048, 7, shared_origin=True)
    o_ref, d_ref = kp_ref._rays(2048, 7, shared_origin=True)
    np.testing.assert_array_equal(o, o_ref)
    np.testing.assert_array_equal(d, d_ref)
    assert (o == o[0]).all()
    tables, perm, _, _ = kp.soup_case(3000, 64, "cpu")
    chunk = tables.chunks[0]
    rec = trace_nearest_bvh8_plain(chunk.bvh8, chunk.tris_packed,
                                   torch.from_numpy(o), torch.from_numpy(d),
                                   0.001, 1000.0, True)
    ref = traverse_ref.trace_nearest_brute(
        perm["pos"], perm["ds"], o, d, 0.001, 1000.0, cull_backface=True)
    results = {}
    assert kp._compare("shared_origin", rec, ref, perm["pos"], results), \
        results
    assert results["shared_origin"]["hits"] > 100


@pytest.fixture(scope="module")
def lit():
    scene = make_parity_scene(4)
    flat, tables = prepare_scene(scene, "cpu", env_resolution=16)
    return scene, flat, tables


def test_hybrid_rays_are_the_renderers(lit):
    scene, flat, tables = lit
    env = load_environment(cube_resolution=16, device="cpu", **TINY_ENV)
    renderer = HybridRenderer(scene, W, H, RenderConfig(width=W, height=H),
                              environment=env, prepared=(flat, tables),
                              device="cpu")
    o, d, near, far, uv, *_ = kp.hybrid_rays(scene, "cpu", W, H)
    px, py = renderer.pixels
    np.testing.assert_array_equal(uv[:, 0].numpy(),
                                  ((px.float() + 0.5) / W).numpy())
    np.testing.assert_array_equal(uv[:, 1].numpy(),
                                  ((py.float() + 0.5) / H).numpy())
    assert o.shape == d.shape == (W * H, 3) and o.is_contiguous()
    np.testing.assert_allclose(torch.linalg.vector_norm(d, dim=-1).numpy(),
                               1.0, atol=1e-6)
    assert (near, far) == (renderer.frame.camera_near,
                           renderer.frame.camera_far)


def test_hybrid_sun_rays_are_the_lighting_stages(lit):
    scene, flat, tables = lit
    assert flat.light_count == 1
    so, sd, t_min, t_max = kp.hybrid_shadow_case(scene, flat, tables, W, H)
    live = t_max >= t_min
    assert 0 < int(live.sum()) < W * H
    chunk = tables.chunks[0]
    occluded = trace_any_bvh8_plain(chunk.bvh8, chunk.tris_packed, so, sd,
                                    t_min, t_max)
    assert not occluded[~live].any()
    assert 0 < int(occluded.sum()) < int(live.sum())

    env = load_environment(cube_resolution=16, device="cpu", **TINY_ENV)
    direct = HybridRenderer(
        scene, W, H, RenderConfig(width=W, height=H, debug_view="direct"),
        environment=env, prepared=(flat, tables),
        device="cpu").render_frame()
    px, py, _ = tiled_order(W, H)
    lit_px = direct[py, px].max(axis=-1) > EPSILON  # tile order
    live, occluded = live.numpy(), occluded.numpy()
    # Lit exactly where a live ray found no occluder.
    np.testing.assert_array_equal(lit_px, live & ~occluded)
