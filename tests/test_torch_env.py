"""The port's environment stack against the reference on the CPU.

Cube sampling (sample_cube, sample_cube_quads, sample_flat_mips,
sample_flat_mips_tri) on seeded random directions and LODs agrees within
1e-6 absolute on radiance of order 1 (both fp32, the same operation order;
only XLA's fusion can move a last bit).  The packers are numpy and give
equal arrays; the one-row and the two-row trilinear forms are held equal to
each other, as the reference holds them (tests/test_cubemap.py).  The
colour curves and sample_trilinear agree within 1e-6.  The panorama
conversion agrees within 1e-5 absolute on a panorama in [0, 4] and within
1e-4 relative on one in [0, 8] (prepare_scene's): atan2 and asin differ
between XLA and ATen by an ulp, and a random panorama's texel-to-texel
steps amplify that in the bilinear read.  The image loaders give equal arrays on files the tests write (a flat
and an RLE Radiance file, an RGB PNG).  Last, a path-traced tile of the
Cornell box lit by docs/golden/surrogate_env.npz's cube as
`environment_cube` (the miss shading reads the cube) matches the reference
as the path-tracing slice's tile does: at most max(2, N/200) pixels beyond
1e-4 and rays_traced within 4 rays per diverging pixel."""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from steeljax.core import camera as camera_ref
from steeljax.core import colors as colors_ref
from steeljax.core.config import RenderConfig as RenderConfigRef
from steeljax.env import cubemap as cubemap_ref
from steeljax.env import panorama as panorama_ref
from steeljax.env.sky import procedural_sky_cube as sky_cube_ref
from steeljax.io import image as image_ref
from steeljax.render import texture as texture_ref
from steeljax.render.pt import integrator as integrator_ref
from steeljax.render.pt import renderer as renderer_ref
from steeljax.scene import builtin as builtin_ref
from steeljax_torch.core import colors
from steeljax_torch.core.config import RenderConfig
from steeljax_torch.env import cubemap, panorama
from steeljax_torch.env.ibl import build_cube_mips
from steeljax_torch.io import image
from steeljax_torch.render import texture
from steeljax_torch.render.pt import integrator, renderer
from steeljax_torch.scene import builtin
from test_torch_support import one_torch_thread  # noqa: F401

ATOL = 1e-6
N = 4096
SURROGATE = Path(__file__).parent.parent / "docs/golden/surrogate_env.npz"


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def cube():
    """A 16-texel cube with texel-scale structure: the sky plus noise."""
    r = np.random.default_rng(1)
    c = sky_cube_ref(16)
    return (c * r.uniform(0.5, 1.5, c.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def dirs():
    r = np.random.default_rng(2)
    d = r.normal(size=(N, 3)).astype(np.float32)
    # Axis-aligned, edge and corner directions besides the random ones.
    d[:6] = np.concatenate([np.eye(3), -np.eye(3)])
    d[6:10] = [[1, 1, 0], [1, 1, 1], [-1, 1, -1], [0, -1, 1]]
    d[10] = 0.0  # the degenerate direction takes face 0
    scale = r.uniform(0.1, 10.0, (N, 1)).astype(np.float32)
    return d * scale  # sampling needs no unit directions


@pytest.fixture(scope="module")
def mips(cube):
    """The cube's box-filtered chain (16, 8, 4, 2, 1)."""
    return [m.numpy() for m in build_cube_mips(torch.from_numpy(cube))]


def test_sample_cube_and_quads(cube, dirs):
    ours = cubemap.sample_cube(torch.from_numpy(cube), torch.from_numpy(dirs))
    _close(ours, cubemap_ref.sample_cube(jnp.asarray(cube),
                                         jnp.asarray(dirs)))
    quads = cubemap.pack_cube_quads(cube)
    np.testing.assert_array_equal(quads, cubemap_ref.pack_cube_quads(cube))
    ours_q = cubemap.sample_cube_quads(torch.from_numpy(quads),
                                       torch.from_numpy(dirs))
    _close(ours_q, cubemap_ref.sample_cube_quads(jnp.asarray(quads),
                                                 jnp.asarray(dirs)))
    # The quad form is the bilinear form (up to the rounding of a lerp
    # between two equal edge texels).
    _close(ours_q, ours.numpy())


@pytest.mark.parametrize("tri", [False, True], ids=["quads", "mip_pairs"])
def test_pack_mips_equals_reference(mips, tri):
    pack, pack_ref = ((cubemap.pack_mips_tri, cubemap_ref.pack_mips_tri)
                      if tri else (cubemap.pack_mips, cubemap_ref.pack_mips))
    for ours, ref in zip(pack(mips, "cpu"), pack_ref(
            [jnp.asarray(m) for m in mips])):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("tri", [False, True], ids=["quads", "mip_pairs"])
def test_sample_flat_mips_matches_reference(mips, dirs, tri):
    r = np.random.default_rng(3)
    lod = r.uniform(-1.0, len(mips) + 1.0, N).astype(np.float32)
    lod[:8] = [0, 1, 2, 3, 4, 0.5, 3.5, 4.0]
    if tri:
        pack, sample = cubemap.pack_mips_tri, cubemap.sample_flat_mips_tri
        sample_ref = cubemap_ref.sample_flat_mips_tri
        pack_ref = cubemap_ref.pack_mips_tri
    else:
        pack, sample = cubemap.pack_mips, cubemap.sample_flat_mips
        sample_ref = cubemap_ref.sample_flat_mips
        pack_ref = cubemap_ref.pack_mips
    ours = sample(*pack(mips, "cpu"), torch.from_numpy(dirs),
                  torch.from_numpy(lod))
    ref = sample_ref(*pack_ref([jnp.asarray(m) for m in mips]),
                     jnp.asarray(dirs), jnp.asarray(lod))
    _close(ours, ref)


def test_mip_pair_rows_equal_quad_rows(mips, dirs):
    """The one-row trilinear (mip-pair rows) gives the two-row form's
    values bit for bit, so lighting may read either."""
    r = np.random.default_rng(4)
    lod = torch.from_numpy(r.uniform(-0.5, len(mips), N).astype(np.float32))
    d = torch.from_numpy(dirs)
    two = cubemap.sample_flat_mips(*cubemap.pack_mips(mips, "cpu"), d, lod)
    one = cubemap.sample_flat_mips_tri(*cubemap.pack_mips_tri(mips, "cpu"),
                                       d, lod)
    np.testing.assert_array_equal(one.numpy(), two.numpy())


def test_panorama_to_cube():
    r = np.random.default_rng(5)
    pano = r.uniform(0.0, 4.0, (12, 24, 3)).astype(np.float32)
    ours = panorama.panorama_to_cube(pano, 8, device="cpu")
    assert ours.shape == (6, 8, 8, 3)
    _close(ours, panorama_ref.panorama_to_cube(pano, 8), atol=1e-5)


def _rgbe(rgb):
    """Radiance RGBE bytes of float colours (the inverse of the loaders'
    decode, to the nearest mantissa)."""
    peak = rgb.max(axis=-1)
    mant, exp = np.frexp(peak)
    scale = np.where(peak > 1e-32, mant * 256.0 / np.maximum(peak, 1e-38),
                     0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(peak > 1e-32, exp + 128, 0)
    return out


def _rle_plane(values):
    """Adaptive-RLE bytes of one channel plane: runs of 3 or more as
    (128 + n, value), the rest as literal blocks."""
    out, i, n = bytearray(), 0, len(values)
    while i < n:
        j = i
        while j < n and j - i < 127 and values[j] == values[i]:
            j += 1
        if j - i >= 3:
            out += bytes([128 + j - i, values[i]])
            i = j
            continue
        k = i
        while k < n and k - i < 128 and not (
                k + 2 < n and values[k] == values[k + 1] == values[k + 2]):
            k += 1
        k = max(k, i + 1)
        out += bytes([k - i]) + bytes(values[i:k])
        i = k
    return bytes(out)


@pytest.fixture(scope="module")
def hdr_files(tmp_path_factory):
    """A flat and an RLE Radiance file of one image (runs and literals,
    zero pixels among them)."""
    r = np.random.default_rng(6)
    h, w = 5, 40
    rgb = r.uniform(0.0, 8.0, (h, w, 3)).astype(np.float32)
    rgb[:, 10:25] = [0.5, 1.5, 3.0]  # runs
    rgb[2, 30:] = 0.0
    rgbe = _rgbe(rgb)
    head = f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {h} +X {w}\n".encode()
    root = tmp_path_factory.mktemp("hdr")
    flat = root / "flat.hdr"
    flat.write_bytes(head + rgbe.tobytes())
    rle = root / "rle.hdr"
    body = b"".join(bytes([2, 2, w >> 8, w & 255]) + b"".join(
        _rle_plane(list(rgbe[y, :, c])) for c in range(4)) for y in range(h))
    rle.write_bytes(head + body)
    return flat, rle, rgbe


@pytest.mark.parametrize("kind", ["flat", "rle"])
def test_load_hdr(hdr_files, kind):
    flat, rle, rgbe = hdr_files
    path = flat if kind == "flat" else rle
    ours = image.load_hdr(path)
    np.testing.assert_array_equal(ours, image_ref.load_hdr(path))
    e = rgbe[..., 3].astype(np.int32)
    expect = (rgbe[..., :3] + 0.5) * np.ldexp(1.0, e - 136)[..., None]
    expect[e == 0] = 0.0
    np.testing.assert_array_equal(ours, expect.astype(np.float32))


def test_load_ldr(tmp_path):
    from PIL import Image

    r = np.random.default_rng(7)
    rgb = r.integers(0, 256, (6, 9, 3)).astype(np.uint8)
    path = tmp_path / "ldr.png"
    Image.fromarray(rgb).save(path)
    ours = image.load_ldr(path)
    assert ours.shape == (6, 9, 4) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, image_ref.load_ldr(path))
    np.testing.assert_array_equal(image.load_ldr(path.read_bytes()), ours)


@pytest.mark.parametrize("name", ["to_srgb", "uncharted_tone_map"])
def test_colour_curves(name):
    x = np.random.default_rng(8).uniform(-0.1, 20.0, 4096).astype(
        np.float32)
    x[:4] = [0.0, 0.0031308, 1.0, 11.2]
    ours = getattr(colors, name)(torch.from_numpy(x))
    ref = np.asarray(getattr(colors_ref, name)(jnp.asarray(x)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=ATOL)


def test_sample_trilinear():
    """The G-buffer's texture read on the textured stress scene's pool:
    random texture ids (missing ones included), wrapped uvs and lods
    below, inside and past each mip chain."""
    flat, _ = renderer.prepare_scene(
        builtin.make_stress_scene(8, 4, textured=True), "cpu",
        env_resolution=4)
    r = np.random.default_rng(9)
    k = flat.tex_size.shape[0]
    tex = r.integers(-1, k, N).astype(np.int32)
    uv = r.uniform(-2.0, 3.0, (N, 2)).astype(np.float32)
    lod = r.uniform(-2.0, flat.tex_offset.shape[1] + 2.0, N).astype(
        np.float32)
    ours = texture.sample_trilinear(flat.atlas, flat.tex_offset,
                                    flat.tex_size, torch.from_numpy(tex),
                                    torch.from_numpy(uv),
                                    torch.from_numpy(lod))
    ref = texture_ref.sample_trilinear(
        *(jnp.asarray(getattr(flat, n).numpy())
          for n in ("atlas", "tex_offset", "tex_size")),
        jnp.asarray(tex), jnp.asarray(uv), jnp.asarray(lod))
    _close(ours, ref)


def test_pt_tile_with_environment_cube_matches_reference():
    """The Cornell tile (32x18, 1 spp) lit by the golden surrogate cube
    through `environment_cube`: prepare_scene takes it, and the miss
    shading reads it (sample_cube_quads)."""
    cube = np.load(SURROGATE)["cube"]
    w, h = 32, 18
    ys, xs = np.meshgrid(np.arange(h, dtype=np.int32),
                         np.arange(w, dtype=np.int32), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)

    scene_r = builtin_ref.make_cornell_scene(sphere_detail=6)
    scene_r.environment_cube = cube
    flat_r, tables_r = renderer_ref.prepare_scene(scene_r, env_resolution=16)
    frame = camera_ref.make_frame(scene_r.camera_location,
                                  scene_r.camera_projection)
    ref, stats_r = integrator_ref.render_pixels(
        flat_r, tables_r, jnp.asarray(frame.inverse_view),
        jnp.asarray(frame.inverse_proj), 0.01, 100.0, w, h,
        jnp.asarray(px), jnp.asarray(py), 0, 0,
        RenderConfigRef(width=w, height=h), return_stats=True)

    scene = builtin.make_cornell_scene(sphere_detail=6)
    scene.environment_cube = cube
    flat, tables = renderer.prepare_scene(scene, "cpu", env_resolution=16)
    assert not flat.env_analytic and flat.env_enabled
    np.testing.assert_array_equal(flat.env_quads.numpy(),
                                  np.asarray(flat_r.env_quads))
    ours, stats = integrator.render_pixels(
        flat, tables, frame.inverse_view, frame.inverse_proj, 0.01, 100.0,
        w, h, px, py, 0, 0, RenderConfig(width=w, height=h),
        return_stats=True)
    ours, ref = ours.numpy(), np.asarray(ref)
    diverging = int((np.abs(ours - ref).max(axis=-1) > 1e-4).sum())
    assert diverging <= max(2, w * h // 200)
    assert abs(float(stats["rays_traced"])
               - float(stats_r["rays_traced"])) <= 4 * diverging
    # The cube's radiance reaches the frame: it differs from the sky's.
    sky = integrator.render_pixels(
        *renderer.prepare_scene(builtin.make_cornell_scene(sphere_detail=6),
                                "cpu", env_resolution=16),
        frame.inverse_view, frame.inverse_proj, 0.01, 100.0, w, h, px, py,
        0, 0, RenderConfig(width=w, height=h)).numpy()
    assert np.abs(ours - sky).max() > 0.1


def test_prepare_scene_takes_a_panorama(hdr_files, tmp_path):
    """A scene's environment_path (a Radiance panorama) becomes its cube,
    as in the reference."""
    flat_path = hdr_files[0]
    scene = builtin.make_cornell_scene(sphere_detail=2)
    scene.environment_path = str(flat_path)
    flat, _ = renderer.prepare_scene(scene, "cpu", env_resolution=8)
    scene_r = builtin_ref.make_cornell_scene(sphere_detail=2)
    scene_r.environment_path = str(flat_path)
    flat_r, _ = renderer_ref.prepare_scene(scene_r, env_resolution=8)
    assert flat.env_enabled and not flat.env_analytic
    np.testing.assert_allclose(flat.env_cube.numpy(),
                               np.asarray(flat_r.env_cube), rtol=1e-4,
                               atol=1e-5)


def test_prepare_scene_converts_the_panorama_on_its_device(hdr_files,
                                                          monkeypatch):
    """prepare_scene hands its device to panorama_to_cube (a spy records
    the call), so a scene's panorama becomes its cube on the render device,
    as the reference converts it on its accelerator; the 16x16 cube equals
    the reference's within test_prepare_scene_takes_a_panorama's relative
    1e-4 and absolute 1e-5 (texels up to 8)."""
    calls = []
    convert = renderer.panorama_to_cube

    def spy(pano, resolution, *args, **kwargs):
        calls.append((resolution, args, kwargs))
        return convert(pano, resolution, *args, **kwargs)

    monkeypatch.setattr(renderer, "panorama_to_cube", spy)
    device = torch.device("cpu")
    scene = builtin.make_cornell_scene(sphere_detail=2)
    scene.environment_path = str(hdr_files[0])
    flat, _ = renderer.prepare_scene(scene, device, env_resolution=16)
    assert len(calls) == 1
    resolution, args, kwargs = calls[0]
    assert resolution == 16
    assert [*args, *kwargs.values()] == [device]
    scene_r = builtin_ref.make_cornell_scene(sphere_detail=2)
    scene_r.environment_path = str(hdr_files[0])
    flat_r, _ = renderer_ref.prepare_scene(scene_r, env_resolution=16)
    assert flat.env_cube.shape == (6, 16, 16, 3)
    np.testing.assert_allclose(flat.env_cube.numpy(),
                               np.asarray(flat_r.env_cube), rtol=1e-4,
                               atol=1e-5)
