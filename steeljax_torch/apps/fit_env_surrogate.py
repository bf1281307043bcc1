"""Fit a structured (SH-2) surrogate environment to the reference gallery.

Port of steeljax/apps/fit_env_surrogate.py.  The reference's golden renders
were captured with an environment panorama that the checkout lacks, so the
golden checks run against a surrogate: a low-order directional fit from
every gallery pixel that observes the environment directly or through the
mirror sphere:

* background pixels (the primary ray misses all geometry) observe env(d)
  through the tone map;
* mirror-sphere pixels whose reflected ray also escapes the box observe
  F_schlick * env(reflect(d, n)), which covers directions behind the
  camera that light the box interior through its opening.

Radiance is recovered by inverting the filmic tone map (a closed-form
quadratic), fitted as 9 SH-2 coefficients per channel with ridge
regularization toward the background mean, clamped non-negative and baked
to a cube written to docs/golden/surrogate_env.npz.  The traces run through
the port's accel.dispatch.trace_nearest on the card, or on the CPU with
--device cpu.  `samples_from_image` takes the decoded gallery image, so a
machine without Pillow can run everything but the PNG decode.

Usage: python -m steeljax_torch.apps.fit_env_surrogate \
    [-o docs/golden/surrogate_env.npz] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from steeljax_torch.accel.dispatch import trace_nearest
from steeljax_torch.core import camera as camera_lib
from steeljax_torch.env.cubemap import face_directions
from steeljax_torch.render.pt.renderer import prepare_scene
from steeljax_torch.render.surface import shade_rows
from steeljax_torch.scene import load_scene
from steeljax_torch.scene.flatten import TriShade

GALLERY = "/root/reference/Gallery/Images/CornellBox_PathTracing.png"
SCENE = "/root/reference/Assets/Scenes/CornellBox/CornellBox.gltf"


def inverse_tone_map(y: np.ndarray) -> np.ndarray:
    """Invert core.colors.tone_map (Hejl-Burgess-Dawson, Common.glsl:
    119-124): y = x(6.2x+.5)/(x(6.2x+1.7)+.06), x = linear - 0.004."""
    y = np.clip(np.asarray(y, np.float64), 0.0, 0.995)
    a = 6.2 * (1.0 - y)
    b = 0.5 - 1.7 * y
    c = -0.06 * y
    x = (-b + np.sqrt(np.maximum(b * b - 4.0 * a * c, 0.0))) / (2.0 * a)
    return (x + 0.004).astype(np.float32)


def sh2_basis(d: np.ndarray) -> np.ndarray:
    """(N, 9) real SH bands 0..2 at unit directions (Ramamoorthi)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    return np.stack([
        np.full_like(x, 0.282095),
        0.488603 * y, 0.488603 * z, 0.488603 * x,
        1.092548 * x * y, 1.092548 * y * z,
        0.315392 * (3.0 * z * z - 1.0),
        1.092548 * x * z, 0.546274 * (x * x - y * y),
    ], axis=-1)


def gather_samples(width: int = 480, height: int = 270,
                   device: torch.device | str = "cuda"):
    """(directions (N, 3), radiance (N, 3), kind (N,) 0 = background, 1 =
    mirror) from GALLERY resized to width x height (Lanczos) and SCENE,
    traced on `device`."""
    from PIL import Image

    img = np.asarray(Image.open(GALLERY).convert("RGB").resize(
        (width, height), Image.LANCZOS), np.float64) / 255.0
    return samples_from_image(img, load_scene(SCENE), device)


def _trace(tables, o: np.ndarray, d: np.ndarray, device) -> dict:
    return trace_nearest(tables, torch.from_numpy(o).to(device),
                         torch.from_numpy(d).to(device), 0.01, 1000.0,
                         cull_backface=False)


def samples_from_image(img: np.ndarray, scene,
                       device: torch.device | str = "cuda"):
    """gather_samples for a decoded (H, W, 3) image in [0, 1] and a loaded
    scene: the samples at the image's pixel centres."""
    height, width = img.shape[:2]
    flat, tables = prepare_scene(scene, device, env_resolution=8,
                                 use_default_environment=False)
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    xs, ys = np.meshgrid((np.arange(width) + 0.5) / width,
                         (np.arange(height) + 0.5) / height)
    xy = np.stack([xs.ravel(), ys.ravel()], -1) * 2.0 - 1.0
    inv_proj = np.asarray(frame.inverse_proj)
    inv_view = np.asarray(frame.inverse_view)
    target = np.concatenate([xy, np.ones((len(xy), 2))], -1) @ inv_proj.T
    d = target[:, :3] / np.linalg.norm(target[:, :3], axis=-1,
                                       keepdims=True)
    d = (np.concatenate([d, np.zeros((len(d), 1))], -1) @ inv_view.T)[:, :3]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(inv_view[:3, 3], (len(d), 1)).astype(np.float32)
    d = d.astype(np.float32)

    rec = _trace(tables, o, d, device)
    hit = rec["hit"].cpu().numpy()
    pix = inverse_tone_map(img.reshape(-1, 3))

    dirs = [d[~hit]]
    rads = [pix[~hit]]
    kinds = [np.zeros(int((~hit).sum()), np.int32)]

    # Mirror-sphere reflections that escape the box.
    rows = shade_rows(flat, tables, rec).cpu().numpy()
    mat = rows[:, TriShade.MAT_ID].astype(np.int64)
    params = flat.mat_params.cpu().numpy()
    mrough, mmetal = params[:, 0], params[:, 1]
    mirror_mats = np.nonzero((mmetal > 0.9) & (mrough < 0.3))[0]
    is_mirror = hit & np.isin(mat, mirror_mats)
    if is_mirror.any():
        u, v, t = (rec[k].cpu().numpy() for k in ("u", "v", "t"))
        w = 1.0 - u - v
        n = rows[:, TriShade.NORMALS].reshape(-1, 3, 3)
        n = n[:, 0] * w[:, None] + n[:, 1] * u[:, None] + n[:, 2] * v[:, None]
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        cos = -np.sum(d * n, axis=-1)
        n = np.where((cos < 0)[:, None], -n, n)
        cos = np.abs(cos)
        refl = d + 2.0 * cos[:, None] * n
        refl /= np.maximum(np.linalg.norm(refl, axis=-1, keepdims=True),
                           1e-20)
        p = o + d * t[:, None]
        sel = np.nonzero(is_mirror)[0]
        start = np.ascontiguousarray(p[sel] + 1e-3 * refl[sel])
        rec2 = _trace(tables, start, np.ascontiguousarray(refl[sel]), device)
        sel = sel[~rec2["hit"].cpu().numpy()]
        if len(sel):
            base = flat.mat_base_color.cpu().numpy()[mat[sel], :3]
            metal = mmetal[mat[sel], None]
            f0 = 0.04 + (base - 0.04) * metal
            f = f0 + (1.0 - f0) * (1.0 - cos[sel, None]) ** 5
            dirs.append(refl[sel])
            rads.append(pix[sel] / np.maximum(f, 1e-3))
            kinds.append(np.ones(len(sel), np.int32))

    return (np.concatenate(dirs), np.concatenate(rads),
            np.concatenate(kinds))


def fit_sh2(dirs, rads, kinds, ridge: float = 0.05,
            mirror_weight: float = 4.0):
    """Ridge-regularized SH-2 fit per channel, shrunk toward the
    background-mean constant, so directions the gallery never observes fall
    back to it instead of extrapolating."""
    basis = sh2_basis(dirs)                       # (N, 9)
    w = np.where(kinds == 1, mirror_weight, 1.0)  # mirrors are scarce
    mean = rads[kinds == 0].mean(axis=0)
    c0 = np.zeros((9, 3))
    c0[0] = mean / 0.282095
    aw = basis * w[:, None]
    ata = aw.T @ basis + ridge * len(dirs) / 9.0 * np.eye(9)
    atb = aw.T @ rads + ridge * len(dirs) / 9.0 * c0
    coeffs = np.linalg.solve(ata, atb)            # (9, 3)
    pred = basis @ coeffs
    rms = float(np.sqrt(np.mean((pred - rads) ** 2)))
    rms0 = float(np.sqrt(np.mean((rads - mean) ** 2)))
    return coeffs, {"fit_rms": rms, "const_rms": rms0,
                    "mean": mean.tolist()}


def bake_cube(coeffs: np.ndarray, resolution: int = 64) -> np.ndarray:
    """The fit evaluated at the texel centres of a (6, R, R, 3) cube,
    clamped non-negative."""
    dirs = face_directions(resolution).reshape(-1, 3)
    cube = sh2_basis(dirs) @ coeffs
    return np.maximum(cube, 0.0).reshape(
        6, resolution, resolution, 3).astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-o", "--output",
                    default="docs/golden/surrogate_env.npz")
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--ridge", type=float, default=0.05)
    ap.add_argument("--device", default="cuda",
                    help="where the traces run (default cuda)")
    args = ap.parse_args(argv)

    dirs, rads, kinds = gather_samples(device=args.device)
    print(f"samples: {int((kinds == 0).sum())} background, "
          f"{int((kinds == 1).sum())} mirror-escape")
    coeffs, stats = fit_sh2(dirs, rads, kinds, ridge=args.ridge)
    print(f"fit rms {stats['fit_rms']:.4f} vs constant-surrogate rms "
          f"{stats['const_rms']:.4f}; background mean {stats['mean']}")
    cube = bake_cube(coeffs, args.resolution)
    np.savez(args.output, cube=cube, sh_coeffs=coeffs.astype(np.float32),
             **{k: np.asarray(v) for k, v in stats.items()})
    print(f"wrote {args.output} (cube {cube.shape})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
