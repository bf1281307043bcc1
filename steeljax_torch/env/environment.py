"""The environment bundle: a radiance cube and its IBL bakes.

Port of steeljax/env/environment.py:23-116 (EnvironmentComponent:
panorama -> cubemap -> irradiance + prefiltered reflection + the specular
BRDF LUT), with every table a tensor on one device.  The reflection
chain is kept in one form, the mip-pair rows of env.cubemap.pack_mips_tri
(one 48-float row a lookup); the reference packs them only below a cap
that sizes an upload to a TPU host, and lights through its quad rows
(pack_mips) above it.  The two forms are bit-exact with each other
(env.cubemap), so the choice changes no pixel; on an H100 the lighting
stage's lookup takes 4.09 ms in mip-pair rows against 4.70 ms in quad rows
on the JAX bench's hybrid frame (chip_smoke.py phase 11).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from steeljax_torch.core import profiling
from steeljax_torch.env import ibl
from steeljax_torch.env.cubemap import pack_cube_quads, pack_mips_tri
from steeljax_torch.env.panorama import panorama_to_cube
from steeljax_torch.env.sky import procedural_sky_cube
from steeljax_torch.io import image as image_io


@dataclasses.dataclass
class Environment:
    cube: torch.Tensor                      # (6, R, R, 3) radiance
    irradiance: torch.Tensor                # (6, r, r, 3)
    reflection_mips: tuple                  # tuple of (6, m, m, 3)
    # The reflection chain packed as mip-pair rows (env.cubemap.
    # pack_mips_tri).
    reflection_tri_data: torch.Tensor       # (N, 48)
    reflection_offsets: torch.Tensor        # (M,) int32
    reflection_sizes: torch.Tensor          # (M,) int32
    specular_lut: torch.Tensor              # (L, L, 2)
    # Bilinear-footprint quad rows (env.cubemap.pack_cube_quads).
    cube_quads: torch.Tensor                # (6*R*R, 16)
    irradiance_quads: torch.Tensor          # (6*r*r, 16)
    specular_lut_quads: torch.Tensor        # (L*L, 8)
    # The cube was baked from the procedural sky: the forward background
    # evaluates env.sky.sky_radiance per ray instead of reading cube_quads
    # (the IBL bakes still come from the cube).
    analytic: bool = False
    # The SH fit of the irradiance cube (ibl.fit_cube_sh), None when the
    # bake's content fails the fit's residual gate; lighting then reads
    # irradiance_quads.
    irradiance_sh: torch.Tensor | None = None

    def to(self, device: torch.device | str) -> "Environment":
        """The same tables on `device`."""
        tables = {f.name: getattr(self, f.name)
                  for f in dataclasses.fields(self)
                  if f.name not in ("reflection_mips", "analytic")}
        return dataclasses.replace(
            self, reflection_mips=tuple(m.to(device)
                                        for m in self.reflection_mips),
            **{k: None if v is None else v.to(device)
               for k, v in tables.items()})


def load_environment(panorama_path: str | None = None,
                     cube: np.ndarray | torch.Tensor | None = None,
                     cube_resolution: int = 256,
                     irradiance_resolution: int = 64,
                     reflection_resolution: int = 256,
                     lut_resolution: int = 256,
                     lut_samples: int = 4096,
                     reflection_samples: int = 2048,
                     irradiance_delta: float = 0.025,
                     analytic: bool = False, *,
                     device: torch.device | str) -> Environment:
    """Build the environment bundle on `device`.

    Sources in priority order: an explicit `cube`, a Radiance panorama at
    `panorama_path`, else the procedural sky.  A caller passing a cube it
    knows was baked from the procedural sky sets `analytic=True` to keep
    the closed-form background.  The whole is the span `environment.load`,
    its steps `environment.cube`, `.reflection_mips`, `.irradiance` and
    `.brdf_lut` (core.profiling), each ending in a synchronize."""
    with profiling.named_scope("environment.load", sync=device):
        with profiling.named_scope("environment.cube", sync=device):
            if cube is None:
                if panorama_path and Path(panorama_path).exists():
                    cube = panorama_to_cube(image_io.load_hdr(panorama_path),
                                            cube_resolution, device=device)
                else:
                    cube = procedural_sky_cube(cube_resolution)
                    analytic = True
            if not isinstance(cube, torch.Tensor):
                cube = torch.from_numpy(np.array(cube, np.float32))
            cube = cube.to(device=device, dtype=torch.float32)
            cube_quads = _quads(cube, device)
        with profiling.named_scope("environment.reflection_mips",
                                   sync=device):
            reflection_mips = ibl.generate_reflection_mips(
                cube, reflection_resolution, reflection_samples)
            data, offsets, sizes = pack_mips_tri(reflection_mips, device)
        with profiling.named_scope("environment.irradiance", sync=device):
            irradiance = ibl.generate_irradiance_cube(
                cube, irradiance_resolution, irradiance_delta)
            irradiance_sh, _ = ibl.fit_cube_sh(irradiance, device=device)
            irradiance_quads = _quads(irradiance, device)
        with profiling.named_scope("environment.brdf_lut", sync=device):
            lut = ibl.specular_brdf_lut(lut_resolution, lut_samples,
                                        device=device)
            lut_quads = ibl.pack_lut_quads(lut)
    return Environment(
        cube=cube, irradiance=irradiance, reflection_mips=reflection_mips,
        reflection_tri_data=data, reflection_offsets=offsets,
        reflection_sizes=sizes, specular_lut=lut, cube_quads=cube_quads,
        irradiance_quads=irradiance_quads, specular_lut_quads=lut_quads,
        analytic=analytic, irradiance_sh=irradiance_sh)


def _quads(cube: torch.Tensor, device) -> torch.Tensor:
    """A cube's bilinear-footprint quad rows (pack_cube_quads) on
    `device`."""
    return torch.from_numpy(pack_cube_quads(cube.cpu().numpy())).to(device)
