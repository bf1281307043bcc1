"""The hit surface: what both renderers read at a hit.

The shading rows of the hits (`shade_rows`: scene.flatten's tri_shade
rows, or the instanced tables' composed ones; columns named by
flatten.TriShade) and the material rows of the fused path
(`material_select`, flatten.MatPacked); their barycentric interpolation,
the material flags, the alpha test, and the textured surface
(Material.glsl:20-60, RayGen.rgen:72-115): normal mapping and each material
term's factor times its texture.  The path tracer's integrator, the
G-buffer and the forward stage differ only in where the inputs come from
and in the texture sampler they pass (bilinear at lod 0 in ray-tracing
stages, trilinear at the G-buffer's lod).  Also the pieces of their
bounded re-traces: the interval's start past a rejected hit
(`retrace_tmin`) and the merge of two hit records (`select_rec`).

The path tracer's exact alpha test is `alpha_test`: with CUDA tensors one
kernel of csrc/alphatest.cu, which reads only the columns the test needs
(of flat, chunked and treelet tables the tri_shade row; of instanced tables
the blas_shade and inst_shade rows that world_shade_rows composes) and
gives the plain version's bits; with CPU tensors the plain `alpha_rejected`
over `shade_rows`.  Nothing falls back: a CUDA tensor launches the kernel
or raises.  Each call adds one to COUNTS["tests"], each launch one to
COUNTS["alpha"], under a profiler in a range named PROFILER_RANGE +
"alpha", apart from the trace kernels'.
"""

from __future__ import annotations

import ctypes

import torch

from steeljax_torch.accel import cuda_traverse
from steeljax_torch.accel.instances import (INST_COLS, InstancedTables,
                                             world_shade_rows)
from steeljax_torch.render.pt import brdf as brdf_lib
from steeljax_torch.render.texture import sample_bilinear
from steeljax_torch.scene.flatten import (TRI_SHADE_COLS, TRI_SHADE_GEOMETRY,
                                          FlatScene, TriShade)
from steeljax_torch.scene.material import MaterialFlags

# Each material term's factor (its column name in TriShade and MatPacked
# alike), texture slot (mat_tex's order: base colour, roughness-metallic,
# normal, occlusion, emission) and texel channels.
_TERMS = {"base_color": ("BASE_COLOR", 0, slice(0, 3)),
          "alpha": ("ALPHA", 0, 3), "roughness": ("ROUGHNESS", 1, 1),
          "metallic": ("METALLIC", 1, 2), "occlusion": ("OCCLUSION", 3, 0),
          "emission": ("EMISSION", 4, slice(0, 3))}
_NORMAL_SLOT = 2

# alpha_test's calls since the last reset, on either route ("tests"), and
# its kernel launches ("alpha"); set the entries to 0 to start counting.
COUNTS = {"tests": 0, "alpha": 0}
# The profiler range of a launch: this prefix and its COUNTS key.
PROFILER_RANGE = "surface_kernel."


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-20)


def retrace_tmin(t: torch.Tensor) -> torch.Tensor:
    """The re-trace interval's start past a rejected hit at t: relative, as
    an absolute 1e-4 is below one fp32 ulp of far t and would find the
    same triangle again (integrator.py:360-363)."""
    return t * (1.0 + 1e-4) + 1e-4


def select_rec(mask: torch.Tensor, new: dict, old: dict) -> dict:
    """Field by field of two hit records, `new` where `mask` holds and
    `old` elsewhere; (N,) and (N, k) fields alike."""
    return {k: torch.where(mask.reshape((-1,) + (1,) * (old[k].dim() - 1)),
                           new[k], old[k]) for k in old}


def material_select(scene: FlatScene, mid: torch.Tensor):
    """Per-ray material constants: (packed_row (N, 16), emission_linear
    (N, 3), texture ids (N, 5)).  The reference builds these with a select
    chain because a TPU gather is slow; plain indexing gives the same
    values."""
    mid = mid.long()
    return (scene.mat_packed[mid], scene.mat_emission_linear[mid],
            scene.mat_tex[mid])


def shade_rows(scene: FlatScene, tables, rec: dict) -> torch.Tensor:
    """The (N, 56) shading rows of the hits, world space
    (integrator.py:82-129): of flat tables one tri_shade row gather, of
    instanced tables instances.world_shade_rows."""
    tri = rec["tri"].clamp(min=0).long()
    if not isinstance(tables, InstancedTables):
        return scene.tri_shade[tri]
    return world_shade_rows(tables, tri, rec["inst"].clamp(min=0).long())


def interpolate(row: torch.Tensor, block: slice, u, v) -> torch.Tensor:
    """Barycentric interpolation at (u, v) of a per-vertex attribute, the
    rows' three consecutive blocks of columns `block`."""
    k = (block.stop - block.start) // 3
    b = block.start
    w = (1.0 - u - v)[..., None]
    return (row[:, b:b + k] * w + row[:, b + k:b + 2 * k] * u[..., None]
            + row[:, b + 2 * k:b + 3 * k] * v[..., None])


def material_flag(row: torch.Tensor, flag: MaterialFlags) -> torch.Tensor:
    """(N,) bool: whether the shading rows' material has `flag`."""
    return (row[:, TriShade.FLAGS].to(torch.int32) & int(flag)) != 0


def bilinear(scene: FlatScene, uv: torch.Tensor):
    """The texture sampler of ray-tracing stages, bilinear at lod 0 at the
    hits' uv, for textured_surface; None in a scene without textures."""
    if not scene.has_textures:
        return None
    return lambda idx: sample_bilinear(scene.atlas, scene.tex_offset,
                                       scene.tex_size, idx, uv)


def textured_surface(rows: torch.Tensor, layout, tex: torch.Tensor, sample,
                     terms, normal=None, tangent=None) -> dict:
    """The textured surface at the hits (Material.glsl:20-60): each of
    `terms` (keys of _TERMS) as its factor times its texture's channels
    where the material binds a texture, times 1 elsewhere; with `normal`
    and `tangent` (N, 3) also NORMAL_MAPPING (Material.glsl:40-47):
    "normal", the mapped normal, and "has_normal_map", where a normal
    texture is bound.  `rows` are the hits' material factors in columns of
    `layout` (shading rows and TriShade, or material_select's packed rows
    and MatPacked), `tex` their (N, 5) texture ids; `sample(ids)` returns
    the (N, 4) texels of texture ids `ids` at the hits, and is None in a
    scene without textures, where every texel reads 1 and no normal is
    mapped."""
    texels = {}

    def texel(slot):
        if slot not in texels:
            idx = tex[:, slot].to(torch.int32)
            texels[slot] = (torch.ones(idx.shape + (4,), device=idx.device)
                            if sample is None else sample(idx)), idx >= 0
        return texels[slot]

    out = {}
    if normal is not None and sample is not None:
        s, has = texel(_NORMAL_SLOT)
        ns = s[..., :3] * 2.0 - 1.0
        scale = rows[:, layout.NORMAL_SCALE]
        ns = normalize(ns * torch.stack(
            [scale, scale, torch.ones_like(scale)], dim=-1))
        tbn = brdf_lib.make_tbn_with_tangent(normal, tangent)
        out["normal"] = normalize(brdf_lib.tangent_to_world(ns, tbn))
        out["has_normal_map"] = has
    for term in terms:
        column, slot, channels = _TERMS[term]
        s, has = texel(slot)
        if isinstance(channels, slice):
            has = has[..., None]
        out[term] = rows[:, getattr(layout, column)] * torch.where(
            has, s[..., channels], 1.0)
    return out


def alpha_rejected(scene: FlatScene, rec: dict, row: torch.Tensor
                   ) -> torch.Tensor:
    """hit & alpha-test & alpha < cutoff at a hit (AnyHit.rahit:35-52,
    integrator.py:132-148).  One shading row covers the flags, cutoff,
    alpha factor, base texture id and the uv triangle."""
    alpha = row[:, TriShade.ALPHA]
    if scene.has_textures:
        uv = interpolate(row, TriShade.UVS, rec["u"], rec["v"])
        alpha = textured_surface(row, TriShade, row[:, TriShade.TEX_IDS],
                                 bilinear(scene, uv), ("alpha",))["alpha"]
    return (rec["hit"] & material_flag(row, MaterialFlags.ALPHA_TEST)
            & (alpha < row[:, TriShade.ALPHA_CUTOFF]))


def alpha_test(scene: FlatScene, tables, rec: dict) -> torch.Tensor:
    """(N,) bool: alpha_rejected at the hits of `rec` ("hit", "tri", "u",
    "v" (N,), and of instanced tables "inst"), whose ids index
    scene.tri_shade unless `tables` are instanced.  With CUDA tensors the
    kernel of csrc/alphatest.cu, which gives the same bits; with CPU
    tensors the plain version."""
    COUNTS["tests"] += 1
    if not rec["tri"].is_cuda:
        return alpha_rejected(scene, rec, shade_rows(scene, tables, rec))
    launch, rejected = alpha_launcher(scene, tables, rec)
    launch()
    return rejected


def alpha_launcher(scene: FlatScene, tables, rec: dict):
    """Check the inputs of one alpha kernel call on CUDA tensors and
    allocate its output: returns (launch, rejected), each `launch()`
    running the kernel into `rejected` on the current stream and adding one
    to COUNTS["alpha"].  alpha_test calls it once; a benchmark can repeat
    the launch without the wrapper's host work."""
    instanced = isinstance(tables, InstancedTables)
    hit, tri, u, v = rec["hit"], rec["tri"], rec["u"], rec["v"]
    inst = rec["inst"] if instanced else tri
    n = tri.shape[0]
    device = tri.device
    for x, dtype in ((hit, torch.bool), (tri, torch.int32),
                     (inst, torch.int32), (u, torch.float32),
                     (v, torch.float32)):
        if x.dim() != 1 or x.shape[0] != n or x.dtype != dtype \
                or x.device != device:
            raise ValueError(f"the alpha test takes (N,) hit bool, tri "
                             f"(and instanced inst) int32, u and v float32 "
                             f"on one device; got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    # The rows holding the uvs and those holding the material, and widths.
    if instanced:
        rows = (tables.blas_shade, tables.inst_shade)
        widths = (TRI_SHADE_GEOMETRY.stop, INST_COLS)
    else:
        rows = (scene.tri_shade,) * 2
        widths = (TRI_SHADE_COLS,) * 2
    pool = [*rows, scene.atlas, scene.tex_offset, scene.tex_size]
    for x, dtype, cols in zip(pool, (torch.float32, torch.float32,
                                     torch.uint8, torch.int32, torch.int32),
                              (*widths, 16, None, 2)):
        if (x.dtype != dtype or x.dim() != 2 or x.device != device
                or not x.is_contiguous() or x.data_ptr() % 16
                or (cols is not None and x.shape[1] != cols)):
            raise ValueError(f"the alpha test's scene tables must be "
                             f"contiguous 16-byte aligned {dtype} on "
                             f"{device}; got {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}")
    out = torch.empty((n,), dtype=torch.bool, device=device)
    ptrs = [x.data_ptr() for x in (hit, tri, inst, u, v, *pool, out)]
    ints = [n, int(scene.has_textures), scene.tex_offset.shape[1],
            int(instanced), hit.stride(0), tri.stride(0), inst.stride(0),
            u.stride(0), v.stride(0)]
    args = ((ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int64 * len(ints))(*ints))
    launch = cuda_traverse._launch_fn("alpha", "steeljax_alpha_test", args,
                                      [hit, tri, inst, u, v, *pool, out],
                                      launches=COUNTS,
                                      prefix=PROFILER_RANGE)
    return launch, out
