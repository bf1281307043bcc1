"""The two per-bounce stages of the path tracer around its visibility trace.

Port of steeljax/render/pt/integrator.py (RayGen.rgen:180-395): once a
bounce's nearest hits are shaded (integrator.unpack_material), `nee_stage`
does the bounce's work up to the shadow ray and `sample_stage` the rest,
with the visibility trace between them:

- `nee_stage`: the path weight throughput / ray_pdf, the miss and alive
  update from the hits, the emission term, the hit point p and the
  outgoing direction wo in the tangent frame; in a lit scene next-event
  estimation up to its trace (DirectLighting, RayGen.rgen:268-305): the
  per-light irradiance estimates, the pick, the penumbra jitter, the light
  direction and distance, and the light's contribution through the BRDF,
  unmasked.  It draws 3 floats a lane in a lit scene, none otherwise.
- `sample_stage`: the contribution of the lanes the shadow ray reached,
  the BRDF sample (3 floats), the black and pdf tests, throughput and
  ray_pdf, Russian roulette (1 float) when asked, and the next ray.

A CPU tensor runs the plain versions, the torch code the integrator ran
(`_nee_stage_plain`, `_sample_stage_plain` over `_estimate_lights`,
`_light_distortion`, `sample_light`, `shadow_rays` and render/pt/brdf.py).
A CUDA tensor launches one kernel of csrc/pathstage.cu a stage, which
computes the same numbers (its note says how), or raises: nothing falls
back.  No Pallas kernel is replaced: the JAX package computes this work in
plain jnp.  Each launch adds one to LAUNCHES["nee"] or ["sample"]; under a
profiler it lies in a range named PROFILER_RANGE + that key, which is not
the trace kernels' `trace_kernel.` prefix, so the trace kernels' device
time stays their own.  The kernels allocate nothing: the wrappers allocate
every output.

`surface` is the shading unpack's dict of the surface's inputs
(base_color (N, 3), roughness, metallic (N,), emission (N, 3)); the stages
derive brdf.make_surface's terms from it themselves.
"""

from __future__ import annotations

import ctypes

import torch

from steeljax_torch.accel import cuda_traverse
from steeljax_torch.core import rng
from steeljax_torch.core.colors import luminance
from steeljax_torch.core.constants import (BIAS, DIRECT_LIGHT_DISK_RADIUS,
                                           EPSILON, PI, POINT_LIGHT_RADIUS,
                                           RAY_DEAD_T, RAY_MAX_T, RAY_MIN_T)
from steeljax_torch.render.pt import brdf as brdf_lib
from steeljax_torch.render.surface import normalize

# Kernel launches by stage since the last reset (set the entries to 0 to
# start counting).
LAUNCHES = {"nee": 0, "sample": 0}
# The profiler range of a launch: this prefix and its LAUNCHES key.
PROFILER_RANGE = "stage_kernel."
# brdf.compose_brdf's terms as the nee kernel numbers them.
COMPOSE = {"both": 0, "diffuse": 1, "specular": 2}
# The light table rows the nee kernel can loop over (MAX_LIGHT_COUNT).
MAX_LIGHTS = 16


def runs_kernels(device: torch.device) -> bool:
    """Whether the stages launch their kernels on `device` (else they run
    the plain versions)."""
    return device.type == "cuda"


def _surface(surface: dict) -> dict:
    return brdf_lib.make_surface(surface["base_color"], surface["roughness"],
                                 surface["metallic"], surface["emission"])


# ---------------------------------------------------------------------------
# Next-event estimation (RayGen.rgen:180-305)
# ---------------------------------------------------------------------------

def _estimate_lights(scene, n, p) -> torch.Tensor:
    """Per-light irradiance estimate (EstimateLight, RayGen.rgen:180-197).
    Returns (N, L) for the first light_count lights."""
    loc = scene.light_location[:scene.light_count]          # (L, 4)
    color = scene.light_color[:scene.light_count, :3]       # (L, 3)
    direction = loc[None, :, :3] - p[:, None, :] * loc[None, :, 3:4]
    dist2 = (direction * direction).sum(dim=-1)
    attenuation = torch.where(
        loc[None, :, 3] == 0.0, 1.0,
        torch.where(dist2 == 0.0, 1e10, 1.0 / dist2))
    l = normalize(direction)
    nol = torch.clamp((n[:, None, :] * l).sum(dim=-1), min=0.0)
    return attenuation * nol * luminance(color)[None, :]


def _light_distortion(n, w, seed):
    """ComputeLightDistortion (RayGen.rgen:251-266): disk/sphere jitter of
    the light direction for soft penumbrae.  Draws two floats."""
    zero = torch.zeros_like(n[..., 0])
    u = torch.stack([n[..., 1], -n[..., 0], zero], dim=-1)
    u_len = torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    unit_x = torch.stack([torch.ones_like(zero), zero, zero], dim=-1)
    u = torch.where(u_len > 1e-12, u / torch.clamp(u_len, min=1e-20), unit_x)
    v = normalize(torch.linalg.cross(n, u, dim=-1))
    theta, seed = rng.next_float(seed)
    theta = theta * 2.0 * PI
    offset = torch.cos(theta)[..., None] * u + torch.sin(theta)[..., None] * v
    r, seed = rng.next_float(seed)
    dd = torch.sqrt(torch.clamp(1.0 - r * r, min=0.0))
    offset = offset * r[..., None] + normalize(n) * (dd * w)[..., None]
    return offset, seed


def sample_light(scene, n, p, seed):
    """The light pick and jittered light direction of DirectLighting
    (RayGen.rgen:268-290), in the reference's RNG order: one float for the
    pick, then two for the distortion.  Returns ({"direction" (N, 3) unit,
    "distance", "attenuation", "pdf", "has_light" (N,), "color" (N, 3)},
    seed)."""
    estimates = _estimate_lights(scene, n, p)            # (N, L)
    # Running sum over the few lights, in cumsum's order: torch.cumsum
    # along this short innermost axis runs as a scan kernel that took 5 ms
    # per call at 921,600 rays on an H100.
    running = list(estimates.unbind(dim=-1))
    for i in range(1, len(running)):
        running[i] = running[i - 1] + running[i]
    cum = torch.stack(running, dim=-1)
    total = running[-1]
    has_light = total > 0.0
    cum_norm = cum / torch.clamp(total, min=1e-20)[:, None]

    pick, seed = rng.next_float(seed)
    # First index with pick < cum_norm[i] (RayGen.rgen:226-234).
    light_index = (pick[:, None] >= cum_norm[:, :-1]).sum(dim=-1)
    norm_est = estimates / torch.clamp(total, min=1e-20)[:, None]
    pdf = norm_est.gather(1, light_index[:, None])[:, 0]
    loc = scene.light_location[light_index]
    color = scene.light_color[light_index, :3]
    is_point = loc[..., 3]

    direction = loc[..., :3] - p * is_point[..., None]
    distortion, seed = _light_distortion(-direction, is_point, seed)
    radius = torch.where(is_point == 0.0, DIRECT_LIGHT_DISK_RADIUS,
                         POINT_LIGHT_RADIUS)
    direction = direction + distortion * radius[..., None]

    distance = torch.where(is_point == 0.0, RAY_MAX_T,
                           torch.linalg.vector_norm(direction, dim=-1))
    attenuation = torch.where(
        is_point == 0.0, 1.0,
        1.0 / torch.clamp(distance * distance, min=1e-20))
    return {"direction": normalize(direction), "distance": distance,
            "attenuation": attenuation, "pdf": pdf, "has_light": has_light,
            "color": color}, seed


def shadow_rays(p, n, light):
    """The shadow ray of sample_light's light: (origin, direction, t_min,
    t_max), with an inverted interval where no light was picked."""
    t_far = torch.where(light["has_light"], light["distance"], RAY_DEAD_T)
    return p + n * BIAS, light["direction"], RAY_MIN_T, t_far


def light_contribution(surface: dict, wo, wi, wh, light,
                       compose: str = "both") -> torch.Tensor:
    """The picked light's radiance through the BRDF, unmasked
    (RayGen.rgen:292-305): f * cos(wi) * color * attenuation / pdf.
    `surface` is brdf.make_surface's dict."""
    f = brdf_lib.evaluate_brdf(surface, wo, wi, wh, compose=compose)
    return (f * brdf_lib.cos_theta(wi)[..., None] * light["color"]
            * (light["attenuation"]
               / torch.clamp(light["pdf"], min=1e-20))[..., None])


# ---------------------------------------------------------------------------
# The stages
# ---------------------------------------------------------------------------

def nee_stage(scene, surface: dict, tbn, o, d, t_hit, hit, throughput,
              ray_pdf, alive, miss, irradiance, seed,
              compose: str = "both") -> dict:
    """The bounce's work from its shaded hits up to the shadow ray.  `o`,
    `d`: the rays just traced, `t_hit`, `hit`: their nearest hits; the
    path state as the bounce found it.  Returns {"alive", "miss" (N,) bool,
    "irradiance" (with the emission), "p", "wo" (N, 3), "seed"}, and in a
    lit scene also "shadow" (origin, direction, t_min, t_max: the inverted
    interval where no light was picked), "contrib" (N, 3), the light's
    contribution before the shadow ray's verdict, and "has_light" (N,)."""
    vectors = [surface["base_color"], surface["emission"], *tbn, o, d,
               throughput, irradiance]
    scalars = [surface["roughness"], surface["metallic"], t_hit, ray_pdf]
    _check(vectors, scalars, [hit, alive, miss], seed)
    if compose not in COMPOSE:
        raise ValueError(f"compose must be one of {sorted(COMPOSE)}, got "
                         f"{compose!r}")
    if not runs_kernels(seed.device):
        return _nee_stage_plain(scene, surface, tbn, o, d, t_hit, hit,
                                throughput, ray_pdf, alive, miss,
                                irradiance, seed, compose)
    return _nee_stage_kernel(scene, surface, tbn, o, d, t_hit, hit,
                             throughput, ray_pdf, alive, miss, irradiance,
                             seed, compose)


def sample_stage(surface: dict, tbn, p, wo, d, throughput, ray_pdf, alive,
                 irradiance, seed, direct=None, roulette: bool = False,
                 rr_min_threshold: float = 0.05) -> dict:
    """The rest of the bounce: with `direct` = (contrib, has_light,
    occluded) the lit lanes' next-event term, then the BRDF sample, the
    path state's update, roulette when `roulette` (a bounce at or past
    min_bounce_count) and the next ray, from `p` along the sampled
    direction (a lane that died keeps `d`, the deferred environment
    lookup's direction).  Returns {"o", "d", "t_min", "t_max",
    "throughput", "ray_pdf", "alive", "irradiance", "seed"}."""
    vectors = [surface["base_color"], *tbn, p, wo, d, throughput,
               irradiance]
    scalars = [surface["roughness"], surface["metallic"], ray_pdf]
    flags = [alive]
    if direct is not None:
        vectors.append(direct[0])
        flags += list(direct[1:])
    _check(vectors, scalars, flags, seed)
    if not runs_kernels(seed.device):
        return _sample_stage_plain(surface, tbn, p, wo, d, throughput,
                                   ray_pdf, alive, irradiance, seed, direct,
                                   roulette, rr_min_threshold)
    return _sample_stage_kernel(surface, tbn, p, wo, d, throughput, ray_pdf,
                                alive, irradiance, seed, direct, roulette,
                                rr_min_threshold)


def _check(vectors, scalars, flags, seed) -> None:
    """One device; (N, 3) and (N,) float32, (N,) bool and (N, 2) int64
    seeds."""
    if seed.dim() != 2 or seed.shape[1] != 2 or seed.dtype != torch.int64:
        raise ValueError(f"seed must be (N, 2) int64, got "
                         f"{tuple(seed.shape)} {seed.dtype}")
    n = seed.shape[0]
    for group, shape, dtype in ((vectors, (n, 3), torch.float32),
                                (scalars, (n,), torch.float32),
                                (flags, (n,), torch.bool)):
        for x in group:
            if tuple(x.shape) != shape or x.dtype != dtype:
                raise ValueError(f"a stage input must be {shape} {dtype}, "
                                 f"got {tuple(x.shape)} {x.dtype}")
            if x.device != seed.device:
                raise ValueError(f"the stage's tensors must lie on one "
                                 f"device: {x.device} and {seed.device}")


def _nee_stage_plain(scene, surface, tbn, o, d, t_hit, hit, throughput,
                     ray_pdf, alive, miss, irradiance, seed, compose):
    weight = throughput / torch.clamp(ray_pdf, min=1e-30)[..., None]
    # Miss -> environment (RayGen.rgen:353-357), deferred.
    miss = miss | (alive & ~hit)
    alive = alive & hit
    # Emission (RayGen.rgen:361).
    irradiance = irradiance + torch.where(
        alive[..., None], surface["emission"] * weight, 0.0)
    p = o + d * t_hit[..., None]
    wo = normalize(brdf_lib.world_to_tangent(-d, tbn))
    out = {"alive": alive, "miss": miss, "irradiance": irradiance, "p": p,
           "wo": wo, "seed": seed}
    if scene.light_count > 0:
        # NEE against punctual lights (RayGen.rgen:366-371), up to the
        # shadow ray.
        n = tbn[2]
        light, seed = sample_light(scene, n, p, seed)
        wi = brdf_lib.world_to_tangent(light["direction"], tbn)
        wh = normalize(wo + wi)
        out.update(shadow=shadow_rays(p, n, light), seed=seed,
                   contrib=light_contribution(_surface(surface), wo, wi, wh,
                                              light, compose),
                   has_light=light["has_light"])
    return out


def _sample_stage_plain(surface, tbn, p, wo, d, throughput, ray_pdf, alive,
                        irradiance, seed, direct, roulette,
                        rr_min_threshold):
    if direct is not None:
        contrib, has_light, occluded = direct
        weight = throughput / torch.clamp(ray_pdf, min=1e-30)[..., None]
        lit = torch.where((has_light & ~occluded)[..., None], contrib, 0.0)
        irradiance = irradiance + torch.where(alive[..., None],
                                              lit * weight, 0.0)

    # BRDF sample (RayGen.rgen:374-385).
    f, wi, pdf, seed = brdf_lib.sample_brdf(_surface(surface), wo, seed)
    black = (f * f).sum(dim=-1) < EPSILON
    alive = alive & (pdf >= EPSILON) & ~black
    throughput = torch.where(
        alive[..., None],
        throughput * f * brdf_lib.cos_theta(wi)[..., None], throughput)
    ray_pdf = torch.where(alive, ray_pdf * pdf, ray_pdf)

    if roulette:
        # Russian roulette (RayGen.rgen:387-395).
        threshold = torch.clamp(1.0 - throughput.max(dim=-1).values,
                                min=rr_min_threshold)
        r, seed = rng.next_float(seed)
        alive = alive & ~(r < threshold)
        throughput = torch.where(
            alive[..., None],
            throughput / torch.clamp(1.0 - threshold, min=1e-20)[..., None],
            throughput)

    # Guarded so a ray that missed keeps its traced direction: that frozen d
    # is the deferred environment lookup direction.
    d = torch.where(alive[..., None], brdf_lib.tangent_to_world(wi, tbn), d)
    # Dead lanes get an inverted interval: the trace reports them as misses
    # without descending.
    return {"o": p, "d": d, "t_min": torch.full_like(ray_pdf, RAY_MIN_T),
            "t_max": torch.where(alive, RAY_MAX_T, RAY_DEAD_T).to(
                torch.float32),
            "throughput": throughput, "ray_pdf": ray_pdf, "alive": alive,
            "irradiance": irradiance, "seed": seed}


# ---------------------------------------------------------------------------
# The kernels' wrappers (csrc/pathstage.cu)
# ---------------------------------------------------------------------------

def _strides(x: torch.Tensor) -> tuple:
    """The row and value strides (elements) the kernel reads `x` with; the
    values of a flag's or a seed's row must be adjacent."""
    if x.dim() == 1:
        return x.stride(0), 1
    if x.dtype != torch.float32 and x.stride(1) != 1:
        raise ValueError(f"a stage input's {x.dtype} rows must be "
                         f"contiguous, got strides {x.stride()}")
    return x.stride()


def _launch(stage: str, entry: str, inputs, outputs, ints, floats) -> None:
    """Launch `entry` over `inputs` (strided views, None for an absent
    one) and `outputs` (contiguous, None for an absent one); `ints` lead
    the int64 values, the inputs' row and value strides follow."""
    ptrs = ([0 if x is None else x.data_ptr() for x in inputs]
            + [0 if x is None else x.data_ptr() for x in outputs])
    values = list(ints) + [v for x in inputs
                           for v in ((0, 0) if x is None else _strides(x))]
    args = ((ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int64 * len(values))(*values),
            *(ctypes.c_float(v) for v in floats))
    tensors = [x for x in (*inputs, *outputs) if x is not None]
    cuda_traverse._launch_fn(stage, entry, args, tensors, launches=LAUNCHES,
                             prefix=PROFILER_RANGE)()


def _light_table(x: torch.Tensor, device, light_count: int) -> None:
    if (x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 4
            or x.shape[0] < light_count or x.device != device
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"the light tables must be contiguous (R, 4) "
                         f"float32 on {device} with R >= {light_count}, "
                         f"16-byte aligned; got {tuple(x.shape)} {x.dtype} "
                         f"on {x.device}")


def _nee_stage_kernel(scene, surface, tbn, o, d, t_hit, hit, throughput,
                      ray_pdf, alive, miss, irradiance, seed, compose):
    n = seed.shape[0]
    device = seed.device
    lights = scene.light_count
    if lights > MAX_LIGHTS:
        raise ValueError(f"the nee kernel takes at most {MAX_LIGHTS} lights, "
                         f"got {lights}")
    if lights > 0:
        _light_table(scene.light_location, device, lights)
        _light_table(scene.light_color, device, lights)

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    out = {"alive": new(n, dtype=torch.bool), "miss": new(n, dtype=torch.bool),
           "irradiance": new(n, 3), "p": new(n, 3), "wo": new(n, 3),
           "seed": seed}
    lit = [None] * 6
    if lights > 0:
        lit = [new(n, 2, dtype=torch.int64), new(n, 3), new(n, 3), new(n),
               new(n, 3), new(n, dtype=torch.bool)]
    inputs = [surface["base_color"], surface["roughness"],
              surface["metallic"], surface["emission"], *tbn, o, d, t_hit,
              hit, throughput, ray_pdf, alive, miss, irradiance, seed]
    tables = ([scene.light_location, scene.light_color] if lights > 0
              else [None, None])
    outputs = tables + [out["alive"], out["miss"], out["irradiance"],
                        out["p"], out["wo"]] + lit
    # The light tables sit between the inputs and the outputs, unstrided.
    _launch("nee", "steeljax_nee_stage", inputs, outputs,
            [n, lights, COMPOSE[compose]], [])
    if lights > 0:
        seed_out, origin, direction, t_far, contrib, has_light = lit
        out.update(seed=seed_out, shadow=(origin, direction, RAY_MIN_T, t_far),
                   contrib=contrib, has_light=has_light)
    return out


def _sample_stage_kernel(surface, tbn, p, wo, d, throughput, ray_pdf, alive,
                         irradiance, seed, direct, roulette,
                         rr_min_threshold):
    n = seed.shape[0]
    device = seed.device

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    out = {"o": p, "d": new(n, 3), "throughput": new(n, 3),
           "ray_pdf": new(n), "alive": new(n, dtype=torch.bool),
           "irradiance": new(n, 3), "seed": new(n, 2, dtype=torch.int64),
           "t_min": new(n), "t_max": new(n)}
    contrib, has_light, occluded = direct if direct is not None else \
        (None, None, None)
    inputs = [surface["base_color"], surface["roughness"],
              surface["metallic"], *tbn, p, wo, d, contrib, has_light,
              occluded, throughput, ray_pdf, alive, irradiance, seed]
    outputs = [out[k] for k in ("d", "throughput", "ray_pdf", "alive",
                                "irradiance", "seed", "t_min", "t_max")]
    _launch("sample", "steeljax_sample_stage", inputs, outputs,
            [n, int(direct is not None), int(bool(roulette))],
            [rr_min_threshold])
    return out
