"""Microfacet BRDF: GGX + Schlick Fresnel + Schlick visibility, Lambert
diffuse, with mixed cosine/GGX importance sampling (PBR.glsl:1-90,
PathTracing.glsl:22-89), and the colour helpers it needs (Common.glsl:
90-140).  A frozen copy of the port's `steeljax_torch/render/pt/brdf.py`
and `core/colors.py` as they stood when the benchmark was written; every
function maps leading dims and keeps its inputs' dtype.  Directions named
wo/wi/wh live in the tangent frame (z = shading normal).
"""

from __future__ import annotations

import torch

from portbench.reference import rng

EPSILON = 1e-6
PI = 3.141592654  # the reference's truncated PI (Constants.glsl:14)
INVERSE_PI = 0.31830988618
DIELECTRIC_F0 = 0.04
_LUMA = (0.2126, 0.7152, 0.0722)


def luminance(color: torch.Tensor) -> torch.Tensor:
    return (color[..., 0] * _LUMA[0] + color[..., 1] * _LUMA[1]
            + color[..., 2] * _LUMA[2])


def to_linear(srgb: torch.Tensor) -> torch.Tensor:
    higher = torch.pow(torch.clamp(srgb + 0.055, min=0.0) / 1.055, 2.4)
    lower = srgb / 12.92
    return torch.where(srgb < 0.04045, lower, higher)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-20)


# ---------------------------------------------------------------------------
# Tangent frames (Common.glsl:33-66)
# ---------------------------------------------------------------------------

def make_tbn(n: torch.Tensor):
    """GetTBN(N): tangent from cross(N, unitY), falling back to
    cross(N, unitX) when degenerate (Common.glsl:41-52)."""
    zero = torch.zeros_like(n[..., 0])
    ty = torch.stack([-n[..., 2], zero, n[..., 0]], dim=-1)  # cross(N, unitY)
    tx = torch.stack([zero, n[..., 2], -n[..., 1]], dim=-1)  # cross(N, unitX)
    use_y = (ty * ty).sum(dim=-1, keepdim=True) >= EPSILON
    t = _normalize(torch.where(use_y, ty, tx))
    b = _normalize(torch.linalg.cross(n, t, dim=-1))
    return t, b, n


def make_tbn_with_tangent(n: torch.Tensor, t: torch.Tensor):
    """GetTBN(N, T): Gram-Schmidt the supplied tangent (Common.glsl:33-39)."""
    t = t - (t * n).sum(dim=-1, keepdim=True) * n
    t = _normalize(t)
    b = torch.linalg.cross(n, t, dim=-1)
    return t, b, n


def world_to_tangent(v, tbn):
    t, b, n = tbn
    return torch.stack([(v * t).sum(dim=-1), (v * b).sum(dim=-1),
                        (v * n).sum(dim=-1)], dim=-1)


def tangent_to_world(v, tbn):
    t, b, n = tbn
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def cos_theta(v: torch.Tensor) -> torch.Tensor:
    """CosThetaTangent (Common.glsl:84-87)."""
    return torch.clamp(v[..., 2], min=0.0)


# ---------------------------------------------------------------------------
# Microfacet terms (PBR.glsl)
# ---------------------------------------------------------------------------

def diffuse_lambert(base_color):
    return base_color * INVERSE_PI


def d_ggx(a2, noh):
    d = (noh * a2 - noh) * noh + 1.0
    return a2 / (PI * d * d)


def f_schlick(f0, voh):
    fc = (1.0 - voh) ** 5
    return f0 + (1.0 - f0) * fc[..., None]


def f_schlick_roughness(f0, voh, roughness):
    """Fresnel with the roughness-limited grazing term (the split-sum
    ambient's kS, PBR.glsl)."""
    fc = ((1.0 - voh) ** 5)[..., None]
    return f0 + (torch.maximum(1.0 - roughness[..., None], f0) - f0) * fc


def vis_schlick(a, nov, nol):
    k = a * 0.5
    vis_v = nov * (1.0 - k) + k
    vis_l = nol * (1.0 - k) + k
    denom = vis_v * vis_l
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    return 0.25 * torch.where(denom == 0.0, torch.full_like(denom, 1e10),
                              1.0 / safe)


def importance_sample_ggx(e, a2):
    """GGX half-vector sample in tangent space (PBR.glsl:55-68)."""
    phi = 2.0 * PI * e[..., 0]
    cos_t = torch.sqrt(torch.clamp(
        (1.0 - e[..., 1]) / (1.0 + (a2 - 1.0) * e[..., 1]), min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)


def specular_pdf(noh, a2, voh):
    return noh * d_ggx(a2, noh) / torch.clamp(4.0 * voh, min=EPSILON)


def cosine_sample_hemisphere(e):
    phi = 2.0 * PI * e[..., 0]
    cos_t = torch.sqrt(torch.clamp(e[..., 1], min=0.0))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)


def cosine_pdf_hemisphere(cos_t):
    return cos_t * INVERSE_PI


def specular_weight(base_color, f0, metallic):
    """GetSpecularWeight (PathTracing.glsl:35-40)."""
    diffuse_lum = luminance(base_color) * (1.0 - metallic)
    specular_lum = luminance(f0)
    return torch.clamp(
        specular_lum / torch.clamp(specular_lum + diffuse_lum, min=1e-20),
        max=1.0)


# ---------------------------------------------------------------------------
# Surface BRDF (PathTracing.glsl:43-89)
# ---------------------------------------------------------------------------

def make_surface(base_color, roughness, metallic, emission) -> dict:
    f0 = DIELECTRIC_F0 + (base_color - DIELECTRIC_F0) * metallic[..., None]
    a = roughness * roughness
    a2 = torch.clamp(a * a, min=EPSILON)
    return {
        "base_color": base_color,
        "roughness": roughness,
        "metallic": metallic,
        "emission": emission,
        "f0": f0,
        "a": a,
        "a2": a2,
        "sw": specular_weight(base_color, f0, metallic),
    }


def compose_brdf(diffuse, specular, compose: str = "both"):
    """ComposeBRDF (Common/PBR.glsl:78-90): "diffuse" or "specular" isolates
    one term (DEBUG_VIEW_DIFFUSE / DEBUG_VIEW_SPECULAR), "both" sums them."""
    if compose == "diffuse":
        return diffuse
    if compose == "specular":
        return specular
    return diffuse + specular


def evaluate_brdf(surface, wo, wi, wh, compose: str = "both"):
    nov = cos_theta(wo)
    nol = cos_theta(wi)
    noh = cos_theta(wh)
    voh = torch.clamp((wo * wh).sum(dim=-1), min=0.0)

    d = d_ggx(surface["a2"], noh)
    f = f_schlick(surface["f0"], voh)
    vis = vis_schlick(surface["a"], nov, nol)

    kd = (1.0 - f) * (1.0 - surface["metallic"])[..., None]
    diffuse = kd * diffuse_lambert(surface["base_color"])
    specular = d[..., None] * f * vis[..., None]
    return compose_brdf(diffuse, specular, compose)


def pdf_brdf(surface, wo, wi, wh):
    diffuse_pdf = cosine_pdf_hemisphere(cos_theta(wi))
    spec = specular_pdf(cos_theta(wh), surface["a2"], (wi * wh).sum(dim=-1))
    sw = surface["sw"]
    return diffuse_pdf * (1.0 - sw) + spec * sw


def sample_brdf(surface, wo, seed):
    """SampleBRDF: pick the specular lobe with probability sw, else the
    cosine hemisphere; single mixed pdf (PathTracing.glsl:70-89).

    Returns (brdf (..., 3), wi (..., 3), pdf (...,), seed)."""
    e, seed = rng.next_vec3(seed)
    e = e.to(wo.dtype)

    wh_spec = importance_sample_ggx(e[..., :2], surface["a2"])
    wi_spec = (2.0 * (wo * wh_spec).sum(dim=-1, keepdim=True) * wh_spec
               - wo)

    wi_diff = cosine_sample_hemisphere(e[..., :2])
    wh_diff = _normalize(wo + wi_diff)

    take_spec = (e[..., 2] < surface["sw"])[..., None]
    wi = torch.where(take_spec, wi_spec, wi_diff)
    wh = torch.where(take_spec, wh_spec, wh_diff)

    pdf = pdf_brdf(surface, wo, wi, wh)
    brdf = evaluate_brdf(surface, wo, wi, wh)
    return brdf, wi, pdf, seed
