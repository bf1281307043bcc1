// The two per-bounce stages of the path tracer around its visibility trace,
// for Hopper (sm_90a): next-event estimation up to the shadow ray (N, the
// `nee` kernel) and BRDF sampling with Russian roulette (S, the `sample`
// kernel).  One thread a ray; each reads the ray's state once and writes
// the next state once.
//
// No Pallas kernel is replaced.  The JAX package computes this work in
// plain jnp (steeljax/render/pt/integrator.py: trace_paths, direct_lighting,
// sample_light, _estimate_lights, _light_distortion; render/pt/brdf.py:
// sample_brdf, evaluate_brdf, pdf_brdf).  The port ran it as torch
// operations, about 460 elementwise launches a bounce over the whole ray
// batch (the RNG's uint32 emulation alone some 15-20 a draw); the plain
// versions in render/pt/stages.py are that code, and these kernels compute
// the same numbers.
//
// The same numbers: every formula is the plain version's, in its order,
// each operation rounded on its own as a separate torch kernel rounds it
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: never
// contracted into a fused multiply-add), with libdevice's sinf, cosf and
// powf (no fast math).  Where one torch kernel does several operations the
// kernel follows that kernel's own rounding: the sum of a 3-vector's terms
// (torch's reduction over a last dimension of 3 runs it on two threads of
// a block row: (x0 + x2) + x1, SUM3), the L2 norm (the same order over the
// squares, then the square root, NORM3) and the cross product (each
// component's first product fused into the subtraction of the second,
// rounded, CROSS).  The xoroshiro64** state is a (N, 2) int64 tensor of
// 32-bit words, as core/rng.py keeps it; the kernels step it in uint32.
// Every lane draws what the plain version draws, alive or not: 3 floats in
// N when the scene has lights (the light pick, then 2 for the penumbra
// jitter), 3 in S for the BRDF sample and 1 more for roulette.
//
// What bounds it on this card: bytes.  A ray reads and writes about 470 B
// of state a bounce across N and S (inputs as strided views, the surface
// rows of the shading unpack included), against a few hundred fp32
// operations, four transcendental calls and a light loop of light_count
// iterations: at 921,600 rays and 4 bounces, about 1.7 GB, 0.5 ms a frame
// at 3.35 TB/s.  The design: one thread a ray, rows read where they lie
// (a row and a value stride for every input, so the shading unpack's
// column slices and the primary rays' broadcast origin need no copy), the
// light table read through the read-only cache, 256 threads a block, no
// shared memory; a warp's reads of 32 consecutive 12-byte rows are
// contiguous.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLights = 16;

// The plain version's constants as torch casts them to float32.
constexpr float kPi = (float)3.141592654;             // PI
constexpr float kTwoPi = (float)(2.0 * 3.141592654);  // 2.0 * PI, in Python
constexpr float kInvPi = (float)0.31830988618;        // INVERSE_PI
constexpr float kEpsilon = (float)1e-6;               // EPSILON
constexpr float kF0 = (float)0.04;                    // DIELECTRIC_F0
constexpr float kBias = (float)0.005;                 // BIAS
constexpr float kRayMinT = (float)0.001;              // RAY_MIN_T
constexpr float kRayMaxT = (float)1000.0;             // RAY_MAX_T
constexpr float kRayDeadT = (float)-3.0e38;           // RAY_DEAD_T
constexpr float kDiskRadius = (float)0.0047;  // DIRECT_LIGHT_DISK_RADIUS
constexpr float kPointRadius = (float)0.05;           // POINT_LIGHT_RADIUS
constexpr float kLuma0 = (float)0.2126;
constexpr float kLuma1 = (float)0.7152;
constexpr float kLuma2 = (float)0.0722;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.clamp(x, min=lo) / (x, max=hi): NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

struct V3 { float x, y, z; };

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  return {x, y, z};
}
__device__ __forceinline__ V3 vadd(V3 a, V3 b) {
  return {add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)};
}
__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)};
}
__device__ __forceinline__ V3 vmul(V3 a, V3 b) {
  return {mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z)};
}
__device__ __forceinline__ V3 vscale(V3 a, float s) {
  return {mul(a.x, s), mul(a.y, s), mul(a.z, s)};
}
__device__ __forceinline__ V3 vdiv(V3 a, float s) {
  return {dvd(a.x, s), dvd(a.y, s), dvd(a.z, s)};
}
__device__ __forceinline__ V3 vneg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 vsel(bool c, V3 a, V3 b) { return c ? a : b; }

// (v * w).sum(dim=-1): the products rounded, then torch's reduction order
// over a last dimension of 3; the trailing + 0 is its identity, which turns
// a -0 sum into +0 as the reduction does.
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return add(add(add(x0, x2), x1), 0.0f);
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return sum3(mul(a.x, b.x), mul(a.y, b.y), mul(a.z, b.z));
}
// torch.linalg.vector_norm(v, dim=-1).
__device__ __forceinline__ float norm3(V3 a) {
  return __fsqrt_rn(add(add(mul(a.x, a.x), mul(a.z, a.z)), mul(a.y, a.y)));
}
// v / clamp(vector_norm(v), 1e-20) (brdf._normalize).
__device__ __forceinline__ V3 normalize(V3 a) {
  return vdiv(a, clamp_min(norm3(a), 1e-20f));
}
// torch.linalg.cross(a, b): a1 * b2 - a2 * b1, the first product fused.
__device__ __forceinline__ float cross1(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -mul(c, d));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {cross1(a.y, b.z, a.z, b.y), cross1(a.z, b.x, a.x, b.z),
          cross1(a.x, b.y, a.y, b.x)};
}
__device__ __forceinline__ float luminance(V3 c) {
  return add(add(mul(c.x, kLuma0), mul(c.y, kLuma1)), mul(c.z, kLuma2));
}
// brdf.world_to_tangent / tangent_to_world.
__device__ __forceinline__ V3 to_tangent(V3 v, V3 t, V3 b, V3 n) {
  return {dot(v, t), dot(v, b), dot(v, n)};
}
__device__ __forceinline__ V3 to_world(V3 v, V3 t, V3 b, V3 n) {
  return vadd(vadd(vscale(t, v.x), vscale(b, v.y)), vscale(n, v.z));
}

// core/rng.py: one xoroshiro64** step and the mantissa trick.
struct Rng {
  uint32_t s0, s1;
  __device__ __forceinline__ float next() {
    const uint32_t r0 = s0 * 0x9E3779BBu;
    const uint32_t result = ((r0 << 5) | (r0 >> 27)) * 5u;
    s1 ^= s0;
    s0 = ((s0 << 26) | (s0 >> 6)) ^ s1 ^ (s1 << 9);
    s1 = (s1 << 13) | (s1 >> 19);
    return sub(__uint_as_float(0x3F800000u | (result >> 9)), 1.0f);
  }
};

// brdf.make_surface's terms.
struct Surface {
  V3 base;
  float roughness, metallic;
  V3 f0;
  float a, a2, sw;
};

__device__ __forceinline__ Surface make_surface(V3 base, float roughness,
                                                float metallic) {
  Surface s;
  s.base = base;
  s.roughness = roughness;
  s.metallic = metallic;
  s.f0 = {add(mul(sub(base.x, kF0), metallic), kF0),
          add(mul(sub(base.y, kF0), metallic), kF0),
          add(mul(sub(base.z, kF0), metallic), kF0)};
  s.a = mul(roughness, roughness);
  s.a2 = clamp_min(mul(s.a, s.a), kEpsilon);
  const float diffuse_lum = mul(luminance(base), sub(1.0f, metallic));
  const float specular_lum = luminance(s.f0);
  s.sw = clamp_max(
      dvd(specular_lum, clamp_min(add(specular_lum, diffuse_lum), 1e-20f)),
      1.0f);
  return s;
}

// 5.0f as a value the compiler cannot see: torch's pow(x, 5.0) hands
// its exponent to powf at run time, and a literal exponent lets the
// compiler rewrite powf as products, which round otherwise.
__device__ __forceinline__ float opaque_five() {
  float five;
  asm("mov.f32 %0, 0f40A00000;" : "=f"(five));
  return five;
}

__device__ __forceinline__ float d_ggx(float a2, float noh) {
  const float d = add(mul(sub(mul(noh, a2), noh), noh), 1.0f);
  return dvd(a2, mul(mul(d, kPi), d));
}

// brdf.evaluate_brdf; compose 0 both terms, 1 the diffuse, 2 the specular.
__device__ __forceinline__ V3 evaluate_brdf(const Surface& s, V3 wo, V3 wi,
                                            V3 wh, int compose) {
  const float nov = clamp_min(wo.z, 0.0f);
  const float nol = clamp_min(wi.z, 0.0f);
  const float noh = clamp_min(wh.z, 0.0f);
  const float voh = clamp_min(dot(wo, wh), 0.0f);
  const float d = d_ggx(s.a2, noh);
  const float fc = powf(sub(1.0f, voh), opaque_five());
  const V3 f = {add(s.f0.x, mul(sub(1.0f, s.f0.x), fc)),
                add(s.f0.y, mul(sub(1.0f, s.f0.y), fc)),
                add(s.f0.z, mul(sub(1.0f, s.f0.z), fc))};
  const float k = mul(s.a, 0.5f);
  const float vis_v = add(mul(nov, sub(1.0f, k)), k);
  const float vis_l = add(mul(nol, sub(1.0f, k)), k);
  const float denom = mul(vis_v, vis_l);
  const float vis =
      mul(0.25f, denom == 0.0f ? 1e10f : dvd(1.0f, denom));
  const float om = sub(1.0f, s.metallic);
  const V3 diffuse = {mul(mul(sub(1.0f, f.x), om), mul(s.base.x, kInvPi)),
                      mul(mul(sub(1.0f, f.y), om), mul(s.base.y, kInvPi)),
                      mul(mul(sub(1.0f, f.z), om), mul(s.base.z, kInvPi))};
  const V3 specular = {mul(mul(d, f.x), vis), mul(mul(d, f.y), vis),
                       mul(mul(d, f.z), vis)};
  if (compose == 1) return diffuse;
  if (compose == 2) return specular;
  return vadd(diffuse, specular);
}

// A strided input: row i at p + i * s, its k-th value at + k * e
// (elements); the flags' and seeds' values in a row are adjacent.
struct F { const float* p; long long s, e; };
struct B { const unsigned char* p; long long s, e; };
struct S { const long long* p; long long s, e; };

__device__ __forceinline__ float ld(F a, long long i) {
  return __ldg(a.p + i * a.s);
}
__device__ __forceinline__ V3 ld3(F a, long long i) {
  const float* r = a.p + i * a.s;
  return {__ldg(r), __ldg(r + a.e), __ldg(r + 2 * a.e)};
}
__device__ __forceinline__ bool ldb(B a, long long i) {
  return __ldg(a.p + i * a.s) != 0;
}
__device__ __forceinline__ void st3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ Rng ld_seed(S a, long long i) {
  const long long* r = a.p + i * a.s;
  return {(uint32_t)__ldg(r), (uint32_t)__ldg(r + 1)};
}
__device__ __forceinline__ void st_seed(long long* p, long long i, Rng r) {
  p[2 * i] = (long long)r.s0;
  p[2 * i + 1] = (long long)r.s1;
}

struct NeeArgs {
  F base, rough, metal, emis, tt, tb, tn, o, d, thit;
  B hit;
  F thr, rpdf;
  B alive, miss;
  F irr;
  S seed;
  const float* light_loc;  // (16, 4): xyz, w = 1 for a point light
  const float* light_col;  // (16, 4): rgb
  int light_count, compose;
  long long n;
  unsigned char *alive_out, *miss_out;
  float *irr_out, *p_out, *wo_out;
  long long* seed_out;
  float *so_out, *sd_out, *tfar_out, *contrib_out;
  unsigned char* has_light_out;
};

__global__ void __launch_bounds__(kThreads)
nee_kernel(const NeeArgs a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const float cpdf = clamp_min(ld(a.rpdf, i), 1e-30f);
  const V3 thr = ld3(a.thr, i);
  const V3 weight = vdiv(thr, cpdf);
  const bool hit = ldb(a.hit, i);
  const bool was_alive = ldb(a.alive, i);
  const bool miss = ldb(a.miss, i) || (was_alive && !hit);
  const bool alive = was_alive && hit;

  // Emission (RayGen.rgen:361).
  const V3 em = ld3(a.emis, i);
  V3 irr = ld3(a.irr, i);
  irr = vadd(irr, alive ? vmul(em, weight) : v3(0.0f, 0.0f, 0.0f));

  const V3 o = ld3(a.o, i), d = ld3(a.d, i);
  const V3 p = vadd(o, vscale(d, ld(a.thit, i)));
  const V3 t = ld3(a.tt, i), b = ld3(a.tb, i), n = ld3(a.tn, i);
  const V3 wo = normalize(to_tangent(vneg(d), t, b, n));

  a.alive_out[i] = alive;
  a.miss_out[i] = miss;
  st3(a.irr_out, i, irr);
  st3(a.p_out, i, p);
  st3(a.wo_out, i, wo);
  if (a.light_count <= 0) return;

  // The light pick (stages.sample_light, _estimate_lights).
  float est[kMaxLights];
  float running = 0.0f, cum[kMaxLights];
  for (int l = 0; l < a.light_count; ++l) {
    const float4 loc = __ldg(reinterpret_cast<const float4*>(a.light_loc) + l);
    const float4 col = __ldg(reinterpret_cast<const float4*>(a.light_col) + l);
    const V3 dir = vsub(v3(loc.x, loc.y, loc.z), vscale(p, loc.w));
    const float dist2 = dot(dir, dir);
    const float att = loc.w == 0.0f ? 1.0f
                      : (dist2 == 0.0f ? 1e10f : dvd(1.0f, dist2));
    const float nol = clamp_min(dot(n, normalize(dir)), 0.0f);
    est[l] = mul(mul(att, nol), luminance(v3(col.x, col.y, col.z)));
    running = l == 0 ? est[0] : add(running, est[l]);
    cum[l] = running;
  }
  const float total = running;
  const bool has_light = total > 0.0f;
  const float ctotal = clamp_min(total, 1e-20f);
  Rng rng = ld_seed(a.seed, i);
  const float pick = rng.next();
  int index = 0;
  for (int l = 0; l + 1 < a.light_count; ++l) {
    index += pick >= dvd(cum[l], ctotal);
  }
  const float pdf = dvd(est[index], ctotal);
  const float4 loc =
      __ldg(reinterpret_cast<const float4*>(a.light_loc) + index);
  const float4 col =
      __ldg(reinterpret_cast<const float4*>(a.light_col) + index);
  const float is_point = loc.w;
  V3 dir = vsub(v3(loc.x, loc.y, loc.z), vscale(p, is_point));

  // The penumbra jitter (stages._light_distortion) about -dir.
  const V3 nl = vneg(dir);
  V3 u = v3(nl.y, -nl.x, 0.0f);
  const float u_len = norm3(u);
  u = u_len > 1e-12f ? vdiv(u, clamp_min(u_len, 1e-20f))
                     : v3(1.0f, 0.0f, 0.0f);
  const V3 v = normalize(cross(nl, u));
  const float theta = mul(mul(rng.next(), 2.0f), kPi);
  V3 offset = vadd(vscale(u, cosf(theta)), vscale(v, sinf(theta)));
  const float r = rng.next();
  const float dd = __fsqrt_rn(clamp_min(sub(1.0f, mul(r, r)), 0.0f));
  offset = vadd(vscale(offset, r), vscale(normalize(nl), mul(dd, is_point)));
  const bool directional = is_point == 0.0f;
  dir = vadd(dir, vscale(offset, directional ? kDiskRadius : kPointRadius));
  const float length = norm3(dir);
  const float distance = directional ? kRayMaxT : length;
  const float attenuation =
      directional ? 1.0f
                  : dvd(1.0f, clamp_min(mul(distance, distance), 1e-20f));
  const V3 l_dir = vdiv(dir, clamp_min(length, 1e-20f));

  // DirectLighting up to the visibility trace (integrator.direct_lighting).
  const V3 wi = to_tangent(l_dir, t, b, n);
  const V3 wh = normalize(vadd(wo, wi));
  const Surface s = make_surface(ld3(a.base, i), ld(a.rough, i),
                                 ld(a.metal, i));
  const V3 f = evaluate_brdf(s, wo, wi, wh, a.compose);
  const float scale = dvd(attenuation, clamp_min(pdf, 1e-20f));
  const V3 contrib = vscale(
      vmul(vscale(f, clamp_min(wi.z, 0.0f)), v3(col.x, col.y, col.z)), scale);

  st3(a.so_out, i, vadd(p, vscale(n, kBias)));
  st3(a.sd_out, i, l_dir);
  a.tfar_out[i] = has_light ? distance : kRayDeadT;
  st3(a.contrib_out, i, contrib);
  a.has_light_out[i] = has_light;
  st_seed(a.seed_out, i, rng);
}

struct SampleArgs {
  F base, rough, metal, tt, tb, tn, p, wo, d, contrib;
  B has_light, occluded;
  F thr, rpdf;
  B alive;
  F irr;
  S seed;
  int direct, roulette;
  float rr_min;
  long long n;
  float *d_out, *thr_out, *rpdf_out;
  unsigned char* alive_out;
  float* irr_out;
  long long* seed_out;
  float *tmin_out, *tmax_out;
};

__global__ void __launch_bounds__(kThreads)
sample_kernel(const SampleArgs a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  V3 thr = ld3(a.thr, i);
  float ray_pdf = ld(a.rpdf, i);
  bool alive = ldb(a.alive, i);
  V3 irr = ld3(a.irr, i);

  // The shadow ray's verdict (integrator.direct_lighting, trace_paths).
  if (a.direct) {
    const V3 weight = vdiv(thr, clamp_min(ray_pdf, 1e-30f));
    const bool visible = ldb(a.has_light, i) && !ldb(a.occluded, i);
    const V3 direct = visible ? ld3(a.contrib, i) : v3(0.0f, 0.0f, 0.0f);
    irr = vadd(irr, alive ? vmul(direct, weight) : v3(0.0f, 0.0f, 0.0f));
  }

  // brdf.sample_brdf.
  const Surface s = make_surface(ld3(a.base, i), ld(a.rough, i),
                                 ld(a.metal, i));
  const V3 wo = ld3(a.wo, i);
  Rng rng = ld_seed(a.seed, i);
  const float e0 = rng.next(), e1 = rng.next(), e2 = rng.next();
  const float phi = mul(kTwoPi, e0);
  const float cos_phi = cosf(phi), sin_phi = sinf(phi);
  const float cs = __fsqrt_rn(clamp_min(
      dvd(sub(1.0f, e1), add(1.0f, mul(sub(s.a2, 1.0f), e1))), 0.0f));
  const float ss = __fsqrt_rn(clamp_min(sub(1.0f, mul(cs, cs)), 0.0f));
  const V3 wh_spec = v3(mul(ss, cos_phi), mul(ss, sin_phi), cs);
  const V3 wi_spec = vsub(vscale(wh_spec, mul(2.0f, dot(wo, wh_spec))), wo);
  const float cd = __fsqrt_rn(clamp_min(e1, 0.0f));
  const float sd = __fsqrt_rn(clamp_min(sub(1.0f, mul(cd, cd)), 0.0f));
  const V3 wi_diff = v3(mul(sd, cos_phi), mul(sd, sin_phi), cd);
  const V3 wh_diff = normalize(vadd(wo, wi_diff));
  const bool take_spec = e2 < s.sw;
  const V3 wi = vsel(take_spec, wi_spec, wi_diff);
  const V3 wh = vsel(take_spec, wh_spec, wh_diff);

  const float cos_wi = clamp_min(wi.z, 0.0f);
  const float noh = clamp_min(wh.z, 0.0f);
  const float spec_pdf = dvd(mul(noh, d_ggx(s.a2, noh)),
                             clamp_min(mul(4.0f, dot(wi, wh)), kEpsilon));
  const float pdf = add(mul(mul(cos_wi, kInvPi), sub(1.0f, s.sw)),
                        mul(spec_pdf, s.sw));
  const V3 f = evaluate_brdf(s, wo, wi, wh, 0);

  const bool black = dot(f, f) < kEpsilon;
  alive = alive && pdf >= kEpsilon && !black;
  if (alive) {
    thr = vscale(vmul(thr, f), cos_wi);
    ray_pdf = mul(ray_pdf, pdf);
  }

  // Russian roulette (RayGen.rgen:387-395).
  if (a.roulette) {
    // throughput.max(dim=-1): a NaN wins.
    float most = thr.x;
    most = (isnan(most) || most > thr.y) ? most : thr.y;
    most = (isnan(most) || most > thr.z) ? most : thr.z;
    const float threshold = clamp_min(sub(1.0f, most), a.rr_min);
    const float r = rng.next();
    alive = alive && !(r < threshold);
    if (alive) thr = vdiv(thr, clamp_min(sub(1.0f, threshold), 1e-20f));
  }

  const V3 t = ld3(a.tt, i), b = ld3(a.tb, i), n = ld3(a.tn, i);
  const V3 d = alive ? to_world(wi, t, b, n) : ld3(a.d, i);
  st3(a.d_out, i, d);
  st3(a.thr_out, i, thr);
  a.rpdf_out[i] = ray_pdf;
  a.alive_out[i] = alive;
  st3(a.irr_out, i, irr);
  st_seed(a.seed_out, i, rng);
  a.tmin_out[i] = kRayMinT;
  a.tmax_out[i] = alive ? kRayMaxT : kRayDeadT;
}

// Input k's view: its row and value strides are strides[2k], [2k + 1].
template <typename T>
T view(const void* const* ptrs, const long long* strides, int k) {
  return {static_cast<decltype(T::p)>(ptrs[k]), strides[2 * k],
          strides[2 * k + 1]};
}

int grid(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// nee: ptrs holds, in this order, the inputs base_color (N, 3), roughness,
// metallic (N,), emission, tangent, bitangent, normal, o, d (N, 3), t_hit
// (N,), hit (N,) bool, throughput (N, 3), ray_pdf (N,), alive, miss (N,)
// bool, irradiance (N, 3), seed (N, 2) int64, light_location,
// light_color (16, 4), then the outputs alive, miss (N,) bool, irradiance,
// p, wo (N, 3), seed (N, 2), and with lights shadow origin, shadow
// direction (N, 3), t_far (N,), contribution (N, 3), has_light (N,) bool.
// ints: n, light_count, compose (0 both, 1 diffuse, 2 specular), then the
// row and value strides (elements) of the 17 ray inputs, two each; the
// outputs are contiguous.
int steeljax_nee_stage(const void* const* ptrs, const long long* ints,
                       void* stream) {
  const long long n = ints[0];
  const int light_count = (int)ints[1];
  if (n < 0 || light_count < 0 || light_count > kMaxLights) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  const long long* st = ints + 3;
  NeeArgs a;
  a.base = view<F>(ptrs, st, 0);
  a.rough = view<F>(ptrs, st, 1);
  a.metal = view<F>(ptrs, st, 2);
  a.emis = view<F>(ptrs, st, 3);
  a.tt = view<F>(ptrs, st, 4);
  a.tb = view<F>(ptrs, st, 5);
  a.tn = view<F>(ptrs, st, 6);
  a.o = view<F>(ptrs, st, 7);
  a.d = view<F>(ptrs, st, 8);
  a.thit = view<F>(ptrs, st, 9);
  a.hit = view<B>(ptrs, st, 10);
  a.thr = view<F>(ptrs, st, 11);
  a.rpdf = view<F>(ptrs, st, 12);
  a.alive = view<B>(ptrs, st, 13);
  a.miss = view<B>(ptrs, st, 14);
  a.irr = view<F>(ptrs, st, 15);
  a.seed = view<S>(ptrs, st, 16);
  a.light_loc = static_cast<const float*>(ptrs[17]);
  a.light_col = static_cast<const float*>(ptrs[18]);
  a.light_count = light_count;
  a.compose = (int)ints[2];
  a.n = n;
  a.alive_out = static_cast<unsigned char*>(const_cast<void*>(ptrs[19]));
  a.miss_out = static_cast<unsigned char*>(const_cast<void*>(ptrs[20]));
  a.irr_out = static_cast<float*>(const_cast<void*>(ptrs[21]));
  a.p_out = static_cast<float*>(const_cast<void*>(ptrs[22]));
  a.wo_out = static_cast<float*>(const_cast<void*>(ptrs[23]));
  a.seed_out = static_cast<long long*>(const_cast<void*>(ptrs[24]));
  a.so_out = static_cast<float*>(const_cast<void*>(ptrs[25]));
  a.sd_out = static_cast<float*>(const_cast<void*>(ptrs[26]));
  a.tfar_out = static_cast<float*>(const_cast<void*>(ptrs[27]));
  a.contrib_out = static_cast<float*>(const_cast<void*>(ptrs[28]));
  a.has_light_out = static_cast<unsigned char*>(const_cast<void*>(ptrs[29]));
  nee_kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// sample: ptrs holds the inputs base_color (N, 3), roughness, metallic
// (N,), tangent, bitangent, normal, p, wo, d, contribution (N, 3),
// has_light, occluded (N,) bool (the last three null without a direct
// term), throughput (N, 3), ray_pdf (N,), alive (N,) bool, irradiance
// (N, 3), seed (N, 2) int64, then the outputs d, throughput (N, 3),
// ray_pdf (N,), alive (N,) bool, irradiance (N, 3), seed (N, 2), t_min,
// t_max (N,).  ints: n, direct (0/1), roulette (0/1), then the row and
// value strides of the 17 inputs, two each.
int steeljax_sample_stage(const void* const* ptrs, const long long* ints,
                          float rr_min, void* stream) {
  const long long n = ints[0];
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long* st = ints + 3;
  SampleArgs a;
  a.base = view<F>(ptrs, st, 0);
  a.rough = view<F>(ptrs, st, 1);
  a.metal = view<F>(ptrs, st, 2);
  a.tt = view<F>(ptrs, st, 3);
  a.tb = view<F>(ptrs, st, 4);
  a.tn = view<F>(ptrs, st, 5);
  a.p = view<F>(ptrs, st, 6);
  a.wo = view<F>(ptrs, st, 7);
  a.d = view<F>(ptrs, st, 8);
  a.contrib = view<F>(ptrs, st, 9);
  a.has_light = view<B>(ptrs, st, 10);
  a.occluded = view<B>(ptrs, st, 11);
  a.thr = view<F>(ptrs, st, 12);
  a.rpdf = view<F>(ptrs, st, 13);
  a.alive = view<B>(ptrs, st, 14);
  a.irr = view<F>(ptrs, st, 15);
  a.seed = view<S>(ptrs, st, 16);
  a.direct = (int)ints[1];
  a.roulette = (int)ints[2];
  if (a.direct && (a.contrib.p == nullptr || a.has_light.p == nullptr ||
                   a.occluded.p == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  a.rr_min = rr_min;
  a.n = n;
  a.d_out = static_cast<float*>(const_cast<void*>(ptrs[17]));
  a.thr_out = static_cast<float*>(const_cast<void*>(ptrs[18]));
  a.rpdf_out = static_cast<float*>(const_cast<void*>(ptrs[19]));
  a.alive_out = static_cast<unsigned char*>(const_cast<void*>(ptrs[20]));
  a.irr_out = static_cast<float*>(const_cast<void*>(ptrs[21]));
  a.seed_out = static_cast<long long*>(const_cast<void*>(ptrs[22]));
  a.tmin_out = static_cast<float*>(const_cast<void*>(ptrs[23]));
  a.tmax_out = static_cast<float*>(const_cast<void*>(ptrs[24]));
  sample_kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
