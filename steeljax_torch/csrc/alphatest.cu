// The exact alpha test at a hit, for Hopper (sm_90a): hit & the material's
// ALPHA_TEST flag & alpha < alpha cutoff, alpha the material's factor times
// the base-colour texture's alpha, bilinear at lod 0 at the hit's
// interpolated uv (AnyHit.rahit:35-52).  One thread a ray writes one bool.
//
// No Pallas kernel is replaced.  The JAX package computes this test in
// plain jnp (steeljax/render/pt/integrator.py:132-148).  The port ran it as
// torch operations over the whole ray batch (render/surface.alpha_rejected
// over surface.shade_rows): a gather of every ray's 56-float tri_shade row
// (224 B, misses clamped to row 0), then some 50 elementwise kernels, the
// bilinear sample's own gathers among them; it stays the plain version,
// and this kernel gives the same bits.
//
// The same bits: every operation is the plain version's, in its order,
// each rounded on its own as a separate torch kernel rounds it (__fmul_rn,
// __fadd_rn, __fsub_rn: never contracted into a fused multiply-add): the
// barycentric weight (1 - u) - v, the interpolation (r0 w + r1 u) + r2 v,
// x = uv * float(width) - 0.5 in two roundings and its floor, the wrap as
// Python's integer remainder, the texel times (float)(1 / 255), the two
// lerps in sample_bilinear's order; the float columns cast to int32 by
// truncation, as .to(torch.int32) casts them.
//
// What bounds it on this card: bytes, and which bytes.  A ray needs its
// hit flag, triangle id and (u, v), 13 B read and 1 B written; a hit needs
// ten columns of its row (uvs 18-23, alpha 35, cutoff 38, flags 40, the
// base-colour texture id 41), which lie in three of the row's seven 32-byte
// sectors (on instanced tables the uvs of the triangle's blas_shade row and
// the rest of the instance's inst_shade row, which world_shade_rows
// composes into that row), and one 16-byte quad row of the texel pool:
// about 130 B against the plain version's 448 B of row gathered and
// written back for every ray, dead or not, and its elementwise passes over
// the batch.  The
// design: one thread a ray, 256 threads a block, no shared memory; the ray
// columns read coalesced through their strides; a ray with no hit writes
// false and reads nothing more (in the alpha re-trace passes about 93% of
// the rays carry the dead interval and miss); a hit reads its row's
// flags sector first and stops where the material is not alpha-tested, then
// the alpha and uv sectors and the texture's size, offset and quad row
// through the read-only cache, as 16-byte loads.  At about 30 fp32
// operations a hit, operations never bound it.  Measured on an H100 over
// the 40 tests of a 1280x720 foliage frame, it takes about 6x the least
// time its bytes allow: at a few microseconds a launch, with most of a
// batch missing, the launch and a hit's chain of dependent loads (flag,
// id, row flags, alpha and uv, texture size and offset, texel) most likely
// set the pace.
//
// Launches on the caller's stream, allocates nothing, reads no device value
// on the host (so a CUDA graph can capture it) and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// The shading rows' columns read here (scene/flatten.TriShade), as the
// 16-byte groups that hold them: uv0 at 18, 19 (group 4, lanes 2, 3), uv1
// and uv2 at 20-23 (group 5); and the material's constants, which start at
// TriShade.MAT_ID (28): ALPHA 7, ALPHA_CUTOFF 10, FLAGS 12 and the
// base-colour texture id 13 columns on.  Flat tables read both from one
// 56-float tri_shade row; instanced tables read the uvs from the pool
// triangle's 28-float blas_shade row (TriGeometry: tri_shade's first 28
// columns) and the material from the instance's 48-float inst_shade row,
// where it starts at column 18 (accel/instances.InstShade.MATERIAL), the
// columns that instances.world_shade_rows copies into the composed row.
constexpr int kUvQuad = 4;
constexpr int kUvQuad2 = 5;
constexpr int kAlphaTest = 1;     // MaterialFlags.ALPHA_TEST
constexpr float kInv255 = (float)(1.0 / 255.0);

template <bool kInstanced>
struct Layout {
  static constexpr int kGeoQuads = kInstanced ? 7 : 14;   // row / 16 B
  static constexpr int kMatQuads = kInstanced ? 12 : 14;
  static constexpr int kMat = kInstanced ? 18 : 28;       // MAT_ID's place
  static constexpr int kAlpha = kMat + 7;
  static constexpr int kCutoff = kMat + 10;
  static constexpr int kFlags = kMat + 12;
  static constexpr int kTex = kMat + 13;
  static_assert(kFlags / 4 == kTex / 4, "flags and texture id share a group");
};

// Column kCol of a row, out of the 16-byte group q that holds it.
template <int kCol>
__device__ __forceinline__ float lane(const float4 q) {
  if constexpr (kCol % 4 == 0) return q.x;
  else if constexpr (kCol % 4 == 1) return q.y;
  else if constexpr (kCol % 4 == 2) return q.z;
  else return q.w;
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// torch.remainder of int32 values: the sign of the divisor.
__device__ __forceinline__ int py_remainder(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// int32 arithmetic as torch's kernels do it: wrapping.
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

struct AlphaArgs {
  const unsigned char* hit;
  const int* tri;
  const int* inst;              // instanced tables: the hits' instances
  const float* u;
  const float* v;
  long long hit_stride, tri_stride, inst_stride, u_stride, v_stride;
  const float4* geo;            // rows holding the uvs, by triangle
  const float4* mats;           // rows holding the material, by triangle
                                // (flat) or by instance (instanced)
  const uint4* atlas;           // (R, 16) uint8 quad rows
  const int* tex_offset;        // (K, mips) int32
  const int2* tex_size;         // (K, 2) int32
  int tex_mips;
  int textured;
  long long n;
  unsigned char* out;
};

// Channel 3 of sample_bilinear at lod 0 (render/texture._bilinear_level).
__device__ float texel_alpha(const AlphaArgs& a, int tex_id, float uvx,
                             float uvy) {
  const int tid = tex_id < 0 ? 0 : tex_id;
  const int2 size = __ldg(a.tex_size + tid);
  const int off = __ldg(a.tex_offset + (long long)tid * a.tex_mips);
  const int w = size.x < 1 ? 1 : size.x;
  const int h = size.y < 1 ? 1 : size.y;
  const float x = sub(mul(uvx, (float)w), 0.5f);
  const float y = sub(mul(uvy, (float)h), 0.5f);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = sub(x, x0);
  const float fy = sub(y, y0);
  const int x0i = py_remainder((int)x0, w);
  const int y0i = py_remainder((int)y0, h);
  const int row = wrap_add(wrap_add(off, wrap_mul(y0i, w)), x0i);
  const uint4 quad = __ldg(a.atlas + (long long)row);
  // The alpha byte of each of the footprint's four texels: bytes 3, 7, 11
  // and 15 of the row.
  const float c0 = mul((float)(quad.x >> 24), kInv255);
  const float c1 = mul((float)(quad.y >> 24), kInv255);
  const float c2 = mul((float)(quad.z >> 24), kInv255);
  const float c3 = mul((float)(quad.w >> 24), kInv255);
  const float gx = sub(1.0f, fx);
  const float top = add(mul(c0, gx), mul(c1, fx));
  const float bot = add(mul(c2, gx), mul(c3, fx));
  return add(mul(top, sub(1.0f, fy)), mul(bot, fy));
}

template <bool kInstanced>
__global__ void __launch_bounds__(kThreads)
alpha_kernel(const AlphaArgs a) {
  using L = Layout<kInstanced>;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  bool rejected = false;
  if (a.hit[i * a.hit_stride]) {
    // Ids clamped at 0, as surface.shade_rows clamps them.
    int t = a.tri[i * a.tri_stride];
    t = t < 0 ? 0 : t;
    int m = t;
    if constexpr (kInstanced) {
      m = a.inst[i * a.inst_stride];
      m = m < 0 ? 0 : m;
    }
    const float4* mrow = a.mats + (long long)m * L::kMatQuads;
    const float4 flags_q = __ldg(mrow + L::kFlags / 4);
    if (((int)lane<L::kFlags>(flags_q) & kAlphaTest) != 0) {
      float alpha = lane<L::kAlpha>(__ldg(mrow + L::kAlpha / 4));
      float4 cutoff_q = flags_q;
      if constexpr (L::kCutoff / 4 != L::kFlags / 4) {
        cutoff_q = __ldg(mrow + L::kCutoff / 4);
      }
      const float cutoff = lane<L::kCutoff>(cutoff_q);
      if (a.textured) {
        const int tex_id = (int)lane<L::kTex>(flags_q);
        if (tex_id >= 0) {
          const float u = a.u[i * a.u_stride];
          const float v = a.v[i * a.v_stride];
          const float4* grow = a.geo + (long long)t * L::kGeoQuads;
          const float4 q0 = __ldg(grow + kUvQuad);
          const float4 q1 = __ldg(grow + kUvQuad2);
          const float w = sub(sub(1.0f, u), v);
          const float uvx = add(add(mul(q0.z, w), mul(q1.x, u)),
                                mul(q1.z, v));
          const float uvy = add(add(mul(q0.w, w), mul(q1.y, u)),
                                mul(q1.w, v));
          alpha = mul(alpha, texel_alpha(a, tex_id, uvx, uvy));
        }
      }
      rejected = alpha < cutoff;
    }
  }
  a.out[i] = rejected;
}

int grid(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// ptrs holds, in this order, the inputs hit (N,) bool, tri (N,) int32,
// inst (N,) int32 (read only with instanced tables; any of the others
// otherwise), u, v (N,) float32 (each strided), the rows holding the uvs
// (tri_shade (T, 56), or instanced blas_shade (T, 28)) and the rows
// holding the material (tri_shade, or instanced inst_shade (I, 48)),
// float32, the scene's atlas (R, 16) uint8, tex_offset (K, mips) int32
// and tex_size (K, 2) int32 (contiguous; the rows and atlas 16-byte
// aligned), then the output (N,) bool.  ints: n, textured (0/1), mips,
// instanced (0/1), then the strides (elements) of hit, tri, inst, u and v.
int steeljax_alpha_test(const void* const* ptrs, const long long* ints,
                        void* stream) {
  const long long n = ints[0];
  if (n < 0 || ints[2] < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  AlphaArgs a;
  a.hit = static_cast<const unsigned char*>(ptrs[0]);
  a.tri = static_cast<const int*>(ptrs[1]);
  a.inst = static_cast<const int*>(ptrs[2]);
  a.u = static_cast<const float*>(ptrs[3]);
  a.v = static_cast<const float*>(ptrs[4]);
  a.geo = static_cast<const float4*>(ptrs[5]);
  a.mats = static_cast<const float4*>(ptrs[6]);
  a.atlas = static_cast<const uint4*>(ptrs[7]);
  a.tex_offset = static_cast<const int*>(ptrs[8]);
  a.tex_size = static_cast<const int2*>(ptrs[9]);
  a.out = static_cast<unsigned char*>(const_cast<void*>(ptrs[10]));
  a.textured = (int)ints[1];
  a.tex_mips = (int)ints[2];
  a.hit_stride = ints[4];
  a.tri_stride = ints[5];
  a.inst_stride = ints[6];
  a.u_stride = ints[7];
  a.v_stride = ints[8];
  a.n = n;
  if (ints[3]) {
    alpha_kernel<true><<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(a);
  } else {
    alpha_kernel<false><<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
