// BVH8 ray traversal for Hopper (sm_90a), one thread per ray.
//
// One templated body, instanced as three TPU kernels of
// steeljax/accel/pallas_traverse.py:_traverse_kernel8 (host wrapper
// _trace_packed8, pallas_call at :719):
//   K1  nearest hit, shade modes 0 and 1 (entry trace_nearest_packet8);
//   K3  nearest hit with textured fused shading, shade mode 2 (:548-565,
//       :608-617);
//   K2  any-hit occlusion (any_hit=True, :506-517, :574-594), over the
//       12-record rows or the dense 14-record rows (trace_anyhit_dense,
//       :781-794).
// Each instance is specialized at compile time on (ANY_HIT, DENSE, SHADE2,
// COUNT), so K1's instance has no code of the others.  The alpha-masked
// kernels K4 (nearest and any-hit) and K5 (K nearest) are alpha8.cu, the
// two-level kernel K6 instanced8.cu, the treelet kernel K7 treelet8.cu.
//
// Tables, in the reference's formats unchanged:
//   snodes (S, 128) f32: 8 children per supernode row, child c at floats
//     [16c, 16c + 8) = [min.xyz, max.xyz, meta0, meta1]; meta1 > 0 is a leaf
//     (meta0 = row-aligned first record, meta1 = count), meta1 == 0 and
//     meta0 >= 0 an internal child (meta0 = supernode row), meta0 < 0 empty
//     (accel/bvh.py collapse_bvh8).
//   tris (R, 128) f32: record k at row k / 12, floats (k % 12) * 10 .. +9 =
//     [v0.xyz, e1.xyz, e2.xyz, double_sided] (cuda_traverse.pack_tris); the
//     dense any-hit layout puts record k at row k / 14, floats (k % 14) * 9
//     .. +8 = [v0.xyz, e1.xyz, e2.xyz] (pack_tris_dense), over supernode
//     rows whose leaves start at multiples of 14.
//   shade (R, 128) f32, mode 1: the tris addressing, records [n0.xyz,
//     n1.xyz, n2.xyz, mat]; mode 2: record k at row (k / 12) * 3 +
//     (k % 12) / 4, floats (k % 4) * 26 .. +25 = [n0.xyz, n1.xyz, n2.xyz,
//     mat, t0.xyz, t1.xyz, t2.xyz, uv0.xy, uv1.xy, uv2.xy, uv_density]
//     (pallas_traverse.py:437-441, cuda_traverse.pack_shade_records).
//   With alpha masks float 9 of a triangle record is the AUX word ds |
//     mask << 1, an exact integer below 2^22 (cuda_traverse.pack_tris), and
//     fine (R, 128) int32 rows run parallel to the triangle rows: record k
//     at row k / 12, words (k % 12) * 10 .. +9 = 5 PASS words, 5 OPAQUE
//     words of the 153-cell fine grid (pack_fine_mask_rows; read by
//     alpha8.cu).  This file reads no masks.
//
// What bounds it on this card.  K1: the scene tables of small scenes stay
// resident in L1/L2, so HBM bandwidth is not the limit; each ray walks its
// own path through the tree, so the kernel is bound by the latency of its
// dependent table reads and by warp divergence when neighbouring rays take
// different paths.  K3: the same as K1, plus one 104-byte shade record per
// ray after the walk.  K2: the dependent-load latency of the walk, which
// ends at the first occluder found.
//
// What the design does about it: one thread per ray with a private stack
// in local memory, so no ray waits on a packet-wide union of nodes (the
// TPU's packet traversal had no per-lane control flow; this card has).  The
// nearest query pushes children far-to-near by their own entry distance, so
// the nearest hit is found early and the far children are culled at pop
// time against the shrinking best t.  The any-hit query keeps no entry
// distances (its interval never shrinks), tests no facing and no shade
// record, and returns at the first accepted candidate.  Table reads go
// through the read-only cache (__ldg).  The winner's shading attributes are
// interpolated once, after the walk, from one record.
//
// Arithmetic follows the reference kernel (pallas_traverse.py:303-305 slab
// reciprocal, :369-383 slab test, :468-490 Moller-Trumbore, :597-617
// normalization).  nvcc contracts a*b+c into FMA, so results may differ
// from the CPU version in the last bit.
//
// Optional telemetry (COUNT instances, the reference's counters=True,
// :618-628): per ray, [supernode pops, triangle-row bodies, leaf pops,
// triangle tests, 0, 0] (the alpha kernels count mask tests in the last
// two); besides, a COUNT instance sets seen_snode[row] for every supernode row
// popped and seen_rec[k] for every triangle record tested, so the caller
// can count the distinct table bytes the walk read.  The render path never
// launches a COUNT instance.

#include "trace8_common.cuh"

using namespace steeljax;

namespace {

struct TraceArgs {
  const float* snodes;
  const float* tris;
  const float* shade;
  const float* o;
  const float* d;
  const float* t_min;
  const float* t_max;
  float* out_t;
  float* out_u;
  float* out_v;
  int* out_tri;
  float* out_n;
  int* out_mat;
  float* out_tan;
  float* out_uv;
  float* out_uvd;
  unsigned char* out_hit;
  int* out_cnt;
  unsigned char* seen_snode;
  unsigned char* seen_rec;
  int n;
  int leaf_cap;
  int cull;
  int shade_mode;
};

template <bool ANY_HIT, bool DENSE, bool SHADE2, bool COUNT>
__global__ void __launch_bounds__(128) trace8_kernel(const TraceArgs a) {
  constexpr int kPerRow = DENSE ? DENSE_PER_ROW : TRI_PER_ROW;
  constexpr int kStride = DENSE ? DENSE_STRIDE : TRI_STRIDE;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;

  const float* snodes = a.snodes;
  const float* tris = a.tris;
  const float* shade = a.shade;

  const float ox = a.o[3 * i + 0], oy = a.o[3 * i + 1], oz = a.o[3 * i + 2];
  const float dx = a.d[3 * i + 0], dy = a.d[3 * i + 1], dz = a.d[3 * i + 2];
  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy),
              inv_dz = safe_inv(dz);
  const float tmn = a.t_min[i];

  float best_t = a.t_max[i];
  float best_u = 0.0f, best_v = 0.0f, best_det = 1.0f;
  int best_i = -1;
  bool occluded = false;
  int n_snode = 0, n_rows = 0, n_leaf = 0, n_tests = 0;

  // Stack entry: >= 0 is a supernode row; < 0 is a leaf child, encoded as
  // -(1 + row * 8 + child) so its meta is re-read from the row at pop time.
  int stack_e[MAX_STACK];
  // Entry distances, for the nearest query's pop-time cull only.
  float stack_near[ANY_HIT ? 1 : MAX_STACK];
  int sp = 0;
  // A dead ray (inverted interval, RAY_DEAD_T) traces nothing.
  if (best_t >= tmn) {
    stack_e[0] = 0;
    if constexpr (!ANY_HIT) stack_near[0] = -3.0e38f;
    sp = 1;
  }

  while (sp > 0) {
    --sp;
    const int entry = stack_e[sp];
    if constexpr (!ANY_HIT) {
      // Pop-time cull: the push-time test near <= best_t, re-evaluated
      // against the best t found since.
      if (stack_near[sp] > best_t) continue;
    }

    if (entry >= 0) {
      if constexpr (COUNT) {
        ++n_snode;
        a.seen_snode[entry] = 1;
      }
      const float* row = snodes + (size_t)entry * LANES;
      const int base = sp;
#pragma unroll
      for (int c = 0; c < SNODE_WIDTH; ++c) {
        const float* ch = row + CHILD_STRIDE * c;
        const float t0x = (__ldg(ch + 0) - ox) * inv_dx;
        const float t1x = (__ldg(ch + 3) - ox) * inv_dx;
        const float t0y = (__ldg(ch + 1) - oy) * inv_dy;
        const float t1y = (__ldg(ch + 4) - oy) * inv_dy;
        const float t0z = (__ldg(ch + 2) - oz) * inv_dz;
        const float t1z = (__ldg(ch + 5) - oz) * inv_dz;
        const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                  fminf(t0z, t1z));
        const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                 fmaxf(t0z, t1z));
        const int meta0 = (int)__ldg(ch + 6);
        const int meta1 = (int)__ldg(ch + 7);
        if (meta0 >= 0 && tnear <= tfar && tfar >= tmn && tnear <= best_t) {
          const int value =
              meta1 > 0 ? -(1 + entry * SNODE_WIDTH + c) : meta0;
          if constexpr (ANY_HIT) {
            // Any occluder ends the walk, so the order is free.
            stack_e[sp++] = value;
          } else {
            // Insertion keeps stack[base..sp) sorted by entry distance,
            // largest at the bottom, so the nearest child is popped first.
            int j = sp;
            while (j > base && stack_near[j - 1] < tnear) {
              stack_e[j] = stack_e[j - 1];
              stack_near[j] = stack_near[j - 1];
              --j;
            }
            stack_e[j] = value;
            stack_near[j] = tnear;
            ++sp;
          }
        }
      }
    } else {
      const int code = -entry - 1;
      const float* ch = snodes + (size_t)(code / SNODE_WIDTH) * LANES +
                        CHILD_STRIDE * (code % SNODE_WIDTH);
      const int start = (int)__ldg(ch + 6);
      const int count = min((int)__ldg(ch + 7), a.leaf_cap);
      int tested = 0;
      for (int l = 0; l < count; ++l) {
        const int rec = start + l;
        const float* r = tris + (size_t)(rec / kPerRow) * LANES +
                         kStride * (rec % kPerRow);
        const float v0x = __ldg(r + 0), v0y = __ldg(r + 1), v0z = __ldg(r + 2);
        const float e1x = __ldg(r + 3), e1y = __ldg(r + 4), e1z = __ldg(r + 5);
        const float e2x = __ldg(r + 6), e2y = __ldg(r + 7), e2z = __ldg(r + 8);
        if constexpr (COUNT) {
          ++tested;
          a.seen_rec[rec] = 1;
        }

        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool det_ok = fabsf(det) > kDetEps;
        bool facing = det_ok;
        if constexpr (!ANY_HIT) {
          const bool double_sided = __ldg(r + 9) > 0.5f;
          if (a.cull) facing = det > kDetEps || (double_sided && det_ok);
        }
        const float inv_det = 1.0f / (det_ok ? det : 1.0f);
        const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
        const float u = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        // t <= best_t: a later candidate wins an exact tie, as in the
        // reference kernel.
        if (facing && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmn &&
            t <= best_t) {
          if constexpr (ANY_HIT) {
            occluded = true;
            break;
          } else {
            best_t = t;
            best_u = u;
            best_v = v;
            best_i = rec;
            best_det = det;
          }
        }
      }
      if constexpr (COUNT) {
        ++n_leaf;
        n_rows += (tested + kPerRow - 1) / kPerRow;
        n_tests += tested;
      }
      if constexpr (ANY_HIT) {
        if (occluded) break;
      }
    }
  }

  if constexpr (COUNT) {
    a.out_cnt[N_COUNTERS * i + 0] = n_snode;
    a.out_cnt[N_COUNTERS * i + 1] = n_rows;
    a.out_cnt[N_COUNTERS * i + 2] = n_leaf;
    a.out_cnt[N_COUNTERS * i + 3] = n_tests;
    a.out_cnt[N_COUNTERS * i + 4] = 0;
    a.out_cnt[N_COUNTERS * i + 5] = 0;
  }
  if constexpr (ANY_HIT) {
    a.out_hit[i] = occluded ? 1 : 0;
    return;
  }

  a.out_t[i] = best_i >= 0 ? best_t : -1.0f;
  a.out_u[i] = best_u;
  a.out_v[i] = best_v;
  a.out_tri[i] = best_i;
  if (SHADE2 || a.shade_mode == 1) {
    // Miss: the reference's initial values (n = +z, mat 0, tangent = +x,
    // uv = 0, uv density 0).
    float nx = 0.0f, ny = 0.0f, nz = 1.0f, mat = 0.0f;
    float tnx = 1.0f, tny = 0.0f, tnz = 0.0f, ux = 0.0f, uy = 0.0f,
          uvd = 0.0f;
    if (best_i >= 0) {
      const float* s;
      if constexpr (SHADE2) {
        s = shade +
            (size_t)((best_i / TRI_PER_ROW) * (TRI_PER_ROW / SHADE2_PER_ROW) +
                     (best_i % TRI_PER_ROW) / SHADE2_PER_ROW) * LANES +
            SHADE2_STRIDE * (best_i % SHADE2_PER_ROW);
      } else {
        s = shade + (size_t)(best_i / TRI_PER_ROW) * LANES +
            SHADE1_STRIDE * (best_i % TRI_PER_ROW);
      }
      const float wb = 1.0f - best_u - best_v;
      nx = __ldg(s + 0) * wb + __ldg(s + 3) * best_u + __ldg(s + 6) * best_v;
      ny = __ldg(s + 1) * wb + __ldg(s + 4) * best_u + __ldg(s + 7) * best_v;
      nz = __ldg(s + 2) * wb + __ldg(s + 5) * best_u + __ldg(s + 8) * best_v;
      mat = __ldg(s + 9);
      if constexpr (SHADE2) {
        tnx = __ldg(s + 10) * wb + __ldg(s + 13) * best_u +
              __ldg(s + 16) * best_v;
        tny = __ldg(s + 11) * wb + __ldg(s + 14) * best_u +
              __ldg(s + 17) * best_v;
        tnz = __ldg(s + 12) * wb + __ldg(s + 15) * best_u +
              __ldg(s + 18) * best_v;
        ux = __ldg(s + 19) * wb + __ldg(s + 21) * best_u +
             __ldg(s + 23) * best_v;
        uy = __ldg(s + 20) * wb + __ldg(s + 22) * best_u +
             __ldg(s + 24) * best_v;
        uvd = __ldg(s + 25);
      }
    }
    // Normalize and flip back-face hits (ClosestHit.rchit:67-70): det < 0
    // is the winding-based hit kind.
    const float n2 = nx * nx + ny * ny + nz * nz;
    const float inv_n =
        (best_det < 0.0f ? -1.0f : 1.0f) * rsqrtf(fmaxf(n2, 1e-20f));
    a.out_n[3 * i + 0] = nx * inv_n;
    a.out_n[3 * i + 1] = ny * inv_n;
    a.out_n[3 * i + 2] = nz * inv_n;
    a.out_mat[i] = (int)mat;
    if constexpr (SHADE2) {
      // The tangent is normalized and never flipped.
      const float t2 = tnx * tnx + tny * tny + tnz * tnz;
      const float inv_t = rsqrtf(fmaxf(t2, 1e-20f));
      a.out_tan[3 * i + 0] = tnx * inv_t;
      a.out_tan[3 * i + 1] = tny * inv_t;
      a.out_tan[3 * i + 2] = tnz * inv_t;
      a.out_uv[2 * i + 0] = ux;
      a.out_uv[2 * i + 1] = uy;
      a.out_uvd[i] = uvd;
    }
  }
}

template <bool ANY_HIT, bool DENSE, bool SHADE2>
int launch(const TraceArgs& a, bool count, void* stream) {
  const int threads = 128;
  const int blocks = (a.n + threads - 1) / threads;
  if (count) {
    trace8_kernel<ANY_HIT, DENSE, SHADE2, true>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  } else {
    trace8_kernel<ANY_HIT, DENSE, SHADE2, false>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Nearest hit of n rays over a BVH8 (K1 for shade modes 0 and 1, K3 for
// mode 2).  Pointers are device pointers; shade and the shading outputs may
// be null when shade_mode == 0, out_tan/out_uv/out_uvd when it is not 2,
// and out_cnt (n x N_COUNTERS int32 counters) with seen_snode (one byte per
// supernode row) and seen_rec (one byte per triangle record), all three,
// when no telemetry is wanted; the seen bytes are set, never cleared.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int steeljax_trace_nearest8(const void* snodes, const void* tris,
                            const void* shade, const void* o, const void* d,
                            const void* t_min, const void* t_max,
                            void* out_t, void* out_u, void* out_v,
                            void* out_tri, void* out_n, void* out_mat,
                            void* out_tan, void* out_uv, void* out_uvd,
                            void* out_cnt, void* seen_snode, void* seen_rec,
                            int n, int max_leaf, int depth, int cull,
                            int shade_mode, void* stream) {
  if (n < 0 || max_leaf <= 0 || depth <= 0 || 8 * depth + 16 > MAX_STACK ||
      (out_cnt != nullptr && (seen_snode == nullptr || seen_rec == nullptr)) ||
      shade_mode < 0 || shade_mode > 2 ||
      (shade_mode != 0 && (shade == nullptr || out_n == nullptr ||
                           out_mat == nullptr)) ||
      (shade_mode == 2 && (out_tan == nullptr || out_uv == nullptr ||
                           out_uvd == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  TraceArgs a = {};
  a.snodes = (const float*)snodes;
  a.tris = (const float*)tris;
  a.shade = (const float*)shade;
  a.o = (const float*)o;
  a.d = (const float*)d;
  a.t_min = (const float*)t_min;
  a.t_max = (const float*)t_max;
  a.out_t = (float*)out_t;
  a.out_u = (float*)out_u;
  a.out_v = (float*)out_v;
  a.out_tri = (int*)out_tri;
  a.out_n = (float*)out_n;
  a.out_mat = (int*)out_mat;
  a.out_tan = (float*)out_tan;
  a.out_uv = (float*)out_uv;
  a.out_uvd = (float*)out_uvd;
  a.out_cnt = (int*)out_cnt;
  a.seen_snode = (unsigned char*)seen_snode;
  a.seen_rec = (unsigned char*)seen_rec;
  a.n = n;
  a.leaf_cap = leaf_cap(max_leaf, TRI_PER_ROW);
  a.cull = cull;
  a.shade_mode = shade_mode;
  const bool count = out_cnt != nullptr;
  if (shade_mode == 2) return launch<false, false, true>(a, count, stream);
  return launch<false, false, false>(a, count, stream);
}

// Occlusion of n rays over a BVH8 (K2): out_hit[i] = 1 when any triangle
// (no culling) is hit with t in [t_min, t_max], else 0; a dead ray (t_max <
// t_min) is never occluded.  dense != 0 reads the 14-record rows of
// pack_tris_dense over their own supernode rows.  out_cnt and the seen
// bytes as above.
int steeljax_trace_any8(const void* snodes, const void* tris, const void* o,
                        const void* d, const void* t_min, const void* t_max,
                        void* out_hit, void* out_cnt, void* seen_snode,
                        void* seen_rec, int n, int max_leaf, int depth,
                        int dense, void* stream) {
  if (n < 0 || max_leaf <= 0 || depth <= 0 || 8 * depth + 16 > MAX_STACK ||
      out_hit == nullptr ||
      (out_cnt != nullptr && (seen_snode == nullptr || seen_rec == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  TraceArgs a = {};
  a.snodes = (const float*)snodes;
  a.tris = (const float*)tris;
  a.o = (const float*)o;
  a.d = (const float*)d;
  a.t_min = (const float*)t_min;
  a.t_max = (const float*)t_max;
  a.out_hit = (unsigned char*)out_hit;
  a.out_cnt = (int*)out_cnt;
  a.seen_snode = (unsigned char*)seen_snode;
  a.seen_rec = (unsigned char*)seen_rec;
  a.n = n;
  const bool count = out_cnt != nullptr;
  if (dense) {
    a.leaf_cap = leaf_cap(max_leaf, DENSE_PER_ROW);
    return launch<true, true, false>(a, count, stream);
  }
  a.leaf_cap = leaf_cap(max_leaf, TRI_PER_ROW);
  return launch<true, false, false>(a, count, stream);
}

}  // extern "C"
