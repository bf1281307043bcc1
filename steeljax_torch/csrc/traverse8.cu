// BVH8 any-hit ray traversal for Hopper (sm_90a), one thread per ray: K2.
//
// TPU kernel replaced: steeljax/accel/pallas_traverse.py:_traverse_kernel8
// with any_hit=True (:506-517, :574-594; host wrapper _trace_packed8,
// pallas_call at :719), over the 12-record rows or the dense 14-record rows
// (trace_anyhit_dense, :781-794).  Each instance is specialized at compile
// time on (DENSE, COUNT).  The nearest-hit kernels K1 and K3, the
// alpha-masked kernels K4 and K5 are alpha8.cu, the two-level kernel K6
// instanced8.cu, the treelet kernel K7 treelet8.cu.
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
//   shade (R, 128) f32 (read by alpha8.cu, instanced8.cu, treelet8.cu),
//     mode 1: the tris addressing, records [n0.xyz, n1.xyz, n2.xyz, mat];
//     mode 2: record k at row (k / 12) * 3 + (k % 12) / 4, floats (k % 4) *
//     26 .. +25 = [n0.xyz, n1.xyz, n2.xyz, mat, t0.xyz, t1.xyz, t2.xyz,
//     uv0.xy, uv1.xy, uv2.xy, uv_density] (pallas_traverse.py:437-441,
//     cuda_traverse.pack_shade_records).
//   With alpha masks float 9 of a triangle record is the AUX word ds |
//     mask << 1, an exact integer below 2^22 (cuda_traverse.pack_tris), and
//     fine (R, 128) int32 rows run parallel to the triangle rows: record k
//     at row k / 12, words (k % 12) * 10 .. +9 = 5 PASS words, 5 OPAQUE
//     words of the 153-cell fine grid (pack_fine_mask_rows; read by
//     alpha8.cu).  This file reads no masks.
//
// What bounds it on this card: the dependent-load latency of the walk,
// which ends at the first occluder found.
//
// What the design does about it: one thread per ray with a private stack
// in local memory, so no ray waits on a packet-wide union of nodes (the
// TPU's packet traversal had no per-lane control flow; this card has).  The
// query keeps no entry distances (its interval never shrinks), tests no
// facing and no shade record, and returns at the first accepted candidate.
// Table reads go through the read-only cache (__ldg).  This is the port's
// first walk; alpha8.cu's (16-byte loads, postponed leaves) is the next
// step for it.
//
// Arithmetic follows the reference kernel (pallas_traverse.py:303-305 slab
// reciprocal, :369-383 slab test, :468-490 Moller-Trumbore).  nvcc
// contracts a*b+c into FMA, so results may differ from the CPU version in
// the last bit.
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
  const float* o;
  const float* d;
  const float* t_min;
  const float* t_max;
  unsigned char* out_hit;
  int* out_cnt;
  unsigned char* seen_snode;
  unsigned char* seen_rec;
  int n;
  int leaf_cap;
};

template <bool DENSE, bool COUNT>
__global__ void __launch_bounds__(128) trace8_kernel(const TraceArgs a) {
  constexpr int kPerRow = DENSE ? DENSE_PER_ROW : TRI_PER_ROW;
  constexpr int kStride = DENSE ? DENSE_STRIDE : TRI_STRIDE;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;

  const float* snodes = a.snodes;
  const float* tris = a.tris;

  const float ox = a.o[3 * i + 0], oy = a.o[3 * i + 1], oz = a.o[3 * i + 2];
  const float dx = a.d[3 * i + 0], dy = a.d[3 * i + 1], dz = a.d[3 * i + 2];
  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy),
              inv_dz = safe_inv(dz);
  const float tmn = a.t_min[i];

  float best_t = a.t_max[i];
  bool occluded = false;
  int n_snode = 0, n_rows = 0, n_leaf = 0, n_tests = 0;

  // Stack entry: >= 0 is a supernode row; < 0 is a leaf child, encoded as
  // -(1 + row * 8 + child) so its meta is re-read from the row at pop time.
  int stack_e[MAX_STACK];
  int sp = 0;
  // A dead ray (inverted interval, RAY_DEAD_T) traces nothing.
  if (best_t >= tmn) {
    stack_e[0] = 0;
    sp = 1;
  }

  while (sp > 0) {
    --sp;
    const int entry = stack_e[sp];

    if (entry >= 0) {
      if constexpr (COUNT) {
        ++n_snode;
        a.seen_snode[entry] = 1;
      }
      const float* row = snodes + (size_t)entry * LANES;
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
          // Any occluder ends the walk, so the order is free.
          stack_e[sp++] = value;
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
        const bool facing = det_ok;
        const float inv_det = 1.0f / (det_ok ? det : 1.0f);
        const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
        const float u = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        if (facing && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmn &&
            t <= best_t) {
          occluded = true;
          break;
        }
      }
      if constexpr (COUNT) {
        ++n_leaf;
        n_rows += (tested + kPerRow - 1) / kPerRow;
        n_tests += tested;
      }
      if (occluded) break;
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
  a.out_hit[i] = occluded ? 1 : 0;
}

template <bool DENSE>
int launch(const TraceArgs& a, bool count, void* stream) {
  const int threads = 128;
  const int blocks = (a.n + threads - 1) / threads;
  if (count) {
    trace8_kernel<DENSE, true>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  } else {
    trace8_kernel<DENSE, false>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

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
    return launch<true>(a, count, stream);
  }
  a.leaf_cap = leaf_cap(max_leaf, TRI_PER_ROW);
  return launch<false>(a, count, stream);
}

}  // extern "C"
