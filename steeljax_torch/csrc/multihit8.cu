// K-nearest multi-hit BVH8 traversal for Hopper (sm_90a), one thread per
// ray: K5, the port of steeljax/accel/pallas_traverse.py:_multihit_kernel
// (:812-1038, host wrapper _trace_multihit :1044, pallas_call :1096, entry
// trace_multihit_packet8 :1117).
//
// Per ray it returns the K nearest candidate hits with t in [t_min, t_max),
// sorted by t, after the alpha-coverage masks (the coarse AUX mask; with
// fine rows the fine PASS plane) have dropped provably transparent ones.
// With fine rows each ray also keeps an opaque bound ob, the nearest hit
// whose fine OPAQUE bit proves the integrator's exact alpha test keeps it:
// the walk prunes against min(slot K-1, ob) and only slots with t <= ob are
// returned, so the output is the K nearest PASS hits at or before the
// nearest provably opaque one, whatever order the walk finds them in.  The
// tables are traverse8.cu's (trace8_common.cuh).
//
// What bounds it on this card: as K1, the latency of the dependent table
// reads of each ray's walk and warp divergence; the K-th slot is a weaker
// prune bound than K1's nearest hit, so a ray tests more triangles.
//
// What the design does about it: one thread per ray with K1's ordered
// stack (children pushed far-to-near, culled at pop time against the
// current bound).  The K slots live in registers: K is a compile-time
// constant (instances K = 2, 4, 8) and the sorted insertion is an unrolled
// carry-and-swap pass over the slots, with no indexed local array.
//
// Optional telemetry (COUNT instances), as in traverse8.cu: per ray
// [supernode pops, triangle-row bodies, leaf pops, triangle tests, coarse
// mask tests, fine mask tests] and the seen flags of the supernode rows,
// triangle records and fine words read.

#include "trace8_common.cuh"

using namespace steeljax;

namespace {

struct MultiArgs {
  const float* snodes;
  const float* tris;
  const int* fine;
  const float* o;
  const float* d;
  const float* t_min;
  const float* t_max;
  float* out_t;  // (K, n)
  float* out_u;
  float* out_v;
  int* out_tri;
  int* out_cnt;
  unsigned char* seen_snode;
  unsigned char* seen_rec;
  unsigned char* seen_fine;
  int n;
  int leaf_cap;
  int cull;
};

template <typename T>
__device__ __forceinline__ void swap_if(bool c, T& a, T& b) {
  const T x = c ? b : a;
  b = c ? a : b;
  a = x;
}

template <int K, bool ALPHA, bool FINE, bool COUNT>
__global__ void __launch_bounds__(128) multihit8_kernel(const MultiArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;

  const float ox = a.o[3 * i + 0], oy = a.o[3 * i + 1], oz = a.o[3 * i + 2];
  const float dx = a.d[3 * i + 0], dy = a.d[3 * i + 1], dz = a.d[3 * i + 2];
  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy),
              inv_dz = safe_inv(dz);
  const float tmn = a.t_min[i];
  const float tmx = a.t_max[i];

  // Slots sorted ascending by t; an empty slot holds t_max and tri -1, so
  // a candidate enters only with t < slot K-1's t.
  float st[K], su[K], sv[K];
  int si[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    st[k] = tmx;
    su[k] = 0.0f;
    sv[k] = 0.0f;
    si[k] = -1;
  }
  float ob = tmx;  // opaque bound (FINE)
  int n_snode = 0, n_rows = 0, n_leaf = 0, n_tests = 0, n_mask = 0,
      n_fine = 0;

  int stack_e[MAX_STACK];
  float stack_near[MAX_STACK];
  int sp = 0;
  if (tmx >= tmn) {
    stack_e[0] = 0;
    stack_near[0] = -3.0e38f;
    sp = 1;
  }

  while (sp > 0) {
    --sp;
    const int entry = stack_e[sp];
    const float bound = FINE ? fminf(st[K - 1], ob) : st[K - 1];
    if (stack_near[sp] > bound) continue;

    if (entry >= 0) {
      if constexpr (COUNT) {
        ++n_snode;
        a.seen_snode[entry] = 1;
      }
      const float* row = a.snodes + (size_t)entry * LANES;
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
        if (meta0 >= 0 && tnear <= tfar && tfar >= tmn && tnear <= bound) {
          const int value =
              meta1 > 0 ? -(1 + entry * SNODE_WIDTH + c) : meta0;
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
    } else {
      const int code = -entry - 1;
      const float* ch = a.snodes + (size_t)(code / SNODE_WIDTH) * LANES +
                        CHILD_STRIDE * (code % SNODE_WIDTH);
      const int start = (int)__ldg(ch + 6);
      const int count = min((int)__ldg(ch + 7), a.leaf_cap);
      int tested = 0;
      for (int l = 0; l < count; ++l) {
        const int rec = start + l;
        const float* r = a.tris + (size_t)(rec / TRI_PER_ROW) * LANES +
                         TRI_STRIDE * (rec % TRI_PER_ROW);
        const float v0x = __ldg(r + 0), v0y = __ldg(r + 1), v0z = __ldg(r + 2);
        const float e1x = __ldg(r + 3), e1y = __ldg(r + 4), e1z = __ldg(r + 5);
        const float e2x = __ldg(r + 6), e2y = __ldg(r + 7), e2z = __ldg(r + 8);
        const float flag = __ldg(r + 9);
        const int aux = ALPHA ? (int)flag : 0;
        if constexpr (COUNT) {
          ++tested;
          a.seen_rec[rec] = 1;
        }

        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool det_ok = fabsf(det) > kDetEps;
        const bool double_sided = ALPHA ? (aux & 1) != 0 : flag > 0.5f;
        const bool facing =
            a.cull ? det > kDetEps || (double_sided && det_ok) : det_ok;
        const float inv_det = 1.0f / (det_ok ? det : 1.0f);
        const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
        const float u = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        if (!(facing && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
              t >= tmn)) {
          continue;
        }
        if constexpr (ALPHA) {
          if constexpr (COUNT) ++n_mask;
          if (!coarse_keep(aux >> 1, u, v)) continue;
        }
        if constexpr (FINE) {
          if constexpr (COUNT) {
            ++n_fine;
            a.seen_fine[rec] = 1;
          }
          bool opaque;
          if (!fine_keep<true>(a.fine + (size_t)(rec / TRI_PER_ROW) * LANES +
                                   FINE_STRIDE * (rec % TRI_PER_ROW),
                               u, v, &opaque)) {
            continue;
          }
          // Every opaque-plane hit bounds the walk, slot member or not: it
          // occludes everything behind it.
          if (opaque && t < ob) ob = t;
        }
        if (!(t < st[K - 1])) continue;
        // Sorted insertion: the candidate is carried down the slots; at the
        // first slot it precedes, it and every later slot shift by one.
        float ct = t, cu = u, cv = v;
        int ci = rec;
        bool shift = false;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          shift = shift || ct < st[k];
          swap_if(shift, ct, st[k]);
          swap_if(shift, cu, su[k]);
          swap_if(shift, cv, sv[k]);
          swap_if(shift, ci, si[k]);
        }
      }
      if constexpr (COUNT) {
        ++n_leaf;
        n_rows += (tested + TRI_PER_ROW - 1) / TRI_PER_ROW;
        n_tests += tested;
      }
    }
  }

  if constexpr (COUNT) {
    a.out_cnt[N_COUNTERS * i + 0] = n_snode;
    a.out_cnt[N_COUNTERS * i + 1] = n_rows;
    a.out_cnt[N_COUNTERS * i + 2] = n_leaf;
    a.out_cnt[N_COUNTERS * i + 3] = n_tests;
    a.out_cnt[N_COUNTERS * i + 4] = n_mask;
    a.out_cnt[N_COUNTERS * i + 5] = n_fine;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    // Slots behind the nearest opaque hit are occluded: dropping them makes
    // the output independent of the walk's order.
    const bool found = si[k] >= 0 && (!FINE || st[k] <= ob);
    const size_t at = (size_t)k * a.n + i;
    a.out_t[at] = found ? st[k] : -1.0f;
    a.out_u[at] = found ? su[k] : 0.0f;
    a.out_v[at] = found ? sv[k] : 0.0f;
    a.out_tri[at] = found ? si[k] : -1;
  }
}

template <int K, bool ALPHA, bool FINE>
int launch(const MultiArgs& a, bool count, void* stream) {
  const int threads = 128;
  const int blocks = (a.n + threads - 1) / threads;
  if (count) {
    multihit8_kernel<K, ALPHA, FINE, true>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  } else {
    multihit8_kernel<K, ALPHA, FINE, false>
        <<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int K>
int launch_k(const MultiArgs& a, bool alpha, bool count, void* stream) {
  if (a.fine != nullptr) return launch<K, true, true>(a, count, stream);
  if (alpha) return launch<K, true, false>(a, count, stream);
  return launch<K, false, false>(a, count, stream);
}

}  // namespace

extern "C" {

// The k nearest hits of n rays over a BVH8 (K5), k in {2, 4, 8}: out_t,
// out_u, out_v and out_tri are (k, n), slot-major; an empty slot has t -1,
// u = v = 0 and tri -1.  alpha != 0 applies the AUX words' coarse masks;
// fine, when not null (it needs alpha), the int32 fine rows' PASS plane and
// opaque bound.  out_cnt (n x N_COUNTERS int32 counters), seen_snode,
// seen_rec and seen_fine as in traverse8.cu, all four or none.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int steeljax_trace_multihit8(const void* snodes, const void* tris,
                             const void* fine, const void* o, const void* d,
                             const void* t_min, const void* t_max,
                             void* out_t, void* out_u, void* out_v,
                             void* out_tri, void* out_cnt, void* seen_snode,
                             void* seen_rec, void* seen_fine, int n,
                             int max_leaf, int depth, int k, int cull,
                             int alpha, void* stream) {
  if (n < 0 || max_leaf <= 0 || depth <= 0 || 8 * depth + 16 > MAX_STACK ||
      out_t == nullptr || out_u == nullptr || out_v == nullptr ||
      out_tri == nullptr || (fine != nullptr && !alpha) ||
      (out_cnt != nullptr && (seen_snode == nullptr || seen_rec == nullptr ||
                              seen_fine == nullptr)) ||
      (k != 2 && k != 4 && k != 8)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  MultiArgs a = {};
  a.snodes = (const float*)snodes;
  a.tris = (const float*)tris;
  a.fine = (const int*)fine;
  a.o = (const float*)o;
  a.d = (const float*)d;
  a.t_min = (const float*)t_min;
  a.t_max = (const float*)t_max;
  a.out_t = (float*)out_t;
  a.out_u = (float*)out_u;
  a.out_v = (float*)out_v;
  a.out_tri = (int*)out_tri;
  a.out_cnt = (int*)out_cnt;
  a.seen_snode = (unsigned char*)seen_snode;
  a.seen_rec = (unsigned char*)seen_rec;
  a.seen_fine = (unsigned char*)seen_fine;
  a.n = n;
  a.leaf_cap = leaf_cap(max_leaf, TRI_PER_ROW);
  a.cull = cull;
  const bool count = out_cnt != nullptr;
  const bool use_alpha = alpha != 0;
  if (k == 2) return launch_k<2>(a, use_alpha, count, stream);
  if (k == 4) return launch_k<4>(a, use_alpha, count, stream);
  return launch_k<8>(a, use_alpha, count, stream);
}

}  // extern "C"
