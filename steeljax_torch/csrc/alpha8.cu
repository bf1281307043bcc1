// Alpha-masked BVH8 ray traversal for Hopper (sm_90a): K4 and K5.
//
// One templated walk with three candidate policies replaces two TPU kernels
// of steeljax/accel/pallas_traverse.py:
//   K4  _traverse_kernel8 with alpha_mask=True (:457-499) and fine=True
//       (:500-505, _fine_test :227-246): NEAREST, the nearest hit (shade
//       mode 0, culling on or off), and ANY, occlusion;
//   K5  _multihit_kernel (:812-1038, host wrapper _trace_multihit :1044,
//       pallas_call :1096, entry trace_multihit_packet8 :1117-1138):
//       K_NEAREST<K>, the K nearest surviving hits, K = 2, 4, 8, sorted by
//       t, with the opaque bound of the fine rows.
// Each policy has ALPHA (coarse AUX masks), FINE (the fine PASS plane, and
// for K_NEAREST the OPAQUE plane) and COUNT (telemetry) instances.  K7's
// coarse-alpha treelet instance stays in traverse8.cu.
//
// Tables: snodes (S, 128) f32 and the fine (R, 128) int32 rows as in
// traverse8.cu, and the Hopper record table that cuda_traverse.
// hopper_records derives on the device from the reference's (R, 128)
// triangle rows: record k is three float4s at k * 3, [v0.xyz, f9],
// [e1.xyz, 0], [e2.xyz, 0], where f9 is the reference record's last float
// (the AUX word ds | mask << 1 of the masked tables, else the double-sided
// flag).  Record ids, leaf starts and counts are the reference's.
//
// Contract, as in the kernels this replaced: Moller-Trumbore with |det| >
// 1e-12 and the culling rule; a dead ray (t_max < t_min) leaves before the
// root; NEAREST keeps t <= best t (the walk order may settle an exact-t tie
// otherwise than the reference); ANY returns at the first accepted
// candidate; K_NEAREST keeps t < slot K-1, bounds the walk by min(slot K-1,
// ob) with ob the nearest OPAQUE-plane hit, and drops slots with t > ob at
// the end, so its output does not depend on the walk's order.
//
// What bounds it on this card.  A masked candidate never shortens the
// interval, so a primary ray of path F tests about 450 triangles in 27
// leaves (K5 at K = 4: 641 in 38): the work is the walk itself, and the
// least time for it is set by its operations (8 slab tests a supernode pop,
// a 53-op triangle test, 16-op mask tests), about 0.41 ms for path F's
// 921,600 primaries.  What the card spends instead goes to feeding the
// walk: neighbouring lanes of a warp sit in different leaves, so every
// table load of a warp touches up to 32 cache lines, one L1 wavefront each,
// and lanes that pop an inner node wait while others of their warp test a
// 24-record leaf.
//
// What the design does about it; each step was timed on the H100 against
// the one before (PERF.md, section 6), and only those that paid are here:
//   D1  16-byte loads (kept): a child box is two float4s ([min.xyz,
//       max.x], [max.yz, meta0, meta1]) and a record three, from the
//       48-byte Hopper table: 3 load instructions a triangle test where the
//       reference's 40-byte records, 8-byte aligned at a 40-byte stride,
//       took 10 (or 5 float2s, which measured slower than the new table).
//   D3  postponed leaves (kept; Aila and Laine 2009, "while-while"): a lane
//       that pops a leaf keeps it and walks inner nodes on (speculatively,
//       until it pops a second leaf, which goes back on the stack) while
//       some lane of its warp still looks for one; then the warp tests its
//       leaves together.  The walks' work counts are unchanged.
//   D2  the stack in shared memory (dropped): 7 * depth + 1 entries of 8
//       bytes per thread, 51,200 bytes a 128-thread block at path F's depth
//       7, allow 4 blocks an SM where the registers allow 10, and the walk
//       needs the warps to hide its load latency: 1.8x slower.  The stack is
//       a per-thread array in local memory; a pop touches its top only.
//   D4  persistent warps (dropped): resident warps taking 32 rays at a time
//       from a global counter were 6% slower over a frame's K4 calls; the
//       alpha re-trace already compacts the rays it re-traces to the front,
//       so a late pass's blocks of dead rays end at once anyway.
// The walk has no matrix product, so wgmma has nothing to do; TMA copies
// tiles of known address, and a ray's next row depends on its last test.
//
// Optional telemetry (COUNT instances), as traverse8.cu's: per ray
// [supernode pops, triangle-row bodies, leaf pops, triangle tests, coarse
// mask tests, fine mask tests], and the seen flags of the supernode rows,
// triangle records and fine words read.  The render path never launches a
// COUNT instance.

#include "trace8_common.cuh"

using namespace steeljax;

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { NEAREST = 0, ANY = 1, K_NEAREST = 2 };

struct AlphaArgs {
  const float* snodes;
  const float4* records;  // the Hopper record table
  const int* fine;
  const float* o;
  const float* d;
  const float* t_min;
  const float* t_max;
  float* out_t;  // (n,), or (K, n) for K_NEAREST
  float* out_u;
  float* out_v;
  int* out_tri;
  unsigned char* out_hit;
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

// Record `rec` as (v0, f9), (e1, 0), (e2, 0): three 16-byte loads.
__device__ __forceinline__ void load_record(const float4* records, int rec,
                                            float4& p, float4& e1,
                                            float4& e2) {
  const float4* r = records + 3 * (size_t)rec;
  p = __ldg(r);
  e1 = __ldg(r + 1);
  e2 = __ldg(r + 2);
}

template <int MODE, int K, bool ALPHA, bool FINE, bool COUNT>
__global__ void __launch_bounds__(kThreads) alpha8_kernel(const AlphaArgs a) {
  // The nearest policies keep each entry's distance for the pop-time cull.
  constexpr bool NEAR = MODE != ANY;

  // Every lane of a warp stays to the end (the postponed-leaf loop votes
  // across the warp); a lane past the last ray walks nothing.
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < a.n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
  float tmn = 0.0f, tmx = -1.0f;
  if (valid) {
    ox = a.o[3 * i + 0];
    oy = a.o[3 * i + 1];
    oz = a.o[3 * i + 2];
    dx = a.d[3 * i + 0];
    dy = a.d[3 * i + 1];
    dz = a.d[3 * i + 2];
    tmn = a.t_min[i];
    tmx = a.t_max[i];
  }
  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy),
              inv_dz = safe_inv(dz);

  // NEAREST: the best hit so far (ANY accepts against t_max throughout).
  float best_t = tmx, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  bool occluded = false;
  // K_NEAREST: slots sorted ascending by t; an empty slot holds t_max and
  // tri -1, so a candidate enters only with t < slot K-1's t.
  float st[K], su[K], sv[K];
  int si[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    st[k] = tmx;
    su[k] = 0.0f;
    sv[k] = 0.0f;
    si[k] = -1;
  }
  float ob = tmx;  // opaque bound (K_NEAREST with FINE)
  int n_snode = 0, n_rows = 0, n_leaf = 0, n_tests = 0, n_mask = 0,
      n_fine = 0;

  auto bound = [&]() -> float {
    if constexpr (MODE == K_NEAREST) {
      return FINE ? fminf(st[K - 1], ob) : st[K - 1];
    } else {
      return best_t;
    }
  };

  // Stack entry: >= 0 a supernode row; < 0 a leaf child, -(1 + row * 8 +
  // child), whose meta is re-read from the row when it is tested.  A pop
  // removes one entry and pushes at most 8, so a tree of depth D needs 7 * D
  // + 1 entries; the host requires 8 * D + 16 <= MAX_STACK.
  int se[MAX_STACK];
  float sn[NEAR ? MAX_STACK : 1];
  int sp = 0;
  if (valid && tmx >= tmn) {
    se[0] = 0;
    if constexpr (NEAR) sn[0] = -3.0e38f;
    sp = 1;
  }

  // Pop a supernode row: slab-test its 8 children and push the hit ones,
  // for the nearest policies sorted so the nearest is popped first.
  auto expand = [&](int entry) {
    if constexpr (COUNT) {
      ++n_snode;
      a.seen_snode[entry] = 1;
    }
    const float4* row =
        reinterpret_cast<const float4*>(a.snodes + (size_t)entry * LANES);
    const float bnd = bound();
    const int first = sp;
#pragma unroll
    for (int c = 0; c < SNODE_WIDTH; ++c) {
      // [min.xyz, max.x], [max.yz, meta0, meta1].
      const float4 p = __ldg(row + 4 * c), q = __ldg(row + 4 * c + 1);
      const float t0x = (p.x - ox) * inv_dx, t1x = (p.w - ox) * inv_dx;
      const float t0y = (p.y - oy) * inv_dy, t1y = (q.x - oy) * inv_dy;
      const float t0z = (p.z - oz) * inv_dz, t1z = (q.y - oz) * inv_dz;
      const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                fminf(t0z, t1z));
      const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                               fmaxf(t0z, t1z));
      const int meta0 = (int)q.z, meta1 = (int)q.w;
      if (meta0 >= 0 && tnear <= tfar && tfar >= tmn && tnear <= bnd) {
        const int value = meta1 > 0 ? -(1 + entry * SNODE_WIDTH + c) : meta0;
        if constexpr (!NEAR) {
          // Any occluder ends the walk, so the order is free.
          se[sp] = value;
        } else {
          // Insertion keeps stack[first..sp) sorted by entry distance,
          // largest at the bottom.
          int j = sp;
          while (j > first && sn[j - 1] < tnear) {
            se[j] = se[j - 1];
            sn[j] = sn[j - 1];
            --j;
          }
          se[j] = value;
          sn[j] = tnear;
        }
        ++sp;
      }
    }
  };

  // Test the records of leaf child `code` (row * 8 + child).
  auto test_leaf = [&](int code) {
    const float2 meta = __ldg(reinterpret_cast<const float2*>(
        a.snodes + (size_t)(code / SNODE_WIDTH) * LANES +
        CHILD_STRIDE * (code % SNODE_WIDTH) + 6));
    const int start = (int)meta.x;
    const int count = min((int)meta.y, a.leaf_cap);
    int tested = 0;
    for (int l = 0; l < count; ++l) {
      const int rec = start + l;
      float4 p, e1, e2;
      load_record(a.records, rec, p, e1, e2);
      if constexpr (COUNT) {
        ++tested;
        a.seen_rec[rec] = 1;
      }
      // AUX word: bit 0 double-sided, bits 1.. the coarse mask.
      const int aux = ALPHA ? (int)p.w : 0;
      const float px = dy * e2.z - dz * e2.y;
      const float py = dz * e2.x - dx * e2.z;
      const float pz = dx * e2.y - dy * e2.x;
      const float det = e1.x * px + e1.y * py + e1.z * pz;
      const bool det_ok = fabsf(det) > kDetEps;
      bool facing = det_ok;
      if constexpr (MODE != ANY) {
        const bool double_sided = ALPHA ? (aux & 1) != 0 : p.w > 0.5f;
        if (a.cull) facing = det > kDetEps || (double_sided && det_ok);
      }
      const float inv_det = 1.0f / (det_ok ? det : 1.0f);
      const float tx = ox - p.x, ty = oy - p.y, tz = oz - p.z;
      const float u = (tx * px + ty * py + tz * pz) * inv_det;
      const float qx = ty * e1.z - tz * e1.y;
      const float qy = tz * e1.x - tx * e1.z;
      const float qz = tx * e1.y - ty * e1.x;
      const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
      const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
      const int* fine_w = FINE ? a.fine + (size_t)(rec / TRI_PER_ROW) * LANES +
                                     FINE_STRIDE * (rec % TRI_PER_ROW)
                               : nullptr;
      if constexpr (MODE != K_NEAREST) {
        // t <= best_t: a later candidate wins an exact tie.
        bool accept = facing && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                      t >= tmn && t <= best_t;
        // Each mask test runs only for a candidate still accepted; the
        // COUNT instances count those candidates.
        if constexpr (ALPHA) {
          if constexpr (COUNT) n_mask += accept ? 1 : 0;
          accept = accept && coarse_keep(aux >> 1, u, v);
        }
        if constexpr (FINE) {
          if constexpr (COUNT) {
            if (accept) {
              ++n_fine;
              a.seen_fine[rec] = 1;
            }
          }
          accept = accept && fine_keep<false>(fine_w, u, v, nullptr);
        }
        if (accept) {
          if constexpr (MODE == ANY) {
            occluded = true;
            break;
          } else {
            best_t = t;
            best_u = u;
            best_v = v;
            best_i = rec;
          }
        }
      } else {
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
          if (!fine_keep<true>(fine_w, u, v, &opaque)) continue;
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
    }
    if constexpr (COUNT) {
      ++n_leaf;
      n_rows += (tested + TRI_PER_ROW - 1) / TRI_PER_ROW;
      n_tests += tested;
    }
  };

  // The walk with postponed leaves (D3).
  int leaf = -1;  // the postponed leaf's code
  while (__any_sync(kFull, sp > 0 || leaf >= 0)) {
    // Inner nodes, while some lane of the warp still looks for a leaf; a
    // lane that holds one walks on until it pops a second, which goes back
    // on the stack.
    bool stalled = false;
    while (__any_sync(kFull, leaf < 0 && sp > 0)) {
      if (sp > 0 && !stalled) {
        --sp;
        const int entry = se[sp];
        // Pop-time cull: the push-time test near <= bound, re-evaluated
        // against the bound found since.
        if (!(NEAR && sn[sp] > bound())) {
          if (entry >= 0) {
            expand(entry);
          } else if (leaf < 0) {
            leaf = -entry - 1;
          } else {
            ++sp;
            stalled = true;
          }
        }
      }
    }
    // The warp's leaves, together.
    if (leaf >= 0) {
      test_leaf(leaf);
      leaf = -1;
      if (MODE == ANY && occluded) sp = 0;
    }
  }

  if (!valid) return;
  if constexpr (COUNT) {
    a.out_cnt[N_COUNTERS * i + 0] = n_snode;
    a.out_cnt[N_COUNTERS * i + 1] = n_rows;
    a.out_cnt[N_COUNTERS * i + 2] = n_leaf;
    a.out_cnt[N_COUNTERS * i + 3] = n_tests;
    a.out_cnt[N_COUNTERS * i + 4] = n_mask;
    a.out_cnt[N_COUNTERS * i + 5] = n_fine;
  }
  if constexpr (MODE == ANY) {
    a.out_hit[i] = occluded ? 1 : 0;
  } else if constexpr (MODE == NEAREST) {
    a.out_t[i] = best_i >= 0 ? best_t : -1.0f;
    a.out_u[i] = best_u;
    a.out_v[i] = best_v;
    a.out_tri[i] = best_i;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // Slots behind the nearest opaque hit are occluded: dropping them
      // makes the output independent of the walk's order.
      const bool found = si[k] >= 0 && (!FINE || st[k] <= ob);
      const size_t at = (size_t)k * a.n + i;
      a.out_t[at] = found ? st[k] : -1.0f;
      a.out_u[at] = found ? su[k] : 0.0f;
      a.out_v[at] = found ? sv[k] : 0.0f;
      a.out_tri[at] = found ? si[k] : -1;
    }
  }
}

template <int MODE, int K, bool ALPHA, bool FINE>
int launch(const AlphaArgs& a, bool count, void* stream) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  if (count) {
    alpha8_kernel<MODE, K, ALPHA, FINE, true>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  } else {
    alpha8_kernel<MODE, K, ALPHA, FINE, false>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <int K>
int launch_k(const AlphaArgs& a, bool alpha, bool count, void* stream) {
  if (a.fine != nullptr) {
    return launch<K_NEAREST, K, true, true>(a, count, stream);
  }
  if (alpha) return launch<K_NEAREST, K, true, false>(a, count, stream);
  return launch<K_NEAREST, K, false, false>(a, count, stream);
}

}  // namespace

extern "C" {

// K4 and K5 over a BVH8 for n rays.  mode 0: the nearest hit (out_t, out_u,
// out_v, out_tri (n,); culling by `cull`); mode 1: occlusion (out_hit (n,),
// one byte 0 or 1; no culling); mode 2: the k nearest hits, k in {2, 4,
// 8}, (k, n) slot-major, an empty slot t -1, u = v = 0, tri -1.  Modes 0 and
// 1 need alpha != 0 (the AUX words' coarse masks); fine, when not null, adds
// the fine rows' PASS plane (mode 2: and the opaque bound).  records is the
// Hopper record table (cuda_traverse.hopper_records).  out_cnt (n x
// N_COUNTERS int32), seen_snode, seen_rec and seen_fine: all four or none;
// the seen bytes are set, never cleared.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int steeljax_trace_alpha8(const void* snodes, const void* records,
                          const void* fine, const void* o, const void* d,
                          const void* t_min, const void* t_max, void* out_t,
                          void* out_u, void* out_v, void* out_tri,
                          void* out_hit, void* out_cnt, void* seen_snode,
                          void* seen_rec, void* seen_fine, int n,
                          int max_leaf, int depth, int cull, int mode, int k,
                          int alpha, void* stream) {
  if (n < 0 || max_leaf <= 0 || depth <= 0 || 8 * depth + 16 > MAX_STACK ||
      mode < 0 || mode > 2 || records == nullptr ||
      (fine != nullptr && !alpha) || (mode != K_NEAREST && !alpha) ||
      (mode == K_NEAREST && k != 2 && k != 4 && k != 8) ||
      (mode == ANY ? out_hit == nullptr
                   : (out_t == nullptr || out_u == nullptr ||
                      out_v == nullptr || out_tri == nullptr)) ||
      (out_cnt != nullptr && (seen_snode == nullptr || seen_rec == nullptr ||
                              seen_fine == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  AlphaArgs a = {};
  a.snodes = (const float*)snodes;
  a.records = (const float4*)records;
  a.fine = (const int*)fine;
  a.o = (const float*)o;
  a.d = (const float*)d;
  a.t_min = (const float*)t_min;
  a.t_max = (const float*)t_max;
  a.out_t = (float*)out_t;
  a.out_u = (float*)out_u;
  a.out_v = (float*)out_v;
  a.out_tri = (int*)out_tri;
  a.out_hit = (unsigned char*)out_hit;
  a.out_cnt = (int*)out_cnt;
  a.seen_snode = (unsigned char*)seen_snode;
  a.seen_rec = (unsigned char*)seen_rec;
  a.seen_fine = (unsigned char*)seen_fine;
  a.n = n;
  a.leaf_cap = leaf_cap(max_leaf, TRI_PER_ROW);
  a.cull = cull;
  const bool count = out_cnt != nullptr;
  const bool fine_rows = a.fine != nullptr;
  if (mode == NEAREST) {
    return fine_rows ? launch<NEAREST, 1, true, true>(a, count, stream)
                     : launch<NEAREST, 1, true, false>(a, count, stream);
  }
  if (mode == ANY) {
    return fine_rows ? launch<ANY, 1, true, true>(a, count, stream)
                     : launch<ANY, 1, true, false>(a, count, stream);
  }
  if (k == 2) return launch_k<2>(a, alpha != 0, count, stream);
  if (k == 4) return launch_k<4>(a, alpha != 0, count, stream);
  return launch_k<8>(a, alpha != 0, count, stream);
}

}  // extern "C"
