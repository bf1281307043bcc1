// The flat BVH8 nearest-hit, any-hit, alpha-masked and multi-hit ray
// traversal for Hopper (sm_90a): K1-K5.
//
// One templated walk with three candidate policies replaces these TPU
// kernels of steeljax/accel/pallas_traverse.py:
//   K1  _traverse_kernel8 (:249, host wrapper _trace_packed8, pallas_call
//       :719, entry trace_nearest_packet8 :752): NEAREST without masks, the
//       nearest hit, culling on or off, with fused shading in shade mode 1
//       (normal and material) or none (mode 0);
//   K2  the same body with any_hit=True (:506-517, :574-594): ANY without
//       masks, occlusion with no culling, over the 12-record rows' records
//       or (K2-dense, trace_anyhit_dense :781-794) the dense 14-record
//       rows' records and their own supernode rows;
//   K3  the same body with shade_mode=2 (:548-565, :608-617): NEAREST
//       without masks with the textured record (tangent, uv, uv density);
//   K4  _traverse_kernel8 with alpha_mask=True (:457-499) and fine=True
//       (:500-505, _fine_test :227-246): NEAREST, the nearest hit (shade
//       mode 0, culling on or off), and ANY, occlusion;
//   K5  _multihit_kernel (:812-1038, host wrapper _trace_multihit :1044,
//       pallas_call :1096, entry trace_multihit_packet8 :1117-1138):
//       K_NEAREST<K>, the K nearest surviving hits, K = 2, 4, 8, sorted by
//       t, with the opaque bound of the fine rows.
// Each policy has ALPHA (coarse AUX masks), FINE (the fine PASS plane, and
// for K_NEAREST the OPAQUE plane) and COUNT (telemetry) instances, and
// NEAREST without masks SHADE 0, 1 and 2.  K2 and K2-dense are one
// instance: the rows' width (per_row, 12 or 14) is an argument.  K6 is
// instanced8.cu, K7 treelet8.cu.
//
// Tables (trace8_common.cuh): snodes (S, 128) f32, the fine (R, 128) int32
// rows and the shade rows of modes 1 and 2 (read once per ray, by the
// winner), and the Hopper record table that cuda_traverse.hopper_records
// derives on the device from the reference's (R, 128) triangle rows for
// every flat chunk (and from the dense rows for a chunk that has them):
// record k is three float4s at k * 3, [v0.xyz, f9], [e1.xyz, 0], [e2.xyz,
// 0], where f9 is the reference record's last float (the AUX word ds | mask
// << 1 of the masked tables, else the double-sided flag; 0 in the dense
// table, and ANY without masks never reads it).  Record ids, leaf starts
// and counts are the rows'.
//
// Contract, as in the kernels this replaced: Moller-Trumbore with |det| >
// 1e-12 and the culling rule; a dead ray (t_max < t_min) leaves before the
// root (K2 writes its flag 0); NEAREST keeps t <= best t (the walk order
// may settle an exact-t tie otherwise than the reference); ANY returns at
// the first accepted candidate, with t in [t_min, t_max]; K_NEAREST keeps t < slot K-1, bounds the walk by min(slot K-1,
// ob) with ob the nearest OPAQUE-plane hit, and drops slots with t > ob at
// the end, so its output does not depend on the walk's order.
//
// What bounds it on this card.  K1 and K3: the walks are short (a primary
// pops 1-5 supernode rows and tests 14-16 triangles on the Cornell box and
// paths L and T, a first-bounce ray up to 5 and 23), and the least time is
// 0.018-0.040 ms a 921,600-ray trace, set by the bytes of the rays and the
// touched tables or by the walk's operations; the card spends 5-20 times
// that on the walk's dependent loads and on lanes that wait while others
// of their warp test a leaf.  K4 and K5: a masked candidate never shortens
// the interval, so a primary ray of path F tests about 450 triangles in 27
// leaves (K5 at K = 4: 641 in 38): the work is the walk itself, and the
// least time for it is set by its operations (8 slab tests a supernode pop,
// a 53-op triangle test, 16-op mask tests), about 0.41 ms for path F's
// 921,600 primaries.  What the card spends instead goes to feeding the
// walk: neighbouring lanes of a warp sit in different leaves, so every
// table load of a warp touches up to 32 cache lines, one L1 wavefront each,
// and lanes that pop an inner node wait while others of their warp test a
// 24-record leaf.  K2 and K2-dense: path L's shadow rays at the primaries'
// hits walk about 2 supernode rows and test 1.9 triangles a live ray, and
// 77% of the 921,600 rays are dead (a primary that hit the sky, a light
// behind the surface); the least time, 0.0040 ms, is the bytes of the rays
// (a dead ray's 8-byte interval) and of the few rows touched.  The walk's
// dependent loads and, in the one-thread walk, lanes of dead rays holding
// their warp while a live neighbour walks take the rest.
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
//       leaves together.  The triangle tests are unchanged; a lane walking
//       on with the bound it had pops more rows (K1, K3: 4-11% more).
//   D2  the stack in shared memory (dropped): 7 * depth + 1 entries of 8
//       bytes per thread, 51,200 bytes a 128-thread block at path F's depth
//       7, allow 4 blocks an SM where the registers allow 10, and the walk
//       needs the warps to hide its load latency: 1.8x slower.  The stack is
//       a per-thread array in local memory; a pop touches its top only.
//   D4  persistent warps (dropped): resident warps taking 32 rays at a time
//       from a global counter were 6% slower over a frame's K4 calls; the
//       alpha re-trace already compacts the rays it re-traces to the front,
//       so a late pass's blocks of dead rays end at once anyway.
//   D5  live-lane compaction (kept, K2 and K2-dense only): a block ballots
//       which of its 128 rays are live, their ids go to shared memory in
//       order, live rays take the block's first lanes and a warp of dead
//       rays writes its flags and leaves; lanes past the live rays of a
//       walking warp hold no ray and vote with an empty stack.
// K1 and K3 took D1 (1.16-1.31x over their earlier one-thread walk) and D3
// (a further 1.05-1.21x); an aligned 48- or 112-byte shade record read
// with float4s paid 0-1% once per ray and was dropped, and a walk of their
// own in place of this one measured 1-4% slower.  K2 and K2-dense took D1
// (1.07-1.10x over their earlier one-thread walk on path L's shadow rays),
// D3 (a further 1.08-1.09x; with ANY the interval never shrinks, so a lane
// walking on pops extra rows only on a ray that its held leaf occludes:
// +1% pops, equal triangle tests) and D5 (a further 1.06-1.08x on that
// 23%-live launch, 1.01-1.02x on its live rays alone): 0.0441 -> 0.0350 ms
// on the H100 (PERF.md, section 6).
// The walk has no matrix product, so wgmma has nothing to do; TMA copies
// tiles of known address, and a ray's next row depends on its last test.
//
// Optional telemetry (COUNT instances, the reference's counters=True,
// :618-628): per ray [supernode pops, triangle-row bodies, leaf pops,
// triangle tests, coarse mask tests, fine mask tests], kept in shared
// memory while the walk runs, and the seen flags of the supernode rows,
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
  const float* shade;  // the reference's shade rows (K1, K3)
  const float* o;
  const float* d;
  const float* t_min;
  const float* t_max;
  float* out_t;  // (n,), or (K, n) for K_NEAREST
  float* out_u;
  float* out_v;
  int* out_tri;
  float* out_n;  // the winner's shading (K1 mode 1, K3 mode 2)
  int* out_mat;
  float* out_tan;
  float* out_uv;
  float* out_uvd;
  unsigned char* out_hit;
  int* out_cnt;
  unsigned char* seen_snode;
  unsigned char* seen_rec;
  unsigned char* seen_fine;
  int n;
  int leaf_cap;
  int per_row;  // records a triangle row of the reference's layout
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

// The winner's fused shading (K1 shade mode 1, K3 mode 2; the reference's
// :597-617), from its record in the reference's shade rows: its normal
// interpolated at (u, v), normalized and flipped when det < 0
// (ClosestHit.rchit:67-70: det < 0 is the winding-based hit kind), and its
// material; mode 2 adds the tangent (normalized, never flipped), the uv and
// the uv density.  A miss gets the reference's initial values: n = +z, mat
// 0, tangent +x, uv 0, uv density 0.
template <int SHADE>
__device__ __forceinline__ void shade_winner(const AlphaArgs& a, int i,
                                             int best_i, float bu, float bv,
                                             float best_det) {
  float nx = 0.0f, ny = 0.0f, nz = 1.0f, mat = 0.0f;
  float tnx = 1.0f, tny = 0.0f, tnz = 0.0f, ux = 0.0f, uy = 0.0f, uvd = 0.0f;
  if (best_i >= 0) {
    const float wb = 1.0f - bu - bv;
    const float* s;
    if constexpr (SHADE == 2) {
      s = a.shade +
          (size_t)((best_i / TRI_PER_ROW) * (TRI_PER_ROW / SHADE2_PER_ROW) +
                   (best_i % TRI_PER_ROW) / SHADE2_PER_ROW) * LANES +
          SHADE2_STRIDE * (best_i % SHADE2_PER_ROW);
    } else {
      s = a.shade + (size_t)(best_i / TRI_PER_ROW) * LANES +
          SHADE1_STRIDE * (best_i % TRI_PER_ROW);
    }
    nx = __ldg(s + 0) * wb + __ldg(s + 3) * bu + __ldg(s + 6) * bv;
    ny = __ldg(s + 1) * wb + __ldg(s + 4) * bu + __ldg(s + 7) * bv;
    nz = __ldg(s + 2) * wb + __ldg(s + 5) * bu + __ldg(s + 8) * bv;
    mat = __ldg(s + 9);
    if constexpr (SHADE == 2) {
      tnx = __ldg(s + 10) * wb + __ldg(s + 13) * bu + __ldg(s + 16) * bv;
      tny = __ldg(s + 11) * wb + __ldg(s + 14) * bu + __ldg(s + 17) * bv;
      tnz = __ldg(s + 12) * wb + __ldg(s + 15) * bu + __ldg(s + 18) * bv;
      ux = __ldg(s + 19) * wb + __ldg(s + 21) * bu + __ldg(s + 23) * bv;
      uy = __ldg(s + 20) * wb + __ldg(s + 22) * bu + __ldg(s + 24) * bv;
      uvd = __ldg(s + 25);
    }
  }
  const float n2 = nx * nx + ny * ny + nz * nz;
  const float inv_n =
      (best_det < 0.0f ? -1.0f : 1.0f) * rsqrtf(fmaxf(n2, 1e-20f));
  a.out_n[3 * i + 0] = nx * inv_n;
  a.out_n[3 * i + 1] = ny * inv_n;
  a.out_n[3 * i + 2] = nz * inv_n;
  a.out_mat[i] = (int)mat;
  if constexpr (SHADE == 2) {
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

template <int MODE, int K, bool ALPHA, bool FINE, bool COUNT, int SHADE>
__global__ void __launch_bounds__(kThreads) alpha8_kernel(const AlphaArgs a) {
  // The nearest policies keep each entry's distance for the pop-time cull.
  constexpr bool NEAR = MODE != ANY;
  // K2 and K2-dense (D5) compact their block's live rays.
  constexpr bool COMPACT = MODE == ANY && !ALPHA;
  // COUNT: the per-ray counters (N_COUNTERS, as out_cnt) live in shared
  // memory, counter c of this lane at cnt[c * kThreads], so that counting
  // takes no registers from the walk.
  int* cnt = nullptr;
  if constexpr (COUNT) {
    __shared__ int cnt_lanes[N_COUNTERS * kThreads];
    cnt = cnt_lanes + threadIdx.x;
  }
  auto count_up = [&](int c, int by) {
    if constexpr (COUNT) cnt[c * kThreads] += by;
  };

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool valid = i < a.n;
  float tmn = 0.0f, tmx = -1.0f;
  if (valid) {
    tmn = a.t_min[i];
    tmx = a.t_max[i];
  }
  if constexpr (COMPACT) {
    // Live-lane compaction (D5): the block's live rays (t_max >= t_min)
    // take its first lanes, in order; a dead ray's own lane writes its
    // output, and whole warps of dead rays leave here.
    __shared__ int live_ray[kThreads];
    __shared__ float2 live_t[kThreads];
    __shared__ int warp_live[kThreads / 32];
    const bool live = valid && tmx >= tmn;
    if (valid && !live) {
      a.out_hit[i] = 0;
      if constexpr (COUNT) {
#pragma unroll
        for (int c = 0; c < N_COUNTERS; ++c) a.out_cnt[N_COUNTERS * i + c] = 0;
      }
    }
    const unsigned ballot = __ballot_sync(kFull, live);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int at = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      at += w < warp ? warp_live[w] : 0;
      total += warp_live[w];
    }
    if (live) {
      at += __popc(ballot & ((1u << lane) - 1u));
      live_ray[at] = i;
      live_t[at] = make_float2(tmn, tmx);
    }
    __syncthreads();
    if ((int)threadIdx.x >= ((total + 31) & ~31)) return;
    // Lanes past the live rays of a warp that walks hold no ray.
    valid = (int)threadIdx.x < total;
    i = valid ? live_ray[threadIdx.x] : 0;
    tmn = valid ? live_t[threadIdx.x].x : 0.0f;
    tmx = valid ? live_t[threadIdx.x].y : -1.0f;
  }
  // Every lane of a warp stays to the end (the postponed-leaf loop votes
  // across the warp); a lane without a ray walks nothing.
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
  if (valid) {
    ox = a.o[3 * i + 0];
    oy = a.o[3 * i + 1];
    oz = a.o[3 * i + 2];
    dx = a.d[3 * i + 0];
    dy = a.d[3 * i + 1];
    dz = a.d[3 * i + 2];
  }
  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy),
              inv_dz = safe_inv(dz);

  // NEAREST: the best hit so far (ANY accepts against t_max throughout).
  float best_t = tmx, best_u = 0.0f, best_v = 0.0f, best_det = 1.0f;
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
  if constexpr (COUNT) {
#pragma unroll
    for (int c = 0; c < N_COUNTERS; ++c) cnt[c * kThreads] = 0;
  }

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
      count_up(0, 1);
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
          count_up(4, accept ? 1 : 0);
          accept = accept && coarse_keep(aux >> 1, u, v);
        }
        if constexpr (FINE) {
          if constexpr (COUNT) {
            if (accept) {
              count_up(5, 1);
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
            best_det = det;
          }
        }
      } else {
        if (!(facing && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
              t >= tmn)) {
          continue;
        }
        if constexpr (ALPHA) {
          count_up(4, 1);
          if (!coarse_keep(aux >> 1, u, v)) continue;
        }
        if constexpr (FINE) {
          if constexpr (COUNT) {
            count_up(5, 1);
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
      // Only the any-hit policy reads rows of another width (K2_dense).
      const int per_row = MODE == ANY ? a.per_row : TRI_PER_ROW;
      count_up(1, (tested + per_row - 1) / per_row);
      count_up(2, 1);
      count_up(3, tested);
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
#pragma unroll
    for (int c = 0; c < N_COUNTERS; ++c) {
      a.out_cnt[N_COUNTERS * i + c] = cnt[c * kThreads];
    }
  }
  if constexpr (MODE == ANY) {
    a.out_hit[i] = occluded ? 1 : 0;
  } else if constexpr (MODE == NEAREST) {
    a.out_t[i] = best_i >= 0 ? best_t : -1.0f;
    a.out_u[i] = best_u;
    a.out_v[i] = best_v;
    a.out_tri[i] = best_i;
    if constexpr (SHADE != 0) {
      shade_winner<SHADE>(a, i, best_i, best_u, best_v, best_det);
    }
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

template <int MODE, int K, bool ALPHA, bool FINE, int SHADE = 0>
int launch(const AlphaArgs& a, bool count, void* stream) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  if (count) {
    alpha8_kernel<MODE, K, ALPHA, FINE, true, SHADE>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  } else {
    alpha8_kernel<MODE, K, ALPHA, FINE, false, SHADE>
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

// The nearest hit (K1, K3, K4), occlusion (K2, K2-dense, K4) and K5 over a
// BVH8 for n rays.  mode 0: the nearest hit (out_t, out_u, out_v, out_tri
// (n,); culling by `cull`); without masks (alpha == 0: K1, K3) shade_mode
// 1 adds out_n (n x 3) and out_mat (n,) from `shade`, the reference's rows
// (pack_shade_records), and shade_mode 2 also out_tan (n x 3), out_uv (n x
// 2) and out_uvd (n,); mode 1: occlusion (out_hit (n,), one byte 0 or 1,
// for every ray; no culling), without masks (alpha == 0: K2) or with the
// AUX words' coarse masks (K4); mode 2: the k nearest hits, k in {2, 4,
// 8}, (k, n) slot-major, an empty slot t -1, u = v = 0, tri -1.  fine,
// when not null, adds the fine rows' PASS plane (mode 2: and the opaque
// bound).  records is the Hopper record table (cuda_traverse.
// hopper_records) of rows of per_row records: TRI_PER_ROW, or
// DENSE_PER_ROW for mode 1 without masks (K2-dense: a leaf then reads at
// most leaf_cap(max_leaf, DENSE_PER_ROW) records).  out_cnt (n x
// N_COUNTERS int32), seen_snode, seen_rec and seen_fine: all four or none;
// the seen bytes are set, never cleared.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int steeljax_trace_alpha8(const void* snodes, const void* records,
                          const void* fine, const void* shade, const void* o,
                          const void* d, const void* t_min, const void* t_max,
                          void* out_t, void* out_u, void* out_v,
                          void* out_tri, void* out_n, void* out_mat,
                          void* out_tan, void* out_uv, void* out_uvd,
                          void* out_hit, void* out_cnt, void* seen_snode,
                          void* seen_rec, void* seen_fine, int n,
                          int max_leaf, int depth, int cull, int mode, int k,
                          int alpha, int shade_mode, int per_row,
                          void* stream) {
  if (n < 0 || max_leaf <= 0 || depth <= 0 || 8 * depth + 16 > MAX_STACK ||
      mode < 0 || mode > 2 || records == nullptr ||
      (fine != nullptr && !alpha) ||
      (per_row != TRI_PER_ROW &&
       (per_row != DENSE_PER_ROW || mode != ANY || alpha)) ||
      (mode == K_NEAREST && k != 2 && k != 4 && k != 8) ||
      (mode == ANY ? out_hit == nullptr
                   : (out_t == nullptr || out_u == nullptr ||
                      out_v == nullptr || out_tri == nullptr)) ||
      shade_mode < 0 || shade_mode > 2 ||
      (shade_mode != 0 && (mode != NEAREST || alpha || shade == nullptr ||
                           out_n == nullptr || out_mat == nullptr)) ||
      (shade_mode == 2 &&
       (out_tan == nullptr || out_uv == nullptr || out_uvd == nullptr)) ||
      (out_cnt != nullptr && (seen_snode == nullptr || seen_rec == nullptr ||
                              seen_fine == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  AlphaArgs a = {};
  a.snodes = (const float*)snodes;
  a.records = (const float4*)records;
  a.fine = (const int*)fine;
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
  a.out_hit = (unsigned char*)out_hit;
  a.out_cnt = (int*)out_cnt;
  a.seen_snode = (unsigned char*)seen_snode;
  a.seen_rec = (unsigned char*)seen_rec;
  a.seen_fine = (unsigned char*)seen_fine;
  a.n = n;
  a.leaf_cap = leaf_cap(max_leaf, per_row);
  a.per_row = per_row;
  a.cull = cull;
  const bool count = out_cnt != nullptr;
  const bool fine_rows = a.fine != nullptr;
  if (mode == NEAREST && !alpha) {
    if (shade_mode == 2) {
      return launch<NEAREST, 1, false, false, 2>(a, count, stream);
    }
    if (shade_mode == 1) {
      return launch<NEAREST, 1, false, false, 1>(a, count, stream);
    }
    return launch<NEAREST, 1, false, false, 0>(a, count, stream);
  }
  if (mode == NEAREST) {
    return fine_rows ? launch<NEAREST, 1, true, true>(a, count, stream)
                     : launch<NEAREST, 1, true, false>(a, count, stream);
  }
  if (mode == ANY) {
    if (!alpha) return launch<ANY, 1, false, false>(a, count, stream);
    return fine_rows ? launch<ANY, 1, true, true>(a, count, stream)
                     : launch<ANY, 1, true, false>(a, count, stream);
  }
  if (k == 2) return launch_k<2>(a, alpha != 0, count, stream);
  if (k == 4) return launch_k<4>(a, alpha != 0, count, stream);
  return launch_k<8>(a, alpha != 0, count, stream);
}

}  // extern "C"
