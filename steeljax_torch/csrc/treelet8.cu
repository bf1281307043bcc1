// Streamed-treelet BVH8 traversal for Hopper (sm_90a): K7, the rounds of
// the treelet scheduler, and the scheduler's packet pick.
//
// K7 is the counterpart of steeljax/accel/pallas_traverse.py:
// _kernel8_treelet (:1252, host wrapper _trace_packed8_treelet :1149,
// pallas_call at :1229), and the pick replaces the scheduler's _next_pid
// (steeljax/accel/treelets.py:184-197) inside its while_loop (:268-308).
// One global BVH is cut into K treelets whose node, triangle and shade
// tables are stacked (accel/treelets.py); rays go in packets of `block`
// consecutive rays, and every round walks each live packet against the one
// treelet the packet picked.
//
// Tables: node_stack (K * node_rows, 128) f32 rows as the snodes of
// trace8_common.cuh, leaf starts local to their treelet; the Hopper record table that
// cuda_traverse.hopper_records derives from tri_stack (K * tri_rows * 12
// records of three float4s [v0.xyz, f9], [e1.xyz, 0], [e2.xyz, 0], f9 the
// double-sided flag or, with alpha masks, the AUX word ds | mask << 1);
// shade_stack (K * tri_rows * {1, 3}, 128) f32 in the mode-1 and mode-2
// layouts of trace8_common.cuh, addressed by the treelet-local record id.
//
// The scheduler's state lives on the device and every round updates it in
// place (cuda_traverse.TreeletState): per ray the running record (t, u, v,
// global triangle id and the fused shading fields, or the occlusion flag),
// the running end of its interval t_far, ceil(K / 32) words of visited
// treelets and its row of the (N, K) treelet entry distances; per packet
// three arrays of 64-bit pick keys, used in turn.  Round r reads keys[r % 3]
// (the packet's treelet, or "done"), takes the atomic minimum into
// keys[(r + 1) % 3] and resets keys[(r + 2) % 3], which round r - 1 read
// and round r + 1 fills: three arrays, because the blocks of one packet read
// its key in no order, so no block of round r may reset the key it reads.
//
// A round, for every ray of a live packet:
//   1. the walk, when the treelet's entry distance is at most t_far (else
//      its root test would reject the ray: the treelet's box holds every
//      box of its tree);
//   2. the in-place merge: a hit strictly nearer than t_far, or the first
//      hit of the ray, writes t, u, v, tri_offsets[treelet] + the local id
//      and the shading fields, and becomes t_far (`better` of
//      steeljax/accel/treelets.py:296); inside a walk t <= best t holds as
//      in K1.  Any-hit sets the flag and kills the interval;
//   3. the next pick: the ray sets the packet's visited bit, takes its
//      masked minimum (not visited, entry < t_far) over its entry row, and
//      packs (ordered distance, packet-local ray index, treelet) into a
//      64-bit key, K as the treelet when no entry is left; the warp reduces
//      its keys with shuffles and one lane takes the atomic minimum into the
//      packet's next key.  The minimum is _next_pid's pick exactly: the
//      packet-wide nearest entry, the first ray on ties (argmin), that
//      ray's first treelet on ties, K for a packet with no entry left.  The
//      distance maps to an int that orders as the float: the bits of a
//      non-negative float, the bits of a negative one with the magnitude
//      bits flipped (entry distances are negative when the origin lies in a
//      treelet's box), -0 as +0.
// A block of a finished packet reads its key once and returns.  The
// scheduler launches the pick kernel once and the round exactly K times,
// with no host read: K rounds is the exact upper bound, since every round
// retires a treelet of every live packet.
//
// What bounds it on this card.  One trace of a primary ray walks about 1.2
// treelets; the least time of the trace as one function is its ray reads
// and writes (bytes).  What the card spends instead: the walks' dependent
// table loads (as K1) and the schedule.  The steps of the design, each
// timed on the H100 against the one before (PERF.md, section 6;
// wall ms of one trace of path U's primaries, 4,096-ray packets):
//   T1  in-place rounds: the merge, the triangle offset and the dead
//       interval of finished packets leave the host's passes (1.66x);
//   T2  the pick in the kernel, one atomic per warp (1.89x);
//   T3  no host read: exactly K rounds (1.35x);
//   T4  the walk of csrc/alpha8.cu: child boxes as two float4s,
//       records as three from the 48-byte table, postponed leaves (a lane
//       that pops a leaf walks inner nodes on until it pops a second while
//       its warp still looks for one; then the warp tests its leaves
//       together), one thread per ray with its stack in local memory
//       (1.27x in device time);
//   packets of 128 rays, one CUDA block (treelets.PACKET_RAYS), where the
//       reference's are 4,096: 1.27x in device time on path U (fewer rays
//       walk treelets they do not need); the pick keeps its warp atomics,
//       four a packet;
//   a CUDA graph of a trace's launches was measured and dropped: its
//       replay saves 3% of a trace's wall time, but the rays change every
//       trace, and a graph captured anew costs 1.8x the plain launches.
//
// Arithmetic is the reference kernel's (pallas_traverse.py:303-305,
// :369-383, :468-490, :597-617), as in alpha8.cu.
//
// Optional telemetry (COUNT instances), summed over the rounds of a trace:
// per ray [supernode pops, triangle-row bodies, leaf pops, triangle tests,
// coarse mask tests, 0], and flags of the supernode rows popped and the
// records tested, over the whole stacks.  The render path never launches a
// COUNT instance.

#include "trace8_common.cuh"

using namespace steeljax;

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;
// No pick yet: above every key a ray makes, and its treelet field (all
// ones) is at least K, so a packet whose next key stays empty is done.
constexpr long long kEmptyKey = 0x7fffffffffffffffLL;
// The dead interval's end (core/constants.py RAY_DEAD_T).
constexpr float kDeadT = -3.0e38f;

struct RoundArgs {
  const float* snodes;     // node_stack
  const float4* records;   // the Hopper record table of tri_stack
  const float* shade;      // shade_stack, or null in shade mode 0
  const int* tri_offsets;  // (K,) first global triangle of each treelet
  const float* entry;      // (n, K) treelet entry distances
  const float* o;
  const float* d;
  const float* t_min;
  float* t_far;            // (n,) running interval end
  unsigned* visited;       // (n, words) visited treelets
  const long long* key_cur;
  long long* key_next;
  long long* key_reset;
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
  int block;
  int ray_bits;
  int n_treelets;
  int words;
  int node_rows;
  int tri_rows;
  int shade_rows;
  int leaf_cap;
  int cull;
};

// The packet-local key of one ray: its masked nearest entry (not visited,
// entry < t_far), the ray's index in its packet and that entry's treelet
// (K when none is left), ordered as _next_pid orders them.
__device__ __forceinline__ long long pick_key(const float* erow,
                                              const unsigned* vw, int words,
                                              int k, float t_far, int local,
                                              int treelet_bits) {
  float best = __int_as_float(0x7f800000);  // +inf
  int desired = k;
  for (int w = 0; w < words; ++w) {
    const unsigned seen = vw[w];
    const int end = min(32 * w + 32, k);
    for (int j = 32 * w; j < end; ++j) {
      const float e = __ldg(erow + j);
      if (((seen >> (j & 31)) & 1u) == 0u && e < t_far && e < best) {
        best = e;
        desired = j;
      }
    }
  }
  int bits = __float_as_int(best == 0.0f ? 0.0f : best);
  if (bits < 0) bits ^= 0x7fffffff;
  const unsigned low = ((unsigned)local << treelet_bits) | (unsigned)desired;
  return (long long)(((unsigned long long)(unsigned)bits << 32) | low);
}

// The warp's least key, then one atomic into the packet's next key.  Every
// lane of the warp calls it (a warp lies inside one packet).
__device__ __forceinline__ void warp_pick(long long key, long long* next) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long other = __shfl_xor_sync(kFull, key, off);
    key = other < key ? other : key;
  }
  if ((threadIdx.x & 31) == 0) atomicMin(next, key);
}

template <bool ANY_HIT, int SHADE, bool ALPHA, bool COUNT>
__global__ void __launch_bounds__(kThreads) treelet8_kernel(
    const RoundArgs a) {
  // n and block are multiples of 32, so a warp lies inside one packet and
  // leaves together.
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int p = i / a.block;
  const int local = i - p * a.block;
  const int treelet_bits = 32 - a.ray_bits;
  if (local == 0) a.key_reset[p] = kEmptyKey;
  const int treelet =
      (int)(a.key_cur[p] & (long long)((1u << treelet_bits) - 1u));
  if (treelet >= a.n_treelets) return;

  const float* snodes = a.snodes + (size_t)treelet * a.node_rows * LANES;
  const float4* records =
      a.records + (size_t)treelet * a.tri_rows * TRI_PER_ROW * 3;
  const size_t seen_snode_base = (size_t)treelet * a.node_rows;
  const size_t seen_rec_base = (size_t)treelet * a.tri_rows * TRI_PER_ROW;
  const float* erow = a.entry + (size_t)i * a.n_treelets;

  const float tmn = __ldg(a.t_min + i);
  const float tf0 = a.t_far[i];
  // A dead, occluded or finished ray, or one whose interval misses the
  // treelet's box, walks nothing.
  const bool walks = __ldg(erow + treelet) <= tf0 && tf0 >= tmn;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
  if (walks) {
    ox = __ldg(a.o + 3 * i + 0);
    oy = __ldg(a.o + 3 * i + 1);
    oz = __ldg(a.o + 3 * i + 2);
    dx = __ldg(a.d + 3 * i + 0);
    dy = __ldg(a.d + 3 * i + 1);
    dz = __ldg(a.d + 3 * i + 2);
  }
  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy),
              inv_dz = safe_inv(dz);

  float best_t = tf0, best_u = 0.0f, best_v = 0.0f, best_det = 1.0f;
  int best_i = -1;
  bool occluded = false;
  int n_snode = 0, n_rows = 0, n_leaf = 0, n_tests = 0, n_mask = 0;

  // Stack entry: >= 0 a supernode row; < 0 a leaf child, -(1 + row * 8 +
  // child), whose meta is re-read when it is tested.  A pop removes one
  // entry and pushes at most 8, and a postponed leaf is one entry held
  // aside, so a tree of depth D needs at most 7 * D + 1 entries; the host
  // requires 8 * D + 16 <= MAX_STACK.
  int se[MAX_STACK];
  float sn[ANY_HIT ? 1 : MAX_STACK];
  int sp = 0;
  if (walks) {
    se[0] = 0;
    if constexpr (!ANY_HIT) sn[0] = -3.0e38f;
    sp = 1;
  }

  // Pop a supernode row: slab-test its 8 children ([min.xyz, max.x],
  // [max.yz, meta0, meta1]: two float4s each) and push the hit ones, for
  // the nearest query sorted so that the nearest is popped first.
  auto expand = [&](int entry) {
    if constexpr (COUNT) {
      ++n_snode;
      a.seen_snode[seen_snode_base + entry] = 1;
    }
    const float4* row =
        reinterpret_cast<const float4*>(snodes + (size_t)entry * LANES);
    const int first = sp;
#pragma unroll
    for (int c = 0; c < SNODE_WIDTH; ++c) {
      const float4 lo = __ldg(row + 4 * c), hi = __ldg(row + 4 * c + 1);
      const float t0x = (lo.x - ox) * inv_dx, t1x = (lo.w - ox) * inv_dx;
      const float t0y = (lo.y - oy) * inv_dy, t1y = (hi.x - oy) * inv_dy;
      const float t0z = (lo.z - oz) * inv_dz, t1z = (hi.y - oz) * inv_dz;
      const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                fminf(t0z, t1z));
      const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                               fmaxf(t0z, t1z));
      const int meta0 = (int)hi.z, meta1 = (int)hi.w;
      if (meta0 >= 0 && tnear <= tfar && tfar >= tmn && tnear <= best_t) {
        const int value = meta1 > 0 ? -(1 + entry * SNODE_WIDTH + c) : meta0;
        if constexpr (ANY_HIT) {
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
        snodes + (size_t)(code / SNODE_WIDTH) * LANES +
        CHILD_STRIDE * (code % SNODE_WIDTH) + 6));
    const int start = (int)meta.x;
    const int count = min((int)meta.y, a.leaf_cap);
    int tested = 0;
    for (int l = 0; l < count; ++l) {
      const int rec = start + l;
      const float4* r = records + 3 * (size_t)rec;
      const float4 v0 = __ldg(r), e1 = __ldg(r + 1), e2 = __ldg(r + 2);
      if constexpr (COUNT) {
        ++tested;
        a.seen_rec[seen_rec_base + rec] = 1;
      }
      // AUX word: bit 0 double-sided, bits 1.. the coarse mask.
      const int aux = ALPHA ? (int)v0.w : 0;
      const float px = dy * e2.z - dz * e2.y;
      const float py = dz * e2.x - dx * e2.z;
      const float pz = dx * e2.y - dy * e2.x;
      const float det = e1.x * px + e1.y * py + e1.z * pz;
      const bool det_ok = fabsf(det) > kDetEps;
      bool facing = det_ok;
      if constexpr (!ANY_HIT) {
        const bool double_sided = ALPHA ? (aux & 1) != 0 : v0.w > 0.5f;
        if (a.cull) facing = det > kDetEps || (double_sided && det_ok);
      }
      const float inv_det = 1.0f / (det_ok ? det : 1.0f);
      const float tx = ox - v0.x, ty = oy - v0.y, tz = oz - v0.z;
      const float u = (tx * px + ty * py + tz * pz) * inv_det;
      const float qx = ty * e1.z - tz * e1.y;
      const float qy = tz * e1.x - tx * e1.z;
      const float qz = tx * e1.y - ty * e1.x;
      const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
      const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
      // t <= best_t: a later candidate wins an exact tie, as in K1.
      bool accept = facing && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                    t >= tmn && t <= best_t;
      if constexpr (ALPHA) {
        if constexpr (COUNT) n_mask += accept ? 1 : 0;
        accept = accept && coarse_keep(aux >> 1, u, v);
      }
      if (accept) {
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
      n_rows += (tested + TRI_PER_ROW - 1) / TRI_PER_ROW;
      n_tests += tested;
    }
  };

  // The walk with postponed leaves; every lane of the warp votes to the
  // end.
  int leaf = -1;  // the postponed leaf's code
  while (__any_sync(kFull, sp > 0 || leaf >= 0)) {
    bool stalled = false;
    while (__any_sync(kFull, leaf < 0 && sp > 0)) {
      if (sp > 0 && !stalled) {
        --sp;
        const int entry = se[sp];
        // Pop-time cull: the push-time test near <= best t, re-evaluated.
        if (ANY_HIT || !(sn[sp] > best_t)) {
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
    if (leaf >= 0) {
      test_leaf(leaf);
      leaf = -1;
      if (ANY_HIT && occluded) sp = 0;
    }
  }

  if constexpr (COUNT) {
    int* cnt = a.out_cnt + N_COUNTERS * (size_t)i;
    cnt[0] += n_snode;
    cnt[1] += n_rows;
    cnt[2] += n_leaf;
    cnt[3] += n_tests;
    cnt[4] += n_mask;
  }

  // The in-place merge.
  float tf = tf0;
  if constexpr (ANY_HIT) {
    if (occluded) {
      a.out_hit[i] = 1;
      tf = kDeadT;
      a.t_far[i] = tf;
    }
  } else if (best_i >= 0 && (best_t < tf0 || a.out_tri[i] < 0)) {
    tf = best_t;
    a.t_far[i] = tf;
    a.out_t[i] = best_t;
    a.out_u[i] = best_u;
    a.out_v[i] = best_v;
    a.out_tri[i] = __ldg(a.tri_offsets + treelet) + best_i;
    if constexpr (SHADE != 0) {
      const float* s;
      const float* shade = a.shade + (size_t)treelet * a.shade_rows * LANES;
      if constexpr (SHADE == 2) {
        s = shade +
            (size_t)((best_i / TRI_PER_ROW) * (TRI_PER_ROW / SHADE2_PER_ROW) +
                     (best_i % TRI_PER_ROW) / SHADE2_PER_ROW) * LANES +
            SHADE2_STRIDE * (best_i % SHADE2_PER_ROW);
      } else {
        s = shade + (size_t)(best_i / TRI_PER_ROW) * LANES +
            SHADE1_STRIDE * (best_i % TRI_PER_ROW);
      }
      const float wb = 1.0f - best_u - best_v;
      const float nx =
          __ldg(s + 0) * wb + __ldg(s + 3) * best_u + __ldg(s + 6) * best_v;
      const float ny =
          __ldg(s + 1) * wb + __ldg(s + 4) * best_u + __ldg(s + 7) * best_v;
      const float nz =
          __ldg(s + 2) * wb + __ldg(s + 5) * best_u + __ldg(s + 8) * best_v;
      // Normalize and flip back-face hits (det < 0).
      const float n2 = nx * nx + ny * ny + nz * nz;
      const float inv_n =
          (best_det < 0.0f ? -1.0f : 1.0f) * rsqrtf(fmaxf(n2, 1e-20f));
      a.out_n[3 * i + 0] = nx * inv_n;
      a.out_n[3 * i + 1] = ny * inv_n;
      a.out_n[3 * i + 2] = nz * inv_n;
      a.out_mat[i] = (int)__ldg(s + 9);
      if constexpr (SHADE == 2) {
        const float tnx = __ldg(s + 10) * wb + __ldg(s + 13) * best_u +
                          __ldg(s + 16) * best_v;
        const float tny = __ldg(s + 11) * wb + __ldg(s + 14) * best_u +
                          __ldg(s + 17) * best_v;
        const float tnz = __ldg(s + 12) * wb + __ldg(s + 15) * best_u +
                          __ldg(s + 18) * best_v;
        // The tangent is normalized and never flipped.
        const float t2 = tnx * tnx + tny * tny + tnz * tnz;
        const float inv_t = rsqrtf(fmaxf(t2, 1e-20f));
        a.out_tan[3 * i + 0] = tnx * inv_t;
        a.out_tan[3 * i + 1] = tny * inv_t;
        a.out_tan[3 * i + 2] = tnz * inv_t;
        a.out_uv[2 * i + 0] = __ldg(s + 19) * wb + __ldg(s + 21) * best_u +
                              __ldg(s + 23) * best_v;
        a.out_uv[2 * i + 1] = __ldg(s + 20) * wb + __ldg(s + 22) * best_u +
                              __ldg(s + 24) * best_v;
        a.out_uvd[i] = __ldg(s + 25);
      }
    }
  }

  // The next pick: every ray of the packet has visited this treelet.
  unsigned* vw = a.visited + (size_t)i * a.words;
  vw[treelet >> 5] |= 1u << (treelet & 31);
  warp_pick(pick_key(erow, vw, a.words, a.n_treelets, tf, local,
                     treelet_bits),
            a.key_next + p);
}

// The first pick of a trace, from every ray's entry row, visited words and
// t_far, into keys (which hold kEmptyKey).
__global__ void __launch_bounds__(kThreads) treelet_pick_kernel(
    const float* entry, const float* t_far, const unsigned* visited,
    long long* keys, int n, int block, int ray_bits, int n_treelets,
    int words) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int p = i / block;
  warp_pick(pick_key(entry + (size_t)i * n_treelets,
                     visited + (size_t)i * words, words, n_treelets,
                     t_far[i], i - p * block, 32 - ray_bits),
            keys + p);
}

template <bool ANY_HIT, int SHADE, bool ALPHA>
int launch(const RoundArgs& a, bool count, void* stream) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  if (count) {
    treelet8_kernel<ANY_HIT, SHADE, ALPHA, true>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  } else {
    treelet8_kernel<ANY_HIT, SHADE, ALPHA, false>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// The packet geometry both entries check: n rays in whole packets of
// `block` rays, a multiple of 32, and K treelets that fit the key's
// treelet field (32 - ray_bits bits, all ones meaning "done").
bool bad_packets(int n, int block, int ray_bits, int n_treelets) {
  return n < 0 || block <= 0 || block % 32 != 0 || n % block != 0 ||
         ray_bits < 1 || ray_bits > 24 || (block - 1) >> ray_bits != 0 ||
         n_treelets <= 0 ||
         (long long)n_treelets >= (1LL << (32 - ray_bits)) - 1;
}

}  // namespace

extern "C" {

// One round r of the treelet scheduler (K7) over n rays in packets of
// `block` rays: key_cur is keys[r % 3], key_next keys[(r + 1) % 3] (all
// empty), key_reset keys[(r + 2) % 3].  Every ray of a live packet walks
// its packet's treelet of node_stack (n_treelets x node_rows x 128) over
// `records` (hopper_records of tri_stack, n_treelets x tri_rows x 12
// records), updates its record, t_far and visited words in place and takes
// part in the next pick; shade_stack (n_treelets x tri_rows * {1, 3} x 128)
// in shade modes 1 and 2.  any_hit != 0: out_hit (one byte per ray) and no
// culling; alpha != 0 applies the coarse masks of the records' AUX words
// (shade mode 0 only).  out_cnt (n x N_COUNTERS int32, summed into) with
// seen_snode (one byte per row of node_stack) and seen_rec (one per
// record): all three or none.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int steeljax_treelet_round8(
    const void* node_stack, const void* records, const void* shade_stack,
    const void* tri_offsets, const void* entry, const void* o, const void* d,
    const void* t_min, void* t_far, void* visited, const void* key_cur,
    void* key_next, void* key_reset, void* out_t, void* out_u, void* out_v,
    void* out_tri, void* out_n, void* out_mat, void* out_tan, void* out_uv,
    void* out_uvd, void* out_hit, void* out_cnt, void* seen_snode,
    void* seen_rec, int n, int block, int ray_bits, int n_treelets,
    int node_rows, int tri_rows, int max_leaf, int depth, int cull,
    int shade_mode, int alpha, int any_hit, void* stream) {
  if (bad_packets(n, block, ray_bits, n_treelets) || node_rows <= 0 ||
      tri_rows <= 0 || max_leaf <= 0 || depth <= 0 ||
      8 * depth + 16 > MAX_STACK || node_stack == nullptr ||
      records == nullptr || tri_offsets == nullptr || entry == nullptr ||
      t_far == nullptr || visited == nullptr || key_cur == nullptr ||
      key_next == nullptr || key_reset == nullptr ||
      (out_cnt != nullptr && (seen_snode == nullptr || seen_rec == nullptr)) ||
      shade_mode < 0 || shade_mode > 2 ||
      ((alpha || any_hit) && shade_mode != 0) ||
      (any_hit && out_hit == nullptr) ||
      (!any_hit && (out_t == nullptr || out_u == nullptr ||
                    out_v == nullptr || out_tri == nullptr)) ||
      (shade_mode != 0 && (shade_stack == nullptr || out_n == nullptr ||
                           out_mat == nullptr)) ||
      (shade_mode == 2 && (out_tan == nullptr || out_uv == nullptr ||
                           out_uvd == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  RoundArgs a = {};
  a.snodes = (const float*)node_stack;
  a.records = (const float4*)records;
  a.shade = (const float*)shade_stack;
  a.tri_offsets = (const int*)tri_offsets;
  a.entry = (const float*)entry;
  a.o = (const float*)o;
  a.d = (const float*)d;
  a.t_min = (const float*)t_min;
  a.t_far = (float*)t_far;
  a.visited = (unsigned*)visited;
  a.key_cur = (const long long*)key_cur;
  a.key_next = (long long*)key_next;
  a.key_reset = (long long*)key_reset;
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
  a.n = n;
  a.block = block;
  a.ray_bits = ray_bits;
  a.n_treelets = n_treelets;
  a.words = (n_treelets + 31) / 32;
  a.node_rows = node_rows;
  a.tri_rows = tri_rows;
  a.shade_rows =
      tri_rows * (shade_mode == 2 ? TRI_PER_ROW / SHADE2_PER_ROW : 1);
  a.leaf_cap = leaf_cap(max_leaf, TRI_PER_ROW);
  a.cull = cull;
  const bool count = out_cnt != nullptr;
  if (any_hit) {
    return alpha ? launch<true, 0, true>(a, count, stream)
                 : launch<true, 0, false>(a, count, stream);
  }
  if (alpha) return launch<false, 0, true>(a, count, stream);
  if (shade_mode == 2) {
    return launch<false, 2, false>(a, count, stream);
  }
  if (shade_mode == 1) {
    return launch<false, 1, false>(a, count, stream);
  }
  return launch<false, 0, false>(a, count, stream);
}

// The first pick of a trace over n rays in packets of `block` rays: keys
// (one per packet, all kEmptyKey) take each packet's least key over its
// rays' entry rows (n x n_treelets), t_far (n,) and visited words (n x
// ceil(n_treelets / 32)).  Launches on `stream` and returns
// cudaGetLastError().
int steeljax_treelet_pick8(const void* entry, const void* t_far,
                           const void* visited, void* keys, int n, int block,
                           int ray_bits, int n_treelets, void* stream) {
  if (bad_packets(n, block, ray_bits, n_treelets) || entry == nullptr ||
      t_far == nullptr || visited == nullptr || keys == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  treelet_pick_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)entry, (const float*)t_far, (const unsigned*)visited,
      (long long*)keys, n, block, ray_bits, n_treelets,
      (n_treelets + 31) / 32);
  return (int)cudaGetLastError();
}

}  // extern "C"
