// Two-level BVH8 ray traversal for Hopper (sm_90a), one thread per ray: an
// instance TLAS over object-space BLAS.
//
// K6, the counterpart of steeljax/accel/pallas_traverse.py:
// _traverse_kernel8_inst (:1283, host wrapper _trace_packed8_inst,
// pallas_call at :1758): nearest hit with shade modes 0, 1 and 2, and
// any-hit occlusion.  Each instance of the template is specialized at
// compile time on (ANY_HIT, SHADE, COUNT).
//
// Tables (accel/instances.py):
//   snodes (S, 128) f32: TLAS rows [0, n_tlas), then every BLAS's rows; the
//     child layout of trace8_common.cuh, with a third child kind: meta1 < 0
//     is an instance (meta0 = instance id).  Leaf children's meta0 index
//     the record pool, internal children's the unified table.
//   records: the Hopper record table of the pooled BLAS records
//     (cuda_traverse.hopper_records of the reference's (R, 128) rows,
//     InstancedTables.tri_records): record k is three float4s at k * 3,
//     [v0.xyz, ds], [e1.xyz, 0], [e2.xyz, 0], in object space; their
//     double-sided float is 0 (the instance carries the flag).
//   inst (I, 48) f32: inverse world 3x4 row-major (0:12), BLAS root
//     supernode (12), double-sided flag (13), material id (14), 1 / uniform
//     scale (15), normal matrix (16:25), world linear matrix (25:34).  A row
//     is 192 bytes and the wrapper checks that the table starts on 16
//     bytes, so every row is read as float4s: the inverse 3x4 as three,
//     (root, double-sided, material, 1 / scale) as the fourth.
//   shade: the object-space fused records of modes 1 and 2
//     (trace8_common.cuh), addressed by the pool index.
//
// One stack serves both levels.  An entry >= 0 is a supernode row: a TLAS
// row (entry < n_tlas) is slab-tested with the world ray, a BLAS row with
// the current object-space ray.  An entry < 0 is code = -entry - 1 with
// code & 1 the kind: 0 a leaf child (code >> 1 = row * 8 + child, its meta
// re-read when it is tested), 1 an instance to enter (code >> 1 = instance
// id).  Entering an instance moves the ray into object space by the
// instance's inverse 3x4 (the direction is not renormalized, so t is the
// world parameter on both levels and entry distances of the two levels
// compare) and pushes the BLAS root.  There is no restore entry: the stack
// is last-in first-out, so everything an instance pushed is popped before
// the next TLAS entry, and one object-space copy per thread is enough.
//
// The Moller-Trumbore test, the |det| > 1e-12 threshold and the facing test
// run on the object-space ray, so facing follows object-space winding; a
// triangle is double-sided when its record or its instance says so.  The
// winner's attributes are interpolated once, after the walk: the kernel
// keeps the winner's instance id and det, rotates the interpolated normal
// by the instance's normal matrix (tangent: world linear matrix) before
// normalizing, flips the normal where the object-space det < 0, takes the
// material id from the instance row and scales the uv density by the row's
// 1 / scale (pallas_traverse.py:1543-1598, :1661-1680).
//
// What bounds it on this card: the tables of an instanced scene are small
// (one BLAS per primitive), so they stay in L1 and L2, and the least time
// for its work is set by its operations (the slab tests of the rows a ray
// pops), not by its bytes.  What the card spends instead goes to feeding
// the walk: dependent table loads, one L1 wavefront per distinct line of a
// warp, and divergence, the worse for neighbouring rays that enter
// different instances.  What the design does about it, each step timed on
// the H100 against the one before (PERF.md, section 6):
//   I1  16-byte loads (kept, 1.11-1.20x): a child box is two float4s
//       ([min.xyz, max.x], [max.yz, meta0, meta1]) on both levels, a record
//       three from the 48-byte table, an instance row four: an instance
//       entry costs four loads where it cost 14 dependent scalar ones;
//   I2  postponed leaves over two levels (as alpha8.cu; the held leaf
//       tested with its instance's object-space ray, the speculative walk
//       stopped at an instance entry or a TLAS row): correct, but 0.99-1.01x
//       over I1, so dropped.  A ray pops 0.8-1.0 leaves of 7-10 records, so
//       a warp has little to gather; its walk is mostly TLAS pops.
// Far-to-near insertion with pop-time culling on both levels keeps
// instances behind the nearest hit from being entered; the any-hit query
// keeps no entry distances and leaves at the first accepted candidate.
//
// Optional telemetry (COUNT instances): per ray [supernode pops on both
// levels, triangle-row bodies, leaf pops, triangle tests, instances
// entered, TLAS supernode pops], and flags of the supernode rows popped,
// the records tested and the instances entered.

#include "trace8_common.cuh"

using namespace steeljax;

#define INST_COLS 48
// The instanced stack also holds instance entries: the host requires
// 8 * depth + 32 <= MAX_STACK with depth = TLAS depth + 1 + deepest BLAS
// (the reference's bound, pallas_traverse.py:1735).
#define INST_STACK_SLACK 32

namespace {

constexpr int kThreads = 128;

struct InstArgs {
  const float* snodes;
  const float4* records;
  const float* inst;
  const float* shade;
  const float* o;
  const float* d;
  const float* t_min;
  const float* t_max;
  float* out_t;
  float* out_u;
  float* out_v;
  int* out_tri;
  int* out_inst;
  float* out_n;
  int* out_mat;
  float* out_tan;
  float* out_uv;
  float* out_uvd;
  unsigned char* out_hit;
  int* out_cnt;
  unsigned char* seen_snode;
  unsigned char* seen_rec;
  unsigned char* seen_inst;
  int n;
  int n_tlas;
  int leaf_cap;
  int cull;
};

template <bool ANY_HIT, int SHADE, bool COUNT>
__global__ void __launch_bounds__(kThreads) inst8_kernel(const InstArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;

  // World ray, and the ray in the current instance's object space.
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
  ox = a.o[3 * i + 0];
  oy = a.o[3 * i + 1];
  oz = a.o[3 * i + 2];
  dx = a.d[3 * i + 0];
  dy = a.d[3 * i + 1];
  dz = a.d[3 * i + 2];
  const float tmn = a.t_min[i], tmx = a.t_max[i];
  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy),
              inv_dz = safe_inv(dz);
  float cox = ox, coy = oy, coz = oz, cdx = dx, cdy = dy, cdz = dz;
  float cinv_dx = inv_dx, cinv_dy = inv_dy, cinv_dz = inv_dz;
  int cur_inst = -1;
  bool cur_ds = false;

  float best_t = tmx;
  float best_u = 0.0f, best_v = 0.0f, best_det = 1.0f;
  int best_i = -1, best_inst = -1;
  bool occluded = false;
  int n_snode = 0, n_rows = 0, n_leaf = 0, n_tests = 0, n_enter = 0,
      n_tlas_pops = 0;

  int se[MAX_STACK];
  // Entry distances, for the nearest query's pop-time cull only.
  float sn[ANY_HIT ? 1 : MAX_STACK];
  int sp = 0;
  // A dead ray (inverted interval) traces nothing.
  if (best_t >= tmn) {
    se[0] = 0;
    if constexpr (!ANY_HIT) sn[0] = -3.0e38f;
    sp = 1;
  }

  // Pop a supernode row (TLAS: the world ray; BLAS: the object-space ray):
  // slab-test its 8 children, two float4s each, and push the hit ones, for
  // the nearest query sorted so that the nearest is popped first.
  auto expand = [&](int entry) {
    const bool world = entry < a.n_tlas;
    if constexpr (COUNT) {
      ++n_snode;
      n_tlas_pops += world ? 1 : 0;
      a.seen_snode[entry] = 1;
    }
    const float sox = world ? ox : cox, soy = world ? oy : coy,
                soz = world ? oz : coz;
    const float six = world ? inv_dx : cinv_dx,
                siy = world ? inv_dy : cinv_dy,
                siz = world ? inv_dz : cinv_dz;
    const float4* row =
        reinterpret_cast<const float4*>(a.snodes + (size_t)entry * LANES);
    const int first = sp;
#pragma unroll
    for (int c = 0; c < SNODE_WIDTH; ++c) {
      // [min.xyz, max.x], [max.yz, meta0, meta1].
      const float4 lo = __ldg(row + 4 * c), hi = __ldg(row + 4 * c + 1);
      const float t0x = (lo.x - sox) * six, t1x = (lo.w - sox) * six;
      const float t0y = (lo.y - soy) * siy, t1y = (hi.x - soy) * siy;
      const float t0z = (lo.z - soz) * siz, t1z = (hi.y - soz) * siz;
      const float tnear = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                fminf(t0z, t1z));
      const float tfar = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                               fmaxf(t0z, t1z));
      const int meta0 = (int)hi.z, meta1 = (int)hi.w;
      if (meta0 >= 0 && tnear <= tfar && tfar >= tmn && tnear <= best_t) {
        int value = meta0;  // an internal child
        if (meta1 > 0) {
          value = -(1 + ((entry * SNODE_WIDTH + c) << 1));
        } else if (meta1 < 0) {
          value = -(1 + ((meta0 << 1) | 1));
        }
        if constexpr (ANY_HIT) {
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

  // Enter instance `iid`: the ray in its object space, then its BLAS root
  // at the instance's own entry distance.
  auto enter = [&](int iid, float near) {
    const float4* m =
        reinterpret_cast<const float4*>(a.inst + (size_t)iid * INST_COLS);
    const float4 r0 = __ldg(m), r1 = __ldg(m + 1), r2 = __ldg(m + 2),
                 r3 = __ldg(m + 3);
    cox = r0.x * ox + r0.y * oy + r0.z * oz + r0.w;
    coy = r1.x * ox + r1.y * oy + r1.z * oz + r1.w;
    coz = r2.x * ox + r2.y * oy + r2.z * oz + r2.w;
    cdx = r0.x * dx + r0.y * dy + r0.z * dz;
    cdy = r1.x * dx + r1.y * dy + r1.z * dz;
    cdz = r2.x * dx + r2.y * dy + r2.z * dz;
    cinv_dx = safe_inv(cdx);
    cinv_dy = safe_inv(cdy);
    cinv_dz = safe_inv(cdz);
    cur_inst = iid;
    cur_ds = r3.y > 0.5f;
    if constexpr (COUNT) {
      ++n_enter;
      a.seen_inst[iid] = 1;
    }
    se[sp] = (int)r3.x;
    if constexpr (!ANY_HIT) sn[sp] = near;
    ++sp;
  };

  // Test the records of leaf child `slot` (row * 8 + child) of the current
  // instance's BLAS with its object-space ray.
  auto test_leaf = [&](int slot) {
    const float2 meta = __ldg(reinterpret_cast<const float2*>(
        a.snodes + (size_t)(slot / SNODE_WIDTH) * LANES +
        CHILD_STRIDE * (slot % SNODE_WIDTH) + 6));
    const int start = (int)meta.x;
    const int count = min((int)meta.y, a.leaf_cap);
    int tested = 0;
    for (int l = 0; l < count; ++l) {
      const int rec = start + l;
      const float4* r = a.records + 3 * (size_t)rec;
      const float4 v0 = __ldg(r), e1 = __ldg(r + 1), e2 = __ldg(r + 2);
      if constexpr (COUNT) {
        ++tested;
        a.seen_rec[rec] = 1;
      }
      const float px = cdy * e2.z - cdz * e2.y;
      const float py = cdz * e2.x - cdx * e2.z;
      const float pz = cdx * e2.y - cdy * e2.x;
      const float det = e1.x * px + e1.y * py + e1.z * pz;
      const bool det_ok = fabsf(det) > kDetEps;
      bool facing = det_ok;
      if constexpr (!ANY_HIT) {
        const bool double_sided = cur_ds || v0.w > 0.5f;
        if (a.cull) facing = det > kDetEps || (double_sided && det_ok);
      }
      const float inv_det = 1.0f / (det_ok ? det : 1.0f);
      const float tx = cox - v0.x, ty = coy - v0.y, tz = coz - v0.z;
      const float u = (tx * px + ty * py + tz * pz) * inv_det;
      const float qx = ty * e1.z - tz * e1.y;
      const float qy = tz * e1.x - tx * e1.z;
      const float qz = tx * e1.y - ty * e1.x;
      const float v = (cdx * qx + cdy * qy + cdz * qz) * inv_det;
      const float t = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
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
          best_inst = cur_inst;
        }
      }
    }
    if constexpr (COUNT) {
      ++n_leaf;
      n_rows += (tested + TRI_PER_ROW - 1) / TRI_PER_ROW;
      n_tests += tested;
    }
  };

  while (sp > 0) {
    --sp;
    const int entry = se[sp];
    const float near = ANY_HIT ? 0.0f : sn[sp];
    if (!ANY_HIT && near > best_t) continue;
    if (entry >= 0) {
      expand(entry);
    } else if ((-entry - 1) & 1) {
      enter((-entry - 1) >> 1, near);
    } else {
      test_leaf((-entry - 1) >> 1);
      if (ANY_HIT && occluded) break;
    }
  }

  if constexpr (COUNT) {
    a.out_cnt[N_COUNTERS * i + 0] = n_snode;
    a.out_cnt[N_COUNTERS * i + 1] = n_rows;
    a.out_cnt[N_COUNTERS * i + 2] = n_leaf;
    a.out_cnt[N_COUNTERS * i + 3] = n_tests;
    a.out_cnt[N_COUNTERS * i + 4] = n_enter;
    a.out_cnt[N_COUNTERS * i + 5] = n_tlas_pops;
  }
  if constexpr (ANY_HIT) {
    a.out_hit[i] = occluded ? 1 : 0;
    return;
  }

  a.out_t[i] = best_i >= 0 ? best_t : -1.0f;
  a.out_u[i] = best_u;
  a.out_v[i] = best_v;
  a.out_tri[i] = best_i;
  a.out_inst[i] = best_inst;
  if constexpr (SHADE != 0) {
    // Miss: the reference's initial values (n = +z, mat 0, tangent = +x,
    // uv = 0, uv density 0).
    float nx = 0.0f, ny = 0.0f, nz = 1.0f, mat = 0.0f;
    float tnx = 1.0f, tny = 0.0f, tnz = 0.0f, ux = 0.0f, uy = 0.0f,
          uvd = 0.0f;
    if (best_i >= 0) {
      const float* m = a.inst + (size_t)best_inst * INST_COLS;
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
      const float wb = 1.0f - best_u - best_v;
      const float onx =
          __ldg(s + 0) * wb + __ldg(s + 3) * best_u + __ldg(s + 6) * best_v;
      const float ony =
          __ldg(s + 1) * wb + __ldg(s + 4) * best_u + __ldg(s + 7) * best_v;
      const float onz =
          __ldg(s + 2) * wb + __ldg(s + 5) * best_u + __ldg(s + 8) * best_v;
      // Object-space normal into world space by the normal matrix.
      nx = __ldg(m + 16) * onx + __ldg(m + 17) * ony + __ldg(m + 18) * onz;
      ny = __ldg(m + 19) * onx + __ldg(m + 20) * ony + __ldg(m + 21) * onz;
      nz = __ldg(m + 22) * onx + __ldg(m + 23) * ony + __ldg(m + 24) * onz;
      mat = __ldg(m + 14);
      if constexpr (SHADE == 2) {
        const float otx = __ldg(s + 10) * wb + __ldg(s + 13) * best_u +
                          __ldg(s + 16) * best_v;
        const float oty = __ldg(s + 11) * wb + __ldg(s + 14) * best_u +
                          __ldg(s + 17) * best_v;
        const float otz = __ldg(s + 12) * wb + __ldg(s + 15) * best_u +
                          __ldg(s + 18) * best_v;
        // Tangents rotate with the plain linear part.
        tnx = __ldg(m + 25) * otx + __ldg(m + 26) * oty + __ldg(m + 27) * otz;
        tny = __ldg(m + 28) * otx + __ldg(m + 29) * oty + __ldg(m + 30) * otz;
        tnz = __ldg(m + 31) * otx + __ldg(m + 32) * oty + __ldg(m + 33) * otz;
        ux = __ldg(s + 19) * wb + __ldg(s + 21) * best_u +
             __ldg(s + 23) * best_v;
        uy = __ldg(s + 20) * wb + __ldg(s + 22) * best_u +
             __ldg(s + 24) * best_v;
        uvd = __ldg(s + 25) * __ldg(m + 15);
      }
    }
    // Normalize and flip back-face hits: the normal matrix keeps the
    // object-space winding sign.
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
}

template <bool ANY_HIT, int SHADE>
int launch_inst(const InstArgs& a, bool count, void* stream) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  if (count) {
    inst8_kernel<ANY_HIT, SHADE, true>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  } else {
    inst8_kernel<ANY_HIT, SHADE, false>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Two-level nearest hit (K6) of n rays, or with any_hit != 0 their
// occlusion flags (out_hit: one byte per ray; no culling, shade mode 0).
// Pointers are device pointers; records is the Hopper record table of the
// pooled BLAS records (cuda_traverse.hopper_records) and inst the (n_inst,
// 48) instance rows, both on 16 bytes; shade and the shading outputs may be
// null when shade_mode == 0, out_tan/out_uv/out_uvd when it is not 2, the
// nearest outputs when any_hit, and out_cnt (n x N_COUNTERS int32) with
// seen_snode (one byte per supernode row), seen_rec (one per pooled
// record) and seen_inst (one per instance), all four, when no telemetry is
// wanted.  depth is TLAS depth + 1 + the deepest BLAS.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
int steeljax_trace_inst8(const void* snodes, const void* records,
                         const void* inst, const void* shade, const void* o,
                         const void* d, const void* t_min, const void* t_max,
                         void* out_t, void* out_u, void* out_v, void* out_tri,
                         void* out_inst, void* out_n, void* out_mat,
                         void* out_tan, void* out_uv, void* out_uvd,
                         void* out_hit, void* out_cnt, void* seen_snode,
                         void* seen_rec, void* seen_inst, int n, int n_tlas,
                         int n_inst, int max_leaf, int depth, int cull,
                         int shade_mode, int any_hit, void* stream) {
  if (n < 0 || n_tlas < 1 || n_inst < 0 || max_leaf <= 0 || depth <= 0 ||
      8 * depth + INST_STACK_SLACK > MAX_STACK || records == nullptr ||
      inst == nullptr || ((size_t)records & 15) != 0 ||
      ((size_t)inst & 15) != 0 ||
      (out_cnt != nullptr && (seen_snode == nullptr || seen_rec == nullptr ||
                              seen_inst == nullptr)) ||
      shade_mode < 0 || shade_mode > 2 || (any_hit && shade_mode != 0) ||
      (any_hit && out_hit == nullptr) ||
      (!any_hit && (out_t == nullptr || out_u == nullptr ||
                    out_v == nullptr || out_tri == nullptr ||
                    out_inst == nullptr)) ||
      (shade_mode != 0 && (shade == nullptr || out_n == nullptr ||
                           out_mat == nullptr)) ||
      (shade_mode == 2 && (out_tan == nullptr || out_uv == nullptr ||
                           out_uvd == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  InstArgs a = {};
  a.snodes = (const float*)snodes;
  a.records = (const float4*)records;
  a.inst = (const float*)inst;
  a.shade = (const float*)shade;
  a.o = (const float*)o;
  a.d = (const float*)d;
  a.t_min = (const float*)t_min;
  a.t_max = (const float*)t_max;
  a.out_t = (float*)out_t;
  a.out_u = (float*)out_u;
  a.out_v = (float*)out_v;
  a.out_tri = (int*)out_tri;
  a.out_inst = (int*)out_inst;
  a.out_n = (float*)out_n;
  a.out_mat = (int*)out_mat;
  a.out_tan = (float*)out_tan;
  a.out_uv = (float*)out_uv;
  a.out_uvd = (float*)out_uvd;
  a.out_hit = (unsigned char*)out_hit;
  a.out_cnt = (int*)out_cnt;
  a.seen_snode = (unsigned char*)seen_snode;
  a.seen_rec = (unsigned char*)seen_rec;
  a.seen_inst = (unsigned char*)seen_inst;
  a.n = n;
  a.n_tlas = n_tlas;
  a.leaf_cap = leaf_cap(max_leaf, TRI_PER_ROW);
  a.cull = cull;
  const bool count = out_cnt != nullptr;
  if (any_hit) return launch_inst<true, 0>(a, count, stream);
  if (shade_mode == 2) {
    return launch_inst<false, 2>(a, count, stream);
  }
  if (shade_mode == 1) {
    return launch_inst<false, 1>(a, count, stream);
  }
  return launch_inst<false, 0>(a, count, stream);
}

}  // extern "C"
