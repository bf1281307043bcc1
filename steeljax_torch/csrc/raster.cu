// Rasterized primary visibility for Hopper (sm_90a): the raster stage of
// the hybrid G-buffer, one thread block per 32x24-pixel subtile.
//
// R, the counterpart of steeljax/render/hybrid/raster.py: _raster_tiles
// (:306).  The reference computes this stage in plain jnp outside Pallas (a
// lax.map over subtiles, each a fori_loop of (768, 3) @ (3, 7 * WINDOW)
// products); no TPU kernel stands behind it.  The plain PyTorch version is
// render/hybrid/raster.py: _raster_tiles_plain, which this kernel matches
// bit for bit.
//
// Inputs (render/hybrid/raster.py: _binned):
//   recs (P, 24) f32: the piece records sorted by bin key, per record the
//     (a, b, c) of the forms E0, E1, E2, Fw, Fu, Fv, Z (each a*sx + b*sy +
//     c at a pixel centre), the triangle id, and the subtile bbox as
//     tx0 + 4096 * ty0 and tx1 + 4096 * ty1;
//   tile_ids (n,) i32: the subtile of each block (ty * ntx + tx);
//   sa, la, sb, lb, gs, gl (n,) i32: the block's three candidate segments
//     in the records, walked in this order: the row above (columns tx - 1
//     .. tx), its own row (the same columns), then the global "big"
//     segment.
// Outputs, (n, 768) f32 each, pixel p = sub * 32 + lane: bz (the winner's
// reverse z, -1 where no piece covers the pixel), fu, fv, fw (0, 0, 1 on a
// miss) and ft (the triangle id, -1 on a miss).
//
// The tie rule is the reference's: each segment is taken in `window`-piece
// slices; within a slice the LAST piece of the greatest z wins (the
// reference's si = max(index)); a later slice replaces the running winner
// only on a strictly greater z.  The winner's Fu, Fv and Fw are evaluated
// from that one piece.  Every form is (a * px + b * py) + c with each
// operation rounded on its own (__fmul_rn, __fadd_rn: no contraction into
// a fused multiply-add), the plain version's order, so the two agree
// exactly.
//
// Design: 256 threads a block, each with 3 pixels (rows sub, sub + 8,
// sub + 16 of one lane), so one record read from shared memory feeds three
// pixels.  A slice's records (at most 256 x 96 bytes = 24 KB) are staged in
// shared memory by the whole block with coalesced loads, then every thread
// walks them in order.  The bbox test is per record and the same for the
// whole block, so a record that does not cover the subtile costs no
// divergence.  No host read: the trip counts are the segment lengths, read
// by the block itself, so the frame keeps no host synchronization.
//
// What bounds it on this card: each block reads its candidate records once
// (96 bytes each) and writes 768 x 20 bytes; each pixel evaluates four
// forms and five comparisons for every candidate that covers its subtile.
// On path H's 1080p frame both are well under a millisecond at the card's
// peaks (chip_smoke.py phase 17 prints the bound); this first version is
// simple and correct, and making it fast (culling by bounding box per warp
// before the forms, TMA staging) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 24;
constexpr int kPx = kTileW * kTileH;
constexpr int kRecCols = 24;
constexpr int kMaxWindow = 256;
constexpr int kThreads = 256;
constexpr int kPerThread = kPx / kThreads;  // 3
// Record columns (render/hybrid/raster.py).
constexpr int kE0 = 0, kE1 = 3, kE2 = 6, kFw = 9, kFu = 12, kFv = 15,
              kZ = 18, kTri = 21, kBmin = 22, kBmax = 23;

__device__ __forceinline__ float form(const float* r, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], px), __fmul_rn(r[1], py)),
                   r[2]);
}

__global__ void __launch_bounds__(kThreads) raster_tiles_kernel(
    const float* __restrict__ recs, const int* __restrict__ tile_ids,
    const int* __restrict__ sa, const int* __restrict__ la,
    const int* __restrict__ sb, const int* __restrict__ lb,
    const int* __restrict__ gs, const int* __restrict__ gl,
    float* __restrict__ out_z, float* __restrict__ out_u,
    float* __restrict__ out_v, float* __restrict__ out_w,
    float* __restrict__ out_t, int n_rows, int ntx, int window) {
  __shared__ float s_rec[kMaxWindow * kRecCols];
  const int b = blockIdx.x;
  const int tile = tile_ids[b];
  const int ty = tile / ntx;
  const int tx = tile % ntx;
  const int lane = threadIdx.x % kTileW;
  const int sub0 = threadIdx.x / kTileW;  // 0..7
  const float px = (float)(tx * kTileW + lane) + 0.5f;
  float py[kPerThread];
  float bz[kPerThread], bu[kPerThread], bv[kPerThread], bw[kPerThread],
      bt[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    py[k] = (float)(ty * kTileH + sub0 + 8 * k) + 0.5f;
    bz[k] = -1.0f;
    bu[k] = 0.0f;
    bv[k] = 0.0f;
    bw[k] = 1.0f;
    bt[k] = -1.0f;
  }
  const int starts[3] = {sa[b], sb[b], gs[b]};
  const int lengths[3] = {la[b], lb[b], gl[b]};
  for (int s = 0; s < 3; ++s) {
    for (int off = 0; off < lengths[s]; off += window) {
      const int count = min(lengths[s] - off, window);
      const int first = starts[s] + off;
      // A segment outside the records is a fault of the caller: stop the
      // launch, which the next synchronize reports as an error.
      if (first < 0 || first + count > n_rows) __trap();
      __syncthreads();  // the previous slice's readers are done
      const float* src = recs + (size_t)first * kRecCols;
      for (int i = threadIdx.x; i < count * kRecCols; i += kThreads) {
        s_rec[i] = __ldg(src + i);
      }
      __syncthreads();
      float sz[kPerThread];
      int si[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        sz[k] = -1.0f;
        si[k] = -1;
      }
      for (int j = 0; j < count; ++j) {
        const float* r = s_rec + j * kRecCols;
        const int bmin = (int)r[kBmin];
        const int bmax = (int)r[kBmax];
        if (tx < bmin % 4096 || tx > bmax % 4096 || ty < bmin / 4096 ||
            ty > bmax / 4096) {
          continue;  // the same for the whole block
        }
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const float z = form(r + kZ, px, py[k]);
          const bool inside = form(r + kE0, px, py[k]) >= 0.0f &&
                              form(r + kE1, px, py[k]) >= 0.0f &&
                              form(r + kE2, px, py[k]) >= 0.0f &&
                              z > 0.0f && z <= 1.0f;
          if (inside && z >= sz[k]) {  // the last of the greatest z
            sz[k] = z;
            si[k] = j;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        if (si[k] >= 0 && sz[k] > bz[k]) {  // strictly greater: replace
          const float* r = s_rec + si[k] * kRecCols;
          bz[k] = sz[k];
          bu[k] = form(r + kFu, px, py[k]);
          bv[k] = form(r + kFv, px, py[k]);
          bw[k] = form(r + kFw, px, py[k]);
          bt[k] = r[kTri];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const size_t p = (size_t)b * kPx + (sub0 + 8 * k) * kTileW + lane;
    out_z[p] = bz[k];
    out_u[p] = bu[k];
    out_v[p] = bv[k];
    out_w[p] = bw[k];
    out_t[p] = bt[k];
  }
}

}  // namespace

extern "C" {

// Rasterize n subtiles (one block each) over the n_rows sorted records
// `recs` (n_rows x 24 f32), `window` (1..256) records a slice; every
// segment must lie inside the records (a block whose segment does not traps,
// and the next synchronize raises).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int steeljax_raster_tiles(const void* recs, const void* tile_ids,
                          const void* sa, const void* la, const void* sb,
                          const void* lb, const void* gs, const void* gl,
                          void* out_z, void* out_u, void* out_v, void* out_w,
                          void* out_t, int n_rows, int n, int ntx,
                          int window, void* stream) {
  if (recs == nullptr || tile_ids == nullptr || sa == nullptr ||
      la == nullptr || sb == nullptr || lb == nullptr || gs == nullptr ||
      gl == nullptr || out_z == nullptr || out_u == nullptr ||
      out_v == nullptr || out_w == nullptr || out_t == nullptr ||
      n < 0 || n_rows < 0 || ntx <= 0 || window < 1 ||
      window > kMaxWindow) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  raster_tiles_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)recs, (const int*)tile_ids, (const int*)sa,
      (const int*)la, (const int*)sb, (const int*)lb, (const int*)gs,
      (const int*)gl, (float*)out_z, (float*)out_u, (float*)out_v,
      (float*)out_w, (float*)out_t, n_rows, ntx, window);
  return (int)cudaGetLastError();
}

}  // extern "C"
