// Table layouts and per-candidate helpers shared by the BVH8 trace kernels
// (alpha8.cu: K1-K5; instanced8.cu: K6; treelet8.cu: K7).
//
// The reference's table formats, which the kernels read or derive theirs
// from (the 48-byte Hopper record table: alpha8.cu):
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
//     n1.xyz, n2.xyz, mat]; mode 2: record k at row (k / 12) * 3 + (k % 12)
//     / 4, floats (k % 4) * 26 .. +25 = [n0.xyz, n1.xyz, n2.xyz, mat,
//     t0.xyz, t1.xyz, t2.xyz, uv0.xy, uv1.xy, uv2.xy, uv_density]
//     (pallas_traverse.py:437-441, cuda_traverse.pack_shade_records).
//   With alpha masks float 9 of a triangle record is the AUX word ds |
//     mask << 1, an exact integer below 2^22 (cuda_traverse.pack_tris), and
//     fine (R, 128) int32 rows run parallel to the triangle rows: record k
//     at row k / 12, words (k % 12) * 10 .. +9 = 5 PASS words, 5 OPAQUE
//     words of the 153-cell fine grid (pack_fine_mask_rows).
//
// Arithmetic follows the reference kernel (pallas_traverse.py:303-305 slab
// reciprocal, :369-383 slab test, :468-490 Moller-Trumbore).  nvcc
// contracts a*b+c into FMA, so results may differ from the CPU version in
// the last bit.
#pragma once

#include <cuda_runtime.h>

#define LANES 128
#define TRI_PER_ROW 12
#define TRI_STRIDE 10
#define DENSE_PER_ROW 14
#define DENSE_STRIDE 9
#define SHADE1_STRIDE 10
#define SHADE2_STRIDE 26
#define SHADE2_PER_ROW 4
#define CHILD_STRIDE 16
#define SNODE_WIDTH 8
// Per-ray telemetry of the COUNT instances: supernode pops, triangle-row
// bodies, leaf pops, triangle tests, coarse mask tests, fine mask tests.
#define N_COUNTERS 6
// Per-thread stack capacity.  A pop removes one entry and pushes at most 8,
// so a tree of supernode depth D needs at most 7 * D + 1 entries; the host
// requires 8 * D + 16 <= MAX_STACK (the reference's bound,
// pallas_traverse.py:698).
#define MAX_STACK 256
// Alpha-coverage masks (accel/alphamask.py): the coarse grid of the AUX
// word and the fine two-plane grid of the parallel int32 rows, whose record
// j of a row holds FINE_WORDS PASS words, then FINE_WORDS OPAQUE words, at
// words [FINE_STRIDE * j, FINE_STRIDE * j + FINE_STRIDE).
#define MASK_GRID 6
#define FINE_GRID 17
#define FINE_WORDS 5
#define FINE_STRIDE 10

namespace steeljax {

constexpr float kDetEps = 1e-12f;

__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-12f ? (d < 0.0f ? -1e-12f : 1e-12f) : d);
}

// The grid cell of (u, v): the product cast toward zero, then clamped, as
// alphamask._cells does.  Called only for candidates inside the triangle,
// where u and v are finite.
__device__ __forceinline__ int grid_cell(float x, int grid) {
  return min(max(__float2int_rz(x * (float)grid), 0), grid - 1);
}

// alphamask.mask_test: keep the candidate unless its coarse cell's bit is
// 0; cells outside the triangular domain always keep.
__device__ __forceinline__ bool coarse_keep(int mask, float u, float v) {
  const int ci = grid_cell(u, MASK_GRID), cj = grid_cell(v, MASK_GRID);
  if (ci + cj > MASK_GRID - 1) return true;
  const int cell = cj * MASK_GRID + ci - ((cj * (cj - 1)) >> 1);
  return ((mask >> cell) & 1) != 0;
}

// alphamask.fine_mask_test for one record's words `w`: returns keep (the
// PASS bit, or true outside the domain); with OPAQUE also sets `opaque`
// (the OPAQUE bit, false outside the domain), which costs a second word.
template <bool OPAQUE>
__device__ __forceinline__ bool fine_keep(const int* w, float u, float v,
                                          bool* opaque) {
  const int ci = grid_cell(u, FINE_GRID), cj = grid_cell(v, FINE_GRID);
  if (ci + cj > FINE_GRID - 1) {
    if constexpr (OPAQUE) *opaque = false;
    return true;
  }
  const int cell = cj * FINE_GRID + ci - ((cj * (cj - 1)) >> 1);
  const int word = cell >> 5, bit = cell & 31;
  if constexpr (OPAQUE) {
    *opaque = ((__ldg(w + FINE_WORDS + word) >> bit) & 1) != 0;
  }
  return ((__ldg(w + word) >> bit) & 1) != 0;
}

// The reference reads ceil(max_leaf / per_row) rows per leaf.
inline int leaf_cap(int max_leaf, int per_row) {
  return (max_leaf + per_row - 1) / per_row * per_row;
}

}  // namespace steeljax
