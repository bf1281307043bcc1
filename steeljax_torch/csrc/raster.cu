// Rasterized primary visibility for Hopper (sm_90a): the raster stage of
// the hybrid G-buffer, one thread block per 32x24-pixel subtile.
//
// R replaces no TPU kernel.  The reference computes this stage in plain
// jnp outside Pallas (steeljax/render/hybrid/raster.py: _raster_tiles,
// :306, a lax.map over subtiles, each a fori_loop of (768, 3) @ (3, 7 *
// WINDOW) products); the port needs a kernel for it because the stage's
// loop trip counts are data-dependent and a host loop would read them.  The
// plain PyTorch version is render/hybrid/raster.py: _raster_tiles_plain,
// which this kernel matches bit for bit.
//
// Inputs (render/hybrid/raster.py: _binned):
//   recs (P, 24) f32, 16-byte aligned: the piece records sorted by bin key,
//     per record the (a, b, c) of the forms E0, E1, E2, Fw, Fu, Fv, Z (each
//     a*sx + b*sy + c at a pixel centre), the triangle id, and the subtile
//     bbox as tx0 + 4096 * ty0 and tx1 + 4096 * ty1;
//   tile_ids (n,) i32: the subtile of each output row (ty * ntx + tx);
//   order (n,) i32: a permutation of the rows; block b rasterizes row
//     order[b] (the wrapper passes the rows by descending local density);
//   sa, la, sb, lb, gs, gl (n,) i32: the row's three candidate segments in
//     the records, walked in this order: the row above (columns tx - 1 ..
//     tx), its own row (the same columns), then the global "big" segment.
// Outputs, (n, 768) f32 each, pixel p = sub * 32 + lane: bz (the winner's
// reverse z, -1 where no piece covers the pixel), fu, fv, fw (0, 0, 1 on a
// miss) and ft (the triangle id, -1 on a miss).
//
// The tie rule is the reference's: each segment is taken in `window`-piece
// slices; within a slice the LAST piece of the greatest z wins (the
// reference's si = max(index)); a later slice replaces the running winner
// only on a strictly greater z.  Every form is (a * px + b * py) + c with
// each operation rounded on its own (__fmul_rn, __fadd_rn: no contraction
// into a fused multiply-add), the plain version's order, so the two agree
// exactly.  Tensor cores cannot help: a TF32 wgmma product would round the
// products otherwise, and the forms are compared for exact equality.
//
// What bounds it on this card: each block reads its candidate records and
// writes 768 x 20 bytes; each pixel evaluates four forms and a few
// comparisons for every candidate that covers its subtile.  At path R's
// 2,700 subtiles the second dominates (chip_smoke.py phase 17 prints the
// bound, by fp32 operations on CUDA cores; the forms cannot fuse into
// multiply-adds, so they run at half the fused rate).  The design, step by
// step:
//
//  1. One pass with a slice tag.  Each candidate carries a tag: its
//     segment's base (the slices of the segments before it), plus off /
//     window, its slice within the segment, so tags do not decrease in
//     walk order and two candidates share a tag exactly when they share a
//     slice.  Each pixel keeps (bz, btag, brow), from (-1, -1, -1).  A
//     candidate inside the pixel at depth z (inside means z > 0) wins if
//     z > bz, or if z == bz and its tag == btag.
//     Proof that this is the slice loop: bz is the running maximum of the
//     inside depths, in both.  The slice loop's winner comes from the first
//     slice S whose own maximum equals the final bz (a later slice with an
//     equal maximum is not strictly greater), and within S it is the last
//     candidate of that depth.  In the one pass, the first candidate of
//     depth bz sits in S (no earlier slice reached it) and wins by z > bz,
//     setting btag = tag(S); every later candidate of S at that depth wins
//     by the equal tag; a candidate of a later slice at that depth has
//     another tag and loses; no candidate is deeper.  So both end on the
//     last candidate of depth bz in S.  The slices therefore bind only the
//     tags: the kernel may cull, stage and walk candidates in chunks of any
//     size, as long as it keeps their order.
//     The one pass is also the greatest (z, -tag, row) among the inside
//     candidates (at equal z the earliest slice, and in it the last row,
//     rows growing within a slice), a maximum that can be taken over parts
//     of the candidates and then over the parts (step 6).
//  2. Cull before staging, in order.  A chunk is 512 candidates, one a
//     thread: each thread tests its candidate's two bbox words (8 bytes)
//     against the subtile.  The covering candidates are compacted in walk
//     order (a warp ballot and popc, then an exclusive scan of the 16
//     warps' counts) into a shared list of (row, tag), and only those
//     records are copied, so a non-covering candidate costs 8 bytes and no
//     walk step.  A staged record holds the 12 floats the walk reads (E0,
//     E1, E2, Z: two 16-byte and four 4-byte pieces, 48 bytes); the
//     winner's Fu, Fv, Fw and triangle are read once (step 5).
//  3. Copies overlap the walk.  Two record buffers and two slots of bbox
//     words in shared memory, filled with cp.async: chunk k + 1's bbox
//     test, compaction and record copies, and chunk k + 2's bbox words,
//     are started before chunk k is walked; one barrier a chunk separates
//     them (each thread's cp.async.wait_group 1, leaving its newest group
//     in flight, then __syncthreads).  cp.async over cp.async.bulk: a
//     row's walk columns are 48 bytes in three runs, below the bulk copy's
//     16-byte-multiple runs and its mbarrier bookkeeping per row, and the
//     rows are a gather, which a TMA tensor map does not describe.
//  4. Cull per strip.  Warps w and w + 8 own rows 3 (w % 8) .. 3 (w % 8) +
//     2 of the subtile (lane = column), a 32x3 strip.  A warp tests 32
//     staged records at once, one a lane, each edge form at the strip's
//     corner pixel centre where that form is largest (picked by the signs
//     of a and b), evaluated as the pixels evaluate it, and skips a record
//     whose edge is below 0 there.  A correctly rounded product or sum is
//     monotone in each operand, so (a*px + b*py) + c, rounded step by
//     step, is at any pixel centre of the strip at most its value at that
//     corner, and no pixel of the strip is inside a skipped record: no
//     margin is needed (render/hybrid/raster.py: corner_max and
//     strip_rejects, held on random, large and near-zero forms by
//     tests/test_torch_raster.py).  A form that overflows gives inf or NaN
//     at the corner, which skips nothing.  The kept records are evaluated
//     exactly as before, in order (the ballot's bits from the lowest),
//     every form and comparison of a pixel without a branch.
//  5. The winner's Fu, Fv and Fw once, at the end, from row brow in device
//     memory with the same form: bit-equal to evaluating them whenever the
//     winner changes.
//  6. Density order and two warps a strip.  Blocks take the rows densest
//     first (order), so the dense subtiles start in the first wave; and the
//     two warps of a strip take its chunk's staged records 32 at a time in
//     turn, each keeping its own (bz, btag, brow), so a dense subtile's
//     walk is spread over 16 warps; at the end warp w + 8 hands its states
//     through shared memory to warp w, which keeps the greater (z, -tag,
//     row) of the two (step 1).  With one warp a strip the densest
//     subtile's block set the launch's length; a third warp gains nothing
//     more on path R (the SM's instruction rate binds) and costs resident
//     blocks.  __launch_bounds__ asks for 3 resident blocks of 512 threads
//     an SM (40 registers; 64.1 KB of shared memory each); the row, the
//     subtile and the segments live in shared memory to stay in 40
//     registers without a spill.
//
// No host read: the trip counts are the segment lengths, read by the block
// itself, so the frame keeps no host synchronization.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 24;
constexpr int kPx = kTileW * kTileH;
constexpr int kRecCols = 24;
constexpr int kRows = 3;                 // rows a strip
constexpr int kStrips = kTileH / kRows;  // 8 strips a subtile
constexpr int kShares = 2;               // warps a strip
constexpr int kWarps = kStrips * kShares;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = kThreads;  // candidates a chunk, one a thread
constexpr int kSlot = 12;         // floats a staged record: E0 E1 E2 Z
constexpr int kMinBlocks = 6 / kShares;  // 48 resident warps an SM
// Dynamic shared memory: two record buffers, two (row, tag) lists, two
// chunks of bbox words and two rows of warp counts.
constexpr int kRecBytes = 2 * kChunk * kSlot * 4;
constexpr int kSmemBytes = kRecBytes + 4 * kChunk * 4 + 2 * kChunk * 8 +
                           2 * kWarps * 4;
static_assert((kShares - 1) * kPx * 12 <= kRecBytes,
              "the shares' states fit in the record buffers");
// Record columns (render/hybrid/raster.py).
constexpr int kE0 = 0, kE1 = 3, kE2 = 6, kFw = 9, kFu = 12, kFv = 15,
              kZ = 18, kTri = 21, kBmin = 22;

__device__ __forceinline__ float form(const float* r, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], px), __fmul_rn(r[1], py)),
                   r[2]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async8(float2* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

// Wait until at most `n` of this thread's copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Form e (a, b, c) at the strip's corner where it is largest, evaluated as
// the pixels evaluate it: no pixel centre of the strip evaluates it larger
// (render/hybrid/raster.py: corner_max).
__device__ __forceinline__ float corner_max(const float* e, float x_lo,
                                            float x_hi, float y_lo,
                                            float y_hi) {
  return form(e, e[0] >= 0.0f ? x_hi : x_lo, e[1] >= 0.0f ? y_hi : y_lo);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) raster_tiles_kernel(
    const float* __restrict__ recs, const int* __restrict__ tile_ids,
    const int* __restrict__ order, const int* __restrict__ sa,
    const int* __restrict__ la, const int* __restrict__ sb,
    const int* __restrict__ lb, const int* __restrict__ gs,
    const int* __restrict__ gl, float* __restrict__ out_z,
    float* __restrict__ out_u, float* __restrict__ out_v,
    float* __restrict__ out_w, float* __restrict__ out_t, int n_rows,
    int ntx, int window) {
  extern __shared__ __align__(16) float smem[];
  float* const s_rec = smem;                                  // [2][kChunk]
  int* const s_row = reinterpret_cast<int*>(smem + 2 * kChunk * kSlot);
  int* const s_tag = s_row + 2 * kChunk;                      // [2][kChunk]
  float2* const s_bb = reinterpret_cast<float2*>(s_tag + 2 * kChunk);
  int* const s_count = reinterpret_cast<int*>(s_bb + 2 * kChunk);

  // The block's row, subtile and segments, read and checked once by one
  // thread and kept in shared memory (registers are the scarcer): a
  // segment outside the records is a fault of the caller, and the trap
  // makes the next synchronize raise.  s_seg: the three starts, the walk's
  // ends of segments 0 and 1 and its total, the slice tags' bases of
  // segments 1 and 2, then tx, ty and the row.
  __shared__ int s_seg[11];
  if (threadIdx.x == 0) {
    const int r = order[blockIdx.x];
    const int tile = tile_ids[r];
    s_seg[8] = tile % ntx;
    s_seg[9] = tile / ntx;
    s_seg[10] = r;
    const int start[3] = {sa[r], sb[r], gs[r]};
    const int len[3] = {max(la[r], 0), max(lb[r], 0), max(gl[r], 0)};
    for (int s = 0; s < 3; ++s) {
      if (len[s] > 0 &&
          (start[s] < 0 || (long long)start[s] + len[s] > n_rows)) {
        __trap();
      }
      s_seg[s] = start[s];
    }
    s_seg[3] = len[0];
    s_seg[4] = len[0] + len[1];
    s_seg[5] = len[0] + len[1] + len[2];
    s_seg[6] = (len[0] + window - 1) / window;
    s_seg[7] = s_seg[6] + (len[1] + window - 1) / window;
  }
  __syncthreads();
  const int n_chunks = (s_seg[5] + kChunk - 1) / kChunk;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int share = warp / kStrips;
  const int row0 = (warp % kStrips) * kRows;
  const float px = (float)(s_seg[8] * kTileW + lane) + 0.5f;
  const float y_lo = (float)(s_seg[9] * kTileH + row0) + 0.5f;  // strip top
  float bz[kRows];
  int btag[kRows], brow[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    bz[q] = -1.0f;
    btag[q] = -1;
    brow[q] = -1;
  }

  // Candidate g of the walk: its record row and slice tag (-1: none).
  auto locate = [&](int g, int& row, int& tag) {
    if (g >= s_seg[5]) {
      row = -1;
      tag = -1;
    } else if (g < s_seg[3]) {
      row = s_seg[0] + g;
      tag = g / window;
    } else if (g < s_seg[4]) {
      row = s_seg[1] + (g - s_seg[3]);
      tag = s_seg[6] + (g - s_seg[3]) / window;
    } else {
      row = s_seg[2] + (g - s_seg[4]);
      tag = s_seg[7] + (g - s_seg[4]) / window;
    }
  };
  // Request candidate g's bbox words into slot `buf` of this thread.
  auto fetch = [&](int g, int buf) {
    int row, tag;
    locate(g, row, tag);
    if (row >= 0) {
      cp_async8(s_bb + buf * kChunk + threadIdx.x,
                recs + (size_t)row * kRecCols + kBmin);
    }
    cp_async_commit();
  };
  // Whether candidate g, its bbox words in slot `buf`, covers the subtile.
  auto covers = [&](int g, int buf, int& row, int& tag) {
    locate(g, row, tag);
    if (row < 0) return false;
    const float2 bb = s_bb[buf * kChunk + threadIdx.x];
    const int bmin = (int)bb.x;
    const int bmax = (int)bb.y;
    const int tx = s_seg[8], ty = s_seg[9];
    return tx >= bmin % 4096 && tx <= bmax % 4096 && ty >= bmin / 4096 &&
           ty <= bmax / 4096;
  };
  // Stage the covering candidate (row, tag) of chunk buffer `buf`: its
  // place in walk order from the warps' counts, then its walk columns.
  auto stage = [&](int buf, unsigned mask, int row, int tag) {
    int before = 0, count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[buf * kWarps + w];
      before += w < warp ? c : 0;
      count += c;
    }
    if (row >= 0 && (mask >> lane) & 1u) {
      const int pos = before + __popc(mask & ((1u << lane) - 1u));
      s_row[buf * kChunk + pos] = row;
      s_tag[buf * kChunk + pos] = tag;
      const float* src = recs + (size_t)row * kRecCols;
      float* dst = s_rec + (buf * kChunk + pos) * kSlot;
      cp_async16(dst, src + kE0);      // E0, E1.a
      cp_async16(dst + 4, src + 4);    // E1.b, E1.c, E2.a, E2.b
      cp_async4(dst + 8, src + 8);     // E2.c
      cp_async4(dst + 9, src + kZ);    // Z
      cp_async4(dst + 10, src + kZ + 1);
      cp_async4(dst + 11, src + kZ + 2);
    }
    cp_async_commit();
    return count;
  };

  // Chunk 0 staged, chunk 1's bbox words in flight.  A thread reads only
  // the bbox words it copied, so its own waits order them; each wait
  // leaves the newest group (the next bbox words or the next records) in
  // flight.
  fetch(threadIdx.x, 0);
  fetch(kChunk + threadIdx.x, 1);
  cp_async_wait<1>();
  int row_n, tag_n;
  bool cov = covers(threadIdx.x, 0, row_n, tag_n);
  unsigned mask = __ballot_sync(0xffffffffu, cov);
  if (lane == 0) s_count[warp] = __popc(mask);
  __syncthreads();
  int n_cur = stage(0, mask, cov ? row_n : -1, tag_n);

  for (int k = 0; k < n_chunks; ++k) {
    const int cur = k & 1, nxt = cur ^ 1;
    // Chunk k + 1: its bbox test and warp counts; chunk k + 2's bbox
    // words requested into the slot chunk k's used.
    cp_async_wait<1>();
    cov = covers((k + 1) * kChunk + threadIdx.x, nxt, row_n, tag_n);
    mask = __ballot_sync(0xffffffffu, cov);
    if (lane == 0) s_count[nxt * kWarps + warp] = __popc(mask);
    fetch((k + 2) * kChunk + threadIdx.x, cur);
    // Chunk k's records have landed and chunk k - 1's walk is done.
    cp_async_wait<1>();
    __syncthreads();
    stage(nxt, mask, cov ? row_n : -1, tag_n);

    // Walk chunk k: this warp's share of its strip's records, 32 staged
    // records a step (one strip test a lane), every kShares-th step.
    const float* buf = s_rec + cur * kChunk * kSlot;
    for (int base = share * 32; base < n_cur; base += 32 * kShares) {
      bool live = false;
      if (base + lane < n_cur) {
        // The strip's corner pixel centres (exact in float32).
        const float x_lo = px - (float)lane, x_hi = x_lo + (kTileW - 1);
        const float y_hi = y_lo + (kRows - 1);
        const float* e = buf + (base + lane) * kSlot;
        live = !(corner_max(e, x_lo, x_hi, y_lo, y_hi) < 0.0f ||
                 corner_max(e + 3, x_lo, x_hi, y_lo, y_hi) < 0.0f ||
                 corner_max(e + 6, x_lo, x_hi, y_lo, y_hi) < 0.0f);
      }
      unsigned todo = __ballot_sync(0xffffffffu, live);
      while (todo) {
        const int i = base + __ffs(todo) - 1;
        todo &= todo - 1u;
        const float4* s4 = reinterpret_cast<const float4*>(buf + i * kSlot);
        const float4 q0 = s4[0], q1 = s4[1], q2 = s4[2];
        const float e0[3] = {q0.x, q0.y, q0.z};
        const float e1[3] = {q0.w, q1.x, q1.y};
        const float e2[3] = {q1.z, q1.w, q2.x};
        const float ez[3] = {q2.y, q2.z, q2.w};
        const int tag = s_tag[cur * kChunk + i];
        const int row = s_row[cur * kChunk + i];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          const float py = y_lo + (float)q;
          const float z = form(ez, px, py);
          // Every form evaluated, no branch: the same result.
          const bool take = (form(e0, px, py) >= 0.0f) &
                            (form(e1, px, py) >= 0.0f) &
                            (form(e2, px, py) >= 0.0f) & (z > 0.0f) &
                            (z <= 1.0f) &
                            ((z > bz[q]) | ((z == bz[q]) & (tag == btag[q])));
          bz[q] = take ? z : bz[q];
          btag[q] = take ? tag : btag[q];
          brow[q] = take ? row : brow[q];
        }
      }
    }
    n_cur = 0;  // chunk k + 1's covering count
#pragma unroll
    for (int w = 0; w < kWarps; ++w) n_cur += s_count[nxt * kWarps + w];
  }

  // The shares of a strip walked disjoint parts of its records in order;
  // each holds the greatest (z, -tag, row) of its part, and share 0 takes
  // the greatest of all (render/hybrid/raster.py, step 3 of the module's
  // docstring).  The record buffers hold the other shares' states.
  if (kShares > 1) {
    cp_async_wait<0>();
    __syncthreads();
    int* const m_tag = reinterpret_cast<int*>(smem) + (kShares - 1) * kPx;
    int* const m_row = m_tag + (kShares - 1) * kPx;
    if (share > 0) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int o = (share - 1) * kPx + (row0 + q) * kTileW + lane;
        smem[o] = bz[q];
        m_tag[o] = btag[q];
        m_row[o] = brow[q];
      }
    }
    __syncthreads();
    if (share > 0) return;
    for (int s = 0; s < kShares - 1; ++s) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int o = s * kPx + (row0 + q) * kTileW + lane;
        const float z = smem[o];
        const int tag = m_tag[o], row = m_row[o];
        if (z > bz[q] || (z == bz[q] && (tag < btag[q] ||
                                         (tag == btag[q] && row > brow[q])))) {
          bz[q] = z;
          btag[q] = tag;
          brow[q] = row;
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const float py = y_lo + (float)q;
    const size_t p = (size_t)s_seg[10] * kPx + (row0 + q) * kTileW + lane;
    float u = 0.0f, v = 0.0f, w = 1.0f, t = -1.0f;
    if (brow[q] >= 0) {
      const float* wr = recs + (size_t)brow[q] * kRecCols;
      u = form(wr + kFu, px, py);
      v = form(wr + kFv, px, py);
      w = form(wr + kFw, px, py);
      t = wr[kTri];
    }
    out_z[p] = bz[q];
    out_u[p] = u;
    out_v[p] = v;
    out_w[p] = w;
    out_t[p] = t;
  }
}

}  // namespace

extern "C" {

// Rasterize n subtiles (one block each, row order[b] for block b) over the
// n_rows sorted records `recs` (n_rows x 24 f32, 16-byte aligned), the
// tie rule's slices `window` (>= 1) records long; every segment must lie
// inside the records (a block whose segment does not traps, and the next
// synchronize raises).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
int steeljax_raster_tiles(const void* recs, const void* tile_ids,
                          const void* order, const void* sa, const void* la,
                          const void* sb, const void* lb, const void* gs,
                          const void* gl, void* out_z, void* out_u,
                          void* out_v, void* out_w, void* out_t, int n_rows,
                          int n, int ntx, int window, void* stream) {
  if (recs == nullptr || tile_ids == nullptr || order == nullptr ||
      sa == nullptr || la == nullptr || sb == nullptr || lb == nullptr ||
      gs == nullptr || gl == nullptr || out_z == nullptr ||
      out_u == nullptr || out_v == nullptr || out_w == nullptr ||
      out_t == nullptr || n < 0 || n_rows < 0 || ntx <= 0 || window < 1 ||
      ((size_t)recs & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  const cudaError_t set = cudaFuncSetAttribute(
      raster_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (set != cudaSuccess) return (int)set;
  raster_tiles_kernel<<<n, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)recs, (const int*)tile_ids, (const int*)order,
      (const int*)sa, (const int*)la, (const int*)sb, (const int*)lb,
      (const int*)gs, (const int*)gl, (float*)out_z, (float*)out_u,
      (float*)out_v, (float*)out_w, (float*)out_t, n_rows, ntx, window);
  return (int)cudaGetLastError();
}

}  // extern "C"
