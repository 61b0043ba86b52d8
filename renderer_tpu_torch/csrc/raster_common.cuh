// Shared pieces of the two raster kernels (raster_kernel.cu, layers.cu).
//
// Binned buffer layout (renderer_tpu_torch/raster/binning.py): f32
// [B_ROWS=16, pp] row-major; column j holds one (tile, triangle) pair:
// rows 0-8 edge planes (C with the watertightness eps folded in), 9-11 the
// depth plane, 12-14 the 1/w plane, 15 the triangle id as f32. A tile's bin
// is the contiguous column range [starts[t], starts[t] + counts[t]).
//
// Every plane is evaluated as (a*px + b*py) + c with explicitly rounded
// multiplies and adds (and the library is built with --fmad=false): a
// contracted FMA would round e' differently from the plain PyTorch version
// and move coverage on boundary samples where e' ≈ 0.
//
// Both kernels walk a tile's bin the same way (walk_bin):
// - Geometry. A block of 256 threads (8 warps) owns a 32P-column x 8-row
//   region of one tile: blockIdx.x picks the region, blockIdx.y the tile,
//   so the blocks of one tile are dispatched together. Each warp owns a
//   footprint of 8P columns x 4 rows; lane (lx, ly) = (lane & 7, lane >> 3)
//   owns pixels (lx + 8p, ly) for p < P with all of the block's samples, so
//   the b*py products of a sample are shared by the thread's P pixels.
// - Staging. The bin goes through shared memory CHUNK triangles at a time.
//   cp.async copies chunks i+1 .. i+STAGES-1 (16-byte pieces when the rows
//   are 16-byte aligned) while chunk i is walked. A short prepare pass then
//   turns each staged column into an 80-byte record (five float4: each
//   edge's a, b, c and its ownership threshold; the depth plane and the id;
//   the 1/w plane) read with five 16-byte broadcast loads instead of 16
//   scalar ones.
// - Choices. CHUNK = 128 gives the prepare pass two threads a triangle and
//   keeps a block's shared memory at 27 KB, so several blocks share an SM.
//   STAGES = 2: three or four buffers gained at most 4% on the most heavily
//   binned scene (renderer_tpu_torch/tools/k1_probe.py on the H100). The
//   8 x 4 footprint (P = 1) is K1's measured best; see raster_kernel.cu.
// - Exact footprint rejection. The prepare pass also tests every staged
//   triangle against every warp's footprint and leaves one bit per
//   (footprint, triangle). IEEE round-to-nearest is monotone in each
//   argument, so plane(a, b, c, X, Y) with X the footprint's largest sample
//   x where a > 0 and its smallest otherwise (Y likewise) is an upper bound
//   on the kernel's own rounded plane value at every sample of the
//   footprint. An edge bound < 0 means no sample is covered; a depth bound
//   (clamped to 1, the z <= 1 clip) below the smallest depth the footprint
//   compares against means no sample can change. Both compares are false
//   for NaN, so a NaN plane is never rejected. A warp then walks only its
//   set bits, in bin order: the decision is uniform across the warp and a
//   skipped triangle could not have changed any of its samples, so the
//   submission order of the ones that can is kept.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace rt {

constexpr int B_ROWS = 16;
constexpr int B_TID = 15;
constexpr int THREADS = 256;           // threads per block
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 128;             // triangles per staged chunk
constexpr int STAGES = 2;              // chunk buffers in flight
constexpr int REC = 5;                 // float4 per triangle record
constexpr int BLOCK_ROWS = 8;          // a block owns 32P columns x 8 rows
constexpr int MAX_SAMPLES = 8;
static_assert(THREADS == 2 * CHUNK, "prepare_chunk: two threads a triangle");

struct SamplePos {
  float x[MAX_SAMPLES];
  float y[MAX_SAMPLES];
};

struct Stage {
  float raw[STAGES][B_ROWS][CHUNK];  // bin columns as copied (SoA)
  float4 rec[CHUNK][REC];          // one record per staged triangle
  unsigned mask[WARPS][CHUNK / 32];  // bit j of mask[w][v]: triangle 32v+j
                                     // may touch warp w's footprint
  float4 box[WARPS];               // footprint samples: xmin, xmax, ymin, ymax
  float zmin[WARPS];               // lower bound of the depths compared against
};

__device__ __forceinline__ float plane(float a, float b, float c, float px,
                                       float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

// Top-left ownership folded into one compare: an owned edge covers e >= 0,
// which for any non-NaN float is e > -(smallest denormal); the library is
// built without flush-to-zero, so that compare is exact.
__device__ __forceinline__ float edge_threshold(float a, float b) {
  const bool own = (a > 0.0f) || ((a == 0.0f) && (b > 0.0f));
  return own ? __int_as_float(0x80000001) : 0.0f;
}

// Upper bound of plane(a, b, c, ·, ·) over the samples of footprint `f`.
__device__ __forceinline__ float plane_bound(float a, float b, float c,
                                             const float4& f) {
  return plane(a, b, c, a > 0.0f ? f.y : f.x, b > 0.0f ? f.w : f.z);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// Where this thread's pixels lie: tile-local column of pixel 0 (pixel p is
// at c + 8p) and row, the tile's global pixel origin, and the output offset
// of pixel 0 in an [Hp, Wp] plane.
struct Place {
  int c, r;
  float x0, y0;
  long long o;
};

template <int P>
__device__ __forceinline__ Place place(int tiles_x, int tile_h, int tile_w,
                                       int wp, int tile_row_offset,
                                       int row_stride) {
  const int tile = blockIdx.y;
  const int lty = tile / tiles_x;
  const int tx = tile - lty * tiles_x;
  const int gty = lty * row_stride + tile_row_offset;
  const int nbx = tile_w / (32 * P);
  const int by = blockIdx.x / nbx;
  const int bx = blockIdx.x - by * nbx;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  Place q;
  q.c = bx * 32 * P + (w & 3) * 8 * P + (lane & 7);
  q.r = by * BLOCK_ROWS + (w >> 2) * 4 + (lane >> 3);
  q.x0 = static_cast<float>(tx * tile_w);
  q.y0 = static_cast<float>(gty * tile_h);
  q.o = static_cast<long long>(lty * tile_h + q.r) * wp + tx * tile_w + q.c;
  return q;
}

// Sample coordinates of the thread's P pixels and TS samples (sample s0 + t),
// summed as (tile origin + in-pixel offset) + pixel index, the plain
// version's order; publishes the warp's footprint box.
template <int P, int TS>
__device__ __forceinline__ void sample_coords(Stage& st, const Place& q,
                                              const SamplePos& sp, int s0,
                                              float (&px)[P][TS],
                                              float (&py)[TS]) {
  float xlo = INFINITY, xhi = -INFINITY, ylo = INFINITY, yhi = -INFINITY;
#pragma unroll
  for (int t = 0; t < TS; ++t) {
    // selected arithmetically (exact: one term is 1 * x, the others + 0):
    // indexing the parameter at run time, or a select chain the compiler
    // turns back into an index, copies it to local memory
    float dx = 0.0f, dy = 0.0f;
#pragma unroll
    for (int j = 0; j < MAX_SAMPLES; ++j) {
      const float on = j == s0 + t ? 1.0f : 0.0f;
      dx = __fadd_rn(dx, __fmul_rn(on, sp.x[j]));
      dy = __fadd_rn(dy, __fmul_rn(on, sp.y[j]));
    }
    py[t] = __fadd_rn(__fadd_rn(q.y0, dy), static_cast<float>(q.r));
    ylo = fminf(ylo, py[t]);
    yhi = fmaxf(yhi, py[t]);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      px[p][t] = __fadd_rn(__fadd_rn(q.x0, dx), static_cast<float>(q.c + 8 * p));
      xlo = fminf(xlo, px[p][t]);
      xhi = fmaxf(xhi, px[p][t]);
    }
  }
  const float4 f = make_float4(warp_min(xlo), warp_max(xhi), warp_min(ylo),
                               warp_max(yhi));
  if ((threadIdx.x & 31) == 0) st.box[threadIdx.x >> 5] = f;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying bin columns [col0, col0 + n) of all 16 rows into raw[buf],
// as one commit group. Columns at or past `pp` are not copied;
// prepare_chunk never uses them.
__device__ __forceinline__ void issue_chunk(Stage& st, int buf,
                                            const float* __restrict__ binned,
                                            long long pp, long long col0, int n,
                                            bool vec) {
  if (vec) {
    for (int k = threadIdx.x; k < B_ROWS * CHUNK / 4; k += THREADS) {
      const int r = k / (CHUNK / 4);
      const int i = (k - r * (CHUNK / 4)) * 4;
      if (i < n && col0 + i < pp)
        cp_async16(&st.raw[buf][r][i], binned + r * pp + col0 + i);
    }
  } else {
    for (int k = threadIdx.x; k < B_ROWS * CHUNK; k += THREADS) {
      const int r = k / CHUNK;
      const int i = k - r * CHUNK;
      if (i < n && col0 + i < pp)
        cp_async4(&st.raw[buf][r][i], binned + r * pp + col0 + i);
    }
  }
  cp_async_commit();
}

// Records and footprint bits of the staged chunk in raw[buf]: thread t
// handles triangle t % CHUNK against footprints 4(t / CHUNK) .. +3.
__device__ __forceinline__ void prepare_chunk(Stage& st, int buf, long long pp,
                                              long long col0, int n) {
  const int i = threadIdx.x & (CHUNK - 1);
  const int half = threadIdx.x / CHUNK;
  float v[B_ROWS];
#pragma unroll
  for (int r = 0; r < B_ROWS; ++r) v[r] = st.raw[buf][r][i];
  const bool valid = i < n && col0 + i < pp;
  if (half == 0) {
    st.rec[i][0] = make_float4(v[0], v[1], v[2], edge_threshold(v[0], v[1]));
    st.rec[i][1] = make_float4(v[3], v[4], v[5], edge_threshold(v[3], v[4]));
    st.rec[i][2] = make_float4(v[6], v[7], v[8], edge_threshold(v[6], v[7]));
  } else {
    st.rec[i][3] = make_float4(v[9], v[10], v[11],
                               __int_as_float(static_cast<int>(v[B_TID])));
    st.rec[i][4] = make_float4(v[12], v[13], v[14], 0.0f);
  }
#pragma unroll
  for (int k = 0; k < WARPS / 2; ++k) {
    const int w = half * (WARPS / 2) + k;
    const float4 f = st.box[w];
    const bool keep = valid && !(plane_bound(v[0], v[1], v[2], f) < 0.0f) &&
                      !(plane_bound(v[3], v[4], v[5], f) < 0.0f) &&
                      !(plane_bound(v[6], v[7], v[8], f) < 0.0f) &&
                      !(fminf(plane_bound(v[9], v[10], v[11], f), 1.0f) <
                        st.zmin[w]);
    const unsigned bits = __ballot_sync(~0u, keep);
    if ((threadIdx.x & 31) == 0) st.mask[w][(threadIdx.x >> 5) & 3] = bits;
  }
}

// Walks the tile's bin [start, start + count): calls walk(record) for every
// triangle that may touch this warp's footprint, in bin order, and
// publish() after each chunk (where the warp refreshes st.zmin).
template <class Walk, class Publish>
__device__ __forceinline__ void walk_bin(Stage& st,
                                         const float* __restrict__ binned,
                                         long long pp, long long start,
                                         int count, Walk&& walk,
                                         Publish&& publish) {
  const bool vec = ((reinterpret_cast<uintptr_t>(binned) & 15) == 0) &&
                   (((start | pp) & 3) == 0);
  const int w = threadIdx.x >> 5;
  const int n_chunks = (count + CHUNK - 1) / CHUNK;
  // one commit group per chunk (empty past the end), so that waiting for
  // all but the newest STAGES - 2 groups waits for chunk ci
  auto issue = [&](int k) {
    if (k < n_chunks)
      issue_chunk(st, k % STAGES, binned, pp, start + k * CHUNK,
                  min(CHUNK, count - k * CHUNK), vec);
    else
      cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(k);
  for (int ci = 0; ci < n_chunks; ++ci) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk ci landed; the last walk and zmin are done
    issue(ci + STAGES - 1);  // into the buffer chunk ci - 1 was prepared from
    prepare_chunk(st, ci % STAGES, pp, start + ci * CHUNK,
                  min(CHUNK, count - ci * CHUNK));
    __syncthreads();
#pragma unroll 1
    for (int v = 0; v < CHUNK / 32; ++v) {
      unsigned m = st.mask[w][v];
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        walk(st.rec[v * 32 + j]);
      }
    }
    publish();
  }
}

}  // namespace rt
