// K1: opaque visibility raster over per-tile bins.
//
// Replaces the Pallas kernel renderer_tpu/raster/raster_kernel.py
// `_binned_kernel` (driven by `rasterize_binned`, pallas_call at :300).
//
// What it computes: for every sample of a tile_h x tile_w tile, the
// lexicographic (z, triangle id) max over the tile's binned triangles that
// cover the sample (three edge functions with top-left ownership, then the
// 1/w > 0 and z in [0, 1] clips). depth starts at 0.0 and id at -1. The
// merge is order-invariant, so the walk order over the bin is free.
//
// What bounds it on an H100: FP32 arithmetic. Densely, every binned
// triangle is tested at every sample of its 32x128 tile, five plane
// evaluations a test; a triangle covers tens of those 4,096 pixels, so most
// of that work is misses. The bin itself is 64 B per triangle, read from L2.
//
// Design (the walk is raster_common.cuh's walk_bin):
// - Each warp owns an 8P x 4-pixel footprint with all S samples; a
//   triangle that cannot touch a footprint, or whose depth bound lies below
//   the footprint's smallest stored depth, is skipped by the whole warp.
//   That depth skip is the TPU kernel's early-depth sub-chunk skip, per
//   warp: the stored depths only grow, so the bound refreshed once a chunk
//   is stale on the safe side, and the opaque bins arrive nearest first.
// - One pixel a thread (P = 1) with its S samples: the footprint stays
//   8 x 4 pixels at every S. Wider footprints (P = 2, 4) share each
//   triangle record among more tests but keep far more blocks; measured by
//   renderer_tpu_torch/tools/k1_probe.py on the H100, P = 4 took 3x as long
//   as P = 1 on the 1M-triangle scene at S = 1 (tests kept 0.168 vs 0.024)
//   and P = 1 was fastest at S = 4 too. A test is 10 un-contracted
//   multiply/adds + 6 compares + the (z, id) merge, with the ownership
//   flags folded into per-edge thresholds once per triangle and the
//   triangle record read with five 16-byte broadcast loads.
// - The (z, id) state never leaves registers until the final store.
#include "raster_common.cuh"

namespace rt {

template <int S, int P>
__global__ void __launch_bounds__(THREADS)
binned_kernel(const float* __restrict__ binned, long long pp,
              const int* __restrict__ starts, const int* __restrict__ counts,
              float* __restrict__ depth_out, int* __restrict__ tid_out,
              int tiles_x, int tile_h, int tile_w, int hp, int wp,
              int tile_row_offset, int row_stride, SamplePos sp) {
  __shared__ Stage st;
  const Place q = place<P>(tiles_x, tile_h, tile_w, wp, tile_row_offset,
                           row_stride);
  float px[P][S], py[S], d[P][S];
  int id[P][S];
  sample_coords<P, S>(st, q, sp, 0, px, py);
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      d[p][s] = 0.0f;
      id[p][s] = -1;
    }
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) st.zmin[w] = 0.0f;

  auto walk = [&](const float4* rec) {
    const float4 e0 = rec[0], e1 = rec[1], e2 = rec[2], zq = rec[3],
                 wq = rec[4];
    const int t = __float_as_int(zq.w);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float y = py[s];
      const float b0 = __fmul_rn(e0.y, y), b1 = __fmul_rn(e1.y, y),
                  b2 = __fmul_rn(e2.y, y), bz = __fmul_rn(zq.y, y),
                  bw = __fmul_rn(wq.y, y);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float x = px[p][s];
        const float f0 = __fadd_rn(__fadd_rn(__fmul_rn(e0.x, x), b0), e0.z);
        const float f1 = __fadd_rn(__fadd_rn(__fmul_rn(e1.x, x), b1), e1.z);
        const float f2 = __fadd_rn(__fadd_rn(__fmul_rn(e2.x, x), b2), e2.z);
        const float z = __fadd_rn(__fadd_rn(__fmul_rn(zq.x, x), bz), zq.z);
        const float iw = __fadd_rn(__fadd_rn(__fmul_rn(wq.x, x), bw), wq.z);
        const bool win = (f0 > e0.w) & (f1 > e1.w) & (f2 > e2.w) &
                         (iw > 0.0f) & (z >= 0.0f) & (z <= 1.0f) &
                         ((z > d[p][s]) | ((z == d[p][s]) & (t > id[p][s])));
        d[p][s] = win ? z : d[p][s];
        id[p][s] = win ? t : id[p][s];
      }
    }
  };
  auto publish = [&]() {
    float m = d[0][0];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int s = 0; s < S; ++s) m = fminf(m, d[p][s]);
    }
    m = warp_min(m);
    if ((threadIdx.x & 31) == 0) st.zmin[w] = m;
  };
  walk_bin(st, binned, pp, starts[blockIdx.y], counts[blockIdx.y], walk,
           publish);

  const long long plane_px = static_cast<long long>(hp) * wp;
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      depth_out[s * plane_px + q.o + 8 * p] = d[p][s];
      tid_out[s * plane_px + q.o + 8 * p] = id[p][s];
    }
  }
}

template <int S, int P>
cudaError_t launch_binned(const float* binned, long long pp, const int* starts,
                          const int* counts, float* depth, int* tid,
                          int n_tiles, int tiles_x, int tile_h, int tile_w,
                          int hp, int wp, int tile_row_offset, int row_stride,
                          const SamplePos& sp, cudaStream_t stream) {
  if (tile_w % (32 * P) != 0 || tile_h % BLOCK_ROWS != 0 || n_tiles > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((tile_w / (32 * P)) * (tile_h / BLOCK_ROWS), n_tiles);
  binned_kernel<S, P><<<grid, THREADS, 0, stream>>>(
      binned, pp, starts, counts, depth, tid, tiles_x, tile_h, tile_w, hp, wp,
      tile_row_offset, row_stride, sp);
  return cudaGetLastError();
}

}  // namespace rt

extern "C" int rt_rasterize_binned(const float* binned, long long pp,
                                   const int* starts, const int* counts,
                                   float* depth, int* tid, int n_tiles,
                                   int tiles_x, int tile_h, int tile_w, int hp,
                                   int wp, int tile_row_offset, int row_stride,
                                   int n_s, const float* sample_xy,
                                   void* stream) {
  if (n_tiles <= 0) return 0;
  rt::SamplePos sp = {};
  for (int s = 0; s < n_s && s < rt::MAX_SAMPLES; ++s) {
    sp.x[s] = sample_xy[2 * s];
    sp.y[s] = sample_xy[2 * s + 1];
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch (n_s) {
#define RT_CASE(S, P)                                                         \
  case S:                                                                     \
    return rt::launch_binned<S, P>(binned, pp, starts, counts, depth, tid,    \
                                   n_tiles, tiles_x, tile_h, tile_w, hp, wp,  \
                                   tile_row_offset, row_stride, sp, st);
    RT_CASE(1, 1)
    RT_CASE(2, 1)
    RT_CASE(4, 1)
    RT_CASE(8, 1)
#undef RT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
