// K2: layered capture for masked (alpha-cutoff) and blended geometry.
//
// Replaces the Pallas kernel renderer_tpu/raster/layers.py
// `_make_layer_kernel` (driven by `rasterize_layers`, pallas_call at :228).
//
// What it computes, per sample, walking the tile's bin strictly in
// submission order (c = the triangle covers the sample and z >= cur_z):
// - masked: top-K nearest insertion of (z, id) above the opaque floor
//   (cur_z = depth_in, constant), `>=` on ties so a later submission sorts
//   first; aux counts the candidates.
// - blended: ordered accept against the running chain depth cur_z (starts
//   at depth_in). The n-th accept is stored in layer n while n < K, and only
//   a stored fragment writes cur_z; aux counts every accept.
// Layers start at (z, id) = (-1, -1).
//
// What bounds it on an H100: FP32 arithmetic of the coverage tests (every
// binned triangle at every sample of its 32x128 tile, five plane
// evaluations a test), then the K-step insertion of the tests that pass.
// With one test a thread, the 16 scalar shared loads of each triangle
// bounded it instead.
//
// Design (the walk is raster_common.cuh's walk_bin):
// - Register blocking: a thread owns TS samples of P pixels, T = TS x P
//   tests, with their K layers, cur_z and aux in registers; each triangle
//   record (five 16-byte broadcast loads) serves all T. T is picked from K
//   so that K x T layers stay in registers without spilling: T = 8 for
//   K <= 2, 4 for K <= 8, 2 for K = 16. TS = min(S, T); a block covers
//   TS of the S samples (blockIdx.z picks which), P = T / TS up to 4.
// - Layer arrays are sized by KC, the layer count rounded up to a power of
//   two (1..16), and the runtime count k <= KC is honoured exactly: masked
//   insertion over KC slots leaves the first k identical to a k-slot list
//   (entries only sink), and blended stores / moves cur_z only while
//   aux < k. Only the first k layers are written out.
// - Exact footprint rejection per warp against the smallest cur_z of the
//   footprint (constant for masked; for blended it only grows, so the
//   value refreshed once a chunk is stale on the safe side). Skipped
//   triangles cannot change any sample, so the submission order of the
//   rest is kept.
#include "raster_common.cuh"

namespace rt {

// Two blocks an SM (at most 128 registers) hold every layer count up to 8
// without spilling; at 16 layers that cap spills (ptxas -v), so one.
template <int KC, int TS, int P, bool MASKED>
__global__ void __launch_bounds__(THREADS, KC < 16 ? 2 : 1)
layer_kernel(const float* __restrict__ binned, long long pp,
             const int* __restrict__ starts, const int* __restrict__ counts,
             const float* __restrict__ depth_in, float* __restrict__ lz_out,
             int* __restrict__ lt_out, int* __restrict__ aux_out, int k_rt,
             int tiles_x, int tile_h, int tile_w, int hp, int wp,
             int tile_row_offset, int row_stride, SamplePos sp) {
  __shared__ Stage st;
  const Place q = place<P>(tiles_x, tile_h, tile_w, wp, tile_row_offset,
                           row_stride);
  const int s0 = blockIdx.z * TS;
  const long long plane_px = static_cast<long long>(hp) * wp;
  float px[P][TS], py[TS], cz[P][TS], lz[P][TS][KC];
  int lt[P][TS][KC], aux[P][TS];
  sample_coords<P, TS>(st, q, sp, s0, px, py);
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int t = 0; t < TS; ++t) {
      cz[p][t] = depth_in[(s0 + t) * plane_px + q.o + 8 * p];
      aux[p][t] = 0;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        lz[p][t][k] = -1.0f;
        lt[p][t][k] = -1;
      }
    }
  }
  const int w = threadIdx.x >> 5;
  auto publish = [&]() {
    float m = cz[0][0];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int t = 0; t < TS; ++t) m = fminf(m, cz[p][t]);
    }
    m = warp_min(m);
    if ((threadIdx.x & 31) == 0) st.zmin[w] = m;
  };
  publish();

  auto walk = [&](const float4* rec) {
    const float4 e0 = rec[0], e1 = rec[1], e2 = rec[2], zq = rec[3],
                 wq = rec[4];
    const int id = __float_as_int(zq.w);
#pragma unroll
    for (int t = 0; t < TS; ++t) {
      const float y = py[t];
      const float b0 = __fmul_rn(e0.y, y), b1 = __fmul_rn(e1.y, y),
                  b2 = __fmul_rn(e2.y, y), bz = __fmul_rn(zq.y, y),
                  bw = __fmul_rn(wq.y, y);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float x = px[p][t];
        const float f0 = __fadd_rn(__fadd_rn(__fmul_rn(e0.x, x), b0), e0.z);
        const float f1 = __fadd_rn(__fadd_rn(__fmul_rn(e1.x, x), b1), e1.z);
        const float f2 = __fadd_rn(__fadd_rn(__fmul_rn(e2.x, x), b2), e2.z);
        const float z = __fadd_rn(__fadd_rn(__fmul_rn(zq.x, x), bz), zq.z);
        const float iw = __fadd_rn(__fadd_rn(__fmul_rn(wq.x, x), bw), wq.z);
        const bool c = (f0 > e0.w) & (f1 > e1.w) & (f2 > e2.w) & (iw > 0.0f) &
                       (z >= 0.0f) & (z <= 1.0f) & (z >= cz[p][t]);
        if (c) {
          if (MASKED) {
            // insertion: the candidate sinks past every layer at least as
            // near (layers hold z >= 0 or the empty -1)
            float vz = z;
            int vt = id;
#pragma unroll
            for (int k = 0; k < KC; ++k) {
              const bool sw = vz >= lz[p][t][k];
              const float oz = lz[p][t][k];
              const int ot = lt[p][t][k];
              lz[p][t][k] = sw ? vz : oz;
              lt[p][t][k] = sw ? vt : ot;
              vz = sw ? oz : vz;
              vt = sw ? ot : vt;
            }
          } else {
#pragma unroll
            for (int k = 0; k < KC; ++k) {
              if (aux[p][t] == k) {
                lz[p][t][k] = z;
                lt[p][t][k] = id;
              }
            }
            if (aux[p][t] < k_rt) cz[p][t] = z;
          }
          ++aux[p][t];
        }
      }
    }
  };
  auto refresh = [&]() {
    if (!MASKED) publish();
  };
  walk_bin(st, binned, pp, starts[blockIdx.y], counts[blockIdx.y], walk,
           refresh);

#pragma unroll
  for (int t = 0; t < TS; ++t) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const long long o = q.o + 8 * p;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k < k_rt) {
          const long long l = (static_cast<long long>(s0 + t) * k_rt + k) * plane_px + o;
          lz_out[l] = lz[p][t][k];
          lt_out[l] = lt[p][t][k];
        }
      }
      aux_out[(s0 + t) * plane_px + o] = aux[p][t];
    }
  }
}

// Tests a thread: T = TS x P, from the padded layer count KC.
constexpr int tests_per_thread(int kc) { return kc <= 2 ? 8 : (kc <= 8 ? 4 : 2); }

template <int KC, int TS>
cudaError_t launch_layers(bool masked, const float* binned, long long pp,
                          const int* starts, const int* counts,
                          const float* depth_in, float* lz, int* lt, int* aux,
                          int k_rt, int n_tiles, int n_s, int tiles_x,
                          int tile_h, int tile_w, int hp, int wp,
                          int tile_row_offset, int row_stride,
                          const SamplePos& sp, cudaStream_t stream) {
  constexpr int P0 = tests_per_thread(KC) / TS;
  constexpr int P = P0 < 1 ? 1 : (P0 > 4 ? 4 : P0);
  if (tile_w % (32 * P) != 0 || tile_h % BLOCK_ROWS != 0 || n_s % TS != 0 ||
      n_tiles > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((tile_w / (32 * P)) * (tile_h / BLOCK_ROWS), n_tiles, n_s / TS);
  if (masked) {
    layer_kernel<KC, TS, P, true><<<grid, THREADS, 0, stream>>>(
        binned, pp, starts, counts, depth_in, lz, lt, aux, k_rt, tiles_x,
        tile_h, tile_w, hp, wp, tile_row_offset, row_stride, sp);
  } else {
    layer_kernel<KC, TS, P, false><<<grid, THREADS, 0, stream>>>(
        binned, pp, starts, counts, depth_in, lz, lt, aux, k_rt, tiles_x,
        tile_h, tile_w, hp, wp, tile_row_offset, row_stride, sp);
  }
  return cudaGetLastError();
}

// TS = min(S, T(KC)) for S in {1, 2, 4, 8}.
template <int KC>
cudaError_t launch_layers_s(int n_s, bool masked, const float* binned,
                            long long pp, const int* starts, const int* counts,
                            const float* depth_in, float* lz, int* lt, int* aux,
                            int k_rt, int n_tiles, int tiles_x, int tile_h,
                            int tile_w, int hp, int wp, int tile_row_offset,
                            int row_stride, const SamplePos& sp,
                            cudaStream_t stream) {
  constexpr int T = tests_per_thread(KC);
#define RT_ARGS                                                              \
  masked, binned, pp, starts, counts, depth_in, lz, lt, aux, k_rt, n_tiles,  \
      n_s, tiles_x, tile_h, tile_w, hp, wp, tile_row_offset, row_stride, sp, \
      stream
  switch (n_s < T ? n_s : T) {
    case 1: return launch_layers<KC, 1>(RT_ARGS);
    case 2: return launch_layers<KC, 2>(RT_ARGS);
    case 4: return launch_layers<KC, (T < 4 ? T : 4)>(RT_ARGS);
    case 8: return launch_layers<KC, (T < 8 ? T : 8)>(RT_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef RT_ARGS
}

}  // namespace rt

extern "C" int rt_rasterize_layers(const float* binned, long long pp,
                                   const int* starts, const int* counts,
                                   const float* depth_in, float* lz, int* lt,
                                   int* aux, int masked, int k, int n_tiles,
                                   int tiles_x, int tile_h, int tile_w, int hp,
                                   int wp, int tile_row_offset, int row_stride,
                                   int n_s, const float* sample_xy,
                                   void* stream) {
  if (n_tiles <= 0) return 0;
  if (n_s != 1 && n_s != 2 && n_s != 4 && n_s != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::SamplePos sp = {};
  for (int s = 0; s < n_s; ++s) {
    sp.x[s] = sample_xy[2 * s];
    sp.y[s] = sample_xy[2 * s + 1];
  }
  auto st = static_cast<cudaStream_t>(stream);
#define RT_CASE(KC)                                                           \
  return rt::launch_layers_s<KC>(n_s, masked != 0, binned, pp, starts,       \
                                 counts, depth_in, lz, lt, aux, k, n_tiles,  \
                                 tiles_x, tile_h, tile_w, hp, wp,            \
                                 tile_row_offset, row_stride, sp, st);
  if (k < 1 || k > 16) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 1) RT_CASE(1)
  if (k <= 2) RT_CASE(2)
  if (k <= 4) RT_CASE(4)
  if (k <= 8) RT_CASE(8)
  RT_CASE(16)
#undef RT_CASE
}
