// S1, S2, S3: the deferred-shading stage.
//
// Replaces what the JAX package leaves to XLA to fuse inside its jitted
// frame (renderer_tpu/raster/pipeline.py `render_shard`): no Pallas kernel
// of its own.
// - S1 rt_shade_stack: renderer_tpu/raster/shade.py `shade_interpolated`
//   (:329) over `interpolants` and `make_sampler` (:46), the solid and
//   blended shade of render_shard; plain version raster/shade.py
//   shade_stack_plain.
// - S2 rt_alpha_stack: shade.py `base_alpha` (:312), render_shard's masked
//   alpha test; plain version shade.alpha_stack_plain.
// - S3 rt_shade_ui: renderer_tpu/raster/ui_stage.py `shade_ui_layer` (:89);
//   plain version raster/ui_stage.py shade_ui_layer_plain.
//
// What bounds them on an H100: issue slots and texel gathers, not device
// memory. With the default sampler (trilinear, 16 anisotropic taps, sRGB
// decoded per tap) a lit pixel takes four textures x 16 x 2 mips x 4 texels
// = 512 texel reads and the bilinear arithmetic of the channels it uses;
// its own inputs and output are ~100 bytes.
//
// S1 design. A candidate map is covered mostly along edges (on a 1080p
// frame about 8% of the (candidate, pixel)s a call holds), so one thread
// an element would run the 4-sample path at a few lanes a warp. Instead
// S1 launches persistent blocks (the SMs x the blocks an SM holds, computed
// on the host once a device, no more than the spans); block b walks spans
// b, b + grid, ... of SPAN consecutive elements, 256 at a time: it reads
// their tids coalesced, writes (0,0,0,0) to the uncovered ones coalesced,
// and appends the covered ones in order to a queue in shared memory
// (__ballot_sync, __popc and a scan of the eight warps' counts). Whenever
// 256 are queued, every thread shades one, so warps shade 32 covered
// neighbouring pixels at a time, interpolation and material lookups
// included. SPAN is one round (256): spans dealt round-robin in so small
// a grain balance the blocks' work best (measured against 1024-4096 with
// tools/shade_probe.py). There are no global atomics: the grid is fixed
// by the shape and the launch captures into a CUDA graph like any other.
// The sampler is templated on the channels each sample's caller uses
// (base colour RGBA, emissive RGB, occlusion R, normal RGB, roughness and
// metalness G and B), so unused channels are neither extracted, decoded
// nor filtered; it chooses the mips once a sample and wraps the
// coordinates once a tap, and a texel pair inside the atlas skips
// take_idx's clamps. A texel byte's linear value is computed in
// registers; the per-tap sRGB decode reads a table replicated once a lane
// (entry b of lane l at b * 32 + l), so every read of it is free of bank
// conflicts. A persistent block fills it once.
//
// S2 design. base_alpha needs the alpha channel alone, which is never
// decoded: S2 samples that one channel with the byte's value in registers,
// one element a thread, and uses no shared memory (its carveout is set to
// the minimum, leaving L1 to the atlas). Every element is computed,
// background included: the plain version does not mask base_alpha.
//
// S3 keeps one element a thread with both byte tables in shared memory;
// it shares the sampler above.
//
// The debug mode is read on the device (a host read would break the
// frame's graph capture) and only the selected output is computed.
#include <algorithm>

#include "shade_common.cuh"

namespace rs {

__device__ __forceinline__ Atlas atlas_of(const ShadeArgs& A) {
  return make_atlas(A.atlas, A.table, A.srgb, A.wrap, A.n_atlas, A.n_tex, A.atlas_w);
}

__device__ __forceinline__ float4 ldg_row4(const float* p, long long i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}

// S1's consecutive elements a block takes at once, and the blocks an SM
// its __launch_bounds__ asks registers for (3: 80 registers; 1 gives 96
// and 2 blocks, 4 spills; both slower on scenes B and C). Measured with
// tools/shade_probe.py, which builds other values.
constexpr int SPAN = 256;
constexpr int S1_MIN_BLOCKS = 3;
constexpr int QUEUE = 2 * THREADS;  // S1: covered elements waiting (< 2 rounds)
static_assert(SPAN % THREADS == 0, "a span is whole rounds of the block");

// S1's shade of one covered element e (its tid >= 0)
template <bool BF, bool PER_TAP>
__device__ __forceinline__ void shade_one(const ShadeArgs& A, const LaneBytes<BF>& by,
                                          int mode, long long e) {
  const int x = static_cast<int>(e % A.w);
  const int y = static_cast<int>((e / A.w) % A.h);
  const Interp it = interpolate(A, __ldg(A.tid + e), x, y);
  float4* out = reinterpret_cast<float4*>(A.out) + e;
  const long long draw = row_idx(it.draw, A.n_draws);
  const long long mat = row_idx(__ldg(A.material_id + draw * A.mat_stride), A.n_mats);
  if (mode == 2) {  // per-draw hashed debug colour (draw_debug_colors)
    const float d = 1.0f + static_cast<float>(__ldg(A.debug_id + draw * A.dbg_stride));
    const float k[3] = {641.65433f, 1864.251623f, 182362.365f};
    float c[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float m = fmodf(sinf(d * k[i]) * 43758.5453123f, 1.0f);
      if (m != 0.0f && m < 0.0f) m += 1.0f;
      c[i] = R<BF>(m);
    }
    *out = make_float4(c[0], c[1], c[2], 1.0f);
    return;
  }
  const Atlas a = atlas_of(A);
  const int* tex = A.tex_indices + 5 * mat;
  const bool tri = A.trilinear != 0;
  const float4 bcf = ldg_row4(A.base_color_factor, mat);
  const float4 eo = ldg_row4(A.emissive_occlusion, mat);
  const float4 arm = ldg_row4(A.arm, mat);
  const float4 eoR = make_float4(R<BF>(eo.x), R<BF>(eo.y), R<BF>(eo.z), R<BF>(eo.w));
  const float4 armR = make_float4(R<BF>(arm.x), R<BF>(arm.y), R<BF>(arm.z), R<BF>(arm.w));
  if (mode == 4) {  // (0, roughness, metalness)
    const float4 mr = sample<BF, PER_TAP, CH_G | CH_B>(
        a, by, __ldg(tex + 1), it.u, it.v_, it.dxu, it.dxv, it.dyu, it.dyv, tri, A.aniso);
    *out = make_float4(0.0f, R<BF>(mr.y * armR.y), R<BF>(mr.z * armR.z), 1.0f);
    return;
  }
  float4 bc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (mode != 3 && mode != 5 && mode != 6) {  // lit (0 and any other) and 1
    const float4 s0 = sample<BF, PER_TAP, CH_RGBA>(
        a, by, __ldg(tex + 0), it.u, it.v_, it.dxu, it.dxv, it.dyu, it.dyv, tri, A.aniso);
    bc = make_float4(R<BF>(s0.x * R<BF>(bcf.x)), R<BF>(s0.y * R<BF>(bcf.y)),
                     R<BF>(s0.z * R<BF>(bcf.z)), R<BF>(s0.w * R<BF>(bcf.w)));
    if (mode == 1) {
      *out = bc;
      return;
    }
  }
  float e3[3] = {0.f, 0.f, 0.f};
  if (mode != 3 && mode != 6) {  // lit and 5
    const float4 s4 = sample<BF, PER_TAP, CH_RGB>(
        a, by, __ldg(tex + 4), it.u, it.v_, it.dxu, it.dxv, it.dyu, it.dyv, tri, A.aniso);
    e3[0] = R<BF>(s4.x * eoR.x);
    e3[1] = R<BF>(s4.y * eoR.y);
    e3[2] = R<BF>(s4.z * eoR.z);
    if (mode == 5) {
      *out = make_float4(e3[0], e3[1], e3[2], 1.0f);
      return;
    }
  }
  float occlusion = 0.0f;
  if (mode != 3) {  // lit and 6
    const float4 s3 = sample<BF, PER_TAP, CH_R>(
        a, by, __ldg(tex + 3), it.u, it.v_, it.dxu, it.dxv, it.dyu, it.dyv, tri, A.aniso);
    occlusion = R<BF>(1.0f + R<BF>(eoR.w * R<BF>(s3.x - 1.0f)));
    if (mode == 6) {
      *out = make_float4(occlusion, occlusion, occlusion, 1.0f);
      return;
    }
  }
  // TBN normal mapping (lit and 3)
  float nrm[3], tg[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    nrm[i] = R<BF>(interp_attr(it, A.normal, 3, i));
    tg[i] = R<BF>(interp_attr(it, A.tangent, 4, i));
  }
  const float tan_w = R<BF>(interp_attr(it, A.tangent, 4, 3));
  const float cr[3] = {R<BF>(R<BF>(nrm[1] * tg[2]) - R<BF>(nrm[2] * tg[1])),
                       R<BF>(R<BF>(nrm[2] * tg[0]) - R<BF>(nrm[0] * tg[2])),
                       R<BF>(R<BF>(nrm[0] * tg[1]) - R<BF>(nrm[1] * tg[0]))};
  const float4 s2 = sample<BF, PER_TAP, CH_RGB>(
      a, by, __ldg(tex + 2), it.u, it.v_, it.dxu, it.dxv, it.dyu, it.dyv, tri, A.aniso);
  const float ns = armR.w;
  float nt[3] = {R<BF>(R<BF>(R<BF>(s2.x * 2.0f) - 1.0f) * ns),
                 R<BF>(R<BF>(R<BF>(s2.y * 2.0f) - 1.0f) * ns),
                 R<BF>(R<BF>(s2.z * 2.0f) - 1.0f)};
  const float ss = clamp_lo(
      R<BF>((R<BF>(nt[0] * nt[0]) + R<BF>(nt[1] * nt[1])) + R<BF>(nt[2] * nt[2])),
      1e-20f);
  const float rn = R<BF>(1.0f / R<BF>(sqrtf(R<BF>(ss))));
  float sn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) nt[i] = R<BF>(nt[i] * rn);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float bt = R<BF>(tan_w * cr[i]);
    sn[i] = R<BF>(R<BF>(R<BF>(tg[i] * nt[0]) + R<BF>(bt * nt[1])) + R<BF>(nrm[i] * nt[2]));
  }
  if (mode == 3) {
    *out = make_float4(sn[0], sn[1], sn[2], 1.0f);
    return;
  }
  // lit (main.frag:78-88)
  const float sun = R<BF>(INV_SQRT3);
  const float dot = R<BF>((R<BF>(sn[0] * R<BF>(-INV_SQRT3)) + R<BF>(sn[1] * sun)) +
                          R<BF>(sn[2] * sun));
  const float sun_dot = clamp_lo(dot, 0.0f);
  const float brightness = R<BF>(R<BF>(occlusion * 0.3f) + R<BF>(sun_dot * 2.0f));
  const float elen =
      R<BF>(sqrtf(R<BF>((R<BF>(e3[0] * e3[0]) + R<BF>(e3[1] * e3[1])) + R<BF>(e3[2] * e3[2]))));
  if (elen > 0.0f) {
    *out = make_float4(e3[0], e3[1], e3[2], 1.0f);
  } else {
    *out = make_float4(R<BF>(brightness * bc.x), R<BF>(brightness * bc.y),
                       R<BF>(brightness * bc.z), bc.w);
  }
}

// S1: persistent blocks, covered elements compacted in order (see the top)
template <bool BF, bool PER_TAP>
__global__ void __launch_bounds__(THREADS, S1_MIN_BLOCKS) shade_kernel(const ShadeArgs A) {
  __shared__ float lane_table[PER_TAP ? LANE_TABLE : 1];
  __shared__ long long queue[QUEUE];
  __shared__ int warp_n[THREADS / 32];
  if constexpr (PER_TAP) fill_lane_table<BF>(lane_table);  // the loop's syncs order it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const LaneBytes<BF> by{PER_TAP ? lane_table : nullptr, lane};
  const int mode = __ldg(A.debug_mode);
  const long long n = A.n_cand * A.h * A.w;
  const long long spans = (n + SPAN - 1) / SPAN;
  float4* out = reinterpret_cast<float4*>(A.out);
  int head = 0, tail = 0;  // the queue's read and write counts (the same in every thread)
  long long sp = blockIdx.x;
  int r = 0;  // the next round of span sp
  for (;;) {
    const bool scanning = sp < spans;
    if (scanning) {  // one round: THREADS consecutive elements
      const long long e = sp * SPAN + r + threadIdx.x;
      bool covered = false;
      if (e < n) {
        covered = __ldg(A.tid + e) >= 0;
        if (!covered) out[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const unsigned m = __ballot_sync(0xffffffffu, covered);
      __syncthreads();  // the last shading has read the queue, and warp_n
      if (lane == 0) warp_n[warp] = __popc(m);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int i = 0; i < THREADS / 32; ++i) {
        const int k = warp_n[i];
        before += i < warp ? k : 0;
        total += k;
      }
      if (covered) queue[(tail + before + __popc(m & ((1u << lane) - 1u))) % QUEUE] = e;
      tail += total;
      r += THREADS;
      if (r == SPAN) {
        r = 0;
        sp += gridDim.x;
      }
    }
    // shade a full round of queued elements, and what is left at the end
    if (tail - head < (scanning ? THREADS : 1)) {
      if (scanning) continue;
      break;
    }
    __syncthreads();  // the queue's writes are seen
    if (head + static_cast<int>(threadIdx.x) < tail)
      shade_one<BF, PER_TAP>(A, by, mode, queue[(head + threadIdx.x) % QUEUE]);
    head = min(head + THREADS, tail);
  }
}

// S2: one element a thread, the alpha channel alone, no shared memory
template <bool BF>
__global__ void __launch_bounds__(THREADS) alpha_kernel(const ShadeArgs A) {
  const long long n = A.n_cand * A.h * A.w;
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= n) return;
  const int x = static_cast<int>(idx % A.w);
  const int y = static_cast<int>((idx / A.w) % A.h);
  // every pixel is computed, background included (the plain version does
  // not mask base_alpha; background pixels shade triangle 0)
  const Interp it = interpolate(A, __ldg(A.tid + idx), x, y);
  const long long draw = row_idx(it.draw, A.n_draws);
  const long long mat = row_idx(__ldg(A.material_id + draw * A.mat_stride), A.n_mats);
  const LaneBytes<BF> by{nullptr, 0};  // alpha is stored linear: raw values only
  const float4 s = sample<BF, false, CH_A>(atlas_of(A), by, __ldg(A.tex_indices + 5 * mat),
                                           it.u, it.v_, it.dxu, it.dxv, it.dyu, it.dyv,
                                           A.trilinear != 0, A.aniso);
  A.out[idx] = s.w * __ldg(A.base_color_factor + 4 * mat + 3);
  A.out2[idx] = __ldg(A.arm + 4 * mat);
}

// imgui.frag at pixel centres: 2D affine barycentrics, the clip-rect
// discard, one trilinear sample (aniso 1, sRGB decoded after the filter)
__global__ void __launch_bounds__(THREADS) ui_kernel(const UiArgs A) {
  __shared__ ByteLut lut;
  fill_lut<false>(lut);
  __syncthreads();
  const long long n = A.n_cand * A.h * A.w;
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= n) return;
  const int x = static_cast<int>(idx % A.w);
  const int y = static_cast<int>((idx / A.w) % A.h);
  const int tr = __ldg(A.lt + idx);
  const bool covered = tr >= 0;
  const long long t = row_idx(covered ? tr : 0, A.n_tris);
  int v[3];
  float P[3][2], U[3], V[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v[i] = static_cast<int>(row_idx(__ldg(A.tris + 3 * t + i), A.n_verts));
    P[i][0] = __ldg(A.pos + 2 * v[i]);
    P[i][1] = __ldg(A.pos + 2 * v[i] + 1);
    U[i] = __ldg(A.uv + 2 * v[i]);
    V[i] = __ldg(A.uv + 2 * v[i] + 1);
  }
  const float px = static_cast<float>(x) + 0.5f;
  const float py = (static_cast<float>(y) + 0.5f) + __ldg(A.row0 + y);
  float g[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3, k = (i + 2) % 3;
    const float ax = P[j][0] - px, ay = P[j][1] - py;
    const float bx = P[k][0] - px, by = P[k][1] - py;
    g[i] = ax * by - ay * bx;
  }
  const float s = (g[0] + g[1]) + g[2];
  const float inv = 1.0f / (fabsf(s) > 1e-12f ? s : 1.0f);
  float lam[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) lam[i] = g[i] * inv;
  const float u = (lam[0] * U[0] + lam[1] * U[1]) + lam[2] * U[2];
  const float vv = (lam[0] * V[0] + lam[1] * V[1]) + lam[2] * V[2];
  float col[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    col[c] = (lam[0] * __ldg(A.col + 4 * v[0] + c) + lam[1] * __ldg(A.col + 4 * v[1] + c)) +
             lam[2] * __ldg(A.col + 4 * v[2] + c);
  }
  const float ea[3] = {(P[1][1] - P[2][1]) * inv, (P[2][1] - P[0][1]) * inv,
                       (P[0][1] - P[1][1]) * inv};
  const float eb[3] = {(P[2][0] - P[1][0]) * inv, (P[0][0] - P[2][0]) * inv,
                       (P[1][0] - P[0][0]) * inv};
  const float dxu = (ea[0] * U[0] + ea[1] * U[1]) + ea[2] * U[2];
  const float dxv = (ea[0] * V[0] + ea[1] * V[1]) + ea[2] * V[2];
  const float dyu = (eb[0] * U[0] + eb[1] * U[1]) + eb[2] * U[2];
  const float dyv = (eb[0] * V[0] + eb[1] * V[1]) + eb[2] * V[2];
  const long long cmd = row_idx(__ldg(A.tri_cmd + t), A.n_cmds);
  const float4 cr = __ldg(reinterpret_cast<const float4*>(A.cliprect) + cmd);
  const bool in_clip = (cr.x < px) & (cr.z >= px) & (cr.y < py) & (cr.w >= py);
  const int kind = __ldg(A.tex_kind + cmd);
  const Atlas a = make_atlas(A.atlas, A.table, A.srgb, A.wrap, A.n_atlas, A.n_tex, A.atlas_w);
  const float4 tex = sample<false, false, CH_RGBA>(a, SharedBytes{lut}, __ldg(A.tex_slot + cmd),
                                                   u, vv, dxu, dxv, dyu, dyv, true, 1);
  float* rgb = A.rgb + 3 * idx;
  if (kind == 2) {  // TEX_KIND_RGBA: full modulate
    rgb[0] = col[0] * tex.x;
    rgb[1] = col[1] * tex.y;
    rgb[2] = col[2] * tex.z;
  } else {
    rgb[0] = col[0];
    rgb[1] = col[1];
    rgb[2] = col[2];
  }
  const float alpha = kind == 1 ? col[3] * tex.x : col[3] * tex.w;  // 1: font
  const bool live = covered & in_clip & ((kind == 1) | (kind == 2));
  A.alpha[idx] = live ? alpha : 0.0f;
}

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace rs

namespace {

// The grid of S1 (persistent blocks) and the launch attributes, found once
// a device and kernel: SMs x the blocks an SM holds at THREADS threads.
struct Occupancy {
  int blocks_per_sm = 0, sms = 0;
};

template <class K>
cudaError_t occupancy(K kernel, Occupancy* cache, Occupancy* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Occupancy o = cache[dev];
  if (o.sms == 0) {
    err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.blocks_per_sm, kernel,
                                                          rs::THREADS, 0);
    if (err != cudaSuccess) return err;
    cache[dev] = o;
  }
  *out = o;
  return cudaSuccess;
}

template <bool BF, bool PT>
cudaError_t s1_occupancy(Occupancy* out) {
  static Occupancy cache[64];
  return occupancy(rs::shade_kernel<BF, PT>, cache, out);
}

template <bool BF>
cudaError_t s2_occupancy(Occupancy* out) {
  static Occupancy cache[64];
  static bool carveout[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= 0 && dev < 64 && !carveout[dev]) {
    // S2 uses no shared memory: leave the most of each SM's 256 KB to L1
    err = cudaFuncSetAttribute(rs::alpha_kernel<BF>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxL1);
    carveout[dev] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return err;
  return occupancy(rs::alpha_kernel<BF>, cache, out);
}

Occupancy s3_occupancy_cache[64];

template <bool BF, bool PT>
cudaError_t launch_shade(const rs::ShadeArgs& a, cudaStream_t st, bool alpha) {
  const long long n = a.n_cand * a.h * a.w;
  Occupancy o;
  if (alpha) {
    cudaError_t err = s2_occupancy<BF>(&o);
    if (err != cudaSuccess) return err;
    rs::alpha_kernel<BF><<<rs::blocks_for(n), rs::THREADS, 0, st>>>(a);
  } else {
    cudaError_t err = s1_occupancy<BF, PT>(&o);
    if (err != cudaSuccess) return err;
    const long long spans = (n + rs::SPAN - 1) / rs::SPAN;
    const long long grid = std::min(spans, static_cast<long long>(o.sms) *
                                               std::max(o.blocks_per_sm, 1));
    rs::shade_kernel<BF, PT><<<static_cast<unsigned>(grid), rs::THREADS, 0, st>>>(a);
  }
  return cudaGetLastError();
}

int shade_entry(const rs::ShadeArgs* a, void* stream, bool alpha) {
  const long long n = a->n_cand * a->h * a->w;
  if (n <= 0) return 0;
  if ((n + rs::THREADS - 1) / rs::THREADS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const bool bf = a->bf16 != 0, pt = a->srgb_per_tap != 0;
  cudaError_t err;
  if (bf) {
    err = pt ? launch_shade<true, true>(*a, st, alpha)
             : launch_shade<true, false>(*a, st, alpha);
  } else {
    err = pt ? launch_shade<false, true>(*a, st, alpha)
             : launch_shade<false, false>(*a, st, alpha);
  }
  return static_cast<int>(err);
}

template <class K>
int kernel_info(K kernel, const Occupancy& o, long long grid_cap, long long* out) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = fa.numRegs;
  out[1] = static_cast<long long>(fa.localSizeBytes);
  out[2] = static_cast<long long>(fa.sharedSizeBytes);
  out[3] = o.blocks_per_sm;
  out[4] = o.sms;
  out[5] = grid_cap;
  return 0;
}

}  // namespace

// What the host knows of one kernel instantiation (kernel 1 = S1, 2 = S2,
// 3 = S3; bf16 and per_tap pick S1's and S2's template): out[0..5] =
// registers a thread, local bytes a thread (stack frame and spills),
// static shared bytes a block, blocks an SM (the occupancy the launches
// use), SMs, and S1's most blocks a launch (0 for S2 and S3, whose grid is
// one thread an element).
extern "C" int rt_shade_info(int kernel, int bf16, int per_tap, long long* out) {
  Occupancy o;
  cudaError_t err = cudaSuccess;
  if (kernel == 1) {
    if (bf16) {
      err = per_tap ? s1_occupancy<true, true>(&o) : s1_occupancy<true, false>(&o);
    } else {
      err = per_tap ? s1_occupancy<false, true>(&o) : s1_occupancy<false, false>(&o);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long cap = static_cast<long long>(o.sms) * std::max(o.blocks_per_sm, 1);
    if (bf16) {
      return per_tap ? kernel_info(rs::shade_kernel<true, true>, o, cap, out)
                     : kernel_info(rs::shade_kernel<true, false>, o, cap, out);
    }
    return per_tap ? kernel_info(rs::shade_kernel<false, true>, o, cap, out)
                   : kernel_info(rs::shade_kernel<false, false>, o, cap, out);
  }
  if (kernel == 2) {
    err = bf16 ? s2_occupancy<true>(&o) : s2_occupancy<false>(&o);
    if (err != cudaSuccess) return static_cast<int>(err);
    return bf16 ? kernel_info(rs::alpha_kernel<true>, o, 0, out)
                : kernel_info(rs::alpha_kernel<false>, o, 0, out);
  }
  if (kernel == 3) {
    err = occupancy(rs::ui_kernel, s3_occupancy_cache, &o);
    if (err != cudaSuccess) return static_cast<int>(err);
    return kernel_info(rs::ui_kernel, o, 0, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rt_shade_stack(const rs::ShadeArgs* args, void* stream) {
  return shade_entry(args, stream, false);
}

extern "C" int rt_alpha_stack(const rs::ShadeArgs* args, void* stream) {
  return shade_entry(args, stream, true);
}

extern "C" int rt_shade_ui(const rs::UiArgs* args, void* stream) {
  const long long n = args->n_cand * args->h * args->w;
  if (n <= 0) return 0;
  if ((n + rs::THREADS - 1) / rs::THREADS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  rs::ui_kernel<<<rs::blocks_for(n), rs::THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
