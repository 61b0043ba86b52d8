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
// - the fused S3 rt_shade_composite_ui: shade_ui_layer and the src-alpha
//   composite of its layers into the HDR samples
//   (renderer_tpu/raster/pipeline.py:513-528), which XLA fuses there;
//   plain version ui_stage.shade_composite_ui_plain.
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
// decoded: S2 samples that one channel with the byte's value in registers.
// Its stack is the masked pass's candidates, whose deeper planes are almost
// all empty (on the patch wall at 1080p, 16 masked layers, about 4% of its
// (candidate, pixel)s are covered), and no later step reads an uncovered
// element's alpha or cutoff (C2 gathers only the candidates that a live
// slot, whose id is >= 0, matches). So S2 takes S1's design: persistent
// blocks walk rounds b, b + grid, ... of 256 consecutive elements, write
// the uncovered ones' alpha and cutoff +0 coalesced (the plain version
// masks to the same +0), queue the covered ones in order in shared memory
// and sample them 256 at a time, so its time follows the covered elements
// and not the configured planes. A round's tids are loaded while the round
// before it is scanned and sampled, and a round covered whole while nothing
// waits is sampled in place. Its queue is its only shared memory: its
// carveout is the smallest that holds it at the blocks an SM its registers
// allow, leaving the rest of each SM to L1 and the atlas.
//
// S3 and the fused S3 design. A UI layer is live (covered, inside its clip
// rect, of a textured kind) only under the UI's windows, a small part of
// a 1080p frame's [4, 1088, 1920] (layer, pixel) elements, while its four
// HDR samples are 100 MB. The fused S3 is bound by those bytes: it
// reads the layer ids, shades only the elements whose value the composite
// can see (compacted in shared memory, as S1 does), and reads each HDR
// sample once, writing in place only the values that change, instead of
// the plain loop's 16 passes over them. See ui_composite_kernel. Both sample only the channels an
// element uses with the byte's value in registers (no table: S3 decodes
// after the filter, so a per-tap table was never read).
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
// the __launch_bounds__ of S1 and S2 ask registers for (S1 3: 80 registers;
// 1 gives 96 and 2 blocks, 4 spills; both slower on scenes B and C. S2 1:
// 62 registers, 4 blocks; 5 and 6 spill, and were slower on B and C).
// Measured with tools/shade_probe.py, which builds other values.
constexpr int SPAN = 256;
constexpr int S1_MIN_BLOCKS = 3;
constexpr int S2_MIN_BLOCKS = 1;
constexpr int QUEUE = 2 * THREADS;  // S1, S2: covered elements waiting (< 2 rounds)
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

// S2's alpha and cutoff of one covered element e (its tid >= 0)
template <bool BF>
__device__ __forceinline__ void alpha_one(const ShadeArgs& A, long long e) {
  const int x = static_cast<int>(e % A.w);
  const int y = static_cast<int>((e / A.w) % A.h);
  const Interp it = interpolate(A, __ldg(A.tid + e), x, y);
  const long long draw = row_idx(it.draw, A.n_draws);
  const long long mat = row_idx(__ldg(A.material_id + draw * A.mat_stride), A.n_mats);
  const LaneBytes<BF> by{nullptr, 0};  // alpha is stored linear: raw values only
  const float4 s = sample<BF, false, CH_A>(atlas_of(A), by, __ldg(A.tex_indices + 5 * mat),
                                           it.u, it.v_, it.dxu, it.dxv, it.dyu, it.dyv,
                                           A.trilinear != 0, A.aniso);
  A.out[e] = s.w * __ldg(A.base_color_factor + 4 * mat + 3);
  A.out2[e] = __ldg(A.arm + 4 * mat);
}

// S2: persistent blocks, covered elements compacted in order (see the top).
// Block b walks rounds b, b + grid, ... of THREADS consecutive elements; a
// round's tids are loaded while the round before it is scanned and shaded.
// A round covered whole while nothing waits is shaded in place.
template <bool BF>
__global__ void __launch_bounds__(THREADS, S2_MIN_BLOCKS) alpha_kernel(const ShadeArgs A) {
  __shared__ long long queue[QUEUE];
  __shared__ int warp_n[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = A.n_cand * A.h * A.w;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  int head = 0, tail = 0;  // the queue's read and write counts (the same in every thread)
  long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  bool scanning = e - threadIdx.x < n;  // the block has a round left
  int t = e < n ? __ldg(A.tid + e) : -1;
  for (;;) {
    if (scanning) {  // one round: THREADS consecutive elements
      const bool covered = t >= 0;
      if (!covered && e < n) {
        A.out[e] = 0.0f;
        A.out2[e] = 0.0f;
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
      const long long here = e;
      e += step;
      scanning = e - threadIdx.x < n;
      t = scanning && e < n ? __ldg(A.tid + e) : -1;  // the next round's, in flight
      if (total == THREADS && head == tail) {  // covered whole, nothing waiting
        alpha_one<BF>(A, here);
        continue;
      }
      if (covered) queue[(tail + before + __popc(m & ((1u << lane) - 1u))) % QUEUE] = here;
      tail += total;
    }
    // shade a full round of queued elements, and what is left at the end
    if (tail - head < (scanning ? THREADS : 1)) {
      if (scanning) continue;
      break;
    }
    __syncthreads();  // the queue's writes are seen
    if (head + static_cast<int>(threadIdx.x) < tail)
      alpha_one<BF>(A, queue[(head + threadIdx.x) % QUEUE]);
    head = min(head + THREADS, tail);
  }
}

// ---- S3 and the fused S3: imgui.frag at pixel centres --------------------

// The affine interpolation of UI triangle t at the pixel centre (px, py):
// 2D barycentrics (w = 1), uv, the vertex colour and uv's screen derivatives
struct UiInterp {
  int v[3];
  float u, v_, dxu, dxv, dyu, dyv;
  float col[4];
};

__device__ __forceinline__ UiInterp ui_interp(const UiArgs& A, long long t, float px,
                                              float py) {
  UiInterp it;
  float P[3][2], U[3], V[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    it.v[i] = static_cast<int>(row_idx(__ldg(A.tris + 3 * t + i), A.n_verts));
    P[i][0] = __ldg(A.pos + 2 * it.v[i]);
    P[i][1] = __ldg(A.pos + 2 * it.v[i] + 1);
    U[i] = __ldg(A.uv + 2 * it.v[i]);
    V[i] = __ldg(A.uv + 2 * it.v[i] + 1);
  }
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
  it.u = (lam[0] * U[0] + lam[1] * U[1]) + lam[2] * U[2];
  it.v_ = (lam[0] * V[0] + lam[1] * V[1]) + lam[2] * V[2];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    it.col[c] = (lam[0] * __ldg(A.col + 4 * it.v[0] + c) +
                 lam[1] * __ldg(A.col + 4 * it.v[1] + c)) +
                lam[2] * __ldg(A.col + 4 * it.v[2] + c);
  }
  const float ea[3] = {(P[1][1] - P[2][1]) * inv, (P[2][1] - P[0][1]) * inv,
                       (P[0][1] - P[1][1]) * inv};
  const float eb[3] = {(P[2][0] - P[1][0]) * inv, (P[0][0] - P[2][0]) * inv,
                       (P[1][0] - P[0][0]) * inv};
  it.dxu = (ea[0] * U[0] + ea[1] * U[1]) + ea[2] * U[2];
  it.dxv = (ea[0] * V[0] + ea[1] * V[1]) + ea[2] * V[2];
  it.dyu = (eb[0] * U[0] + eb[1] * U[1]) + eb[2] * U[2];
  it.dyv = (eb[0] * V[0] + eb[1] * V[1]) + eb[2] * V[2];
  return it;
}

__device__ __forceinline__ float ui_py(const UiArgs& A, int y) {
  return (static_cast<float>(y) + 0.5f) + __ldg(A.row0 + y);
}

// Whether (col·tex)·0 equals col·0 in bits for every texel the sampler can
// give here without sampling: the sample is finite, >= +0 and at most
// 1 + 2^-20 when uv and its derivatives are finite (bytes over 255, weights
// in [0, 1]), so col·tex keeps col's sign and finiteness unless |col| is
// within a factor of two of FLT_MAX.
__device__ __forceinline__ bool is_finite_f(float x) { return fabsf(x) <= 0x1.fffffep127f; }

__device__ __forceinline__ bool ui_tex_sign_known(const UiInterp& it) {
  bool ok = is_finite_f(it.u) && is_finite_f(it.v_) && is_finite_f(it.dxu) &&
            is_finite_f(it.dxv) && is_finite_f(it.dyu) && is_finite_f(it.dyv);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    ok = ok && !(fabsf(it.col[c]) >= 0x1p126f && is_finite_f(it.col[c]));
  return ok;
}

// One (layer, pixel) element of shade_ui_layer: rgb unmasked and the alpha
// masked to the live elements (covered, inside the clip rect, tex_kind 1 or
// 2). The sampler takes the channels the element uses, with the byte's
// value in registers (S3 decodes after the filter): R for a live font
// element, RGBA for a live TEX_KIND_RGBA one, RGB for a TEX_KIND_RGBA one
// that is not live (its rgb is unmasked), none for any other. EXACT = false
// (the fused composite, which multiplies a non-live element's rgb by 0)
// skips that last sample where ui_tex_sign_known says (col·tex)·0 = col·0.
struct UiShade {
  float r, g, b, a;
};

template <bool EXACT>
__device__ __forceinline__ UiShade ui_shade(const UiArgs& A, int tr, int x, int y) {
  const float px = static_cast<float>(x) + 0.5f;
  const float py = ui_py(A, y);
  const bool covered = tr >= 0;
  const long long t = row_idx(covered ? tr : 0, A.n_tris);
  const UiInterp it = ui_interp(A, t, px, py);
  const long long cmd = row_idx(__ldg(A.tri_cmd + t), A.n_cmds);
  const float4 cr = __ldg(reinterpret_cast<const float4*>(A.cliprect) + cmd);
  const bool in_clip = (cr.x < px) & (cr.z >= px) & (cr.y < py) & (cr.w >= py);
  const int kind = __ldg(A.tex_kind + cmd);
  const bool live = covered & in_clip & ((kind == 1) | (kind == 2));
  UiShade out{it.col[0], it.col[1], it.col[2], 0.0f};
  if (kind != 1 && kind != 2) return out;
  if (kind == 1 && !live) return out;
  if (kind == 2 && !live && !EXACT && ui_tex_sign_known(it)) return out;
  const Atlas a = make_atlas(A.atlas, A.table, A.srgb, A.wrap, A.n_atlas, A.n_tex, A.atlas_w);
  const LaneBytes<false> by{nullptr, 0};
  const int slot = __ldg(A.tex_slot + cmd);
  if (kind == 1) {  // live font: alpha = vertex alpha · tex.r (R8 font)
    const float4 tex = sample<false, false, CH_R>(a, by, slot, it.u, it.v_, it.dxu, it.dxv,
                                                  it.dyu, it.dyv, true, 1);
    out.a = it.col[3] * tex.x;
    return out;
  }
  float4 tex;  // TEX_KIND_RGBA: full modulate
  if (live) {
    tex = sample<false, false, CH_RGBA>(a, by, slot, it.u, it.v_, it.dxu, it.dxv, it.dyu,
                                        it.dyv, true, 1);
    out.a = it.col[3] * tex.w;
  } else {
    tex = sample<false, false, CH_RGB>(a, by, slot, it.u, it.v_, it.dxu, it.dxv, it.dyu,
                                       it.dyv, true, 1);
  }
  out.r = it.col[0] * tex.x;
  out.g = it.col[1] * tex.y;
  out.b = it.col[2] * tex.z;
  return out;
}

// S3 (shade_ui_layer): one element a thread, every element shaded
__global__ void __launch_bounds__(THREADS) ui_kernel(const UiArgs A) {
  const long long n = A.n_cand * A.h * A.w;
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= n) return;
  const int x = static_cast<int>(idx % A.w);
  const int y = static_cast<int>((idx / A.w) % A.h);
  const UiShade sh = ui_shade<true>(A, __ldg(A.lt + idx), x, y);
  float* rgb = A.rgb + 3 * idx;
  rgb[0] = sh.r;
  rgb[1] = sh.g;
  rgb[2] = sh.b;
  A.alpha[idx] = sh.a;
}

// The fused S3's queue: (plane, pixel) elements waiting to be shaded in a
// round, and their shades
constexpr int UI_QUEUE = 1024;
// Coordinates and vertex values within 2^20 keep every interpolant of a
// triangle finite at any pixel within 2^20 (|lam| < 2^83, |uv|, |col| <
// 2^105, derivatives < 2^83), so ui_tex_sign_known holds
constexpr float UI_SANE = 1048576.0f;

__device__ __forceinline__ bool ui_sane(float x) { return fabsf(x) <= UI_SANE; }

// Whether UI triangle 0, which every uncovered element shades, has
// vertices within UI_SANE
__device__ __forceinline__ bool ui_triangle0_sane(const UiArgs& A) {
  if (A.n_tris < 1 || A.n_verts < 1) return false;
  bool ok = true;
  for (int i = 0; i < 3; ++i) {
    const long long v = row_idx(__ldg(A.tris + i), A.n_verts);
    for (int c = 0; c < 2; ++c)
      ok = ok && ui_sane(__ldg(A.pos + 2 * v + c)) && ui_sane(__ldg(A.uv + 2 * v + c));
    for (int c = 0; c < 4; ++c) ok = ok && ui_sane(__ldg(A.col + 4 * v + c));
  }
  return ok;
}

__device__ __forceinline__ float* ui_hdr(const UiArgs& A, int s) {
  switch (s) {  // a constant index into the parameters, no local copy
    case 0: return A.hdr[0];
    case 1: return A.hdr[1];
    case 2: return A.hdr[2];
    case 3: return A.hdr[3];
    case 4: return A.hdr[4];
    case 5: return A.hdr[5];
    case 6: return A.hdr[6];
    default: return A.hdr[7];
  }
}

__device__ __forceinline__ bool neg_zero(float x) { return __float_as_uint(x) == 0x80000000u; }

// The fused S3 (shade_composite_ui): persistent blocks; block b walks rounds
// b, b + grid, ... of round_px consecutive pixels, a thread a pixel.
// (1) Each pixel's planes are classed: an uncovered element over a sane
// triangle 0 (see below) needs no shade; every other one is queued in
// order in shared memory (a warp scan and the eight warps' counts).
// (2) Every thread shades queued elements (ui_shade<false>), so warps
// sample 32 live elements at a time. (3) Each pixel then composites its
// planes into its samples' HDR values in the plain loop's order:
// hdr · (1 − a) + rgb · a, one rounding an op (--fmad=false), and stores
// a value only where its bits changed (the samples under no live layer,
// most of a frame, are read and not written).
// An element that was not shaded has a = 0 and rgb·0 = ±0 with the sign of
// its vertex colour (which is finite there): hdr · 1 + (±0) is hdr, except
// that −0 turns +0 when that colour is >= +0, and NaN stays NaN. So the
// colour is interpolated only where the sample holds −0.
__global__ void __launch_bounds__(THREADS) ui_composite_kernel(const UiArgs A) {
  __shared__ float4 shades[UI_QUEUE];
  __shared__ int queue[UI_QUEUE];
  __shared__ int warp_n[THREADS / 32];
  __shared__ int sane0_s;
  if (threadIdx.x == 0) sane0_s = ui_triangle0_sane(A);
  __syncthreads();
  const bool sane0 = sane0_s != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n_px = static_cast<long long>(A.h) * A.w;
  const int planes = static_cast<int>(A.n_cand), rpx = A.round_px;
  const long long rounds = (n_px + rpx - 1) / rpx;
  for (long long r = blockIdx.x; r < rounds; r += gridDim.x) {
    const long long p = r * rpx + threadIdx.x;
    const bool mine = static_cast<int>(threadIdx.x) < rpx && p < n_px;
    int x = 0, y = 0;
    bool skip_ok = false;  // an uncovered element here needs no shade
    int n = 0;
    if (mine) {
      x = static_cast<int>(p % A.w);
      y = static_cast<int>(p / A.w);
      skip_ok = sane0 && ui_sane(static_cast<float>(x) + 0.5f) && ui_sane(ui_py(A, y));
      for (int j = 0; j < planes; ++j) n += !(skip_ok && __ldg(A.lt + j * n_px + p) < 0);
    }
    int incl = n;  // the block's exclusive scan of n
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_n[warp] = incl;
    __syncthreads();
    int first = incl - n, total = 0;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) {
      const int k = warp_n[i];
      first += i < warp ? k : 0;
      total += k;
    }
    if (mine && n) {
      int q = first;
      for (int j = 0; j < planes; ++j)
        if (!(skip_ok && __ldg(A.lt + j * n_px + p) < 0))
          queue[q++] = (static_cast<int>(threadIdx.x) << 11) | j;
    }
    __syncthreads();
    for (int i = static_cast<int>(threadIdx.x); i < total; i += THREADS) {
      const int e = queue[i];
      const long long pe = r * rpx + (e >> 11);
      const UiShade sh = ui_shade<false>(A, __ldg(A.lt + (e & 2047) * n_px + pe),
                                         static_cast<int>(pe % A.w),
                                         static_cast<int>(pe / A.w));
      shades[i] = make_float4(sh.r, sh.g, sh.b, sh.a);
    }
    __syncthreads();
    if (mine) {
      int q = first;
      for (int s = 0; s < A.n_samples; ++s) {
        if (!A.per_sample) q = first;  // every sample takes the same planes
        float* hp = ui_hdr(A, s) + 3 * p;
        const float h0[3] = {hp[0], hp[1], hp[2]};
        float h[3] = {h0[0], h0[1], h0[2]};
        for (int k = 0; k < A.n_layers; ++k) {
          const int j = A.per_sample ? s * A.n_layers + k : k;
          float4 sh;
          if (skip_ok && __ldg(A.lt + j * n_px + p) < 0) {
            sh = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // a = 0; rgb·0 = +0 unless ...
            if (neg_zero(h[0]) | neg_zero(h[1]) | neg_zero(h[2])) {  // ... its sign counts
              const UiInterp it = ui_interp(A, 0, static_cast<float>(x) + 0.5f, ui_py(A, y));
              sh = make_float4(it.col[0], it.col[1], it.col[2], 0.0f);
            }
          } else {
            sh = shades[q++];
          }
          const float om = __fsub_rn(1.0f, sh.w);
          h[0] = __fadd_rn(__fmul_rn(h[0], om), __fmul_rn(sh.x, sh.w));
          h[1] = __fadd_rn(__fmul_rn(h[1], om), __fmul_rn(sh.y, sh.w));
          h[2] = __fadd_rn(__fmul_rn(h[2], om), __fmul_rn(sh.z, sh.w));
        }
#pragma unroll
        for (int c = 0; c < 3; ++c)  // the plain loop's result, storing only new bits
          if (__float_as_uint(h[c]) != __float_as_uint(h0[c])) hp[c] = h[c];
      }
    }
    __syncthreads();  // the composite has read the shades and the queue
  }
}

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

}  // namespace rs

namespace {

// The grid of S1 and S2 (persistent blocks) and the launch attributes,
// found once a device and kernel: SMs x the blocks an SM holds at THREADS
// threads.
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
    // S2's queue is its only shared memory: the smallest carveout that
    // holds it at the blocks an SM its registers allow (found under the
    // default carveout), leaving the rest of each SM's 256 KB to L1
    cudaFuncAttributes fa;
    int per_sm = 0, reserved = 0, blocks = 0;
    err = cudaFuncGetAttributes(&fa, rs::alpha_kernel<BF>);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rs::alpha_kernel<BF>,
                                                          rs::THREADS, 0);
    if (err == cudaSuccess) {
      const long long need =
          static_cast<long long>(blocks) * (static_cast<long long>(fa.sharedSizeBytes) + reserved);
      const long long pct = std::min(100LL, (need * 100 + per_sm - 1) / std::max(per_sm, 1));
      err = cudaFuncSetAttribute(rs::alpha_kernel<BF>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 static_cast<int>(pct));
    }
    carveout[dev] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return err;
  return occupancy(rs::alpha_kernel<BF>, cache, out);
}

Occupancy s3_occupancy_cache[64];
Occupancy s3c_occupancy_cache[64];

template <bool BF, bool PT>
cudaError_t launch_shade(const rs::ShadeArgs& a, cudaStream_t st, bool alpha) {
  const long long n = a.n_cand * a.h * a.w;
  Occupancy o;
  cudaError_t err = alpha ? s2_occupancy<BF>(&o) : s1_occupancy<BF, PT>(&o);
  if (err != cudaSuccess) return err;
  const long long grain = alpha ? rs::THREADS : rs::SPAN;  // S2 deals rounds, S1 spans
  const long long blocks = (n + grain - 1) / grain;
  const unsigned grid = static_cast<unsigned>(
      std::min(blocks, static_cast<long long>(o.sms) * std::max(o.blocks_per_sm, 1)));
  if (alpha) {
    rs::alpha_kernel<BF><<<grid, rs::THREADS, 0, st>>>(a);
  } else {
    rs::shade_kernel<BF, PT><<<grid, rs::THREADS, 0, st>>>(a);
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
// 3 = S3, 4 = the fused S3; bf16 and per_tap pick S1's and S2's template):
// out[0..5] = registers a thread, local bytes a thread (stack frame and
// spills), static shared bytes a block, blocks an SM (the occupancy the
// launches use), SMs, and the most blocks a launch of a persistent kernel
// (S1, S2, the fused S3; 0 for S3, whose grid is one thread an element).
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
    const long long cap = static_cast<long long>(o.sms) * std::max(o.blocks_per_sm, 1);
    return bf16 ? kernel_info(rs::alpha_kernel<true>, o, cap, out)
                : kernel_info(rs::alpha_kernel<false>, o, cap, out);
  }
  if (kernel == 3) {
    err = occupancy(rs::ui_kernel, s3_occupancy_cache, &o);
    if (err != cudaSuccess) return static_cast<int>(err);
    return kernel_info(rs::ui_kernel, o, 0, out);
  }
  if (kernel == 4) {
    err = occupancy(rs::ui_composite_kernel, s3c_occupancy_cache, &o);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long cap = static_cast<long long>(o.sms) * std::max(o.blocks_per_sm, 1);
    return kernel_info(rs::ui_composite_kernel, o, cap, out);
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

// The fused S3: args->n_cand planes of [h, w] composited into n_samples
// HDR buffers; round_px * n_cand must fit the queue.
extern "C" int rt_shade_composite_ui(const rs::UiArgs* args, void* stream) {
  const long long n_px = static_cast<long long>(args->h) * args->w;
  if (n_px <= 0 || args->n_cand <= 0) return 0;
  if (args->n_samples < 1 || args->n_samples > rs::MAX_HDR || args->n_layers < 1 ||
      args->round_px < 1 || args->round_px > rs::THREADS ||
      args->round_px * args->n_cand > rs::UI_QUEUE ||
      args->n_cand != (args->per_sample ? args->n_samples : 1) * args->n_layers ||
      args->n_cand * n_px > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Occupancy o;
  const cudaError_t err = occupancy(rs::ui_composite_kernel, s3c_occupancy_cache, &o);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rounds = (n_px + args->round_px - 1) / args->round_px;
  const long long grid = std::min(rounds, static_cast<long long>(o.sms) *
                                              std::max(o.blocks_per_sm, 1));
  rs::ui_composite_kernel<<<static_cast<unsigned>(grid), rs::THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}
