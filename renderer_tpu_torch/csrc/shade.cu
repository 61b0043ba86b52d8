// S1, S2, S3: the deferred-shading stage, one (candidate, pixel) a thread.
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
// What bounds it on an H100: FP32 arithmetic and texel gathers. With the
// default sampler (trilinear, 16 anisotropic taps, sRGB decoded per tap) a
// lit pixel takes four textures x 16 x 2 mips x 4 texels = 512 texel reads
// and their bilinear weights; its own inputs and output are ~100 bytes.
//
// Design: the work is per pixel with no data shared between pixels, so a
// thread computes one (candidate, pixel) with everything in registers and
// writes its result once. Neighbouring threads take neighbouring pixels of
// one candidate map, so their texel reads fall on neighbouring atlas
// texels and are served by L1/L2. A per-tap sRGB decode depends on the
// texel byte alone: each block decodes the 256 bytes once into shared
// memory (ByteLut) and the taps read that table instead of evaluating pow.
// The debug mode is read on the device (a host read would break the frame's
// graph capture) and only the selected output is computed.
#include "shade_common.cuh"

namespace rs {

__device__ __forceinline__ Atlas atlas_of(const ShadeArgs& A) {
  return Atlas{A.atlas, A.table, A.srgb, A.wrap, A.n_atlas, A.n_tex, A.atlas_w};
}

__device__ __forceinline__ float4 ldg_row4(const float* p, long long i) {
  return __ldg(reinterpret_cast<const float4*>(p) + i);
}

template <bool BF, bool PER_TAP>
__global__ void __launch_bounds__(THREADS) shade_kernel(const ShadeArgs A) {
  __shared__ ByteLut lut;
  fill_lut<BF>(lut);
  __syncthreads();
  const long long n = A.n_cand * A.h * A.w;
  const long long idx = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (idx >= n) return;
  const int x = static_cast<int>(idx % A.w);
  const int y = static_cast<int>((idx / A.w) % A.h);
  const Interp it = interpolate(A, __ldg(A.tid + idx), x, y);
  float4* out = reinterpret_cast<float4*>(A.out) + idx;
  const int mode = __ldg(A.debug_mode);
  const long long draw = row_idx(it.draw, A.n_draws);
  const long long mat = row_idx(__ldg(A.material_id + draw * A.mat_stride), A.n_mats);
  if (!it.covered) {
    *out = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
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
  auto smp = [&](int col) {
    return sample<BF, PER_TAP>(a, lut, __ldg(tex + col), it.u, it.v_, it.dxu,
                               it.dxv, it.dyu, it.dyv, A.trilinear != 0, A.aniso);
  };
  const float4 bcf = ldg_row4(A.base_color_factor, mat);
  const float4 eo = ldg_row4(A.emissive_occlusion, mat);
  const float4 arm = ldg_row4(A.arm, mat);
  const float4 eoR = make_float4(R<BF>(eo.x), R<BF>(eo.y), R<BF>(eo.z), R<BF>(eo.w));
  const float4 armR = make_float4(R<BF>(arm.x), R<BF>(arm.y), R<BF>(arm.z), R<BF>(arm.w));
  if (mode == 4) {  // (0, roughness, metalness)
    const float4 mr = smp(1);
    *out = make_float4(0.0f, R<BF>(mr.y * armR.y), R<BF>(mr.z * armR.z), 1.0f);
    return;
  }
  float4 bc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (mode != 3 && mode != 5 && mode != 6) {  // lit (0 and any other) and 1
    const float4 s0 = smp(0);
    bc = make_float4(R<BF>(s0.x * R<BF>(bcf.x)), R<BF>(s0.y * R<BF>(bcf.y)),
                     R<BF>(s0.z * R<BF>(bcf.z)), R<BF>(s0.w * R<BF>(bcf.w)));
    if (mode == 1) {
      *out = bc;
      return;
    }
  }
  float e[3] = {0.f, 0.f, 0.f};
  if (mode != 3 && mode != 6) {  // lit and 5
    const float4 s4 = smp(4);
    e[0] = R<BF>(s4.x * eoR.x);
    e[1] = R<BF>(s4.y * eoR.y);
    e[2] = R<BF>(s4.z * eoR.z);
    if (mode == 5) {
      *out = make_float4(e[0], e[1], e[2], 1.0f);
      return;
    }
  }
  float occlusion = 0.0f;
  if (mode != 3) {  // lit and 6
    const float4 s3 = smp(3);
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
  const float4 s2 = smp(2);
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
      R<BF>(sqrtf(R<BF>((R<BF>(e[0] * e[0]) + R<BF>(e[1] * e[1])) + R<BF>(e[2] * e[2]))));
  if (elen > 0.0f) {
    *out = make_float4(e[0], e[1], e[2], 1.0f);
  } else {
    *out = make_float4(R<BF>(brightness * bc.x), R<BF>(brightness * bc.y),
                       R<BF>(brightness * bc.z), bc.w);
  }
}

template <bool BF, bool PER_TAP>
__global__ void __launch_bounds__(THREADS) alpha_kernel(const ShadeArgs A) {
  __shared__ ByteLut lut;
  fill_lut<BF>(lut);
  __syncthreads();
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
  const float4 s = sample<BF, PER_TAP>(atlas_of(A), lut, __ldg(A.tex_indices + 5 * mat),
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
  const Atlas a{A.atlas, A.table, A.srgb, A.wrap, A.n_atlas, A.n_tex, A.atlas_w};
  const float4 tex = sample<false, false>(a, lut, __ldg(A.tex_slot + cmd), u, vv, dxu,
                                          dxv, dyu, dyv, true, 1);
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

template <bool BF, bool PT>
cudaError_t launch_shade(const rs::ShadeArgs& a, cudaStream_t st, bool alpha) {
  const long long n = a.n_cand * a.h * a.w;
  if (alpha) {
    rs::alpha_kernel<BF, PT><<<rs::blocks_for(n), rs::THREADS, 0, st>>>(a);
  } else {
    rs::shade_kernel<BF, PT><<<rs::blocks_for(n), rs::THREADS, 0, st>>>(a);
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

}  // namespace

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
