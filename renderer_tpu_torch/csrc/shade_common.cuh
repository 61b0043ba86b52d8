// Shared device functions of the deferred-shading kernels (shade.cu): the
// index semantics of the plain versions' gathers, the perspective
// interpolation of a visibility-buffer pixel, and the atlas sampler.
//
// Every function here repeats renderer_tpu_torch/raster/shade.py op for op:
// each PyTorch op rounds once, and the library is built with --fmad=false,
// so `a * b + c` rounds twice here as it does there. Sums are taken left to
// right as the plain version writes them. Constants the plain version
// multiplies by (1 / 12.92, 1 / 1.055, 1 / sqrt(3)) are the same f32 values
// on both sides.
//
// bf16 shading (RenderConfig.bf16_shading): the plain version keeps texel
// addressing and interpolation in f32 and runs filtering and lighting on
// bf16 tensors, where each op computes in f32 and rounds its result to
// bf16. The kernels are templated on BF and round with R<BF> after every op
// whose result is a bf16 tensor there; R<false> is the identity.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace rs {

constexpr int MAX_MIPS = 12;         // materials/atlas.py MAX_MIPS
constexpr int THREADS = 256;         // a block's threads (every kernel here)
constexpr float INV_12_92 = 0x1.3d0722p-4f;  // f32(1) / f32(12.92)
constexpr float INV_1_055 = 0x1.e54edep-1f;  // f32(1) / f32(1.055)
constexpr float INV_SQRT3 = 0x1.279a74p-1f;  // f32(1) / sqrt(f32(3))
constexpr float SRGB_GAMMA = 2.4f;
constexpr float SRGB_KNEE = 0.04045f;

// the arguments of the scene kernels (S1, S2); the field order is
// raster/shade.py's _ShadeArgs
struct ShadeArgs {
  const int* tid;                 // [C, h, w] candidate triangle ids
  const float* row0;              // [h] per-row offset to the global row
  const int* tri_v;               // [T, 3]
  const float* clip;              // [V, 4]
  const float* uv;                // [V, 2]
  const float* normal;            // [V, 3]
  const float* tangent;           // [V, 4]
  const int* draw;                // [V]
  const int* material_id;         // [D] (stride mat_stride)
  const int* debug_id;            // [D] (stride dbg_stride)
  const int* debug_mode;          // scalar on the device
  const int* atlas;               // [AH, AW] packed RGBA8
  const int* table;               // [NT, MAX_MIPS, 4] x, y, w, h
  const int* srgb;                // [NT]
  const int* wrap;                // [NT, 2] or null (all repeat)
  const int* tex_indices;         // [M, 5]
  const float* base_color_factor; // [M, 4]
  const float* emissive_occlusion;// [M, 4]
  const float* arm;               // [M, 4] alpha cutoff, rough, metal, nscale
  float* out;                     // S1: [C, h, w, 4]; S2: alpha [C, h, w]
  float* out2;                    // S2: cutoff [C, h, w]
  long long n_cand, n_tris, n_verts, n_draws, mat_stride, dbg_stride, n_mats,
      n_atlas, n_tex;
  int h, w, width, height, atlas_w, trilinear, aniso, srgb_per_tap, bf16;
};

constexpr int MAX_HDR = 8;  // the composite's HDR buffers: one an MSAA sample

// the arguments of the UI kernels (S3 and the fused S3); the field order is
// kernels.py's UiArgs
struct UiArgs {
  const int* lt;        // [C, h, w] layer triangle ids (C planes)
  const float* row0;    // [h]
  const int* tris;      // [N, 3]
  const float* pos;     // [V, 2]
  const float* uv;      // [V, 2]
  const float* col;     // [V, 4]
  const int* tri_cmd;   // [N]
  const float* cliprect;// [K, 4]
  const int* tex_kind;  // [K]
  const int* tex_slot;  // [K]
  const int* atlas;
  const int* table;
  const int* srgb;
  const int* wrap;
  float* rgb;           // S3: [C, h, w, 3]
  float* alpha;         // S3: [C, h, w]
  float* hdr[MAX_HDR];  // fused S3: the samples' HDR buffers [h, w, 3], in place
  long long n_cand, n_tris, n_verts, n_cmds, n_atlas, n_tex;
  int h, w, atlas_w;
  // fused S3: the HDR buffers, the layers a sample, whether plane j
  // composites into sample j / n_layers alone (ui_msaa) or into every
  // sample, and the pixels a round (so that a round's planes fit the queue)
  int n_samples, n_layers, per_sample, round_px;
};

template <bool BF>
__device__ __forceinline__ float R(float x) {
  if constexpr (BF) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// torch.maximum / torch.minimum / torch.clamp propagate NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_lohi(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// shade._take: a negative index wraps once, then clamps into [0, n)
__device__ __forceinline__ long long take_idx(long long i, long long n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}
// shade._rows takes indices in range; a kernel clamps them so that no
// address faults (in-range indices are unchanged)
__device__ __forceinline__ long long row_idx(long long i, long long n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}
// i32 arithmetic as the plain version's int32 tensors do it (wrapping)
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// shade._f32_to_i32: NaN -> 0, clamp to +-2^30, truncate
__device__ __forceinline__ int f2i(float x) {
  if (x != x) return 0;
  return static_cast<int>(clamp_lohi(x, -1073741824.0f, 1073741824.0f));
}

template <bool BF>
__device__ __forceinline__ float srgb_decode(float c) {
  const float lo = R<BF>(c * INV_12_92);
  const float base = R<BF>(R<BF>(c + 0.055f) * INV_1_055);
  // torch.pow on a bf16 tensor takes the exponent as bf16 too
  const float hi = R<BF>(powf(base, R<BF>(SRGB_GAMMA)));
  // torch compares a bf16 tensor with the knee rounded to bf16 too
  return c <= R<BF>(SRGB_KNEE) ? lo : hi;
}

// The value of a texel byte b in the compute type: b / 255 as the plain
// version's `byte * R(1/255)`, in registers.
template <bool BF>
__device__ __forceinline__ float byte_value(int b) {
  return R<BF>(static_cast<float>(b) * R<BF>(static_cast<float>(1.0 / 255.0)));
}

// S1's per-tap decode table, replicated once a lane: entry b of lane l at
// b * 32 + l (32 KB), so the 32 lanes of a warp read 32 different banks
// whatever bytes they hold. Each of the block's 256 threads decodes one
// byte; each warp then writes its 32 bytes' rows, one row a store.
constexpr int LANE_TABLE = 256 * 32;

template <bool BF>
__device__ __forceinline__ void fill_lane_table(float* tab) {
  static_assert(THREADS == 256, "one byte a thread");
  const float d = srgb_decode<BF>(byte_value<BF>(threadIdx.x));
  const int lane = threadIdx.x & 31, first = threadIdx.x & ~31;
#pragma unroll 4
  for (int j = 0; j < 32; ++j) tab[(first + j) * 32 + lane] = __shfl_sync(0xffffffffu, d, j);
}

// Where a sampler takes a texel byte's value from: raw(b) for linear
// channels, dec(b) for an sRGB channel decoded per tap.
template <bool BF>
struct LaneBytes {  // raw in registers, dec from the lane's column (S1)
  const float* tab;  // fill_lane_table's table; null where nothing decodes per tap
  int lane;
  __device__ __forceinline__ float raw(int b) const { return byte_value<BF>(b); }
  __device__ __forceinline__ float dec(int b) const { return tab[b * 32 + lane]; }
};

// The channels a caller uses (a template mask): the sampler extracts,
// decodes and filters only those. Channels are independent in the plain
// version, so each used channel keeps its bits; unused ones come back 0.
constexpr int CH_R = 1, CH_G = 2, CH_B = 4, CH_A = 8;
constexpr int CH_RGB = CH_R | CH_G | CH_B, CH_RGBA = CH_RGB | CH_A;

template <int MASK>
__device__ __forceinline__ constexpr bool uses(int ch) {
  return ((MASK >> ch) & 1) != 0;
}

struct Atlas {
  const int* atlas;
  const int* table;
  const int* srgb;
  const int* wrap;
  long long n_atlas, n_tex;
  int atlas_w;
  int last_pair;  // min(n_atlas - 1, 2^31 - 1): i in [0, last_pair) has i + 1 in range
};

__device__ __forceinline__ Atlas make_atlas(const int* atlas, const int* table,
                                            const int* srgb, const int* wrap,
                                            long long n_atlas, long long n_tex, int atlas_w) {
  const long long last = n_atlas - 1 < 0x7fffffffLL ? n_atlas - 1 : 0x7fffffffLL;
  return Atlas{atlas, table, srgb, wrap, n_atlas, n_tex, atlas_w,
               static_cast<int>(last < 0 ? 0 : last)};
}

// The texels at atlas indices take_idx(i) and take_idx(i + 1) (i32
// arithmetic wrapping): a bilinear quad's two texels of one row. When both
// lie inside the atlas (nearly always) neither index wraps or clamps, and
// one unsigned compare stands for take_idx's four.
__device__ __forceinline__ int2 texel_pair(const Atlas& a, int i) {
  if (static_cast<unsigned>(i) < static_cast<unsigned>(a.last_pair))
    return make_int2(__ldg(a.atlas + i), __ldg(a.atlas + i + 1));
  return make_int2(__ldg(a.atlas + take_idx(i, a.n_atlas)),
                   __ldg(a.atlas + take_idx(wrap_add(i, 1), a.n_atlas)));
}

// shade.make_sampler's apply_wrap for one axis (mode m: 0 repeat, 1 clamp
// to edge, 2 mirrored repeat)
__device__ __forceinline__ float wrap_axis(float u, int m, bool has_wrap) {
  const float rep = u - floorf(u);
  if (!has_wrap) return rep;
  if (m == 1) return clamp_lohi(u, 0.0f, 1.0f);
  if (m == 2) {
    const float half = u * 0.5f;
    const float t = 2.0f * (half - floorf(half)) - 1.0f;
    return 1.0f - fabsf(t);
  }
  return rep;
}

struct Slot {
  int slot;
  int wm0, wm1;  // address modes
  bool decoded;  // sRGB texture (RGB decoded, alpha linear)
};

__device__ __forceinline__ Slot slot_info(const Atlas& a, int slot) {
  Slot s;
  s.slot = slot;
  const long long t = take_idx(slot, a.n_tex);
  s.wm0 = a.wrap ? __ldg(a.wrap + 2 * t) : 0;
  s.wm1 = a.wrap ? __ldg(a.wrap + 2 * t + 1) : 0;
  s.decoded = __ldg(a.srgb + t) > 0;
  return s;
}

// one mip's rectangle in the atlas (make_sampler.sample_mip's rect)
struct MipRect {
  int x, y;
  float w, h;
};

__device__ __forceinline__ MipRect mip_rect(const Atlas& a, const Slot& s, int lod) {
  const long long ri = take_idx(wrap_add(wrap_mul(s.slot, MAX_MIPS), lod),
                                a.n_tex * MAX_MIPS);
  const int4 r = __ldg(reinterpret_cast<const int4*>(a.table) + ri);
  return MipRect{r.x, r.y, static_cast<float>(r.z), static_cast<float>(r.w)};
}

// make_sampler.sample_filtered's choice of mips, the same for every
// anisotropic tap of a sample: the nearest mip (m0), or two and their blend
// weights
struct Lod {
  MipRect m0, m1;
  float frac, om;
};

template <bool BF>
__device__ __forceinline__ Lod lod_of(const Atlas& a, const Slot& s, float lodf,
                                      bool trilinear) {
  lodf = clamp_lohi(lodf, 0.0f, MAX_MIPS - 1.0f);
  Lod L;
  if (!trilinear) {
    L.m0 = mip_rect(a, s, f2i(nearbyintf(lodf)));
    L.m1 = L.m0;
    L.frac = 0.0f;
    L.om = 1.0f;
    return L;
  }
  const float l0f = floorf(lodf);
  L.frac = R<BF>(lodf - l0f);
  const int l0 = f2i(l0f);
  L.m0 = mip_rect(a, s, l0);
  L.m1 = mip_rect(a, s, min(l0 + 1, MAX_MIPS - 1));
  L.om = R<BF>(1.0f - L.frac);
  return L;
}

// one mip of one texture at wrapped coordinates (uu, vv): bilinear over 4
// taps (make_sampler.sample_mip)
template <bool BF, bool PER_TAP, int MASK, class Bytes>
__device__ __forceinline__ float4 sample_mip(const Atlas& a, const Bytes& by, const Slot& s,
                                             const MipRect& m, float uu, float vv) {
  const float uf = uu * m.w - 0.5f;
  const float vf = vv * m.h - 0.5f;
  const float iuf = floorf(uf), ivf = floorf(vf);
  const float fu = R<BF>(uf - iuf), fv = R<BF>(vf - ivf);
  const int iu = f2i(iuf), iv = f2i(ivf);
  // taps 00, 10 (row iv) and 01, 11 (row iv + 1)
  const int xx = wrap_add(m.x, iu);
  const int yy = wrap_add(m.y, iv);
  const int2 top = texel_pair(a, wrap_add(wrap_mul(yy, a.atlas_w), xx));
  const int2 bot = texel_pair(a, wrap_add(wrap_mul(wrap_add(yy, 1), a.atlas_w), xx));
  const int texel[4] = {top.x, top.y, bot.x, bot.y};
  const float a0 = R<BF>(1.0f - fu), b0 = R<BF>(1.0f - fv);
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    if (!uses<MASK>(ch)) continue;
    const bool decoded = s.decoded && ch < 3;
    float t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int b = (texel[k] >> (8 * ch)) & 0xFF;
      t[k] = (PER_TAP && decoded) ? by.dec(b) : by.raw(b);
    }
    float x = R<BF>(R<BF>(R<BF>(t[0] * a0) * b0) + R<BF>(R<BF>(t[1] * fu) * b0));
    x = R<BF>(x + R<BF>(R<BF>(t[2] * a0) * fv));
    x = R<BF>(x + R<BF>(R<BF>(t[3] * fu) * fv));
    c[ch] = (!PER_TAP && decoded) ? srgb_decode<BF>(x) : x;
  }
  return make_float4(c[0], c[1], c[2], c[3]);
}

// make_sampler.sample_filtered at (u, v): the address modes, then the
// nearest mip or the two-mip blend of L
template <bool BF, bool PER_TAP, int MASK, class Bytes>
__device__ __forceinline__ float4 sample_filtered(const Atlas& a, const Bytes& by,
                                                  const Slot& s, const Lod& L, float u,
                                                  float v, bool trilinear) {
  const float uu = wrap_axis(u, s.wm0, a.wrap != nullptr);
  const float vv = wrap_axis(v, s.wm1, a.wrap != nullptr);
  if (!trilinear) return sample_mip<BF, PER_TAP, MASK>(a, by, s, L.m0, uu, vv);
  const float4 s0 = sample_mip<BF, PER_TAP, MASK>(a, by, s, L.m0, uu, vv);
  const float4 s1 = sample_mip<BF, PER_TAP, MASK>(a, by, s, L.m1, uu, vv);
  const float p0[4] = {s0.x, s0.y, s0.z, s0.w}, p1[4] = {s1.x, s1.y, s1.z, s1.w};
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    if (uses<MASK>(ch)) c[ch] = R<BF>(R<BF>(p0[ch] * L.om) + R<BF>(p1[ch] * L.frac));
  }
  return make_float4(c[0], c[1], c[2], c[3]);
}

// make_sampler.sample with analytic UV derivatives: per-axis texel-space
// footprint, LOD from the major (aniso <= 1) or clamped minor axis, and
// `aniso` trilinear taps along the major axis averaged as sum x (1/aniso);
// the channels of MASK only
template <bool BF, bool PER_TAP, int MASK, class Bytes>
__device__ float4 sample(const Atlas& a, const Bytes& by, int slot, float u, float v,
                         float dxu, float dxv, float dyu, float dyv, bool trilinear,
                         int aniso) {
  const Slot s = slot_info(a, slot);
  const int4 size = __ldg(reinterpret_cast<const int4*>(a.table) +
                          take_idx(slot, a.n_tex) * MAX_MIPS);
  const float w = static_cast<float>(size.z), h = static_cast<float>(size.w);
  const float qx0 = dxu * w, qx1 = dxv * h, qy0 = dyu * w, qy1 = dyv * h;
  const float lx = sqrtf(qx0 * qx0 + qx1 * qx1);
  const float ly = sqrtf(qy0 * qy0 + qy1 * qy1);
  const float rho_max = clamp_lo(nan_max(lx, ly), 1e-8f);
  if (aniso <= 1) {
    const Lod L = lod_of<BF>(a, s, log2f(rho_max), trilinear);
    return sample_filtered<BF, PER_TAP, MASK>(a, by, s, L, u, v, trilinear);
  }
  const float rho_min = nan_max(nan_min(lx, ly), rho_max * (1.0f / static_cast<float>(aniso)));
  const Lod L = lod_of<BF>(a, s, log2f(rho_min), trilinear);
  const bool x_major = lx >= ly;
  const float mu = x_major ? dxu : dyu, mv = x_major ? dxv : dyv;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < aniso; ++i) {
    const float t = static_cast<float>((i + 0.5) / aniso - 0.5);
    const float4 q = sample_filtered<BF, PER_TAP, MASK>(a, by, s, L, u + mu * t, v + mv * t,
                                                        trilinear);
    const float qc[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      if (uses<MASK>(ch)) acc[ch] = i == 0 ? qc[ch] : R<BF>(acc[ch] + qc[ch]);
    }
  }
  const float inv = R<BF>(static_cast<float>(1.0 / aniso));
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    if (uses<MASK>(ch)) c[ch] = R<BF>(acc[ch] * inv);
  }
  return make_float4(c[0], c[1], c[2], c[3]);
}

// shade.interpolants for one pixel: the candidate's three vertices, the
// 2DH perspective barycentrics lp, uv and its screen derivatives
struct Interp {
  bool covered;
  int v[3];
  float lp[3];
  float u, v_, dxu, dxv, dyu, dyv;
  int draw;
};

__device__ __forceinline__ Interp interpolate(const ShadeArgs& A, int tid_raw,
                                              int x, int y) {
  Interp it;
  it.covered = tid_raw >= 0;
  const long long t = row_idx(it.covered ? tid_raw : 0, A.n_tris);
  float X[3], Y[3], W[3], U[3], V[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    it.v[i] = static_cast<int>(row_idx(__ldg(A.tri_v + 3 * t + i), A.n_verts));
    const float4 c = __ldg(reinterpret_cast<const float4*>(A.clip) + it.v[i]);
    X[i] = (c.x * 0.5f + c.w * 0.5f) * static_cast<float>(A.width);
    Y[i] = (c.y * 0.5f + c.w * 0.5f) * static_cast<float>(A.height);
    W[i] = c.w;
    U[i] = __ldg(A.uv + 2 * it.v[i]);
    V[i] = __ldg(A.uv + 2 * it.v[i] + 1);
  }
  const float px = static_cast<float>(x) + 0.5f;
  const float py = (static_cast<float>(y) + 0.5f) + __ldg(A.row0 + y);
  float ea[3], eb[3], g[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3, k = (i + 2) % 3;
    ea[i] = Y[j] * W[k] - W[j] * Y[k];
    eb[i] = W[j] * X[k] - X[j] * W[k];
    const float cc = X[j] * Y[k] - Y[j] * X[k];
    g[i] = (ea[i] * px + eb[i] * py) + cc;
  }
  const float gsum = (g[0] + g[1]) + g[2];
  const float inv = 1.0f / (fabsf(gsum) > 1e-20f ? gsum : 1.0f);
#pragma unroll
  for (int i = 0; i < 3; ++i) it.lp[i] = g[i] * inv;
  it.u = (it.lp[0] * U[0] + it.lp[1] * U[1]) + it.lp[2] * U[2];
  it.v_ = (it.lp[0] * V[0] + it.lp[1] * V[1]) + it.lp[2] * V[2];
  float da[3], db[3], du[3], dv[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    da[i] = ea[i] * inv;
    db[i] = eb[i] * inv;
    du[i] = U[i] - it.u;
    dv[i] = V[i] - it.v_;
  }
  it.dxu = (da[0] * du[0] + da[1] * du[1]) + da[2] * du[2];
  it.dxv = (da[0] * dv[0] + da[1] * dv[1]) + da[2] * dv[2];
  it.dyu = (db[0] * du[0] + db[1] * du[1]) + db[2] * du[2];
  it.dyv = (db[0] * dv[0] + db[1] * dv[1]) + db[2] * dv[2];
  it.draw = __ldg(A.draw + it.v[0]);
  return it;
}

// lp-weighted sum of a per-vertex attribute's component k (K components)
__device__ __forceinline__ float interp_attr(const Interp& it, const float* attr,
                                             int K, int k) {
  return (it.lp[0] * __ldg(attr + K * it.v[0] + k) +
          it.lp[1] * __ldg(attr + K * it.v[1] + k)) +
         it.lp[2] * __ldg(attr + K * it.v[2] + k);
}

}  // namespace rs
