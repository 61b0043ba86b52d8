// C1, C2, C3: the candidate loops of the deferred stage.
//
// Replace what the JAX package leaves to XLA to fuse inside its jitted
// frame (renderer_tpu/raster/pipeline.py `render_shard`): no Pallas kernel
// of its own. Plain versions: raster/candidates.py.
// - C1 rt_extract_candidates: `_extract_candidates` (:118), the first n
//   distinct triangle ids of a pixel's slots, and the solid pass's count
//   of distinct ids (:452-461); plain version extract_candidates_plain.
// - C2 rt_masked_merge: the masked alpha test's merge (:407-439) through
//   `_select` (:203); plain version masked_merge_plain.
// - C3 rt_resolve: the solid select (:462-476) and the blended composite
//   (:478-490); plain version resolve_plain.
//
// What bounds them on an H100: device memory. Each is a few integer
// compares and selects a slot (and, in C3, four f32 operations a channel
// a blended layer) against 4-16 bytes a slot read and written once; on
// frame B (S = 4, 8 masked and 4 blended layers, 11 / 4 / 7 candidates)
// their bytes come to ~0.2 ms at 3.35 TB/s. Eagerly, the plain loops are
// ~8,000 PyTorch launches a 1080p frame, each a pass over a [1088, 1920]
// map.
//
// Design: one thread a pixel, 256 a block, the pixel index fastest, so a
// warp reads and writes each [h, w] plane of slots, candidates, alphas and
// shades coalesced; no shared memory. A pixel's candidate ids sit in
// registers (NC, the count rounded up to 1, 2, 4, 8, 16 or 24, unrolled so
// no array spills to local memory), each slot is matched against them,
// and a value per candidate (alpha, cutoff, shade) is read only for the
// candidate a slot matches. `_select`'s semantics: the value of the LAST
// candidate equal to the slot, candidate 0's where none is. The arithmetic
// repeats the plain version's rounding with __fsub_rn / __fmul_rn /
// __fadd_rn under --fmad=false, so the kernels are bit-equal to it.
// In-place outputs (C2's solid ids and depths, the clamp mask) are stored
// only where their value changes; the others are written whole.
#include <cuda_runtime.h>

namespace rc {

constexpr int THREADS = 256;
constexpr int MAX_SLOTS = 128;      // 8 samples x 16 layers (MAX_KERNEL_LAYERS)
constexpr int MAX_CANDIDATES = 23;  // 16 layers + 7 extra candidates
constexpr int MAX_SOLID = 8;        // solid candidates: at most the MSAA count

__device__ __forceinline__ long long pixel_index() {
  return static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
}

// Index of the last of c[0..n) equal to t, -1 for none (`_select`).
template <int NC>
__device__ __forceinline__ int last_match(const int (&c)[NC], int n, int t) {
  int idx = -1;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (j < n && c[j] == t) idx = j;
  }
  return idx;
}

template <int NC>
__device__ __forceinline__ void load_ids(int (&c)[NC], const int* __restrict__ src,
                                         int n, long long plane, long long p) {
#pragma unroll
  for (int j = 0; j < NC; ++j) c[j] = j < n ? __ldg(src + j * plane + p) : 0;
}

// C1. `_extract_candidates`: the first n distinct ids != -1 in slot order
// (every other value, -2 included, is an id), -2 past the last. The plain
// version's n passes over the slots give exactly that list, built here in
// one pass. With `count`, also the number of distinct ids != -1 of all the
// slots: once the list is full, a new value is checked against the earlier
// slots themselves. ptxas holds the 16-candidate instantiation to 32
// registers and spills two candidates (16 B): bounding the kernel to four
// blocks an SM removed the spill (36 registers) but made it ~10% slower
// on frame B, so the spill, which stays in L1, is kept.
template <int NC>
__global__ void __launch_bounds__(THREADS)
extract_kernel(const int* __restrict__ slots, int* __restrict__ cands,
               int* __restrict__ count, int n_slots, int n, long long plane) {
  const long long p = pixel_index();
  if (p >= plane) return;
  int c[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) c[j] = 0;
  int m = 0, distinct = 0;
  for (int i = 0; i < n_slots; ++i) {
    if (count == nullptr && m == n) break;  // later slots change nothing
    const int t = __ldg(slots + i * plane + p);
    if (t == -1) continue;
    bool seen = false;
#pragma unroll
    for (int j = 0; j < NC; ++j) seen |= (j < m) && (c[j] == t);
    if (count != nullptr) {
      bool earlier = seen;
      for (int q = 0; q < i && !earlier && m == n; ++q)
        earlier = __ldg(slots + q * plane + p) == t;
      distinct += !earlier;
    }
    if (!seen && m < n) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (j == m) c[j] = t;
      }
      ++m;
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (j < n) cands[j * plane + p] = j < m ? c[j] : -2;
  }
  if (count != nullptr) count[p] = distinct;
}

// C2. The masked merge: per sample s, layers k = K-1 .. 0 (far to near, so
// the nearest passing fragment is written last); a live slot (t >= 0) that
// matches no candidate sets the clamp mask, and one that matches passes
// when alpha > cutoff and alpha > floor_s (the f32 of (s + 0.5) / S, 0 at
// S = 1; a NaN passes neither). A pass moves (t, its depth) into the solid
// id and depth of sample s, in place.
template <int NC>
__global__ void __launch_bounds__(THREADS)
merge_kernel(const int* __restrict__ lt, const float* __restrict__ lz,
             const int* __restrict__ cands, const float* __restrict__ alpha,
             const float* __restrict__ cutoff, int* __restrict__ solid_tid,
             float* __restrict__ solid_z, unsigned char* __restrict__ clamp,
             int n_s, int k_layers, int n, long long plane) {
  const long long p = pixel_index();
  if (p >= plane) return;
  int c[NC];
  load_ids(c, cands, n, plane, p);
  bool clamped = false;
  for (int s = 0; s < n_s; ++s) {
    const float floor_s =
        n_s > 1 ? static_cast<float>((s + 0.5) / n_s) : 0.0f;
    const long long base = static_cast<long long>(s) * k_layers;
    int tid = -1;
    float z = 0.0f;
    bool moved = false;
    for (int k = k_layers - 1; k >= 0; --k) {
      const int t = __ldg(lt + (base + k) * plane + p);
      if (t < 0) continue;
      const int idx = last_match(c, n, t);
      if (idx < 0) {
        clamped = true;
        continue;
      }
      const float a = __ldg(alpha + idx * plane + p);
      const float co = __ldg(cutoff + idx * plane + p);
      if (a > co && a > floor_s) {
        tid = t;
        z = __ldg(lz + (base + k) * plane + p);
        moved = true;
      }
    }
    if (moved) {
      solid_tid[s * plane + p] = tid;
      solid_z[s * plane + p] = z;
    }
  }
  if (clamped) clamp[p] = 1;
}

__device__ __forceinline__ float4 load4(const float* __restrict__ src, long long i) {
  return __ldg(reinterpret_cast<const float4*>(src) + i);
}

// hdr * (1 - a) + c * a, each operation rounded once, as the plain
// version's four tensor ops
__device__ __forceinline__ float over(float hdr, float c, float a, float one_minus) {
  return __fadd_rn(__fmul_rn(hdr, one_minus), __fmul_rn(c, a));
}

// C3. The solid select and the blended composite, sample by sample. The
// solid value of a covered sample (t >= 0) is its candidate's shade (an
// unmatched one takes candidate 0's and sets the clamp mask); an
// uncovered sample is +0.0. Then every blended layer k in order, empty
// and unmatched ones included: hdr = hdr * (1 - a) + rgb * a with rgb the
// selected shade and a its alpha where the layer is live, 0 where it is
// not. That is not a no-op in bits (-0.0 + 0.0 is +0.0, inf * 0 is NaN),
// so no layer is skipped. NB = 0 instantiates the solid select alone.
template <int NB>
__global__ void __launch_bounds__(THREADS)
resolve_kernel(const int* __restrict__ solid_tid, const int* __restrict__ cands_s,
               const float* __restrict__ shaded_s, const int* __restrict__ lt_b,
               const int* __restrict__ cands_b, const float* __restrict__ shaded_b,
               float* __restrict__ hdr, unsigned char* __restrict__ clamp, int n_s,
               int n_cs, int k_layers, int n_cb, long long plane) {
  const long long p = pixel_index();
  if (p >= plane) return;
  int cs[MAX_SOLID];
  load_ids(cs, cands_s, n_cs, plane, p);
  constexpr int NBR = NB > 0 ? NB : 1;
  [[maybe_unused]] int cb[NBR];
  [[maybe_unused]] float4 b0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (NB > 0) {
    load_ids(cb, cands_b, n_cb, plane, p);
    b0 = load4(shaded_b, p);
  }
  bool clamped = false;
  for (int s = 0; s < n_s; ++s) {
    const int t = __ldg(solid_tid + s * plane + p);
    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (t >= 0) {
      int idx = last_match(cs, n_cs, t);
      if (idx < 0) {
        clamped = true;
        idx = 0;
      }
      const float4 col = load4(shaded_s, idx * plane + p);
      r = col.x;
      g = col.y;
      b = col.z;
    }
    if constexpr (NB > 0) {
      const long long base = static_cast<long long>(s) * k_layers;
      for (int k = 0; k < k_layers; ++k) {
        const int tb = __ldg(lt_b + (base + k) * plane + p);
        const int idx = last_match(cb, n_cb, tb);
        if (tb >= 0 && idx < 0) clamped = true;
        const float4 col = idx < 0 ? b0 : load4(shaded_b, idx * plane + p);
        const float a = (tb >= 0 && idx >= 0) ? col.w : 0.0f;
        const float one_minus = __fsub_rn(1.0f, a);
        r = over(r, col.x, a, one_minus);
        g = over(g, col.y, a, one_minus);
        b = over(b, col.z, a, one_minus);
      }
    }
    float* out = hdr + (s * plane + p) * 3;
    out[0] = r;
    out[1] = g;
    out[2] = b;
  }
  if (clamped) clamp[p] = 1;
}

inline unsigned blocks_for(long long plane) {
  return static_cast<unsigned>((plane + THREADS - 1) / THREADS);
}

inline bool grid_fits(long long plane) {
  return (plane + THREADS - 1) / THREADS <= 0x7fffffffLL;
}

}  // namespace rc

// The candidate count n (1..23) picks the instantiation NC >= n.
#define RC_DISPATCH(n, CASE) \
  if ((n) <= 1) CASE(1)      \
  if ((n) <= 2) CASE(2)      \
  if ((n) <= 4) CASE(4)      \
  if ((n) <= 8) CASE(8)      \
  if ((n) <= 16) CASE(16)    \
  CASE(24)

// slots [n_slots, plane] i32 -> cands [n, plane] i32 and, when count is
// not null, count [plane] i32.
extern "C" int rt_extract_candidates(const int* slots, int* cands, int* count,
                                     int n_slots, int n, long long plane,
                                     void* stream) {
  if (plane <= 0) return 0;
  if (n_slots < 1 || n_slots > rc::MAX_SLOTS || n < 1 || n > rc::MAX_CANDIDATES ||
      !rc::grid_fits(plane))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define RC_CASE(NC)                                                        \
  {                                                                        \
    rc::extract_kernel<NC><<<rc::blocks_for(plane), rc::THREADS, 0, st>>>( \
        slots, cands, count, n_slots, n, plane);                           \
    return static_cast<int>(cudaGetLastError());                           \
  }
  RC_DISPATCH(n, RC_CASE)
#undef RC_CASE
}

// lt, lz [n_s, k, plane]; cands, alpha, cutoff [n, plane]; solid_tid,
// solid_z [n_s, plane] and clamp [plane] (u8) updated in place.
extern "C" int rt_masked_merge(const int* lt, const float* lz, const int* cands,
                               const float* alpha, const float* cutoff,
                               int* solid_tid, float* solid_z, unsigned char* clamp,
                               int n_s, int k, int n, long long plane, void* stream) {
  if (plane <= 0 || n_s <= 0 || k <= 0) return 0;
  if (n < 1 || n > rc::MAX_CANDIDATES || !rc::grid_fits(plane))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define RC_CASE(NC)                                                      \
  {                                                                      \
    rc::merge_kernel<NC><<<rc::blocks_for(plane), rc::THREADS, 0, st>>>( \
        lt, lz, cands, alpha, cutoff, solid_tid, solid_z, clamp, n_s, k, \
        n, plane);                                                       \
    return static_cast<int>(cudaGetLastError());                         \
  }
  RC_DISPATCH(n, RC_CASE)
#undef RC_CASE
}

// solid_tid [n_s, plane], cands_s [n_cs, plane], shaded_s [n_cs, plane, 4];
// lt_b [n_s, k, plane], cands_b [n_cb, plane], shaded_b [n_cb, plane, 4]
// (lt_b null: no blended layers) -> hdr [n_s, plane, 3]; clamp [plane]
// (u8) updated in place.
extern "C" int rt_resolve(const int* solid_tid, const int* cands_s,
                          const float* shaded_s, const int* lt_b,
                          const int* cands_b, const float* shaded_b, float* hdr,
                          unsigned char* clamp, int n_s, int n_cs, int k, int n_cb,
                          long long plane, void* stream) {
  if (plane <= 0 || n_s <= 0) return 0;
  if (n_cs < 1 || n_cs > rc::MAX_SOLID || !rc::grid_fits(plane))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define RC_LAUNCH(NB)                                                       \
  {                                                                         \
    rc::resolve_kernel<NB><<<rc::blocks_for(plane), rc::THREADS, 0, st>>>( \
        solid_tid, cands_s, shaded_s, lt_b, cands_b, shaded_b, hdr, clamp,  \
        n_s, n_cs, k, n_cb, plane);                                         \
    return static_cast<int>(cudaGetLastError());                            \
  }
  if (lt_b == nullptr || k <= 0) RC_LAUNCH(0)
  if (n_cb < 1 || n_cb > rc::MAX_CANDIDATES)
    return static_cast<int>(cudaErrorInvalidValue);
  RC_DISPATCH(n_cb, RC_LAUNCH)
#undef RC_LAUNCH
}
