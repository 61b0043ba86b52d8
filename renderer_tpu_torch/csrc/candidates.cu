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
// Design (C1, C3; C2 below stages its ids in shared memory): one thread a
// pixel, 256 a block, the pixel index fastest, so a warp reads and writes
// each [h, w] plane of slots, candidates, alphas and shades coalesced; no
// shared memory. A pixel's candidate ids sit in
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

#include <algorithm>
#include <cstdint>

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
//
// Computed here the other way round, with the same result:
// - The floors rise with s, so candidate j passes sample s exactly when
//   s < m_j, m_j = #{s : a_j > cutoff_j and a_j > floor_s} (0 for a NaN).
//   A pixel reads the alpha and cutoff of each candidate its live slots
//   match once, and keeps m_j (a byte in shared memory).
// - The far-to-near overwrite leaves the NEAREST passing layer: the scan
//   runs k = 0 .. K-1 and takes the first, and reads only its depth and id.
// - Every slot is still matched (the clamp mask): a -1 may sit anywhere.
// The slot and candidate ids are ~93% of the bytes; on frames B and C
// only 3.4% and 0.8% of the slots are live, so the gathers are few but
// each waits a whole memory latency. Each warp is therefore a pipeline of
// its own, on tiles of 32 pixels (a lane a pixel): cp.async copies the
// tile's [S*K + n] rows of ids into the warp's stage in shared memory;
// pass 1 matches every slot against the pixel's candidates (registers;
// the warp compares only up to its lanes' last candidate >= 0, since a
// negative one never matches a live slot) and keeps each match as a byte;
// the stage is then refilled with the warp's next tile at once, so its
// copy is in flight while the warp waits on its gathers (alpha and
// cutoff, then the nearest passing layers' depths and ids); no barrier
// wider than the warp holds one warp for another's gathers. Persistent
// blocks; a warp walks the tiles gw, gw + warps, ... Reading a pixel's
// slots one after another (one or two loads in flight a thread) reached
// 48% of the bytes bound on frame B; block-wide tiles behind
// __syncthreads, whose gathers stalled every warp's copies, 44-55%.
constexpr int C2_WARPS = 8;                 // warps a block at most
constexpr int C2_STAGES = 1;                // tiles a warp copies ahead
constexpr int C2_SHARED = 110 * 1024;       // dynamic shared bytes a block at most
constexpr int C2_GROUP = 4;                 // samples whose depths are read together
constexpr int C2_CHUNK = 8;                 // slots whose ids are read at once
constexpr int C2_GATHER = 4;                // candidates whose alpha and cutoff are read at once

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_addr(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_addr(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp starts the copy of its tile, pixels [p0, p0 + 32) of the
// n_slots slot planes and then the n candidate planes, into dst [rows][32];
// 16 bytes a copy when `vec` (plane a multiple of 4, both bases 16-byte
// aligned), else 4. Pixels past the plane are not copied.
__device__ __forceinline__ void stage_tile(int* dst, const int* __restrict__ lt,
                                           const int* __restrict__ cands, int n_slots,
                                           int rows, long long plane, long long p0, bool vec,
                                           int lane) {
  const long long left = plane - p0;
  const int valid = left < 32 ? static_cast<int>(left) : 32;
  const int shift = vec ? 3 : 5;  // copies a row = 1 << shift
  const int step = vec ? 4 : 1;
  const int total = rows << shift;
  for (int i = lane; i < total; i += 32) {
    const int r = i >> shift;
    const int q = (i & ((1 << shift) - 1)) * step;
    if (q >= valid) continue;
    const int* src = (r < n_slots ? lt + r * plane : cands + (r - n_slots) * plane) + p0 + q;
    if (vec) {
      cp_async16(dst + r * 32 + q, src);
    } else {
      cp_async4(dst + r * 32 + q, src);
    }
  }
}

// m_j of one candidate: the samples it passes (a prefix of 0 .. S-1);
// `fl` holds the first C2_GROUP floors.
__device__ __forceinline__ int pass_count(float a, float co, const float (&fl)[C2_GROUP],
                                          const float* floors, int n_s) {
  int m = 0;
  if (!(a > co)) return 0;
  if (n_s <= C2_GROUP) {
#pragma unroll
    for (int s = 0; s < C2_GROUP; ++s) m += s < n_s && a > fl[s];
    return m;
  }
  while (m < n_s && a > floors[m]) ++m;
  return m;
}

// Pass 1 of one staged tile, one lane a pixel: each slot's match (the last
// candidate equal to a live id; -1 for none or a dead slot) into the byte
// rows `match` [n_slots][32], C2_CHUNK slots' ids read at once. Returns
// the candidates matched (a bit each); a live slot that matches none sets
// `clamped`.
template <int NC>
__device__ __forceinline__ unsigned match_tile(const int* stage, signed char* match,
                                               int n_slots, int n, bool valid, int lane,
                                               bool& clamped) {
  const int* col = stage + lane;
  const int* cs = stage + n_slots * 32 + lane;
  int c[NC];
  int last = 0;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    c[j] = valid && j < n ? cs[j * 32] : -1;
    if (c[j] >= 0) last = j + 1;
  }
  // a negative candidate never matches a live slot: the warp's compares
  // stop after its lanes' last candidate >= 0
  const int scan = __reduce_max_sync(0xffffffffu, last);
  unsigned need = 0;
  if (scan == 0) {  // no candidate in the warp: only the clamp mask
    if (valid) {
      for (int r = 0; r < n_slots; ++r) clamped |= col[r * 32] >= 0;
    }
    return 0;
  }
  for (int r0 = 0; r0 < n_slots; r0 += C2_CHUNK) {
    int t[C2_CHUNK], idx[C2_CHUNK];
#pragma unroll
    for (int u = 0; u < C2_CHUNK; ++u) {
      t[u] = valid && r0 + u < n_slots ? col[(r0 + u) * 32] : -1;
      idx[u] = -1;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (j >= scan) break;
#pragma unroll
      for (int u = 0; u < C2_CHUNK; ++u) {
        if (c[j] == t[u]) idx[u] = j;
      }
    }
#pragma unroll
    for (int u = 0; u < C2_CHUNK; ++u) {
      if (r0 + u >= n_slots) break;
      if (t[u] < 0) {
        idx[u] = -1;  // not a match: a candidate < 0 may equal a dead id
      } else if (idx[u] < 0) {
        clamped = true;
      } else {
        need |= 1u << idx[u];
      }
      match[(r0 + u) * 32 + lane] = static_cast<signed char>(idx[u]);
    }
  }
  return need;
}

// The rest of one pixel once its tile's ids are no longer needed: the
// matched candidates' alpha and cutoff (read once, all in flight) become
// pass counts [n][32] (bytes), then each sample's nearest passing layer,
// its depth and id read together (the id from lt, just streamed: in L2),
// and stored.
template <int NC>
__device__ __forceinline__ void merge_pixel(
    const signed char* match, unsigned char* passes, const float (&fl)[C2_GROUP],
    const float* floors, const int* __restrict__ lt, const float* __restrict__ lz,
    const float* __restrict__ alpha, const float* __restrict__ cutoff,
    int* __restrict__ solid_tid, float* __restrict__ solid_z, int n_s, int k_layers,
    long long plane, long long p, int lane, unsigned need) {
  // C2_GATHER candidates a round (a pixel matches one to three, mostly)
  for (unsigned rest = need; rest != 0;) {
    int j[C2_GATHER];
    float a[C2_GATHER], co[C2_GATHER];
#pragma unroll
    for (int q = 0; q < C2_GATHER; ++q) {
      j[q] = rest != 0 ? __ffs(rest) - 1 : -1;
      rest &= rest - 1;
    }
#pragma unroll
    for (int q = 0; q < C2_GATHER; ++q) {
      a[q] = co[q] = 0.0f;
      if (j[q] >= 0) {
        a[q] = __ldg(alpha + j[q] * plane + p);
        co[q] = __ldg(cutoff + j[q] * plane + p);
      }
    }
#pragma unroll
    for (int q = 0; q < C2_GATHER; ++q) {
      if (j[q] >= 0)
        passes[j[q] * 32 + lane] =
            static_cast<unsigned char>(pass_count(a[q], co[q], fl, floors, n_s));
    }
  }
  for (int s0 = 0; s0 < n_s; s0 += C2_GROUP) {
    int row[C2_GROUP];
#pragma unroll
    for (int u = 0; u < C2_GROUP; ++u) {
      const int s = s0 + u;
      row[u] = -1;
      if (s >= n_s) continue;
      for (int k0 = 0; k0 < k_layers && row[u] < 0; k0 += C2_CHUNK) {
        const int r0 = s * k_layers + k0;
        int idx[C2_CHUNK], m[C2_CHUNK];
#pragma unroll
        for (int v = 0; v < C2_CHUNK; ++v)
          idx[v] = k0 + v < k_layers ? match[(r0 + v) * 32 + lane] : -1;
#pragma unroll
        for (int v = 0; v < C2_CHUNK; ++v) m[v] = idx[v] >= 0 ? passes[idx[v] * 32 + lane] : 0;
#pragma unroll
        for (int v = 0; v < C2_CHUNK; ++v) {
          if (row[u] < 0 && s < m[v]) row[u] = r0 + v;
        }
      }
    }
    int t[C2_GROUP];
    float z[C2_GROUP];
#pragma unroll
    for (int u = 0; u < C2_GROUP; ++u) {
      if (row[u] < 0) continue;
      t[u] = __ldg(lt + row[u] * plane + p);
      z[u] = __ldg(lz + row[u] * plane + p);
    }
#pragma unroll
    for (int u = 0; u < C2_GROUP; ++u) {
      if (row[u] < 0) continue;
      solid_tid[(s0 + u) * plane + p] = t[u];
      solid_z[(s0 + u) * plane + p] = z[u];
    }
  }
}

// Shared bytes of one warp: C2_STAGES stages of [S*K + n][32] ids, then
// [S*K][32] matches and [n][32] pass counts (bytes).
__host__ __device__ constexpr int merge_warp_bytes(int rows) {
  return (C2_STAGES * rows * 4 + rows) * 32;
}

// The persistent kernel. Each warp is a pipeline of its own: it walks the
// 32-pixel tiles gw, gw + warps, ... (gw its index in the grid), copies
// C2_STAGES tiles ahead into its ring and refills a stage as soon as pass
// 1 has read it, so its copies stay in flight while it waits on its
// gathers; no block-wide barrier holds a warp back for another's gathers.
template <int NC>
__global__ void __launch_bounds__(C2_WARPS * 32)
merge_kernel(const int* __restrict__ lt, const float* __restrict__ lz,
             const int* __restrict__ cands, const float* __restrict__ alpha,
             const float* __restrict__ cutoff, int* __restrict__ solid_tid,
             float* __restrict__ solid_z, unsigned char* __restrict__ clamp,
             int n_s, int k_layers, int n, long long plane, int vec) {
  extern __shared__ __align__(16) int c2_shared[];
  __shared__ float floors[MAX_SLOTS];
  const int n_slots = n_s * k_layers, rows = n_slots + n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* ring = c2_shared + warp * (merge_warp_bytes(rows) / 4);
  signed char* match = reinterpret_cast<signed char*>(ring + C2_STAGES * rows * 32);
  unsigned char* passes = reinterpret_cast<unsigned char*>(match + n_slots * 32);
  for (int s = threadIdx.x; s < n_s; s += blockDim.x)
    floors[s] = n_s > 1 ? static_cast<float>((s + 0.5) / n_s) : 0.0f;
  __syncthreads();
  float fl[C2_GROUP];
#pragma unroll
  for (int s = 0; s < C2_GROUP; ++s) fl[s] = s < n_s ? floors[s] : 0.0f;
  const long long tiles = (plane + 31) >> 5;
  const long long step = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const long long first = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
#pragma unroll
  for (int i = 0; i < C2_STAGES; ++i) {
    const long long tile = first + i * step;
    if (tile < tiles)
      stage_tile(ring + i * rows * 32, lt, cands, n_slots, rows, plane, tile << 5, vec != 0,
                 lane);
    cp_async_commit();
  }
  int here = 0;
  for (long long tile = first; tile < tiles; tile += step) {
    const long long p = (tile << 5) + lane;
    const bool valid = p < plane;
    cp_async_wait<C2_STAGES - 1>();
    __syncwarp();  // every lane's copies into the stage have landed
    bool clamped = false;
    const unsigned need = match_tile<NC>(ring + here * rows * 32, match, n_slots, n, valid,
                                         lane, clamped);
    __syncwarp();  // the stage is read: refill it
    const long long ahead = tile + C2_STAGES * step;
    if (ahead < tiles)
      stage_tile(ring + here * rows * 32, lt, cands, n_slots, rows, plane, ahead << 5,
                 vec != 0, lane);
    cp_async_commit();
    here = here == C2_STAGES - 1 ? 0 : here + 1;
    if (need != 0)
      merge_pixel<NC>(match, passes, fl, floors, lt, lz, alpha, cutoff, solid_tid, solid_z,
                      n_s, k_layers, plane, p, lane, need);
    if (clamped) clamp[p] = 1;
  }
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

namespace {

// C2's launch: warps a block (as many as let their stages and bytes fit
// C2_SHARED), its dynamic shared bytes, the blocks an SM holds and the
// persistent grid. The occupancy is asked when the shape changes (a frame
// launches C2 at one shape), so a repeated launch asks the runtime only
// for the current device.
struct MergeLaunch {
  int warps = 0, shared = 0, blocks_per_sm = 0, sms = 0;
  long long grid = 0;
};

template <int NC>
cudaError_t merge_launch(int n_s, int k, int n, long long plane, MergeLaunch* out) {
  static MergeLaunch last[64];  // a device's last shape, sms = 0 before its first
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  MergeLaunch m;
  const int warp_bytes = rc::merge_warp_bytes(n_s * k + n);
  m.warps = std::min(rc::C2_WARPS, rc::C2_SHARED / warp_bytes);
  if (m.warps < 1) return cudaErrorInvalidValue;
  m.shared = m.warps * warp_bytes;
  MergeLaunch& c = last[dev];
  if (c.sms == 0) {
    err = cudaFuncSetAttribute(rc::merge_kernel<NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, rc::C2_SHARED);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&m.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  } else {
    m.sms = c.sms;
  }
  if (c.sms == 0 || c.warps != m.warps || c.shared != m.shared) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&m.blocks_per_sm, rc::merge_kernel<NC>,
                                                        m.warps * 32, m.shared);
    if (err != cudaSuccess) return err;
    c = m;
  }
  m.blocks_per_sm = c.blocks_per_sm;
  const long long tiles = (plane + 31) / 32;
  m.grid = std::min((tiles + m.warps - 1) / m.warps,
                    static_cast<long long>(m.sms) * std::max(m.blocks_per_sm, 1));
  *out = m;
  return cudaSuccess;
}

}  // namespace

// lt, lz [n_s, k, plane]; cands, alpha, cutoff [n, plane]; solid_tid,
// solid_z [n_s, plane] and clamp [plane] (u8) updated in place. At most
// MAX_SLOTS slots (n_s * k) and MAX_CANDIDATES candidates.
extern "C" int rt_masked_merge(const int* lt, const float* lz, const int* cands,
                               const float* alpha, const float* cutoff,
                               int* solid_tid, float* solid_z, unsigned char* clamp,
                               int n_s, int k, int n, long long plane, void* stream) {
  if (plane <= 0 || n_s <= 0 || k <= 0) return 0;
  if (n < 1 || n > rc::MAX_CANDIDATES || n_s * k > rc::MAX_SLOTS || !rc::grid_fits(plane))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = plane % 4 == 0 && reinterpret_cast<uintptr_t>(lt) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cands) % 16 == 0;
#define RC_CASE(NC)                                                                  \
  {                                                                                  \
    MergeLaunch m;                                                                   \
    cudaError_t err = merge_launch<NC>(n_s, k, n, plane, &m);                        \
    if (err != cudaSuccess) return static_cast<int>(err);                            \
    rc::merge_kernel<NC><<<static_cast<unsigned>(m.grid), m.warps * 32, m.shared, st>>>( \
        lt, lz, cands, alpha, cutoff, solid_tid, solid_z, clamp, n_s, k, n, plane,   \
        vec ? 1 : 0);                                                                \
    return static_cast<int>(cudaGetLastError());                                     \
  }
  RC_DISPATCH(n, RC_CASE)
#undef RC_CASE
}

// C2's launch for these sizes on the current device: out[0..5]
// = threads a block (32 a warp, a warp a 32-pixel tile), dynamic shared
// bytes a block, blocks an SM, SMs, grid, and the kernel's registers a
// thread (cudaFuncGetAttributes).
extern "C" int rt_merge_info(int n_s, int k, int n, long long plane, long long* out) {
  if (n < 1 || n > rc::MAX_CANDIDATES || n_s <= 0 || k <= 0 || n_s * k > rc::MAX_SLOTS)
    return static_cast<int>(cudaErrorInvalidValue);
#define RC_CASE(NC)                                                     \
  {                                                                     \
    MergeLaunch m;                                                      \
    cudaFuncAttributes fa;                                              \
    cudaError_t err = merge_launch<NC>(n_s, k, n, plane, &m);           \
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, rc::merge_kernel<NC>); \
    if (err != cudaSuccess) return static_cast<int>(err);               \
    out[0] = m.warps * 32;                                              \
    out[1] = m.shared;                                                  \
    out[2] = m.blocks_per_sm;                                           \
    out[3] = m.sms;                                                     \
    out[4] = m.grid;                                                    \
    out[5] = fa.numRegs;                                                \
    return 0;                                                           \
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
