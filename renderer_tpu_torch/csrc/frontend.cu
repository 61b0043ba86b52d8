// F1-F4: the raster front end, triangle setup and tile binning.
//
// Replace what the JAX package leaves to XLA to fuse inside its jitted
// frame: no Pallas kernel of its own. Plain versions: raster/setup.py
// `triangle_setup_plain` and raster/binning.py `bin_triangle_classes_plain`.
// - F1 rt_setup (setup_kernel): renderer_tpu/raster/setup.py:57
//   `triangle_setup`, a triangle a thread.
// - F2 rt_bin_spans + rt_bin_rows (spans_kernel, rows_kernel):
//   renderer_tpu/raster/binning.py:66 `_tile_spans` and stage 1 of
//   `bin_triangle_classes` (:234-278, the repeat at :239): a triangle's
//   tile span, class, band clip and z-bucket, then its tile rows.
// - F3 rt_bin_pairs (pairs_kernel): stage 2 (:279-343, the repeat at
//   :283): each row's pairs, their tile, key and extent reject, and the
//   group counts that stand for the searchsorted pair (:352-354).
// - F4 rt_bin_scan + rt_bin_scatter (scan_kernel, scatter_kernel): the
//   128-aligned starts (:356-362), the per-class overflow (:387-394) and
//   the scatter of the sorted pairs into the binned buffer (:364-380).
// Between them the wrapper runs two torch.cumsum and one stable torch.sort
// of the keys (jnp.cumsum and jnp.argsort in the JAX package).
//
// What bounds them on an H100: device memory, and at frame B's sizes
// (301,056 triangles, 1<<19 pair slots) the launches themselves. Eagerly,
// the plain versions are ~550 PyTorch launches, each a pass over one
// [Tc], [row_capacity] or [pair_capacity] vector; here one pass a stage.
//
// Design: F1 runs a triangle a thread, 128 a block, and reads a vertex's
// clip row in one 16-byte load. On frames A and B its stores alone run at
// the bytes' rate and are 70% of its time, its loads the rest; persistent
// blocks with the loads a tile ahead, tri_v staged in 16-byte loads,
// stores through shared memory and a split of setup's arithmetic over two
// warps were each no faster than this on any frame (PERF.md). Blocks of
// 128 (256 before) spread the small calls (C and the UI pass, one wave)
// over more SMs, which shortens them. F4 scatter is a gather: a block takes a tile of 256
// binned columns (512, two a thread, from 2^19 columns), finds the (class,
// tile) groups they fall in with one search a block (a group that owns
// columns is at least 128 wide, so the groups at the ends of the tile's
// 128-column segments are all it meets: two rounds of loads, where a
// search a column took up to 11), and copies each live column's pair's 16
// rows, or zeros, so the buffer is written once and needs no memset; a
// tile past the live columns loads nothing. Four columns a thread with
// 16-byte stores was slower: with every block of A in flight at once, 16
// rows of 4 KB a block wrote at half the card's rate; persistent blocks
// (the probes loaded once a block) were slower on A and B (PERF.md).
// F2 spans is bound by its bytes on large calls and by its launch on small
// ones (frame A: 1M triangles; C: 3,072). It runs a triangle a thread.
// Small calls take a narrow path, every td row a triangle reads loaded at
// once. Large ones a wide path: persistent blocks, so that A's 4,096
// blocks, whose launch alone took 2.2 us over one resident grid's, go; a
// triangle reads its bbox and z rows only when it is valid (A's and B's
// invalid triangles come in runs), and a thread's loads run a triangle
// ahead of its arithmetic. What a triangle's work shared with the others
// moved out of it: the tile reciprocals come from the host
// (binning._reciprocal), the class bounds are read once a block, the
// band's division by a stride of 1 is skipped; tri_info is written only
// for the triangles with rows, the only ones F2 rows reads. Four triangles
// a thread with 16-byte loads was slower on every call (PERF.md).
// F4 scan is one block, and its launch is most of its time. The rest was
// a chain of dependent round trips to L2 (a carry load, a loop of loads and
// stores, then a thread's loads after stores they might alias): now every
// load is issued at once (each thread's consecutive counts, the scalars by
// the last warp), then one block scan and the stores.
// The two ragged repeats, F2 rows (triangles to tile rows) and F3 (rows to
// pairs), are load-balanced expansions a block. A block owns a tile of
// consecutive items (384 in F2 rows, 512 in F3) of the merge path of the
// sources (triangles; rows) with the slots (row slots; pair slots), so a
// run of zero-count sources (invalid, off-screen or outside the band;
// rejected rows) takes tiles as slots do and a tile's sources stay few.
// Warps 0 and 1 find a tile's two splits, each with 32 probes of the
// global cumsum a step (four dependent loads and a last probe for 2^20
// sources, where a search a slot took ~20). The block then stages in
// shared memory, with coalesced loads, what its slots read: the cumsum
// segment, then for the sources that own live slots of the tile F2 rows'
// tri_info and 11 td rows (planes 0-8, xmin, xmax) by cp.async, F3's
// row_rec and its triangles' 9 plane rows (rows are in triangle order, so a
// warp reads a few triangles). Each source marks its slots with its
// index, so nothing is searched a slot. F2 rows runs persistent blocks
// that find the next tile's splits while the tile's copies are in flight.
// Past the live count (the demand, cut at the capacity, read on the
// device) a tile only writes the dead rows' 0 or the dead pairs' key with
// 16-byte stores; F3's tiles over the rows past the live ones (no pairs)
// do nothing. The grids follow the capacities (and the SMs), so a
// captured graph replays any demand. The merges need cumsums that do not
// wrap: the wrapper refuses sizes whose demand could pass 2^31 - 1.
// What bounds them: the dependent loads of a tile (the splits, the
// cumsum, the staged rows) more than the bytes (PERF.md).
// Class and group counts are integer atomics (the class totals summed over
// the warp and the block first, the group counts over a warp by
// __match_any_sync);
// integer sums do not depend on their order.
//
// Bit-equality with the plain versions: every product, sum and quotient
// is the intrinsic of the torch op it repeats (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn; torch.reciprocal is 1 / x), in torch's order,
// built with --fmad=false; torch.maximum / minimum / clamp keep a NaN
// operand, amin / amax reduce three values as torch's reduction does
// (v0 with v2, then v1); f32_to_i32 is __float2int_rz (truncation,
// saturation, NaN to 0); integer arithmetic wraps as int32 tensors do.
// Where the JAX package divides by a tile size, the plain version and the
// kernels multiply by its f32 reciprocal, as XLA does with a constant
// divisor (binning._reciprocal).
#include <cuda_runtime.h>

#include <cstdint>

namespace rf {

constexpr int THREADS = 256;
constexpr int SCAN_THREADS = 1024;
// F4 scan: the keys a pass, SCAN_PER consecutive keys a thread at most
constexpr int SCAN_KEYS = 4096;
constexpr int SCAN_PER = SCAN_KEYS / SCAN_THREADS;
static_assert(SCAN_KEYS % SCAN_THREADS == 0 && SCAN_THREADS >= 64 && SCAN_THREADS <= 1024,
              "F4 scan's block");
// F2 rows and F3: the items (sources and slots) of the merge a block takes
// (binning.EXPAND_ITEMS mirrors them) and its threads
constexpr int ROWS_ITEMS = 384;
constexpr int ROWS_THREADS = 256;
constexpr int PAIRS_ITEMS = 512;
constexpr int PAIRS_THREADS = 256;
// Where F2 rows and F3 stop, for tools/frontend_probe's timings of their
// phases alone: 0 never (the kernels), 1 after the merge splits, 2 after
// F2 rows' staging (its rows get span 0: F3 then finds no pairs); the
// outputs are then wrong.
constexpr int EXPAND_STOP = 0;
// F2 spans: its threads a block, and from how many triangles it takes its
// wide path (a triangle reads its bbox and z rows only when it is valid)
constexpr int SPANS_THREADS = 256;
constexpr int SPANS_GATE_MIN = 32768;
// What F2 spans does, for tools/frontend_probe's split of its time: 0 all
// (the kernel), 1 its loads and stores with the arithmetic cut, 2 its
// stores of n_rows alone; the outputs are then wrong.
constexpr int SPANS_STOP = 0;
// What F1 and F4 scatter do, for tools/frontend_probe's split of their time:
// 0 all (the kernels); F1: 1 its loads and stores with the arithmetic cut,
// 2 its stores alone; F4 scatter: 1 its group search, then zeros stored, 2
// its stores of zeros alone, 3 all but the td loads; the outputs are then
// wrong.
constexpr int SETUP_STOP = 0;
constexpr int SCATTER_STOP = 0;
// F1: its threads a block (setup.TILE mirrors it)
constexpr int SETUP_THREADS = 128;
// F4 scatter: its threads a block, and the consecutive columns a thread
// stores below SCATTER_WIDE_MIN binned columns (narrow) and from there
// (wide); binning.SCATTER_COLS and SCATTER_WIDE_MIN mirror them
constexpr int SCATTER_THREADS = 256;
constexpr int SCATTER_PER_NARROW = 1;
constexpr int SCATTER_PER_WIDE = 2;
constexpr int SCATTER_WIDE_MIN = 524288;  // 2^19
constexpr int ROWS = 24;        // setup.py ROWS
constexpr int B_ROWS = 16;      // binning.py B_ROWS: rows 0-14 and the id
constexpr int B_TID = 15;
constexpr int ALIGN = 128;      // binning.py ALIGN
constexpr int MAX_CLASSES = 3;  // opaque, masked, blended
constexpr float W_EPS = 1e-6f;  // setup.py W_EPS

// A count the caller gives as a Python number or a one-element int32 /
// int64 tensor on the device (read there: the host never waits for it).
struct Count {
  const void* ptr;
  long long value;
  int is64;
};

__device__ __forceinline__ long long read_count(const void* ptr, long long value, int is64) {
  if (ptr == nullptr) return value;
  return is64 ? *static_cast<const long long*>(ptr) : *static_cast<const int*>(ptr);
}

// int32 arithmetic that wraps, as torch's int32 tensors do
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// torch.maximum / torch.minimum on floats (a NaN operand is returned)
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp(x, lo, hi) on floats (NaN stays NaN)
__device__ __forceinline__ float tclamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
// torch.amin / amax over three values: the CUDA reduction runs two threads
// an output, (v0, v2) and (v1), combined in that order; ties keep the
// later operand and a NaN wins
__device__ __forceinline__ float amin3(float v0, float v1, float v2) {
  auto f = [](float a, float b) { return (a != a || a < b) ? a : b; };
  return f(f(v0, v2), v1);
}
__device__ __forceinline__ float amax3(float v0, float v1, float v2) {
  auto f = [](float a, float b) { return (a != a || a > b) ? a : b; };
  return f(f(v0, v2), v1);
}

// binning.f32_to_i32: truncate, saturate, NaN to 0
__device__ __forceinline__ int f32_to_i32(float x) { return __float2int_rz(x); }

// torch.div(a, b, rounding_mode="floor") for b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// The edge plane (a, b, c) = u_a x u_b of setup.cross
struct Plane {
  float a, b, c;
};
__device__ __forceinline__ Plane cross(float xa, float ya, float wa, float xb, float yb,
                                       float wb) {
  return {__fsub_rn(__fmul_rn(ya, wb), __fmul_rn(wa, yb)),
          __fsub_rn(__fmul_rn(wa, xb), __fmul_rn(xa, wb)),
          __fsub_rn(__fmul_rn(xa, yb), __fmul_rn(ya, xb))};
}

// ---------------------------------------------------------------------------
// F1. triangle_setup: gathers a triangle's three clip vertices and writes
// its column of the [24, tc] SoA, zero where it is invalid. A triangle a
// thread, SETUP_THREADS a block, consecutive threads on consecutive
// triangles, so the rows are written coalesced; a vertex's clip row is one
// 16-byte load (the wrapper refuses a clip that is not 16-byte aligned).
template <bool DOUBLE_SIDED>
__global__ void __launch_bounds__(SETUP_THREADS)
setup_kernel(const float4* __restrict__ clip, const int* __restrict__ tri_v, Count num_tris,
             float* __restrict__ out, int tc, long long n_verts, float width, float height,
             float bbox_pad, float maxdim) {
  const long long t = static_cast<long long>(blockIdx.x) * SETUP_THREADS + threadIdx.x;
  if (t >= tc) return;
  if (SETUP_STOP == 2) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) out[r * static_cast<long long>(tc) + t] = 0.0f;
    return;
  }
  float xs[3], ys[3], ws[3], zs[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    long long vi = __ldg(tri_v + 3 * t + v);
    if (vi < 0) vi += n_verts;  // torch's negative index
    if (vi < 0 || vi >= n_verts) vi = 0;  // out of range: the plain version's assert
    const float4 c = __ldg(clip + vi);
    if (SETUP_STOP == 1) {
      xs[v] = c.x;
      ys[v] = c.y;
      zs[v] = c.z;
      ws[v] = c.w;
      continue;
    }
    const float hw = __fmul_rn(c.w, 0.5f);
    xs[v] = __fmul_rn(__fadd_rn(__fmul_rn(c.x, 0.5f), hw), width);
    ys[v] = __fmul_rn(__fadd_rn(__fmul_rn(c.y, 0.5f), hw), height);
    ws[v] = c.w;
    zs[v] = c.z;
  }
  if (SETUP_STOP == 1) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int v = (r / 4) % 3, k = r % 4;
      out[r * static_cast<long long>(tc) + t] = k == 0 ? xs[v] : k == 1 ? ys[v] : k == 2 ? zs[v]
                                                                                       : ws[v];
    }
    return;
  }
  // v1 <-> v2 (setup.py `order`)
  const float x0 = xs[0], x1 = xs[2], x2 = xs[1];
  const float y0 = ys[0], y1 = ys[2], y2 = ys[1];
  const float w0 = ws[0], w1 = ws[2], w2 = ws[1];
  const float z0 = zs[0], z1 = zs[2], z2 = zs[1];

  Plane e0 = cross(x1, y1, w1, x2, y2, w2);
  Plane e1 = cross(x2, y2, w2, x0, y0, w0);
  Plane e2 = cross(x0, y0, w0, x1, y1, w1);
  float det = __fadd_rn(__fadd_rn(__fmul_rn(e0.a, x0), __fmul_rn(e0.b, y0)),
                        __fmul_rn(e0.c, w0));
  if (DOUBLE_SIDED) {
    const float flip = det < 0.0f ? -1.0f : 1.0f;
    auto flipped = [flip](const Plane& e) {
      return Plane{__fmul_rn(e.a, flip), __fmul_rn(e.b, flip), __fmul_rn(e.c, flip)};
    };
    e0 = flipped(e0);
    e1 = flipped(e1);
    e2 = flipped(e2);
    det = __fmul_rn(det, flip);
  }
  const bool front = det > 0.0f;
  const float inv_det = __fdiv_rn(1.0f, front ? det : 1.0f);
  const float w_a = __fmul_rn(__fadd_rn(__fadd_rn(e0.a, e1.a), e2.a), inv_det);
  const float w_b = __fmul_rn(__fadd_rn(__fadd_rn(e0.b, e1.b), e2.b), inv_det);
  const float w_c = __fmul_rn(__fadd_rn(__fadd_rn(e0.c, e1.c), e2.c), inv_det);

  const bool all_front = ws[0] > W_EPS && ws[1] > W_EPS && ws[2] > W_EPS;
  const bool any_front = ws[0] > W_EPS || ws[1] > W_EPS || ws[2] > W_EPS;
  float px[3], py[3], sz[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const float inv_w = __fdiv_rn(1.0f, fabsf(ws[v]) > W_EPS ? ws[v] : 1.0f);
    px[v] = __fmul_rn(xs[v], inv_w);
    py[v] = __fmul_rn(ys[v], inv_w);
    sz[v] = __fmul_rn(zs[v], inv_w);
  }
  // depth plane: screen-space differences when all in front, else the
  // homogeneous form
  const float sx0 = px[0], sx1 = px[2], sx2 = px[1];
  const float sy0 = py[0], sy1 = py[2], sy2 = py[1];
  const float sz0 = sz[0], sz1 = sz[2], sz2 = sz[1];
  const float dx1 = __fsub_rn(sx1, sx0), dx2 = __fsub_rn(sx2, sx0);
  const float dy1 = __fsub_rn(sy1, sy0), dy2 = __fsub_rn(sy2, sy0);
  const float dz1 = __fsub_rn(sz1, sz0), dz2 = __fsub_rn(sz2, sz0);
  const float area2 = __fsub_rn(__fmul_rn(dx1, dy2), __fmul_rn(dy1, dx2));
  const float inv_area = __fdiv_rn(1.0f, fabsf(area2) > 1e-20f ? area2 : 1.0f);
  const float zss_a = __fmul_rn(__fsub_rn(__fmul_rn(dz1, dy2), __fmul_rn(dz2, dy1)), inv_area);
  const float zss_b = __fmul_rn(__fsub_rn(__fmul_rn(dz2, dx1), __fmul_rn(dz1, dx2)), inv_area);
  const float zss_c = __fsub_rn(__fsub_rn(sz0, __fmul_rn(zss_a, sx0)), __fmul_rn(zss_b, sy0));
  auto hom = [&](float p0, float p1, float p2) {
    return __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(z0, p0), __fmul_rn(z1, p1)),
                               __fmul_rn(z2, p2)), inv_det);
  };
  const float z_a = all_front ? zss_a : hom(e0.a, e1.a, e2.a);
  const float z_b = all_front ? zss_b : hom(e0.b, e1.b, e2.b);
  const float z_c = all_front ? zss_c : hom(e0.c, e1.c, e2.c);

  const float xmin = all_front ? __fsub_rn(amin3(px[0], px[1], px[2]), bbox_pad) : 0.0f;
  const float xmax = all_front ? __fadd_rn(amax3(px[0], px[1], px[2]), bbox_pad) : width;
  const float ymin = all_front ? __fsub_rn(amin3(py[0], py[1], py[2]), bbox_pad) : 0.0f;
  const float ymax = all_front ? __fadd_rn(amax3(py[0], py[1], py[2]), bbox_pad) : height;
  const bool on_screen = xmax >= 0.0f && xmin <= width && ymax >= 0.0f && ymin <= height;

  // f32 tolerance of a·px + b·py + c, folded into c by the ownership rule
  const float abs_c = tmax(fabsf(e0.c), tmax(fabsf(e1.c), fabsf(e2.c)));
  const float abs_ab = tmax(tmax(fabsf(e0.a), fabsf(e0.b)),
                            tmax(tmax(fabsf(e1.a), fabsf(e1.b)),
                                 tmax(fabsf(e2.a), fabsf(e2.b))));
  const float eps = __fmul_rn(__fadd_rn(abs_c, __fmul_rn(maxdim, abs_ab)), 0x1p-21f);
  auto shift = [&](const Plane& e) {
    const bool own = e.a > 0.0f || (e.a == 0.0f && e.b > 0.0f);
    return __fadd_rn(e.c, own ? eps : -eps);
  };
  const float c0 = shift(e0), c1 = shift(e1), c2 = shift(e2);

  const bool in_range = t < read_count(num_tris.ptr, num_tris.value, num_tris.is64);
  const bool valid = in_range && front && any_front && on_screen;
  const float rows[ROWS] = {e0.a, e0.b, c0, e1.a, e1.b, c1, e2.a, e2.b, c2,
                            z_a, z_b, z_c, w_a, w_b, w_c,
                            xmin, ymin, xmax, ymax, 1.0f, 0.0f, eps, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < ROWS; ++r) out[r * static_cast<long long>(tc) + t] = valid ? rows[r] : 0.0f;
}

// ---------------------------------------------------------------------------
// The binning kernels share one argument structure (kernels.py BinArgs).
struct BinArgs {
  const float* td;       // [24, tc] triangle_setup's SoA
  int* n_rows;           // [tc] a triangle's tile rows in this call's row set
  int4* tri_info;        // [tc] (tx0, span_w, k0, cls + 4 * z-bucket), where n_rows > 0
  const int* cum_r;      // [tc] inclusive cumsum of n_rows
  int* row_span;         // [rc] a row's tile columns
  int4* row_rec;         // [rc] (triangle, first column, local row k, cls + 4 * z-bucket)
  const int* cum_p;      // [rc] inclusive cumsum of row_span
  int* key;              // [pc] (class, tile, z-bucket) key, or `dead`
  int* tri_pair;         // [pc] a pair's triangle
  const long long* order;  // [pc] the stable sort's permutation of the keys
  int* acc;              // counts [n_keys] | class_pairs [C] | keys below 0 [1]
  int* scan;             // padded_starts [n_keys] | starts_raw [n_keys] |
                         // overflow [C] | row_overflow | pair demand | row demand
  float* binned;         // [16, p_total]
  const void* bound_ptr[MAX_CLASSES + 1];
  long long bound_value[MAX_CLASSES + 1];
  long long p_total;
  int bound_is64[MAX_CLASSES + 1];
  int tc, rc, pc, n_classes, tiles_x, tiles_y, tile_w, tile_h;
  int tile_row_lo, local_tiles_y, row_stride, zbuckets;
  float inv_tile_w, inv_tile_h;  // binning._reciprocal of tile_w, tile_h
};

__device__ __forceinline__ long long bound(const BinArgs& A, int c) {
  return read_count(A.bound_ptr[c], A.bound_value[c], A.bound_is64[c]);
}

__device__ __forceinline__ int n_keys(const BinArgs& A) {
  return A.n_classes * A.tiles_x * A.local_tiles_y;
}

// _tile_spans' span: the first tile and the tile count covering any pixel
// centre of [lo, hi], with the tile size's f32 reciprocal `inv` (the host's
// binning._reciprocal) and the last tile `nm1`
__device__ __forceinline__ int2 tile_span(float lo, float hi, float inv, float nm1) {
  const int t0 =
      f32_to_i32(tclamp(ceilf(__fsub_rn(__fmul_rn(__fadd_rn(lo, 0.5f), inv), 1.0f)), 0.0f, nm1));
  const int t1 = f32_to_i32(tclamp(floorf(__fmul_rn(__fsub_rn(hi, 0.5f), inv)), 0.0f, nm1));
  return make_int2(t0, max(wadd(wsub(t1, t0), 1), 0));
}

// One triangle of F2 spans: its row count in the band (0 without pairs)
// and its tri_info (tx0, span_w, k0, cls + 4 * z-bucket), which F2 rows
// reads only for triangles with rows. z: the z plane's rows 9-11, read
// only with zbuckets > 1.
__device__ __forceinline__ int span_rows(const BinArgs& A, bool valid, int cls, float xmin,
                                         float ymin, float xmax, float ymax, float za,
                                         float zbp, float zc, int4* info) {
  const int2 sx = tile_span(xmin, xmax, A.inv_tile_w, static_cast<float>(A.tiles_x - 1));
  const int2 sy = tile_span(ymin, ymax, A.inv_tile_h, static_cast<float>(A.tiles_y - 1));
  const int n_pairs = valid ? wmul(sx.y, sy.y) : 0;
  // the band: rows {row_lo + k * stride}, k in [0, local_tiles_y); a
  // division by a stride of 1 (every call but the mesh's bands) is the
  // identity, so it is skipped
  const int ty1 = wsub(wadd(sy.x, sy.y), 1);
  int k0, k1;
  if (A.row_stride == 1) {
    k0 = max(wsub(0, wsub(A.tile_row_lo, sy.x)), 0);
    k1 = min(wsub(ty1, A.tile_row_lo), A.local_tiles_y - 1);
  } else {
    k0 = max(wsub(0, floor_div(wsub(A.tile_row_lo, sy.x), A.row_stride)), 0);
    k1 = min(floor_div(wsub(ty1, A.tile_row_lo), A.row_stride), A.local_tiles_y - 1);
  }
  const int band_h = max(wadd(wsub(k1, k0), 1), 0);
  const bool has_pairs = n_pairs > 0 && wmul(sx.y, band_h) > 0;
  int zb = 0;
  if (A.zbuckets > 1) {
    // nearest-first sub-key: the z plane's corner max over the bbox
    const float z_near = tclamp(
        __fadd_rn(__fadd_rn(__fmul_rn(za, za > 0.0f ? xmax : xmin),
                            __fmul_rn(zbp, zbp > 0.0f ? ymax : ymin)), zc), 0.0f, 1.0f);
    const int q = f32_to_i32(__fmul_rn(__fsub_rn(1.0f, z_near),
                                       static_cast<float>(A.zbuckets)));
    zb = min(max(q, 0), A.zbuckets - 1);
  }
  *info = make_int4(sx.x, sx.y, k0, cls + 4 * zb);
  return has_pairs ? band_h : 0;
}

// A triangle's td rows in F2 spans: valid, xmin, ymin, xmax, ymax and the
// z plane's a, b, c
struct SpanRows {
  float v, x0, y0, x1, y1, za, zb, zc;
};

__device__ __forceinline__ void span_bbox(SpanRows& s, const float* __restrict__ td,
                                          long long tc, long long t, bool zrows) {
  s.x0 = __ldg(td + 15 * tc + t);
  s.y0 = __ldg(td + 16 * tc + t);
  s.x1 = __ldg(td + 17 * tc + t);
  s.y1 = __ldg(td + 18 * tc + t);
  if (zrows) {
    s.za = __ldg(td + 9 * tc + t);
    s.zb = __ldg(td + 10 * tc + t);
    s.zc = __ldg(td + 11 * tc + t);
  }
}

// F2, its first pass: per triangle, the tile span, class, band clip and
// z-bucket, and its row count for the cumsum; zeroes the atomic counters.
// A triangle a thread, on one of two paths by the call's size. Narrow
// (below SPANS_GATE_MIN triangles, frame C and the UI pass: one wave,
// launch-bound): a triangle's td rows are all loaded at once, while the
// class bounds are read. Wide (GATE, frames A and B): persistent blocks
// (the grid from the occupancy query) walk the triangles, and a triangle
// reads its bbox and z rows only when it is valid (invalid triangles come
// in runs there), a round trip after its valid row; so that the trip
// overlaps other work, a thread's loads run ahead of its arithmetic: while
// it computes one triangle, the next one's bbox rows and the one after's
// valid row are in flight. Both read the class bounds once a block,
// clamped to [0, tc] (the same comparisons for t in [0, tc)), and write
// tri_info only for the triangles with rows (the only ones F2 rows reads).
template <bool GATE>
__global__ void __launch_bounds__(SPANS_THREADS) spans_kernel(const BinArgs A) {
  __shared__ int bnd[MAX_CLASSES + 1];
  const int tc = A.tc;
  const long long step = static_cast<long long>(gridDim.x) * SPANS_THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * SPANS_THREADS + threadIdx.x;
  const bool zrows = A.zbuckets > 1;
  const float* __restrict__ td = A.td;
  const float* __restrict__ valid_row = td + 19LL * tc;
  // the loads that need no bound go out before the barrier: the first
  // triangle's rows (wide: its valid row, and the next triangle's)
  SpanRows cur{};
  float ahead = 0.0f;  // wide: the valid row of the triangle after the next
  if (SPANS_STOP != 2 && first < tc) {
    cur.v = __ldg(valid_row + first);
    if (!GATE) span_bbox(cur, td, tc, first, zrows);
    if (GATE && first + step < tc) ahead = __ldg(valid_row + first + step);
  }
  if (threadIdx.x <= A.n_classes) {
    const long long b = bound(A, threadIdx.x);
    bnd[threadIdx.x] = static_cast<int>(b < 0 ? 0 : (b > tc ? tc : b));
  }
  const int n_acc = n_keys(A) + A.n_classes + 1;
  for (long long i = first; i < n_acc; i += step) A.acc[i] = 0;
  __syncthreads();
  const int lo = bnd[0], hi = bnd[A.n_classes];
  // a class bound past every triangle where the class does not exist
  const int b1 = A.n_classes > 1 ? bnd[1] : tc, b2 = A.n_classes > 2 ? bnd[2] : tc;
  auto valid_of = [&](float v, long long t) { return v > 0.0f && t >= lo && t < hi; };
  bool valid = false;
  if (GATE && first < tc) {
    valid = valid_of(cur.v, first);
    if (valid) span_bbox(cur, td, tc, first, zrows);
  }
  for (long long i = first; i < tc; i += step) {
    const int t = static_cast<int>(i);
    if (SPANS_STOP == 2) {
      A.n_rows[t] = 0;
      continue;
    }
    if (!GATE) valid = valid_of(cur.v, i);
    // the next triangle's loads, before this one's arithmetic
    SpanRows next{};
    bool next_valid = false;
    const long long i1 = i + step;
    if (GATE) {
      next.v = ahead;
      if (i1 < tc) {
        next_valid = valid_of(next.v, i1);
        if (next_valid) span_bbox(next, td, tc, i1, zrows);
      }
      ahead = i1 + step < tc ? __ldg(valid_row + i1 + step) : 0.0f;
    } else if (i1 < tc) {
      next.v = __ldg(valid_row + i1);
      span_bbox(next, td, tc, i1, zrows);
    }
    int n = 0;
    if (!GATE || valid) {
      int4 info;
      if (SPANS_STOP == 1) {
        // one row of one column a valid triangle, so that the later steps
        // stay sane
        n = valid;
        info = make_int4(0, 1, 0, __float_as_int(cur.x0) ^ __float_as_int(cur.y0) ^
                                      __float_as_int(cur.x1) ^ __float_as_int(cur.y1) ^
                                      __float_as_int(cur.za + cur.zb + cur.zc));
      } else {
        n = span_rows(A, valid, (t >= b1) + (t >= b2), cur.x0, cur.y0, cur.x1, cur.y1, cur.za,
                      cur.zb, cur.zc, &info);
      }
      if (n > 0) A.tri_info[t] = info;
    }
    A.n_rows[t] = n;
    cur = next;
    valid = next_valid;
  }
}

// F2 rows and F3 expand each source (a triangle; a row) into its slots (its
// tile rows; its pairs), given the inclusive cumsum cum[0, n_src) of the
// counts. A block owns ITEMS consecutive items of the merge of the sources
// with the slots 0 .. n_slots - 1 in which slot j comes before source i iff
// j < cum[i]: a source follows its own slots, so it stands at i + cum[i]
// (cum cut at n_slots), and slot j's source is the number of sources
// before it, upper_bound(cum, j). A run of zero-count sources is a run of
// items like any other, so a block's sources are as few as its items,
// whatever the counts.

// The merge's split at diagonal d: the sources among its first d items,
// the first i in [0, n_src) with i + min(cum[i], n_slots) >= d (n_src if
// none). Called by a whole warp: 32 probes a step narrow the range
// 32-fold (four steps and a last probe for 2^20 sources). The probes
// depend on d only through the range they narrow, so every block probes
// the same first 32 values and neighbouring blocks the same next ones.
__device__ long long merge_split(const int* __restrict__ cum, long long n_src,
                                 long long n_slots, long long d) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  auto after = [&](long long i) {
    return i + min(static_cast<long long>(__ldg(cum + i)), n_slots) >= d;
  };
  long long lo = 0, hi = n_src;  // the split lies in [lo, hi]
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const long long p = lo + span * lane / 32;
    const unsigned m = __ballot_sync(0xffffffffu, after(p));
    if (m == 0) {
      lo += span * 31 / 32 + 1;
    } else {
      const int f = __ffs(m) - 1;
      hi = lo + span * f / 32;
      if (f > 0) lo += span * (f - 1) / 32 + 1;
    }
  }
  const long long p = lo + lane;
  const unsigned m = __ballot_sync(0xffffffffu, p < hi && after(p));
  return m ? lo + __ffs(m) - 1 : hi;
}

// v into p[lo, hi) by the whole block: 16-byte stores between the
// unaligned ends
__device__ void block_fill(int* __restrict__ p, long long lo, long long hi, int v) {
  if (lo >= hi) return;
  int* const a = p + lo;
  int* const e = p + hi;
  int* a4 = reinterpret_cast<int*>((reinterpret_cast<uintptr_t>(a) + 15) & ~uintptr_t{15});
  int* e4 = reinterpret_cast<int*>(reinterpret_cast<uintptr_t>(e) & ~uintptr_t{15});
  if (a4 > e) a4 = e;
  if (e4 < a4) e4 = a4;
  for (int* q = a + threadIdx.x; q < a4; q += blockDim.x) *q = v;
  const int4 v4 = make_int4(v, v, v, v);
  for (int4* q = reinterpret_cast<int4*>(a4) + threadIdx.x; q < reinterpret_cast<int4*>(e4);
       q += blockDim.x)
    *q = v4;
  for (int* q = e4 + threadIdx.x; q < e; q += blockDim.x) *q = v;
}

// Copies to shared memory that wait for nothing until cp_async_wait_all:
// a thread's staging loads are all in flight at once.
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_addr(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(shared_addr(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A block's shared memory in F2 rows or F3: the tile's cumsum segment,
// each slot's source, and an int4 record and `cols` f32 rows a source.
struct ExpandSmem {
  int* cum;    // [items + 2]: cum[i0 - 1 + k] (0 before the first source)
  int* src;    // [items]: slot j0 + s belongs to source src[s]
  int4* rec;   // [items + 1]: F2 rows' tri_info, F3's row_rec
  float* col;  // [cols][items + 1]: td rows
};
__host__ __device__ constexpr int expand_smem_bytes(int items, int cols) {
  return 4 * (items + 2) + 4 * items + 16 +  // + 16: rec 16-byte aligned
         (16 + 4 * cols) * (items + 1);
}
__device__ __forceinline__ ExpandSmem expand_smem(unsigned char* base, int items) {
  ExpandSmem m;
  m.cum = reinterpret_cast<int*>(base);
  m.src = m.cum + items + 2;
  m.rec = reinterpret_cast<int4*>(
      (reinterpret_cast<uintptr_t>(m.src + items) + 15) & ~uintptr_t{15});
  m.col = reinterpret_cast<float*>(m.rec + items + 1);
  return m;
}

// Whether staged source k owns slots of the tile's live ones [j0, j_live)
__device__ __forceinline__ bool owns_slots(const ExpandSmem& m, int k, long long j0,
                                           long long j_live) {
  return max(static_cast<long long>(m.cum[k]), j0) <
         min(static_cast<long long>(m.cum[k + 1]), j_live);
}

// After the cumsum segment is staged: marks each live slot with its
// source (m.src), so that a slot reads its source instead of searching
// for it.
__device__ void map_slots(const ExpandSmem& m, int n_s, long long j0, long long j_live,
                          int threads) {
  for (int k = threadIdx.x; k < n_s; k += threads) {
    const int lo = static_cast<int>(max(static_cast<long long>(m.cum[k]), j0));
    const int hi = static_cast<int>(min(static_cast<long long>(m.cum[k + 1]), j_live));
    for (int s = lo; s < hi; ++s) m.src[s - j0] = k;
  }
}

// td rows a row's x-window reads: the edge planes 0-8, xmin and xmax; a
// pair's extent reject: the edge planes
constexpr int ROW_COLS = 11;
constexpr int PAIR_COLS = 9;
__device__ __forceinline__ int row_col(int c) { return c < 9 ? c : (c == 9 ? 15 : 17); }
constexpr int ROWS_SMEM = expand_smem_bytes(ROWS_ITEMS, ROW_COLS);
constexpr int PAIRS_SMEM = expand_smem_bytes(PAIRS_ITEMS, PAIR_COLS);
static_assert(ROWS_SMEM <= 227 * 1024 && PAIRS_SMEM <= 227 * 1024, "shared memory a block");

// Warps 0 and 1 find the splits at a tile's two ends (into `split`).
// F2 rows runs persistent blocks that walk tiles of ROWS_ITEMS items of the
// merge, gridDim apart: while a tile's staging copies are in flight, they
// find the next tile's splits, so the search's loads and the staging's
// overlap.
__device__ __forceinline__ void next_split(const int* __restrict__ cum, long long n_src,
                                           long long n_slots, long long d0, long long d1,
                                           long long* split) {
  const int warp = static_cast<int>(threadIdx.x >> 5);
  if (warp < 2) {
    const long long s = merge_split(cum, n_src, n_slots, warp ? d1 : d0);
    if ((threadIdx.x & 31) == 0) split[warp] = s;
  }
}

// F2, its second pass: tiles of ROWS_ITEMS items of the merge of the
// triangles with the row slots r < rc. A live row (r below the row
// demand) takes its triangle's tile row, narrows the triangle's columns to
// the edges' x-window over the row's padded extent and adds the row's
// columns to its class's pair total (summed over the thread's tiles, the
// warp, then the block); a dead row's span is 0.
__global__ void __launch_bounds__(ROWS_THREADS) rows_kernel(const BinArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long split[2];
  __shared__ int class_pairs[MAX_CLASSES];
  constexpr int STAGED = ROWS_ITEMS + 1;
  const ExpandSmem m = expand_smem(smem, ROWS_ITEMS);
  const long long n_src = A.tc, n_slots = A.rc, tc = A.tc;
  const long long n_items = n_src + n_slots;
  const long long tiles = (n_items + ROWS_ITEMS - 1) / ROWS_ITEMS;
  const int live = min(__ldg(A.cum_r + A.tc - 1), A.rc);
  // the tiles before every triangle is behind (past them: dead rows only)
  const long long live_tiles = min(tiles, (n_src + live + ROWS_ITEMS - 1) / ROWS_ITEMS);
  auto d_of = [&](long long t) { return min(t * ROWS_ITEMS, n_items); };
  if (threadIdx.x < MAX_CLASSES) class_pairs[threadIdx.x] = 0;
  if (blockIdx.x < live_tiles)
    next_split(A.cum_r, n_src, n_slots, d_of(blockIdx.x), d_of(blockIdx.x + 1), split);
  __syncthreads();
  const float inv_w = __fdiv_rn(1.0f, static_cast<float>(A.tile_w));
  int total[MAX_CLASSES] = {0, 0, 0};
  for (long long t = blockIdx.x; t < live_tiles; t += gridDim.x) {
    const long long d0 = d_of(t), d1 = d_of(t + 1), tn = t + gridDim.x;
    const long long i0 = split[0], i1 = split[1], j0 = d0 - i0, j1 = d1 - i1;
    __syncthreads();  // split is read: the next tile's may be written
    if (j0 >= j1 || j0 >= live || EXPAND_STOP == 1) {
      if (EXPAND_STOP != 1) block_fill(A.row_span, j0, j1, 0);
      if (tn < live_tiles) next_split(A.cum_r, n_src, n_slots, d_of(tn), d_of(tn + 1), split);
      __syncthreads();
      continue;
    }
    // the triangles the tile's live rows can take: i0 .. min(i1, tc - 1)
    const int n_s = static_cast<int>(min(i1, n_src - 1) - i0 + 1);
    for (int k = threadIdx.x; k <= n_s; k += ROWS_THREADS) {
      if (i0 + k > 0) cp_async4(m.cum + k, A.cum_r + i0 + k - 1);
      else m.cum[k] = 0;
    }
    cp_async_wait_all();
    __syncthreads();
    const long long j_live = min(j1, static_cast<long long>(live));
    map_slots(m, n_s, j0, j_live, ROWS_THREADS);
    for (int k = threadIdx.x; k < n_s; k += ROWS_THREADS) {
      if (!owns_slots(m, k, j0, j_live)) continue;
      const long long tri = i0 + k;
      cp_async16(m.rec + k, A.tri_info + tri);
#pragma unroll
      for (int r = 0; r < ROW_COLS; ++r)
        cp_async4(m.col + r * STAGED + k, A.td + row_col(r) * tc + tri);
    }
    if (tn < live_tiles) next_split(A.cum_r, n_src, n_slots, d_of(tn), d_of(tn + 1), split);
    cp_async_wait_all();
    __syncthreads();
    if (EXPAND_STOP == 2) {
      for (long long j = j0 + threadIdx.x; j < j1; j += ROWS_THREADS)
        A.row_span[j] = m.rec[0].x == 1 && m.col[0] == 1.0f && j < 0;
      continue;
    }
    for (long long j = j0 + threadIdx.x; j < j1; j += ROWS_THREADS) {
      int span = 0;
      if (j < live) {
        const int r = static_cast<int>(j);
        const int k = m.src[r - j0];
        const int4 info = m.rec[k];
        const float* col = m.col + k;
        // m.cum[k] = cum_r[t] - n_rows[t], the triangle's first row
        const int row_k = wadd(info.z, wsub(r, m.cum[k]));
        const int row_ty = wadd(A.tile_row_lo, wmul(row_k, A.row_stride));
        const float ext_y0 = __fsub_rn(__fmul_rn(__int2float_rn(row_ty),
                                                 static_cast<float>(A.tile_h)), 0.5f);
        const float ext_y1 = __fadd_rn(ext_y0, static_cast<float>(A.tile_h) + 1.0f);
        float xlo = col[9 * STAGED], xhi = col[10 * STAGED];
        bool alive = true;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const float a = col[(3 * e) * STAGED];
          const float b = col[(3 * e + 1) * STAGED];
          const float c = col[(3 * e + 2) * STAGED];
          const float bb = __fadd_rn(__fmul_rn(b, b > 0.0f ? ext_y1 : ext_y0), c);
          const float x = __fdiv_rn(-bb, a == 0.0f ? 1.0f : a);
          if (a > 0.0f) xlo = tmax(xlo, x);
          if (a < 0.0f) xhi = tmin(xhi, x);
          alive = alive && (a != 0.0f || bb >= 0.0f);
        }
        xlo = __fsub_rn(xlo, 1.0f);
        xhi = __fadd_rn(xhi, 1.0f);
        const int rx_lo = max(info.x, f32_to_i32(ceilf(__fsub_rn(
                                          __fmul_rn(__fsub_rn(xlo, 0.5f), inv_w), 1.0f))));
        const int rx_hi = min(wsub(wadd(info.x, info.y), 1),
                              f32_to_i32(floorf(__fmul_rn(__fadd_rn(xhi, 0.5f), inv_w))));
        span = alive ? max(wadd(wsub(rx_hi, rx_lo), 1), 0) : 0;
        A.row_rec[r] = make_int4(static_cast<int>(i0) + k, rx_lo, row_k, info.w);
#pragma unroll
        for (int c = 0; c < MAX_CLASSES; ++c)
          total[c] = wadd(total[c], (info.w & 3) == c ? span : 0);
      }
      A.row_span[j] = span;
    }
  }
  // past every triangle: dead rows only
  for (long long t = live_tiles + (blockIdx.x + gridDim.x - live_tiles % gridDim.x) % gridDim.x;
       t < tiles; t += gridDim.x)
    block_fill(A.row_span, d_of(t) - n_src, d_of(t + 1) - n_src, 0);
#pragma unroll
  for (int c = 0; c < MAX_CLASSES; ++c) {
    const int t = __reduce_add_sync(0xffffffffu, total[c]);
    if ((threadIdx.x & 31) == 0 && t != 0) atomicAdd(&class_pairs[c], t);
  }
  __syncthreads();
  if (threadIdx.x < A.n_classes && class_pairs[threadIdx.x] != 0)
    atomicAdd(A.acc + n_keys(A) + threadIdx.x, class_pairs[threadIdx.x]);
}

// F3: a block of PAIRS_ITEMS items of the merge of the rows with the pair
// slots p < pc. A live pair (p below the pair demand) takes its row's tile,
// its key and the extent reject (every edge's most-inside corner of the
// tile's sample extent padded a pixel); a kept pair counts in its (class,
// tile) group, a dead or rejected one gets the key `dead`. The counts are
// aggregated over the warp first (__match_any_sync): a warp's pairs are
// consecutive in the stream, and small triangles bin many pairs of one tile
// next to each other (on the 1M-triangle field one atomic a pair took 6x
// the kernel's time). One block a tile: the persistent walk of F2 rows
// made F3 slower (PERF.md).
__global__ void __launch_bounds__(PAIRS_THREADS) pairs_kernel(const BinArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long split[2];
  constexpr int STAGED = PAIRS_ITEMS + 1;
  const ExpandSmem m = expand_smem(smem, PAIRS_ITEMS);
  const int keys = n_keys(A);
  const int zbuckets = A.zbuckets;
  const int dead = wmul(keys, zbuckets);
  const long long n_src = A.rc, n_slots = A.pc, tc = A.tc;
  const long long n_items = n_src + n_slots;
  const int live_rows = min(__ldg(A.cum_r + A.tc - 1), A.rc);
  const int live = min(__ldg(A.cum_p + A.rc - 1), A.pc);
  const long long d0 = static_cast<long long>(blockIdx.x) * PAIRS_ITEMS;
  const long long d1 = min(d0 + PAIRS_ITEMS, n_items);
  // past every live pair come the dead rows (no pairs, after the live
  // pairs), then the dead pairs (after every row)
  if (d0 >= live_rows + live) {
    block_fill(A.key, max(d0 - n_src, static_cast<long long>(live)),
               max(d1 - n_src, static_cast<long long>(live)), dead);
    return;
  }
  next_split(A.cum_p, n_src, n_slots, d0, d1, split);
  __syncthreads();
  const long long i0 = split[0], i1 = split[1], j0 = d0 - i0, j1 = d1 - i1;
  if (j0 >= j1 || j0 >= live) {
    block_fill(A.key, j0, j1, dead);
    return;
  }
  if (EXPAND_STOP == 1) return;
  // the rows the block's live pairs can take: i0 .. min(i1, live_rows - 1)
  const int n_s = static_cast<int>(min(i1, static_cast<long long>(live_rows) - 1) - i0 + 1);
  for (int k = threadIdx.x; k <= n_s; k += PAIRS_THREADS) {
    m.cum[k] = i0 + k > 0 ? __ldg(A.cum_p + i0 + k - 1) : 0;
    if (k < n_s) m.rec[k] = __ldg(reinterpret_cast<const int4*>(A.row_rec) + i0 + k);
  }
  __syncthreads();
  const long long j_live = min(j1, static_cast<long long>(live));
  // rows are in triangle order: a warp's rows read a few triangles' planes
  for (int k = threadIdx.x; k < n_s; k += PAIRS_THREADS) {
    if (!owns_slots(m, k, j0, j_live)) continue;
    const int tri = m.rec[k].x;
#pragma unroll
    for (int r = 0; r < PAIR_COLS; ++r) m.col[r * STAGED + k] = __ldg(A.td + r * tc + tri);
  }
  map_slots(m, n_s, j0, j_live, PAIRS_THREADS);
  __syncthreads();
  const float fw = static_cast<float>(A.tile_w), fh = static_cast<float>(A.tile_h);
  const int lane = static_cast<int>(threadIdx.x & 31);
  // the same trip count in every thread: __match_any_sync takes whole warps
  for (long long base = j0; base < j1; base += PAIRS_THREADS) {
    const long long p = base + threadIdx.x;
    // the counter a kept pair adds to: its group, keys (keys below 0, which
    // sort first and shift every group's sorted start; only an int32 wrap
    // of a window makes one), or none (-1: dead, rejected or past `dead`)
    int counter = -1;
    if (p < j1 && p >= live) {
      A.key[p] = dead;
    } else if (p < j1) {
      const int q = static_cast<int>(p);
      const int k = m.src[q - j0];
      const int4 rec = m.rec[k];
      const float* col = m.col + k;
      // m.cum[k] = cum_p[row] - row_span[row], the row's first pair
      const int tile_x = wadd(rec.y, wsub(q, m.cum[k]));
      const int tile_y = wadd(A.tile_row_lo, wmul(rec.z, A.row_stride));
      const int cls = rec.w & 3;
      const int group = wadd(wmul(cls, A.tiles_x * A.local_tiles_y),
                             wadd(wmul(rec.z, A.tiles_x), tile_x));
      int key = group;
      if (zbuckets > 1) key = wadd(wmul(group, zbuckets), cls == 0 ? rec.w >> 2 : 0);
      const float ext_x0 = __fsub_rn(__fmul_rn(__int2float_rn(tile_x), fw), 0.5f);
      const float ext_x1 = __fadd_rn(ext_x0, fw + 1.0f);
      const float ext_y0 = __fsub_rn(__fmul_rn(__int2float_rn(tile_y), fh), 0.5f);
      const float ext_y1 = __fadd_rn(ext_y0, fh + 1.0f);
      bool covers = true;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float a = col[(3 * e) * STAGED];
        const float b = col[(3 * e + 1) * STAGED];
        const float c = col[(3 * e + 2) * STAGED];
        const float e_max = __fadd_rn(__fadd_rn(__fmul_rn(a, a > 0.0f ? ext_x1 : ext_x0),
                                                __fmul_rn(b, b > 0.0f ? ext_y1 : ext_y0)), c);
        covers = covers && e_max >= 0.0f;
      }
      if (!covers) key = dead;
      A.key[p] = key;
      A.tri_pair[p] = rec.x;
      if (covers) counter = key < 0 ? keys : (key < dead ? key / zbuckets : -1);
    }
    const unsigned peers = __match_any_sync(0xffffffffu, counter);
    if (counter >= 0 && lane == __ffs(peers) - 1) {
      int* acc = counter == keys ? A.acc + keys + A.n_classes : A.acc + counter;
      atomicAdd(acc, __popc(peers));
    }
  }
}

// Inclusive block-wide sums of two values (SCAN_THREADS threads); `total`
// gets the block's sums.
__device__ __forceinline__ void block_scan2(int& a, int& b, int2& total) {
  __shared__ int2 warp_sums[SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ua = __shfl_up_sync(0xffffffffu, a, off);
    const int ub = __shfl_up_sync(0xffffffffu, b, off);
    if (lane >= off) {
      a = wadd(a, ua);
      b = wadd(b, ub);
    }
  }
  if (lane == 31) warp_sums[warp] = make_int2(a, b);
  __syncthreads();
  if (warp == 0) {
    int2 s = lane < SCAN_THREADS / 32 ? warp_sums[lane] : make_int2(0, 0);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ua = __shfl_up_sync(0xffffffffu, s.x, off);
      const int ub = __shfl_up_sync(0xffffffffu, s.y, off);
      if (lane >= off) {
        s.x = wadd(s.x, ua);
        s.y = wadd(s.y, ub);
      }
    }
    if (lane < SCAN_THREADS / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) {
    a = wadd(a, warp_sums[warp - 1].x);
    b = wadd(b, warp_sums[warp - 1].y);
  }
  total = warp_sums[SCAN_THREADS / 32 - 1];
  __syncthreads();
}

// One pass of F4 scan over the keys [base, base + SCAN_THREADS * PER) (cut
// at `keys`), ceil(its keys / SCAN_THREADS) <= PER consecutive keys a
// thread; the first pass also has threads of the last warp load the
// scalars into shared memory. Every load of a pass is issued before its
// scan and its stores; its block scan's barriers publish the scalars.
template <int PER>
__device__ __forceinline__ void scan_pass(const BinArgs& A, int keys, int base, int* scalars,
                                          int& carry_raw, int& carry_pad) {
  constexpr int BELOW = MAX_CLASSES, ROW_DEMAND = MAX_CLASSES + 1, PAIR_DEMAND = MAX_CLASSES + 2;
  const int* __restrict__ acc = A.acc;
  int* __restrict__ out = A.scan;
  const int tid = threadIdx.x, nc = A.n_classes;
  const int end = min(keys - base, SCAN_THREADS * PER) + base;
  const int per = PER == 1 ? 1 : (end - base + SCAN_THREADS - 1) / SCAN_THREADS;
  const int k0 = base + tid * per;
  int c[PER], padded[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) c[j] = j < per && k0 + j < end ? __ldg(acc + k0 + j) : 0;
  if (base == 0) {
    const int s = tid - (SCAN_THREADS - 32);
    if (s >= 0 && s <= nc) scalars[s < nc ? s : BELOW] = __ldg(acc + keys + s);
    else if (s == ROW_DEMAND) scalars[ROW_DEMAND] = __ldg(A.cum_r + A.tc - 1);
    else if (s == PAIR_DEMAND) scalars[PAIR_DEMAND] = __ldg(A.cum_p + A.rc - 1);
  }
  int raw = 0, pad = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    padded[j] = (c[j] + ALIGN - 1) / ALIGN * ALIGN;
    raw = wadd(raw, c[j]);
    pad = wadd(pad, padded[j]);
  }
  const int own_raw = raw, own_pad = pad;
  int2 total;
  block_scan2(raw, pad, total);
  if (base == 0) carry_raw = scalars[BELOW];
  int r = wadd(carry_raw, wsub(raw, own_raw)), q = wadd(carry_pad, wsub(pad, own_pad));
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (j < per && k0 + j < end) {
      out[k0 + j] = q;
      out[keys + k0 + j] = r;
    }
    r = wadd(r, c[j]);
    q = wadd(q, padded[j]);
  }
  carry_raw = wadd(carry_raw, total.x);
  carry_pad = wadd(carry_pad, total.y);
}

// F4, its first pass (one block): each group's sorted start (keys below 0
// first) and 128-aligned start, and the scalars: per-class overflow, row
// overflow, the pair and row demands. The launch is most of its time (the
// floor, PERF.md); what is left was a chain of dependent round trips to
// L2. Now one round of loads, then one scan: each thread loads its
// consecutive counts (one where keys <= SCAN_THREADS, else up to SCAN_PER
// a pass of SCAN_KEYS keys; more keys take more passes) while threads of
// the last warp load the scalars into shared memory, every load read-only
// and issued before any store; then one block scan of each thread's raw
// and padded sums, the stores, and the class overflows n_classes threads
// at once.
__global__ void __launch_bounds__(SCAN_THREADS) scan_kernel(const BinArgs A) {
  // class_pairs [C] | keys below 0 | row demand | pair demand
  __shared__ int scalars[MAX_CLASSES + 3];
  constexpr int ROW_DEMAND = MAX_CLASSES + 1, PAIR_DEMAND = MAX_CLASSES + 2;
  const int keys = n_keys(A), nc = A.n_classes;
  const int tid = threadIdx.x;
  int carry_raw = 0, carry_pad = 0;
  if (keys <= SCAN_THREADS)
    scan_pass<1>(A, keys, 0, scalars, carry_raw, carry_pad);
  else
    for (int base = 0; base < keys; base += SCAN_KEYS)
      scan_pass<SCAN_PER>(A, keys, base, scalars, carry_raw, carry_pad);
  int* const tail = A.scan + 2 * keys;
  if (tid < nc) {
    int e_c = 0;
    for (int c = 0; c <= tid; ++c) e_c = wadd(e_c, scalars[c]);
    const int s_c = wsub(e_c, scalars[tid]);
    tail[tid] = wsub(max(wsub(e_c, A.pc), 0), max(wsub(s_c, A.pc), 0));
  } else if (tid == nc) {
    tail[nc] = max(wsub(scalars[ROW_DEMAND], A.rc), 0);
  } else if (tid == nc + 1) {
    tail[nc + 1] = scalars[PAIR_DEMAND];
  } else if (tid == nc + 2) {
    tail[nc + 2] = scalars[ROW_DEMAND];
  }
}

// F4, its second pass: the binned buffer, a block a tile of
// SCATTER_THREADS × PER consecutive columns, PER consecutive columns a
// thread (scatter_grid picks PER by the call's size). A column d's group
// is the last whose 128-aligned start is <= d; a column within the group's
// count takes the sorted pair at the group's sorted start + rank: the
// triangle's 15 plane rows and its id; every other column is zero. A group
// that owns columns is at least ALIGN wide, so the tile's segments of ALIGN
// columns meet at most one group boundary each: the groups of the
// segments' ends (the points d0 + ALIGN k and the tile's last column) are
// the only groups the tile's columns take, and a column takes the one of
// its segment's two ends whose start it has reached. A block finds them at
// once: every thread loads one of SCATTER_PROBES evenly spaced starts (with
// the live columns' end: a tile past it stores zeros and loads nothing
// more), then a half-warp a point narrows its range in shared memory and
// probes the last (at most 16) starts, with their counts and sorted starts,
// in one round. A thread then loads its live columns' sorted pairs, their
// triangles, and then their td rows, each round issued at once, and
// stores its columns, PER × 4 bytes a row where the row's columns are
// aligned.
constexpr int SCATTER_PROBES = 256;
static_assert(SCATTER_PROBES == 16 * 16, "F4 scatter's probes: 16 a half-warp, twice");

// A group's padded start, count and sorted start (the scan's raw start)
struct Group {
  int start, count, raw;
};

// The last group whose padded start is <= x, among [lo, hi] (starts[lo] <=
// x), with its count and sorted start: found by the 16 lanes of a
// half-warp (each half of the warp its own x; `active` false: none), 16
// probes a step while more than 16 groups remain, then the last 16 at once.
__device__ Group find_group(const BinArgs& A, int keys, long long x, int lo, int hi,
                            bool active) {
  const int* __restrict__ starts = A.scan;
  const int lane = static_cast<int>(threadIdx.x & 31), sub = lane & 15, shift = lane & 16;
  auto half_ballot = [&](bool p) { return (__ballot_sync(0xffffffffu, p) >> shift) & 0xffffu; };
  while (__any_sync(0xffffffffu, active && hi - lo >= 16)) {
    const bool wide = active && hi - lo >= 16;
    const long long span = hi - lo;
    // probes at lo + 1 + span j / 16, j < 16, all in (lo, hi]
    const unsigned m = half_ballot(
        wide && __ldg(starts + lo + 1 + static_cast<int>(span * sub / 16)) <= x);
    if (wide) {
      if (m == 0) {
        hi = lo;
      } else {
        const int j = 31 - __clz(m);
        if (j < 15) hi = lo + static_cast<int>(span * (j + 1) / 16);
        lo += 1 + static_cast<int>(span * j / 16);
      }
    }
  }
  const int q = lo + sub;
  const bool in = active && q <= hi;
  int s = 0, c = 0, r = 0;
  if (in) {
    s = __ldg(starts + q);
    c = __ldg(A.acc + q);
    r = __ldg(A.scan + keys + q);
  }
  const unsigned m = half_ballot(in && s <= x);
  const int src = shift + (m ? 31 - __clz(m) : 0);
  return {__shfl_sync(0xffffffffu, s, src), __shfl_sync(0xffffffffu, c, src),
          __shfl_sync(0xffffffffu, r, src)};
}

// A thread's PER columns from c0 (< p_total) of the 16 rows: one PER × 4
// byte store a row where the columns are in the row and aligned, else one
// a column
template <int PER>
__device__ __forceinline__ void store_rows(const BinArgs& A, long long c0,
                                           const float (*v)[PER]) {
  const long long pt = A.p_total;
#pragma unroll
  for (int r = 0; r < B_ROWS; ++r) {
    float* p = A.binned + r * pt + c0;
    const bool wide = c0 + PER <= pt && (reinterpret_cast<uintptr_t>(p) & (4 * PER - 1)) == 0;
    if constexpr (PER == 2) {
      if (wide) *reinterpret_cast<float2*>(p) = make_float2(v[r][0], v[r][1]);
    }
    if (PER == 1 || !wide) {
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (c0 + k < pt) p[k] = v[r][k];
    }
  }
}

template <int PER>
__global__ void __launch_bounds__(SCATTER_THREADS) scatter_kernel(const BinArgs A) {
  constexpr int COLS = SCATTER_THREADS * PER;
  constexpr int POINTS = COLS / ALIGN + 1;
  static_assert(POINTS <= SCATTER_THREADS / 16 && COLS % ALIGN == 0 && (PER == 1 || PER == 2),
                "F4 scatter's tile");
  __shared__ int probe[SCATTER_PROBES];
  __shared__ Group ends[POINTS];
  const long long pt = A.p_total, tc = A.tc;
  const long long d0 = static_cast<long long>(blockIdx.x) * COLS;
  const long long c0 = d0 + PER * threadIdx.x;  // the thread's first column
  float v[B_ROWS][PER] = {};
  if (SCATTER_STOP == 2) {
    if (c0 < pt) store_rows<PER>(A, c0, v);
    return;
  }
  const int keys = n_keys(A);
  const int* __restrict__ starts = A.scan;
  auto probe_at = [&](int j) {
    return static_cast<int>(static_cast<long long>(j) * keys / SCATTER_PROBES);
  };
  for (int j = threadIdx.x; j < SCATTER_PROBES; j += SCATTER_THREADS)
    probe[j] = __ldg(starts + probe_at(j));
  // every live column lies before the last group's start + count
  const long long live_end =
      static_cast<long long>(__ldg(starts + keys - 1)) + __ldg(A.acc + keys - 1);
  __syncthreads();
  if (d0 >= live_end) {
    if (c0 < pt) store_rows<PER>(A, c0, v);
    return;
  }
  const int half = static_cast<int>(threadIdx.x >> 4), sub = static_cast<int>(threadIdx.x & 15);
  if (static_cast<int>(threadIdx.x >> 5) <= (POINTS - 1) / 2) {
    const bool active = half < POINTS;
    // the point: a segment's first column, or the tile's last column
    const long long x = min(d0 + (half + 1 < POINTS ? ALIGN * half : COLS - 1), pt - 1);
    // the last probe whose start is <= x: its index and the next probe's
    // bound the point's group
    const int shift = static_cast<int>(threadIdx.x & 16);
    auto half_ballot = [&](bool p) { return (__ballot_sync(0xffffffffu, p) >> shift) & 0xffffu; };
    const unsigned m1 = half_ballot(active && probe[16 * sub] <= x);
    const int j1 = m1 ? 31 - __clz(m1) : 0;
    const unsigned m2 = half_ballot(active && probe[16 * j1 + sub] <= x);
    const int j = 16 * j1 + (m2 ? 31 - __clz(m2) : 0);
    const int lo = probe_at(j), hi = j + 1 < SCATTER_PROBES ? probe_at(j + 1) - 1 : keys - 1;
    const Group g = find_group(A, keys, x, lo, max(lo, hi), active);
    if (active && sub == 0) ends[half] = g;
  }
  __syncthreads();
  if (c0 >= pt) return;
  const int seg = static_cast<int>(PER * threadIdx.x / ALIGN);
  const Group ga = ends[seg], gb = ends[seg + 1];
  bool live[PER];
  long long at[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const long long d = c0 + k;
    const Group& g = d >= gb.start ? gb : ga;
    const long long rank = d - g.start;
    live[k] = d < pt && rank < g.count;
    at[k] = g.raw + rank;
  }
  if (SCATTER_STOP == 1) {
#pragma unroll
    for (int k = 0; k < PER; ++k)
#pragma unroll
      for (int r = 0; r < B_ROWS; ++r) v[r][k] = live[k] && at[k] == -7 ? 1.0f : 0.0f;
  } else {
    long long o[PER];
    int tri[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) o[k] = live[k] ? __ldg(A.order + at[k]) : 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) tri[k] = live[k] ? __ldg(A.tri_pair + o[k]) : 0;
#pragma unroll
    for (int r = 0; r < B_TID; ++r)
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (live[k])
          v[r][k] = SCATTER_STOP == 3 ? __int_as_float(tri[k]) : __ldg(A.td + r * tc + tri[k]);
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (live[k]) v[B_TID][k] = __int2float_rn(tri[k]);
  }
  store_rows<PER>(A, c0, v);
}

// An empty kernel: the launch floor of tools/frontend_probe
__global__ void empty_kernel() {}

inline unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + THREADS - 1) / THREADS);
}

inline bool grid_fits(long long n) { return n > 0 && (n + THREADS - 1) / THREADS < (1LL << 31); }

}  // namespace rf

namespace {

bool bin_args_ok(const rf::BinArgs* a) {
  // the row and pair demands (at most tc * local_tiles_y and rc * tiles_x)
  // below 2^31: their int32 cumsums never wrap, as F2 rows' and F3's
  // merges need
  return a->tc > 0 && a->rc > 0 && a->pc > 0 && a->n_classes >= 1 &&
         a->n_classes <= rf::MAX_CLASSES && a->tiles_x > 0 && a->tiles_y > 0 &&
         a->local_tiles_y > 0 && a->tile_w > 0 && a->tile_h > 0 && a->row_stride > 0 &&
         a->zbuckets >= 1 && a->p_total > 0 &&
         static_cast<long long>(a->tc) * a->local_tiles_y < (1LL << 31) &&
         static_cast<long long>(a->rc) * a->tiles_x < (1LL << 31);
}

// The most blocks of `kernel` resident at once on the current device,
// asked of the runtime once a device (into cache[device]) with the dynamic
// shared memory's limit raised to `smem`
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int smem, int* cache, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = per_sm * sms;
  }
  *out = cache[dev];
  return cudaSuccess;
}

long long n_acc(const rf::BinArgs* a) {
  return static_cast<long long>(a->n_classes) * a->tiles_x * a->local_tiles_y + a->n_classes + 1;
}

// F2 spans' launch for `args`: the narrow path (all of a triangle's rows
// loaded at once) below SPANS_GATE_MIN triangles, the wide one (`gate`:
// the bbox rows read after the valid row) from there; a thread a triangle
// or a counter to zero, in at most the blocks resident at once (the rest
// walked by a grid stride)
cudaError_t spans_launch(const rf::BinArgs* a, bool* gate, unsigned* grid) {
  static int cache[2][64];
  *gate = a->tc >= rf::SPANS_GATE_MIN;
  int most = 0;
  const cudaError_t err =
      *gate ? resident_blocks(rf::spans_kernel<true>, rf::SPANS_THREADS, 0, cache[1], &most)
            : resident_blocks(rf::spans_kernel<false>, rf::SPANS_THREADS, 0, cache[0], &most);
  if (err != cudaSuccess) return err;
  const long long n = a->tc > n_acc(a) ? a->tc : n_acc(a);
  const long long blocks = (n + rf::SPANS_THREADS - 1) / rf::SPANS_THREADS;
  *grid = static_cast<unsigned>(blocks < most ? blocks : most);
  return *grid > 0 ? cudaSuccess : cudaErrorInvalidValue;
}

// F1's grid for tc triangles: a block a tile of SETUP_THREADS
unsigned setup_grid(long long tc) {
  return static_cast<unsigned>((tc + rf::SETUP_THREADS - 1) / rf::SETUP_THREADS);
}

// F4 scatter's launch for p_total columns: its columns a thread (wide:
// SCATTER_PER_WIDE from SCATTER_WIDE_MIN columns, else SCATTER_PER_NARROW)
// and its grid, a block a tile of SCATTER_THREADS × that many
long long scatter_grid(long long p_total, bool* wide) {
  *wide = p_total >= rf::SCATTER_WIDE_MIN;
  const long long cols =
      rf::SCATTER_THREADS * (*wide ? rf::SCATTER_PER_WIDE : rf::SCATTER_PER_NARROW);
  return (p_total + cols - 1) / cols;
}

}  // namespace

// F1: clip [n_verts, 4] f32 (16-byte aligned), tri_v [tc, 3] i32 -> out [24, tc] f32.
// num_tris: the pointer (int32, or int64 when num_is64) or, when null, num_value.
extern "C" int rt_setup(const float* clip, const int* tri_v, const void* num_ptr,
                        long long num_value, int num_is64, float* out, int tc,
                        long long n_verts, float width, float height, float bbox_pad,
                        float maxdim, int double_sided, void* stream) {
  if (tc <= 0) return 0;
  if (n_verts <= 0 || (reinterpret_cast<uintptr_t>(clip) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = setup_grid(tc);
  auto st = static_cast<cudaStream_t>(stream);
  const rf::Count num{num_ptr, num_value, num_is64};
  const auto* clip4 = reinterpret_cast<const float4*>(clip);
  if (double_sided)
    rf::setup_kernel<true><<<grid, rf::SETUP_THREADS, 0, st>>>(
        clip4, tri_v, num, out, tc, n_verts, width, height, bbox_pad, maxdim);
  else
    rf::setup_kernel<false><<<grid, rf::SETUP_THREADS, 0, st>>>(
        clip4, tri_v, num, out, tc, n_verts, width, height, bbox_pad, maxdim);
  return static_cast<int>(cudaGetLastError());
}

// F1's launch for tc triangles: out[0] its grid, out[1] the blocks of F1
// resident at once (asked of the runtime once a device), for
// tests/test_torch_cuda_kernels.py's triangle counts at their edges
extern "C" int rt_setup_launch(long long tc, int double_sided, long long* out) {
  static int cache[2][64];
  int resident = 0;
  const cudaError_t err =
      double_sided
          ? resident_blocks(rf::setup_kernel<true>, rf::SETUP_THREADS, 0, cache[1], &resident)
          : resident_blocks(rf::setup_kernel<false>, rf::SETUP_THREADS, 0, cache[0], &resident);
  out[0] = setup_grid(tc);
  out[1] = resident;
  return static_cast<int>(err);
}

// F2 rows and F3: blocks over the tiles of `items` of the merge of n_src
// sources and n_slots slots, one a tile or, `persistent`, as many as fit
// the SMs at once
template <typename Kernel>
int expand_launch(Kernel kernel, const rf::BinArgs* args, long long n_src, long long n_slots,
                  int items, int threads, int smem, bool persistent, int* grid_cap,
                  void* stream) {
  if (!bin_args_ok(args)) return static_cast<int>(cudaErrorInvalidValue);
  int most = 0;
  const cudaError_t err = resident_blocks(kernel, threads, smem, grid_cap, &most);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n_src + n_slots + items - 1) / items;
  const unsigned grid = static_cast<unsigned>(!persistent || tiles < most ? tiles : most);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// F2 (spans): n_rows, tri_info; zeroes acc.
extern "C" int rt_bin_spans(const rf::BinArgs* args, void* stream) {
  if (!bin_args_ok(args)) return static_cast<int>(cudaErrorInvalidValue);
  bool gate = false;
  unsigned grid = 0;
  const cudaError_t err = spans_launch(args, &gate, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  if (gate)
    rf::spans_kernel<true><<<grid, rf::SPANS_THREADS, 0, st>>>(*args);
  else
    rf::spans_kernel<false><<<grid, rf::SPANS_THREADS, 0, st>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// F2 (rows): row_span, row_rec and the class pair totals, after cum_r.
extern "C" int rt_bin_rows(const rf::BinArgs* args, void* stream) {
  static int grid_cap[64];
  return expand_launch(rf::rows_kernel, args, args->tc, args->rc, rf::ROWS_ITEMS,
                       rf::ROWS_THREADS, rf::ROWS_SMEM, true, grid_cap, stream);
}

// F3: key, tri_pair and the group counts, after cum_p.
extern "C" int rt_bin_pairs(const rf::BinArgs* args, void* stream) {
  static int grid_cap[64];
  return expand_launch(rf::pairs_kernel, args, args->rc, args->pc, rf::PAIRS_ITEMS,
                       rf::PAIRS_THREADS, rf::PAIRS_SMEM, false, grid_cap, stream);
}

// F4 (scan): padded and sorted starts, the overflow and demand scalars.
extern "C" int rt_bin_scan(const rf::BinArgs* args, void* stream) {
  if (!bin_args_ok(args)) return static_cast<int>(cudaErrorInvalidValue);
  rf::scan_kernel<<<1, rf::SCAN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// F4 (scatter): the binned buffer, after the sort's permutation.
extern "C" int rt_bin_scatter(const rf::BinArgs* args, void* stream) {
  if (!bin_args_ok(args)) return static_cast<int>(cudaErrorInvalidValue);
  bool wide = false;
  const auto grid = static_cast<unsigned>(scatter_grid(args->p_total, &wide));
  auto st = static_cast<cudaStream_t>(stream);
  if (wide)
    rf::scatter_kernel<rf::SCATTER_PER_WIDE><<<grid, rf::SCATTER_THREADS, 0, st>>>(*args);
  else
    rf::scatter_kernel<rf::SCATTER_PER_NARROW><<<grid, rf::SCATTER_THREADS, 0, st>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

// The launch floor: an empty kernel with F4 scan's one block (what 0), F2
// spans' grid and threads for `args` (what 1), a thread a triangle or a
// counter, 256 a block (what 2), a thread a binned column, 256 a block (F4
// scatter's grid before its redesign: what 3), F1's grid for args->tc
// triangles (what 4) or F4 scatter's for args->p_total columns (what 5)
extern "C" int rt_launch_floor(const rf::BinArgs* args, int what, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const long long n = args->tc > n_acc(args) ? args->tc : n_acc(args);
  if (what == 0) {
    rf::empty_kernel<<<1, rf::SCAN_THREADS, 0, st>>>();
  } else if (what == 1) {
    bool gate = false;
    unsigned grid = 0;
    const cudaError_t err = spans_launch(args, &gate, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    rf::empty_kernel<<<grid, rf::SPANS_THREADS, 0, st>>>();
  } else if (what == 2 && rf::grid_fits(n)) {
    rf::empty_kernel<<<rf::blocks_for(n), rf::THREADS, 0, st>>>();
  } else if (what == 3 && rf::grid_fits(args->p_total)) {
    rf::empty_kernel<<<rf::blocks_for(args->p_total), rf::THREADS, 0, st>>>();
  } else if (what == 4 && args->tc > 0) {
    rf::empty_kernel<<<setup_grid(args->tc), rf::SETUP_THREADS, 0, st>>>();
  } else if (what == 5 && args->p_total > 0) {
    bool wide = false;
    rf::empty_kernel<<<static_cast<unsigned>(scatter_grid(args->p_total, &wide)),
                       rf::SCATTER_THREADS, 0, st>>>();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
