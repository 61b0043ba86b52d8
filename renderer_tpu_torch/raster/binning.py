"""Tile binning: triangle stream → per-tile compact triangle lists.

The reference's analog is the indirect-draw stream (one sorted command list
consumed by the whole GPU, renderer.rs:219-256); a software tile rasterizer
instead needs per-tile work lists so each tile only touches triangles that
overlap it.

Dense tensor formulation with static capacities, bit-identical to the JAX
package's binning (the binned buffers of the two are interchangeable):
1. per-triangle tile span from the setup bbox (pixel-center semantics),
2. ragged two-level expansion to (tile, triangle) pairs with
   `repeat_interleave(output_size=capacity)`, then a tight edge-plane
   trivial-reject per pair,
3. one stable sort by (class, tile[, z-bucket]) key,
4. scatter of the kernel-consumed triangle setup rows into bin order → a
   [B_ROWS, P] SoA tensor where every tile's rows are CONTIGUOUS and every
   tile's start is 128-aligned,
5. per-tile (start, count) via searchsorted.

Pair order within a tile is triangle-stream order (stable sort), preserving
the reference's later-submission-wins depth-tie semantics. The opaque class
may additionally be sub-ordered nearest-first at z-bucket granularity
(`zbuckets`, riding the same sort) — output-invariant because the opaque
kernel's merge is a lexicographic (z, id) max.

`bin_triangle_classes` (and `bin_triangles` through it) dispatches on the
device as raster/candidates.py does: CPU tensors run
`bin_triangle_classes_plain`; CUDA tensors run kernels F2-F4 of
csrc/frontend.cu (for the JAX package's XLA-fused
renderer_tpu/raster/binning.py:66 and :141) with two torch.cumsum and one
stable torch.sort between them (`binning_steps`), bit-equal to the plain
version on the card, or raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from renderer_tpu_torch import kernels
from renderer_tpu_torch.engine import profiling
from renderer_tpu_torch.raster.setup import BBOX_ROWS, ROWS, TID_ROW, VALID_ROW, count_arg
from renderer_tpu_torch.raster.shade import check_tensor

# Per-tile bin starts are aligned to this.
ALIGN = 128
# Triangles per staged chunk of the opaque raster kernel; the binned buffer
# carries one chunk of padding so a chunk read past a bin's end stays inside.
CHUNK = 256

# Binned-row layout: the raster kernels consume only the plane rows
# (edges 0-8 with the eps band pre-folded into C — setup.py —, depth 9-11,
# 1/w 12-14) and the triangle id. Indices below are positions in the SLIM
# [B_ROWS, Pp] buffer.
KEEP_ROWS = tuple(range(15)) + (TID_ROW,)
B_ROWS = len(KEEP_ROWS)  # 16
B_TID = 15

#: items (sources and slots) of the merge path that one block of F2 rows
#: and one of F3 takes (csrc/frontend.cu ROWS_ITEMS, PAIRS_ITEMS): the
#: card tests put live counts and truncations at and around their multiples
EXPAND_ITEMS = {"F2 rows": 384, "F3 pairs": 512}

#: binned columns a block of F4 scatter takes on its narrow and its wide
#: path (csrc/frontend.cu SCATTER_THREADS × SCATTER_PER_NARROW, ×
#: SCATTER_PER_WIDE), the binned columns from which it takes the wide one
#: (SCATTER_WIDE_MIN), and the evenly spaced group starts it probes at once
#: (SCATTER_PROBES; past 16 groups between two probes, more than 4096
#: groups, its search narrows 16-fold a round): the card tests put group
#: boundaries, column and key counts at and around them
SCATTER_COLS = {"narrow": 256, "wide": 512}
SCATTER_WIDE_MIN = 524288
SCATTER_PROBES = 256

_I32_MIN = -(2**31)
_I32_MAX = 2**31 - 1

#: the binning kernels' launch counters in profiling.COUNTERS: F2 (its
#: per-triangle pass "bin_spans" and its row pass "bin_rows"), F3
#: ("bin_pairs") and F4 (its scan "bin_scan" and its scatter
#: "bin_scatter"); the plain version does not count
LAUNCHES = ("bin_spans", "bin_rows", "bin_pairs", "bin_scan", "bin_scatter")
profiling.register_launches(LAUNCHES)

#: the CUDA path's steps in order (binning_steps): (name, the launch
#: counter of its kernel, or None for a library call)
STEPS = (("F2 spans", "bin_spans"), ("cumsum of the row counts", None),
         ("F2 rows", "bin_rows"), ("cumsum of the row spans", None),
         ("F3 pairs", "bin_pairs"), ("stable sort of the keys", None),
         ("F4 scan", "bin_scan"), ("F4 scatter", "bin_scatter"))


def padded_capacity_classes(pair_capacity: int, n_tiles: int, n_classes: int) -> int:
    return pair_capacity + ALIGN * n_tiles * n_classes + CHUNK


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 → i32 with XLA's conversion semantics (truncate toward zero,
    saturate out-of-range values, NaN → 0), which the bin spans depend on for
    degenerate planes; a plain `.to(torch.int32)` is undefined there."""
    x = torch.nan_to_num(x.double(), nan=0.0)
    return torch.clamp(x, _I32_MIN, _I32_MAX).to(torch.int32)


def _ragged_repeat(n: int, reps: torch.Tensor, capacity: int) -> torch.Tensor:
    """Indices 0..n-1 each repeated reps[i] times, cut or padded to exactly
    `capacity` entries — jnp.repeat(arange(n), reps,
    total_repeat_length=capacity): entries past the total repeat the last
    index. Static output size, so no host sync."""
    dev = reps.device
    ends = torch.clamp(torch.cumsum(reps.long(), 0), max=capacity)
    clipped = ends - torch.cat([ends.new_zeros(1), ends[:-1]])
    tail = capacity - ends[-1:]
    idx = torch.clamp(torch.arange(n + 1, dtype=torch.int32, device=dev), max=n - 1)
    return torch.repeat_interleave(idx, torch.cat([clipped, tail]),
                                   output_size=capacity)


def _reciprocal(size: int) -> float:
    """The f32 reciprocal of a tile size. The plain version multiplies by
    it where the JAX package divides by the size: its jitted binning
    divides by the constant as XLA does, a product with the f32 reciprocal,
    and so does torch on the card with a Python divisor, while torch on the
    CPU divides truly. The product rounds alike on every device and in the
    JAX package (for a size such as 24 or 384 the quotient does not)."""
    return float(np.float32(1.0) / np.float32(size))


def _tile_spans(tri_data, bounds, n_classes, *, tiles_x, tiles_y,
                tile_w, tile_h):
    """Per-triangle first tile (tx0, ty0), span (span_w, span_h), bbox pair
    count (0 for invalid / out-of-bounds triangles), and alpha-class id."""
    tc = tri_data.shape[1]
    xmin, ymin, xmax, ymax = (tri_data[k] for k in BBOX_ROWS)
    tri_idx = torch.arange(tc, dtype=torch.int32, device=tri_data.device)
    valid = (tri_data[VALID_ROW] > 0.0) & (tri_idx >= bounds[0]) & (tri_idx < bounds[-1])
    cls = torch.zeros(tc, dtype=torch.int32, device=tri_data.device)
    for c in range(1, n_classes):
        cls = cls + (tri_idx >= bounds[c]).to(torch.int32)

    def span(lo, hi, size, n):
        inv = _reciprocal(size)
        t0 = f32_to_i32(torch.clamp(torch.ceil((lo + 0.5) * inv - 1.0), 0, n - 1))
        t1 = f32_to_i32(torch.clamp(torch.floor((hi - 0.5) * inv), 0, n - 1))
        return t0, torch.clamp(t1 - t0 + 1, min=0)

    # tile index ranges covering any pixel CENTER in [min, max]
    tx0, span_w = span(xmin, xmax, tile_w, tiles_x)
    ty0, span_h = span(ymin, ymax, tile_h, tiles_y)
    n_pairs = torch.where(valid, span_w * span_h, torch.zeros_like(span_w))
    return tx0, ty0, span_w, span_h, n_pairs, cls


def band_rows(tri_data, bounds, n_classes, *, tiles_x, tiles_y, tile_w, tile_h,
              tile_row_lo=0, local_tiles_y=None, row_stride=1):
    """What stage 1 expands (F2 spans on the card), per triangle: its first
    tile column tx0, its span of columns, its first local tile row k0 in
    this call's row set, its row count there (0 for a triangle without
    pairs) and its class."""
    local_tiles_y = tiles_y if local_tiles_y is None else local_tiles_y
    tx0, ty0, span_w, span_h, n_pairs, cls = _tile_spans(
        tri_data, bounds, n_classes,
        tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
    )
    # clip each triangle's tile-row span to this call's row SET
    # {row_lo + k·stride}, in local k units (floor division keeps the ceil
    # identity for spans starting above row_lo)
    row_lo = tile_row_lo
    ty1 = ty0 + span_h - 1
    k0 = torch.clamp(-torch.div(row_lo - ty0, row_stride, rounding_mode="floor"), min=0)
    k1 = torch.clamp(torch.div(ty1 - row_lo, row_stride, rounding_mode="floor"),
                     max=local_tiles_y - 1)
    span_h = torch.clamp(k1 - k0 + 1, min=0)
    n_pairs = torch.where(n_pairs > 0, span_w * span_h, torch.zeros_like(n_pairs))
    n_rows = torch.where(n_pairs > 0, span_h, torch.zeros_like(span_h))
    return tx0, span_w, k0, n_rows, cls


def bin_triangles(
    tri_data: torch.Tensor,  # [ROWS, Tc] from triangle_setup
    lo=0,  # bin only triangles with lo <= index < hi
    hi=None,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    pair_capacity: int,
    row_capacity: int | None = None,
    tile_row_lo: int = 0,
    local_tiles_y: int | None = None,
    row_stride: int = 1,
):
    """Single-class binning (the UI pass, raster/ui_stage.py; the scene
    uses `bin_triangle_classes` — one sort for all alpha classes).
    `row_capacity` defaults to `pair_capacity` (tile rows per triangle never
    exceed its bbox pairs). Returns (binned [B_ROWS, Pp] f32 SoA, starts
    [tiles] i32 (128-aligned), counts [tiles] i32, overflow i32 scalar) —
    the overflow folds the row truncation into the pair overflow (each
    dropped row hides ≥ 0 pairs; callers only test > 0 and grow their one
    capacity knob)."""
    binned, starts, counts, overflow, row_ov, _pd, _rd = bin_triangle_classes(
        tri_data, (lo, tri_data.shape[1] if hi is None else hi),
        tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
        pair_capacity=pair_capacity,
        row_capacity=pair_capacity if row_capacity is None else row_capacity,
        tile_row_lo=tile_row_lo, local_tiles_y=local_tiles_y,
        row_stride=row_stride,
    )
    return binned, starts[0], counts[0], overflow[0] + row_ov


def bin_triangle_classes(
    tri_data: torch.Tensor,
    bounds,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    pair_capacity: int,
    row_capacity: int | None = None,
    tile_row_lo: int = 0,
    local_tiles_y: int | None = None,
    zbuckets: int = 1,
    row_stride: int = 1,
):
    """Bins the triangles of every alpha class with one sort
    (bin_triangle_classes_plain, which documents the arguments and the
    outputs). CPU tensors run the plain version; CUDA tensors run F2-F4
    (binning_steps) and raise ValueError on inputs they do not take."""
    kw = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
              pair_capacity=pair_capacity, row_capacity=row_capacity,
              tile_row_lo=tile_row_lo, local_tiles_y=local_tiles_y,
              zbuckets=zbuckets, row_stride=row_stride)
    if tri_data.device.type == "cpu":
        return bin_triangle_classes_plain(tri_data, bounds, **kw)
    steps, result = binning_steps(tri_data, bounds, **kw)
    for _name, run in steps:
        run()
    return result()


def binning_steps(
    tri_data: torch.Tensor,
    bounds,
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    pair_capacity: int,
    row_capacity: int | None = None,
    tile_row_lo: int = 0,
    local_tiles_y: int | None = None,
    zbuckets: int = 1,
    row_stride: int = 1,
):
    """bin_triangle_classes on CUDA tensors as its steps (STEPS), so that
    each can be timed alone (tools/frontend_probe.py): returns ([(name,
    run)], result). Running the steps in order, then result(), gives
    bin_triangle_classes' outputs. The kernels take 1..3 classes whose
    bounds are numbers or int32 / int64 values; every buffer is allocated
    here, the host never waits, and every launch is on the current stream."""
    dev = tri_data.device
    tri_data = tri_data.contiguous()
    check_tensor("tri_data", tri_data, torch.float32, (ROWS, None), dev)
    tc = tri_data.shape[1]
    row_capacity = pair_capacity if row_capacity is None else row_capacity
    local_tiles_y = tiles_y if local_tiles_y is None else local_tiles_y
    n_classes = len(bounds) - 1
    n_tiles = tiles_x * local_tiles_y
    p_total = padded_capacity_classes(pair_capacity, n_tiles, n_classes)
    if not 1 <= n_classes <= kernels.MAX_BIN_CLASSES:
        raise ValueError(f"bin_triangle_classes: {n_classes} classes; the kernels take "
                         f"1..{kernels.MAX_BIN_CLASSES}")
    sizes = dict(triangles=tc, row_capacity=row_capacity, pair_capacity=pair_capacity,
                 tiles_x=tiles_x, tiles_y=tiles_y, local_tiles_y=local_tiles_y,
                 tile_w=tile_w, tile_h=tile_h, row_stride=row_stride, zbuckets=zbuckets)
    bad = {k: v for k, v in sizes.items() if not 1 <= v < 2**31}
    if bad or p_total >= 2**31 or n_classes * n_tiles * zbuckets >= 2**31:
        raise ValueError(f"bin_triangle_classes: sizes {bad or sizes} out of the kernels' "
                         "range (1 .. 2^31 - 1, keys and binned columns below 2^31)")
    if tc * local_tiles_y >= 2**31 or row_capacity * tiles_x >= 2**31:
        raise ValueError(
            f"bin_triangle_classes: the row demand (at most {tc} triangles × "
            f"{local_tiles_y} tile rows) or the pair demand (at most {row_capacity} rows × "
            f"{tiles_x} tile columns) could pass 2^31 - 1, where the int32 cumsums that "
            "F2 rows and F3 expand would wrap")
    bound_args = [count_arg(b, dev, f"bounds[{c}]") for c, b in enumerate(bounds)]
    if dev.type != "cuda":
        raise ValueError(f"bin_triangle_classes: unsupported device {dev}")
    i32 = dict(dtype=torch.int32, device=dev)
    n_keys = n_classes * n_tiles
    bufs = dict(
        n_rows=torch.empty(tc, **i32), tri_info=torch.empty((tc, 4), **i32),
        cum_r=torch.empty(tc, **i32), row_span=torch.empty(row_capacity, **i32),
        row_rec=torch.empty((row_capacity, 4), **i32),
        cum_p=torch.empty(row_capacity, **i32), key=torch.empty(pair_capacity, **i32),
        tri_pair=torch.empty(pair_capacity, **i32),
        order=torch.empty(pair_capacity, dtype=torch.int64, device=dev),
        acc=torch.empty(n_keys + n_classes + 1, **i32),
        scan=torch.empty(2 * n_keys + n_classes + 3, **i32),
        binned=torch.empty((B_ROWS, p_total), dtype=torch.float32, device=dev))
    key_sorted = torch.empty(pair_capacity, **i32)
    args = kernels.BinArgs(
        td=tri_data.data_ptr(), **{k: v.data_ptr() for k, v in bufs.items()},
        p_total=p_total, tc=tc, rc=row_capacity, pc=pair_capacity, n_classes=n_classes,
        tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w, tile_h=tile_h,
        tile_row_lo=tile_row_lo, local_tiles_y=local_tiles_y, row_stride=row_stride,
        zbuckets=zbuckets, inv_tile_w=_reciprocal(tile_w), inv_tile_h=_reciprocal(tile_h))
    for c, (ptr, value, is64) in enumerate(bound_args):
        setattr(args, f"bound_ptr{c}", ptr)
        setattr(args, f"bound_value{c}", value)
        setattr(args, f"bound_is64{c}", is64)
    lib = kernels.load()

    def kernel(fn, counter):
        def run():
            with torch.cuda.device(dev):
                err = fn(ctypes.byref(args), kernels.current_stream())
            kernels.check_launch(f"bin_triangle_classes ({counter})", err)
            profiling.count(counter)
        return run

    library = {
        "cumsum of the row counts": lambda: torch.cumsum(
            bufs["n_rows"], 0, dtype=torch.int32, out=bufs["cum_r"]),
        "cumsum of the row spans": lambda: torch.cumsum(
            bufs["row_span"], 0, dtype=torch.int32, out=bufs["cum_p"]),
        "stable sort of the keys": lambda: torch.sort(
            bufs["key"], stable=True, out=(key_sorted, bufs["order"])),
    }
    steps = [(name, library[name] if counter is None else
              kernel(getattr(lib, "rt_" + counter), counter)) for name, counter in STEPS]

    def result():
        scan, acc = bufs["scan"], bufs["acc"]
        tail = scan[2 * n_keys:]
        return (bufs["binned"], scan[:n_keys].view(n_classes, n_tiles),
                acc[:n_keys].view(n_classes, n_tiles), tail[:n_classes],
                tail[n_classes], tail[n_classes + 1], tail[n_classes + 2])

    return steps, result


def bin_triangle_classes_plain(
    tri_data: torch.Tensor,  # [ROWS, Tc] from triangle_setup
    bounds,  # (C+1) scalars: class c = triangles [bounds[c], bounds[c+1])
    *,
    tiles_x: int,
    tiles_y: int,
    tile_w: int,
    tile_h: int,
    pair_capacity: int,
    row_capacity: int | None = None,
    tile_row_lo: int = 0,  # first tile row this call bins (sharding)
    local_tiles_y: int | None = None,  # tile rows binned (None = all)
    zbuckets: int = 1,  # nearest-first sub-order of the OPAQUE class
    row_stride: int = 1,  # stride between binned tile rows
):
    """Bin all alpha classes with ONE stable sort: pairs are keyed by
    class * n_tiles + tile, so each (class, tile) segment lands contiguous and
    128-aligned in one shared buffer — the raster kernels for each class index
    the same binned tensor through their own starts/counts row. The stream is
    ordered [opaque | masked | blended], so classes are contiguous
    triangle-index ranges and pair/row truncation drops from the blended tail
    first.

    The expansion is RAGGED two-level so the sort width tracks actual
    coverage, not the bbox:
      1. triangles expand to (triangle, tile-row) pairs (`row_capacity`),
      2. each row gets a tight x-window from the edge planes (±1 px of slack
         so f32 division rounding can never cull true coverage),
      3. rows expand to (triangle, tile) pairs over their windows only
         (`pair_capacity`), and the per-pair extent reject prunes the rest.

    Returns (binned [B_ROWS, Pp] f32 SoA, starts [C, tiles] i32
    (128-aligned), counts [C, tiles] i32, overflow_pairs [C] i32,
    row_overflow i32 scalar, pair_demand i32 scalar, row_demand i32 scalar).
    The demands are the UNtruncated expansion totals — the sizing signals
    for pair_capacity / row_capacity."""
    dev = tri_data.device
    tc = tri_data.shape[1]
    if row_capacity is None:
        row_capacity = pair_capacity
    if local_tiles_y is None:
        local_tiles_y = tiles_y
    n_classes = len(bounds) - 1
    assert n_classes >= 1
    tx0, span_w, k0, n_rows, cls = band_rows(
        tri_data, bounds, n_classes, tiles_x=tiles_x, tiles_y=tiles_y, tile_w=tile_w,
        tile_h=tile_h, tile_row_lo=tile_row_lo, local_tiles_y=local_tiles_y,
        row_stride=row_stride)
    row_lo = tile_row_lo
    xmin, _ymin, xmax, _ymax = (tri_data[k] for k in BBOX_ROWS)

    # -- stage 1: (triangle, tile-row) expansion ------------------------------
    cum_end_r = torch.cumsum(n_rows, 0, dtype=torch.int32)
    row_demand = cum_end_r[-1]
    cum_start_r = cum_end_r - n_rows
    tri_of_row = _ragged_repeat(tc, n_rows, row_capacity).long()
    row_idx = torch.arange(row_capacity, dtype=torch.int32, device=dev)
    row_live = row_idx < torch.clamp(row_demand, max=row_capacity)
    # local row index within this call's row set, and its GLOBAL tile row
    # (pixel-coordinate math below runs on the global row)
    row_k = k0[tri_of_row] + (row_idx - cum_start_r[tri_of_row])
    row_ty = row_lo + row_k * row_stride

    # tight per-row x-window: for each edge, coverage anywhere in the row's
    # padded y-extent needs a·x + max_y(b·y) + c ≥ 0 — a half-line in x
    ext_y0 = row_ty.to(torch.float32) * tile_h - 0.5
    ext_y1 = ext_y0 + (tile_h + 1.0)
    xlo = xmin[tri_of_row]
    xhi = xmax[tri_of_row]
    alive = row_live
    for e in range(3):
        a = tri_data[3 * e][tri_of_row]
        b = tri_data[3 * e + 1][tri_of_row]
        c = tri_data[3 * e + 2][tri_of_row]
        bb = b * torch.where(b > 0, ext_y1, ext_y0) + c
        t = -bb / torch.where(a == 0.0, torch.ones_like(a), a)
        xlo = torch.where(a > 0, torch.maximum(xlo, t), xlo)
        xhi = torch.where(a < 0, torch.minimum(xhi, t), xhi)
        alive = alive & ((a != 0.0) | (bb >= 0.0))
    xlo = xlo - 1.0  # one pixel of slack each side: f32 division rounding
    xhi = xhi + 1.0  # can never cull a pair the extent reject would keep
    # tile columns whose padded extent [tx·tw − 0.5, tx·tw + tw + 0.5]
    # intersects the window, clipped to the triangle's bbox span
    inv_w = _reciprocal(tile_w)
    rx_lo = torch.maximum(
        tx0[tri_of_row], f32_to_i32(torch.ceil((xlo - 0.5) * inv_w - 1.0)))
    rx_hi = torch.minimum(
        tx0[tri_of_row] + span_w[tri_of_row] - 1,
        f32_to_i32(torch.floor((xhi + 0.5) * inv_w)))
    row_span = torch.where(alive, torch.clamp(rx_hi - rx_lo + 1, min=0),
                           torch.zeros_like(rx_hi))

    # -- stage 2: (triangle, tile) expansion over the row windows -------------
    cum_end_p = torch.cumsum(row_span, 0, dtype=torch.int32)
    total = cum_end_p[-1]  # the ragged pair demand
    cum_start_p = cum_end_p - row_span
    row_of_pair = _ragged_repeat(row_capacity, row_span, pair_capacity).long()
    pair_idx = torch.arange(pair_capacity, dtype=torch.int32, device=dev)
    pair_live = pair_idx < torch.clamp(total, max=pair_capacity)

    tri_of_pair = tri_of_row[row_of_pair]
    tile_x = rx_lo[row_of_pair] + (pair_idx - cum_start_p[row_of_pair])
    tile_y = row_ty[row_of_pair]
    # tile keys are LOCAL to the binned row set (k of tile_row_lo + k·s)
    tile = row_k[row_of_pair] * tiles_x + tile_x
    n_tiles = tiles_x * local_tiles_y
    n_keys = n_classes * n_tiles  # (class, tile) GROUPS — starts/counts rows
    cls_pair = cls[tri_of_pair]
    group = cls_pair * n_tiles + tile
    if zbuckets > 1:
        # nearest-first sub-key for the opaque class: the conservative
        # nearest depth of each triangle over its bbox is the corner-max of
        # the z plane (reverse-Z: larger = nearer), bucketed so nearer pairs
        # sort earlier within their (class=0, tile) group.
        za, zb, zc = tri_data[9], tri_data[10], tri_data[11]
        ymin, ymax = tri_data[BBOX_ROWS[1]], tri_data[BBOX_ROWS[3]]
        z_near = (za * torch.where(za > 0, xmax, xmin)
                  + zb * torch.where(zb > 0, ymax, ymin) + zc)
        z_near = torch.clamp(z_near, 0.0, 1.0)
        zb_tri = torch.clamp(f32_to_i32((1.0 - z_near) * zbuckets), 0, zbuckets - 1)
        sub = torch.where(cls_pair == 0, zb_tri[tri_of_pair],
                          torch.zeros_like(cls_pair))
        key = group * zbuckets + sub
    else:
        key = group
    dead = n_keys * zbuckets
    dead_t = torch.full_like(key, dead)
    key = torch.where(pair_live, key, dead_t)  # dead pairs → overflow bucket

    # Tight trivial-reject on the surviving pairs: a pair is kept only if
    # EVERY edge's most-inside corner of the tile's sample extent is inside.
    # The extent is padded a FULL pixel past the tile's pixel centers: 0.5 px
    # bounds every MSAA sample position, and the other 0.5 px drowns f32
    # rounding of e_max.
    ext_x0 = tile_x.to(torch.float32) * tile_w - 0.5
    ext_x1 = ext_x0 + (tile_w + 1.0)
    ext_y0p = tile_y.to(torch.float32) * tile_h - 0.5
    ext_y1p = ext_y0p + (tile_h + 1.0)
    covers = pair_live
    for e in range(3):
        a = tri_data[3 * e][tri_of_pair]
        b = tri_data[3 * e + 1][tri_of_pair]
        c = tri_data[3 * e + 2][tri_of_pair]
        e_max = (a * torch.where(a > 0, ext_x1, ext_x0)
                 + b * torch.where(b > 0, ext_y1p, ext_y0p) + c)
        covers = covers & (e_max >= 0.0)
    key = torch.where(covers, key, dead_t)

    key_sorted, order = torch.sort(key, stable=True)
    tri_sorted = tri_of_pair[order]
    # (class, tile) group of each sorted pair; dead -> n_keys sentinel
    group_sorted = (torch.div(key_sorted, zbuckets, rounding_mode="floor")
                    if zbuckets > 1 else key_sorted)

    # group boundaries: a group's keys span [g*zbuckets, (g+1)*zbuckets)
    key_range = torch.arange(n_keys, dtype=torch.int32, device=dev)
    starts_raw = torch.searchsorted(key_sorted, key_range * zbuckets).to(torch.int32)
    ends_raw = torch.searchsorted(key_sorted, (key_range + 1) * zbuckets).to(torch.int32)
    counts = ends_raw - starts_raw

    # 128-aligned destination offsets per (class, tile) segment
    padded_sizes = torch.div(counts + ALIGN - 1, ALIGN, rounding_mode="floor") * ALIGN
    padded_starts = torch.cat(
        [padded_sizes.new_zeros(1), torch.cumsum(padded_sizes, 0, dtype=torch.int32)[:-1]])

    p_total = padded_capacity_classes(pair_capacity, n_tiles, n_classes)
    gs = group_sorted.long()
    rank = pair_idx - torch.cat([starts_raw, total.reshape(1)])[gs]
    live_sorted = group_sorted < n_keys
    dest = torch.where(
        live_sorted,
        torch.cat([padded_starts, padded_starts.new_zeros(1)])[gs] + rank,
        torch.full_like(rank, p_total - 1),  # dead pairs: last (padding) column
    )

    # KEEP_ROWS: rows 0-14 gathered, the triangle id written from the sort
    rows = tri_data[:B_ROWS][:, tri_sorted.long()]  # [B_ROWS, P]
    rows[B_TID] = tri_sorted.to(torch.float32)
    # dead rows must not rasterize even via the dump column
    rows = torch.where(live_sorted[None, :], rows, torch.zeros_like(rows))

    binned = torch.zeros((B_ROWS, p_total), dtype=torch.float32, device=dev)
    binned[:, dest.long()] = rows

    # Per-class overflow: pair truncation keeps the first `pair_capacity`
    # pairs in triangle-stream order, so class c (pair-space range
    # [S_c, E_c)) loses max(0, E_c − cap) − max(0, S_c − cap) pairs.
    class_pairs = torch.zeros(n_classes, dtype=torch.int32, device=dev)
    class_pairs.index_add_(0, cls[tri_of_row].long(), row_span.to(torch.int32))
    e_c = torch.cumsum(class_pairs, 0, dtype=torch.int32)
    s_c = e_c - class_pairs
    overflow = (torch.clamp(e_c - pair_capacity, min=0)
                - torch.clamp(s_c - pair_capacity, min=0))
    row_overflow = torch.clamp(row_demand - row_capacity, min=0)
    return (binned, padded_starts.reshape(n_classes, n_tiles),
            counts.reshape(n_classes, n_tiles), overflow.to(torch.int32),
            row_overflow.to(torch.int32), total.to(torch.int32),
            row_demand.to(torch.int32))
