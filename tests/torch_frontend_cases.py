"""Inputs of the raster front end (renderer_tpu_torch/raster/setup.py and
binning.py), made with numpy from a seed, for the CPU parity tests against
the JAX package (tests/test_torch_frontend.py) and the card tests of kernels
F1-F4 (tests/test_torch_cuda_kernels.py). Imports neither jax nor torch.

`setup_inputs(case, tiles)` gives triangle_setup's inputs on a screen of
TILE_GRID tiles of `tiles` (tile_w, tile_h): clip f32 [V, 4], tri_v i32
[T, 3] (T = N_TRIS for every case, so that the parity tests compile each
JAX configuration once), num_tris (the last NUM_PADDING triangles are
padding) and the screen's width and height. The crafted cases, each mixed
with a random soup so that every class has triangles:

- "soup": random triangles from sub-pixel to half the screen, depths across
  the near plane, one vertex in 20 behind the eye (w crossing 0);
- "degenerate": points (one vertex thrice), a repeated vertex and collinear
  triples (horizontal, vertical, diagonal, at w = 2), each beside a valid
  triangle of the same vertices;
- "w-edge": a vertex at w = 0 exactly (+0.0 and -0.0), at w = ±1e-6 and its
  f32 neighbours, and whole triangles behind the eye;
- "non-finite": one coordinate of a vertex +inf, -inf or NaN;
- "tile-edges": vertices at pixel centres on tile edges (x = k·tile_w ± 0.5,
  y = k·tile_h ± 0.5) and on the screen's border, axis-aligned and slanted,
  and a vertex one ULP above the tile edge y = 120 at 384×24, where a
  quotient by the tile height and the product with its f32 reciprocal
  round to different sides of 5 (RECIPROCAL_FLIP).

`bin_config(name, tiles, n)` gives bin_triangle_classes' bounds and keyword
arguments for the BIN_CONFIGS: 1, 2 and 3 classes, z-buckets 1 and 16, a
band (tile_row_lo 1, row_stride 2, half the tile rows), and pair and row
truncation (capacities below the soup's demand).
"""

from __future__ import annotations

import numpy as np

CASES = ("soup", "degenerate", "w-edge", "non-finite", "tile-edges")
TILES = ((128, 32), (384, 24))
TILE_GRID = (4, 6)  # tiles across and down
N_TRIS = 192
NUM_PADDING = 5
#: (tiles, the pixel row of the tile-edges case's vertex whose bbox
#: quotient by the tile height flips under a reciprocal product)
RECIPROCAL_FLIP = ((384, 24), 119.99999237060547)
BIN_CONFIGS = ("one-class", "two-classes-zb1", "three-classes", "band",
               "pair-truncation", "row-truncation")
# (tiles, config) of the CPU parity tests: every config at the default
# tiles, three at 384×24 (each configuration compiles the jitted JAX
# binning anew, ~1 s)
PARITY_BINS = tuple([(TILES[0], c) for c in BIN_CONFIGS]
                    + [(TILES[1], c) for c in ("two-classes-zb1", "band", "pair-truncation")])


def screen(tiles: tuple) -> tuple[int, int]:
    return tiles[0] * TILE_GRID[0], tiles[1] * TILE_GRID[1]


def _soup(rng, n: int, largest: float = 0.5) -> np.ndarray:
    """n random triangles as [3n, 4] clip vertices, of spreads up to
    `largest` in NDC."""
    clip = np.empty((3 * n, 4), np.float32)
    clip[:, 3] = rng.uniform(0.3, 2.0, 3 * n)
    clip[rng.uniform(size=3 * n) < 0.05, 3] *= -0.5
    centers = np.repeat(rng.uniform(-1.1, 1.1, (n, 2)), 3, axis=0)
    spread = np.repeat(rng.uniform(0.002, largest, (n, 1)), 3, axis=0)
    clip[:, :2] = (centers + spread * rng.normal(size=(3 * n, 2))) * clip[:, 3:4]
    clip[:, 2] = rng.uniform(-0.1, 1.1, 3 * n) * clip[:, 3]
    return clip


def _ndc(px: float, py: float, width: int, height: int, w: float = 1.0, z: float = 0.5):
    """The clip vertex at pixel (px, py) of the screen, at depth w."""
    return [(2.0 * px / width - 1.0) * w, (2.0 * py / height - 1.0) * w, z * w, w]


def _crafted(case: str, width: int, height: int, tiles: tuple) -> np.ndarray:
    v = lambda px, py, w=1.0: _ndc(px, py, width, height, w)  # noqa: E731
    tw, th = tiles
    tris = []
    if case == "degenerate":
        for w in (1.0, 2.0):
            tris += [
                [v(40.5, 20.5, w)] * 3,                                       # a point
                [v(40.5, 20.5, w), v(40.5, 20.5, w), v(90.5, 60.5, w)],       # repeated
                [v(30.5, 40.5, w), v(60.5, 40.5, w), v(90.5, 40.5, w)],       # horizontal
                [v(50.5, 10.5, w), v(50.5, 30.5, w), v(50.5, 70.5, w)],       # vertical
                [v(10.5, 10.5, w), v(20.5, 20.5, w), v(40.5, 40.5, w)],       # diagonal
                [v(30.5, 40.5, w), v(90.5, 40.5, w), v(60.5, 80.5, w)],       # controls
                [v(30.5, 40.5, w), v(60.5, 80.5, w), v(90.5, 40.5, w)],
            ]
    elif case == "w-edge":
        eps = np.float32(1e-6)
        for w0 in (0.0, -0.0, eps, -eps, np.nextafter(eps, np.float32(1)),
                   np.nextafter(eps, np.float32(0)), -1.0):
            a, b, c = v(100.5, 50.5), v(300.5, 60.5), v(180.5, 150.5)
            a = [a[0], a[1], a[2], float(w0)]
            tris += [[a, b, c], [a, c, b]]
        tris += [[v(100.5, 50.5, -1.0), v(300.5, 60.5, -2.0), v(180.5, 150.5, -0.5)]]
    elif case == "non-finite":
        for bad in (np.inf, -np.inf, np.nan):
            for comp in range(4):
                a, b, c = v(60.5, 30.5), v(220.5, 40.5), v(140.5, 120.5)
                a = list(a)
                a[comp] = bad
                tris += [[a, b, c], [b, a, c]]
    elif case == "tile-edges":
        for k in range(1, 3):
            x0, y0 = k * tw - 0.5, k * th - 0.5
            x1, y1 = k * tw + 0.5, k * th + 0.5
            tris += [
                [v(x0, y0), v(x0, y0 + 2 * th), v(x0 + tw, y0)],
                [v(x1, y1), v(x1 + tw, y1), v(x1, y1 + th)],
                [v(x0, 0.5), v(x0, height - 0.5), v(x1 + 3, 0.5)],
                [v(0.5, y0), v(width - 0.5, y0), v(0.5, y1 + 5)],
                [v(x0, y1), v(x1 + tw, y0 + th), v(x0 - tw / 2, y1 + th)],
            ]
        tris += [[v(0.0, 0.0), v(width, 0.0), v(0.0, height)],
                 [v(width - 0.5, height - 0.5), v(0.5, height - 0.5), v(width - 0.5, 0.5)]]
        # a bottom vertex at y = 120 − 1 ULP (at 384×24's height 144, w =
        # 0.75): with bbox_pad 0.5, (ymax − 0.5) / 24 is just below 5 while
        # its product with the f32 reciprocal of 24 rounds to 5
        w = 0.75
        bottom = [(2.0 * 200.5 / width - 1.0) * w, 0.49999991059303284, 0.5 * w, w]
        tris += [[v(180.5, 60.5), v(260.5, 70.5), bottom],
                 [v(180.5, 60.5), bottom, v(260.5, 70.5)]]
    return np.asarray(tris, np.float32).reshape(-1, 4)


def setup_inputs(case: str, tiles: tuple, seed: int = 0) -> dict:
    if case not in CASES:
        raise ValueError(case)
    rng = np.random.default_rng(seed)
    width, height = screen(tiles)
    crafted = (_crafted(case, width, height, tiles) if case != "soup"
               else np.zeros((0, 4), np.float32))
    n_crafted = crafted.shape[0] // 3
    clip = np.concatenate([_soup(rng, N_TRIS - n_crafted), crafted])
    tri_v = rng.permutation(N_TRIS).astype(np.int32)  # crafted ones spread out
    tri_v = (3 * tri_v[:, None] + np.arange(3, dtype=np.int32)).astype(np.int32)
    return dict(clip=clip, tri_v=tri_v, num_tris=N_TRIS - NUM_PADDING,
                width=width, height=height)


def bin_config(name: str, tiles: tuple, n: int) -> tuple[tuple, dict]:
    """(bounds, keyword arguments) of bin_triangle_classes for `n` triangles."""
    if name not in BIN_CONFIGS:
        raise ValueError(name)
    tw, th = tiles
    kw = dict(tiles_x=TILE_GRID[0], tiles_y=TILE_GRID[1], tile_w=tw, tile_h=th,
              pair_capacity=4096, row_capacity=4096, zbuckets=16)
    bounds = (0, n // 2, 3 * n // 4, n - NUM_PADDING)
    if name == "one-class":
        bounds = (0, n - NUM_PADDING)
    elif name == "two-classes-zb1":
        bounds = (0, n // 2, n - NUM_PADDING)
        kw["zbuckets"] = 1
    elif name == "band":
        kw.update(tile_row_lo=1, row_stride=2, local_tiles_y=TILE_GRID[1] // 2)
    elif name == "pair-truncation":
        kw.update(pair_capacity=96)
    elif name == "row-truncation":
        kw.update(row_capacity=48)
    return bounds, kw


# -- F2 spans' and F4 scan's edges --------------------------------------------
#
# F2 spans (csrc/frontend.cu) takes a triangle a thread, 256 threads a
# block, on its narrow path below SPANS_GATE_MIN triangles and from there
# on its wide path, persistent blocks where a triangle reads its bbox and
# z rows only when it is valid; F4 scan takes one key a thread up to 1024
# keys, else up to 4096 keys a pass, ceil(keys / 1024) consecutive keys a
# thread. EDGE_CASES: name → (triangles, tile
# (w, h), tile grid (across, down), classes, other keyword arguments of
# bin_triangle_classes). The key count n_classes × tiles across × tile rows
# is in the "keys-" names; the "tc-" triangle counts are 190, 1023 and 1025
# (one short of and one past 4 × 256, neither a multiple of 4), 40000 and
# 40001 (past SPANS_GATE_MIN); "stride-3" bins a band of every third tile
# row. Each soup has a run of invalid (off-screen) triangles, EDGE_RUN,
# across whole groups of 4 and at least one whole block of 256 (of 1024 in
# the longer soups).

EDGE_CASES = {
    "tc-190": (190, (32, 16), (6, 8), 3, {}),
    "tc-1023": (1023, (32, 16), (6, 8), 3, {"zbuckets": 1}),
    "tc-1025": (1025, (32, 16), (6, 8), 2, {}),
    "tc-40000": (40000, (32, 16), (6, 8), 3, {}),
    "tc-40001": (40001, (32, 16), (6, 8), 3, {"zbuckets": 1}),
    "keys-1023": (2400, (16, 8), (11, 31), 3, {}),
    "keys-1024": (2400, (8, 8), (32, 32), 1, {"zbuckets": 1}),
    "keys-1025": (2400, (8, 8), (25, 41), 1, {}),
    "keys-2048": (2400, (8, 8), (32, 32), 2, {"zbuckets": 1}),
    "keys-2049": (2400, (8, 32), (683, 1), 3, {}),
    "keys-4097": (2400, (8, 4), (17, 241), 1, {}),
    "stride-3": (2400, (32, 16), (6, 9), 3, {"tile_row_lo": 2, "row_stride": 3,
                                              "local_tiles_y": 3}),
}
#: the run of invalid triangles [lo, hi) in a soup of n: across a whole
#: span of 1024 triangles (2400, 40000 and 40001 triangles) or of 256
EDGE_RUN = {2400: (1000, 2100), 40000: (1000, 2100), 40001: (1000, 2100), 1023: (250, 530),
            1025: (250, 530), 190: (13, 38)}
#: F2 spans takes its wide path from this many triangles (csrc/frontend.cu
#: SPANS_GATE_MIN): "tc-40000" and "tc-40001" take it, the others the
#: narrow path
SPANS_GATE_MIN = 32768


def edge_inputs(name: str, seed: int = 0) -> dict:
    """triangle_setup's inputs of an EDGE_CASES case (as setup_inputs):
    a soup of small triangles with the run EDGE_RUN moved off the screen."""
    n, tile, grid = EDGE_CASES[name][:3]
    rng = np.random.default_rng(seed)
    clip = _soup(rng, n, largest=0.08)
    run = slice(3 * EDGE_RUN[n][0], 3 * EDGE_RUN[n][1])
    clip[run, 3] = np.abs(clip[run, 3])  # in front of the eye, left of the screen
    clip[run, 0] = -3.0 * clip[run, 3] - 1.0
    return dict(clip=clip, tri_v=np.arange(3 * n, dtype=np.int32).reshape(n, 3),
                num_tris=n - NUM_PADDING, width=tile[0] * grid[0], height=tile[1] * grid[1])


def edge_bins(name: str) -> tuple[tuple, dict]:
    """(bounds, keyword arguments) of bin_triangle_classes for a case."""
    n, tile, grid, classes, extra = EDGE_CASES[name]
    live = n - NUM_PADDING
    bounds = {1: (0, live), 2: (0, n // 2, live), 3: (0, n // 2, 3 * n // 4, live)}[classes]
    kw = dict(tiles_x=grid[0], tiles_y=grid[1], tile_w=tile[0], tile_h=tile[1],
              pair_capacity=1 << 14, row_capacity=1 << 14, zbuckets=16)
    kw.update(extra)
    return bounds, kw


# -- the block-boundary case ------------------------------------------------
#
# F2 rows and F3 (csrc/frontend.cu) give a block of threads a fixed number
# of items of the merge path of their sources (triangles; rows) with their
# slots (rows; pairs): binning.EXPAND_ITEMS. "blocks" is a stream whose
# counts follow from its construction (block_counts), so that block_variants
# can put a live count, a dead-slot start or a truncation at or inside a
# block's edge. At tiles of 128×32 on the 4×6 grid (512×192 pixels), with
# w = 1, each triangle is one of
# - "Z": off the screen, no rows;
# - "S": small, inside one tile: 1 row of 1 pair;
# - "T": tall, inside one tile column: every tile row, 1 pair each;
# - "W": wide, inside one tile row: 1 row of 4 pairs.
# The stream: a run of BLOCK_PREFIX Z (longer than a block), a body of
# BLOCK_BODY random S, T, W and Z, BLOCK_TAIL S with one W in their middle
# (trimming the last class bound by m triangles moves the live counts by
# 2 or 5 a triangle, so some m meets every residue), and NUM_PADDING Z
# past num_tris.

BLOCK_PREFIX = 1500
BLOCK_BODY = 2000
BLOCK_TAIL = 1200
BLOCK_TILES = TILES[0]
#: the row and pair capacities of the block case's bin configurations
BLOCK_CAPACITY = 1 << 13
#: pixel vertices of each kind in tile (tx, ty), front-facing
_SHAPES = {
    "Z": lambda x0, y0: ((-300.5, 50.5), (-250.5, 80.5), (-200.5, 50.5)),
    "S": lambda x0, y0: ((x0 + 20.5, y0 + 8.5), (x0 + 40.5, y0 + 24.5), (x0 + 60.5, y0 + 8.5)),
    "T": lambda x0, y0: ((x0 + 20.5, 4.5), (x0 + 60.5, 187.5), (x0 + 100.5, 4.5)),
    "W": lambda x0, y0: ((8.5, y0 + 4.5), (256.5, y0 + 28.5), (503.5, y0 + 4.5)),
}


def block_layout(seed: int = 0) -> list[tuple[str, int, int]]:
    """(kind, tx, ty) of each triangle of the "blocks" case, in stream order."""
    rng = np.random.default_rng(seed)
    tiles_x, tiles_y = TILE_GRID
    cell = lambda kind: (kind, int(rng.integers(tiles_x)), int(rng.integers(tiles_y)))  # noqa: E731
    body = rng.choice(["S", "T", "W", "Z"], BLOCK_BODY, p=[0.4, 0.25, 0.25, 0.1])
    tail = ["S"] * BLOCK_TAIL
    tail[BLOCK_TAIL // 2] = "W"
    kinds = ["Z"] * BLOCK_PREFIX + list(body) + tail + ["Z"] * NUM_PADDING
    return [cell(k) for k in kinds]


def block_inputs(seed: int = 0) -> dict:
    """triangle_setup's inputs of the "blocks" case (as setup_inputs)."""
    rng = np.random.default_rng(seed + 1)
    layout = block_layout(seed)
    width, height = screen(BLOCK_TILES)
    tw, th = BLOCK_TILES
    clip = []
    for kind, tx, ty in layout:
        for px, py in _SHAPES[kind](tx * tw, ty * th):
            z = float(rng.uniform(0.2, 0.8))
            clip.append([2.0 * px / width - 1.0, 2.0 * py / height - 1.0, z, 1.0])
    n = len(layout)
    return dict(clip=np.asarray(clip, np.float32),
                tri_v=np.arange(3 * n, dtype=np.int32).reshape(n, 3),
                num_tris=n - NUM_PADDING, width=width, height=height)


def block_counts(layout: list, bounds: tuple, kw: dict) -> tuple[np.ndarray, list]:
    """(each triangle's row count, each triangle's rows' pair counts) of the
    "blocks" case binned with `bounds` and `kw`, before truncation: a
    triangle outside [bounds[0], bounds[-1]) has none; rows are the band's
    (tile_row_lo + k * row_stride, k < local_tiles_y)."""
    tiles_y = TILE_GRID[1]
    lo, stride = kw.get("tile_row_lo", 0), kw.get("row_stride", 1)
    band = {lo + k * stride for k in range(kw.get("local_tiles_y") or tiles_y)}
    rows, spans = [], []
    for t, (kind, _tx, ty) in enumerate(layout):
        tile_rows = {"Z": [], "S": [ty], "W": [ty], "T": list(range(tiles_y))}[kind]
        if not bounds[0] <= t < bounds[-1]:
            tile_rows = []
        n = sum(r in band for r in tile_rows)
        rows.append(n)
        spans.append([4 if kind == "W" else 1] * n)
    return np.asarray(rows, np.int64), spans


def block_demands(layout: list, bounds: tuple, kw: dict, front: int = 0) -> dict:
    """The merge paths of F2 rows and F3 on the "blocks" case (after
    `front` zero-count triangles): the live rows and pairs, the row
    demand, each live row's triangle and first pair, each live pair's row,
    and the merge position of each live slot (its index plus the sources
    before it)."""
    rows, spans = block_counts(layout, bounds, kw)
    rows = np.concatenate([np.zeros(front, np.int64), rows])
    spans = [[]] * front + spans
    rc, pc = kw["row_capacity"], kw["pair_capacity"]
    row_tri = np.repeat(np.arange(rows.size), rows)
    live_r = min(row_tri.size, rc)
    row_span = np.asarray([s for per in spans for s in per], np.int64)[:live_r]
    pair_row = np.repeat(np.arange(live_r), row_span)
    live_p = min(pair_row.size, pc)
    return dict(live_rows=live_r, live_pairs=live_p, row_demand=int(rows.sum()),
                pair_demand=int(row_span.sum()), row_tri=row_tri[:live_r],
                row_first_pair=np.cumsum(row_span) - row_span, pair_row=pair_row[:live_p],
                row_pos=np.arange(live_r) + row_tri[:live_r],
                pair_pos=np.arange(live_p) + pair_row[:live_p])


def block_bins(n: int) -> tuple[tuple, dict]:
    """The "blocks" case's base bounds and bin_triangle_classes arguments
    (three classes, 16 z-buckets, every count below the capacities)."""
    tw, th = BLOCK_TILES
    return (0, n // 2, 3 * n // 4, n - NUM_PADDING), dict(
        tiles_x=TILE_GRID[0], tiles_y=TILE_GRID[1], tile_w=tw, tile_h=th,
        pair_capacity=BLOCK_CAPACITY, row_capacity=BLOCK_CAPACITY, zbuckets=16)


#: the names of block_variants' configurations
BLOCK_VARIANTS = ("base", "band", *(
    f"{what} {delta:+d}" for delta in (-1, 0, 1)
    for what in ("rows-dead-start", "rows-live-end", "pairs-live-end", "pairs-dead-start")),
    "rows-truncated", "pairs-truncated")


def block_variants(items_rows: int, items_pairs: int, seed: int = 0) -> list[dict]:
    """Bin configurations of the "blocks" case that put F2 rows' and F3's
    edges at and around multiples of their blocks' items (items_rows,
    items_pairs): dicts of "name", "bounds", "kw", "front" and "back" (zero
    columns to put before and after the triangle setup's output). Each
    name says what it places where (δ in -1, 0, +1, modulo the items):
    - "base", "band" (tile_row_lo 1, row_stride 2, 3 tile rows);
    - "rows-dead-start δ": F2 rows' triangles and live rows together at δ
      (past it a block writes dead rows only), by zero columns after;
    - "rows-live-end δ": the merge position after the last live row at δ,
      by zero columns before;
    - "pairs-live-end δ": F3's live rows and live pairs together at δ
      (past it come the rows without pairs), by trimming the last class;
    - "pairs-dead-start δ": the row capacity and the live pairs together
      at δ (past it a block writes dead pairs only), by the row capacity,
      at least a block of dead rows above the demand;
    - "rows-truncated", "pairs-truncated": the row capacity inside a tall
      triangle's rows, the pair capacity inside a wide triangle's row's
      pairs, both past three blocks and in the middle half of a block."""
    layout = block_layout(seed)
    n = len(layout)
    bounds, kw = block_bins(n)
    out = [dict(name="base", bounds=bounds, kw=kw, front=0, back=0),
           dict(name="band", bounds=bounds, front=0, back=0,
                kw={**kw, "tile_row_lo": 1, "row_stride": 2, "local_tiles_y": 3})]
    base = block_demands(layout, bounds, kw)
    live_r, live_p = base["live_rows"], base["live_pairs"]
    rows, spans = block_counts(layout, bounds, kw)
    # rows and pairs of the triangles before each index
    cum_rows = np.concatenate([[0], np.cumsum(rows)])
    cum_pairs = np.concatenate([[0], np.cumsum([sum(per) for per in spans])])
    for delta in (-1, 0, 1):
        out.append(dict(name=f"rows-dead-start {delta:+d}", bounds=bounds, kw=kw, front=0,
                        back=(delta - n - live_r) % items_rows))
        out.append(dict(name=f"rows-live-end {delta:+d}", bounds=bounds, kw=kw, back=0,
                        front=(delta - int(base["row_pos"][-1]) - 1) % items_rows))
        # trimming the last class by m drops the last m triangles' rows and pairs
        ends = np.arange(bounds[-1] - BLOCK_TAIL, bounds[-1] + 1)[::-1]
        together = live_r + live_p - (cum_rows[-1] - cum_rows[ends]) - (
            cum_pairs[-1] - cum_pairs[ends])
        m = int(np.flatnonzero((together - delta) % items_pairs == 0)[0])
        out.append(dict(name=f"pairs-live-end {delta:+d}", front=0, back=0, kw=kw,
                        bounds=bounds[:-1] + (bounds[-1] - m,)))
        rc = live_r + items_pairs + (delta - live_r - items_pairs - live_p) % items_pairs
        out.append(dict(name=f"pairs-dead-start {delta:+d}", bounds=bounds,
                        kw={**kw, "row_capacity": rc}, front=0, back=0))
    tall = [t for t, (kind, _x, _y) in enumerate(layout)
            if kind == "T" and bounds[0] <= t < bounds[-1]]
    middle = lambda pos, items: items // 4 <= pos % items < 3 * items // 4  # noqa: E731
    for t in tall:
        rc = int(np.searchsorted(base["row_tri"], t)) + 3
        if rc > 3 * items_rows and middle(rc - 1 + t, items_rows):
            out.append(dict(name="rows-truncated", bounds=bounds, front=0, back=0,
                            kw={**kw, "row_capacity": rc}))
            break
    wide = [r for r in range(live_r) if layout[base["row_tri"][r]][0] == "W"]
    for r in wide:
        pc = int(base["row_first_pair"][r]) + 2
        if pc > 3 * items_pairs and middle(pc - 1 + r, items_pairs):
            out.append(dict(name="pairs-truncated", bounds=bounds, front=0, back=0,
                            kw={**kw, "pair_capacity": pc}))
            break
    return out


# -- F1's edges ---------------------------------------------------------------
#
# F1 (csrc/frontend.cu setup_kernel) takes a triangle a thread, SETUP_TILE
# triangles a block (setup.TILE); the card holds R blocks at once
# (setup.setup_launch), so past R blocks its grid takes a second wave.
# setup_edges(R): name → (triangles, num_tris): counts at and around a
# warp, a block, R blocks and past two rounds of them, with num_tris
# cutting inside a block in some.

SETUP_TILE = 128
#: R for the CPU tests, where no card says it: 132 SMs × 9 blocks
NOMINAL_RESIDENT = 1188


def setup_edges(resident: int) -> dict:
    t, r = SETUP_TILE, resident * SETUP_TILE
    return {"tc-1": (1, 1), "tc-33": (33, 20), "tile-1": (t - 1, t - 1), "tile": (t, t - 25),
            "tile+1": (t + 1, t + 1), "two-tiles+1": (2 * t + 1, t + 44),
            "grid-1": (r - 1, r - 1), "grid": (r, r - 77), "grid+1": (r + 1, r + 1),
            "two-waves+129": (2 * r + 129, 2 * r + 100)}


def setup_edge_inputs(n: int, num: int, seed: int = 0) -> dict:
    """triangle_setup's inputs (as setup_inputs) of the first n triangles of
    a soup of small ones, num_tris = num, on TILES[0]'s screen. The soup
    comes in chunks of 4096 triangles, each from a seed of its own, so a
    case's inputs are the first n triangles of any longer case's."""
    chunks = -(-n // 4096)
    clip = np.concatenate([_soup(np.random.default_rng([seed, k]), 4096, largest=0.08)
                           for k in range(chunks)])[:3 * n]
    width, height = screen(TILES[0])
    return dict(clip=clip, tri_v=np.arange(3 * n, dtype=np.int32).reshape(n, 3),
                num_tris=num, width=width, height=height)


# -- F4 scatter's edges ---------------------------------------------------------
#
# F4 scatter (csrc/frontend.cu scatter_kernel) gives a block a tile of
# binning.SCATTER_COLS binned columns and finds the (class, tile) groups its
# columns fall in from the groups at its segments' ends (a group that owns
# columns is at least 128 wide). The "scatter" case puts a chosen count of
# small triangles (1 pair each) into chosen (class, tile) groups of a 16×12
# grid of 128×32 tiles (576 groups): a group of exactly one tile's columns
# (its live columns end at the tile's edge), a group longer than a tile, a
# group's count one short of and one past 128, and one of one pair; 476
# empty groups (the rest of class 0, class 1, class 2 up to tile 100) all
# start inside the tile whose columns the groups on either side also take.
# SCATTER_CASES: name → (pair capacity, whether the classes are empty):
# "scatter" at a capacity of 4096, "scatter-odd" at 4099 (the binned rows
# are then not 8-byte aligned), "scatter-cut" at 2001 (the pairs cut inside
# the long group), "scatter-none" with every class empty (no live pair), and
# the binned columns one short of ("scatter-narrow-edge") and at
# ("scatter-wide-edge") SCATTER_WIDE_MIN, where F4 scatter takes its wide
# path (binning.SCATTER_WIDE_MIN).

SCATTER_GRID = (16, 12)
#: (class, tile index, triangles) of the "scatter" case, in stream order
SCATTER_GROUPS = ((0, 0, 1024), (0, 1, 1500), (0, 2, 1), (0, 5, 127), (0, 7, 129),
                  (0, 9, 10), (2, 100, 5), (2, 191, 300))
SCATTER_WIDE_MIN = 524288
_SCATTER_PADDING = 128 * 3 * 16 * 12 + 256  # binning.padded_capacity_classes past the pairs
SCATTER_CASES = {"scatter": (4096, False), "scatter-odd": (4099, False),
                 "scatter-cut": (2001, False), "scatter-none": (4096, True),
                 "scatter-narrow-edge": (SCATTER_WIDE_MIN - _SCATTER_PADDING - 1, False),
                 "scatter-wide-edge": (SCATTER_WIDE_MIN - _SCATTER_PADDING, False)}


def scatter_inputs(seed: int = 0) -> dict:
    """triangle_setup's inputs (as setup_inputs) of the "scatter" case: the
    triangles of SCATTER_GROUPS, each inside its tile, then NUM_PADDING off
    the screen."""
    rng = np.random.default_rng(seed)
    tw, th = TILES[0]
    width, height = SCATTER_GRID[0] * tw, SCATTER_GRID[1] * th
    verts = []
    for _cls, tile, count in SCATTER_GROUPS:
        x0, y0 = (tile % SCATTER_GRID[0]) * tw, (tile // SCATTER_GRID[0]) * th
        verts += list(_SHAPES["S"](x0, y0)) * count
    verts += list(_SHAPES["Z"](0, 0)) * NUM_PADDING
    px = np.asarray(verts, np.float64)
    n = len(verts) // 3
    clip = np.empty((3 * n, 4), np.float32)
    clip[:, 0] = 2.0 * px[:, 0] / width - 1.0
    clip[:, 1] = 2.0 * px[:, 1] / height - 1.0
    clip[:, 2] = rng.uniform(0.2, 0.8, 3 * n)
    clip[:, 3] = 1.0
    return dict(clip=clip, tri_v=np.arange(3 * n, dtype=np.int32).reshape(n, 3),
                num_tris=n - NUM_PADDING, width=width, height=height)


def scatter_bins(name: str) -> tuple[tuple, dict]:
    """(bounds, keyword arguments) of bin_triangle_classes for a case."""
    capacity, empty = SCATTER_CASES[name]
    per_class = [sum(c for cls, _t, c in SCATTER_GROUPS if cls == k) for k in range(3)]
    ends = tuple(int(e) for e in np.cumsum(per_class))
    bounds = (0, 0, 0, 0) if empty else (0, *ends)
    tw, th = TILES[0]
    return bounds, dict(tiles_x=SCATTER_GRID[0], tiles_y=SCATTER_GRID[1], tile_w=tw,
                        tile_h=th, pair_capacity=capacity, row_capacity=4096, zbuckets=16)
