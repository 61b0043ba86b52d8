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


def _soup(rng, n: int) -> np.ndarray:
    """n random triangles as [3n, 4] clip vertices."""
    clip = np.empty((3 * n, 4), np.float32)
    clip[:, 3] = rng.uniform(0.3, 2.0, 3 * n)
    clip[rng.uniform(size=3 * n) < 0.05, 3] *= -0.5
    centers = np.repeat(rng.uniform(-1.1, 1.1, (n, 2)), 3, axis=0)
    spread = np.repeat(rng.uniform(0.002, 0.5, (n, 1)), 3, axis=0)
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
