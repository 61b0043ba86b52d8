"""Binned buffers built by hand for the raster kernels' edge cases, with the
layout of renderer_tpu_torch.raster.binning (f32 [16, pp] SoA, one column a
(tile, triangle) pair, per-tile starts and counts).

Every coefficient and sample coordinate is a dyadic rational of small
magnitude, so plane values are exact: edges pass exactly through sample
positions and footprint corners (e' == 0 exactly, where top-left ownership
decides), depths tie exactly, and the 1/w plane crosses 0 inside tiles.
Imports no jax, so the card-only tests can use it on a machine without it.
"""

from __future__ import annotations

import numpy as np
import torch

from renderer_tpu_torch.raster.pipeline import STANDARD_SAMPLE_POSITIONS

TILE_H, TILE_W = 32, 128
H, W = 96, 384
CASES = ("sample-edges", "footprint-corners", "subpixel", "w-crossing",
         "depth-skip")

# per-tile triangle counts: empty tiles, one triangle, exact and ragged
# chunks of 128
_COUNTS = (257, 0, 300, 128, 1, 200, 263, 131, 64)
_OFFSETS = sorted({p for m in (1, 4, 8) for p in STANDARD_SAMPLE_POSITIONS[m]})
_NORMALS = ((1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0), (1.0, 1.0),
            (-1.0, 1.0), (1.0, -1.0), (-1.0, -1.0), (2.0, 1.0), (-1.0, 2.0),
            (0.5, -1.0), (-2.0, -0.5))
# inward normals that span the plane positively: bounded triangles
_SPANNING = (((1.0, 0.0), (-1.0, 1.0), (-1.0, -1.0)),
             ((0.0, 1.0), (1.0, -1.0), (-1.0, -1.0)),
             ((-1.0, 0.0), (1.0, 1.0), (1.0, -1.0)),
             ((2.0, 1.0), (-1.0, 2.0), (-1.0, -3.0)))


def _triangle(rng, case: str, x0: float, y0: float, i: int, n: int):
    """16 binned rows of one triangle of tile origin (x0, y0), the i-th of n
    in its bin."""
    dx, dy = _OFFSETS[rng.integers(len(_OFFSETS))]
    col, row = rng.integers(TILE_W), rng.integers(TILE_H)
    radii = (0.0, 0.0, 0.5, 1.0, 3.0, 8.0)
    if case == "footprint-corners":
        # through the first / last sample column and row of 8-, 16- and
        # 32-pixel wide footprints
        col = int(rng.choice((8, 16, 32))) * rng.integers(1, 4) - rng.integers(2)
        row = 4 * rng.integers(1, 8) - rng.integers(2)
        radii = (0.0, 0.0, 0.0, 64.0)
    elif case == "subpixel":
        # around a sample or between samples, at most a pixel across
        if rng.random() < 0.5:
            dx, dy = rng.integers(32, size=2) / 32.0
        radii = (1 / 16, 1 / 8, 1 / 4, 1 / 2)
    elif case in ("w-crossing", "depth-skip"):
        radii = (4.0, 16.0, 64.0, 1e4)
    cx, cy = x0 + dx + col, y0 + dy + row
    if case == "subpixel" or rng.random() < 0.5:
        normals = _SPANNING[rng.integers(len(_SPANNING))]
    else:  # some one-sided wedges and half-planes too
        normals = [_NORMALS[k] for k in rng.choice(len(_NORMALS), size=3, replace=False)]
    planes = []
    for a, b in normals:
        planes += [a, b, float(rng.choice(radii)) - (a * cx + b * cy)]
    if case == "depth-skip":
        # whole-tile triangles, nearest first with exact ties, then a few
        # nearer ones late in the bin
        planes = [0.0, 0.0, 1.0] * 3 if rng.random() < 0.7 else planes
        z = 1.0 - (i // 3) / 256.0 if rng.random() < 0.9 else rng.integers(257) / 256.0
        zplane = [0.0, 0.0, z]
    else:
        za, zb = rng.choice((0.0, 0.0, 1 / 1024, -1 / 1024, 1 / 256), size=2)
        zc = float(rng.choice((0.0, 0.25, 0.5, 0.75, 1.0, -0.125, 1.125)))
        zplane = [za, zb, zc - za * x0 - zb * y0]
    wplane = [0.0, 0.0, 1.0]
    if case == "w-crossing":
        wa, wb = _NORMALS[rng.integers(len(_NORMALS))]
        wplane = [wa / 64, wb / 64, -(wa * cx + wb * cy) / 64]
    return planes + zplane + wplane + [float(rng.integers(1 << 20))]


def crafted_bins(case: str, device, seed: int = 0):
    """(binned, starts, counts) of `case` for an H × W screen in 32 × 128
    tiles. Odd cases put tile starts off 16-byte alignment and give pp an
    odd length, so both of the kernels' staging paths run."""
    rng = np.random.default_rng([CASES.index(case), seed])
    aligned = CASES.index(case) % 2 == 0
    tiles_x = W // TILE_W
    cols, starts, at = [], [], 0
    for t, n in enumerate(_COUNTS):
        x0, y0 = (t % tiles_x) * TILE_W, (t // tiles_x) * TILE_H
        start = at if aligned else at + 1 + t % 3
        cols += [[0.0] * 16] * (start - at)
        cols += [_triangle(rng, case, x0, y0, i, n) for i in range(n)]
        starts.append(start)
        at = start + n
        pad = (-at) % 128 if aligned else 0
        cols += [[0.0] * 16] * pad
        at += pad
    cols += [[0.0] * 16] * (256 if aligned else 257)
    binned = np.ascontiguousarray(np.asarray(cols, np.float32).T)
    return (torch.from_numpy(binned).to(device),
            torch.tensor(starts, dtype=torch.int32, device=device),
            torch.tensor(_COUNTS, dtype=torch.int32, device=device))


def crafted_floor(n_s: int, device, seed: int = 0):
    """A depth floor [S, H, W] for the layered kernel: per 8 × 4 block one of
    a few exact levels (some high enough to reject most triangles), plus
    exact per-sample steps of 1/64."""
    rng = np.random.default_rng([99, seed])
    levels = np.array([0.0, 0.0, 0.25, 0.5, 0.75, 0.9375], np.float32)
    block = levels[rng.integers(len(levels), size=(n_s, H // 4, W // 8))]
    floor = np.repeat(np.repeat(block, 4, axis=1), 8, axis=2)
    floor += rng.integers(4, size=floor.shape).astype(np.float32) / 64
    return torch.from_numpy(np.ascontiguousarray(floor)).to(device)


# -- UI pass cases (raster/ui_stage.py): K2 in blended mode at z = 0.5 -------

UI_CASES = ("windings", "deep-stack", "glyphs", "edges-on-samples")


def ui_drawlist(case: str, seed: int = 0):
    """A renderer_tpu_torch.ui.DrawList of `case` on the H × W screen, and
    the MaterialRegistry its font is registered in:
    - windings: quads of 1-60 px drawn counter-clockwise (add_quad) and the
      same shapes clockwise (add_triangle with the vertices reversed);
    - deep-stack: 24 quads over one spot (deeper than every layer count the
      kernel takes) and partial overlaps, every fragment at z = 0.5;
    - glyphs: text lines from the font atlas (glyph-sized quads);
    - edges-on-samples: quad edges on pixel centres, on MSAA sample offsets
      and on the corners of 8-, 16- and 32-pixel-wide footprints."""
    from renderer_tpu_torch.materials.registry import MaterialRegistry
    from renderer_tpu_torch.ui import DrawList, get_font

    rng = np.random.default_rng([UI_CASES.index(case), seed])
    registry = MaterialRegistry()
    dl = DrawList()

    def color():
        return tuple(int(c) for c in rng.integers(40, 256, size=4))

    def quad(x0, y0, x1, y1, clockwise=False):
        if clockwise:  # the two triangles of add_quad, vertex order reversed
            c = color()
            dl.add_triangle((x0, y1), (x1, y0), (x0, y0), c)
            dl.add_triangle((x1, y1), (x1, y0), (x0, y1), c)
        else:
            dl.add_rect_filled((x0, y0), (x1, y1), color())

    if case == "windings":
        for i in range(120):
            w, h = rng.uniform(1.0, 60.0, size=2)
            x0, y0 = rng.uniform(-8.0, W), rng.uniform(-8.0, H)
            quad(x0, y0, x0 + w, y0 + h, clockwise=bool(i % 2))
    elif case == "deep-stack":
        for i in range(24):
            quad(100.0 + i, 30.0 + (i % 3), 160.0 - i, 70.0, clockwise=bool(i % 3 == 0))
        for _ in range(40):
            x0, y0 = rng.uniform(0.0, W - 40.0), rng.uniform(0.0, H - 20.0)
            quad(x0, y0, x0 + 40.0, y0 + 20.0, clockwise=bool(rng.integers(2)))
    elif case == "glyphs":
        font = get_font()
        dl.push_clip_rect(4.0, 4.0, W - 20.0, H - 4.0)
        for line in range(6):
            text = "".join(chr(c) for c in rng.integers(32, 127, size=40))
            dl.add_text((float(rng.integers(0, 8)) + 0.5 * (line % 2),
                         4.0 + line * font.line_height), text, color(), font,
                        registry)
        dl.pop_clip_rect()
    else:
        assert case == "edges-on-samples", case
        offsets = sorted({p for m in (1, 4, 8) for p in STANDARD_SAMPLE_POSITIONS[m]})
        for i in range(160):
            if i % 2:  # footprint corners
                x0 = float(rng.choice((8, 16, 32)) * rng.integers(0, 12))
                y0 = float(4 * rng.integers(0, 22))
                w = float(rng.choice((8, 16, 32)) * rng.integers(1, 4))
                h = float(4 * rng.integers(1, 4))
            else:  # pixel centres and sample offsets
                dx, dy = offsets[rng.integers(len(offsets))]
                x0 = float(rng.integers(0, W - 16)) + dx
                y0 = float(rng.integers(0, H - 8)) + dy
                w, h = float(rng.integers(1, 16)), float(rng.integers(1, 8))
            quad(x0, y0, x0 + w, y0 + h, clockwise=bool(i % 3 == 0))
    return dl, registry


def ui_config(n_layers: int = 4):
    """RenderConfig of the UI cases' H × W screen."""
    from renderer_tpu_torch.core.config import RenderConfig

    return RenderConfig(width=W, height=H, ui_layers=n_layers,
                        ui_pair_capacity=1 << 12)
