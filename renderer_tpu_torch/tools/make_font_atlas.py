"""Regenerate the UI font atlas, renderer_tpu_torch/ui/font_atlas.npz.

The atlas is Pillow's built-in default font rasterized into a coverage image
of 16 glyphs a row, one cell per printable ASCII character, with a uv table
per glyph (ui/font.py reads it). The port itself never imports Pillow: the
atlas is committed, and this script is the only place that rasterizes it.

    python -m renderer_tpu_torch.tools.make_font_atlas

`ImageFont.load_default()` returns a FreeType font from Pillow 10.1 on and a
bitmap font before it, so the atlas depends on the Pillow that ran this
script; tests/test_torch_ui.py holds the committed file equal to the JAX
package's atlas under the installed Pillow.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

ASCII_FIRST = 32
ASCII_LAST = 126
COLS = 16
OUT = Path(__file__).resolve().parents[1] / "ui" / "font_atlas.npz"


def rasterize():
    """(coverage u8 [H, W], line_height, glyph table f32 [95, 7] of
    u0 v0 u1 v1 width height advance, text advances i32 [95]), in
    character order. The text advance is the pen step of Pillow's
    `ImageDraw.text` (`getlength`), which overlay/hud.draw_hud lays lines
    out with."""
    from PIL import Image, ImageDraw, ImageFont

    pil_font = ImageFont.load_default()
    chars = [chr(c) for c in range(ASCII_FIRST, ASCII_LAST + 1)]

    # measure
    draw = ImageDraw.Draw(Image.new("L", (64, 64)))
    boxes = {}
    max_h = 1
    for ch in chars:
        _x0, _y0, x1, y1 = draw.textbbox((0, 0), ch, font=pil_font)
        boxes[ch] = (max(int(x1), 1), max(int(y1), 1))
        max_h = max(max_h, boxes[ch][1])
    line_height = max_h + 2

    # rasterize one row per COLS glyphs
    cell_w = max(w for w, _ in boxes.values()) + 1
    rows = (len(chars) + COLS - 1) // COLS
    img = Image.new("L", (COLS * cell_w, rows * line_height), 0)
    draw = ImageDraw.Draw(img)
    aw, ah = img.size
    table = np.zeros((len(chars), 7), np.float64)
    for i, ch in enumerate(chars):
        cx = (i % COLS) * cell_w
        cy = (i // COLS) * line_height
        draw.text((cx, cy), ch, fill=255, font=pil_font)
        w, _h = boxes[ch]
        table[i] = (cx / aw, cy / ah, (cx + w) / aw,
                    (cy + line_height - 1) / ah, w, line_height - 1, w + 1)
    text_advance = np.array([pil_font.getlength(ch) for ch in chars], np.int32)
    return np.asarray(img, np.uint8), line_height, table, text_advance


def main() -> None:
    coverage, line_height, table, text_advance = rasterize()
    np.savez_compressed(OUT, coverage=coverage,
                        line_height=np.int32(line_height), glyphs=table,
                        text_advance=text_advance)
    print(f"wrote {OUT}: coverage {coverage.shape}, line_height {line_height}, "
          f"{len(table)} glyphs")


if __name__ == "__main__":
    main()
