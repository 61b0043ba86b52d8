"""Bitmap font atlas for the UI pass.

The reference uploads Dear ImGui's font atlas as an R8_UNORM texture and the
imgui fragment shader reads only `.r` as alpha (imgui_support.rs:52-99,
imgui.frag:34-39 tex_kind 1). Here the glyph atlas is a coverage image
committed beside this module (font_atlas.npz, written by
renderer_tpu_torch/tools/make_font_atlas.py), expanded into an RGBA8 texture
whose R channel is the glyph coverage and registered as a normal texture
slot (TextureKind.LINEAR_COLOR — no sRGB decode on fonts).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from renderer_tpu_torch.materials.registry import MaterialRegistry, Texture, TextureKind

ASCII_FIRST = 32
ASCII_LAST = 126
ATLAS_PATH = Path(__file__).with_name("font_atlas.npz")


@dataclass
class Glyph:
    u0: float
    v0: float
    u1: float
    v1: float
    width: int
    height: int
    advance: int


class Font:
    """One glyph atlas + per-character uv table, read from `path`."""

    def __init__(self, path: Path = ATLAS_PATH) -> None:
        with np.load(path) as data:  # a missing atlas raises here
            coverage = data["coverage"]
            self.line_height = int(data["line_height"])
            table = data["glyphs"]
            text_advance = data["text_advance"]
        chars = [chr(c) for c in range(ASCII_FIRST, ASCII_LAST + 1)]
        if coverage.dtype != np.uint8 or table.shape != (len(chars), 7):
            raise ValueError(f"{path}: not a font atlas")
        self.glyphs: dict[str, Glyph] = {
            ch: Glyph(float(u0), float(v0), float(u1), float(v1), int(w),
                      int(h), int(adv))
            for ch, (u0, v0, u1, v1, w, h, adv) in zip(chars, table)
        }
        # Pillow's pen step a character (ImageDraw.text), for line_coverage
        self.text_advance = dict(zip(chars, text_advance.tolist()))
        self._coverage = coverage
        rgba = np.zeros((*coverage.shape, 4), np.uint8)
        rgba[..., 0] = coverage  # alpha lives in R (R8 parity)
        rgba[..., 1] = rgba[..., 2] = coverage
        rgba[..., 3] = coverage
        self._rgba = rgba
        # one Texture PER registry: a Texture carries the slot the registry
        # that registered it assigned, so sharing one object across
        # registries would leak the first registry's slot into the second
        # (register_texture short-circuits on slot >= 0). Weak keys so a
        # dead registry can't alias a recycled id and the cache can't grow
        # unboundedly.
        self._textures: "weakref.WeakKeyDictionary[MaterialRegistry, Texture]" \
            = weakref.WeakKeyDictionary()

    def slot(self, registry: MaterialRegistry) -> int:
        tex = self._textures.get(registry)
        if tex is None:
            tex = Texture([self._rgba], TextureKind.LINEAR_COLOR, "ui-font")
            self._textures[registry] = tex
        return registry.register_texture(tex)

    def text_width(self, text: str) -> int:
        return sum(self.glyphs.get(c, self.glyphs["?"]).advance for c in text)

    def line_coverage(self, text: str) -> np.ndarray:
        """u8 [line_height - 1, w] coverage of `text` laid out as Pillow's
        ImageDraw.text lays it out with this font, its column 0 one pixel
        left of the text's origin (glyphs such as 's' and ')' reach one
        column left of their pen; the atlas keeps that column just left of
        their cells): each glyph's cell at its pen position (the sum of the
        earlier text advances), a glyph over the ones before it as Pillow
        composites them: DIV255(under * (255 - over) + over * 255)."""
        h, aw = self.line_height - 1, self._coverage.shape[1]
        ah = self._coverage.shape[0]
        chars = [c if c in self.glyphs else "?" for c in text]
        pens = np.cumsum([0] + [self.text_advance[c] for c in chars])
        width = max([int(p) + self.glyphs[c].width for p, c in zip(pens, chars)] + [0])
        out = np.zeros((h, width + 1), np.uint8)
        for pen, c in zip(pens, chars):
            g = self.glyphs[c]
            x, y = round(g.u0 * aw), round(g.v0 * ah)
            lead = min(x, 1)
            cell = self._coverage[y:y + h, x - lead:x + g.width]
            view = out[:, pen + 1 - lead:pen + 1 + g.width]
            t = view.astype(np.int32) * (255 - cell) + cell.astype(np.int32) * 255 + 128
            view[...] = ((t >> 8) + t) >> 8
        return out


_font: Font | None = None


def get_font() -> Font:
    global _font
    if _font is None:
        _font = Font()
    return _font
