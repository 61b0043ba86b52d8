"""The port's host-side HUD, overlay/hud.draw_hud (no Pillow), against the
JAX package's (Pillow's ImageDraw) on the CPU.

Measured difference: none. The port lays each line out with the font
atlas's glyph cells at Pillow's pen steps (`Font.line_coverage`, the
atlas's `text_advance`) and composites glyphs, the box and the text with
Pillow's own blend, so every pixel — box, text and what lies outside the
window — is bit-equal; the tests pin that.
"""

import string

import numpy as np
import pytest

from tests import torch_parity  # noqa: F401 — one torch thread a worker

from renderer_tpu.engine import profiling as jprof
from renderer_tpu.overlay import hud as jhud
from renderer_tpu_torch.engine import profiling as tprof
from renderer_tpu_torch.overlay import hud as thud


def test_hud_draws_window():
    """The twin of tests/test_engine.py::test_hud_draws_window."""
    img = np.zeros((128, 256, 3), np.uint8)
    p = tprof.Profiler(enabled=True)
    with p.span("frame"):
        pass
    out = thud.draw_hud(img, p, ["hello"], device="cpu")
    assert out.shape == img.shape
    assert (out != 0).any(), "HUD must draw something"
    # original untouched
    assert (img == 0).all()


def _profiler(prof):
    """Fixed spans (a collapsed-free startup section and a live frame), so
    both packages print the same lines."""
    p = prof.Profiler(enabled=True)
    p.sections = {"startup": [prof.Span("load assets", 0, 0.5, 1),
                              prof.Span("compile", 1, 0.25, 1)]}
    p._spans = {
        (0, "frame"): prof.Span("frame", 0, 1.0e-3, 1),
        (1, "raster"): prof.Span("raster", 1, 0.8e-3, 1),
        (1, "post"): prof.Span("post", 1, 0.05e-3, 1),
    }
    p._order = list(p._spans)
    return p


PRINTABLE = [string.printable[:94][i:i + 24] for i in range(0, 94, 24)]
CASES = {
    # (image h, w, origin, alpha, extra lines, with the profiler)
    "spans": (140, 320, (8, 8), 0.65, ["mini sandbox"], True),
    "printable": (120, 220, (8, 8), 0.65, PRINTABLE + ["ffi fl AV To Wa yy (gjpq)"], False),
    "clipped-right-bottom": (40, 90, (30, 12), 0.65, ["a long line that leaves the image"], True),
    "clipped-left-top": (60, 200, (-20, -9), 0.3, [")xs, left of the origin"], False),
    "opaque": (64, 200, (4, 4), 1.0, ["alpha 1"], False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_draw_hud_equals_jax(case):
    h, w, origin, alpha, extra, spans = CASES[case]
    rng = np.random.default_rng(len(case))
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = jhud.draw_hud(img, _profiler(jprof) if spans else None, extra,
                         origin=origin, alpha=alpha)
    got = thud.draw_hud(img, _profiler(tprof) if spans else None, extra,
                        origin=origin, alpha=alpha, device="cpu")
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert (got != img).any(axis=-1).mean() > 0.05
    np.testing.assert_array_equal(got, want)


def test_line_coverage_equals_pillow_text():
    """Font.line_coverage of every printable character, and of pairs that
    overlap, equals Pillow's ImageDraw.text mask of the same line."""
    from PIL import Image, ImageDraw

    from renderer_tpu_torch.ui import get_font

    font = get_font()
    for line in PRINTABLE + ["xsx)s/s;x]", "ffi fl AV To Wa yy"]:
        cov = font.line_coverage(line)
        canvas = Image.new("L", (cov.shape[1] + 8, cov.shape[0] + 4), 0)
        ImageDraw.Draw(canvas).text((1, 0), line, fill=255)
        want = np.asarray(canvas)
        assert not want[cov.shape[0]:].any() and not want[:, cov.shape[1]:].any()
        np.testing.assert_array_equal(cov, want[:cov.shape[0], :cov.shape[1]], err_msg=line)
