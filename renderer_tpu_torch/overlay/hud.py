"""Performance HUD — the reference's in-app ImGui stats window.

The reference renders a live collapsible span tree with µs timings and
%-of-frame coloring, split into "latest frame" and "startup" sections,
through an ImGui pass (reference: renderer/src/imgui_support.rs:107-169,
examples/sandbox/src/main.rs:769-847 span_tree + :315-319 section split).
`build_hud_drawlist` builds the same window as a renderer_tpu_torch.ui
DrawList — translucent window background (src-alpha blend), clipped to the
window rect, section headers with [-]/[+] collapse markers, per-line indent
= span depth, µs + %-of-section-root timing text tinted green→yellow→red by
the span's share of its section root (the reference's percentage coloring,
main.rs:795-818) — rendered THROUGH the raster pipeline's UI pass
(raster/ui_stage.py), exactly the reference's pass position. Collapse state
is an explicit `collapsed` set (headless engine: the caller owns input).
`draw_hud` composites the flat window onto an image on the host, for
annotating images outside a render loop, without Pillow.
"""

from __future__ import annotations

import numpy as np

from renderer_tpu_torch.engine.profiling import Profiler, Span
from renderer_tpu_torch.engine.stats import format_bytes, memory_usage

# %-of-frame text tint (the reference lerps toward red as a span's share of
# the frame grows, main.rs:795-818): quiet spans stay readable gray-green,
# heavy ones stand out.
_COL_HEADER = (160, 190, 255, 255)
_COL_TEXT = (220, 220, 230, 255)
_COL_BG = (20, 20, 28)  # draw_hud's window, blended at its alpha


def _pct_color(pct: float) -> tuple[int, int, int, int]:
    t = min(max(pct / 100.0, 0.0), 1.0)
    if t < 0.5:  # green -> yellow
        u = t / 0.5
        return (int(150 + 90 * u), int(210 + 10 * u), int(150 - 40 * u), 255)
    u = (t - 0.5) / 0.5  # yellow -> red
    return (240, int(220 - 110 * u), int(110 - 20 * u), 255)


def _section_lines(label: str, spans: list[Span], collapsed: bool,
                   out: list[tuple[str, tuple]]) -> None:
    marker = "[+]" if collapsed else "[-]"
    out.append((f"{marker} {label}", _COL_HEADER))
    if collapsed or not spans:
        return
    # section root = total of the top-level spans: the denominator of the
    # reference's %-of-frame column
    root_s = sum(s.total_s / max(s.count, 1) for s in spans if s.depth == 0)
    for s in spans:
        mean_s = s.total_s / max(s.count, 1)
        pct = 100.0 * mean_s / root_s if root_s > 0 else 0.0
        us = mean_s * 1e6
        t = f"{us / 1000:.1f} ms" if us >= 10000 else f"{us:.0f} us"
        out.append((
            f"  {'  ' * s.depth}{s.name}: {t} ({pct:.0f}%)",
            _pct_color(pct),
        ))


def hud_tree_lines(
    profiler: Profiler | None = None,
    extra_lines: list[str] | None = None,
    collapsed: set[str] | frozenset[str] = frozenset(),
    show_memory: bool = True,
    device="cuda",
) -> list[tuple[str, tuple]]:
    """The stats window as (text, rgba) lines: snapshot sections (e.g.
    'startup', Profiler.snapshot) each under a collapsible header, then the
    live spans as the 'latest frame' section, then the memory of `device`
    (the renderer's) — the reference sandbox's exact window structure
    (main.rs:769-847)."""
    lines: list[tuple[str, tuple]] = [
        (t, _COL_TEXT) for t in (extra_lines or [])
    ]
    if profiler is not None and profiler.enabled:
        for label, spans in getattr(profiler, "sections", {}).items():
            _section_lines(label, spans, label in collapsed, lines)
        live = profiler.report()
        if live:
            _section_lines("latest frame", live, "latest frame" in collapsed,
                           lines)
    if show_memory:
        u = memory_usage(device)
        lines.append((
            f"HBM: {format_bytes(u['in_use'])} (peak {format_bytes(u['peak'])})",
            _COL_TEXT,
        ))
    return lines


def hud_lines(
    profiler: Profiler | None = None,
    extra_lines: list[str] | None = None,
    device="cuda",
) -> list[str]:
    """Flat text variant (log output): the tree lines without colors."""
    return [t for t, _c in hud_tree_lines(profiler, extra_lines, device=device)]


def build_hud_drawlist(
    registry,
    profiler: Profiler | None = None,
    extra_lines: list[str] | None = None,
    *,
    origin: tuple[int, int] = (8, 8),
    alpha: float = 0.65,
    max_width: int | None = None,
    collapsed: set[str] | frozenset[str] = frozenset(),
    show_memory: bool = True,  # False = deterministic window (goldens)
    device="cuda",
):
    """The stats window as a DrawList for the in-frame UI pass: collapsible
    span-tree sections with %-of-frame tinting (see hud_tree_lines)."""
    from renderer_tpu_torch.ui import DrawList, get_font

    lines = hud_tree_lines(profiler, extra_lines, collapsed, show_memory, device)
    ui = DrawList()
    if not lines:
        return ui
    font = get_font()
    x0, y0 = origin
    line_h = font.line_height
    wmax = max(max(font.text_width(t) for t, _c in lines) + 12, 120)
    if max_width is not None:
        wmax = min(wmax, max_width - x0)
    hmax = line_h * len(lines) + 10
    ui.push_clip_rect(x0 - 4, y0 - 4, x0 + wmax, y0 + hmax)
    ui.add_rect_filled(
        (x0 - 4, y0 - 4), (x0 + wmax, y0 + hmax), (20, 20, 28, int(alpha * 255))
    )
    for i, (text, color) in enumerate(lines):
        ui.add_text((x0, y0 + i * line_h), text, color, font, registry)
    ui.pop_clip_rect()
    return ui


def _blend(dst: np.ndarray, mask, ink) -> None:
    """Pillow's ImageDraw blend of an RGBA ink onto RGB pixels, in place:
    dst = DIV255(dst * (255 - mask) + ink * mask), DIV255(a) = ((a + 128)
    + ((a + 128) >> 8)) >> 8 (libImaging's BLEND)."""
    m = np.asarray(mask, np.int32)[..., None]
    t = dst.astype(np.int32) * (255 - m) + np.asarray(ink, np.int32) * m + 128
    dst[...] = ((t >> 8) + t) >> 8


def draw_hud(
    img: np.ndarray,
    profiler: Profiler | None = None,
    extra_lines: list[str] | None = None,
    *,
    origin: tuple[int, int] = (8, 8),
    alpha: float = 0.65,
    device="cuda",
) -> np.ndarray:
    """A copy of `img` (u8 [H, W, 3]) with the stats window (hud_lines, the
    memory of `device`) composited on the host, for annotating images
    outside a render loop; the in-frame HUD is build_hud_drawlist. The
    window is the JAX package's host fallback drawn without Pillow: the same
    box (12-pixel lines, 6 pixels a character, inclusive corners) blended
    at `alpha` and the text at the font atlas's coverage
    (ui/font.Font.line_coverage), both with Pillow's blend."""
    from renderer_tpu_torch.ui import get_font

    lines = hud_lines(profiler, extra_lines, device=device)
    if not lines:
        return img
    out = np.array(img, np.uint8)
    h, w = out.shape[:2]
    x0, y0 = origin
    line_h = 12
    wmax = max(6 * max(len(line) for line in lines) + 12, 120)
    hmax = line_h * len(lines) + 10
    bx0, by0 = max(x0 - 4, 0), max(y0 - 4, 0)
    bx1, by1 = min(x0 + wmax + 1, w), min(y0 + hmax + 1, h)
    if bx0 < bx1 and by0 < by1:
        _blend(out[by0:by1, bx0:bx1], int(alpha * 255), _COL_BG)
    font = get_font()
    for i, line in enumerate(lines):
        cov = font.line_coverage(line)
        ty, tx = y0 + i * line_h, x0 - 1  # column 0 is left of the origin
        ys, xs = max(ty, 0), max(tx, 0)
        ye, xe = min(ty + cov.shape[0], h), min(tx + cov.shape[1], w)
        if ys < ye and xs < xe:
            _blend(out[ys:ye, xs:xe], cov[ys - ty:ye - ty, xs - tx:xe - tx], _COL_TEXT[:3])
    return out
