"""UI draw list: the host-side ImDrawList/ImDrawCmd data model.

Parity with the reference's per-frame UI mesh rebuild
(imgui_support.rs:107-169): screen-space vertices {pos px, uv, color u8x4},
u16-style triangle indices, and one command per (clip rect, texture) change —
each command is the analog of the reference's per-draw-cmd clip-rect Material
(material.rs:121-148, capacity MAX_MATERIALS ImGuiDrawCmds,
uniforms.rs:81-110). Kind 1 = alpha-from-R font texture, kind 2 = full RGBA
(imgui.frag:34-44); the kind is packed next to the texture index exactly like
the reference's `texture_index | kind << 16` trick, kept as separate arrays.
"""

from __future__ import annotations

import numpy as np

from renderer_tpu_torch.core import constants

TEX_KIND_FONT = 1
TEX_KIND_RGBA = 2

MAX_UI_COMMANDS = constants.MAX_MATERIALS  # 1000, ImGuiDrawCmd capacity


def _bucket(x: int, quantum: int = 64) -> int:
    import math

    x = max(int(x), quantum)
    return quantum * (1 << math.ceil(math.log2((x + quantum - 1) // quantum)))


class DrawList:
    """Append-only UI geometry builder. Coordinates are framebuffer pixels,
    origin top-left (the reference feeds imgui an orthographic projection of
    the same space, imgui_support.rs:158-168)."""

    def __init__(self) -> None:
        self._pos: list = []
        self._uv: list = []
        self._col: list = []
        self._tris: list = []
        self._tri_cmd: list = []
        self._cmds: list = []  # (clip_rect, tex_slot, tex_kind)
        self._clip_stack: list = [(-1.0, -1.0, 1e9, 1e9)]
        self._nv = 0

    # -- clip rects -----------------------------------------------------------

    def push_clip_rect(self, x0: float, y0: float, x1: float, y1: float) -> None:
        px0, py0, px1, py1 = self._clip_stack[-1]
        self._clip_stack.append(
            (max(x0, px0), max(y0, py0), min(x1, px1), min(y1, py1))
        )

    def pop_clip_rect(self) -> None:
        assert len(self._clip_stack) > 1
        self._clip_stack.pop()

    # -- primitives -----------------------------------------------------------

    def _cmd(self, tex_slot: int, tex_kind: int) -> int:
        key = (self._clip_stack[-1], tex_slot, tex_kind)
        if self._cmds and self._cmds[-1] == key:
            return len(self._cmds) - 1
        assert len(self._cmds) < MAX_UI_COMMANDS, "UI draw-command capacity"
        self._cmds.append(key)
        return len(self._cmds) - 1

    def add_quad(self, p0, p1, uv0, uv1, color, tex_slot: int, tex_kind: int) -> None:
        """Axis-aligned textured quad: p0=(x0,y0) top-left, p1=(x1,y1)
        bottom-right, uv likewise."""
        cmd = self._cmd(tex_slot, tex_kind)
        x0, y0 = p0
        x1, y1 = p1
        u0, v0 = uv0
        u1, v1 = uv1
        base = self._nv
        self._pos += [(x0, y0), (x1, y0), (x0, y1), (x1, y1)]
        self._uv += [(u0, v0), (u1, v0), (u0, v1), (u1, v1)]
        self._col += [color] * 4
        self._nv += 4
        self._tris += [(base, base + 1, base + 2), (base + 2, base + 1, base + 3)]
        self._tri_cmd += [cmd, cmd]

    def add_triangle(self, p0, p1, p2, color, tex_slot: int = 0,
                     tex_kind: int = TEX_KIND_RGBA, uvs=None) -> None:
        cmd = self._cmd(tex_slot, tex_kind)
        base = self._nv
        self._pos += [tuple(p0), tuple(p1), tuple(p2)]
        self._uv += list(uvs) if uvs is not None else [(0.5, 0.5)] * 3
        self._col += [color] * 3
        self._nv += 3
        self._tris.append((base, base + 1, base + 2))
        self._tri_cmd.append(cmd)

    def add_rect_filled(self, p0, p1, color, tex_slot: int = 0) -> None:
        """Solid translucent rectangle (the stats-window background). Uses
        the 1x1 white default texture slot with kind RGBA → pure vertex
        color."""
        self.add_quad(p0, p1, (0.5, 0.5), (0.5, 0.5), color, tex_slot,
                      TEX_KIND_RGBA)

    def add_text(self, pos, text: str, color, font, registry) -> None:
        """One textured quad per glyph from the font atlas (kind FONT:
        rgb = vertex color, alpha = vertex alpha · tex.r, imgui.frag:34-39)."""
        slot = font.slot(registry)
        x, y = pos
        for ch in text:
            g = font.glyphs.get(ch, font.glyphs["?"])
            if ch != " ":
                self.add_quad(
                    (x, y), (x + g.width, y + g.height),
                    (g.u0, g.v0), (g.u1, g.v1), color, slot, TEX_KIND_FONT,
                )
            x += g.advance

    def extend(self, other: "DrawList") -> None:
        """Append another DrawList's geometry after this one (painter's
        order). Used by the widget layer to composite per-window draw lists
        back-to-front in focus order — the analog of imgui sorting window
        draw data by focus order before the backend consumes it."""
        base_v = self._nv
        base_c = len(self._cmds)
        assert base_c + len(other._cmds) <= MAX_UI_COMMANDS, \
            "UI draw-command capacity"
        self._pos += other._pos
        self._uv += other._uv
        self._col += other._col
        self._nv += other._nv
        self._tris += [(a + base_v, b + base_v, c + base_v)
                       for a, b, c in other._tris]
        self._tri_cmd += [c + base_c for c in other._tri_cmd]
        self._cmds += other._cmds

    # -- packing --------------------------------------------------------------

    @property
    def empty(self) -> bool:
        return not self._tris

    def pack(self) -> dict[str, np.ndarray]:
        """Fixed-bucket numpy arrays for upload (pow2-ish buckets, so the
        upload shapes change only when the UI outgrows its bucket)."""
        nv = max(self._nv, 1)
        nt = len(self._tris)
        nc = max(len(self._cmds), 1)
        vc = _bucket(nv)
        tc = _bucket(max(nt, 1))
        cc = _bucket(nc, quantum=16)

        pos = np.zeros((vc, 2), np.float32)
        uv = np.zeros((vc, 2), np.float32)
        col = np.zeros((vc, 4), np.float32)
        if self._nv:
            pos[: self._nv] = self._pos
            uv[: self._nv] = self._uv
            col[: self._nv] = np.asarray(self._col, np.float32) / 255.0
        tris = np.zeros((tc, 3), np.int32)
        tri_cmd = np.zeros(tc, np.int32)
        if nt:
            tris[:nt] = self._tris
            tri_cmd[:nt] = self._tri_cmd
        clip = np.zeros((cc, 4), np.float32)
        tex_slot = np.zeros(cc, np.int32)
        tex_kind = np.zeros(cc, np.int32)
        for i, (rect, slot, kind) in enumerate(self._cmds):
            clip[i] = rect
            tex_slot[i] = slot
            tex_kind[i] = kind
        return {
            "pos": pos,
            "uv": uv,
            "col": col,
            "tris": tris,
            "tri_cmd": tri_cmd,
            "clip": clip,
            "tex_slot": tex_slot,
            "tex_kind": tex_kind,
            "counts": np.asarray([nt], np.int32),
        }
