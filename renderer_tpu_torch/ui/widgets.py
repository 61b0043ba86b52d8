"""Immediate-mode widget layer over the UI draw-list pass (Dear ImGui analog).

The reference vendors Dear ImGui and drives it from the sandbox: a
"Performance stats" window with a size/collapsed `Condition::Appearing`
state, a checkbox, separators, a tree-node span hierarchy with per-line
right-aligned colored text (examples/sandbox/src/main.rs:528-541, 769-847),
routed through `imgui.io()`'s capture flags to decide whether the camera or
the UI consumes each event (main.rs:348-349).

This module is the widget toolkit those calls need, built immediate-mode on
top of `renderer_tpu_torch.ui.DrawList` (which already renders through the
raster pipeline's blended pre-tonemap UI pass, raster/ui_stage.py):

  ctx = UiContext()                      # persistent across frames
  io.new_frame(); ui = ctx.new_frame(io, registry)
  with ui.window("Stats", size=(640, 480), collapsed=True) as visible:
      if visible:
          changed, flag = ui.checkbox("Capture", flag)
          ui.separator()
          tok = ui.tree_node("frame")
          ...
          if tok: tok.pop()
  drawlist = ui.end_frame()              # feed render_frame(..., ui=drawlist)

State model (the imgui core loop, kept minimal and deterministic for a
headless engine): widget ids are (window, id-stack, label) tuples; one
`active_id` owns the mouse while the left button is held; hover resolves
against the PREVIOUS frame's window rects front-most-first (focus order);
clicking a window raises it; each window draws into its own DrawList and
`end_frame` composites back-to-front. Windows support title-bar drag,
collapse (arrow click or title double-click), Condition semantics
("appearing" applies once, "always" every frame), and mouse-wheel scrolling.
Widgets: text / text_colored / separator / same_line(+with_pos) / button /
checkbox / slider_float / input_text / tree_node (with leaf rows) /
push_id. Outputs: io.want_capture_mouse / want_capture_keyboard /
want_text_input / mouse_cursor — the handshake the reference event loop
reads (main.rs:348-349; imgui-sdl2-support/src/lib.rs:301-361 syncs the
cursor icon from the same field).

Not modeled (scoped like SURVEY §7's "ImGui parity not literal"): window
resizing grips, docking, popups/menus, column API — nothing the reference
app uses.
"""

from __future__ import annotations

from dataclasses import dataclass

from renderer_tpu_torch.ui.draw_list import DrawList
from renderer_tpu_torch.ui.font import get_font
from renderer_tpu_torch.ui.io import UiIo

# -- style (flat theme; colors are u8 RGBA like DrawList) ----------------------

STYLE = {
    "window_bg": (20, 20, 28, 230),
    "title_bg": (35, 45, 70, 255),
    "title_bg_active": (55, 75, 120, 255),
    "text": (220, 220, 230, 255),
    "frame_bg": (42, 50, 72, 255),
    "frame_bg_hovered": (52, 64, 94, 255),
    "frame_bg_active": (62, 78, 116, 255),
    "check_mark": (120, 170, 255, 255),
    "slider_grab": (100, 140, 220, 255),
    "separator": (110, 110, 120, 255),
    "arrow": (200, 205, 215, 255),
    "window_padding": 6.0,
    "item_spacing": 4.0,
    "indent": 16.0,
    "double_click_s": 0.30,
}


class Condition:
    """imgui::Condition subset the reference uses (main.rs:534-535)."""

    ALWAYS = "always"
    APPEARING = "appearing"


def _contains(rect, p) -> bool:
    x0, y0, x1, y1 = rect
    return x0 <= p[0] < x1 and y0 <= p[1] < y1


@dataclass
class _WindowState:
    pos: tuple = (60.0, 60.0)
    size: tuple = (320.0, 240.0)
    collapsed: bool = False
    scroll_y: float = 0.0
    content_h: float = 0.0
    seen: bool = False          # Condition::Appearing latch
    last_title_click: float = -1e9


class UiContext:
    """Persistent widget state (imgui::Context analog)."""

    def __init__(self) -> None:
        self.windows: dict[str, _WindowState] = {}
        self.tree_open: dict[tuple, bool] = {}
        self.active_id: tuple | None = None
        self.active_data: dict = {}
        self.text_active: tuple | None = None
        self.text_state: dict = {}
        self.window_order: list[str] = []   # back ... front
        self._rects: dict[str, tuple] = {}  # last frame's outer rects

    def new_frame(self, io: UiIo, registry) -> "Ui":
        return Ui(self, io, registry)

    def _hovered_window(self, mouse) -> str | None:
        for title in reversed(self.window_order):
            r = self._rects.get(title)
            if r is not None and _contains(r, mouse):
                return title
        return None


def _pop_entry(stack: list, value) -> None:
    """Remove the last occurrence of `value`. Tokens pop their OWN entry so
    out-of-order pops (a push_id `with` block exiting before a tree token it
    wraps, the reference's Rust drop-order pattern at main.rs:799) stay
    balanced."""
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == value:
            del stack[i]
            return
    raise AssertionError(f"id-stack entry {value!r} already popped")


class _IdToken:
    def __init__(self, ui: "Ui", value):
        self._ui = ui
        self._value = value

    def pop(self) -> None:
        _pop_entry(self._ui._id_stack, self._value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pop()
        return False


class _TreeToken:
    """Open tree node: indents (and scopes child ids by the node's FULL id,
    not just the label — two same-named nodes under different push_id
    scopes must give their children distinct ids even though the push_id
    `with` block exits before the subtree renders) until pop()
    (imgui TreeNodeToken)."""

    def __init__(self, ui: "Ui", entry: tuple):
        self._ui = ui
        self._entry = entry
        ui._win._indent += STYLE["indent"]
        ui._id_stack.append(self._entry)

    def pop(self) -> None:
        self._ui._win._indent -= STYLE["indent"]
        _pop_entry(self._ui._id_stack, self._entry)


class _ActiveWindow:
    """Per-frame layout state of the window being built."""

    def __init__(self, title: str, state: _WindowState, dl: DrawList):
        self.title = title
        self.state = state
        self.dl = dl
        x, y = state.pos
        self.font = get_font()
        self.title_h = self.font.line_height + 6.0
        pad = STYLE["window_padding"]
        self.content_x = x + pad
        self.content_y0 = y + self.title_h + pad - state.scroll_y
        self.cursor = [self.content_x, self.content_y0]
        self.line_y = self.cursor[1]
        self.line_max_h = 0.0
        self._indent = 0.0
        self.visible = not state.collapsed

    @property
    def outer_rect(self):
        x, y = self.state.pos
        w, h = self.state.size
        if self.state.collapsed:
            return (x, y, x + w, y + self.title_h)
        return (x, y, x + w, y + h)

    @property
    def content_clip(self):
        x, y = self.state.pos
        w, h = self.state.size
        return (x, y + self.title_h, x + w, y + h)

    def item_rect(self, w: float, h: float):
        """Claim a w×h rect at the cursor and advance to the next line."""
        x = self.cursor[0] + self._indent
        y = self.cursor[1]
        if y != self.line_y:  # first item of a new line
            self.line_y = y
            self.line_max_h = h
        else:  # same_line continuation: the line grows to the tallest item
            self.line_max_h = max(self.line_max_h, h)
        self.cursor = [self.content_x,
                       self.line_y + self.line_max_h + STYLE["item_spacing"]]
        self.last_item = (x, y, x + w, y + h)
        return self.last_item


class Ui:
    """One frame of widget building (imgui::Ui analog)."""

    def __init__(self, ctx: UiContext, io: UiIo, registry) -> None:
        self._ctx = ctx
        self._io = io
        self._registry = registry
        self._font = get_font()
        self._win: _ActiveWindow | None = None
        self._window_lists: dict[str, DrawList] = {}
        self._id_stack: list = []
        self._hover_window = ctx._hovered_window(io.mouse_pos)
        self._cursor_icon = "arrow"
        self._frame_rects: dict[str, tuple] = {}
        # text-focus liveness: input_text registers its id here every frame
        # it is submitted; end_frame defocuses a field that stopped being
        # drawn (collapsed window, widget removed) — imgui's keep-alive rule
        self._text_seen: set = set()
        if not io.mouse_down["left"] and not io.mouse_released["left"]:
            # mouse is up: nothing can stay active (drag ended off-frame;
            # text focus lives in ctx.text_active, not active_id)
            ctx.active_id = None

    # -- ids --------------------------------------------------------------------

    def _id(self, label: str) -> tuple:
        return (self._win.title, tuple(self._id_stack), label)

    def push_id(self, v) -> _IdToken:
        self._id_stack.append(v)
        return _IdToken(self, v)

    # -- windows ----------------------------------------------------------------

    def window(self, title: str, *, size=None, position=None, collapsed=None,
               condition: str = Condition.APPEARING):
        """Begin a window; use as `with ui.window(...) as visible:`. The
        size/collapsed/position arguments follow imgui Condition semantics:
        APPEARING applies them only the first time the window exists
        (main.rs:533-535), ALWAYS every frame."""
        assert self._win is None, "windows do not nest"
        ctx = self._ctx
        st = ctx.windows.setdefault(title, _WindowState())
        apply = condition == Condition.ALWAYS or not st.seen
        if apply:
            if size is not None:
                st.size = (float(size[0]), float(size[1]))
            if position is not None:
                st.pos = (float(position[0]), float(position[1]))
            if collapsed is not None:
                st.collapsed = bool(collapsed)
        st.seen = True
        if title not in ctx.window_order:
            ctx.window_order.append(title)

        io = self._io
        dl = DrawList()
        self._window_lists[title] = dl
        win = _ActiveWindow(title, st, dl)
        self._win = win

        # -- interactions (before drawing so this frame reflects them) --------
        hovered_here = self._hover_window == title
        x, y = st.pos
        w, _h = st.size
        title_rect = (x, y, x + w, y + win.title_h)
        arrow_rect = (x + 2, y, x + win.title_h, y + win.title_h)
        move_id = ("window-move", title)
        if hovered_here and io.mouse_clicked["left"]:
            # raise to front (focus order)
            ctx.window_order.remove(title)
            ctx.window_order.append(title)
            if _contains(arrow_rect, io.mouse_pos):
                st.collapsed = not st.collapsed
            elif _contains(title_rect, io.mouse_pos):
                if io.time - st.last_title_click < STYLE["double_click_s"]:
                    st.collapsed = not st.collapsed  # title double-click
                else:
                    ctx.active_id = move_id
                    ctx.active_data = {
                        "grab": (io.mouse_pos[0] - x, io.mouse_pos[1] - y)}
                st.last_title_click = io.time
        if ctx.active_id == move_id:
            if io.mouse_down["left"]:
                gx, gy = ctx.active_data["grab"]
                st.pos = (io.mouse_pos[0] - gx, io.mouse_pos[1] - gy)
            else:
                ctx.active_id = None
        if hovered_here and not st.collapsed and io.mouse_wheel[1] != 0.0:
            st.scroll_y -= io.mouse_wheel[1] * 3.0 * self._font.line_height
            max_scroll = max(
                0.0, st.content_h - (st.size[1] - win.title_h
                                     - 2 * STYLE["window_padding"]))
            st.scroll_y = min(max(st.scroll_y, 0.0), max_scroll)

        # recompute layout from the (possibly moved) position
        win.__init__(title, st, dl)

        # -- draw chrome -------------------------------------------------------
        x, y = st.pos
        focused = ctx.window_order and ctx.window_order[-1] == title
        ox0, oy0, ox1, oy1 = win.outer_rect
        dl.push_clip_rect(ox0, oy0, ox1, oy1)
        tb = STYLE["title_bg_active"] if focused else STYLE["title_bg"]
        dl.add_rect_filled((x, y), (x + st.size[0], y + win.title_h), tb)
        self._collapse_arrow((x + 6, y + win.title_h / 2), st.collapsed, dl)
        dl.add_text((x + win.title_h + 2, y + 3), title, STYLE["text"],
                    self._font, self._registry)
        if not st.collapsed:
            dl.add_rect_filled((x, y + win.title_h),
                               (x + st.size[0], y + st.size[1]),
                               STYLE["window_bg"])
            cx0, cy0, cx1, cy1 = win.content_clip
            dl.push_clip_rect(cx0, cy0, cx1, cy1)
        return _WindowCM(self, win)

    def _collapse_arrow(self, center, collapsed: bool, dl: DrawList) -> None:
        cx, cy = center
        s = 4.0
        if collapsed:  # pointing right
            dl.add_triangle((cx - s, cy - s), (cx + s, cy), (cx - s, cy + s),
                            STYLE["arrow"])
        else:          # pointing down
            dl.add_triangle((cx - s, cy - s), (cx + s, cy - s), (cx, cy + s),
                            STYLE["arrow"])

    def _end_window(self, win: _ActiveWindow) -> None:
        st = win.state
        if not st.collapsed:
            # content_y0 already subtracts scroll_y, so cursor - content_y0 is
            # the scroll-INVARIANT intrinsic height (the wheel clamp depends
            # on this not growing with the current scroll)
            st.content_h = win.cursor[1] - win.content_y0
            # re-clamp EVERY frame (imgui re-clamps at Begin): collapsing a
            # big subtree shrinks content_h, and a stale scroll_y past the
            # new end would render an empty body until the next wheel event
            max_scroll = max(
                0.0, st.content_h - (st.size[1] - win.title_h
                                     - 2 * STYLE["window_padding"]))
            st.scroll_y = min(max(st.scroll_y, 0.0), max_scroll)
            win.dl.pop_clip_rect()
        win.dl.pop_clip_rect()
        self._frame_rects[win.title] = win.outer_rect
        self._win = None

    # -- frame end ---------------------------------------------------------------

    def end_frame(self) -> DrawList:
        """Composite the per-window lists back-to-front in focus order and
        publish the io outputs the event loop reads next frame."""
        assert self._win is None, "end_frame inside an open window"
        ctx, io = self._ctx, self._io
        out = DrawList()
        for title in ctx.window_order:
            dl = self._window_lists.get(title)
            if dl is not None and not dl.empty:
                out.extend(dl)
        ctx._rects = dict(self._frame_rects)
        if ctx.text_active is not None and ctx.text_active not in self._text_seen:
            # the focused field was not submitted this frame (window
            # collapsed / widget gone): defocus, or want_text_input would
            # capture the keyboard forever
            ctx.text_active = None
        over_any = any(_contains(r, io.mouse_pos)
                       for r in self._frame_rects.values())
        io.want_capture_mouse = over_any or ctx.active_id is not None
        io.want_text_input = ctx.text_active is not None
        io.want_capture_keyboard = io.want_text_input
        io.mouse_cursor = self._cursor_icon
        return out

    # -- passive widgets ----------------------------------------------------------

    def text(self, s: str) -> None:
        self.text_colored(STYLE["text"], s)

    def text_colored(self, color, s: str) -> None:
        win = self._win
        rect = win.item_rect(self._font.text_width(s), self._font.line_height)
        win.dl.add_text((rect[0], rect[1]), s, tuple(color), self._font,
                        self._registry)

    def separator(self) -> None:
        win = self._win
        x0 = win.state.pos[0] + 2
        x1 = win.state.pos[0] + win.state.size[0] - 2
        _, y, _, _ = win.item_rect(x1 - x0, 3.0)
        win.dl.add_rect_filled((x0, y + 1), (x1, y + 2), STYLE["separator"])

    def same_line(self, spacing: float | None = None) -> None:
        """Continue on the previous item's line (imgui same_line)."""
        win = self._win
        sp = STYLE["item_spacing"] if spacing is None else spacing
        win.cursor = [win.last_item[2] + sp - win._indent, win.line_y]

    def same_line_with_pos(self, pos_x: float) -> None:
        """Continue on the previous line at window-local x (the reference's
        right-aligned timing columns, main.rs:829-845)."""
        win = self._win
        win.cursor = [win.state.pos[0] + pos_x - win._indent, win.line_y]

    def calc_text_size(self, s: str):
        return (float(self._font.text_width(s)), float(self._font.line_height))

    def window_size(self):
        return self._win.state.size

    # -- interactive widgets -------------------------------------------------------

    def _item_behavior(self, wid: tuple, rect) -> tuple[bool, bool, bool]:
        """(hovered, held, clicked) for a rect: standard imgui button
        behavior — press arms the id, release inside fires."""
        io, ctx = self._io, self._ctx
        hovered = (self._hover_window == self._win.title
                   and _contains(rect, io.mouse_pos)
                   and _contains(self._win.content_clip, io.mouse_pos)
                   and ctx.active_id in (None, wid))
        if hovered and io.mouse_clicked["left"]:
            ctx.active_id = wid
            ctx.active_data = {}
        held = ctx.active_id == wid
        clicked = False
        if held and io.mouse_released["left"]:
            clicked = hovered
            ctx.active_id = None
        return hovered, held, clicked

    def _frame_color(self, hovered: bool, held: bool):
        if held:
            return STYLE["frame_bg_active"]
        return STYLE["frame_bg_hovered"] if hovered else STYLE["frame_bg"]

    def button(self, label: str) -> bool:
        win = self._win
        w = self._font.text_width(label) + 12.0
        h = self._font.line_height + 6.0
        rect = win.item_rect(w, h)
        wid = self._id(label)
        hovered, held, clicked = self._item_behavior(wid, rect)
        win.dl.add_rect_filled(rect[0:2], rect[2:4],
                               self._frame_color(hovered, held))
        win.dl.add_text((rect[0] + 6, rect[1] + 3), label, STYLE["text"],
                        self._font, self._registry)
        return clicked

    def checkbox(self, label: str, value: bool) -> tuple[bool, bool]:
        """Returns (changed, new_value) — the imgui-rs &mut bool contract
        (main.rs:537) without mutation."""
        win = self._win
        box = self._font.line_height + 2.0
        w = box + 6.0 + self._font.text_width(label)
        rect = win.item_rect(w, box)
        wid = self._id(label)
        hovered, held, clicked = self._item_behavior(wid, rect)
        bx0, by0 = rect[0], rect[1]
        win.dl.add_rect_filled((bx0, by0), (bx0 + box, by0 + box),
                               self._frame_color(hovered, held))
        if value != clicked:  # XOR: shows the post-toggle state
            pad = 3.0
            win.dl.add_rect_filled((bx0 + pad, by0 + pad),
                                   (bx0 + box - pad, by0 + box - pad),
                                   STYLE["check_mark"])
        win.dl.add_text((bx0 + box + 6, by0 + 1), label, STYLE["text"],
                        self._font, self._registry)
        return clicked, (not value) if clicked else value

    def slider_float(self, label: str, value: float, v_min: float,
                     v_max: float) -> tuple[bool, float]:
        """Horizontal slider; drag sets the value from the mouse x within the
        frame. Returns (changed, new_value), clamped to [v_min, v_max]."""
        win = self._win
        frame_w = max(win.state.size[0] * 0.5, 60.0)
        h = self._font.line_height + 4.0
        w = frame_w + 6.0 + self._font.text_width(label)
        rect = win.item_rect(w, h)
        wid = self._id(label)
        frame = (rect[0], rect[1], rect[0] + frame_w, rect[3])
        hovered, held, _ = self._item_behavior(wid, frame)
        changed = False
        if held and self._io.mouse_down["left"]:
            t = (self._io.mouse_pos[0] - frame[0]) / max(frame_w, 1e-6)
            new = v_min + (v_max - v_min) * min(max(t, 0.0), 1.0)
            changed = new != value
            value = new
        value = min(max(value, v_min), v_max)
        win.dl.add_rect_filled(frame[0:2], frame[2:4],
                               self._frame_color(hovered, held))
        t = (value - v_min) / max(v_max - v_min, 1e-12)
        gx = frame[0] + t * (frame_w - 8.0)
        win.dl.add_rect_filled((gx, frame[1] + 1), (gx + 8.0, frame[3] - 1),
                               STYLE["slider_grab"])
        vtext = f"{value:.3f}"
        win.dl.add_text((frame[0] + frame_w / 2
                         - self._font.text_width(vtext) / 2, frame[1] + 2),
                        vtext, STYLE["text"], self._font, self._registry)
        win.dl.add_text((frame[2] + 6, frame[1] + 2), label, STYLE["text"],
                        self._font, self._registry)
        return changed, value

    def input_text(self, label: str, value: str) -> tuple[bool, str]:
        """Single-line text field. Click to focus; characters arrive through
        io.add_input_character (the SDL TextInput path, lib.rs:263-266);
        Backspace/Delete/arrows/Home/End edit; Enter/Escape defocus. While
        focused, io.want_text_input and the text-input cursor icon are set —
        the fields the platform layer syncs to SDL (lib.rs:168,301-361)."""
        from renderer_tpu_torch.ui.io import Key

        win, io, ctx = self._win, self._io, self._ctx
        frame_w = max(win.state.size[0] * 0.5, 60.0)
        h = self._font.line_height + 4.0
        w = frame_w + 6.0 + self._font.text_width(label)
        rect = win.item_rect(w, h)
        wid = ("text", self._id(label))
        self._text_seen.add(wid)
        frame = (rect[0], rect[1], rect[0] + frame_w, rect[3])
        hovered = (self._hover_window == win.title
                   and _contains(frame, io.mouse_pos)
                   and _contains(win.content_clip, io.mouse_pos))
        if hovered:
            self._cursor_icon = "text_input"
        if hovered and io.mouse_clicked["left"]:
            ctx.text_active = wid
            ctx.text_state = {"cursor": len(value)}
        elif io.mouse_clicked["left"] and ctx.text_active == wid:
            ctx.text_active = None
        changed = False
        active = ctx.text_active == wid
        if active:
            cur = min(ctx.text_state.get("cursor", len(value)), len(value))
            # keys before characters: SDL delivers KeyDown ahead of TextInput
            # for the same frame (lib.rs:244-266 event order)
            if Key.BACKSPACE in io.keys_pressed and cur > 0:
                value = value[:cur - 1] + value[cur:]
                cur -= 1
                changed = True
            if Key.DELETE in io.keys_pressed and cur < len(value):
                value = value[:cur] + value[cur + 1:]
                changed = True
            if Key.LEFT_ARROW in io.keys_pressed:
                cur = max(cur - 1, 0)
            if Key.RIGHT_ARROW in io.keys_pressed:
                cur = min(cur + 1, len(value))
            if Key.HOME in io.keys_pressed:
                cur = 0
            if Key.END in io.keys_pressed:
                cur = len(value)
            # characters after keys: within one SDL frame KeyDown precedes
            # TextInput (lib.rs:244-266), so e.g. Home+"x" prepends
            for ch in io.input_characters:
                if ch >= " ":
                    value = value[:cur] + ch + value[cur:]
                    cur += 1
                    changed = True
            if (Key.ENTER in io.keys_pressed
                    or Key.KEYPAD_ENTER in io.keys_pressed
                    or Key.ESCAPE in io.keys_pressed):
                ctx.text_active = None
                active = False
            ctx.text_state["cursor"] = cur
        win.dl.add_rect_filled(
            frame[0:2], frame[2:4],
            STYLE["frame_bg_active"] if active
            else self._frame_color(hovered, False))
        win.dl.add_text((frame[0] + 4, frame[1] + 2), value, STYLE["text"],
                        self._font, self._registry)
        if active:
            cx = frame[0] + 4 + self._font.text_width(
                value[:ctx.text_state.get("cursor", len(value))])
            win.dl.add_rect_filled((cx, frame[1] + 2),
                                   (cx + 1, frame[3] - 2), STYLE["text"])
        win.dl.add_text((frame[2] + 6, frame[1] + 2), label, STYLE["text"],
                        self._font, self._registry)
        return changed, value

    def tree_node(self, label: str, *, leaf: bool = False,
                  default_open: bool = False):
        """Collapsible hierarchy row (the span tree's node type,
        main.rs:769-847). Returns a token with .pop() while the node is open
        (always for leaf=True rows, which render a bullet and no toggle),
        else None. Open state persists in the context keyed by the id stack."""
        win, io, ctx = self._win, self._io, self._ctx
        wid = self._id(label)
        arrow_w = self._font.line_height
        w = arrow_w + 2.0 + self._font.text_width(label)
        rect = win.item_rect(w, self._font.line_height)
        if leaf:
            # leaf rows are always-open nodes (imgui TreeNodeFlags::Leaf);
            # their token still scopes child ids by the full wid, but no
            # open-state is stored (it would never be read, and span names
            # vary over a session — the persistent dict must not grow
            # unboundedly)
            cx = rect[0] + arrow_w / 2
            cy = (rect[1] + rect[3]) / 2
            win.dl.add_rect_filled((cx - 2, cy - 2), (cx + 2, cy + 2),
                                   STYLE["arrow"])
            win.dl.add_text((rect[0] + arrow_w + 2, rect[1]), label,
                            STYLE["text"], self._font, self._registry)
            return _TreeToken(self, ("tree", wid))
        is_open = ctx.tree_open.setdefault(wid, default_open)
        hovered, _held, clicked = self._item_behavior(("tree", wid), rect)
        if clicked:
            is_open = not is_open
            ctx.tree_open[wid] = is_open
        cx = rect[0] + arrow_w / 2
        cy = (rect[1] + rect[3]) / 2
        self._collapse_arrow((cx, cy), not is_open, win.dl)
        win.dl.add_text((rect[0] + arrow_w + 2, rect[1]), label,
                        STYLE["text"], self._font, self._registry)
        return _TreeToken(self, ("tree", wid)) if is_open else None


class _WindowCM:
    def __init__(self, ui: Ui, win: _ActiveWindow):
        self._ui = ui
        self._win = win

    def __enter__(self) -> bool:
        return self._win.visible

    def __exit__(self, *exc):
        self._ui._end_window(self._win)
        return False
