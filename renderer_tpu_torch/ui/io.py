"""UI input backend: the imgui-sdl2-support platform analog.

The reference vendors an SDL2 backend platform for Dear ImGui
(imgui-sdl2-support/src/lib.rs): it translates SDL scancodes to imgui keys
(lib.rs:28-142 — including the quirk that the top-row digit keys Num1..Num0
map to the *keypad* digits, lib.rs:56-65), recomputes the four modifier keys
from the SDL keymod bitmask on every key event (handle_key_modifier,
lib.rs:145-162), forwards mouse wheel / buttons / text input
(handle_event, lib.rs:244-290), and per frame updates delta time, display
size + framebuffer scale, the want_set_mouse_pos warp, the mouse position,
and the system mouse-cursor icon (prepare_frame, lib.rs:301-361, cursor map
lib.rs:165-177).

This module is the headless equivalent: `UiIo` is the io state (imgui::Io
analog), `Platform` consumes SDL-shaped event tuples and performs the frame
preparation, and `filter_event` reproduces the multi-window event filter
(lib.rs:194-196). Events are queued and promoted at `UiIo.new_frame()` —
the same queue-then-apply model imgui uses — so widget code always sees one
consistent snapshot per frame. The event loop reads `want_capture_mouse` /
`want_capture_keyboard` before forwarding events to the game (the reference
sandbox gates its camera input on exactly these, main.rs:348-349) and the
`config_no_mouse` flag suppresses mouse events during mouse-look
(ConfigFlags::NO_MOUSE, main.rs:381,425,439).
"""

from __future__ import annotations

from dataclasses import dataclass, field


# -- keys (imgui::Key analog) -------------------------------------------------

class Key:
    """Key name constants (imgui::Key). Plain strings for readable state."""

    # letters
    A = "a"; B = "b"; C = "c"; D = "d"; E = "e"; F = "f"; G = "g"; H = "h"
    I = "i"; J = "j"; K = "k"; L = "l"; M = "m"; N = "n"; O = "o"; P = "p"
    Q = "q"; R = "r"; S = "s"; T = "t"; U = "u"; V = "v"; W = "w"; X = "x"
    Y = "y"; Z = "z"
    KEYPAD_0 = "keypad_0"; KEYPAD_1 = "keypad_1"; KEYPAD_2 = "keypad_2"
    KEYPAD_3 = "keypad_3"; KEYPAD_4 = "keypad_4"; KEYPAD_5 = "keypad_5"
    KEYPAD_6 = "keypad_6"; KEYPAD_7 = "keypad_7"; KEYPAD_8 = "keypad_8"
    KEYPAD_9 = "keypad_9"
    ENTER = "enter"; ESCAPE = "escape"; BACKSPACE = "backspace"
    TAB = "tab"; SPACE = "space"; MINUS = "minus"; EQUAL = "equal"
    LEFT_BRACKET = "left_bracket"; RIGHT_BRACKET = "right_bracket"
    BACKSLASH = "backslash"; SEMICOLON = "semicolon"
    APOSTROPHE = "apostrophe"; GRAVE_ACCENT = "grave_accent"
    COMMA = "comma"; PERIOD = "period"; SLASH = "slash"
    CAPS_LOCK = "caps_lock"
    F1 = "f1"; F2 = "f2"; F3 = "f3"; F4 = "f4"; F5 = "f5"; F6 = "f6"
    F7 = "f7"; F8 = "f8"; F9 = "f9"; F10 = "f10"; F11 = "f11"; F12 = "f12"
    PRINT_SCREEN = "print_screen"; SCROLL_LOCK = "scroll_lock"
    PAUSE = "pause"; INSERT = "insert"; HOME = "home"; PAGE_UP = "page_up"
    DELETE = "delete"; END = "end"; PAGE_DOWN = "page_down"
    RIGHT_ARROW = "right_arrow"; LEFT_ARROW = "left_arrow"
    DOWN_ARROW = "down_arrow"; UP_ARROW = "up_arrow"
    KEYPAD_DIVIDE = "keypad_divide"; KEYPAD_MULTIPLY = "keypad_multiply"
    KEYPAD_SUBTRACT = "keypad_subtract"; KEYPAD_ADD = "keypad_add"
    KEYPAD_ENTER = "keypad_enter"; KEYPAD_DECIMAL = "keypad_decimal"
    KEYPAD_EQUAL = "keypad_equal"; MENU = "menu"
    LEFT_CTRL = "left_ctrl"; LEFT_SHIFT = "left_shift"
    LEFT_ALT = "left_alt"; LEFT_SUPER = "left_super"
    RIGHT_CTRL = "right_ctrl"; RIGHT_SHIFT = "right_shift"
    RIGHT_ALT = "right_alt"; RIGHT_SUPER = "right_super"
    MOD_SHIFT = "mod_shift"; MOD_CTRL = "mod_ctrl"
    MOD_ALT = "mod_alt"; MOD_SUPER = "mod_super"


def _letters():
    return {ch.upper(): getattr(Key, ch.upper()) for ch in
            "abcdefghijklmnopqrstuvwxyz"}


#: SDL scancode name -> Key; the reference's match table (lib.rs:29-139).
#: Unknown scancodes are ignored (lib.rs:135-138). Kept quirks:
#: top-row Num1..Num0 map to Keypad1..Keypad0 (lib.rs:56-65) and Return maps
#: to Enter (lib.rs:66).
SCANCODE_MAP: dict[str, str] = {
    **_letters(),
    "Num1": Key.KEYPAD_1, "Num2": Key.KEYPAD_2, "Num3": Key.KEYPAD_3,
    "Num4": Key.KEYPAD_4, "Num5": Key.KEYPAD_5, "Num6": Key.KEYPAD_6,
    "Num7": Key.KEYPAD_7, "Num8": Key.KEYPAD_8, "Num9": Key.KEYPAD_9,
    "Num0": Key.KEYPAD_0,
    "Return": Key.ENTER, "Escape": Key.ESCAPE, "Backspace": Key.BACKSPACE,
    "Tab": Key.TAB, "Space": Key.SPACE, "Minus": Key.MINUS,
    "Equals": Key.EQUAL, "LeftBracket": Key.LEFT_BRACKET,
    "RightBracket": Key.RIGHT_BRACKET, "Backslash": Key.BACKSLASH,
    "Semicolon": Key.SEMICOLON, "Apostrophe": Key.APOSTROPHE,
    "Grave": Key.GRAVE_ACCENT, "Comma": Key.COMMA, "Period": Key.PERIOD,
    "Slash": Key.SLASH, "CapsLock": Key.CAPS_LOCK,
    "F1": Key.F1, "F2": Key.F2, "F3": Key.F3, "F4": Key.F4, "F5": Key.F5,
    "F6": Key.F6, "F7": Key.F7, "F8": Key.F8, "F9": Key.F9, "F10": Key.F10,
    "F11": Key.F11, "F12": Key.F12,
    "PrintScreen": Key.PRINT_SCREEN, "ScrollLock": Key.SCROLL_LOCK,
    "Pause": Key.PAUSE, "Insert": Key.INSERT, "Home": Key.HOME,
    "PageUp": Key.PAGE_UP, "Delete": Key.DELETE, "End": Key.END,
    "PageDown": Key.PAGE_DOWN,
    "Right": Key.RIGHT_ARROW, "Left": Key.LEFT_ARROW,
    "Down": Key.DOWN_ARROW, "Up": Key.UP_ARROW,
    "KpDivide": Key.KEYPAD_DIVIDE, "KpMultiply": Key.KEYPAD_MULTIPLY,
    "KpMinus": Key.KEYPAD_SUBTRACT, "KpPlus": Key.KEYPAD_ADD,
    "KpEnter": Key.KEYPAD_ENTER,
    "Kp1": Key.KEYPAD_1, "Kp2": Key.KEYPAD_2, "Kp3": Key.KEYPAD_3,
    "Kp4": Key.KEYPAD_4, "Kp5": Key.KEYPAD_5, "Kp6": Key.KEYPAD_6,
    "Kp7": Key.KEYPAD_7, "Kp8": Key.KEYPAD_8, "Kp9": Key.KEYPAD_9,
    "Kp0": Key.KEYPAD_0, "KpPeriod": Key.KEYPAD_DECIMAL,
    "Application": Key.MENU, "KpEquals": Key.KEYPAD_EQUAL, "Menu": Key.MENU,
    "LCtrl": Key.LEFT_CTRL, "LShift": Key.LEFT_SHIFT, "LAlt": Key.LEFT_ALT,
    "LGui": Key.LEFT_SUPER, "RCtrl": Key.RIGHT_CTRL,
    "RShift": Key.RIGHT_SHIFT, "RAlt": Key.RIGHT_ALT,
    "RGui": Key.RIGHT_SUPER,
}

MOUSE_BUTTONS = ("left", "right", "middle", "x1", "x2")

#: imgui::MouseCursor -> SDL SystemCursor (lib.rs:165-177). The widget layer
#: sets UiIo.mouse_cursor to one of the keys; a windowing host maps it to the
#: native cursor via this table.
CURSOR_TO_SYSTEM: dict[str, str] = {
    "arrow": "Arrow",
    "text_input": "IBeam",
    "resize_all": "SizeAll",
    "resize_ns": "SizeNS",
    "resize_ew": "SizeWE",
    "resize_nesw": "SizeNESW",
    "resize_nwse": "SizeNWSE",
    "hand": "Hand",
    "not_allowed": "No",
}


def filter_event(window_id: int, event: tuple) -> bool:
    """True if the event belongs to `window_id` (lib.rs:194-196). Events that
    carry no window id (last element not an int tagged dict) pass through.
    Event tuples may append a {'window_id': N} dict as their last element."""
    if event and isinstance(event[-1], dict):
        wid = event[-1].get("window_id")
        return wid is None or wid == window_id
    return True


# -- io state (imgui::Io analog) ----------------------------------------------

@dataclass
class UiIo:
    """Input/output state shared between the event loop and the widgets.

    Events queue via add_*_event and are promoted to the per-frame snapshot
    by `new_frame()`. Outputs (want_capture_*, mouse_cursor) are written by
    the widget layer at the end of its frame and read by the event loop
    before the next batch of events — the reference's exact handshake
    (main.rs:348-349 reads io().want_capture_mouse before event routing)."""

    display_size: tuple[float, float] = (0.0, 0.0)
    display_framebuffer_scale: tuple[float, float] = (1.0, 1.0)
    mouse_pos: tuple[float, float] = (-1.0, -1.0)
    delta_time: float = 1.0 / 60.0
    time: float = 0.0

    # config flags
    config_no_mouse: bool = False        # ConfigFlags::NO_MOUSE (mouse-look)
    config_no_cursor_change: bool = False  # ConfigFlags::NO_MOUSE_CURSOR_CHANGE
    mouse_draw_cursor: bool = False

    # outputs (written by the widget layer)
    want_capture_mouse: bool = False
    want_capture_keyboard: bool = False
    want_text_input: bool = False
    want_set_mouse_pos: bool = False
    mouse_cursor: str | None = "arrow"   # None = hide (lib.rs:355-358)

    # current-frame snapshot (promoted at new_frame)
    mouse_down: dict = field(default_factory=lambda: dict.fromkeys(
        MOUSE_BUTTONS, False))
    mouse_clicked: dict = field(default_factory=lambda: dict.fromkeys(
        MOUSE_BUTTONS, False))
    mouse_released: dict = field(default_factory=lambda: dict.fromkeys(
        MOUSE_BUTTONS, False))
    mouse_wheel: tuple[float, float] = (0.0, 0.0)
    keys_down: dict = field(default_factory=dict)
    keys_pressed: set = field(default_factory=set)
    keys_released: set = field(default_factory=set)
    input_characters: list = field(default_factory=list)

    def __post_init__(self):
        self._pending: list[tuple] = []

    # -- event intake (imgui's add_*_event queue) ------------------------------

    def add_key_event(self, key: str, pressed: bool) -> None:
        self._pending.append(("key", key, pressed))

    def add_mouse_button_event(self, button: str, pressed: bool) -> None:
        if self.config_no_mouse:
            return
        if button not in MOUSE_BUTTONS:
            return  # unmapped buttons (6+-button mice) are dropped, like
            # the reference backend's non-exhaustive match (lib.rs:244-290)
        self._pending.append(("mouse_button", button, pressed))

    def add_mouse_wheel_event(self, dx: float, dy: float) -> None:
        if self.config_no_mouse:
            return
        self._pending.append(("wheel", float(dx), float(dy)))

    def add_mouse_pos_event(self, x: float, y: float) -> None:
        if self.config_no_mouse:
            return
        self._pending.append(("mouse_pos", float(x), float(y)))

    def add_input_character(self, ch: str) -> None:
        self._pending.append(("char", ch))

    def update_delta_time(self, dt: float) -> None:
        self.delta_time = max(float(dt), 0.0)

    # -- frame boundary ---------------------------------------------------------

    def key_down(self, key: str) -> bool:
        return self.keys_down.get(key, False)

    def new_frame(self) -> None:
        """Promote queued events into the per-frame snapshot and clear the
        previous frame's transitions."""
        self.mouse_clicked = dict.fromkeys(MOUSE_BUTTONS, False)
        self.mouse_released = dict.fromkeys(MOUSE_BUTTONS, False)
        self.mouse_wheel = (0.0, 0.0)
        self.keys_pressed = set()
        self.keys_released = set()
        self.input_characters = []
        wx, wy = 0.0, 0.0
        for ev in self._pending:
            kind = ev[0]
            if kind == "key":
                _, key, pressed = ev
                was = self.keys_down.get(key, False)
                self.keys_down[key] = pressed
                if pressed:
                    # EVERY key_down event is a press — SDL delivers key
                    # repeat as repeated KeyDown while the key is held, and
                    # the reference forwards them (lib.rs:244-266), so held
                    # Backspace/arrows must keep editing like held
                    # printable keys keep arriving via TextInput
                    self.keys_pressed.add(key)
                if was and not pressed:
                    self.keys_released.add(key)
            elif kind == "mouse_button":
                _, btn, pressed = ev
                if pressed and not self.mouse_down[btn]:
                    self.mouse_clicked[btn] = True
                if self.mouse_down[btn] and not pressed:
                    self.mouse_released[btn] = True
                self.mouse_down[btn] = pressed
            elif kind == "wheel":
                wx += ev[1]
                wy += ev[2]
            elif kind == "mouse_pos":
                self.mouse_pos = (ev[1], ev[2])
            elif kind == "char":
                self.input_characters.append(ev[1])
        self.mouse_wheel = (wx, wy)
        self._pending = []
        self.time += self.delta_time


# -- platform (SdlPlatform analog) ---------------------------------------------

class Platform:
    """Headless SdlPlatform (lib.rs:208-361): routes SDL-shaped event tuples
    into a UiIo and performs the per-frame preparation. Event tuples:

      ("key_down"|"key_up", scancode, mods)   mods ⊆ {"shift","ctrl","alt","super"}
      ("mouse_button_down"|"mouse_button_up", button)
      ("mouse_wheel", x, y)
      ("mouse_motion", x, y)
      ("text_input", text)

    each optionally followed by a {"window_id": N} dict (see filter_event)."""

    def __init__(self) -> None:
        self._last_time: float | None = None
        self._cursor: str | None = None  # cached cursor (lib.rs:209 comment)

    def handle_event(self, io: UiIo, event: tuple) -> bool:
        """Returns True when the event updated imgui state (lib.rs:244-290)."""
        kind = event[0]
        if kind == "mouse_wheel":
            io.add_mouse_wheel_event(event[1], event[2])
            return True
        if kind == "mouse_button_down":
            io.add_mouse_button_event(event[1], True)
            return True
        if kind == "mouse_button_up":
            io.add_mouse_button_event(event[1], False)
            return True
        if kind == "mouse_motion":
            io.add_mouse_pos_event(event[1], event[2])
            return True
        if kind == "text_input":
            for ch in event[1]:
                io.add_input_character(ch)
            return True
        if kind in ("key_down", "key_up"):
            pressed = kind == "key_down"
            mods = set(event[2]) if len(event) > 2 and not isinstance(
                event[2], dict) else set()
            # modifiers recomputed from the keymod mask on EVERY key event
            # (handle_key_modifier, lib.rs:145-162)
            io.add_key_event(Key.MOD_SHIFT, "shift" in mods)
            io.add_key_event(Key.MOD_CTRL, "ctrl" in mods)
            io.add_key_event(Key.MOD_ALT, "alt" in mods)
            io.add_key_event(Key.MOD_SUPER, "super" in mods)
            key = SCANCODE_MAP.get(event[1])
            if key is not None:  # unknown scancodes ignored (lib.rs:135-138)
                io.add_key_event(key, pressed)
            return True
        return False

    def prepare_frame(
        self,
        io: UiIo,
        *,
        window_size: tuple[float, float],
        drawable_size: tuple[float, float] | None = None,
        mouse_pos: tuple[float, float] | None = None,
        now: float | None = None,
    ) -> dict:
        """Per-frame preparation (lib.rs:301-361): delta time, display size +
        framebuffer scale, the want_set_mouse_pos warp, mouse position, and
        the system-cursor icon. Returns the host actions a windowing backend
        would perform: {"warp_mouse_to": (x,y)|None,
        "system_cursor": SDL name|None (None = hide)}."""
        if now is not None:
            if self._last_time is not None:
                io.update_delta_time(now - self._last_time)
            self._last_time = now
        dw, dh = drawable_size if drawable_size is not None else window_size
        io.display_size = (float(window_size[0]), float(window_size[1]))
        io.display_framebuffer_scale = (
            dw / max(window_size[0], 1.0), dh / max(window_size[1], 1.0))

        warp = None
        if io.want_set_mouse_pos:
            warp = io.mouse_pos  # warp_mouse_in_window (lib.rs:329-332)
            io.want_set_mouse_pos = False
        elif mouse_pos is not None:
            io.add_mouse_pos_event(*mouse_pos)

        system_cursor: str | None = None
        if not io.config_no_cursor_change:
            if io.mouse_cursor is not None and not io.mouse_draw_cursor:
                system_cursor = CURSOR_TO_SYSTEM[io.mouse_cursor]
                self._cursor = system_cursor
            else:
                self._cursor = None  # hide (lib.rs:355-358)
        return {"warp_mouse_to": warp, "system_cursor": self._cursor}
