"""The port's UI pass against the JAX package's, on the CPU.

Tolerances and why:
- DrawList, widgets, HUD and font: exactly equal. They are the same host
  arithmetic in the same order, and the port's font atlas is a committed
  copy of the JAX package's rasterization.
- triangle_setup(double_sided=True): ≤ 4 ULP of each value's own magnitude,
  as the scene setup's parity test (the same elementwise IEEE ops);
  bin_triangles fed the JAX setup output: exactly equal.
- rasterize_ui: layer tids and aux exactly equal (the plain K2 against the
  Pallas kernel in interpret mode on the same planes).
- shade_ui_layer: rgb within 1e-6. Alpha within 2^-16, and within 1e-6 on
  all but 2% of the shaded pixels: XLA's batched dot rounds the 3-term uv
  contraction differently from any fixed summation order (in a probe
  14-37% of its results differed in the last bit from each of the six
  orders, with and without FMA), and the font's bilinear tap multiplies a
  1-ULP uv difference (≤ 2^-24) by the 176-texel atlas width and a
  coverage step of up to 1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import renderer_tpu as jrt
import renderer_tpu.ui as jui
from renderer_tpu.engine import profiling as jprof
from renderer_tpu.overlay import hud as jhud
from renderer_tpu.overlay import perf_window as jpw
from renderer_tpu.raster import binning as jbin
from renderer_tpu.raster import setup as jsetup
from renderer_tpu.raster import ui_stage as jstage
import renderer_tpu_torch as trt
import renderer_tpu_torch.ui as tui
from renderer_tpu_torch.assets import demo_scenes
from renderer_tpu_torch.engine import profiling as tprof
from renderer_tpu_torch.interop import from_numpy_arrays
from renderer_tpu_torch.overlay import perf_window as tpw
from renderer_tpu_torch.raster import binning as tbin
from renderer_tpu_torch.raster import setup as tsetup
from renderer_tpu_torch.raster import ui_stage as tstage
from renderer_tpu_torch.raster.pipeline import STANDARD_SAMPLE_POSITIONS
from tests.test_sandbox_golden import _perf_window_drawlist
from tests.torch_bins import ui_drawlist
from tests.torch_parity import W, H


def _assert_packs_equal(a: dict, b: dict, what=""):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (what, k)
        assert a[k].tobytes() == b[k].tobytes(), (what, k)


# -- widgets: scripted SDL-shaped events through both packages ---------------

def _click(x, y):
    return [("mouse_motion", x, y), ("mouse_button_down", "left"),
            ("mouse_button_up", "left")]


# per case: the events of each frame (frame 0 builds the windows so hover
# has last frame's rects to resolve against)
SCRIPTS = {
    "window-drag": [[], [("mouse_motion", 40, 15), ("mouse_button_down", "left")],
                    [("mouse_motion", 90, 52)], [("mouse_button_up", "left")], []],
    "collapse": [[], _click(16, 20), [], _click(16, 20)],
    "scroll": [[], [("mouse_motion", 60, 60), ("mouse_wheel", 0, -1)],
               [("mouse_wheel", 0, -2)], [("mouse_wheel", 0, 1)]],
    "button": [[], [("mouse_motion", 20, 40), ("mouse_button_down", "left")],
               [("mouse_button_up", "left")], _click(20, 40)],
    "checkbox": [[], _click(20, 40), [], _click(20, 40)],
    "slider": [[], [("mouse_motion", 30, 40), ("mouse_button_down", "left")],
               [("mouse_motion", 95, 41)], [("mouse_button_up", "left")]],
    "input-text": [[], _click(30, 40),
                   [("text_input", "hello"), ("key_down", "Backspace", [])],
                   [("key_down", "Left", []), ("key_down", "Home", []),
                    ("text_input", "X")],
                   [("key_down", "Return", [])]],
    "tree-node": [[], _click(24, 42), _click(40, 78), [], _click(24, 42)],
    "perf-window": [[], _click(66, 70), _click(70, 90), [], _click(70, 118),
                    [("mouse_motion", 300, 300), ("mouse_wheel", 0, -1)]],
}


class _Pkg:
    def __init__(self, ui_mod, pw, prof, root):
        self.ui, self.pw, self.prof, self.root = ui_mod, pw, prof, root


JAX = _Pkg(jui, jpw, jprof, jrt)
PORT = _Pkg(tui, tpw, tprof, trt)


def _build(pkg, case, ui, state):
    """One frame of `case`'s widgets; returns what the widgets returned."""
    if case == "perf-window":
        s = pkg.prof.Span
        frame = [s("frame", 0, 2.0e-3, 1), s("raster", 1, 1.5e-3, 1),
                 s("bins", 2, 0.2e-3, 1), s("post", 1, 0.1e-3, 1)]
        startup = [s("load", 0, 0.5, 1), s("atlas", 1, 0.1, 1)]
        state["v"] = pkg.pw.performance_stats_window(ui, state.get("v", False),
                                                     frame, startup)
        return [state["v"]]
    out = []
    size = (220.0, 100.0 if case == "scroll" else 160.0)
    with ui.window("W", size=size, position=(10.0, 10.0)) as visible:
        if visible:
            if case == "button":
                out.append(ui.button("Press me"))
            elif case == "checkbox":
                out.append(ui.checkbox("Check", state.get("v", False)))
                state["v"] = out[-1][1]
            elif case == "slider":
                out.append(ui.slider_float("Slide", state.get("v", 0.25), 0.0, 1.0))
                state["v"] = out[-1][1]
            elif case == "input-text":
                out.append(ui.input_text("Name", state.get("v", "ab")))
                state["v"] = out[-1][1]
            elif case == "tree-node":
                tok = ui.tree_node("root")
                out.append(tok is not None)
                if tok is not None:
                    ui.tree_node("leaf", leaf=True).pop()
                    with ui.push_id(2):
                        sub = ui.tree_node("sub")
                    out.append(sub is not None)
                    if sub is not None:
                        ui.text_colored((240, 120, 90, 255), "inside")
                        sub.pop()
                    tok.pop()
            else:
                for i in range(30 if case == "scroll" else 3):
                    ui.text(f"line {i}")
                    ui.same_line()
                    ui.text_colored((200, 120, 60, 255), f"{i * 7} us")
            ui.separator()
    return out


def _run_script(pkg, case):
    ctx, io, platform = pkg.ui.UiContext(), pkg.ui.UiIo(), pkg.ui.Platform()
    registry = pkg.root.MaterialRegistry()
    state, frames = {}, []
    for events in SCRIPTS[case]:
        for ev in events:
            platform.handle_event(io, ev)
        io.new_frame()
        ui = ctx.new_frame(io, registry)
        result = _build(pkg, case, ui, state)
        dl = ui.end_frame()
        frames.append((dl.pack(), result, io.want_capture_mouse,
                       io.want_capture_keyboard, io.want_text_input,
                       io.mouse_cursor,
                       {t: (w.pos, w.size, w.collapsed, w.scroll_y)
                        for t, w in ctx.windows.items()}))
    return frames


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_widgets_and_drawlist_equal(case):
    got, want = _run_script(PORT, case), _run_script(JAX, case)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_packs_equal(g[0], w[0], f"{case} frame {i}")
        assert g[1:] == w[1:], (case, i)
    # the script did something: the last frame differs from the first
    assert any(got[0][0][k].tobytes() != got[-1][0][k].tobytes()
               for k in got[0][0]) or got[0][1:] != got[-1][1:]


# -- font and HUD -------------------------------------------------------------

def test_font_atlas_equals_the_jax_font():
    pytest.importorskip("PIL")
    from renderer_tpu.ui.font import get_font as jax_font
    from renderer_tpu_torch.ui.font import get_font as port_font

    a, b = jax_font(), port_font()
    assert a._rgba.shape == (84, 176, 4) and a._rgba.dtype == np.uint8
    assert np.array_equal(a._rgba, b._rgba)
    assert a.line_height == b.line_height == 14
    assert len(a.glyphs) == len(b.glyphs) == 95
    for ch, g in a.glyphs.items():
        assert vars(g) == vars(b.glyphs[ch]), ch


def test_missing_font_atlas_raises(tmp_path):
    from renderer_tpu_torch.ui.font import Font

    with pytest.raises(FileNotFoundError):
        Font(tmp_path / "no_atlas.npz")


def _jax_hud(registry):
    """The golden's HUD, built with the JAX package (test_sandbox_golden)."""
    prof = jprof.Profiler(enabled=True)
    prof.sections = {"startup": [jprof.Span("load", 0, 0.5, 1)]}
    prof._spans = {
        (0, "frame"): jprof.Span("frame", 0, 1.0e-3, 1),
        (1, "raster"): jprof.Span("raster", 1, 0.8e-3, 1),
        (1, "post"): jprof.Span("post", 1, 0.05e-3, 1),
    }
    prof._order = list(prof._spans)
    return jhud.build_hud_drawlist(registry, prof, ["mini sandbox"],
                                   collapsed={"startup"}, max_width=W,
                                   show_memory=False)


@pytest.mark.parametrize("kind", ["hud", "perfwin"])
def test_sandbox_overlays_equal(kind):
    """The golden's HUD (build_hud_drawlist with its deterministic spans)
    and its two-frame "Performance stats" window."""
    jreg = jrt.MaterialRegistry()
    want = _jax_hud(jreg) if kind == "hud" else _perf_window_drawlist(jreg)
    got = demo_scenes.mini_sandbox_ui(trt.MaterialRegistry(), kind)
    _assert_packs_equal(got.pack(), want.pack(), kind)
    assert not got.empty


def test_hud_memory_line_reads_the_renderers_device():
    from renderer_tpu_torch.overlay.hud import hud_lines

    assert hud_lines(None, ["x"], device="cpu")[-1] == "HBM: 0 B (peak 0 B)"
    assert trt.memory_usage("cpu") == {"in_use": 0, "peak": 0, "limit": 0}
    assert trt.format_bytes(3 << 20) == "3.00 MiB"
    assert trt.format_bytes(1000) == "1000 B"


# -- setup and binning --------------------------------------------------------

def _mixed_winding_clip(n=600, seed=3):
    """Screen-space-sized triangles of both windings (half of them with v1
    and v2 swapped), z = 0.5, w = 1 — the UI pass's clip positions."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1.1, 1.1, size=(n, 1, 2))
    spread = rng.uniform(0.002, 0.4, size=(n, 1, 1))
    xy = centers + spread * rng.normal(size=(n, 3, 2))
    xy[::2] = xy[::2, [0, 2, 1]]
    clip = np.concatenate([xy, np.full((n, 3, 1), 0.5), np.ones((n, 3, 1))], -1)
    return clip.reshape(-1, 4).astype(np.float32)


def test_double_sided_setup_and_bin_triangles():
    clip = _mixed_winding_clip()
    n = clip.shape[0] // 3
    tri_v = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    for pad in (0.0, 0.5):
        jt = jsetup.triangle_setup(jnp.asarray(clip), jnp.asarray(tri_v), n - 7,
                                   W, H, bbox_pad=pad, double_sided=True)
        tt = tsetup.triangle_setup(torch.from_numpy(clip), torch.from_numpy(tri_v),
                                   torch.tensor(n - 7, dtype=torch.int32), W, H,
                                   bbox_pad=pad, double_sided=True)
        a, b = np.array(jt), tt.numpy()
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
        assert np.all(np.abs(a.astype(np.float64) - b) <= 4 * ulp.astype(np.float64))
        # both windings survive: double-sided setup culls nothing for facing
        valid = a[jsetup.VALID_ROW] > 0
        assert valid[0::2].sum() > 0.8 * valid[1::2].sum() > 0
        one_sided = np.asarray(jsetup.triangle_setup(
            jnp.asarray(clip), jnp.asarray(tri_v), n - 7, W, H, bbox_pad=pad))
        assert (one_sided[jsetup.VALID_ROW] > 0).sum() < valid.sum()
        kw = dict(tiles_x=2, tiles_y=3, tile_w=128, tile_h=32, pair_capacity=1 << 11)
        for lo, hi in ((0, None), (5, n - 40)):
            jb = jbin.bin_triangles(jt, lo, hi, **kw)
            tb = tbin.bin_triangles(torch.from_numpy(a), lo, hi, **kw)
            for name, x, y in zip(("binned", "starts", "counts", "overflow"), jb, tb):
                x, y = np.asarray(x), y.numpy()
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name
        # overflow folds the row truncation in
        small = dict(kw, pair_capacity=64, row_capacity=32)
        jo = jbin.bin_triangles(jt, **small)[3]
        to = tbin.bin_triangles(torch.from_numpy(a), **small)[3]
        assert int(jo) == int(to) > 0


# -- the UI stage: rasterize_ui + shade_ui_layer ------------------------------

@pytest.fixture(scope="module")
def hud_case():
    """The golden's HUD plus a stack of 12 quads over it (deeper than
    ui_layers), packed, with the registry's materials as numpy."""
    registry = jrt.MaterialRegistry()
    dl = _jax_hud(registry)
    stack, _ = ui_drawlist("deep-stack")
    dl.extend(stack)
    packed = dl.pack()
    cfg = jrt.RenderConfig(width=W, height=H, msaa_samples=4, ui_layers=4)
    mats = {k: np.asarray(v) for k, v in
            jrt.Renderer(registry, cfg)._materials().items()}
    return packed, mats


@pytest.mark.parametrize("ui_msaa", [False, True])
def test_ui_stage(hud_case, ui_msaa):
    packed, mats = hud_case
    jcfg = jrt.RenderConfig(width=W, height=H, msaa_samples=4, ui_layers=4,
                            ui_msaa=ui_msaa)
    tcfg = trt.RenderConfig(width=W, height=H, msaa_samples=4, ui_layers=4,
                            ui_msaa=ui_msaa)
    spos = STANDARD_SAMPLE_POSITIONS[4 if ui_msaa else 1]
    jui_d = {k: jnp.asarray(v) for k, v in packed.items()}
    tui_d = from_numpy_arrays(packed, device="cpu")
    kw = dict(local_tiles_y=jcfg.tiles_y, tile_row_offset=0, sample_positions=spos)
    jlt, jov, jaux = jstage.rasterize_ui(jui_d, config=jcfg, interpret=True, **kw)
    tlt, tov, taux = tstage.rasterize_ui(tui_d, config=tcfg, **kw)
    assert np.array_equal(np.asarray(jlt), tlt.numpy())
    assert np.array_equal(np.asarray(jaux), taux.numpy())
    assert int(jov) == int(tov) == 0
    # deeper than ui_layers somewhere: saturation and demand are exercised
    assert int(taux.max()) > tcfg.ui_layers
    row0 = np.zeros((jcfg.padded_height, 1), np.float32)
    lt = jlt if ui_msaa else jlt[0]
    jrgb, ja = jstage.shade_ui_layer(lt, jui_d, {k: jnp.asarray(v) for k, v in mats.items()},
                                     config=jcfg, row0=jnp.asarray(row0))
    trgb, ta = tstage.shade_ui_layer(tlt if ui_msaa else tlt[0], tui_d,
                                     from_numpy_arrays(mats, device="cpu"),
                                     config=tcfg, row0=torch.from_numpy(row0))
    assert np.abs(np.asarray(jrgb) - trgb.numpy()).max() <= 1e-6
    ja, ta = np.asarray(ja), ta.numpy()
    err = np.abs(ja - ta)
    live = (ja > 0) | (ta > 0)
    assert err.max() <= 2.0**-16
    assert (err[live] <= 1e-6).mean() >= 0.98
    assert live.sum() > 1000 and ta.max() > 0.5  # glyphs and quads shaded


# -- a whole frame with the "Performance stats" window ------------------------

def test_perf_window_frame_golden_and_stats_match_jax():
    """The mini-sandbox with its "Performance stats" window through the
    port's Renderer on the CPU: within the golden tolerance of
    sandbox-golden.npz's key, 0 overflow, and the stats vector equal to the
    JAX renderer's on the same scene and UI (test_sandbox_golden._render)."""
    from tests.test_sandbox_golden import _render
    from tests.test_torch_skin import assert_sandbox_golden

    sandbox = demo_scenes.mini_sandbox_scene(0.4)
    ui = demo_scenes.mini_sandbox_ui(sandbox.registry, "perfwin")
    r = trt.Renderer(sandbox.registry, trt.RenderConfig(width=W, height=H,
                                                        msaa_samples=4),
                     device="cpu")
    img = r.render_frame(sandbox.scene, 0, ui=ui)
    stats = r.frame_stats()
    assert_sandbox_golden(img, stats, "mini-sandbox-perfwin")
    assert stats["ui_demand_max"] >= 2
    _jimg, jstats = _render(perf_window=True)
    assert stats == jstats
