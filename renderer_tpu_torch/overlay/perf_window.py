"""The sandbox "Performance stats" window, built with real widgets.

Port of the reference's interactive perf UI: the window itself
(examples/sandbox/src/main.rs:533-541 — size [640,480] Condition::Appearing,
collapsed(true, Appearing), a "Capture timings every frame" checkbox,
separators, one span tree for the latest frame and one for startup) and the
span-tree renderer (main.rs:769-847 — tree nodes per span with a stack of
open tokens, push_id per duplicate name, the %-of-root text right-aligned at
window_width - width - 50 with green→red tinting, and the µs/ms timing text
right-aligned at window_width - width - 150).

`build_hud_drawlist` (overlay/hud.py) remains the zero-state flat HUD; this
module is the interactive variant driven through
renderer_tpu_torch.ui.widgets + renderer_tpu_torch.ui.io — collapsible
nodes, a working checkbox, window drag and scroll — rendered through the
same in-frame UI pass.
"""

from __future__ import annotations

from renderer_tpu_torch.overlay.hud import _pct_color
from renderer_tpu_torch.ui.widgets import Condition, Ui


def _mean_s(span) -> float:
    return span.total_s / max(span.count, 1)


def span_tree(ui: Ui, spans) -> None:
    """Render a flat depth-annotated span list as a collapsible tree
    (main.rs:769-847). `spans` is profiling.Span objects (name, depth,
    total_s, count).

    Matches the reference's semantics: the %-column denominator is the FIRST
    span's duration (main.rs:826-827), name counts for duplicate-name ids are
    scoped per open parent (name_counts Vec<HashMap>, main.rs:776-799),
    root-level rows default open (default_open(tree_nodes.is_empty()),
    main.rs:805), closed nodes skip their whole subtree (main.rs:815-823),
    and timings print in µs only (fmt_ms, main.rs:770-772)."""
    spans = list(spans)
    if not spans:
        return
    root_s = _mean_s(spans[0])
    open_stack: list = []    # (span, token) for open nodes (tree_nodes)
    count_stack: list[dict] = [{}]  # per-parent duplicate-name counts
    i = 0
    while i < len(spans):
        s = spans[i]
        while open_stack and open_stack[-1][0].depth >= s.depth:
            _sp, tok = open_stack.pop()
            count_stack.pop()
            tok.pop()
        counts = count_stack[-1]
        n = counts.get(s.name, 0) + 1
        counts[s.name] = n
        has_children = i + 1 < len(spans) and spans[i + 1].depth > s.depth
        # duplicate names stay distinct ids (ui.push_id_int, main.rs:799)
        with ui.push_id(n):
            tok = ui.tree_node(s.name, leaf=not has_children,
                               default_open=not open_stack)
        mean = _mean_s(s)
        pct = 100.0 * mean / root_s if root_s > 0 else 0.0
        pct_text = f"{pct:.1f} %"
        window_width = ui.window_size()[0]
        pct_w = ui.calc_text_size(pct_text)[0]
        ui.same_line_with_pos(window_width - pct_w - 50.0)
        ui.text_colored(_pct_color(pct), pct_text)
        timing_text = f"{mean * 1e6:.0f} us"
        timing_w = ui.calc_text_size(timing_text)[0]
        ui.same_line_with_pos(window_width - timing_w - 150.0)
        ui.text(timing_text)
        if tok is not None:
            open_stack.append((s, tok))
            count_stack.append({})
            i += 1
        else:
            i += 1
            while i < len(spans) and spans[i].depth > s.depth:
                i += 1
    while open_stack:
        _sp, tok = open_stack.pop()
        count_stack.pop()
        tok.pop()


def performance_stats_window(
    ui: Ui,
    capture_every_frame: bool,
    frame_spans,
    startup_spans,
) -> bool:
    """The reference sandbox's perf window (main.rs:533-541). Returns the
    (possibly toggled) capture flag."""
    with ui.window("Performance stats", size=(640.0, 480.0),
                   collapsed=True, condition=Condition.APPEARING) as visible:
        if visible:
            _changed, capture_every_frame = ui.checkbox(
                "Capture timings every frame", capture_every_frame)
            ui.separator()
            span_tree(ui, frame_spans)
            ui.separator()
            span_tree(ui, startup_spans)
    return capture_every_frame
