"""Host issue layer: the harness's host clock around each window frame's
re-queue and `Renderer.render_frame_device` call, summed over the window's
frames and divided by their number, in ms."""


def read(w, window):
    return 1e3 * sum(w.host_s) / len(w.host_s) if w.host_s else None
