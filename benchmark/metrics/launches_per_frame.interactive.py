"""Host issue layer: device events (kernels, copies, memsets) in the
traced window, divided by its frames."""


def read(w, window):
    return len(w.device) / w.frames if w.device else None
