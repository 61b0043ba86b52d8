"""Host issue layer: host ms a frame in the program's span
`frame/pipeline` (issuing the frame's device work), over the traced
window's frames."""

from benchmark import spans


def read(w, window):
    return spans.host_ms(w, "frame", "pipeline")
