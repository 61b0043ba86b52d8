"""Host issue layer: host ms a frame in the program's prologue spans
(`frame/prologue.*`: the draw sort and pack, the geometry, the blob's pack
and upload, the materials), over the traced window's frames."""

from benchmark import spans


def read(w, window):
    return spans.host_ms(w, "frame", "prologue.")
