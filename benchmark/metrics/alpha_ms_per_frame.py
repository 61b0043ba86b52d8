"""Shading kernels: device ms a frame attributed to the span `shade.alpha`
(S2, its strips and their concatenation), by the program's manifests."""

from benchmark import spans


def read(w, window):
    return spans.device_ms(w, "shade.alpha")
