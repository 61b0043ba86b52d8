"""Shading kernels: device ms a frame attributed to the spans `shade.solid`
and `shade.blended` (S1, its strips and their concatenation), by the
program's manifests."""

from benchmark import spans


def read(w, window):
    return spans.device_ms(w, "shade.solid", "shade.blended")
