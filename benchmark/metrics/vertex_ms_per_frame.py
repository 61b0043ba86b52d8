"""Torch ops: device ms a frame attributed to the span `vertex` (the vertex
stage and skinning), by the program's manifests."""

from benchmark import spans


def read(w, window):
    return spans.device_ms(w, "vertex")
