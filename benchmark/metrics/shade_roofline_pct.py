"""Shading kernels (csrc/shade.cu, namespace rs): the frames' S1 and S2
work (benchmark/work/shade.py) at the chip's peaks over their device time,
in percent."""

WORK = "shade"


def read(w, window):
    return w.roofline(WORK, "rs")
