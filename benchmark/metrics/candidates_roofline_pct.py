"""Candidate kernels (csrc/candidates.cu, namespace rc): the frames' C1-C3
work (benchmark/work/candidates.py) at the chip's peaks over their device
time, in percent."""

WORK = "candidates"


def read(w, window):
    return w.roofline(WORK, "rc")
