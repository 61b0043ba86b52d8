"""Setup and binning kernels F1-F4 (csrc/frontend.cu, namespace rf): the
frames' front-end bytes (benchmark/work/frontend.py) at the bandwidth peak
over their device time, in percent."""

WORK = "frontend"


def read(w, window):
    return w.roofline(WORK, "rf")
