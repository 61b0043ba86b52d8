"""Raster kernels K1 and K2 (csrc/raster_kernel.cu, csrc/layers.cu,
namespace rt): the bytes of the frames' bins and output planes
(benchmark/work/raster.py) at the bandwidth peak over their device time,
in percent."""

WORK = "raster"


def read(w, window):
    return w.roofline(WORK, "rt")
