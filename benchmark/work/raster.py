"""Work of the raster kernels K1 (opaque visibility) and K2 (the masked and
the blended layers) in one frame, from the reference's binning and
visibility of the frame (benchmark/reference/frame.py `probe`): each kernel
reads the binned columns of its class's kept pairs (16 rows of 4 bytes a
pair) and its class's bin starts and counts once, K2 the depth floor it is
given, and each writes its output planes once (K1 depth and id a sample;
K2 its demand count a sample, and depth and id of each layer entry the
frame fills, as the reference's layers hold them, not of every one of the
configured layers). Counted from the pairs the frame's binning keeps and
the layers the frame fills, not from how many coverage tests a kernel's
design keeps. The coverage arithmetic is not counted: each kernel is held
to its bytes alone, so the share is a floor of how near the kernels come
to their bound, and reads low for a kernel that its arithmetic bounds."""

from __future__ import annotations

from benchmark.reference.raster.binning import B_ROWS


def count(probe: dict, cfg) -> list:
    """[(kernel, operations, bytes)] of one frame's K1 and K2 launches."""
    counts = probe["c_all"]
    n_tiles = counts.shape[1]
    n_s = cfg.msaa_samples
    plane = n_s * cfg.padded_height * cfg.padded_width
    bins = [int(c) * B_ROWS * 4 + n_tiles * 8 for c in counts.sum(1).tolist()]
    out = [("K1 opaque", 0, bins[0] + plane * 8)]
    cls = 1
    for name, key in (("K2 masked", "filled_m"), ("K2 blended", "filled_b")):
        if probe.get(key) is not None:
            out.append((name, 0, bins[cls] + plane * 4 + int(probe[key]) * 8 + plane * 4))
            cls += 1
    return out
