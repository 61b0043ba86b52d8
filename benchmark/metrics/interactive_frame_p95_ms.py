"""The interactive viewer's stutter: the 95th percentile of the intervals
between the CUDA events recorded after consecutive frames, over every frame
of the window outside the traced sub-window, in ms (a per-layer reading:
two sets of runs of one tree spread too wide for a bound)."""


def read(w, window):
    return window.get("interactive_frame_p95_ms")
