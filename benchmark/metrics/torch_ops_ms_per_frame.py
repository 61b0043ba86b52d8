"""Vertex stage, tonemap, glue and the binning's library sort and cumsums:
the device time of every event outside the hand-written kernels'
namespaces (rs, rc, rt, rf), divided by the frames, in ms."""


def read(w, window):
    return 1e3 * w.time_outside(("rs", "rc", "rt", "rf")) / w.frames if w.device else None
