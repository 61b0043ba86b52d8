"""Device: the share of the traced window in which no device event ran,
in percent (1 - the union of the device events' intervals / the window)."""


def read(w, window):
    return 100.0 * (1.0 - w.busy_s / w.window_s) if w.window_s > 0 else None
