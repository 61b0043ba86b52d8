"""Device: the share of the window's busy device time under no span of the
program (work launched outside its calls, or outside every span of one),
in percent, by the program's manifests."""

from benchmark import spans


def read(w, window):
    return spans.unattributed_pct(w)
