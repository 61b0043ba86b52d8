"""Set-up: host seconds of the program's CUDA graph captures and
instantiations (set-up spans `setup.capture` and `setup.instantiate`),
summed over the run's captures."""

from benchmark import spans


def read(w, window):
    return spans.setup_s("setup.capture", "setup.instantiate")
