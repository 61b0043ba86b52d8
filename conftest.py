"""pytest set-up for the repo's test folders, beside each folder's own
conftest.py.

The JAX package's host library (csrc/librenderer_native.so) is brought up
to date once, before any test of tests/ loads it. Its loader
(renderer_tpu/tools/native.py) runs `make -C csrc` itself when the library
is missing or stale, and the xdist workers that load it at once would race
one make against another. Each process takes a file lock in build/ and
runs make under it; once one has built the library, make is a no-op for
the others."""

import fcntl
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _runs_tests_folder(config) -> bool:
    """Whether the session collects from tests/ (its paths, or the root)."""
    tests = ROOT / "tests"
    for arg in config.args or ["."]:
        path = (Path(config.invocation_params.dir) / str(arg).split("::")[0]).resolve()
        if path == tests or tests in path.parents or path in tests.parents:
            return True
    return False


def pytest_configure(config):
    if shutil.which("make") is None or not _runs_tests_folder(config):
        return
    (ROOT / "build").mkdir(exist_ok=True)
    with open(ROOT / "build" / "csrc-make.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", str(ROOT / "csrc")], capture_output=True)
