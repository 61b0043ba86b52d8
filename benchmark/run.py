"""The benchmark of renderer_tpu_torch on one NVIDIA GPU: one run of one
cell of BENCHMARK.json.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run is one process: it builds the cell's scene from the seed, warms up
every shape the cell's traffic uses, measures for `--seconds`, checks what
the window produced against the plain reference (benchmark/reference), and
prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device` and, traced, `breakdown`,
then `checks`, each number compared beside its limit (also the last lines
of standard error). It exits 2, printing no result, without a card (or
with fewer than the cell asks for), and 3 if JAX or the JAX package is
loaded once the window has closed. `--control` runs the program with its
bf16 shading (the control of the comparison, not a cell's run). A traffic
mix with `host_cores` holds the process to that many of its allowed cores.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """Wall-clock time this process started (from /proc; now, where that
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(x.split()[1]) for x in f if x.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "renderer_tpu")
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def load_cell(name: str) -> tuple:
    """(workload entry, configuration, traffic, end-to-end metrics, per-layer
    metrics) of cell `name`, each found by name from BENCHMARK.json."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the cells are {sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return w, config, traffic, mine(bench["end_to_end"]), mine(bench["per_layer"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    w, config, traffic, e2e, per_layer = load_cell(args.workload)
    if traffic.get("host_cores"):
        # a host-paced mix runs on a fixed few of the allowed cores (the
        # highest-numbered), set before torch sizes its thread pool from them
        allowed = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, set(allowed[-traffic["host_cores"]:]))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"benchmark: needs {w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: "
              "no result (the benchmark never runs on the CPU)", file=sys.stderr)
        return 2
    from benchmark import harness

    result = harness.run(w, config, traffic, e2e, per_layer, seed=args.seed,
                         seconds=args.seconds, traced=bool(args.trace), device="cuda",
                         process_start=START, control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package is loaded: {bad}; no result",
              file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
