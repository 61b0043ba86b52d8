"""A run of one cell, from set-up to its result line (benchmark/run.py is
the command; the CPU tests call `run` with device "cpu")."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

from benchmark import cell as cell_mod
from benchmark import trace
from benchmark.cell import BENCH_ROOT

#: the numbers compared with the reference, in the order they print
CHECKS = ("px_differing", "u8_gap", "stats_differing", "dropped_work", "config_changed")


def card_line() -> str:
    """The card's name and power limit (nvidia-smi), to stand beside every
    number of the run."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run(workload: dict, config: dict, traffic: dict, e2e: list, per_layer: list, *,
        seed: int, seconds: float, traced: bool, device: str, process_start: float,
        control: bool = False) -> dict:
    """Set-up, warm-up, the window, the check; returns the result dict."""
    readers = {m["name"]: cell_mod.load_module(BENCH_ROOT / "metrics" / f"{m['name']}.py",
                                               f"benchmark.metrics.{m['name']}")
               for m in per_layer} if traced else {}
    work_names = tuple(sorted({getattr(r, "WORK") for r in readers.values()
                               if hasattr(r, "WORK")}))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    overrides = {"bf16_shading": True} if control else None
    cell = cell_mod.Cell(config, traffic, seed, device, overrides)
    first = cell_mod.warm_up(cell)
    setup_s = time.time() - process_start
    run_ = cell_mod.window(cell, first, seconds, profile=traced)
    stated = cell.rt.RenderConfig(**cell.port_kw)
    grown = {f.name: getattr(run_.config_after, f.name) for f in dataclasses.fields(stated)
             if getattr(run_.config_after, f.name) != getattr(stated, f.name)}
    if grown:
        print(f"benchmark: the renderer changed its configuration in warm-up: {grown}",
              file=sys.stderr)
    measured = cell_mod.readings(run_, traffic)
    cell_mod.free_port(cell, run_)
    from renderer_tpu_torch.raster.pipeline import STAT_NAMES

    t_check = time.perf_counter()
    readings, works = cell_mod.check(cell, run_, STAT_NAMES, work_names)
    check_s = time.perf_counter() - t_check
    readings["config_changed"] = len(grown)
    limits = config["check"]["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in CHECKS}
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and readings["frames_checked"] > 0)
    metrics = {}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": run_.memory_peak}
    result = {"correct": correct, "attempted": run_.frames, "failed": readings["failed"]}
    if traced:
        peaks = json.loads((BENCH_ROOT / "peaks.json").read_text()).get(dev_info["kind"])
        w = trace.Window(run_.events or [], run_.profiled[1] if run_.profiled else 0,
                         host_s=run_.host_s, work=works, peaks=peaks)
        for m in per_layer:
            value = readers[m["name"]].read(w, measured)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=w.busy_s, window_s=w.window_s)
        result["breakdown"] = w.breakdown()
    else:
        measured["setup_s"] = setup_s
        for m in e2e:
            if measured.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    result.update(metrics=metrics, device=dev_info)
    result["card"] = card_line() if cuda else "cpu"
    result["frames_checked"] = readings["frames_checked"]
    result["check_s"] = check_s
    result["dropped"] = readings["dropped"]
    result["checks"] = checks
    return result


def report(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
