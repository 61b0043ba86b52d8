"""The raster front end's kernels F1-F4 (csrc/frontend.cu) against their
plain versions on the calls a real frame makes, timed step by step.

`recorded_frontend()` records every call made to setup.triangle_setup
("F1") and binning.bin_triangle_classes ("BIN"; the UI pass's
bin_triangles runs through it) while a frame renders; `run_frontend` runs
one recorded call again through the kernels or the plain version;
`compare` counts the values whose bits differ; `step_ms` times each step
of a call on the device (F1, or binning.STEPS: the kernels F2-F4 and the
library calls between them); `frontend_work` counts the bytes each step's
data needs. chip_smoke.py phase 12 and tests/test_torch_cuda_kernels.py
use them.

As a probe, on one NVIDIA GPU:

    python3 -m renderer_tpu_torch.tools.frontend_probe [--against FILE ...] [--timing FILE ...] [variant ...]

records one 1920×1080 frame of chip_smoke.py's scenes A, B and C (C with
its UI window, whose pass runs setup and binning once more), holds every
call's kernels to the plain versions bit for bit, and prints each call's
time as issued and queued behind a spin kernel, the plain version's, the
launch floor (`launch_floor_ms`) and each step's queued time beside its
bound. With --against FILE (another version's frontend.cu, with the same
entry points; each option one file, named by its stem), --timing FILE (the
same, timed without comparing its outputs: a version cut to time a part
of a kernel) and with variants (the library's frontend.cu with constants
edited, as named in VARIANTS), it builds each beside the library and
times all on every call in turns (library, other, ..., other, library).
The parent commit's kernels against the library (build/ is git-ignored;
the file goes with the repository to the card's machine):

    git show HEAD~1:renderer_tpu_torch/csrc/frontend.cu > build/parent_frontend.cu
    python3 -m renderer_tpu_torch.tools.frontend_probe --against build/parent_frontend.cu
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from renderer_tpu_torch import kernels
from renderer_tpu_torch.engine import stats as engine_stats
from renderer_tpu_torch.raster import binning, setup

#: the recorded entry points, by kind: (module, function name, plain version)
ENTRY_POINTS = {"F1": (setup, "triangle_setup", setup.triangle_setup_plain),
                "BIN": (binning, "bin_triangle_classes", binning.bin_triangle_classes_plain)}
#: the kernels' entry points in the library (tools.shade_probe.using)
LIBRARY_FUNCTIONS = ("rt_setup", "rt_bin_spans", "rt_bin_rows", "rt_bin_pairs",
                     "rt_bin_scan", "rt_bin_scatter")
#: each kernel's device function in csrc/frontend.cu (its ptxas report)
DEVICE_FUNCTIONS = {"F1 setup": "setup_kernel", "F2 spans": "spans_kernel",
                    "F2 rows": "rows_kernel", "F3 pairs": "pairs_kernel",
                    "F4 scan": "scan_kernel", "F4 scatter": "scatter_kernel"}
#: name → the constants of csrc/frontend.cu it edits, with their values
#: (F2 rows' and F3's items a tile, or where they stop)
VARIANTS = {
    "items256": (("ROWS_ITEMS", "256"), ("PAIRS_ITEMS", "256")),
    "items512": (("ROWS_ITEMS", "512"), ("PAIRS_ITEMS", "512")),
    "items768": (("ROWS_ITEMS", "768"), ("PAIRS_ITEMS", "768")),
    # timings of F2 rows' and F3's phases alone (their outputs are not
    # compared): up to the merge splits; F2 rows up to its staging
    "stop-split": (("EXPAND_STOP", "1"),),
    "stop-staged": (("EXPAND_STOP", "2"),),
    # F2 spans split: its loads and stores with the arithmetic cut; its
    # stores alone
    "spans-memory": (("SPANS_STOP", "1"),),
    "spans-stores": (("SPANS_STOP", "2"),),
    # F2 spans' narrow path (its rows loaded at once) or its wide path (the
    # bbox rows read after the valid row) on every call
    "spans-narrow": (("SPANS_GATE_MIN", "2147483647"),),
    "spans-wide": (("SPANS_GATE_MIN", "0"),),
    # F1 split: its loads and stores with the arithmetic cut; its stores
    # alone. F4 scatter split: its group search, then zeros; its stores alone
    "setup-memory": (("SETUP_STOP", "1"),),
    "setup-stores": (("SETUP_STOP", "2"),),
    "scatter-search": (("SCATTER_STOP", "1"),),
    "scatter-stores": (("SCATTER_STOP", "2"),),
    "scatter-gathers": (("SCATTER_STOP", "3"),),
    # F1 at 256 threads a block (the parent's); F4 scatter on one path on
    # every call
    "setup-threads256": (("SETUP_THREADS", "256"),),
    "scatter-narrow": (("SCATTER_WIDE_MIN", "2147483647"),),
    "scatter-wide": (("SCATTER_WIDE_MIN", "0"),),
}
#: the variants whose outputs are incomplete
TIMING_ONLY = ("stop-split", "stop-staged", "spans-memory", "spans-stores", "setup-memory",
               "setup-stores", "scatter-search", "scatter-stores", "scatter-gathers")
#: rt_launch_floor's empty launches: name → its `what`
FLOORS = {"one block": 0, "F2 spans' grid": 1, "a thread a triangle": 2,
          "a thread a binned column": 3, "F1's grid": 4, "F4 scatter's grid": 5}
#: the floors timed for a call, by kind
CALL_FLOORS = {"F1": ("one block", "a thread a triangle", "F1's grid"),
               "BIN": ("one block", "F2 spans' grid", "a thread a triangle",
                       "a thread a binned column", "F4 scatter's grid")}
#: each kernel's floor, whose time over it is printed: its own grid's
#: where one is timed (F1, F2 spans, F4 scatter), else one block's
OVER_FLOOR = {"F1 setup": "F1's grid", "F2 spans": "F2 spans' grid", "F2 rows": "one block",
              "F3 pairs": "one block", "F4 scan": "one block",
              "F4 scatter": "F4 scatter's grid"}
BYTES_PER_S = 3.35e12  # H100 SXM HBM3 data sheet
REPS = 10  # calls a timing


@contextlib.contextmanager
def recorded_frontend():
    """Yields a list that receives (kind, args, kwargs) of every call made
    to the entry points inside the block; the calls still run."""
    calls = []
    originals = {kind: getattr(mod, name) for kind, (mod, name, _) in ENTRY_POINTS.items()}

    def recorder(kind, fn):
        def call(*args, **kw):
            calls.append((kind, args, dict(kw)))
            return fn(*args, **kw)
        return call

    for kind, (mod, name, _) in ENTRY_POINTS.items():
        setattr(mod, name, recorder(kind, originals[kind]))
    try:
        yield calls
    finally:
        for kind, (mod, name, _) in ENTRY_POINTS.items():
            setattr(mod, name, originals[kind])


def run_frontend(kind: str, args: tuple, kw: dict, plain: bool) -> tuple:
    """One recorded call through its entry point (the kernels, for CUDA
    tensors) or its plain version: a tuple of its outputs."""
    mod, name, plain_fn = ENTRY_POINTS[kind]
    out = (plain_fn if plain else getattr(mod, name))(*args, **kw)
    return out if isinstance(out, tuple) else (out,)


def compare(got: tuple, want: tuple) -> dict:
    """Counts of the outputs' values, of those whose bits differ, and of
    the plain version's NaN (a NaN must have the same bits too)."""
    out = {"values": 0, "differing": 0, "nan": 0}
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype)
        out["values"] += w.numel()
        if w.dtype == torch.float32:
            out["nan"] += int(torch.isnan(w).sum())
            g, w = g.view(torch.int32), w.view(torch.int32)
        out["differing"] += int((g != w).sum())
    return out


def _steps(kind: str, args: tuple, kw: dict) -> list:
    if kind == "F1":
        return [("F1 setup", lambda: setup.triangle_setup(*args, **kw))]
    steps, _result = binning.binning_steps(*args, **kw)
    return steps


def step_ms(kind: str, args: tuple, kw: dict, reps: int = REPS) -> dict:
    """{step: mean device ms} of one recorded call's steps over `reps`
    runs enqueued behind a spin kernel (engine.stats.held_stream), from
    CUDA events between the steps, so the times are the device's alone.
    The runs reuse one call's buffers (each step rewrites its outputs)."""
    return _timed(_steps(kind, args, kw), reps)


def launch_floor_ms(kind: str, args: tuple, kw: dict, reps: int = REPS) -> dict:
    """{FLOORS name: mean device ms} of an empty kernel timed as step_ms
    times a step, with the grids of CALL_FLOORS[kind] for the call's sizes:
    F4 scan's one block of threads, a grid of a thread a triangle (F1's and
    F2 spans' before their redesigns), F1's grid; for a binning call also
    F2 spans' grid, a grid of a thread a binned column (F4 scatter's before
    its redesign) and F4 scatter's grid. The least a step of the call can
    take."""
    lib = kernels.load()
    a = kernels.BinArgs()
    if kind == "F1":
        a.tc = args[1].shape[0]
    else:
        a.tc, a.n_classes, a.tiles_x = args[0].shape[1], len(args[1]) - 1, kw["tiles_x"]
        a.local_tiles_y = kw.get("local_tiles_y") or kw["tiles_y"]
        a.p_total = binning.padded_capacity_classes(
            kw["pair_capacity"], a.tiles_x * a.local_tiles_y, a.n_classes)
    floors = {k: FLOORS[k] for k in CALL_FLOORS[kind]}

    def empty(what):
        return lambda: kernels.check_launch(
            "launch floor", lib.rt_launch_floor(ctypes.byref(a), what, kernels.current_stream()))
    return _timed([(name, empty(what)) for name, what in floors.items()], reps)


def _timed(steps: list, reps: int) -> dict:
    for _name, run in steps:
        run()
    torch.cuda.synchronize()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(len(steps) + 1)]
              for _ in range(reps)]
    with engine_stats.held_stream(engine_stats.SPIN_CYCLES):
        for evs in events:
            evs[0].record()
            for (_name, run), ev in zip(steps, evs[1:]):
                run()
                ev.record()
    torch.cuda.synchronize()
    return {name: sum(evs[i].elapsed_time(evs[i + 1]) for evs in events) / reps
            for i, (name, _run) in enumerate(steps)}


def frontend_work(kind: str, args: tuple, kw: dict, outs: tuple) -> dict:
    """{step: bytes} that one call's data needs in each step: each input
    read once and each output written once, counting per triangle only
    the valid triangles of the call's bounds (and F2 spans' tri_info only
    for the triangles with rows, the only ones F2 rows reads), per row the
    live rows and per pair the live (demanded) and kept (binned) pairs; the
    vectors a library call reads or writes in full (the cumsums' and the
    sort's) count in full. The operations, a few tens a row or pair, are
    far below the bytes' time on this card."""
    if kind == "F1":
        tri_v = args[1]
        t = tri_v.shape[0]
        return {"F1 setup": 12 * t + 16 * int(torch.unique(tri_v).numel()) + 96 * t}
    td, bounds = args[0], args[1]
    tc = td.shape[1]
    rc = kw.get("row_capacity") or kw["pair_capacity"]
    pc = kw["pair_capacity"]
    binned, starts, counts, _ov, _row_ov, total, row_demand = outs
    n_classes, n_tiles = counts.shape
    n_keys = n_classes * n_tiles
    idx = torch.arange(tc, device=td.device)
    valid = int(((td[setup.VALID_ROW] > 0) & (idx >= bounds[0]) & (idx < bounds[-1])).sum())
    rows, pairs = min(int(row_demand), rc), min(int(total), pc)
    kept = int(counts.sum())
    z_rows = 12 if kw.get("zbuckets", 1) > 1 else 0
    grid = {k: kw[k] for k in ("tiles_x", "tiles_y", "tile_w", "tile_h", "tile_row_lo",
                               "local_tiles_y", "row_stride") if k in kw}
    with_rows = int((binning.band_rows(td, bounds, n_classes, **grid)[3] > 0).sum())
    return {
        "F2 spans": (4 * tc + valid * (16 + z_rows) + 4 * tc + 16 * with_rows
                     + 4 * (n_keys + n_classes + 1)),
        "cumsum of the row counts": 8 * tc,
        "F2 rows": 4 * tc + valid * 64 + 4 * rc + 16 * rows,
        "cumsum of the row spans": 8 * rc,
        "F3 pairs": 4 * rc + 20 * rows + 36 * valid + 4 * pc + 4 * pairs + 4 * n_keys,
        "stable sort of the keys": 16 * pc,
        "F4 scan": 4 * (n_keys + n_classes + 1) + 4 * (2 * n_keys + n_classes + 3) + 8,
        "F4 scatter": 12 * kept + 60 * min(kept, valid) + 12 * n_keys + binned.numel() * 4,
    }


def resources(report: dict, step: str) -> dict:
    """Registers (the most), stack and spill bytes and static shared bytes
    of a kernel's instantiations in a build's ptxas report."""
    fn = DEVICE_FUNCTIONS[step]
    got = [v for k, v in report.items() if f"2rf{len(fn)}{fn}" in k]
    if not got:
        raise RuntimeError(f"no ptxas report for {fn}")
    return dict(registers=max(v["registers"] for v in got),
                shared=max(v["shared"] for v in got),
                **{key: sum(v[key] for v in got)
                   for key in ("stack", "spill_stores", "spill_loads")})


def frame_calls(renderer, scene, ui=None) -> list:
    """The front end's calls of one frame (the second: the first grows the
    capacities under overflow_policy "sync")."""
    renderer.render_frame_device(scene, 0, ui=ui)
    with recorded_frontend() as calls:
        renderer.render_frame_device(scene, 0, ui=ui)
    torch.cuda.synchronize()
    return calls


def _build(tmp: Path, name: str, src: Path, edits: tuple = ()) -> tuple:
    """Library and ptxas log of `src` with some constants edited, built in
    a directory of its own."""
    d = tmp / name
    d.mkdir()
    text = src.read_text()
    for const, value in edits:
        text, n = re.subn(rf"(constexpr int {const} = )\d+;", rf"\g<1>{value};", text)
        if n != 1:
            raise RuntimeError(f"{src}: no constant {const}")
    (d / "frontend.cu").write_text(text)
    so, log = d / "frontend.so", d / "build.log"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
           str(d / "frontend.cu")]
    return cmd, so, log


def _build_all(todo: list) -> dict:
    """{name: (library, ptxas log)}: every (name, command, library, log)
    of `todo` compiled at once."""
    procs = [(name, cmd, so, log, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
             for name, cmd, so, log in todo]
    out = {}
    for name, cmd, so, log, proc in procs:
        log.write_text(proc.communicate()[0])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}\n{log.read_text()[-4000:]}")
        out[name] = (so, log)
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("frontend_probe: torch.cuda.is_available() is False")
    import chip_smoke as cs
    import renderer_tpu_torch as trt
    from renderer_tpu_torch.tools.shade_probe import load, using

    others, timing_only = {}, set(TIMING_ONLY)
    while argv[:1] in (["--against"], ["--timing"]):
        path = Path(argv[1])
        others[path.stem] = path
        if argv[0] == "--timing":
            timing_only.add(path.stem)
        argv = argv[2:]
    variants = argv
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise SystemExit(f"frontend_probe: unknown variants {unknown}; known: {list(VARIANTS)}")
    dev = torch.device("cuda")
    card = engine_stats.card_line()
    print(card, flush=True)
    libs = {"library": kernels.load()}
    reports = {"library": kernels.ptxas_report()}
    with tempfile.TemporaryDirectory() as tmp:
        todo = [(n, *_build(Path(tmp), n, kernels.CSRC / "frontend.cu", VARIANTS[n]))
                for n in variants]
        todo[:0] = [(n, *_build(Path(tmp), n, path)) for n, path in others.items()]
        for n, (so, log) in _build_all(todo).items():
            libs[n] = load(so)
            reports[n] = kernels.ptxas_report(log)
        reg_a, sc_a, cfg_a, pol_a = cs.scene_a()
        reg_b, sc_b, cfg_b, pol_b = cs.scene_b()
        frames_c, cfg_c, pol_c = cs.scene_c()
        sc_c, ui_c = frames_c.next()
        scenes = (("A", trt.Renderer(reg_a, cfg_a, overflow_policy=pol_a, device=dev), sc_a,
                   None),
                  ("B", trt.Renderer(reg_b, cfg_b, overflow_policy=pol_b, device=dev), sc_b,
                   None),
                  ("C", trt.Renderer(frames_c.registry, cfg_c, profiler=frames_c.profiler,
                                     overflow_policy=pol_c, device=dev), sc_c, ui_c))
        for scene, r, sc, ui in scenes:
            for i, (kind, args, kw) in enumerate(frame_calls(r, sc, ui)):
                what = f"scene {scene} call {i} ({kind}{', the UI pass' if i >= 2 else ''})"
                want = run_frontend(kind, args, kw, plain=True)
                for n, lib in libs.items():
                    if n in timing_only:
                        continue
                    with using(lib, LIBRARY_FUNCTIONS):
                        got = run_frontend(kind, args, kw, plain=False)
                    diff = compare(got, want)
                    if diff["differing"]:
                        raise RuntimeError(f"{n}: {what}: {diff}")
                work = frontend_work(kind, args, kw, want)
                times = {n: [] for n in libs}
                order = list(libs)
                for n in order + order[::-1]:
                    with using(libs[n], LIBRARY_FUNCTIONS):
                        times[n].append(step_ms(kind, args, kw))
                issued = cs.cuda_ms(lambda: run_frontend(kind, args, kw, False), REPS)
                plain = cs.cuda_ms(lambda: run_frontend(kind, args, kw, True), 2)
                floor = launch_floor_ms(kind, args, kw)
                print(f"probe: {what}: {diff['values']} values bit-equal ({diff['nan']} NaN) "
                      f"| issued {issued:.4f} ms, plain {plain:.3f} ms | launch floor "
                      + ", ".join(f"{k} {v:.4f}" for k, v in floor.items())
                      + f" ms queued | {card}", flush=True)
                for step in times["library"][0]:
                    bound = work.get(step, 0) / BYTES_PER_S * 1e3
                    over = ""
                    if step in OVER_FLOOR:
                        f = floor[OVER_FLOOR[step]]
                        over = f" | over {OVER_FLOOR[step]} floor " + "; ".join(
                            f"{n} " + " / ".join(f"{t[step] - f:.4f}" for t in ts)
                            for n, ts in times.items())
                    print(f"probe:   {step}: "
                          + "; ".join(f"{n} " + " / ".join(f"{t[step]:.4f}" for t in ts)
                                      for n, ts in times.items())
                          + f" ms queued | bound {bound:.7f} ms ({work.get(step, 0)} B)"
                          + over, flush=True)
    for n, rep in reports.items():
        print(f"probe: ptxas {n}: " + ", ".join(
            f"{s} {resources(rep, s)}" for s in DEVICE_FUNCTIONS), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
