"""One run of a cell: set-up, warm-up, the measured window (traced: with a
profiled sub-window), and the check against the plain reference.

Everything here is general: the configuration (`configs/<name>.json`), the
traffic mix (`traffic/<name>.json`), the scene generator
(`scenes/<scene>.py`), the per-layer readers (`metrics/<name>.py`) and the
work formulas (`work/<name>.py`) are found by name. The program is driven
only through its public API (`renderer_tpu_torch`: RenderConfig, Renderer,
MaterialRegistry, VertexLibraryBuilder, Scene and the material types)."""

from __future__ import annotations

import gc
import importlib
import importlib.util
import statistics
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark import trace
from benchmark.scenes import scene as scene_mod

BENCH_ROOT = Path(__file__).resolve().parent

#: the stats entries that count dropped or truncated work (renderer stats
#: vector, renderer_tpu_torch.raster.pipeline.STAT_NAMES); shade_clamped_px
#: is the renderer's reported shading fallback, held to the reference's
DROPS = ("overflow_opaque", "overflow_masked", "overflow_blended", "overflow_ui",
         "masked_saturated_px", "blended_saturated_px", "ui_saturated_px", "row_overflow")


def load_module(path: Path, name: str):
    """A module of the benchmark's own by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Run:
    """What a run measured: the end-to-end readings, the frames, the
    device's peak memory, and the per-layer context of a traced run."""

    first: int = 0
    seconds: float = 0.0
    frames: int = 0
    frame_ms: list = field(default_factory=list)
    host_s: list = field(default_factory=list)
    stats: list = field(default_factory=list)
    kept: list = field(default_factory=list)  # (frame index, part, image)
    profiled: tuple | None = None  # (first frame, frames) of the traced window
    events: list | None = None
    memory_peak: int = 0
    config_after: object = None


class Cell:
    """A cell's inputs, made from the seed: the scene as numpy data, the
    camera path, and the port's objects built from them."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 port_overrides: dict | None = None):
        import renderer_tpu_torch as rt

        self.rt, self.config, self.traffic, self.device = rt, config, traffic, device
        self.seed = seed
        rng = np.random.default_rng(seed)
        # the seed sets the camera path's phase, the timeline's start and
        # the seeded textures' contents, and nothing else
        self.phase = float(rng.uniform(0.0, 2.0 * np.pi))
        self.t0 = float(rng.uniform(0.0, config["camera"]["period_s"]))
        gen = load_module(BENCH_ROOT / "scenes" / f"{config['scene']}.py",
                          f"benchmark.scenes.{config['scene']}")
        self.desc = gen.make(config["scene_params"], rng)
        self.render_kw = dict(config["render"])
        self.port_kw = {**self.render_kw, **(port_overrides or {})}
        self.registry, self.meshes, self.materials = scene_mod.build(self.desc, rt)
        self.renderer = rt.Renderer(self.registry, rt.RenderConfig(**self.port_kw),
                                    overflow_policy="sync", device=device)

    def pose(self, i: int):
        return scene_mod.camera_pose(self.config["camera"], self.phase,
                                     self.t0 + i / self.traffic["path_fps"])

    def scene(self, i: int, into=None):
        sc = self.rt.Scene(world_space=self.rt.GLTF) if into is None else into
        scene_mod.queue(sc, self.desc, self.meshes, self.materials, self.pose(i))
        return sc


class Clock:
    """Marks after each frame on the stream: CUDA events on the card, host
    stamps after a synchronize-free call on the CPU (CPU runs are tests)."""

    def __init__(self, device: str):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def warm_up(cell: Cell) -> int:
    """Every shape the cell's traffic uses, under the "sync" overflow
    policy, then one batch or frame under "off", as the window runs:
    returns the next frame index of the timeline."""
    r, tr = cell.renderer, cell.traffic
    i = 0
    if tr["entry"] == "render_frames_device":
        for b in range(tr["warmup_batches"]):
            r.overflow_policy = "sync" if b + 1 < tr["warmup_batches"] else "off"
            r.render_frames_device([cell.scene(i + j) for j in range(tr["batch"])])
            i += tr["batch"]
    else:
        sc = None
        for k in range(tr["warmup_frames"]):
            r.overflow_policy = "sync" if k + 1 < tr["warmup_frames"] else "off"
            sc = cell.scene(i, into=sc)
            r.render_frame_device(sc)
            i += 1
    r.overflow_policy = "off"
    sync(cell.device)
    return i


class Keep:
    """Which frames of the window are kept for the check: the timeline is
    cut into blocks of `every` frames (a flythrough's batches), each block
    into `parts` equal parts, and one frame of each part is kept, at an
    offset drawn from the seed for that block and part. So every position
    of a batch can be checked, and each part of it is in every run."""

    def __init__(self, seed: int, every: int, parts: int):
        self.seed, self.every, self.parts = seed, every, parts
        self._at: dict = {}

    def part(self, n: int) -> int | None:
        """The part of frame n's block it is kept for, None where it is not
        kept."""
        block, pos = divmod(n, self.every)
        part = pos * self.parts // self.every
        key = (block, part)
        if key not in self._at:
            lo = -(-part * self.every // self.parts)
            hi = -(-(part + 1) * self.every // self.parts)
            rng = np.random.default_rng([self.seed, 1, block, part])
            self._at[key] = lo + int(rng.integers(hi - lo))
        return part if pos == self._at[key] else None


def window(cell: Cell, first: int, seconds: float, profile: bool) -> Run:
    """The measured window: frames issued from `first` on until `seconds`
    of host time have passed, then a synchronize. With `profile`, a
    torch.profiler window of the traffic's `profile_frames` frames starts
    once half of `seconds` has passed (after a synchronize, so that it
    holds those frames' work and no earlier)."""
    r, tr, dev = cell.renderer, cell.traffic, cell.device
    run, clock = Run(first=first), Clock(dev)
    batched = tr["entry"] == "render_frames_device"
    step = tr["batch"] if batched else 1
    keep = Keep(cell.seed, tr["keep_every"], cell.config["check"]["frames"])
    prof = None
    sc = None
    i = first
    t0 = time.perf_counter()
    clock.mark()
    while True:
        if profile and prof is None and time.perf_counter() - t0 >= seconds / 2:
            sync(dev)
            prof = trace.Profiler(dev)
            run.profiled = (i, tr["profile_frames"])
        h0 = time.perf_counter()
        if batched:
            with trace.label("bench.build_scenes"):
                scenes = [cell.scene(i + j) for j in range(step)]
            with trace.label("bench.render_frames_device"):
                imgs, stats = r.render_frames_device(scenes)
        else:
            with trace.label("bench.requeue_scene"):
                sc = cell.scene(i, into=sc)
            with trace.label("bench.render_frame_device"):
                imgs, stats = r.render_frame_device(sc)[None], r.last_stats[None]
        run.host_s.append(time.perf_counter() - h0)
        clock.mark()
        run.stats.append(stats)
        for j in range(step):
            part = keep.part(i + j)
            if part is not None:
                run.kept.append((i + j, part, imgs[j].clone() if batched else imgs[j]))
        last = (i + step - 1, 0, imgs[-1].clone() if batched else imgs[-1])
        del imgs
        i += step
        if prof is not None and run.events is None and i >= sum(run.profiled):
            with trace.label("bench.synchronize"):
                sync(dev)
            run.events = prof.stop()
            run.profiled = (run.profiled[0], i - run.profiled[0])
        if time.perf_counter() - t0 >= seconds and (not profile or run.events is not None):
            break
    sync(dev)
    run.seconds = time.perf_counter() - t0
    if not run.kept:  # a window shorter than keep_every frames
        run.kept.append(last)
    run.frames = i - first
    run.frame_ms = clock.intervals_ms()
    run.config_after = r.config
    if torch.device(dev).type == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated()
    return run


def p95(values: list) -> float:
    """The 95th percentile (statistics.quantiles, exclusive method; the
    largest value of fewer than two; None of none)."""
    if len(values) < 2:
        return max(values, default=None)
    return statistics.quantiles(values, n=20)[18]


def readings(run: Run, traffic: dict) -> dict:
    """The window's end-to-end readings by metric name. A traced run's
    frame intervals leave out the traced sub-window's frames and the
    interval spanning the profiler's stop."""
    out = {}
    if traffic["entry"] == "render_frames_device":
        out["flythrough_fps"] = run.frames / run.seconds
    else:
        out["interactive_fps"] = run.frames / run.seconds
        ms = run.frame_ms
        if run.profiled is not None:
            lo, n = run.profiled[0] - run.first, run.profiled[1]
            ms = ms[:lo] + ms[lo + n + 1:]
        out["interactive_frame_p95_ms"] = p95(ms)
    return out


def free_port(cell: Cell, run: Run) -> None:
    """Drop the program's state before the reference runs: its renderer,
    graphs and tensors; the kept images and stats move to the host."""
    run.kept = [(i, part, img.cpu()) for i, part, img in run.kept]
    run.stats = torch.cat(run.stats).cpu()
    cell.renderer = None
    gc.collect()
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()


def check(cell: Cell, run: Run, stat_names: tuple, work_names: tuple) -> tuple:
    """Compares what the window produced with the plain reference: the
    images of `config.check.frames` kept frames drawn from the seed (from
    the traced window in a traced run; the k-th of them from the kept
    frames of part k of their block, so that each part of a batch is
    checked), their stats vectors, and every window frame's
    dropped work. Returns (readings, per-frame work by work module: of
    the checked frames, and in a traced run of further frames of its window,
    evenly spaced, up to `config.check.work_frames`, rendered by the
    reference for their work alone)."""
    import benchmark.reference.api as ref
    from benchmark.reference.renderer import PlainRenderer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kept = run.kept
    if run.profiled is not None:
        lo, n = run.profiled
        kept = [k for k in kept if lo <= k[0] < lo + n] or kept
    rng = np.random.default_rng([cell.seed, 2])
    n_check = min(cell.config["check"]["frames"], len(kept))
    picks = []
    for k in range(n_check):
        part = k % cell.config["check"]["frames"]
        pool = [p for p in range(len(kept)) if p not in picks and kept[p][1] == part]
        pool = pool or [p for p in range(len(kept)) if p not in picks]
        picks.append(pool[int(rng.integers(len(pool)))])
    picks.sort()
    extra = []
    if work_names and run.profiled is not None:
        lo, n = run.profiled
        n_work = cell.config["check"]["work_frames"]
        checked = {kept[p][0] for p in picks}
        extra = [f for f in sorted({lo + k * n // n_work for k in range(n_work)})
                 if f not in checked][: max(0, n_work - len(picks))]
    registry, meshes, materials = scene_mod.build(cell.desc, ref)
    plain = PlainRenderer(registry, ref.RenderConfig(**cell.render_kw), cell.device)
    drops = [stat_names.index(k) for k in DROPS]
    dropped = int(run.stats[:, drops].sum())
    px = gap = stats_diff = 0
    failed = int((run.stats[:, drops].sum(1) > 0).sum())
    works = {name: [] for name in work_names}

    def count_work(probe):
        for name in work_names:
            mod = importlib.import_module(f"benchmark.work.{name}")
            works[name].append(mod.count(probe, plain.config))

    for p in picks:
        i, _part, img = kept[p]
        sc = ref.Scene(world_space=ref.GLTF)
        scene_mod.queue(sc, cell.desc, meshes, materials, cell.pose(i))
        probe = {} if work_names else None
        want, want_stats = plain.render(sc, probe)
        want, got = want.cpu(), img
        diff = (want.to(torch.int16) - got.to(torch.int16)).abs()
        frame_px = int(diff.amax(-1).gt(0).sum())
        px, gap = max(px, frame_px), max(gap, int(diff.max()))
        row = run.stats[i - run.first]
        frame_stats = int((row != want_stats.cpu()).sum())
        stats_diff = max(stats_diff, frame_stats)
        failed += int(frame_px > 0 or frame_stats > 0)
        count_work(probe)
        del probe, want
    for i in extra:
        sc = ref.Scene(world_space=ref.GLTF)
        scene_mod.queue(sc, cell.desc, meshes, materials, cell.pose(i))
        probe = {}
        plain.render(sc, probe)
        count_work(probe)
        del probe
    by_stat = {k: int(run.stats[:, stat_names.index(k)].sum()) for k in DROPS}
    readings = {"px_differing": px, "u8_gap": gap, "stats_differing": stats_diff,
                "dropped_work": dropped, "frames_checked": n_check, "failed": failed,
                "dropped": {k: v for k, v in by_stat.items() if v}}
    return readings, works
