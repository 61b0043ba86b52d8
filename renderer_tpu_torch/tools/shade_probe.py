"""Probe of the shading kernels S1 and S2 (csrc/shade.cu) on one NVIDIA GPU.

Builds csrc/shade.cu once for each variant (one constant edited: S1's span
or the minimum blocks an SM of S1's or S2's __launch_bounds__), and, with
`--against DIR`, another version's shade.cu (DIR holds its shade.cu and
shade_common.cuh; the ShadeArgs interface must be the same), in a temporary
directory with renderer_tpu_torch.kernels' flags. It records every S1 and S2 call of one
1920×1080 frame of chip_smoke.py's scenes B and C, and B's S2 calls again
on stacks with every element covered ("B-full", fully_covered), holds each variant's
outputs to the plain versions' bit for bit (NaN at the same values; of the
other version's S2, its covered elements: see held), and
times every variant over the frame's calls in turns (first to last, then
last to first; CUDA events as issued and queued behind a spin kernel),
with each build's registers and spills and, where the source has
rt_shade_info, the blocks an SM its launches assume. With `--against`, it
then replays frames B and C as CUDA graphs on the library's S1 and S2 and
on the other version's, in turns (library, other, other, library): the
whole frame's time on either pair of kernels.

    python3 -m renderer_tpu_torch.tools.shade_probe [--against DIR] [variant ...]

Variants are named in VARIANTS; "library" is the kernel library the port
loads.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import torch

import chip_smoke as cs
import renderer_tpu_torch as trt
from renderer_tpu_torch import kernels
from renderer_tpu_torch.engine import stats as engine_stats
from renderer_tpu_torch.engine.stats import card_line
from renderer_tpu_torch.tools.shade_check import recorded_shading, run_shading

#: name → (constant, value) edited in csrc/shade.cu
VARIANTS = {
    "span1024": ("SPAN", 1024),
    "minblocks1": ("S1_MIN_BLOCKS", 1),
    "minblocks4": ("S1_MIN_BLOCKS", 4),
    "s2minblocks5": ("S2_MIN_BLOCKS", 5),
    "s2minblocks6": ("S2_MIN_BLOCKS", 6),
}
REPS = 10  # runs of a frame's calls a timing


def build(tmp: Path, name: str, src: Path, edit: tuple | None) -> tuple[list, Path, Path]:
    """nvcc command, library and log path of `src` (a shade.cu beside its
    shade_common.cuh) with one constant edited, in a directory of its own."""
    d = tmp / name
    d.mkdir()
    text = src.read_text()
    if edit is not None:
        text, n = re.subn(rf"constexpr int {edit[0]} = \d+;",
                          f"constexpr int {edit[0]} = {edit[1]};", text)
        assert n == 1, f"{edit[0]} not found"
    (d / "shade.cu").write_text(text)
    shutil.copy(src.parent / "shade_common.cuh", d / "shade_common.cuh")
    so, log = d / f"{name}.so", d / f"{name}.log"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(d / "shade.cu")]
    return cmd, so, log


def load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for name, args in kernels._SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def using(lib, names=("rt_shade_stack", "rt_alpha_stack")):
    """Inside the block the wrappers launch `lib`'s entry points `names`
    (S1 and S2 by default); every other kernel stays the library's."""
    base = kernels.load()
    mixed = types.SimpleNamespace(**{n: getattr(base, n) for n in kernels._SIGNATURES})
    for name in names:
        setattr(mixed, name, getattr(lib, name))
    original = kernels.load
    kernels.load = lambda: mixed
    try:
        yield
    finally:
        kernels.load = original


def info(lib, kind: str, kw: dict) -> dict | None:
    if not hasattr(lib, "rt_shade_info"):
        return None
    out = (ctypes.c_longlong * len(kernels.SHADE_INFO))()
    bf16 = int(kw["compute_dtype"] == torch.bfloat16)
    err = lib.rt_shade_info(1 if kind == "S1" else 2, bf16, int(kw["srgb_per_tap"]), out)
    kernels.check_launch("rt_shade_info", err)
    return dict(zip(kernels.SHADE_INFO, (int(v) for v in out)))


def differing(got: tuple, want: tuple) -> int:
    """Values whose bits differ (NaN at the same values counts as equal)."""
    n = 0
    for g, w in zip(got, want, strict=True):
        nan = torch.isnan(w)
        if not torch.equal(torch.isnan(g), nan):
            return -1
        n += int(((g.view(torch.int32) != w.view(torch.int32)) & ~nan).sum())
    return n


def fully_covered(tid: torch.Tensor) -> torch.Tensor:
    """A candidate stack with every element covered: an uncovered element
    takes the largest id its pixel holds in any plane (triangle 0 where it
    holds none, as a kernel that shades every element shades there)."""
    top = tid.amax(0, keepdim=True).clamp(min=0).expand_as(tid)
    return torch.where(tid >= 0, tid, top).contiguous()


def held(name: str, kind: str, args: tuple, out: tuple) -> tuple:
    """The outputs of build `name` that are held to the plain version: all
    of them, but of another version's S2 (--against) its covered elements
    alone, since a version that shades every element gives the uncovered
    ones values that no later step reads, where alpha_stack_plain gives +0."""
    if name != "against" or kind != "S2":
        return out
    return tuple(torch.where(args[0] >= 0, t, 0.0) for t in out)


def scene_calls(dev) -> dict:
    """{scene: recorded calls} of one 1920×1080 frame of scenes B and C, and
    B's S2 calls on fully covered stacks ("B-full")."""
    reg_b, sc_b, cfg_b, pol_b = cs.scene_b()
    frames_c, cfg_c, pol_c = cs.scene_c()
    rb = trt.Renderer(reg_b, cfg_b, overflow_policy=pol_b, device=dev)
    rc = trt.Renderer(frames_c.registry, cfg_c, profiler=frames_c.profiler,
                      overflow_policy=pol_c, device=dev)
    sc_c, ui_c = frames_c.next()
    out = {}
    for name, r, sc, ui in (("B", rb, sc_b, None), ("C", rc, sc_c, ui_c)):
        r.render_frame_device(sc, 0, ui=ui)  # grows the capacities
        with recorded_shading() as calls:
            r.render_frame_device(sc, 0, ui=ui)
        out[name] = [c for c in calls if c[0] in ("S1", "S2")]
    out["B-full"] = [(kind, (fully_covered(args[0]), *args[1:]), kw)
                     for kind, args, kw in out["B"] if kind == "S2"]
    torch.cuda.synchronize()
    return out


def replayed_frames(dev) -> dict:
    """{scene: median ms of a replay of the frame's CUDA graph} of scenes B
    and C (engine.stats.fused_frame_ms; fresh renderers, since a renderer
    keeps the graph it captured)."""
    reg_b, sc_b, cfg_b, pol_b = cs.scene_b()
    frames_c, cfg_c, pol_c = cs.scene_c()
    sc_c, _ui = frames_c.next()
    out = {}
    for name, reg, sc, cfg, pol in (("B", reg_b, sc_b, cfg_b, pol_b),
                                    ("C", frames_c.registry, sc_c, cfg_c, pol_c)):
        r = trt.Renderer(reg, cfg, overflow_policy=pol, device=dev)
        r.render_frame_device(sc, 0)  # grows the capacities
        r.render_frame_device(sc, 0)
        out[name] = engine_stats.fused_frame_ms(r, sc, iters=cs.REPLAYS)
    torch.cuda.synchronize()
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("shade_probe: torch.cuda.is_available() is False")
    against = None
    if argv[:1] == ["--against"]:
        against, argv = Path(argv[1]), argv[2:]
    names = argv or list(VARIANTS)
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    libs = {"library": kernels.load()}
    reports = {"library": kernels.ptxas_report()}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        todo = [(n, kernels.CSRC / "shade.cu", VARIANTS[n]) for n in names]
        if against is not None:
            todo.append(("against", against / "shade.cu", None))
        t0 = time.perf_counter()
        builds = [build(tmp, n, src, edit) for n, src, edit in todo]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd, _, _ in builds]
        for (n, _, _), (cmd, so, log), proc in zip(todo, builds, procs):
            text = proc.communicate()[0]
            log.write_text(text)
            if proc.returncode != 0:
                raise RuntimeError(f"{n}: nvcc failed\n{text[-4000:]}")
            libs[n] = load(so)
            reports[n] = kernels.ptxas_report(log)
        print(f"probe: built {len(todo)} variants in {time.perf_counter() - t0:.1f} s",
              flush=True)
        order = list(libs)
        for scene, calls in scene_calls(dev).items():
            for kind in ("S1", "S2"):
                mine = [(a, k) for c, a, k in calls if c == kind]
                if not mine:
                    continue
                plain = [run_shading(kind, a, k, plain=True) for a, k in mine]
                torch.cuda.synchronize()
                times = {n: [] for n in order}
                for n in order:
                    with using(libs[n]):
                        diff = sum(differing(held(n, kind, a, run_shading(kind, a, k, plain=False)),
                                             w) for (a, k), w in zip(mine, plain))
                    if diff != 0:
                        raise RuntimeError(f"{n}: {kind} on {scene}: {diff} values differ")

                def run(mine=mine, kind=kind):
                    for a, k in mine:
                        run_shading(kind, a, k, plain=False)

                for n in order + order[::-1]:
                    with using(libs[n]):
                        times[n].append((cs.cuda_ms(run, REPS),
                                         cs.queued_ms(run, REPS, engine_stats.SPIN_CYCLES)))
                for n in order:
                    occ = info(libs[n], kind, mine[0][1])
                    print(f"probe: {scene} {kind} ({len(mine)} calls) {n}: ms "
                          + " / ".join(f"{a:.3f} ({q:.3f})" for a, q in times[n])
                          + f" | {occ} | {card}", flush=True)
                del plain
        if against is not None:  # the whole frame on either S1 and S2, in turns
            frames = {"library": [], "against": []}
            for n in ("library", "against", "against", "library"):
                with using(libs[n]):
                    frames[n].append(replayed_frames(dev))
            for n, runs in frames.items():
                print(f"probe: replayed frames on {n}'s S1 and S2: "
                      + " / ".join(", ".join(f"{k} {v:.2f} ms" for k, v in run.items())
                                   for run in runs) + f" | {card}", flush=True)
    for n, rep in reports.items():
        short = {k: v for k, v in rep.items() if "shade_kernel" in k or "alpha_kernel" in k}
        print(f"probe: ptxas {n}: {short}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
