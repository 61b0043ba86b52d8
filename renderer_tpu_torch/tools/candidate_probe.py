"""Probe of the masked merge C2 (csrc/candidates.cu `rt_masked_merge`) on
one NVIDIA GPU.

Builds csrc/candidates.cu once for each variant (constants edited, as
named in VARIANTS) and, with `--against FILE`, another version's
candidates.cu (its rt_masked_merge must take the same arguments), each in
a temporary directory with renderer_tpu_torch.kernels' flags. It records
the C2 call of one 1920×1080 frame of chip_smoke.py's scenes B and C,
holds every build's outputs to masked_merge_plain bit for bit (NaN at the
same values), and times the builds in turns (first to last, then last to
first; CUDA events as issued and queued behind a spin kernel) beside the
call's bound (chip_smoke.candidate_work), with each build's registers,
spills and static shared bytes from ptxas and, for the library, its
launch: threads a block, dynamic shared bytes, blocks an SM, grid
(kernels.merge_info). The parent commit's C2 against the library, in one
run (build/ is git-ignored; the file goes with the repository to the
card's machine):

    git show HEAD~1:renderer_tpu_torch/csrc/candidates.cu > build/parent.cu
    python3 -m renderer_tpu_torch.tools.candidate_probe --against build/parent.cu [variant ...]

"library" is the kernel library the port loads.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

import chip_smoke as cs
import renderer_tpu_torch as trt
from renderer_tpu_torch import kernels
from renderer_tpu_torch.engine import stats as engine_stats
from renderer_tpu_torch.engine.stats import card_line
from renderer_tpu_torch.raster import candidates
from renderer_tpu_torch.tools import candidate_check
from renderer_tpu_torch.tools.shade_probe import load, using

#: name → the constants of csrc/candidates.cu it edits, with their values
VARIANTS = {
    "stages2": (("C2_STAGES", "2"),),
    "warps4": (("C2_WARPS", "4"),),
    "chunk4": (("C2_CHUNK", "4"),),
    "gather2": (("C2_GATHER", "2"),),
}
REPS = 20  # C2 calls a timing


def build(tmp: Path, name: str, src: Path, edits: tuple) -> tuple[list, Path, Path]:
    """nvcc command, library and log path of `src` with some constants
    edited, in a directory of its own."""
    d = tmp / name
    d.mkdir()
    text = src.read_text()
    for const, value in edits:
        text, n = re.subn(rf"constexpr int {const} = [^;]+;",
                          f"constexpr int {const} = {value};", text)
        assert n == 1, f"{const} not found"
    (d / "candidates.cu").write_text(text)
    so, log = d / f"{name}.so", d / f"{name}.log"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
           str(d / "candidates.cu")]
    return cmd, so, log


def merge_calls(dev) -> dict:
    """{scene: (args, kwargs)} of the C2 call of one 1920×1080 frame of
    scenes B and C (the second frame: the first grows the capacities)."""
    reg_b, sc_b, cfg_b, pol_b = cs.scene_b()
    frames_c, cfg_c, pol_c = cs.scene_c()
    rb = trt.Renderer(reg_b, cfg_b, overflow_policy=pol_b, device=dev)
    rc = trt.Renderer(frames_c.registry, cfg_c, profiler=frames_c.profiler,
                      overflow_policy=pol_c, device=dev)
    sc_c, ui_c = frames_c.next()
    out = {}
    for name, r, sc, ui in (("B", rb, sc_b, None), ("C", rc, sc_c, ui_c)):
        r.render_frame_device(sc, 0, ui=ui)
        with candidate_check.recorded_candidates() as calls:
            r.render_frame_device(sc, 0, ui=ui)
        (args, kw), = [(a, k) for c, a, k in calls if c == "C2"]
        out[name] = (args, kw)
    torch.cuda.synchronize()
    return out


def merge_resources(report: dict) -> dict:
    """{candidates of the instantiation (NC): (registers, spill bytes
    stored, spill bytes loaded, static shared bytes)} of the C2 kernels
    in one build's ptxas report."""
    out = {}
    for name, v in report.items():
        m = re.search(r"12merge_kernelILi(\d+)E", name)
        if m:
            out[int(m.group(1))] = (v["registers"], v["spill_stores"], v["spill_loads"],
                                    v["shared"])
    return dict(sorted(out.items()))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("candidate_probe: torch.cuda.is_available() is False")
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
        todo = [(n, kernels.CSRC / "candidates.cu", VARIANTS[n]) for n in names]
        if against is not None:
            todo.append(("against", against, ()))
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
        for scene, (args, kw) in merge_calls(dev).items():
            lt, cands = args[0], args[2]
            n_s, k, h, w = lt.shape
            want = candidate_check.run_candidates("C2", args, kw, plain=True)
            for n in order:
                with using(libs[n], ("rt_masked_merge",)):
                    got = candidate_check.run_candidates("C2", args, kw, plain=False)
                diff = candidate_check.compare(got, want)["differing"]
                if diff != 0:
                    raise RuntimeError(f"{n}: C2 on {scene}: {diff} values differ")
            del got, want
            # the in-place tensors copied once; a repeated merge stores the same values
            work = tuple(a.clone() if i in (5, 6, 7) else a for i, a in enumerate(args))

            def run(work=work):
                candidates.masked_merge(*work)

            times = {n: [] for n in order}
            for n in order + order[::-1]:
                with using(libs[n], ("rt_masked_merge",)):
                    times[n].append((cs.cuda_ms(run, REPS),
                                     cs.queued_ms(run, REPS, engine_stats.SPIN_CYCLES)))
            _, n_bytes = cs.candidate_work("C2", args, kw)
            bound = n_bytes / cs.BYTES_PER_S * 1e3
            info = kernels.merge_info(n_s, k, cands.shape[0], h * w)
            print(f"probe: scene {scene} C2 {tuple(lt.shape)}, {cands.shape[0]} candidates: "
                  f"bound {bound:.4f} ms ({n_bytes / 1e6:.1f} MB); library launch {info} "
                  f"| {card}", flush=True)
            for n in order:
                queued = sum(t for _, t in times[n]) / len(times[n])
                print(f"probe: scene {scene} C2 {n}: ms "
                      + " / ".join(f"{a:.4f} ({t:.4f})" for a, t in times[n])
                      + f"; share of the bound {bound / queued:.1%} (mean queued) | {card}",
                      flush=True)
    for n, rep in reports.items():
        print(f"probe: ptxas {n} (NC: registers, spill stores, spill loads, static shared "
              f"bytes): {merge_resources(rep)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
