"""Startup measurement: one JSON line of the stages a session pays before
its first frame, on the asset the repository carries (the loader fixture
tests/fixtures/strided.gltf):

- torch_import_s / package_import_s: `import torch`, then `import
  renderer_tpu_torch`, in a fresh interpreter;
- cuda_init_s: the card's context, made by its first tensor (null on the
  CPU);
- kernel_build_s: kernels.load() on the card. "cold" builds the library
  into an empty temporary directory that the probe points kernels.BUILD_DIR
  at; "warm" loads the one under build/kernels/ (building it only if it is
  missing; nvcc_s, the set-up span setup.nvcc, is then 0.0). Null on the
  CPU;
- load_gltf_s: load_gltf of the fixture (parse, accessors, the embedded
  texture decode) and the vertex library build;
- atlas_s: build_atlas_plan and realize_atlas of its registry, synced;
- first_frame_s: a Renderer at 1280×720 and its first frame, synced.

Run one cold and one warm probe, each in a process of its own:
  python -m renderer_tpu_torch.tools.startup_probe cold
  python -m renderer_tpu_torch.tools.startup_probe warm [device]
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FIXTURE = ROOT / "tests" / "fixtures" / "strided.gltf"
_IMPORTS = ("import time\nt0 = time.perf_counter()\nimport torch\n"
            "t1 = time.perf_counter()\nimport renderer_tpu_torch\n"
            "print(t1 - t0, time.perf_counter() - t1)\n")


def main(mode: str = "warm", device="cuda", width: int = 1280,
         height: int = 720) -> dict:
    if mode not in ("cold", "warm"):
        raise ValueError(f"startup_probe: mode {mode!r} is not cold or warm")
    child = subprocess.run([sys.executable, "-c", _IMPORTS], capture_output=True,
                           text=True, cwd=ROOT, timeout=600, check=True)
    torch_s, package_s = (float(v) for v in child.stdout.split())

    import numpy as np
    import torch

    import renderer_tpu_torch as rt
    from renderer_tpu_torch import kernels
    from renderer_tpu_torch.core import math3d
    from renderer_tpu_torch.engine import profiling
    from renderer_tpu_torch.interop import resolve_device
    from renderer_tpu_torch.materials import atlas_device

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    out = {"mode": mode, "torch_import_s": torch_s, "package_import_s": package_s,
           "cuda_init_s": None, "kernel_build_s": None, "nvcc_s": None}
    with tempfile.TemporaryDirectory() as tmp:
        if dev.type == "cuda":
            t0 = time.perf_counter()
            torch.zeros(1, device=dev)
            sync()
            out["cuda_init_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            if mode == "cold":
                if kernels._lib is not None:
                    raise RuntimeError("startup_probe cold: this process has "
                                       "already loaded the kernels")
                default_dir, kernels.BUILD_DIR = kernels.BUILD_DIR, Path(tmp)
                try:
                    kernels.load()
                finally:
                    kernels.BUILD_DIR = default_dir
            else:
                kernels.load()
            out["kernel_build_s"] = time.perf_counter() - t0
            out["nvcc_s"] = profiling.setup_seconds("setup.nvcc")

        t0 = time.perf_counter()
        registry, builder = rt.MaterialRegistry(), rt.VertexLibraryBuilder()
        gltf = rt.load_gltf(FIXTURE, builder, registry, device=dev)
        builder.build()
        out["load_gltf_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        atlas_device.realize_atlas(atlas_device.build_atlas_plan(registry), dev)
        sync()
        out["atlas_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        renderer = rt.Renderer(registry, rt.RenderConfig(width=width, height=height),
                               overflow_policy="off", device=dev)
        scene = rt.Scene(world_space=rt.GLTF)
        scene.camera.position, scene.camera.orientation = math3d.look_at(
            np.array([0.3, 1.2, 4.0], np.float32), np.array([0.3, 0.5, 0.0], np.float32),
            np.array([0.0, 1.0, 0.0], np.float32))
        gltf.queue_animated(scene, math3d.IDENTITY,
                            [(0.7 % a.end_time, a) for a in gltf.animations])
        renderer.render_frame_device(scene)
        sync()
        out["first_frame_s"] = time.perf_counter() - t0
    stages = ("torch_import_s", "package_import_s", "cuda_init_s", "kernel_build_s",
              "load_gltf_s", "atlas_s", "first_frame_s")
    out["total_s"] = sum(out[k] or 0.0 for k in stages)
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out["resolution"] = [width, height]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "warm",
         sys.argv[2] if len(sys.argv) > 2 else "cuda")
