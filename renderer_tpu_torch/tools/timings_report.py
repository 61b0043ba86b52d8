"""Print the per-stage device timing table of one 1920×1080 frame.

Runs engine.stats.device_stage_timings (CUDA events, the median of 20
runs a stage) at both of its paces — device time (the stage captured as a
CUDA graph, replays queued behind a spin kernel) and host-paced (eager runs
as the host issues them) — on the sandbox scene (Sponza + Smol Ame, from
$RENDERER_TPU_ASSETS) or, with `walls`, on the asset-free all-classes scene
at Sponza scale (demo_scenes.patch_wall_scene, chip_smoke.py's scene B).
One "sync" frame first grows the bin capacities and layer counts to the
scene's demand, so the stages run at the frame's own config. The header
names the card and its power limit.

Usage: python -m renderer_tpu_torch.tools.timings_report [msaa]
       [pair_capacity] [bf16] [walls]
(defaults: msaa4, pair_capacity 1<<20; `bf16` also times the fused frame
with bf16 shading). Needs CUDA; without it, it exits with an error.
"""

from __future__ import annotations

import sys
import time
from dataclasses import replace

import torch

import renderer_tpu_torch as rt
from renderer_tpu_torch.engine import stats


def main():
    if not torch.cuda.is_available():
        raise SystemExit("timings_report: torch.cuda.is_available() is False")
    numbers = [a for a in sys.argv[1:] if a.isdigit()]
    msaa = int(numbers[0]) if numbers else 4
    pair_cap = int(numbers[1]) if len(numbers) > 1 else 1 << 20
    config = rt.RenderConfig(width=1920, height=1080, msaa_samples=msaa,
                             pair_capacity=pair_cap).validate()
    if "walls" in sys.argv[1:]:
        from renderer_tpu_torch.assets import demo_scenes

        registry, scene = demo_scenes.patch_wall_scene()
        name = "all-classes walls (301,056 triangles)"
    else:
        from renderer_tpu_torch.apps.sandbox import Sandbox

        sb = Sandbox(with_smol_ame=True)
        registry, scene = sb.registry, sb.build_scene(1.0)
        name = "sandbox (Sponza + Smol Ame)"
    renderer = rt.Renderer(registry, config, overflow_policy="sync")
    renderer.render_frame(scene)  # grow the capacities, build the kernels
    t0 = time.time()
    timings = stats.device_stage_timings(renderer, scene, iters=20)
    host_paced = stats.device_stage_timings(renderer, scene, iters=20, paced="host")
    if "bf16" in sys.argv[1:]:
        r16 = rt.Renderer(registry, replace(renderer.config, bf16_shading=True),
                          overflow_policy="off")
        timings[f"FULL FRAME (fused, msaa{msaa}, bf16 shading)"] = (
            stats.fused_frame_ms(r16, scene, iters=20))
    print(f"# {name}, 1920x1080 msaa{msaa}, {stats.card_line()}; "
          f"measured in {time.time() - t0:.0f}s wall", flush=True)
    print("| stage | device µs | host-paced µs |")
    print("|---|---|---|")
    for k, v in timings.items():
        paced = f"{host_paced[k] * 1e3:.0f}" if k in host_paced else ""
        print(f"| {k} | {v * 1e3:.0f} | {paced} |")
    total = {name: sum(v for k, v in t.items() if not k.startswith("FULL"))
             for name, t in (("device", timings), ("host", host_paced))}
    print(f"| sum (staged; the fused frame overlaps these) | "
          f"{total['device'] * 1e3:.0f} | {total['host'] * 1e3:.0f} |")

if __name__ == "__main__":
    main()
