"""Row 6 of apps/configs.py alone: the flythrough mode — 16 frames of the
sandbox scene (camera orbit + animation) a Renderer.render_frames_device
call, on the card one CUDA graph of the frame replayed once a frame — at
1920×1080, 4×MSAA, pair capacity 1<<20. Prints the best of three rounds of
four calls (CUDA events around each round) as fps and ms a frame.

The scene source is `sandbox=` (default: apps.sandbox.Sandbox, which needs
the sandbox assets).

Run: python -m renderer_tpu_torch.tools.flythrough_run [device]
"""

from __future__ import annotations

import sys

from renderer_tpu_torch.apps import configs


def main(sandbox=None, k: int = configs.FLY_BATCH, rounds: int = 3, reps: int = 4,
         device="cuda", **config) -> dict:
    """Returns {"fps", "ms_per_frame", "stats"} (the stats rows of the last
    batch, on the device); `config` overrides the RenderConfig."""
    if sandbox is None:
        from renderer_tpu_torch.apps.sandbox import Sandbox

        sandbox = Sandbox(with_smol_ame=True, device=device)
    renderer, scenes = configs.flythrough_batch(
        sandbox, device, k, **{"pair_capacity": 1 << 20, **config})
    out = list(renderer.render_frames_device(scenes, 0))  # capture + warm-up

    def batch(_):
        out[:] = renderer.render_frames_device(scenes, 0)

    best_ms = min(configs.loop_ms(renderer.device, batch, reps) / k
                  for _ in range(rounds))
    cfg = renderer.config
    print(f"flythrough-batch{k}-{cfg.height}p-msaa{cfg.msaa_samples}: "
          f"{1000.0 / best_ms:.1f} fps ({best_ms:.3f} ms/frame)", flush=True)
    return {"fps": 1000.0 / best_ms, "ms_per_frame": best_ms, "stats": out[1]}


if __name__ == "__main__":
    main(device=sys.argv[1] if len(sys.argv) > 1 else "cuda")
