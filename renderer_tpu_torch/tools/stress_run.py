"""Row 7 of apps/configs.py alone: the >1M-triangle stress field at
1920×1080 (32 patches × 32768 triangles), 20 timed frames after a warm-up
(CUDA events around the loop on the card), then the last frame's device
stats read through Renderer.last_stats and the image written as a PNG.

Run: python -m renderer_tpu_torch.tools.stress_run [frames] [out.png] [device]
"""

from __future__ import annotations

import sys

from renderer_tpu_torch.apps import configs
from renderer_tpu_torch.assets import png
from renderer_tpu_torch.raster.pipeline import STAT_NAMES


def main(frames: int = 20, out_png: str | None = None, device="cuda", **row) -> dict:
    """Times the stress row (configs.stress_row; `row` overrides its sizes
    and config) and returns {"ms_per_frame", "fps", "stats", "image"}."""
    renderer, scene = configs.stress_row(device, **row)
    img, ms = configs.timed_frames(renderer, configs.fixed(scene), 0, int(frames))
    # after the timed loop: the last frame's stats, read from the device
    stats = dict(zip(STAT_NAMES, renderer.last_stats.cpu().tolist()))
    image = img.cpu().numpy()
    print(f"stress-1M-tris-1080p: {ms:.3f} ms/frame = {1000.0 / ms:.1f} fps",
          flush=True)
    print("stats:", stats, flush=True)
    if out_png:
        png.write_png(out_png, image)
    return {"ms_per_frame": ms, "fps": 1000.0 / ms, "stats": stats, "image": image}


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20,
         sys.argv[2] if len(sys.argv) > 2 else "stress_1m.png",
         sys.argv[3] if len(sys.argv) > 3 else "cuda")
