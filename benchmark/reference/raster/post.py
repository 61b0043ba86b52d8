# Frozen copy of renderer_tpu_torch/raster/post.py at commit 5822f29, cut to its
# plain (PyTorch / numpy) path: nothing here launches a hand-written kernel
# or calls the host library. Part of the benchmark's yardstick; do not edit.
"""Post-process pass: exposure + ACES tonemap + sRGB encode (+ MSAA resolve).

Parity: renderer/shaders/glsl/render_res_pp.frag:22-48 — exposure 0.8, ACES
fit clamp(x(2.51x+0.03) / (x(2.43x+0.59)+0.14), 0, 1). The reference writes
to an sRGB swapchain image, so the hardware applies the sRGB OETF after the
shader; it is applied explicitly here before quantizing to u8. MSAA resolve
is AVERAGE mode (render_passes.rs:28-42), i.e. a mean over samples — and in
the reference the resolve happens *after* this tonemap pass (sample-rate
shading runs the post-process per sample, physical_device.rs:265-266), so
the resolve follows the tonemap here too.
"""

from __future__ import annotations

import numpy as np
import torch

EXPOSURE = 0.8


def aces(x: torch.Tensor) -> torch.Tensor:
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def srgb_encode(linear: torch.Tensor) -> torch.Tensor:
    linear = torch.clamp(linear, 0.0, 1.0)
    lo = linear * 12.92
    hi = 1.055 * torch.pow(torch.clamp(linear, min=1e-7), 1.0 / 2.4) - 0.055
    return torch.where(linear <= 0.0031308, lo, hi)


def srgb_decode_np(encoded):
    """Host-side (numpy) sRGB EOTF, for texture preprocessing."""
    encoded = np.asarray(encoded, np.float32)
    lo = encoded / 12.92
    hi = ((encoded + 0.055) / 1.055) ** 2.4
    return np.where(encoded <= 0.04045, lo, hi).astype(np.float32)


def tonemap(hdr_rgb: torch.Tensor) -> torch.Tensor:
    """Linear HDR [..., 3] → display-ready u8 [..., 3]. If a leading samples
    axis is present ([S, H, W, 3]), tonemap per sample then resolve."""
    mapped = aces(hdr_rgb * EXPOSURE)
    if mapped.ndim == 4:
        mapped = torch.mean(mapped, dim=0)
    encoded = srgb_encode(mapped)
    return torch.round(encoded * 255.0).to(torch.uint8)
