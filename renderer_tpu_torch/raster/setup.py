"""Triangle setup: clip space → raster planes (clipless homogeneous).

Replaces the fixed-function triangle setup / primitive assembly / near-plane
clipping stages of the Vulkan pipeline. Instead of geometric clipping,
triangles are set up in 2D homogeneous form (Olano–Greer): with
pixel-scaled clip vertices u_i = (X_i, Y_i, w_i), the three edge functions
are the plane equations n_i = u_j × u_k evaluated at p = (px, py, 1). This is
exact for triangles crossing the w = 0 plane (no vertex splitting needed);
the Vulkan depth-range clip z ∈ [0, 1] then performs the near clip
(reverse-Z sends closer-than-near to z > 1), and a 1/w > 0 plane test
discards the anti-triangle branch.

Behavior parity:
- Viewport transform to framebuffer coords, origin upper-left, +Y down.
- Back-face culling: CCW front (pipelines.rs:147-158) ⟺ negative y-down
  shoelace ⟺ after the v1/v2 swap det(u0,u1,u2) > 0.
- Depth = z_clip/w (reverse-Z), screen-linear → one plane, no per-pixel
  divide.

A per-triangle epsilon plus the top-left ownership rule in the kernels makes
shared mesh edges watertight. The eps band is PRE-FOLDED into each edge's C
coefficient (C' = C + eps if the edge owns its boundary — a > 0, or
a == 0 ∧ b > 0 — else C − eps), so the kernels' coverage test is
`e' > 0 | (own ∧ e' ≥ 0)` with own recomputed from the stored A, B signs,
and the binned buffer keeps 16 rows (binning.KEEP_ROWS).

Output layout: one [ROWS=24, Tc] f32 SoA tensor; rows:
  0-8  : A0 B0 C0' A1 B1 C1' A2 B2 C2' (edge planes, C pre-shifted by ±eps)
  9-11 : z_a z_b z_c                 (NDC depth plane, z = z·px + …)
  12-14: w_a w_b w_c                 (1/w plane; visible side = positive)
  15-18: bbox xmin ymin xmax ymax    (consumed by binning only)
  19   : valid (1.0 / 0.0)
  20   : original triangle id (written by binning)
  21   : eps (the folded coverage tolerance, for introspection/tests)
  22-23: reserved / padding

`triangle_setup` dispatches on the device as raster/candidates.py does:
CPU tensors run `triangle_setup_plain` (the JAX package's setup, op for
op); CUDA tensors launch kernel F1 (csrc/frontend.cu `setup_kernel`, for
the JAX package's XLA-fused renderer_tpu/raster/setup.py:57), bit-equal to
the plain version on the card, or raise.
"""

from __future__ import annotations

import ctypes

import torch

from renderer_tpu_torch import kernels
from renderer_tpu_torch.engine import profiling
from renderer_tpu_torch.raster.shade import check_tensor

W_EPS = 1e-6
ROWS = 24
VALID_ROW = 19
TID_ROW = 20
EPS_ROW = 21
BBOX_ROWS = (15, 16, 17, 18)

#: triangles a block of F1 takes, a triangle a thread (csrc/frontend.cu
#: SETUP_THREADS): the card tests put triangle counts and num_tris at and
#: around its multiples
TILE = 128

#: F1's launch counter in profiling.COUNTERS; the plain version does not
#: count
LAUNCHES = ("setup",)
profiling.register_launches(LAUNCHES)


def count_arg(v, device: torch.device, what: str) -> tuple[int, int, int]:
    """A count (a Python integer or a one-element int32 / int64 tensor) as
    the front-end kernels take it: (pointer, value, is64) — a tensor on
    `device` by its pointer (the kernel reads it, the host never waits), a
    number or a CPU tensor by its value (pointer 0)."""
    if not isinstance(v, torch.Tensor):
        return 0, int(v), 0
    if v.numel() != 1 or v.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what} must be one int32 or int64 value, got {v.dtype} "
                         f"{tuple(v.shape)}")
    if v.device.type == "cpu":
        return 0, int(v), 0
    if v.device != device:
        raise ValueError(f"{what} is on {v.device}, not {device}")
    return v.data_ptr(), 0, int(v.dtype == torch.int64)


def triangle_setup(
    clip: torch.Tensor,  # [VE,4]
    tri_v: torch.Tensor,  # [Tc,3] i32 expanded-vertex ids
    num_tris,  # i32 scalar — triangles at index ≥ num_tris are invalid
    width: int,
    height: int,
    bbox_pad: float = 0.0,
    double_sided: bool = False,
) -> torch.Tensor:
    """The [ROWS, Tc] f32 SoA of the triangles tri_v over the clip-space
    vertices clip (triangle_setup_plain). CPU tensors run the plain version;
    CUDA tensors launch F1 (clip f32 [VE, 4], tri_v i32 [Tc, 3]; num_tris
    a number or an int32 / int64 value, on the device or the CPU) and raise
    ValueError on other inputs, a clip whose data is not 16-byte aligned
    among them (F1 reads a vertex's row in one 16-byte load; a contiguous
    [VE, 4] tensor of its own is aligned, a view may not be)."""
    if clip.device.type == "cpu":
        return triangle_setup_plain(clip, tri_v, num_tris, width, height,
                                    bbox_pad=bbox_pad, double_sided=double_sided)
    dev = clip.device
    clip, tri_v = clip.contiguous(), tri_v.contiguous()
    check_tensor("clip", clip, torch.float32, (None, 4), dev)
    check_tensor("tri_v", tri_v, torch.int32, (None, 3), dev)
    tc = tri_v.shape[0]
    if tc and not clip.shape[0]:
        raise ValueError("triangle_setup: triangles over no vertices")
    num_ptr, num_value, num_is64 = count_arg(num_tris, dev, "num_tris")
    if dev.type != "cuda":
        raise ValueError(f"triangle_setup: unsupported device {dev}")
    if clip.data_ptr() % 16:
        raise ValueError(f"triangle_setup: clip's data at {clip.data_ptr():#x} is not "
                         "16-byte aligned (F1 loads a vertex's row in 16 bytes)")
    out = torch.empty((ROWS, tc), dtype=torch.float32, device=dev)
    lib = kernels.load()
    with torch.cuda.device(dev):
        err = lib.rt_setup(clip.data_ptr(), tri_v.data_ptr(), num_ptr, num_value, num_is64,
                           out.data_ptr(), tc, clip.shape[0], float(width), float(height),
                           float(bbox_pad), float(max(width, height)), int(double_sided),
                           kernels.current_stream())
    kernels.check_launch("triangle_setup", err)
    profiling.count("setup")
    return out


def setup_launch(tc: int, double_sided: bool = False) -> dict:
    """F1's launch for tc triangles on the current CUDA device: "grid", its
    blocks (TILE triangles a block), and "resident", the blocks of F1 the
    device holds at once (asked of the runtime)."""
    out = (ctypes.c_longlong * 2)()
    kernels.check_launch("setup_launch", kernels.load().rt_setup_launch(
        tc, int(double_sided), out))
    return {"grid": int(out[0]), "resident": int(out[1])}


def triangle_setup_plain(
    clip: torch.Tensor,  # [VE,4]
    tri_v: torch.Tensor,  # [Tc,3] i32 expanded-vertex ids
    num_tris,  # i32 scalar — triangles at index ≥ num_tris are invalid
    width: int,
    height: int,
    bbox_pad: float = 0.0,  # grown bbox (binning stays conservative for MSAA)
    double_sided: bool = False,  # no back-face cull (the ImGui pipeline,
    # pipeline_parameters.rs IMGUI double_sided=true): back-facing triangles
    # get their edge planes negated so the inside test still holds
) -> torch.Tensor:
    tc = tri_v.shape[0]
    c = clip[tri_v.long()]  # [Tc,3,4]

    # pixel-scaled homogeneous coords: screen = (X/W, Y/W)
    xs = (c[:, :, 0] * 0.5 + c[:, :, 3] * 0.5) * width  # [Tc,3]
    ys = (c[:, :, 1] * 0.5 + c[:, :, 3] * 0.5) * height
    ws = c[:, :, 3]
    zs = c[:, :, 2]

    # Swap v1↔v2 so front faces (Vulkan CCW, negative y-down shoelace) get
    # det > 0.
    order = (0, 2, 1)
    x0, x1, x2 = (xs[:, i] for i in order)
    y0, y1, y2 = (ys[:, i] for i in order)
    w0, w1, w2 = (ws[:, i] for i in order)
    z0, z1, z2 = (zs[:, i] for i in order)

    def cross(xa, ya, wa, xb, yb, wb):
        return (
            ya * wb - wa * yb,  # A (coefficient of px)
            wa * xb - xa * wb,  # B (coefficient of py)
            xa * yb - ya * xb,  # C
        )

    a0, b0, c0 = cross(x1, y1, w1, x2, y2, w2)  # opposite v0
    a1, b1, c1 = cross(x2, y2, w2, x0, y0, w0)  # opposite v1
    a2, b2, c2 = cross(x0, y0, w0, x1, y1, w1)  # opposite v2

    det = a0 * x0 + b0 * y0 + c0 * w0
    if double_sided:
        flip = torch.where(det < 0.0, -1.0, 1.0)
        a0, b0, c0 = a0 * flip, b0 * flip, c0 * flip
        a1, b1, c1 = a1 * flip, b1 * flip, c1 * flip
        a2, b2, c2 = a2 * flip, b2 * flip, c2 * flip
        det = det * flip
    front = det > 0.0
    one = torch.ones_like(det)
    inv_det = torch.reciprocal(torch.where(front, det, one))

    # attribute planes: f/w(p) = (Σ f_i · n_i / det) · p
    w_a = (a0 + a1 + a2) * inv_det
    w_b = (b0 + b1 + b2) * inv_det
    w_c = (c0 + c1 + c2) * inv_det

    all_front = torch.all(ws > W_EPS, dim=1)
    inv_w = torch.reciprocal(torch.where(torch.abs(ws) > W_EPS, ws,
                                         torch.ones_like(ws)))
    px = xs * inv_w
    py = ys * inv_w

    # Depth plane. The homogeneous form Σ z_i·n_i/det loses ~7 bits to
    # cancellation (big adjugate products); for the common all-in-front case
    # the difference-based screen-space derivation keeps exact ties for
    # coplanar geometry (reference depth-tie parity). The homogeneous form
    # is only used for near-plane-crossing triangles.
    sz = zs * inv_w
    sx0, sx1, sx2 = (px[:, i] for i in order)
    sy0, sy1, sy2 = (py[:, i] for i in order)
    sz0, sz1, sz2 = (sz[:, i] for i in order)
    area2 = (sx1 - sx0) * (sy2 - sy0) - (sy1 - sy0) * (sx2 - sx0)
    inv_area = torch.reciprocal(torch.where(torch.abs(area2) > 1e-20, area2, one))
    zss_a = ((sz1 - sz0) * (sy2 - sy0) - (sz2 - sz0) * (sy1 - sy0)) * inv_area
    zss_b = ((sz2 - sz0) * (sx1 - sx0) - (sz1 - sz0) * (sx2 - sx0)) * inv_area
    zss_c = sz0 - zss_a * sx0 - zss_b * sy0
    z_a = torch.where(all_front, zss_a, (z0 * a0 + z1 * a1 + z2 * a2) * inv_det)
    z_b = torch.where(all_front, zss_b, (z0 * b0 + z1 * b1 + z2 * b2) * inv_det)
    z_c = torch.where(all_front, zss_c, (z0 * c0 + z1 * c1 + z2 * c2) * inv_det)

    # Screen bbox: exact from projected vertices when fully in front of the
    # eye; conservative full-screen when crossing w = 0 (rare, the kernel's
    # edge tests prune).
    def full(v):
        return torch.full_like(det, v)

    xmin = torch.where(all_front, torch.amin(px, dim=1) - bbox_pad, full(0.0))
    xmax = torch.where(all_front, torch.amax(px, dim=1) + bbox_pad,
                       full(float(width)))
    ymin = torch.where(all_front, torch.amin(py, dim=1) - bbox_pad, full(0.0))
    ymax = torch.where(all_front, torch.amax(py, dim=1) + bbox_pad,
                       full(float(height)))
    on_screen = (xmax >= 0.0) & (xmin <= width) & (ymax >= 0.0) & (ymin <= height)

    # f32 evaluation tolerance for e = A·px + B·py + C.
    maxdim = float(max(width, height))
    abs_c = torch.maximum(torch.abs(c0), torch.maximum(torch.abs(c1), torch.abs(c2)))
    abs_ab = torch.maximum(
        torch.maximum(torch.abs(a0), torch.abs(b0)),
        torch.maximum(
            torch.maximum(torch.abs(a1), torch.abs(b1)),
            torch.maximum(torch.abs(a2), torch.abs(b2)),
        ),
    )
    eps = 4.0 * 2.0**-23 * (abs_c + maxdim * abs_ab)

    # Pre-fold the watertightness band into C (see module docstring): the
    # owning edge's boundary moves +eps (inclusive via e' ≥ 0), the
    # non-owning edge's −eps (exclusive via e' > 0).
    def shift(a, b, c):
        own = (a > 0.0) | ((a == 0.0) & (b > 0.0))
        return c + torch.where(own, eps, -eps)

    c0 = shift(a0, b0, c0)
    c1 = shift(a1, b1, c1)
    c2 = shift(a2, b2, c2)

    any_front = torch.any(ws > W_EPS, dim=1)
    in_range = torch.arange(tc, dtype=torch.int32, device=clip.device) < num_tris
    valid = in_range & front & any_front & on_screen
    validf = valid.to(torch.float32)

    zero = torch.zeros_like(validf)
    rows = [a0, b0, c0, a1, b1, c1, a2, b2, c2,
            z_a, z_b, z_c, w_a, w_b, w_c,
            xmin, ymin, xmax, ymax, validf, zero, eps, zero, zero]
    tri_data = torch.stack(rows, dim=0)  # [ROWS,Tc]
    # Zero out invalid columns so padded/culled triangles can never rasterize
    # even if a later stage skips the valid row.
    return torch.where(valid[None, :], tri_data, torch.zeros_like(tri_data))
