# Frozen copy of renderer_tpu_torch/geometry/quantize.py at commit 5822f29, cut to its
# plain (PyTorch / numpy) path: nothing here launches a hand-written kernel
# or calls the host library. Part of the benchmark's yardstick; do not edit.
"""Vertex attribute quantization, bit-for-bit parity with the reference.

The reference quantizes CPU-side into the vertex buffers and the GPU's vertex
fetch dequantizes (reference: renderer/src/renderer/pipeline_parameters/
vertex_buffers.rs:76-179). Here we quantize and immediately dequantize at
scene-build time, so the device arrays hold f32 values that are exactly the
representable quantized values — same precision behavior, no on-device unpack.

Formats:
  position  f32x3 -> f16x3
  texcoord  f32x2 -> f16x2
  normal    f32x3 -> A2B10G10R10_SNORM (10-bit snorm xyz)
  tangent   f32x4 -> A2B10G10R10_SNORM (10-bit snorm xyz + 2-bit snorm w)
  weights   f32x4 -> u8x4 unorm (truncating, `(f * 255.0) as u8`)
  joints    u8x4  -> u8x4 (passthrough)
"""

from __future__ import annotations

import numpy as np


def quantize_f16(x: np.ndarray) -> np.ndarray:
    """f32 -> f16 -> f32 round trip (positions, uvs)."""
    return np.asarray(x, dtype=np.float32).astype(np.float16).astype(np.float32)


def _pack_snorm(x: np.ndarray, bits: int) -> np.ndarray:
    """`pack<N>` parity (vertex_buffers.rs:107-112): (max * clamp(f,-1,1)) as
    i32 — Rust's `as i32` truncates toward zero."""
    max_val = float(2 ** (bits - 1) - 1)
    scaled = max_val * np.clip(np.asarray(x, dtype=np.float32), -1.0, 1.0)
    return np.trunc(scaled).astype(np.int32)


def _unpack_snorm(i: np.ndarray, bits: int) -> np.ndarray:
    """Vulkan SNORM decode: clamp(int / max, -1, 1)."""
    max_val = float(2 ** (bits - 1) - 1)
    return np.clip(i.astype(np.float32) / max_val, -1.0, 1.0)


def quantize_snorm10(x: np.ndarray) -> np.ndarray:
    """f32 -> 10-bit snorm -> f32 (normal xyz, tangent xyz)."""
    return _unpack_snorm(_pack_snorm(x, 10), 10)


def quantize_snorm2(x: np.ndarray) -> np.ndarray:
    """f32 -> 2-bit snorm -> f32 (tangent w / bitangent sign)."""
    return _unpack_snorm(_pack_snorm(x, 2), 2)


def quantize_unorm8(x: np.ndarray) -> np.ndarray:
    """f32 -> u8 unorm -> f32 (skin weights). Truncating encode per
    vertex_buffers.rs:146-148, standard `/255` decode."""
    q = np.trunc(np.asarray(x, dtype=np.float32) * 255.0)
    return np.clip(q, 0.0, 255.0).astype(np.float32) / 255.0


def quantize_position(p: np.ndarray) -> np.ndarray:
    return quantize_f16(p)


def quantize_texcoord(uv: np.ndarray) -> np.ndarray:
    return quantize_f16(uv)


def quantize_normal(n: np.ndarray) -> np.ndarray:
    return quantize_snorm10(n)


def quantize_tangent(t: np.ndarray) -> np.ndarray:
    """[..., 4]: xyz 10-bit snorm, w 2-bit snorm (the bitangent sign)."""
    t = np.asarray(t, dtype=np.float32)
    out = np.empty_like(t)
    out[..., :3] = quantize_snorm10(t[..., :3])
    out[..., 3] = quantize_snorm2(t[..., 3])
    return out
