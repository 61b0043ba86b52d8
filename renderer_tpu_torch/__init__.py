"""renderer_tpu_torch — the renderer on PyTorch and CUDA (one NVIDIA H100).

The port of the JAX package `renderer_tpu`, which stays beside it as the
reference. Host-side scene building (scene, draw-stream packing, registry,
atlas, camera, math) is numpy, carried as jax-free copies; the device side
is PyTorch, with the two raster kernels (opaque visibility and layered
capture) hand-written in CUDA for sm_90a (renderer_tpu_torch/csrc). This
package imports torch and numpy, never jax.
"""

from renderer_tpu_torch.core.camera import GLTF, QUAKE, VULKAN, Camera, CoordinateSystem
from renderer_tpu_torch.core.config import RenderConfig
from renderer_tpu_torch.core.constants import (
    MAX_DRAW_CALLS,
    MAX_JOINT_COUNT,
    MAX_MATERIALS,
    MAX_TEXTURES,
)
from renderer_tpu_torch.engine.profiling import Profiler
from renderer_tpu_torch.engine.renderer import Renderer
from renderer_tpu_torch.engine.stats import format_bytes, log_memory_usage, memory_usage
from renderer_tpu_torch.geometry.vertex_library import (
    Mesh,
    VertexLibrary,
    VertexLibraryBuilder,
    VertexLibraryMeasurer,
)
from renderer_tpu_torch.materials.registry import (
    AlphaMode,
    Material,
    MaterialRegistry,
    PbrMaterialParameters,
    Texture,
    TextureKind,
    TextureWrap,
)
from renderer_tpu_torch.assets.gltf_loader import Gltf, load_gltf
from renderer_tpu_torch.scene.scene import Scene

__all__ = [
    "GLTF", "QUAKE", "VULKAN", "Camera", "CoordinateSystem", "RenderConfig",
    "MAX_DRAW_CALLS", "MAX_JOINT_COUNT", "MAX_MATERIALS", "MAX_TEXTURES",
    "Profiler", "Renderer", "Mesh", "VertexLibrary", "VertexLibraryBuilder",
    "VertexLibraryMeasurer", "AlphaMode", "Material", "MaterialRegistry",
    "PbrMaterialParameters", "Texture", "TextureKind", "TextureWrap", "Scene",
    "Gltf", "load_gltf",
    # device memory accounting — the reference's Bytes printer + vram
    # getters (lib.rs:75-95,103-128)
    "format_bytes", "memory_usage", "log_memory_usage",
]

__version__ = "0.1.0"
