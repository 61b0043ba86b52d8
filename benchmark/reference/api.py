"""The reference's scene-building names, as the port's package exports
them (renderer_tpu_torch's public API), over this package's copies."""

from benchmark.reference.core.camera import GLTF
from benchmark.reference.core.config import RenderConfig
from benchmark.reference.geometry.vertex_library import VertexLibraryBuilder
from benchmark.reference.materials.registry import (
    AlphaMode,
    MaterialRegistry,
    PbrMaterialParameters,
    Texture,
    TextureKind,
)
from benchmark.reference.scene.scene import Scene

__all__ = ["GLTF", "RenderConfig", "VertexLibraryBuilder", "AlphaMode",
           "MaterialRegistry", "PbrMaterialParameters", "Texture", "TextureKind", "Scene"]
