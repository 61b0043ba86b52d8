# Frozen copy of renderer_tpu_torch/core/constants.py at commit 5822f29, cut to its
# plain (PyTorch / numpy) path: nothing here launches a hand-written kernel
# or calls the host library. Part of the benchmark's yardstick; do not edit.
"""Capacity constants shared by every stage of the renderer.

Parity: these mirror the reference's shader constants, which are the single
source of truth for both GLSL and Rust there
(reference: renderer/shaders/glsl/constants.glsl:1-4, renderer/build.rs:35-50).
On TPU they are *array dimensions*: every per-draw / per-material / per-joint
uniform becomes a fixed-shape device array so the frame function compiles once.
"""

MAX_TEXTURES = 300
MAX_MATERIALS = 1000
MAX_JOINT_COUNT = 65536 // (4 * 16)  # 1024
MAX_DRAW_CALLS = 65536 // 4  # 16384

# Morph-target capacity (NO reference counterpart: the reference leaves
# morph animation as a todo!(), gltf/src/lib.rs:229 — we implement it).
# Per-draw morph weights are a fixed [MAX_DRAW_CALLS, MAX_MORPH_TARGETS]
# column of the scene SoA; meshes with more targets are refused LOUDLY at
# load time (resource exhaustion is never silent).
MAX_MORPH_TARGETS = 8

# Texture-slot indices of the PBR default 1x1 textures
# (reference: renderer/src/renderer/descriptors.rs:186-203,
#  renderer/src/image_loading/pbr_defaults.rs:11-14).
DEFAULT_BASE_COLOR_SLOT = 0
DEFAULT_METALLIC_ROUGHNESS_SLOT = 1
DEFAULT_NORMAL_SLOT = 2
DEFAULT_OCCLUSION_SLOT = 3
DEFAULT_EMISSIVE_SLOT = 4
NUM_DEFAULT_TEXTURES = 5

# Debug visualization modes, switched by a per-frame scalar
# (reference: renderer/shaders/glsl/main.frag:78-107).
DEBUG_MODE_LIT = 0
DEBUG_MODE_BASE_COLOR = 1
DEBUG_MODE_DRAW_ID = 2
DEBUG_MODE_NORMAL = 3
DEBUG_MODE_ROUGHNESS_METALLIC = 4
DEBUG_MODE_EMISSIVE = 5
DEBUG_MODE_OCCLUSION = 6
NUM_DEBUG_MODES = 7
