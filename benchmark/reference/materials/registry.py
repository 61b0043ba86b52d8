# Frozen copy of renderer_tpu_torch/materials/registry.py at commit 5822f29, cut to its
# plain (PyTorch / numpy) path: nothing here launches a hand-written kernel
# or calls the host library. Part of the benchmark's yardstick; do not edit.
"""Materials: bindless-style texture + PBR-factor slot registry.

Parity: the reference keeps one 300-slot texture array and a 1000-slot
PbrFactors structure-of-arrays UBO, indexed draw-id → material-id → texture
slots in the shaders (reference: renderer/src/renderer/descriptors.rs:52-74,
renderer/src/renderer/descriptors/material.rs:87-119,
renderer/shaders/glsl/main.frag:35-57). Slots are freed when the last
reference to a Material/Texture drops (weakref, mirroring the Rc-weak slot
arrays of descriptors.rs:52-74).

On TPU the texture array becomes one atlas (materials/atlas.py) and the
factors SoA becomes fixed-shape device arrays gathered by material id.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np

from benchmark.reference.core import constants


class SlotsExhausted(Exception):
    pass


class ReusableSlots:
    """Fixed-capacity slot allocator; a slot is reclaimed when the object it
    was allocated for is garbage collected (descriptors.rs:52-74)."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._free = list(range(capacity - 1, -1, -1))
        self._live: dict[int, weakref.ref] = {}

    def allocate(self, owner: object) -> int:
        if not self._free:
            raise SlotsExhausted(f"all {self.capacity} slots in use")
        slot = self._free.pop()

        def _release(_ref, self=self, slot=slot):
            self._live.pop(slot, None)
            self._free.append(slot)

        self._live[slot] = weakref.ref(owner, _release)
        return slot

    @property
    def used(self) -> int:
        return self.capacity - len(self._free)


class TextureKind:
    """reference: renderer/src/image_loading.rs:46-60."""

    SRGB_COLOR = "srgb"
    LINEAR_COLOR = "linear"
    NORMAL_MAP = "normal"


class TextureWrap:
    """Per-axis sampler address modes (glTF sampler.wrapS/wrapT; GL enums
    10497/33071/33648). BEYOND the reference: it parses glTF samplers but
    never uses them — every texture goes through one repeat-mode sampler
    (descriptors.rs:90-105, gltf crate's `samplers` field unused). Here the
    wrap mode is honored per texture axis in the atlas sampler
    (raster/shade.py) with matching atlas border texels
    (materials/atlas.py)."""

    REPEAT = 0
    CLAMP_TO_EDGE = 1
    MIRRORED_REPEAT = 2


class Texture:
    """A decoded RGBA8 texture with a full mip chain. `mips[i]` is a
    [h, w, 4] u8 array; mips[0] is the base level.

    May be LAZY (`mips=None` + `loader`/`shape`/`fingerprint`): the decode
    runs only if the mips are actually needed — the two-phase
    preload(header-only)/upload(decode) split of the reference
    (gltf/src/lib.rs:152-175, pending_gltf.rs:122-138). With the atlas
    bundle cache (materials/atlas.py) a warm startup never decodes at all."""

    def __init__(self, mips: list[np.ndarray] | None, kind: str,
                 name: str = "", *, loader=None, shape=None,
                 fingerprint: str | None = None,
                 wrap_s: int = TextureWrap.REPEAT,
                 wrap_t: int = TextureWrap.REPEAT,
                 blocks_loader=None) -> None:
        if mips is None:
            assert loader is not None and shape is not None
            assert fingerprint is not None, "lazy textures need a fingerprint"
            self._mips = None
            self._loader = loader
            self._shape = (int(shape[0]), int(shape[1]))
        else:
            assert mips, "texture needs at least one mip"
            for m in mips:
                assert m.dtype == np.uint8 and m.ndim == 3 and m.shape[2] == 4
            self._mips = mips
            self._loader = None
            self._shape = mips[0].shape[:2]
        self._fingerprint = fingerprint
        # optional compressed-source access: () -> list[[nb,16] u8 BC7
        # blocks per mip] or None — lets the device-decode atlas path
        # (materials/atlas_device.py) upload 1-byte/texel blocks without
        # ever touching the decoded mips
        self._blocks_loader = blocks_loader
        self._blocks = None
        self.kind = kind
        self.name = name
        assert wrap_s in (0, 1, 2) and wrap_t in (0, 1, 2)
        self.wrap_s = wrap_s
        self.wrap_t = wrap_t
        self.slot = -1  # assigned by MaterialRegistry

    @property
    def mips(self) -> list[np.ndarray]:
        if self._mips is None:
            mips = self._loader()
            assert mips and mips[0].shape[:2] == self._shape, (
                f"texture {self.name}: loader shape {mips[0].shape[:2]} != "
                f"declared {self._shape}"
            )
            self._mips = mips
        return self._mips

    @property
    def bc7_mips(self) -> list[np.ndarray] | None:
        """Per-mip raw BC7 block arrays ([nb, 16] u8) when the texture is
        backed by a compressed source, else None. Never triggers a decode."""
        if self._blocks is None and self._blocks_loader is not None:
            self._blocks = self._blocks_loader()
            self._blocks_loader = None  # one attempt; None result sticks
            if self._blocks is not None:
                nb0 = (self.width + 3) // 4 * ((self.height + 3) // 4)
                assert self._blocks[0].shape == (nb0, 16), (
                    f"texture {self.name}: block count {self._blocks[0].shape}"
                    f" != expected {(nb0, 16)}"
                )
        return self._blocks

    @property
    def fingerprint(self) -> str:
        """Content identity for caching (atlas bundles). Lazy textures carry
        an explicit one (file path+size+mtime); eager textures hash their
        pixels on first request."""
        if self._fingerprint is None:
            import hashlib

            h = hashlib.sha1()
            for m in self._mips:
                h.update(repr(m.shape).encode())
                h.update(m.tobytes())
            self._fingerprint = "sha1:" + h.hexdigest()
        return self._fingerprint

    @property
    def width(self) -> int:
        return self._shape[1]

    @property
    def height(self) -> int:
        return self._shape[0]


class AlphaMode:
    """reference: descriptors/material.rs:13-18."""

    OPAQUE = 0
    ALPHA_TO_COVERAGE = 1
    BLENDED = 2


@dataclass
class PbrMaterialParameters:
    """reference: descriptors/material.rs:37-71 (defaults included)."""

    base_color: Texture | None = None
    metallic_roughness: Texture | None = None
    normal: Texture | None = None
    occlusion: Texture | None = None
    emissive: Texture | None = None
    base_color_factor: tuple = (1.0, 1.0, 1.0, 1.0)
    emissive_factor: tuple = (1.0, 1.0, 1.0)
    occlusion_factor: float = 1.0
    roughness_factor: float = 1.0
    metallic_factor: float = 1.0
    normal_strength: float = 1.0
    alpha_cutoff: float = 0.5
    alpha_mode: int = AlphaMode.OPAQUE


class Material:
    """A PBR material occupying one factors slot
    (descriptors/material.rs:74-119)."""

    def __init__(self, name: str, material_id: int, params: PbrMaterialParameters) -> None:
        self.name = name
        self.id = material_id
        self.params = params  # keeps the Textures alive → keeps their slots

    @property
    def alpha_mode(self) -> int:
        return self.params.alpha_mode


class MaterialRegistry:
    """Owns texture slots, factors slots, and the packed SoA arrays the frame
    function gathers from (the TPU analog of Descriptors,
    renderer/src/renderer/descriptors.rs:76-85)."""

    def __init__(self) -> None:
        self.texture_slots = ReusableSlots(constants.MAX_TEXTURES)
        self.factor_slots = ReusableSlots(constants.MAX_MATERIALS)
        self.textures: dict[int, Texture] = {}  # slot -> live texture
        self._default_material: Material | None = None

        m = constants.MAX_MATERIALS
        # PbrFactors SoA (uniforms.rs:81-110); texture indices kept unpacked
        # (the reference packs base<<16|mtl_rgh into a uvec4 purely as a GLSL
        # layout trick, material.rs:107-110).
        self.base_color_factor = np.tile(np.array([1, 1, 1, 1], np.float32), (m, 1))
        self.emissive_occlusion = np.tile(np.array([1, 1, 1, 1], np.float32), (m, 1))
        # columns: alpha_cutoff, roughness, metallic, normal_scale
        self.alpha_rgh_mtl_normal = np.tile(np.array([0.5, 1, 1, 1], np.float32), (m, 1))
        # columns: base_color, metallic_roughness, normal, occlusion, emissive
        self.tex_indices = np.tile(
            np.array(
                [
                    constants.DEFAULT_BASE_COLOR_SLOT,
                    constants.DEFAULT_METALLIC_ROUGHNESS_SLOT,
                    constants.DEFAULT_NORMAL_SLOT,
                    constants.DEFAULT_OCCLUSION_SLOT,
                    constants.DEFAULT_EMISSIVE_SLOT,
                ],
                np.int32,
            ),
            (m, 1),
        )
        self.alpha_mode = np.zeros(m, np.int32)
        self._version = 0  # bumped on any change, for device-array caching
        self._register_default_textures()

    def _register_default_textures(self) -> None:
        """The 5 PBR default 1x1 textures occupy slots 0-4
        (descriptors.rs:186-203, image_loading/pbr_defaults.rs:11-14)."""

        def pixel(rgba, kind, name):
            tex = Texture([np.array([[rgba]], np.uint8)], kind, name)
            slot = self.texture_slots.allocate(tex)
            tex.slot = slot
            self.textures[slot] = tex
            return tex

        self._defaults = [
            pixel((0xFF, 0xFF, 0xFF, 0xFF), TextureKind.SRGB_COLOR, "default-base-color"),
            pixel((0x00, 0xFF, 0xFF, 0x00), TextureKind.LINEAR_COLOR, "default-metallic-roughness"),
            pixel((0x7F, 0x7F, 0xFF, 0x00), TextureKind.NORMAL_MAP, "default-normal"),
            pixel((0xFF, 0xFF, 0xFF, 0xFF), TextureKind.LINEAR_COLOR, "default-occlusion"),
            pixel((0x00, 0x00, 0x00, 0x00), TextureKind.SRGB_COLOR, "default-emissive"),
        ]

    def register_texture(self, texture: Texture) -> int:
        if texture.slot >= 0:
            return texture.slot
        slot = self.texture_slots.allocate(texture)
        texture.slot = slot
        self.textures[slot] = texture
        self._version += 1
        return slot

    def create_material(self, name: str, params: PbrMaterialParameters) -> Material:
        """Material::for_pbr parity (material.rs:87-119)."""
        slots = [
            self.register_texture(t) if t is not None else d.slot
            for t, d in zip(
                (params.base_color, params.metallic_roughness, params.normal,
                 params.occlusion, params.emissive),
                self._defaults,
            )
        ]
        material = Material(name, -1, params)
        mid = self.factor_slots.allocate(material)
        material.id = mid
        self.base_color_factor[mid] = np.asarray(params.base_color_factor, np.float32)
        self.emissive_occlusion[mid] = np.asarray(
            (*params.emissive_factor, params.occlusion_factor), np.float32
        )
        self.alpha_rgh_mtl_normal[mid] = np.asarray(
            (params.alpha_cutoff, params.roughness_factor, params.metallic_factor,
             params.normal_strength),
            np.float32,
        )
        self.tex_indices[mid] = np.asarray(slots, np.int32)
        self.alpha_mode[mid] = params.alpha_mode
        self._version += 1
        return material

    def default_material(self) -> Material:
        if self._default_material is None:
            self._default_material = self.create_material("default", PbrMaterialParameters())
        return self._default_material

    @property
    def version(self) -> int:
        return self._version
