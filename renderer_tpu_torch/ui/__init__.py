"""UI overlay rendered THROUGH the raster pipeline (ImGui-path parity).

The reference rebuilds UI meshes every frame and queues them through the
normal scene path as blended, double-sided, depth-test-off draws into the
HDR geometry pass, with one material per draw command carrying a clip rect +
texture slot + texture kind (renderer/src/imgui_support.rs:107-169,
renderer/src/renderer/descriptors/material.rs:121-148,
renderer/shaders/glsl/imgui.vert + imgui.frag).

Here: `DrawList` builds the same data model host-side (screen-space vertices
with uv + color, per-command clip rect / texture slot / kind), and
`raster/pipeline.py` rasterizes the UI triangles with the same ordered-accept
layer kernel used for blended scene geometry (K2, csrc/layers.cu), shades
them with clip-rect discard + font-alpha sampling, and composites them into
the HDR buffer of every MSAA sample BEFORE tonemap — exactly the reference's
pass position.
"""

from renderer_tpu_torch.ui.draw_list import TEX_KIND_FONT, TEX_KIND_RGBA, DrawList
from renderer_tpu_torch.ui.font import get_font
from renderer_tpu_torch.ui.io import Key, Platform, UiIo, filter_event
from renderer_tpu_torch.ui.widgets import Condition, Ui, UiContext

__all__ = [
    "DrawList", "TEX_KIND_FONT", "TEX_KIND_RGBA", "get_font",
    "Key", "Platform", "UiIo", "filter_event",
    "Condition", "Ui", "UiContext",
]
