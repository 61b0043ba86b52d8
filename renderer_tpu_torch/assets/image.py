"""One decoder by content for the two image types glTF 2.0 allows
(image/png and image/jpeg, glTF 2.0 §3.9): as Pillow's `Image.open`, it
reads the signature and ignores any declared MIME type or file name."""

from __future__ import annotations

import numpy as np

from renderer_tpu_torch.assets import jpeg, png


def decode_image(data: bytes) -> np.ndarray:
    """PNG or JPEG bytes → [h, w, 4] u8 RGBA, as Pillow's
    `Image.open(...).convert("RGBA")` gives it. Anything else raises
    ValueError naming its first bytes."""
    if data.startswith(png.SIGNATURE):
        return png.decode_png(data)
    if data.startswith(b"\xff\xd8\xff"):
        return jpeg.decode_jpeg(data)
    raise ValueError(f"not a PNG or JPEG image (it starts {bytes(data[:8]).hex(' ')})")
