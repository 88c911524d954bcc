"""Image I/O: PNG encode of renders, JPEG decode for image textures.

Host-side replacement for the reference's ``image`` crate usage: PNG output
(src/renderer.rs:59-72) and JPEG texture load (src/texture.rs:76-81).
"""

from __future__ import annotations

import numpy as np

from . import color as color_util


def write_png(path: str, image_linear: np.ndarray) -> None:
    """Encode a linear float (H,W,3) image to PNG with the reference's
    gamma-2.2 + 256*clamp quantization (src/color.rs:12-19)."""
    from PIL import Image

    rgb8 = color_util.color_to_rgb8(image_linear)
    Image.fromarray(rgb8, mode="RGB").save(path, format="PNG")


def read_image_rgb8(path: str) -> np.ndarray:
    """Decode any image to uint8 (H,W,3) — texture loading
    (src/texture.rs:78)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)
