"""Terminal live viewer: the progressive preview surface.

PyTorch counterpart of rust_tracing_tpu/utils/viewer.py (the same frames,
character for character). The reference opens an FLTK window and blits a
surface per frame (src/renderer.rs:77-137); a GPU box is headless, so the
preview is drawn in the terminal: the accumulation buffer downsampled and
written in place with 24-bit ANSI colour, two pixels a character cell
through the upper-half-block glyph, with the running spp as the status line
(renderer.rs:101).
"""

from __future__ import annotations

import shutil
import sys

import numpy as np

from . import color as color_util

_UPPER_HALF = "▀"


def _downsample(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Nearest-neighbour downsample (H,W,3) -> (out_h,out_w,3)."""
    h, w, _ = img.shape
    ys = (np.arange(out_h) * h // out_h).clip(0, h - 1)
    xs = (np.arange(out_w) * w // out_w).clip(0, w - 1)
    return img[ys][:, xs]


def frame_ansi(image_linear: np.ndarray, cols: int | None = None,
               rows: int | None = None) -> str:
    """A linear image as an ANSI string, two image rows a text row."""
    term = shutil.get_terminal_size((100, 40))
    cols = cols or max(20, term.columns - 2)
    rows = rows or max(10, term.lines - 3)
    h, w, _ = image_linear.shape
    # keep the aspect: a cell is ~1:2 (w:h), half-blocks give 2 subrows
    out_w = min(cols, w)
    out_h = min(rows * 2, int(out_w * h / w)) & ~1
    out_w = min(out_w, max(2, int(out_h * w / h)))
    rgb = color_util.color_to_rgb8(
        _downsample(np.asarray(image_linear, np.float64), out_w,
                    max(out_h, 2)))
    lines = []
    for tr, br in zip(rgb[0::2], rgb[1::2]):
        cells = [f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m"
                 f"\x1b[48;2;{b[0]};{b[1]};{b[2]}m{_UPPER_HALF}"
                 for t, b in zip(tr, br)]
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


class TerminalViewer:
    """Progressive in-place terminal display (does nothing when stdout is
    not a terminal)."""

    def __init__(self, force: bool | None = None):
        self.enabled = sys.stdout.isatty() if force is None else force
        self._last_lines = 0

    def show(self, image_linear: np.ndarray, status: str = "") -> None:
        if not self.enabled:
            return
        frame = frame_ansi(image_linear)
        n = frame.count("\n") + 2
        # move the cursor up over the previous frame and redraw in place
        if self._last_lines:
            sys.stdout.write(f"\x1b[{self._last_lines}F")
        sys.stdout.write(frame + "\n" + status + "\x1b[K\n")
        sys.stdout.flush()
        self._last_lines = n
