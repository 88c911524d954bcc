"""Terminal progress reporting (reference: indicatif bar, src/renderer.rs:17-23)."""

from __future__ import annotations

import sys
import time


class ProgressBar:
    """Minimal ETA progress bar, ticked from the render chunk loop."""

    def __init__(self, total: int, prefix: str = "rendering", width: int = 40,
                 stream=None):
        self.total = max(1, total)
        self.prefix = prefix
        self.width = width
        # sys.stderr as it is now, not as it was when the module was imported
        self.stream = stream if stream is not None else sys.stderr
        self.start = time.perf_counter()
        self._last = 0.0

    def __call__(self, done: int, total: int = None) -> None:
        total = total or self.total
        now = time.perf_counter()
        if done < total and now - self._last < 0.25:
            return
        self._last = now
        frac = min(1.0, done / total)
        filled = int(self.width * frac)
        elapsed = now - self.start
        eta = elapsed * (1 - frac) / frac if frac > 0 else 0.0
        self.stream.write(
            f"\r{self.prefix} [{'#' * filled}{'.' * (self.width - filled)}] "
            f"{frac * 100:5.1f}%  eta {eta:6.1f}s")
        if done >= total:
            self.stream.write(f"  ({elapsed:.1f}s)\n")
        self.stream.flush()
