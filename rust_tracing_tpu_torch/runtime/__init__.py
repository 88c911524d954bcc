"""Native (C++) runtime components, loaded via ctypes.

Compile-on-demand with g++; every native piece has a pure-Python fallback so
the framework works without a toolchain (set RT_NO_NATIVE=1 to force the
fallbacks).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

_HERE = os.path.dirname(__file__)
_LIB_CACHE = {}


def _build_dir() -> str:
    d = os.path.join(os.path.dirname(_HERE), "build")
    os.makedirs(d, exist_ok=True)
    return d


def load_library(name: str) -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load runtime/<name>.cpp as a shared library."""
    if os.environ.get("RT_NO_NATIVE"):
        return None
    if name in _LIB_CACHE:
        return _LIB_CACHE[name]
    src = os.path.join(_HERE, f"{name}.cpp")
    if not os.path.exists(src):
        _LIB_CACHE[name] = None
        return None
    so = os.path.join(_build_dir(), f"{name}.so")
    try:
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", so],
                check=True, capture_output=True, timeout=120)
        lib = ctypes.CDLL(so)
    except (OSError, subprocess.SubprocessError):
        lib = None
    _LIB_CACHE[name] = lib
    return lib
