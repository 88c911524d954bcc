"""rust_tracing_tpu_torch — the path tracer on PyTorch + CUDA.

Port of the JAX package ``rust_tracing_tpu`` (which stays in the repository
as the reference) to PyTorch, with the fused render written by hand as a CUDA
kernel for NVIDIA Hopper. Same sub-layout and module names as the reference
so each counterpart is easy to find. Imports ``torch`` and numpy only.

Entry points run on the GPU unless the caller passes ``device="cpu"``, which
runs the kernels' plain PyTorch versions.
"""

from .camera import Camera, get_rays
from .config import RenderSettings
from .models.compile import CompiledScene, compile_scene
from .models.scene import SceneBuilder, Transform
from .renderer import render, progressive_init, progressive_step

__all__ = [
    "Camera",
    "CompiledScene",
    "RenderSettings",
    "SceneBuilder",
    "Transform",
    "compile_scene",
    "get_rays",
    "render",
    "progressive_init",
    "progressive_step",
]

__version__ = "0.1.0"
