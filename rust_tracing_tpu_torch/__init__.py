"""rust_tracing_tpu_torch — the path tracer on PyTorch + CUDA.

Port of the JAX package ``rust_tracing_tpu`` (which stays in the repository
as the reference) to PyTorch, with the fused render written by hand as a CUDA
kernel for NVIDIA Hopper. Same sub-layout and module names as the reference
so each counterpart is easy to find. Imports ``torch`` and numpy only.

Entry points run on the GPU unless the caller passes ``device="cpu"``, which
runs the kernels' plain PyTorch versions. ``parallel/`` shards a render or a
gradient over the ranks of a ``torch.distributed`` group.
"""

from .camera import Camera, get_rays
from .config import RenderSettings
from .models.compile import CompiledScene, compile_scene
from .models.scene import SceneBuilder, Transform
from .parallel.grad_dist import make_replay_train_step, replay_loss_and_grad
from .parallel.mesh import init_distributed, make_mesh
from .parallel.render_dist import render_distributed
from .renderer import (measure_occupancy, progressive_init, progressive_step,
                       render)

__all__ = [
    "Camera",
    "CompiledScene",
    "RenderSettings",
    "SceneBuilder",
    "Transform",
    "compile_scene",
    "get_rays",
    "init_distributed",
    "make_mesh",
    "make_replay_train_step",
    "measure_occupancy",
    "render",
    "render_distributed",
    "replay_loss_and_grad",
    "progressive_init",
    "progressive_step",
]

__version__ = "0.1.0"
