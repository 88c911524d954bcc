"""The (rays, sample) mesh over the ranks of a ``torch.distributed`` group.

PyTorch counterpart of rust_tracing_tpu/parallel/mesh.py. The
decomposition is the reference's:

- ``rays`` axis: each rays-shard owns one contiguous range of flat pixel ids
  (``shard_range``);
- ``sample`` axis: the spp budget is split into equal ranges, one for each
  rank of a rays-shard, and the per-pixel means are summed back;
- scene tables are replicated: every rank compiles the same builder output;
- parameter gradients are summed over every rank, once.

Rank ``r`` sits at ``(rays_idx, sample_idx) = (r // sp, r % sp)`` for
``sp = sample_parallelism``. Without a process group ``make_mesh`` returns a
1x1 mesh, and the same code runs with collectives that do nothing.

The port's kernels take a row-major pixel range, not the TPU's 32x32 tiles,
so nothing is padded and no clamped duplicate pixel is traced. Only
``all_reduce`` and ``broadcast`` are used: gloo offers just those on CUDA
tensors, so the same code runs under NCCL on the cards, under gloo on one
shared card, and under gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..config import resolve_device

RAYS_AXIS = "rays"
SAMPLE_AXIS = "sample"

DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (rays, sample) mesh and its device."""

    n_rays: int
    n_sample: int
    rank: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {RAYS_AXIS: self.n_rays, SAMPLE_AXIS: self.n_sample}

    @property
    def size(self) -> int:
        return self.n_rays * self.n_sample

    @property
    def rays_idx(self) -> int:
        return self.rank // self.n_sample

    @property
    def sample_idx(self) -> int:
        return self.rank % self.n_sample

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over every rank of the default group (nothing
        to do without a process group); returns ``t``."""
        if dist.is_initialized():
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    def assemble(self, local: torch.Tensor, base: int,
                 n_total: int) -> torch.Tensor:
        """The (n_total, ...) tensor that holds each rank's ``local`` at its
        rows ``base ..``: zeros elsewhere, summed over every rank by one
        all-reduce. Where ranks share rows (the sample axis) their values
        add; elsewhere ``x + 0 = x`` keeps every value's bits."""
        full = torch.zeros((n_total,) + tuple(local.shape[1:]),
                           dtype=local.dtype, device=local.device)
        full[base:base + local.shape[0]] = local
        return self.all_reduce(full)


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     device=None) -> torch.device:
    """Join the default process group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; ``MASTER_ADDR``/``MASTER_PORT``
    unless ``init_method`` names the rendezvous, e.g. ``file://<dir>/rdv``).
    Returns this rank's device.

    ``device=None`` gives rank ``cuda:{LOCAL_RANK}`` and raises when the host
    has fewer cards. ``backend=None`` is NCCL on a CUDA device and gloo on
    the CPU. Ranks share one card only when the caller names the device and
    ``backend="gloo"``: NCCL refuses two ranks on one GPU. ``timeout_s``
    bounds the rendezvous and every collective, so a lost rank fails the
    others instead of hanging them."""
    missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"init_distributed: {', '.join(missing)} not set; start the "
            "ranks with torchrun (or parallel.launch.run_ranks)")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device is None:
        resolve_device(None)  # raises without a card
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: LOCAL_RANK {local_rank} but this host has "
                f"{torch.cuda.device_count()} CUDA device(s)")
        dev = torch.device("cuda", local_rank)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            idx = 0 if dev.index is None else dev.index
            if idx >= torch.cuda.device_count():
                raise RuntimeError(
                    f"rank {rank}: device {dev} but this host has "
                    f"{torch.cuda.device_count()} CUDA device(s)")
            dev = torch.device("cuda", idx)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_mesh(sample_parallelism: int = 1, device=None) -> Mesh:
    """The (rays, sample) mesh over the ranks of the default process group,
    or a 1x1 mesh when there is none. ``device=None`` means this rank's
    current CUDA device; the CPU runs only on ``device="cpu"``."""
    sp = max(1, int(sample_parallelism))
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if world % sp:
        raise ValueError(f"{world} ranks not divisible by "
                         f"sample_parallelism={sp}")
    return Mesh(n_rays=world // sp, n_sample=sp, rank=rank, device=dev)


def shard_range(n_pixels: int, mesh: Mesh) -> Tuple[int, int]:
    """(pixel_base, pixel_count) of this rank's rays-shard: the flat pixel
    ids ``[0, n_pixels)`` cut into ``mesh.n_rays`` contiguous ranges whose
    sizes differ by at most one. A shard may be empty when there are more
    rays-shards than pixels."""
    r, n = mesh.rays_idx, mesh.n_rays
    base = n_pixels * r // n
    return base, n_pixels * (r + 1) // n - base
