"""Multi-GPU rendering and gradients over ``torch.distributed``.

PyTorch counterpart of rust_tracing_tpu/parallel/: one process per rank
(``torchrun``, or ``launch.run_ranks`` on one host), a (rays, sample) mesh
over the ranks of the default process group (``mesh.py``), the sharded
render (``render_dist.py``, ``ops/megakernel.render_fast_sharded``) and the
distributed record/replay gradient (``grad_dist.py``).
"""
