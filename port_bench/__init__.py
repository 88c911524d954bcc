"""Benchmark of the PyTorch/CUDA port ``rust_tracing_tpu_torch`` on one card.

``python -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Everything a cell is made of is found by name under this folder:
``configs/<config>.json`` (the scene), ``traffic/<mix>.json`` (the load),
``metrics/<metric>.py`` (a per-layer reader) and ``limits/<cell>.json`` (the
limits of the comparison that decides ``correct``). ``reference/`` is the
plain PyTorch reference; it imports nothing of the port.
"""
