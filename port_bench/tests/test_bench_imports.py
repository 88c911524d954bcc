"""What a run imports: no JAX and no JAX package anywhere, and nothing of
the program in the reference and the comparison. Checked in fresh
interpreters, by whole top-level module names (the program's name begins
with the JAX package's)."""

import json
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "rust_tracing_tpu")


def _top_modules(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_and_check_import_nothing_of_the_program():
    mods = _top_modules(
        "import os, port_bench.check, port_bench.control, "
        "port_bench.yardstick\n"
        "from port_bench import lookup\n"
        "for folder in ('kinds', 'scenes', 'metrics'):\n"
        "    for f in sorted(os.listdir(os.path.join('port_bench', folder))):\n"
        "        if f.endswith('.py'):\n"
        "            lookup.module('port_bench', folder, f[:-3])")
    assert not mods & set(FORBIDDEN) | {"rust_tracing_tpu_torch"} & mods


def test_a_run_on_the_cpu_loads_no_jax():
    mods = _top_modules(
        "import torch\n"
        "from port_bench import harness\n"
        "from port_bench.tests.conftest import TINY\n"
        "harness.run_cell('.', 'cornell_box.offline', 5, 0.1, False, 0.0,\n"
        "                 device='cpu', overrides=TINY['cornell_box.offline'])")
    assert "rust_tracing_tpu_torch" in mods
    assert not mods & set(FORBIDDEN)


def test_the_guard_compares_whole_names():
    from port_bench import harness
    sys.modules.setdefault("rust_tracing_tpu_torch_probe_only", sys)
    try:
        assert "rust_tracing_tpu_torch_probe_only" not in \
            harness.forbidden_modules()
    finally:
        del sys.modules["rust_tracing_tpu_torch_probe_only"]
