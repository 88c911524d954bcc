"""Run one cell of the benchmark once and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program ``rust_tracing_tpu_torch``. Standard output's last line is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``);
the last lines of standard error are the compared numbers beside their
limits. Exits with 1 and prints no result without enough CUDA devices, or
if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
# caches the program or PyTorch may build, at fixed paths in the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = os.path.join(ROOT, "port_bench", ".cache", _sub)
# the scenes' earth texture is the procedural stand-in, never a file
os.environ.pop("RT_EARTH_ASSET", None)

from port_bench import lookup  # noqa: E402


def pin(mix) -> None:
    """Pin the process, before any thread starts, to the cores the mix
    names (``pin_cpus``), where it names any and the process may use them:
    a host-paced mix whose rate follows where the scheduler puts it."""
    cpus = set(mix.get("pin_cpus", []))
    if cpus and cpus <= os.sched_getaffinity(0):
        os.sched_setaffinity(0, cpus)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = lookup.find_cell(ROOT, args.workload)
    pin(cell.mix)

    import torch

    from port_bench import harness
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 1
    result, lines = harness.run_cell(ROOT, args.workload, args.seed,
                                     args.seconds, bool(args.trace), _T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 1
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(harness.json_safe(result)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
