"""The control of the comparison: the reference computed in bfloat16 put in
the program's place, judged by the same numbers against the float32
reference. Its numbers are the upper readings the limits are set below.

    python3 -m port_bench.control --workload <cell> --seeds 1 2 3

runs on the card at the cell's own sizes. It draws each seed's units
(their seeds, samples and checked pixels) by the run's own ``Draws``, and
needs nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict

import torch

from . import check, driver, lookup
from .harness import json_safe


def control_numbers(cell: lookup.Cell, seed: int, device,
                    count: int = None) -> Dict[str, float]:
    count = count or int(cell.mix["check"]["units"])
    d = driver.Draws(cell, seed)
    units = [d.draw(k) for k in range(count)]
    low = cell.kind.answer(cell, units, d.n_pix, device, torch.bfloat16)
    return check.numbers(cell, low, d.n_pix, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = lookup.find_cell(os.getcwd(), args.workload)
    dev = torch.device("cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control_numbers(cell, seed, dev)
        print(json.dumps(json_safe(dict(
            workload=args.workload, seed=seed, control=nums,
            seconds=time.perf_counter() - t0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
