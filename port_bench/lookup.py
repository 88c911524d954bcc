"""Every piece of a cell, found by name under this folder of the checkout:

- the cell: its entry in ``BENCHMARK.json``;
- its configuration: the file the entry's ``configs`` row names;
- its traffic mix: ``traffic/<mix>.json``, whose ``kind`` names
  ``kinds/<kind>.py``, the loop that drives the program and the comparison
  that judges it;
- the reference's scene: ``scenes/<scene>.py`` for the configuration's
  ``scene``;
- the limits of its comparison: ``limits/<cell>.json``;
- each metric's reader: ``metrics/<metric>.py``.

A later cell, scene, kind or metric is new files and entries; no file here
changes. This module imports no third-party package, so a run can read its
cell before it loads PyTorch.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict

PKG = os.path.basename(os.path.dirname(os.path.abspath(__file__)))
_MODULES: Dict[str, object] = {}


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: Dict    # the cell's entry in BENCHMARK.json
    cfg: Dict      # the configuration file
    mix: Dict      # the traffic mix
    limits: Dict   # limit of each number the check compares
    spec: Dict     # BENCHMARK.json
    base: str      # this folder in the checkout

    def module(self, folder: str, name: str):
        return module(self.base, folder, name)

    @property
    def kind(self):
        return self.module("kinds", self.mix["kind"])


def find_cell(root: str, workload: str) -> Cell:
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in spec["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"]
                     if c["name"] == entry["config"])
    cfg = load_json(os.path.join(root, cfg_entry["file"]))
    base = os.path.join(root, PKG)
    mix = load_json(os.path.join(base, "traffic", entry["traffic"] + ".json"))
    limits = load_json(os.path.join(base, "limits", workload + ".json"))
    return Cell(workload, entry, cfg, mix, limits, spec, base)


def module(base: str, folder: str, name: str):
    """``<base>/<folder>/<name>.py`` as a module, loaded once a path."""
    path = os.path.join(base, folder, name + ".py")
    if path not in _MODULES:
        if not os.path.isfile(path):
            raise SystemExit(f"no {folder} file {name}.py under {base}")
        tag = f"{PKG}_{folder}_" + name.replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(tag, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]
