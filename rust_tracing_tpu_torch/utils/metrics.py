"""Structured per-step metrics (SURVEY.md §5.5).

The reference logs with bare ``println!`` (render time renderer.rs:51, BVH
build main.rs:660, encode renderer.rs:73). Production framework equivalent:
one machine-parseable JSON line per event on a dedicated stream, so tools /
dashboards can consume rays/s, per-bounce occupancy and distributed-step
telemetry without scraping human-readable output.

Off by default. Enable with ``RT_METRICS=1`` (or ``--metrics`` on the CLI,
which sets it) to emit to stderr; ``RT_METRICS=/path/file.jsonl`` appends to
a file instead. Every line is ``{"event": ..., "t": <unix seconds>, ...}``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

_sink = None  # resolved lazily; False = disabled


def _resolve():
    global _sink
    cfg = os.environ.get("RT_METRICS", "")
    if not cfg or cfg == "0":
        _sink = False
    elif cfg == "1" or cfg.lower() == "stderr":
        _sink = sys.stderr
    else:
        _sink = open(cfg, "a")
    return _sink


def enabled() -> bool:
    s = _sink if _sink is not None else _resolve()
    return s is not False


def enable(path: Optional[str] = None) -> None:
    """Programmatic/CLI enable: stderr by default, or append to ``path``."""
    global _sink
    os.environ["RT_METRICS"] = path or "1"
    _sink = None


def emit(event: str, **fields) -> None:
    """Emit one JSON metrics line; no-op unless enabled. Values must be
    JSON-serializable (floats are rounded to keep lines compact)."""
    s = _sink if _sink is not None else _resolve()
    if s is False:
        return
    rec = {"event": event, "t": round(time.time(), 3)}
    for k, v in fields.items():
        if isinstance(v, float):
            v = round(v, 6)
        rec[k] = v
    print(json.dumps(rec), file=s, flush=True)
