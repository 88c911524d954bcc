"""Run a function on N local ranks, one process each: the port's
counterpart of the reference's test mesh of virtual devices.

``run_ranks(fn, world_size, ...)`` starts ``world_size`` fresh interpreters
(never a fork of a process that may hold a CUDA context), each of which
joins one process group through a rendezvous file (no network), calls
``fn(device, *args)`` and hands back what it returns. A rank that fails, or
a run that outlasts ``timeout_s``, stops every rank and raises, with the
tail of each rank's output.

``fn`` must be importable by name in a fresh interpreter: a module-level
function of a module on ``sys.path``, or of the script being run
(``__main__``, loaded again from its file under another name, so its
``if __name__ == "__main__"`` block does not run). Build the CUDA kernels
in the caller before starting the ranks, so they do not all run nvcc.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, List, Optional

_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_ranks(fn, world_size: int, backend: Optional[str] = None,
              device=None, timeout_s: float = 300.0,
              args: tuple = ()) -> List[Any]:
    """``[fn(device, *args) of rank 0, ..., of rank world_size-1]``.

    ``device=None`` gives rank r ``cuda:r``; a named device (``"cpu"``,
    ``"cuda:0"``) is shared by every rank, which needs ``backend="gloo"``
    on a CUDA device. ``backend=None`` is NCCL on CUDA, gloo on the CPU."""
    mod = sys.modules[fn.__module__]
    spec = dict(module=fn.__module__, qualname=fn.__qualname__,
                file=getattr(mod, "__file__", None)
                if fn.__module__ == "__main__" else None,
                args=args, backend=backend,
                device=None if device is None else str(device),
                timeout_s=timeout_s, sys_path=list(sys.path))
    tmp = tempfile.mkdtemp(prefix="rt_ranks_")
    procs, logs = [], []
    try:
        spec["init_method"] = "file://" + os.path.join(tmp, "rdv")
        spec_path = os.path.join(tmp, "spec.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump(spec, f)
        base_env = dict(os.environ)
        base_env["PYTHONPATH"] = os.pathsep.join(
            [_PKG_PARENT] + [p for p in base_env.get("PYTHONPATH", "")
                             .split(os.pathsep) if p])
        # every rank is on this host: keep the transports on the loopback
        base_env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        base_env.setdefault("NCCL_SOCKET_IFNAME", "lo")
        for r in range(world_size):
            rank_env = dict(base_env, RANK=str(r), LOCAL_RANK=str(r),
                            WORLD_SIZE=str(world_size))
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+b")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, spec_path, str(r)],
                env=rank_env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(
                    f"rank {bad[0]} of {world_size} exited with "
                    f"{codes[bad[0]]}\n{_tails(logs)}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world_size} ranks did not finish within {timeout_s} "
                    f"s\n{_tails(logs)}")
            time.sleep(0.05)
        out = []
        for r in range(world_size):
            # written by the rank processes this call started
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _tails(logs, n_bytes: int = 4000) -> str:
    parts = []
    for r, log in enumerate(logs):
        log.flush()
        log.seek(0)
        text = log.read().decode(errors="replace")
        parts.append(f"--- rank {r}:\n{text[-n_bytes:]}")
    return "\n".join(parts)


def _rank_main(spec_path: str, rank: int) -> int:
    import importlib
    import importlib.util

    import torch.distributed as dist

    from .mesh import init_distributed

    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    sys.path[:0] = [p for p in spec["sys_path"] if p not in sys.path]
    if spec["file"]:
        mspec = importlib.util.spec_from_file_location("__rank_main__",
                                                       spec["file"])
        mod = importlib.util.module_from_spec(mspec)
        mspec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(spec["module"])
    fn = mod
    for part in spec["qualname"].split("."):
        fn = getattr(fn, part)
    dev = init_distributed(spec["backend"], spec["init_method"],
                           spec["timeout_s"], spec["device"])
    try:
        result = fn(dev, *spec["args"])
    finally:
        dist.destroy_process_group()
    out = os.path.join(os.path.dirname(spec_path), f"result{rank}.pkl")
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)
    return 0


if __name__ == "__main__":
    try:
        rc = _rank_main(sys.argv[1], int(sys.argv[2]))
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
