"""Launching the port's multi-process CPU checks (tests/torch_parallel_worker.py)
from a test: one subprocess per rank on a gloo group at a free local port,
each with one thread and a time limit, and their results read back."""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_parallel_worker.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", PYTHONPATH=str(REPO))
    return env


def run_ranks(checks: list, world: int, tmp: Path, timeout: float = 240.0) -> list[dict]:
    """Run ``checks`` (``(name, kind, kwargs)``) on ``world`` ranks; returns
    each rank's {name: result}. Raises with the ranks' stderr on a failure
    or at the time limit (every rank is killed then)."""
    tmp.mkdir(parents=True, exist_ok=True)
    job = tmp / "job.pkl"
    with open(job, "wb") as f:
        pickle.dump(checks, f)
    port = free_port()
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(job), str(tmp), str(r), str(world),
                               str(port)], cwd=REPO, env=worker_env(), stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        text = ""
        for r in failed:
            logs[r].seek(0)
            text += f"--- rank {r} (exit {procs[r].returncode})\n{logs[r].read()[-4000:]}\n"
        raise RuntimeError(f"ranks {failed} of {world} failed:\n{text}")
    for log in logs:
        log.close()
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out
