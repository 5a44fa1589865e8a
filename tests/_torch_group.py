"""Run a job of ``tests/_torch_mesh_worker.py`` on a gloo process group of
spawned CPU ranks, with a deadline.

Each rank is its own ``python -m _torch_mesh_worker <job> <rank> <world>
<workdir>`` process (one ``torch.distributed`` gloo group, rendezvous
through a file in ``workdir``, collectives timing out after 60 s).  The
parent waits for every rank until the deadline; past it, or if a rank
fails, it kills them all and the test fails with the ranks' logs.  Rank
0 leaves the job's result in ``workdir / "result.pkl"``.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _tails(workdir: Path, world: int) -> str:
    out = []
    for r in range(world):
        log = (workdir / f"rank{r}.log").read_text(errors="replace")
        out.append(f"--- rank {r} ---\n{log[-3000:]}")
    return "\n".join(out)


def start_group(job: str, world: int, workdir: Path) -> list:
    """Start the ranks; :func:`join_group` waits for them."""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(REPO / "src"),
                                          str(REPO / "tests")]),
           "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(world):
        log = open(workdir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "_torch_mesh_worker", job, str(r),
             str(world), str(workdir)], env=env, stdout=log,
            stderr=subprocess.STDOUT, cwd=str(REPO)), log))
    return procs


def join_group(procs: list, workdir: Path, timeout: float):
    """Wait for every rank until ``timeout`` seconds from now; kill them
    all past it or when one fails; rank 0's result."""
    deadline = time.monotonic() + timeout
    world = len(procs)
    failed = None
    try:
        pending = list(procs)
        while pending:
            if time.monotonic() > deadline:
                failed = f"the group did not finish in {timeout:.0f} s"
                break
            for item in list(pending):
                rc = item[0].poll()
                if rc is None:
                    continue
                pending.remove(item)
                if rc != 0:
                    failed = f"a rank exited with {rc}"
            if failed:
                break
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if failed:
        raise AssertionError(f"{failed}\n{_tails(workdir, world)}")
    with open(workdir / "result.pkl", "rb") as f:
        return pickle.load(f)
