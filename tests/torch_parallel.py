"""Launching gloo ranks for the port's multi-process tests.

`run_ranks(n, job, payload, tmp_path)` pickles `payload`, starts `n`
processes of `tests/torch_parallel_worker.py` with torchrun's environment
(MASTER_ADDR / MASTER_PORT on a free localhost port, RANK, LOCAL_RANK,
WORLD_SIZE, LOCAL_WORLD_SIZE; no card visible) and returns each rank's
result, in rank order. Every child is killed when the timeout passes or
one of them fails, so nothing outlives the test.
"""

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(n: int, job: str, payload, tmp_path, timeout: float = 240.0):
    """Run `job` of the worker on `n` gloo ranks over `payload`; returns
    the ranks' results (AssertionError with the logs where one fails)."""
    tmp_path = Path(tmp_path)
    tmp_path.mkdir(parents=True, exist_ok=True)
    src = tmp_path / f"{job}_payload.pkl"
    with open(src, "wb") as fh:
        pickle.dump(payload, fh, protocol=pickle.HIGHEST_PROTOCOL)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "PYTHONPATH")}
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO))
    logs = [open(tmp_path / f"{job}_rank{r}.log", "w+") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(src), job], cwd=str(REPO),
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.poll() not in (None, 0) for p in procs)):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    texts = []
    for fh in logs:
        fh.seek(0)
        texts.append(fh.read()[-4000:])
        fh.close()
    codes = [p.returncode for p in procs]
    assert codes == [0] * n, (job, codes, texts)
    out = []
    for r in range(n):
        with open(f"{src}.rank{r}", "rb") as fh:
            out.append(pickle.load(fh))
    return out
