"""Runs the port's collectives in several CPU processes over gloo, for the
parity tests of the sharded paths (``tests/test_torch_mesh.py``,
``test_torch_sharded_search.py``, ``test_torch_sharded_index.py``,
``test_torch_llm_tp.py``, ``test_torch_sharded_serving.py``, and others).

The test process calls :func:`run_ranks` once per world size and module: it
writes the cases to a pickle and starts ``world`` workers, each of which
joins a gloo group through a FileStore (``distributed_init(init_method=
"file://...")``), runs a task of :mod:`torch_dist_tasks` on the cases and
pickles what it returns. The workers import torch and the port, never JAX.

    python tests/torch_dist.py <task> <rank> <world> <store> <cases.pkl> <out.pkl>
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path
from typing import Any, List

HERE = Path(__file__).resolve().parent
THREADS = "2"  # per worker: four workers share the test worker's cores


def run_ranks(task: str, world: int, cases: Any, tmp_path: Path, timeout: float = 240
              ) -> List[Any]:
    """Run ``task`` in ``world`` gloo ranks on ``cases``; one result a rank."""
    work = Path(tmp_path) / f"{task}_{world}"
    work.mkdir(parents=True, exist_ok=True)
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = {**os.environ, "PYTHONPATH": str(HERE.parent), "OMP_NUM_THREADS": THREADS,
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "torch_dist.py"), task, str(rank), str(world),
         str(work / "store"), str(work / "cases.pkl"), str(work / f"out_{rank}.pkl")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for rank in range(world)]
    errors = []
    for rank, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            errors.append(f"rank {rank} exited {p.returncode}:\n{err[-4000:]}")
    if errors:
        raise AssertionError("\n".join(errors))
    out = []
    for rank in range(world):
        with open(work / f"out_{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def check_near_ties(ids, scores, ref_ids, ref_scores, atol) -> None:
    """Scores within ``atol`` of the reference's, and the ids (lists of
    lists) equal wherever the reference's score is more than ``atol`` from
    its neighbours in the row (a near-tie may order either way)."""
    import numpy as np

    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=atol)
    for row in range(len(ids)):
        s = ref_scores[row]
        for j, (a, b) in enumerate(zip(ids[row], ref_ids[row])):
            near = [abs(s[j] - s[i]) <= atol for i in (j - 1, j + 1) if 0 <= i < len(s)]
            if not any(near):
                assert a == b, (row, j, a, b)


def _worker(task: str, rank: int, world: int, store: str, cases_path: str,
            out_path: str) -> None:
    import torch
    import torch.distributed as dist

    import torch_dist_tasks
    from kirag_tpu_torch.parallel import distributed_init

    torch.set_num_threads(int(THREADS))
    distributed_init(num_processes=world, process_id=rank, backend="gloo",
                     init_method=f"file://{store}", timeout_s=120)
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    result = getattr(torch_dist_tasks, task)(cases)
    with open(out_path, "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
