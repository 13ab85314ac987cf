"""The thread cap of the port's CPU tests (tests/torch_port.py): under
pytest-xdist each worker runs torch on its share of the cores, and a rank
spawned through parallel/distributed.py:launch inherits the cap through
OMP_NUM_THREADS and MKL_NUM_THREADS (torch's pool follows MKL's count where
the two differ); outside xdist torch keeps its default.
"""

import os
import subprocess
import sys

import pytest
import torch

import torch_dp
import torch_port


@pytest.mark.parametrize("workers,cores,share", [
    (None, 8, None), ("", 8, None), ("1", 8, 8), ("3", 8, 2), ("6", 8, 1),
    ("16", 8, 1)])
def test_worker_share(workers, cores, share):
    environ = {} if workers is None else {"PYTEST_XDIST_WORKER_COUNT": workers}
    assert torch_port.worker_threads(environ, cores) == share


def test_torch_threads_hold_the_worker_share():
    share = torch_port.worker_threads()
    if share is not None:
        assert 1 <= torch.get_num_threads() <= share
        return
    # outside xdist: what a fresh interpreter in this environment gets
    fresh = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        capture_output=True, text=True, check=True).stdout
    assert torch.get_num_threads() == int(fresh)


def test_a_launched_rank_inherits_the_cap(tmp_path):
    torch_dp.launch(torch_dp.threads_rank, 2, tmp_path, str(tmp_path))
    omp, mkl = (os.environ.get(v)
                for v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"))
    if torch_port.worker_threads() is not None:
        assert omp is not None and mkl is not None
    for r in range(2):
        got = (tmp_path / f"threads_rank{r}.txt").read_text().split()
        assert got[:2] == [str(omp), str(mkl)]
        if omp is not None and omp == mkl:
            assert int(got[2]) == int(omp)
