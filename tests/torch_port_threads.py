"""One CPU thread for the pipeline tests of the port (tests/test_torch_port_
{data,viz,viz_figures,runner,runner_cadence,run_dir,cli,cli_run}.py).

Their work is many small convolutions, KMeans, t-SNE and image encodes.
A parallel run (pytest-xdist, 6 workers) puts 6 test processes on the
CPUs at once, and torch's and sklearn's OpenMP pools of one thread per CPU
in each then wait on each other at every parallel region: a file that
takes seconds alone took minutes there. One thread a process for the length of each module (torch's
intra-op pool and every OpenMP / BLAS pool threadpoolctl finds), restored
after it."""
import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_process():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(before)
