"""The CPU thread budget of the port's tests.

The repo's test command runs six pytest workers, and torch's intra-op
pool takes every core in each of them, so the port's tests oversubscribe
the CPU: on an eight-core machine the whole command took 1753 s with
torch's default and 1259 s with two intra-op threads a process
(``OMP_NUM_THREADS=2``), every test passing either way.  Each
``tests/test_torch_*.py`` imports :func:`torch_threads`, an autouse
fixture that gives torch two threads while the module's tests run (and
``OMP_NUM_THREADS`` to the processes they start) and restores both
after, so the JAX package's tests keep their settings.
"""

import os

import pytest
import torch

#: intra-op threads a worker's torch takes while a port test runs
THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(THREADS)
    os.environ["OMP_NUM_THREADS"] = str(THREADS)
    try:
        yield THREADS
    finally:
        torch.set_num_threads(threads)
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env
