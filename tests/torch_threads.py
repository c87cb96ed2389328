"""One PyTorch intra-op thread for a port test module: import
``_one_thread`` into it (the fixture is autouse).

With a thread a core in each of several pytest workers the CPU is
oversubscribed, and a small training loop ran 20 to 30 times slower
than on one thread.  The tests' tolerances do not depend on the thread
count.  This module imports no jax, so that the test modules whose
functions ``run_world``'s ranks import may use it too; each rank runs
one thread already."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
