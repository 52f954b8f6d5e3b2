"""One intra-op thread for the port's tests on the CPU.

The suite runs in several worker processes on a machine with few cores.
At the tests' small shapes PyTorch's OpenMP threads gain nothing, and
where the workers' threads outnumber the cores every op's barrier waits
on threads the other workers hold: an AMG solve that takes under a
second alone took minutes.  Each `test_torch_*` module imports this
autouse fixture, which runs the module on one thread and restores the
count after it.
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
