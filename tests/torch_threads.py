"""One intra-op torch thread for a port test module (import
``one_torch_thread`` into it; the fixture is autouse).

Under ``pytest -n 6`` six workers share the machine's cores; a worker whose
torch runs one OpenMP thread per core oversubscribes them, and the engine /
training loops of these modules (many small ops) then spend most of their
time waiting for threads. The thread count changes no assertion of these
modules; the previous count is restored after the module."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
