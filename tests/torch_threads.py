"""torch's CPU thread count for the port's tests.

The suite runs in several worker processes at once (``pytest -n``), and
torch gives each of them one OpenMP thread per core by default. The cores
are then oversubscribed, and every parallel region's barrier waits for
threads the scheduler has parked: a bf16 ResNet-50 training step at 32x32
that takes 0.2 s in an idle process took 20 s beside five busy workers on
8 cores, and 0.4 s with two threads. Each test of the port's files runs
with ``THREADS`` threads; the count is restored after it.
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)
