"""A module-scoped autouse fixture that runs a test file's torch CPU work
on one thread: the closed-loop parity files step small tensors through
thousands of tiny operations, where more threads gain nothing (a B = 2
fleet second takes 16.6 s on one thread, 15.6 s on eight) and, under the
suite's parallel workers, only oversubscribe the cores."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
