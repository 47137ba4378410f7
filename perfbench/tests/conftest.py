import pytest


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny cells on one CPU thread: under the suite's parallel
    workers a pool of threads a worker only contends for the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
