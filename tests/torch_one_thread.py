"""The port's CPU tests run PyTorch with one intra-op thread: the suite runs
in several worker processes, and on tensors this small a thread pool per
process only contends with the others (the flagship's float32 roundtrip
test took 1.7 s alone and 90-120 s beside five busy workers; six of the
port's test files took 228 s together on six workers with a thread pool
each, 105 s with one thread each).  A test file imports the fixture:

    from torch_one_thread import _one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
