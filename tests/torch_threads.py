"""One PyTorch intra-op thread for a test file's tests, as a fixture the
file imports: the tier-1 run's six workers share the host's cores, and a
file of many small PyTorch operations (the eager samplers, the plain
kernels at a few chains) ran 15-30 times slower when every operation's
parallel region asked for all of them."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)
