"""One intra-op thread for the port's CPU tests.

The suite runs six pytest workers on the machine's cores, and each torch
process would otherwise start as many intra-op threads as there are cores:
dozens of threads spinning on a few cores, which slowed the port's tests
3-60x and, through the contention, the reference's too (the whole suite:
1397 s on eight threads, 994 s on one).  A test module imports the fixture
below (autouse, module scope), which restores the thread count after the
module.  Importing the name is enough: pytest finds fixtures in the test
module's namespace.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
