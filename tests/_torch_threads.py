"""One torch thread for every test of a module whose port runs are many
small ops: under the suite's six worker processes torch's intra-op pool
oversubscribes the cores, and such a test then waits far longer than
its work takes (tests/test_torch_kmeans.py's ``one_thread`` gives the
K-Means examples the same remedy).  A module takes it by importing the
fixture, which is autouse:

    from _torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
