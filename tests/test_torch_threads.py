"""One torch intra-op thread for the port's CPU test modules.

The port's plain walks on the CPU (ops/gather_block.py, ops/kf_block.py,
ops/track_chain.py) issue thousands of small torch operations an epoch.
With several test workers on one host, each worker's default pool of
intra-op threads (one per core) oversubscribes the cores and spins at
every parallel region: four concurrent runs of tests/test_torch_gather_
block.py's JAX parity cases took 275 s each with the default pool and
about 63 s with one thread, of tests/test_torch_kf_block.py 350 s and
30 s.  `one_torch_thread` sets one thread for the
tests of a module (its module-scoped fixtures included) and restores the
pool after them, so no other module sees the change."""

import pytest
import torch


@pytest.fixture(scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_one_torch_thread_sets_one_and_restores_the_pool():
    before = torch.get_num_threads()
    gen = one_torch_thread.__wrapped__()
    next(gen)
    assert torch.get_num_threads() == 1
    next(gen, None)
    assert torch.get_num_threads() == before
