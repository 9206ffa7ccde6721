"""The ``one_thread`` fixture of the port's CPU tests (not collected: its
name does not start with ``test_``). A tiny frame is hundreds of small ops;
with the suite's other workers on the same cores, torch's intra-op threads
spin against them (6 copies of one such file in parallel took 206 s each
against 6 s alone), so these tests run torch on one thread and restore the
count after. A test file takes it (pytest puts ``tests/`` on the path;
``tests`` itself may name another package on a machine) with

    from torch_threads import one_thread  # noqa: F401 (autouse: torch on one thread)

This module imports neither JAX nor the JAX package, so files that run on
the card's machine import it too."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
