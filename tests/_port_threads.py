"""One intra-op thread for the port's CPU tests.

Tier-1 runs the tests in six pytest-xdist workers on a machine of a few
cores.  PyTorch starts as many intra-op threads as there are cores in every
worker, and XLA its own pool beside them, so the workers' threads contend
for the cores and a test takes many times its own time (the port's four
heaviest files: 888 test-seconds at 4 workers with PyTorch's default, 186
with one thread each).  Each ``tests/test_torch_*.py`` that runs on the
CPU imports :func:`one_torch_thread`, a module-scoped autouse fixture: its
tests run with one PyTorch thread, and the worker's setting comes back
after the module.  Numerics do not depend on it beyond the summation order
of PyTorch's CPU reductions, which the tests' tolerances state.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
