"""One intra-op thread for PyTorch while a test module runs.

The port's tests work on reduced models, whose ops are far too small to
gain from PyTorch's intra-op threads; and the suite runs in parallel
processes (``pytest -n 6``), where every process's default pool of one
thread a core contends with the others' for the same cores.  Six
concurrent runs of ``tests/test_torch_spec.py`` took 861 s on 8 cores
with the default pool and 72 s with one thread.  A port test module
imports the fixture below (``from _torch_threads import
one_torch_thread``); it restores the previous count when the module's
last test ends, so modules run after it in the same process keep theirs.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
