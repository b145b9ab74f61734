"""The port's tests' shared fixture: eager torch on one intra-op thread.

Import it into a test module (``from torch_threads import
_one_torch_thread  # noqa: F401``) and it applies, module-scoped and
autouse, to every test there.  Under the suite's parallel workers torch's
default of one thread a core oversubscribes the host: a trajectory test
took 51.6 s with 8 threads and 2.4 s with one, on a host with 7 busy
cores.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
