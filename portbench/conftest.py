"""Settings of the benchmark's CPU tests: torch runs each test on one
thread. The tests' models are small, so more threads gain nothing alone,
and with several test processes at once (pytest-xdist) a thread a core in
each makes every small operation wait on the others: six runs of the
four-card smoke cell at once take about 450 s on eight threads each and
about 4 s on one."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
