"""The benchmark's tests: CPU tests of the harness, and ``card`` tests
that run only on an NVIDIA card (each decides inside its fixture)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA card; skips without one')


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
