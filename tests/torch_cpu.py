"""CPU settings shared by the port's heavier parity tests."""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def cpu_settings():
    """Flush subnormal floats, as XLA's CPU backend does (without it the
    backward of softplus100 and the Adam moments fill with subnormals and
    the port's CPU path runs several times slower), and cap torch at two
    intra-op threads so parallel test workers do not oversubscribe the
    cores. Both settings are restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_flush_denormal(True)
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        torch.set_flush_denormal(False)


@pytest.fixture
def torch_cpu():
    """cpu_settings() around one test."""
    with cpu_settings():
        yield
