"""The benchmark's own tests. Tests that need the card carry the ``card``
marker and skip, with a reason, where no CUDA device is visible; the
decision is made inside each test."""

import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
    torch.set_num_threads(1)
