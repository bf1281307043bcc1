"""Registers the marker of tests that need a CUDA card: each such test decides
inside itself whether there is one, never while the module is imported."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
