"""portbench's own tests: ``python -m pytest portbench/tests -q -n 0``."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one, decided in the test)")
