def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (skips without one); run on the card with "
        "`python -m pytest -m gpu tests/test_torch_gpu.py`")
