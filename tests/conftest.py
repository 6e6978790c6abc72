def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card and skips without one; on the card "
        "run `PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py`")
