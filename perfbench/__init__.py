"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): see
``run.py``. It imports neither JAX nor the JAX package ``repro``."""
