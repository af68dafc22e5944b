"""The benchmark of the PyTorch and CUDA port (``repro_torch``): see
``bench/run.py``.  It imports the program from ``src/`` and never ``jax`` or
the JAX package."""
