"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version, and the dispatch the model calls (``ops``)."""
