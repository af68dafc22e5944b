"""Hand-written CUDA kernels for Hopper (``csrc/``), each beside its plain
PyTorch version.  Callers import each kernel's module: a CPU tensor takes
the plain version, a CUDA tensor the kernel, or the call raises."""
