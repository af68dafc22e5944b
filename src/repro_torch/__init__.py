"""PyTorch/CUDA port of the chunked-prefill serving system in ``repro``.

Laid out like ``repro`` (``configs``, ``core``, ``engine``, ``kernels``,
``models``, ``launch``, ...), imports ``torch`` and never ``jax`` or
``repro``.  Its entry points run on an NVIDIA GPU through hand-written CUDA
kernels unless the caller passes ``device="cpu"``, which runs the kernels'
plain PyTorch versions.
"""
