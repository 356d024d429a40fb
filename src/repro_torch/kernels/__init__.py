"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``). CUDA sources live under ``csrc/`` and are built at the
first launch (``_build.py``), never at import."""
