"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions and
the dispatch in ``ops``."""
