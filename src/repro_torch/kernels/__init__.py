"""Hand-written CUDA kernels (``csrc/``), their plain PyTorch versions and
the dispatch in ``ops`` (``ref`` holds the plain oracles).  Nothing is
built when the package is imported."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
