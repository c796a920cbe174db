"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU.

    Asking for CUDA without a card raises — there is no silent CPU
    fallback.  On CUDA this also turns TF32 off for matmuls and cuDNN:
    the OBS solve and the Hessian need full fp32 (TF32 keeps ~3 digits);
    and it routes the linear algebra to cuSOLVER, which the captured
    solves need (``util/graphs.py``: PyTorch's default sends a batched
    ``cholesky_solve`` to MAGMA), so eager and replayed solves run the
    same routines.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.preferred_linalg_library("cusolver")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
