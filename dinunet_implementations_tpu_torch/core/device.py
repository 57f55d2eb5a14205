"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a caller that wants the CPU says so
    (``device="cpu"``, as the tests do). With no card and no explicit
    device this raises: the port never carries on on the CPU by itself.

    Also turns TF32 off for matrix products and cuDNN: the JAX reference
    computes in full f32 when ``compute_dtype`` is unset, and TF32 keeps
    only about three decimal digits, which would break parity with it.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device
