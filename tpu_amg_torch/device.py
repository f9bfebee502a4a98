"""Device policy: the caller names the device; nothing probes for one.

``resolve_device("cuda")`` raises when PyTorch sees no CUDA device; the
code never falls back to the CPU.  ``disable_tf32`` turns TF32 off for
float32 matmuls and convolutions: TF32 keeps about three decimal digits,
and the reference needed full-precision matmuls for the same reason
(``tpu_amg/ops/well_pallas.py:31-33``).
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(a, device, dtype=None) -> torch.Tensor:
    """``a`` (a numpy array, copied, or a tensor) as a tensor on ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device=device, dtype=dtype)


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but PyTorch sees no CUDA device"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


def disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
