"""Device resolution for the port's entry points.

Every entry point takes a keyword-only ``device=``. ``None`` means the CUDA
card; the CPU runs only when a caller asks for it by name (the tests do), so a
missing card is an error and never a silent fall back to the CPU path.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "libzkp_tpu_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
