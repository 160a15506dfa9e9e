"""Device resolution for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """torch.device for `device`; raises on CUDA when no GPU is present
    rather than quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "valida_tpu_torch: device 'cuda' requested but no CUDA GPU is "
            "available (pass device='cpu' to run the plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
