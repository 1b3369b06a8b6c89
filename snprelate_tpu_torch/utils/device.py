"""Where the port runs: the ``device=`` argument of every public function."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Asking for CUDA on a host without one
    raises: the port never carries on quietly on the CPU. Pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # indexed, so it compares equal to the device of a tensor on it
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
