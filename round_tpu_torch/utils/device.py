"""Device selection shared by every entry point of the port.

Entry points run on the card by default.  A caller that wants the CPU says
so (``device="cpu"``, as the tests do); asking for CUDA where there is no
card raises instead of quietly running somewhere else."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
