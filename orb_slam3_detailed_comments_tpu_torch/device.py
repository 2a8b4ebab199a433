"""Device choice for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). Without a card and without that
request they raise: nothing quietly carries on on the CPU.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the card; any other value is taken as given, and a
    CUDA device that does not exist raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
