"""Device choice for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). Without a card and without that
request they raise: nothing quietly carries on on the CPU.

Resolving to the card also turns TF32 off for float32 matrix products and
convolutions: the pyramid's interpolation products and the bundle
adjustment's Schur products need full float32.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """``None`` means the card; any other value is taken as given, and a
    CUDA device that does not exist raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def _as_i32(t: torch.Tensor) -> torch.Tensor:
    """Flat int32 view of a tensor's bits (float32 / int32 / bool)."""
    t = t.reshape(-1)
    if t.dtype == torch.float32:
        return t.contiguous().view(torch.int32)
    return t.to(torch.int32)


def fetch_packed(parts) -> list:
    """Bring float32 / int32 / bool tensors to the host in one transfer;
    returns numpy arrays of the tensors' shapes and types."""
    sizes = [p.numel() for p in parts]
    flat = torch.cat([_as_i32(p) for p in parts]).cpu().numpy()
    out = []
    for p, c in zip(parts, np.split(flat, np.cumsum(sizes)[:-1])):
        if p.dtype == torch.float32:
            c = c.view(np.float32)
        elif p.dtype == torch.bool:
            c = c.astype(bool)
        out.append(c.reshape(tuple(p.shape)).copy())
    return out
