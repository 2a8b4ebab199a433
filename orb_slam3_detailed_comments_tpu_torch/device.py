"""Device choice for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). Without a card and without that
request they raise: nothing quietly carries on on the CPU.

Resolving to the card also turns TF32 off for float32 matrix products and
convolutions: the pyramid's interpolation products and the bundle
adjustment's Schur products need full float32.

Background threads (the mapping worker, the racing global BA) launch on
the device's default stream, as tracking does. The card runs the kernels
of every thread in the order they were queued, so what one thread queued
before another reads it (the map lock, or the start of a thread, orders
the two) is written by then: no stream needs a handoff.

The transfers between host and card (``to_device``, ``upload_packed``,
``fetch_packed``) copy from and to pageable host memory: each waits for
the stream, a host sync, and runs inside a span "host sync"
(``utils/timing``).
"""
from __future__ import annotations

import numpy as np
import torch

from .utils import timing


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


_WORD_TYPES = (np.dtype(np.float32), np.dtype(np.int32), np.dtype(bool))


def to_device(x, device) -> torch.Tensor:
    """x (a numpy array or a tensor) on device. A copy of any elements
    between host and card waits for the stream, a host sync; without a
    card, each copy of the helpers stands for the card's."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x
    dev = torch.device(device)
    if t.numel() == 0 or t.device.type == dev.type == "cuda":
        return t.to(dev)
    with timing.span("host sync"):
        return t.to(dev)


def upload_packed(arrays, device) -> list:
    """Copy float32 / int32 / bool numpy arrays to the device in one
    transfer; returns tensors of the arrays' shapes and types."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    for a in arrays:
        if a.dtype not in _WORD_TYPES:
            raise TypeError(f"upload_packed takes float32, int32 or bool "
                            f"arrays, not {a.dtype}")
    words = [(a.astype(np.int32) if a.dtype == bool else a.view(np.int32))
             .reshape(-1) for a in arrays]
    flat = to_device(np.concatenate(words), device)
    out = []
    for a, c in zip(arrays, torch.split(flat, [w.size for w in words])):
        if a.dtype == np.float32:
            c = c.view(torch.float32)
        elif a.dtype == bool:
            c = c != 0
        out.append(c.reshape(a.shape))
    return out


def fetch_packed(parts) -> list:
    """Bring float32 / int32 / bool tensors to the host in one transfer;
    returns numpy arrays of the tensors' shapes and types."""
    sizes = [p.numel() for p in parts]
    flat = to_device(torch.cat([_as_i32(p) for p in parts]), "cpu").numpy()
    out = []
    for p, c in zip(parts, np.split(flat, np.cumsum(sizes)[:-1])):
        if p.dtype == torch.float32:
            c = c.view(np.float32)
        elif p.dtype == torch.bool:
            c = c.astype(bool)
        out.append(c.reshape(tuple(p.shape)).copy())
    return out
