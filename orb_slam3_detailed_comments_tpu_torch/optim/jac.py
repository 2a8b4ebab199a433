"""Forward-mode Jacobians with every tangent direction in one pass.

The JAX package takes ``jax.jacfwd`` of its small inertial residuals
(``vi_ba.py:131``, ``pose_opt.py:151,275,367``, ``inertial_init.py:77``).
Here the primal x [..., D] is repeated along a new leading axis of length D
and seeded with the identity as its tangent, so one dual-number pass of
``torch.autograd.forward_ad`` (which stays in C++, where ``torch.func``
decomposes these ops in Python) yields all D columns; the function must
broadcast over that leading axis.
"""
from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwAD


def jacobian_fwd(fn, x: torch.Tensor):
    """(fn(x) [..., R], d fn / d x [..., R, D]) for x [..., D]."""
    D = x.shape[-1]
    eye = torch.eye(D, dtype=x.dtype, device=x.device)
    tangent = eye.reshape(D, *([1] * (x.dim() - 1)), D).expand(D, *x.shape)
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(x.expand(D, *x.shape).contiguous(),
                                tangent.contiguous()))
        primal, tan = fwAD.unpack_dual(out)
    return primal[0], torch.movedim(tan, 0, -1)
