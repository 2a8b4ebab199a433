"""PyTorch/CUDA port of the tpu-slam engine.

Beside the JAX package ``orb_slam3_detailed_comments_tpu`` (the reference),
this package keeps the same sub-package layout and module names in PyTorch
idiom. Every Pallas kernel on a ported path is a hand-written CUDA kernel
(sources in ``csrc/``, built with nvcc on first use, see ``native``); each
has a plain PyTorch version beside it that CPU tensors take.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
