"""PyTorch/CUDA port of ``katib_tpu`` for NVIDIA Hopper GPUs.

The JAX package ``katib_tpu`` is the reference this package is held
against.  This package imports nothing of it and nothing of JAX.  Entry
points run on ``cuda`` unless the caller names the CPU
(:func:`katib_tpu_torch.device.resolve_device`).
"""
