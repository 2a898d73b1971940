"""PyTorch/CUDA port of the bottleneck-time scheduler.

A second package beside the JAX reference ``repro``: it imports ``torch``,
``numpy`` and ``scipy``, never ``jax`` and nothing of ``repro``.  Its entry
points (``repro_torch.core.schedule`` and friends) run on the CUDA card
unless the caller passes ``device="cpu"``.
"""
