"""Device resolution shared by the port's entry points.

``device=None`` means the CUDA card: without one the entry points raise
instead of carrying on on the CPU.  The CPU is used only when the caller
asks for it (``device="cpu"``), as the tests do.

Resolving a CUDA device also pins float32 matrix products to full float32
(``allow_tf32 = False``, matmul precision "highest"): TF32 in the rounding's
``z = g @ rootᵀ`` would flip the signs of z near 0 and change which samples
are drawn.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (or ``RuntimeError``); anything else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch needs a CUDA device (none is available); "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
