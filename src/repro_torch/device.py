"""Device resolution shared by the port's entry points.

``device=None`` means the CUDA card: without one the entry points raise
instead of carrying on on the CPU.  The CPU is used only when the caller
asks for it (``device="cpu"``), as the tests do.

Resolving a CUDA device also pins float32 matrix products and cuDNN's
float32 convolutions to full float32 (``matmul.allow_tf32 = False``, matmul
precision "highest", ``cudnn.allow_tf32 = False``).  TF32 keeps about three
decimal digits: in the rounding's ``z = g @ rootᵀ`` it would flip the signs
of z near 0 and change which samples are drawn, and in the FL CNN's
convolutions it would move the card's losses away from the CPU's.
"""

from __future__ import annotations

import functools

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
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index`` (the kernels' plans
    size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
