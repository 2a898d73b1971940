"""Hand-written CUDA kernels for the H100 (``csrc/``) and their wrappers.

Each wrapper launches its kernel on a CUDA tensor (building the library at
first use, ``build.py``) and runs its plain PyTorch version on a CPU
tensor.  ``launch_counts`` / ``reset_launch_counts`` read and zero the
per-wrapper launch counters, so a run can show that it went through the
kernels.
"""

from repro_torch.kernels.bottleneck import bottleneck_eval
from repro_torch.kernels.sdp_proj import rank_k_update, sdp_subspace

WRAPPERS = (sdp_subspace, rank_k_update, bottleneck_eval)


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


__all__ = [
    "WRAPPERS",
    "bottleneck_eval",
    "launch_counts",
    "rank_k_update",
    "reset_launch_counts",
    "sdp_subspace",
]
