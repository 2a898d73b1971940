"""Hand-written CUDA kernels for the H100 (``csrc/``) and their wrappers.

Each wrapper launches its kernel on a CUDA tensor (building the library at
first use, ``build.py``) and runs its plain PyTorch version on a CPU
tensor.  ``launch_counts`` / ``reset_launch_counts`` read and zero the
per-wrapper launch counters, so a run can show that it went through the
kernels.
"""

from repro_torch.kernels.bottleneck import bottleneck_eval
from repro_torch.kernels.compress import int8_roundtrip, topk_mask
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gossip_mix import gossip_mix, gossip_mix_all, gossip_mix_block
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.sdp_proj import rank_k_update, sdp_subspace

WRAPPERS = (sdp_subspace, rank_k_update, bottleneck_eval, gossip_mix_all, gossip_mix_block,
            gossip_mix, topk_mask, int8_roundtrip, rmsnorm, flash_attention, decode_attention)


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


__all__ = [
    "WRAPPERS",
    "bottleneck_eval",
    "decode_attention",
    "flash_attention",
    "gossip_mix",
    "gossip_mix_all",
    "gossip_mix_block",
    "int8_roundtrip",
    "launch_counts",
    "rank_k_update",
    "reset_launch_counts",
    "rmsnorm",
    "sdp_subspace",
    "topk_mask",
]
