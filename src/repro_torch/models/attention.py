"""Prefill self-attention of the dense LM in the model layout.

The port's copy of ``repro.models.attention.attention``: q ``(B, S, H, D)``,
k/v ``(B, S, Hkv, D)``.  It runs the flash-attention kernel on a CUDA tensor
(its plain version on a CPU tensor) for every S; ``repro`` picks its dense
or chunked jnp version by size, and all compute the same function.  Decode
calls ``repro_torch.kernels.decode_attention`` directly.

The chunked jnp attention with its custom VJP (training) and the
sequence-sharded decode (meshes) are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int = 0) -> torch.Tensor:
    """Self-attention of (B,S,H,D) queries over (B,S,Hkv,D) keys -> (B,S,H,D)."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal, window=window)
    return out.transpose(1, 2)
