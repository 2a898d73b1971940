"""The all-receivers gossip exchange ``out = W @ X``.

Counterpart of ``repro.kernels.gossip_mix.gossip_mix_all_fwd``: X is the
stacked ``(N, L)`` sender buffer (float32 or bfloat16), W the ``(M, N)``
float32 mixing matrix (row m = receiver m's weights); sums are float32 and
the result is ``(M, L)`` in X's dtype.  The stacked trainer
(``repro_torch.fl.gossip``) calls it once per round on its flat message
buffer, with no padding and no concatenation.

``gossip_mix_all`` chooses by the tensor's device: on a CUDA tensor it
launches the hand-written kernel (``csrc/gossip_mix.cu``) or raises; on a
CPU tensor it runs ``gossip_mix_all_plain``.  ``gossip_mix_all.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def gossip_mix_all_plain(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Plain version: (W @ X) in float32, cast to X's dtype."""
    return (W.float() @ X.float()).to(X.dtype)


def gossip_mix_all(X: torch.Tensor, W: torch.Tensor, *, out: torch.Tensor | None = None):
    """(N, L) senders, (M, N) weights -> (M, L) mixes (into ``out`` if given)."""
    if X.dim() != 2 or W.dim() != 2 or W.shape[1] != X.shape[0]:
        raise ValueError(
            f"gossip_mix_all: need X (N, L) and W (M, N), got {tuple(X.shape)}, {tuple(W.shape)}"
        )
    if W.device != X.device:
        raise ValueError(f"gossip_mix_all: W is on {W.device}, X on {X.device}")
    (M, N), L = W.shape, X.shape[1]
    if out is not None and (out.shape != (M, L) or out.dtype != X.dtype or out.device != X.device):
        raise ValueError(f"gossip_mix_all: out must be ({M}, {L}) {X.dtype} on {X.device}")
    if X.device.type == "cpu":
        res = gossip_mix_all_plain(X, W)
        return res if out is None else out.copy_(res)
    if X.device.type != "cuda":
        raise RuntimeError(f"gossip_mix_all: no kernel for device {X.device}")
    if X.dtype not in _DTYPES or W.dtype != torch.float32:
        raise ValueError(f"gossip_mix_all: X must be float32 or bfloat16 and W float32, "
                         f"got {X.dtype}, {W.dtype}")
    if out is None:
        out = torch.empty((M, L), dtype=X.dtype, device=X.device)
    if not (X.is_contiguous() and W.is_contiguous() and out.is_contiguous()):
        raise ValueError("gossip_mix_all: X, W and out must be contiguous")
    if M and L:
        lib = build.library()
        with torch.cuda.device(X.device):
            err = getattr(lib, f"gossip_mix_all_{_DTYPES[X.dtype]}")(
                X.data_ptr(), W.data_ptr(), out.data_ptr(), M, N, L,
                torch.cuda.current_stream(X.device).cuda_stream,
            )
        build.check(err, "gossip_mix_all")
        gossip_mix_all.launches += 1
    return out


gossip_mix_all.launches = 0
