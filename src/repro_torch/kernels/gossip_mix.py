"""The gossip exchange kernels of the FL engines.

Counterparts of ``repro.kernels.gossip_mix``:

  - ``gossip_mix_all(X, W)``: all receivers, ``out (M, L) = W (M, N) @ X
    (N, L)`` (``gossip_mix_all_fwd``).  The stacked trainer calls it once
    per round on its flat message buffer, with no padding and no
    concatenation.
  - ``gossip_mix_block(local, w_block, halo, w_halo)``: one shard of the
    mesh-sharded engine, ``out (m, L) = w_block (m, m) @ local (m, L) +
    w_halo (m, H) @ halo (H, L)`` (``gossip_mix_block_fwd``): the shard's
    own slab and the gathered boundary rows of the other shards stream
    through one kernel.  With ``H = 0`` it hands off to ``gossip_mix_all``
    (and counts a launch there), as ``repro`` does.
  - ``gossip_mix(X, w)``: one receiver, ``out (L) = w (N) @ X (N, L)``
    (``gossip_mix_fwd``, public ``repro.kernels.gossip_mix``): the
    per-user reference engine's average of a receiver's own model and its
    messages.

Senders are float32 or bfloat16, weights float32; sums are float32 and the
result has the senders' dtype.  Each wrapper chooses by the tensors'
device: on CUDA tensors it launches its hand-written kernel
(``csrc/gossip_mix.cu``) or raises; on CPU tensors it runs its plain
version.  ``<wrapper>.launches`` counts kernel launches.

On float32 senders ``gossip_mix_all`` and ``gossip_mix_block`` run on the
tensor cores in three TF32 products: with ``split_tf32``'s halves of X and
W, ``X_lo·W_hi + X_hi·W_lo + X_hi·W_hi`` drops only terms below 2^-22 of
each product, where one TF32 product would miss the float32 exchange's
1e-5 (tests/test_torch_fl_kernels.py models the arithmetic).  Each chunk of
32 senders is summed on the tensor cores and the chunk sums are added in
float32, in order, so the error does not grow with the number of senders
(``csrc/gossip_mix.cu`` gives the readings).  ``gossip_mix_block``'s local
and halo rows are one sender list, each part padded to whole chunks.  Where
W does not fit in shared memory (more than one 128-receiver tile, or more
chunks than fit beside the ring of X slabs) the launch is a pair, W split
into halves into a scratch and then the product, counted once.  bfloat16
senders run a tile of float32 FMAs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import KernelInputError

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def gossip_mix_all_plain(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Plain version: (W @ X) in float32, cast to X's dtype."""
    return (W.float() @ X.float()).to(X.dtype)


def gossip_mix_block_plain(local: torch.Tensor, w_block: torch.Tensor, halo: torch.Tensor,
                           w_halo: torch.Tensor) -> torch.Tensor:
    """Plain version: (w_block @ local + w_halo @ halo) in float32, cast to local's dtype."""
    return (w_block.float() @ local.float() + w_halo.float() @ halo.float()).to(local.dtype)


def gossip_mix_plain(X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: (w @ X) in float32, cast to X's dtype."""
    return (w.float() @ X.float()).to(X.dtype)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds; the low 13 bits become zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 x as TF32 ``hi = tf32(x)`` and ``lo = tf32(x - hi)``, so that
    ``hi + lo`` is x to within 2^-22 |x|: the halves of the float32
    exchange's operands (``split_tf32`` in ``csrc/gossip_mix.cu``)."""
    hi = round_tf32(x)
    return hi, round_tf32(x.float() - hi)


def _check_cuda(name: str, senders, weights, out) -> None:
    """What every kernel needs of CUDA tensors: dtypes and contiguity."""
    dt = senders[0].dtype
    if dt not in _DTYPES or any(x.dtype != dt for x in senders) or any(
            w.dtype != torch.float32 for w in weights):
        raise KernelInputError(f"{name}: senders must be float32 or bfloat16 (one dtype) and "
                               f"weights float32, got {[x.dtype for x in senders]}, "
                               f"{[w.dtype for w in weights]}")
    if not all(t.is_contiguous() for t in (*senders, *weights, out)):
        raise KernelInputError(f"{name}: every tensor must be contiguous")


def _check_out(name: str, out, shape, like: torch.Tensor) -> None:
    if out is not None and (tuple(out.shape) != shape or out.dtype != like.dtype
                            or out.device != like.device):
        raise KernelInputError(f"{name}: out must be {shape} {like.dtype} on {like.device}")


def _no_kernel(name: str, device: torch.device) -> RuntimeError:
    return RuntimeError(f"{name}: no kernel for device {device}")


def gossip_mix_all(X: torch.Tensor, W: torch.Tensor, *, out: torch.Tensor | None = None):
    """(N, L) senders, (M, N) weights -> (M, L) mixes (into ``out`` if given)."""
    if X.dim() != 2 or W.dim() != 2 or W.shape[1] != X.shape[0]:
        raise KernelInputError(
            f"gossip_mix_all: need X (N, L) and W (M, N), got {tuple(X.shape)}, {tuple(W.shape)}"
        )
    if W.device != X.device:
        raise KernelInputError(f"gossip_mix_all: W is on {W.device}, X on {X.device}")
    (M, N), L = W.shape, X.shape[1]
    _check_out("gossip_mix_all", out, (M, L), X)
    if X.device.type == "cpu":
        res = gossip_mix_all_plain(X, W)
        return res if out is None else out.copy_(res)
    if X.device.type != "cuda":
        raise _no_kernel("gossip_mix_all", X.device)
    if out is None:
        out = torch.empty((M, L), dtype=X.dtype, device=X.device)
    _check_cuda("gossip_mix_all", (X,), (W,), out)
    if M and L:
        lib = build.library()
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream(X.device).cuda_stream
            if X.dtype == torch.float32:
                scratch = torch.empty(lib.gossip_mix_all_scratch_floats(M, N),
                                      dtype=torch.float32, device=X.device)
                err = lib.gossip_mix_all_f32(X.data_ptr(), W.data_ptr(), out.data_ptr(),
                                             scratch.data_ptr(), M, N, L, stream)
            else:
                err = lib.gossip_mix_all_bf16(X.data_ptr(), W.data_ptr(), out.data_ptr(), M, N,
                                              L, stream)
        build.check(err, "gossip_mix_all")
        gossip_mix_all.launches += 1
    return out


gossip_mix_all.launches = 0


def gossip_mix_block(local: torch.Tensor, w_block: torch.Tensor, halo: torch.Tensor,
                     w_halo: torch.Tensor, *, out: torch.Tensor | None = None):
    """One shard's exchange: (m, L) local senders under the (m, m) block,
    (H, L) halo rows under the (m, H) block -> (m, L) (into ``out`` if given)."""
    if local.dim() != 2 or halo.dim() != 2 or halo.shape[1] != local.shape[1]:
        raise KernelInputError(f"gossip_mix_block: need local (m, L) and halo (H, L), got "
                               f"{tuple(local.shape)}, {tuple(halo.shape)}")
    m, H, L = local.shape[0], halo.shape[0], local.shape[1]
    if tuple(w_block.shape) != (m, m) or tuple(w_halo.shape) != (m, H):
        raise KernelInputError(f"gossip_mix_block: need w_block ({m}, {m}) and w_halo ({m}, {H}), "
                               f"got {tuple(w_block.shape)}, {tuple(w_halo.shape)}")
    if any(t.device != local.device for t in (w_block, halo, w_halo)):
        raise KernelInputError("gossip_mix_block: local, w_block, halo and w_halo must be on one "
                               "device")
    _check_out("gossip_mix_block", out, (m, L), local)
    if H == 0:
        return gossip_mix_all(local, w_block, out=out)
    if local.device.type == "cpu":
        res = gossip_mix_block_plain(local, w_block, halo, w_halo)
        return res if out is None else out.copy_(res)
    if local.device.type != "cuda":
        raise _no_kernel("gossip_mix_block", local.device)
    if out is None:
        out = torch.empty((m, L), dtype=local.dtype, device=local.device)
    _check_cuda("gossip_mix_block", (local, halo), (w_block, w_halo), out)
    if m and L:
        lib = build.library()
        with torch.cuda.device(local.device):
            stream = torch.cuda.current_stream(local.device).cuda_stream
            ptrs = (local.data_ptr(), w_block.data_ptr(), halo.data_ptr(), w_halo.data_ptr(),
                    out.data_ptr())
            if local.dtype == torch.float32:
                scratch = torch.empty(lib.gossip_mix_block_scratch_floats(m, H),
                                      dtype=torch.float32, device=local.device)
                err = lib.gossip_mix_block_f32(*ptrs, scratch.data_ptr(), m, H, L, stream)
            else:
                err = lib.gossip_mix_block_bf16(*ptrs, m, H, L, stream)
        build.check(err, "gossip_mix_block")
        gossip_mix_block.launches += 1
    return out


gossip_mix_block.launches = 0


def gossip_mix(X: torch.Tensor, w: torch.Tensor, *, out: torch.Tensor | None = None):
    """(N, L) senders, (N,) weights -> (L,) mix (into ``out`` if given)."""
    if X.dim() != 2 or w.dim() != 1 or w.shape[0] != X.shape[0]:
        raise KernelInputError(
            f"gossip_mix: need X (N, L) and w (N,), got {tuple(X.shape)}, {tuple(w.shape)}"
        )
    if w.device != X.device:
        raise KernelInputError(f"gossip_mix: w is on {w.device}, X on {X.device}")
    N, L = X.shape
    _check_out("gossip_mix", out, (L,), X)
    if X.device.type == "cpu":
        res = gossip_mix_plain(X, w)
        return res if out is None else out.copy_(res)
    if X.device.type != "cuda":
        raise _no_kernel("gossip_mix", X.device)
    if out is None:
        out = torch.empty((L,), dtype=X.dtype, device=X.device)
    _check_cuda("gossip_mix", (X,), (w,), out)
    if L:
        lib = build.library()
        with torch.cuda.device(X.device):
            err = getattr(lib, f"gossip_mix_{_DTYPES[X.dtype]}")(
                X.data_ptr(), w.data_ptr(), out.data_ptr(), N, L,
                torch.cuda.current_stream(X.device).cuda_stream,
            )
        build.check(err, "gossip_mix")
        gossip_mix.launches += 1
    return out


gossip_mix.launches = 0
