"""Train and serve step builders for the decoder LMs (counterpart of
``repro.train.trainer``).

A train state is ``{"params": LM, "opt": AdamWState}``: the float32
masters and the moments, keyed by the ``LM``'s parameter names.  A
step takes the gradients with respect to per-step ``cfg.dtype`` copies of
the masters (``cast_params_once``, ``repro``'s mixed precision: the copies
are leaves of the autograd graph, the masters are not), accumulates
microbatch gradients in float32 and divides them by the microbatch count,
then runs ``AdamW.update``.  ``repro``'s step is pure (``jit`` with the
state donated); here the state's tensors are updated in place and the same
dict is returned with the new optimizer state.

Under a mesh (``rules``, a ``launch.sharding.MeshRules``) the serve steps
pass ``rules`` on (``api.forward`` and ``api.decode_step`` place each batch
by ``batch_specs``); in training the
masters and moments are DTensors laid out by ``param_specs``, each
(micro)batch is placed by ``batch_specs``, the loss is taken under
``rules``, and each gradient is brought to its master's layout before the
update.  ``loss`` and ``grad_norm`` come back as plain float32 scalars,
full, on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.api import ModelAPI
from repro_torch.models.transformer import LM, bind
from repro_torch.train.optim import AdamW


def init_train_state(api: ModelAPI, optimizer: AdamW, seed: int = 0, device=None,
                     rules=None) -> dict:
    """Parameters drawn from ``seed`` on ``device`` (None: the card, or
    ``RuntimeError`` without one) and zero moments; under ``rules`` each a
    DTensor laid out by its parameter's spec (every rank draws the same
    parameters, one whole leaf at a time, and keeps its blocks)."""
    params = api.init_params(seed, device=device, rules=rules)
    return {"params": params, "opt": optimizer.init(dict(params.named_parameters()))}


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def compute_copies(params: LM, cfg) -> dict[str, torch.Tensor]:
    """The tensors a step differentiates: each float32 master cast to
    ``cfg.dtype`` when ``cfg.cast_params_once`` (the master itself, detached,
    otherwise), each a leaf that requires its gradient."""
    out = {}
    for name, p in params.named_parameters():
        c = p.detach()
        if cfg.cast_params_once and c.dtype == torch.float32:
            c = c.to(cfg.dtype)
        out[name] = c.requires_grad_()
    return out


def make_train_step(api: ModelAPI, optimizer: AdamW, rules=None,
                    microbatches: int | None = None) -> Callable:
    """(state, batch) -> (state, metrics).  ``batch`` holds (B, S) ``tokens``
    and ``labels`` (numpy or tensors, the full batch on every rank);
    ``microbatches`` > 1 splits B and accumulates the gradients in float32.
    ``metrics`` are device tensors: ``loss`` and ``grad_norm`` (float32) and
    ``step`` (int32)."""
    cfg = api.cfg
    mb = microbatches if microbatches is not None else cfg.train_microbatches

    def loss_of(params, batch):
        if rules is None:
            return api.loss_fn(params, batch)
        return api.loss_fn(params, rules.place_batch(batch, params.embed.device), rules)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        dev = params.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        copies = compute_copies(params, cfg)
        stand_in = bind(params, copies)
        leaves = list(copies.values())
        masters = dict(params.named_parameters())

        def laid_out(name, g):           # a gradient in its master's layout
            p = masters[name]
            return g.redistribute(p.device_mesh, p.placements) if isinstance(g, DTensor) else g

        if mb <= 1:
            loss = loss_of(stand_in, batch)
            grads = {n: laid_out(n, g) for n, g in zip(copies, torch.autograd.grad(loss, leaves))}
            loss = _full(loss.detach())
        else:
            if any(v.shape[0] % mb for v in batch.values()):
                raise ValueError(f"a batch of {batch['tokens'].shape[0]} does not split into "
                                 f"{mb} microbatches")
            grads = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in masters.items()}
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            parts = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:]) for k, v in batch.items()}
            for i in range(mb):
                part = loss_of(stand_in, {k: v[i] for k, v in parts.items()})
                for (n, acc), g in zip(grads.items(), torch.autograd.grad(part, leaves)):
                    acc.add_(laid_out(n, g).float())
                loss += _full(part.detach()).float()
            for g in grads.values():
                g.div_(mb)
            loss = loss / mb
        del copies, stand_in, leaves
        _, opt, gnorm = optimizer.update(grads, state["opt"], masters)
        state["opt"] = opt
        return state, {"loss": loss.float(), "grad_norm": _full(gnorm).float(), "step": opt.step}

    return train_step


def make_prefill_step(api: ModelAPI, rules=None) -> Callable:
    def prefill_step(params, batch):
        return api.forward(params, batch, rules)

    return prefill_step


def make_decode_step(api: ModelAPI, rules=None) -> Callable:
    """(params, cache, batch) -> (logits, cache); the cache is updated in
    place (under ``rules`` a cache laid out by ``cache_specs``, e.g.
    ``api.init_cache(..., rules=rules)``)."""

    def decode_step(params, cache, batch):
        return api.decode_step(params, cache, batch, rules)

    return decode_step
