"""Uniform model API: ``build_model(cfg)`` behind ``repro``'s member names.

``build_model(cfg)`` returns a ``ModelAPI`` for the dense decoder LMs:

  - ``init_params(seed=0, device=None)``   a ``DenseLM`` drawn on the device
  - ``forward(params, batch)``              prefill: (B, S) tokens -> (B, S, V) logits
  - ``init_cache(batch, seq_len, device=None)``   the decode state
  - ``decode_step(params, cache, batch)``   one serve step: (B,) tokens at (B,) positions
                                            -> ((B, V) logits, the cache, updated in place)
  - ``loss_fn(params, batch)``              training: mean next-token cross-entropy of
                                            (B, S) tokens against (B, S) labels, a float32
                                            scalar with gradients (``params`` a ``DenseLM``
                                            or a ``transformer.bind`` stand-in)

``device=None`` means the CUDA card (``RuntimeError`` without one);
``device="cpu"`` runs the kernels' plain versions.  ``forward`` and
``decode_step`` run where ``params`` live; token and position arrays are
moved there.  Whisper, MoE, SSM, RG-LRU and VLM configs raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable        # (seed=0, device=None) -> DenseLM
    loss_fn: Callable            # (params, batch) -> scalar
    forward: Callable            # (params, batch) -> logits
    init_cache: Callable         # (batch, seq_len, device=None) -> cache
    decode_step: Callable        # (params, cache, batch) -> (logits, cache)


def build_model(cfg: ModelConfig) -> ModelAPI:
    tf.check_supported(cfg)
    return _build_lm(cfg)


def _build_lm(cfg: ModelConfig) -> ModelAPI:
    def init_params(seed: int = 0, device=None) -> tf.DenseLM:
        dev = resolve_device(device)
        return tf.init_lm_params(cfg, torch.Generator(device=dev).manual_seed(seed))

    def loss_fn(params, batch: dict) -> torch.Tensor:
        return tf.lm_loss(params, batch, cfg)

    def forward(params: tf.DenseLM, batch: dict) -> torch.Tensor:
        dev = params.device
        positions = batch.get("positions")
        return tf.lm_forward(
            params, torch.as_tensor(batch["tokens"], device=dev), cfg,
            positions=None if positions is None else torch.as_tensor(positions, device=dev),
        )

    def init_cache(batch: int, seq_len: int, device=None) -> dict:
        return tf.init_decode_cache(cfg, batch, seq_len, resolve_device(device))

    def decode_step(params: tf.DenseLM, cache: dict, batch: dict):
        dev = params.device
        return tf.lm_decode_step(
            params, cache, torch.as_tensor(batch["tokens"], device=dev),
            torch.as_tensor(batch["pos"], device=dev), cfg,
        )

    return ModelAPI(cfg=cfg, init_params=init_params, loss_fn=loss_fn, forward=forward,
                    init_cache=init_cache, decode_step=decode_step)
