"""Uniform model API: ``build_model(cfg)`` behind ``repro``'s member names.

``build_model(cfg)`` returns a ``ModelAPI`` for the decoder LMs (dense,
mixture-of-experts, Mamba-2, VLM, RG-LRU hybrid) and for Whisper:

  - ``init_params(seed=0, device=None, rules=None)``   an ``LM`` drawn on the device;
                                            under ``rules`` its leaves DTensors laid out
                                            by their specs
  - ``forward(params, batch, rules=None)``  prefill: (B, S) ``tokens`` -> (B, S, V) logits;
                                            under ``rules`` the batch is placed by
                                            ``batch_specs`` and the logits are a DTensor
  - ``init_cache(batch, seq_len, device=None, rules=None)``   the decode state; under
                                            ``rules`` laid out by ``cache_specs``
  - ``decode_step(params, cache, batch, rules=None)``   one serve step: (B,) ``tokens``
                                            at (B,) ``pos`` -> ((B, V) logits, the cache,
                                            updated in place); under ``rules`` the
                                            batch is placed by ``batch_specs`` and the
                                            logits are a DTensor
  - ``loss_fn(params, batch, rules=None)``  training: mean next-token cross-entropy of
                                            (B, S) tokens against (B, S) labels (plus the
                                            mixture-of-experts auxiliary loss), a float32
                                            scalar with gradients (``params`` an ``LM``
                                            or a ``transformer.bind`` stand-in); under
                                            ``rules`` (``launch.sharding.MeshRules``) the
                                            parameters, batch and loss are DTensors
  - ``input_specs(spec)``                   the batch of a ``ShapeSpec``: ``repro``'s keys,
                                            shapes and dtypes, as meta-device tensors
                                            (nothing allocated; ``jax.ShapeDtypeStruct``
                                            stand-ins in ``repro``)
  - ``cache_specs(spec)``                   ``init_cache`` of the spec's batch and length
                                            on the meta device

A VLM (``family == "vlm"``, qwen2-vl) takes ``inputs_embeds`` in place of
tokens: (B, S, D) for ``forward``, (B, 1, D) for ``decode_step``, and
``forward`` takes (3, B, S) M-RoPE ``positions`` (t, h, w; default 0 … S − 1
on each axis), as ``repro``'s ``input_specs`` lay the batch out.

Whisper (``family == "encdec"``) takes ``repro``'s batch keys:
``enc_frames`` (B, S_enc, D) and ``dec_tokens`` (B, S_dec) for ``forward``,
plus ``labels`` for ``loss_fn``, and ``tokens`` and ``pos`` for
``decode_step``; ``init_cache(batch, seq_len, enc_len=None, device=None,
rules=None)`` holds ``enc_len`` (default max(seq_len // 4, 64))
cross-attention slots, zeros until ``whisper.fill_cross_cache`` writes an
encoding's.  Every Whisper entry takes ``rules`` as the LMs' do.  Its
``input_specs`` give the encoder ``seq_len`` frames and the decoder
max(seq_len // 4, 64) tokens (``_whisper_seqs``); its ``cache_specs`` hold
a self cache of ``seq_len`` and max(seq_len // 16, 64) cross slots.

``device=None`` means the CUDA card (``RuntimeError`` without one);
``device="cpu"`` runs the kernels' plain versions.  ``forward`` and
``decode_step`` run where ``params`` live; token, embedding and position
arrays are moved there.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models import whisper as wh
from repro_torch.models.common import ModelConfig
from repro_torch.shapes import ShapeSpec


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable        # (seed=0, device=None, rules=None) -> LM or Whisper
    loss_fn: Callable            # (params, batch, rules=None) -> scalar
    forward: Callable            # (params, batch, rules=None) -> logits
    init_cache: Callable         # (batch, seq_len, device=None, rules=None) -> cache
    decode_step: Callable        # (params, cache, batch, rules=None) -> (logits, cache)
    input_specs: Callable        # (ShapeSpec) -> batch dict of meta tensors
    cache_specs: Callable        # (ShapeSpec) -> cache dict of meta tensors


META = torch.device("meta")      # shapes and dtypes only, nothing allocated


def _sds(shape, dtype) -> torch.Tensor:
    """A shape and dtype stand-in: a tensor on the meta device."""
    return torch.empty(shape, dtype=dtype, device=META)


def _whisper_seqs(spec: ShapeSpec) -> tuple[int, int]:
    """Encoder frames get the full seq_len; decoder gets seq_len // 4
    (whisper's audio:text ratio is ≈3-4:1; see DESIGN.md)."""
    return spec.seq_len, max(spec.seq_len // 4, 64)


def build_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "encdec":
        return _build_whisper(cfg)
    tf.check_supported(cfg)
    return _build_lm(cfg)


def _on(params, batch: dict, key: str):
    v = batch.get(key)
    return v if v is None or isinstance(v, DTensor) else torch.as_tensor(v, device=params.device)


def _placed(params, batch: dict, rules) -> dict:
    """``batch`` laid out by ``batch_specs`` under a mesh, else as it is."""
    return batch if getattr(rules, "mesh", None) is None else rules.place_batch(batch,
                                                                              params.device)


def _build_lm(cfg: ModelConfig) -> ModelAPI:
    uses_embeds = cfg.family == "vlm"

    def init_params(seed: int = 0, device=None, rules=None) -> tf.LM:
        dev = resolve_device(device)
        return tf.init_lm_params(cfg, torch.Generator(device=dev).manual_seed(seed), rules)

    def loss_fn(params, batch: dict, rules=None) -> torch.Tensor:
        return tf.lm_loss(params, batch, cfg, rules)

    def forward(params: tf.LM, batch: dict, rules=None) -> torch.Tensor:
        batch = _placed(params, batch, rules)
        return tf.lm_forward(params, _on(params, batch, "tokens"), cfg, rules,
                             positions=_on(params, batch, "positions"),
                             inputs_embeds=_on(params, batch, "inputs_embeds"))

    def init_cache(batch: int, seq_len: int, device=None, rules=None) -> dict:
        cache = tf.init_decode_cache(cfg, batch, seq_len, resolve_device(device))
        return cache if getattr(rules, "mesh", None) is None else rules.place_cache(cache)

    def decode_step(params: tf.LM, cache: dict, batch: dict, rules=None):
        batch = _placed(params, batch, rules)
        return tf.lm_decode_step(params, cache, _on(params, batch, "tokens"),
                                 _on(params, batch, "pos"), cfg,
                                 inputs_embeds=_on(params, batch, "inputs_embeds"),
                                 rules=rules)

    def input_specs(spec: ShapeSpec) -> dict:
        b, s = spec.global_batch, spec.seq_len
        if spec.kind in ("train", "prefill"):
            out = {}
            if uses_embeds:
                out["inputs_embeds"] = _sds((b, s, cfg.d_model), cfg.dtype)
                out["positions"] = _sds((3, b, s), torch.int32)
            else:
                out["tokens"] = _sds((b, s), torch.int32)
            if spec.kind == "train":
                out["labels"] = _sds((b, s), torch.int32)
            return out
        # decode: one new token, cache of seq_len
        out = {"pos": _sds((b,), torch.int32)}
        if uses_embeds:
            out["inputs_embeds"] = _sds((b, 1, cfg.d_model), cfg.dtype)
        else:
            out["tokens"] = _sds((b,), torch.int32)
        return out

    def cache_specs(spec: ShapeSpec) -> dict:
        return tf.init_decode_cache(cfg, spec.global_batch, spec.seq_len, META)

    return ModelAPI(cfg=cfg, init_params=init_params, loss_fn=loss_fn, forward=forward,
                    init_cache=init_cache, decode_step=decode_step, input_specs=input_specs,
                    cache_specs=cache_specs)


def _build_whisper(cfg: ModelConfig) -> ModelAPI:
    def init_params(seed: int = 0, device=None, rules=None) -> wh.Whisper:
        dev = resolve_device(device)
        return wh.init_whisper_params(cfg, torch.Generator(device=dev).manual_seed(seed), rules)

    def loss_fn(params, batch: dict, rules=None) -> torch.Tensor:
        return wh.whisper_loss(params, batch, cfg, rules)

    def forward(params: wh.Whisper, batch: dict, rules=None) -> torch.Tensor:
        batch = _placed(params, batch, rules)
        return wh.whisper_forward(params, _on(params, batch, "enc_frames"),
                                  _on(params, batch, "dec_tokens"), cfg, rules)

    def init_cache(batch: int, seq_len: int, enc_len: int | None = None, device=None,
                   rules=None) -> dict:
        cache = wh.init_whisper_cache(cfg, batch, seq_len, enc_len or max(seq_len // 4, 64),
                                      resolve_device(device))
        return cache if getattr(rules, "mesh", None) is None else rules.place_cache(cache)

    def decode_step(params: wh.Whisper, cache: dict, batch: dict, rules=None):
        batch = _placed(params, batch, rules)
        return wh.whisper_decode_step(params, cache, _on(params, batch, "tokens"),
                                      _on(params, batch, "pos"), cfg, rules)

    def input_specs(spec: ShapeSpec) -> dict:
        b = spec.global_batch
        s_enc, s_dec = _whisper_seqs(spec)
        if spec.kind in ("train", "prefill"):
            out = {"enc_frames": _sds((b, s_enc, cfg.d_model), cfg.dtype),
                   "dec_tokens": _sds((b, s_dec), torch.int32)}
            if spec.kind == "train":
                out["labels"] = _sds((b, s_dec), torch.int32)
            return out
        return {"tokens": _sds((b,), torch.int32), "pos": _sds((b,), torch.int32)}

    def cache_specs(spec: ShapeSpec) -> dict:
        # decode cache: self-attn cache of seq_len + cross KV of seq_len//16
        enc_len = max(spec.seq_len // 16, 64)
        return wh.init_whisper_cache(cfg, spec.global_batch, spec.seq_len, enc_len, META)

    return ModelAPI(cfg=cfg, init_params=init_params, loss_fn=loss_fn, forward=forward,
                    init_cache=init_cache, decode_step=decode_step, input_specs=input_specs,
                    cache_specs=cache_specs)
