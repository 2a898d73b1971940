"""Decoder LMs for serving and training: dense (qwen3, granite,
mistral-nemo, mistral-large), mixture-of-experts (mixtral, olmoe), Mamba-2
(mamba2) and the VLM backbone (qwen2-vl).

``build_model(cfg)`` gives ``repro``'s model API (``init_params``,
``loss_fn``, ``forward``, ``init_cache``, ``decode_step``) over ``LM``,
whose norms and attentions run the port's CUDA kernels on the card.
"""

from repro_torch.models.api import ModelAPI, build_model
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import LM

__all__ = ["LM", "ModelAPI", "ModelConfig", "build_model"]
