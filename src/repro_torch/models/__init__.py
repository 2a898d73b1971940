"""Dense decoder LMs (qwen3, granite, mistral-nemo, mistral-large) for serving
and training.

``build_model(cfg)`` gives ``repro``'s model API (``init_params``,
``loss_fn``, ``forward``, ``init_cache``, ``decode_step``) over ``DenseLM``,
whose norms and attentions run the port's CUDA kernels on the card.
"""

from repro_torch.models.api import ModelAPI, build_model
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import DenseLM

__all__ = ["DenseLM", "ModelAPI", "ModelConfig", "build_model"]
