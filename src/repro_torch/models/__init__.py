"""Models for serving and training: the decoder LMs, dense (qwen3, granite,
mistral-nemo, mistral-large), mixture-of-experts (mixtral, olmoe), Mamba-2
(mamba2), the VLM backbone (qwen2-vl) and the RG-LRU hybrid
(recurrentgemma), and the Whisper encoder-decoder (whisper-small).

``build_model(cfg)`` gives ``repro``'s model API (``init_params``,
``loss_fn``, ``forward``, ``init_cache``, ``decode_step``, ``input_specs``,
``cache_specs``) over ``LM`` or ``Whisper``, whose norms and attentions run
the port's CUDA kernels on the card; ``param_counts`` and ``model_flops``
are the analytic counts of ``models/flops.py``.
"""

from repro_torch.models.api import ModelAPI, build_model
from repro_torch.models.common import ModelConfig
from repro_torch.models.flops import model_flops, param_counts
from repro_torch.models.transformer import LM
from repro_torch.models.whisper import Whisper

__all__ = ["LM", "ModelAPI", "ModelConfig", "Whisper", "build_model", "model_flops",
           "param_counts"]
