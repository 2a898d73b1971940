"""Training primitives: SGD with momentum and the gossip-message compressors
(the gossip-FL slice), AdamW, its schedule and the LM trainer (counterparts
of ``repro.train.optim``, ``repro.train.compression`` and
``repro.train.trainer``)."""

from repro_torch.train.compression import Int8, TopK, message_bytes
from repro_torch.train.optim import (
    SGDM,
    AdamW,
    AdamWState,
    cosine_warmup_schedule,
    global_norm,
)

__all__ = ["AdamW", "AdamWState", "Int8", "SGDM", "TopK", "cosine_warmup_schedule",
           "global_norm", "message_bytes"]
