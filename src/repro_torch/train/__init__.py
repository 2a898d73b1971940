"""Training primitives of the gossip-FL slice: SGD with momentum and the
gossip-message compressors (counterparts of ``repro.train.optim`` and
``repro.train.compression``)."""

from repro_torch.train.compression import Int8, TopK, message_bytes
from repro_torch.train.optim import SGDM, global_norm

__all__ = ["Int8", "SGDM", "TopK", "global_norm", "message_bytes"]
