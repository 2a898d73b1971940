"""whisper-small [audio]: enc-dec, 12+12L, d=768, 12H (kv=12), ff=3072,
vocab=51865.  Conv/log-mel frontend is a stub (precomputed frame
embeddings).  [arXiv:2212.04356; unverified]"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "whisper-small"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="encdec",
        num_layers=12,
        num_encoder_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        frontend="audio",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, d_ff=128, vocab_size=512, remat=False,
    )
