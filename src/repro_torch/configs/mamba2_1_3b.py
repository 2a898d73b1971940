"""mamba2-1.3b [ssm]: 48L, d=2048, attention-free SSD blocks,
ssm_state=128, headdim=64, expand=2, vocab=50280.
[arXiv:2405.21060; unverified]"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "mamba2-1.3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=1,            # unused (attention-free)
        num_kv_heads=1,
        d_ff=0,
        vocab_size=50280,
        block_pattern=("ssm",),
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        tied_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, vocab_size=512, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=32, remat=False,
    )
