"""mixtral-8x7b [moe]: 32L, d=4096, 32H (GQA kv=8), ff=14336, vocab=32000,
8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088; hf]"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "mixtral-8x7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        num_experts=8,
        num_experts_per_tok=2,
        window=4096,
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=512, num_experts=4, num_experts_per_tok=2, window=64,
        remat=False,
    )
