"""olmoe-1b-7b [moe]: 16L, d=2048, 16H (GQA kv=16), ff=1024 per expert,
vocab=50304, 64 experts top-8, qk_norm.  [arXiv:2409.02060; hf]"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "olmoe-1b-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        num_experts=64,
        num_experts_per_tok=8,
        qk_norm=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=64,
        vocab_size=512, num_experts=8, num_experts_per_tok=2, remat=False,
    )
