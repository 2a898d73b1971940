"""qwen3-8b [dense]: 36L, d=4096, 32H (GQA kv=8), ff=12288, vocab=151936,
qk_norm + GQA.  [hf:Qwen/Qwen3-8B; hf]"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "qwen3-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, remat=False,
    )
