"""mistral-large-123b [dense]: 88L, d=12288, 96H (GQA kv=8, head_dim=128),
ff=28672, vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407;
unverified]"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "mistral-large-123b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=88,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=32768,
        rope_theta=1_000_000.0,
        train_microbatches=8,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, remat=False,
    )
