"""mistral-nemo-12b [dense]: 40L, d=5120, 32H (GQA kv=8, head_dim=128),
ff=14336, vocab=131072, 128k context.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "mistral-nemo-12b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        rope_theta=1_000_000.0,
        max_seq_len=131072,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, remat=False,
    )
