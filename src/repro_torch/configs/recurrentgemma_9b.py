"""recurrentgemma-9b [hybrid]: 38L, d=4096, 16H (MQA kv=1), ff=12288,
vocab=256000.  RG-LRU + local attention in a 1:2 attention:recurrence
pattern — block groups of (rglru, rglru, local_attn); 38 = 12×3 + 2, the
two remainder layers are rglru.  [arXiv:2402.19427; unverified]"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "recurrentgemma-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        d_ff=12288,
        vocab_size=256000,
        block_pattern=("rglru", "rglru", "local_attn"),
        local_window=2048,
        lru_width=4096,
        train_microbatches=2,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=512, local_window=32, lru_width=64, remat=False,
    )
