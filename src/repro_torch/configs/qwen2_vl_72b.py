"""qwen2-vl-72b [vlm]: 80L, d=8192, 64H (GQA kv=8), ff=29568,
vocab=152064, M-RoPE + dynamic resolution.  The vision frontend is a stub:
``input_specs()`` provides precomputed patch/text embeddings and 3-axis
(t, h, w) M-RoPE position ids.  [arXiv:2409.12191; hf]"""

from repro_torch.models.common import ModelConfig

ARCH_ID = "qwen2-vl-72b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=29568,
        vocab_size=152064,
        mrope=True,
        rope_theta=1_000_000.0,
        frontend="vision",
        train_microbatches=4,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, remat=False,
    )
