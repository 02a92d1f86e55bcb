"""OLMo 1B [arXiv:2402.00838; hf:allenai/OLMo-1B].

16L d_model=2048 16H (MHA kv=16, head_dim=128) d_ff=8192 vocab=50304;
non-parametric LayerNorm (no scale/bias), tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    attn_kind="gqa",
    rope_theta=10_000.0,
    norm_kind="nonparametric",
    tie_embeddings=True,
    max_seq_len=4096,
    optimizer="adamw",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="olmo-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        max_seq_len=512,
        param_dtype="float32",
        act_dtype="float32",
    )
