"""Llama-3.2 1B [hf:meta-llama/Llama-3.2-1B].

16L d_model=2048 32H (GQA kv=8, head_dim=64) d_ff=8192 vocab=128256; tied.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    attn_kind="gqa",
    rope_theta=500_000.0,
    norm_kind="rmsnorm",
    tie_embeddings=True,
    max_seq_len=131072,
    optimizer="adamw",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="llama3.2-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        max_seq_len=512,
        param_dtype="float32",
        act_dtype="float32",
    )
