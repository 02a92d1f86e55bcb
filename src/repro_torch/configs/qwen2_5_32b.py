"""Qwen2.5-32B [hf:Qwen/Qwen2.5-32B].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064; QKV bias.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    attn_kind="gqa",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    max_seq_len=131072,
    optimizer="adamw",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="qwen2.5-reduced",
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
