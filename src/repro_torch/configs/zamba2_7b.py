"""Zamba2-7B [arXiv:2411.15242].

81L d_model=3584; Mamba2 backbone (d_inner=7168, 112 SSM heads x head_dim 64,
ssm_state=64, conv width 4) with a parameter-SHARED attention+MLP block applied
every 6th layer on concat(hidden, original_embedding) (width 2*d_model, 32
heads x head_dim 224), d_ff=14336, vocab=32000.

Deviation (DESIGN.md §5): the released model alternates two shared blocks and
adds per-invocation LoRA deltas; we use a single shared block (optional LoRA
path exists in models/blocks.py) — placement/routing semantics identical.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=224,  # attention width = 2*d_model = 7168 = 32*224
    d_ff=14336,
    vocab_size=32000,
    attn_kind="gqa",
    shared_attn_period=6,
    ssm_state=64,
    ssm_heads=112,
    ssm_head_dim=64,
    d_inner=7168,
    conv_width=4,
    rope_theta=10_000.0,
    norm_kind="rmsnorm",
    max_seq_len=1 << 20,
    optimizer="adamw",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-reduced",
        n_layers=7,  # 2 mega-blocks of 3 + 1 tail mamba layer
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,  # 2*64/4
        d_ff=128,
        vocab_size=256,
        shared_attn_period=3,
        ssm_state=16,
        ssm_heads=8,
        ssm_head_dim=16,
        d_inner=128,
        max_seq_len=512,
        param_dtype="float32",
        act_dtype="float32",
    )
