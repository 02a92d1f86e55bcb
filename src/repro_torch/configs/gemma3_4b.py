"""Gemma-3 4B [hf:google/gemma-3-4b-pt].

34L d_model=2560 8H (GQA kv=4, head_dim=256) d_ff=10240 vocab=262144;
5 local (sliding-window 1024) : 1 global pattern, 128k context, qk-norm,
tied embeddings.

Deviation (DESIGN.md §5): one rope theta (1e6) for both local and global
layers (released model uses 10k local / 1M global).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    attn_kind="gqa",
    qk_norm=True,
    sliding_window=1024,
    local_global_period=6,  # layers 5, 11, 17, ... are global
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    sandwich_norm=True,
    tie_embeddings=True,
    max_seq_len=131072 * 8,
    optimizer="adamw",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="gemma3-reduced",
        n_layers=7,  # exercises the 5:1 pattern + a tail local layer
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        sliding_window=16,
        local_global_period=3,
        max_seq_len=512,
        param_dtype="float32",
        act_dtype="float32",
    )
