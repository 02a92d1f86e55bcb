"""RWKV-6 (Finch) 7B [arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b].

32L d_model=4096 (attention-free), 64 WKV heads x head_dim 64 with
data-dependent decay (low-rank), channel-mix d_ff=14336, vocab=65536.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=14336,
    vocab_size=65536,
    attn_kind="none",
    pos_kind="none",
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_state=64,
    norm_kind="layernorm",
    max_seq_len=1 << 20,
    optimizer="adamw",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="rwkv6-reduced",
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        ssm_heads=4,
        ssm_head_dim=16,
        ssm_state=16,
        max_seq_len=512,
        param_dtype="float32",
        act_dtype="float32",
    )
