"""Llama-4 Scout 17B-active / 16 experts [hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) d_ff(expert)=8192 vocab=202048, MoE 16 experts
top-1 + 1 shared expert, early fusion (text + image tokens share the stack).

Deviation (DESIGN.md §5): uniform MoE layers (released model interleaves
dense/MoE); shared-expert and top-1 routing semantics preserved.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    attn_kind="gqa",
    n_experts=16,
    n_shared_experts=1,
    moe_top_k=1,
    d_ff_expert=8192,
    rope_theta=500_000.0,
    norm_kind="rmsnorm",
    max_seq_len=131072,
    optimizer="adamw",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="llama4-scout-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=96,
        d_ff_expert=96,
        vocab_size=256,
        n_experts=4,
        n_shared_experts=1,
        moe_top_k=1,
        max_seq_len=512,
        param_dtype="float32",
        act_dtype="float32",
    )
