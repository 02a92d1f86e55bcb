"""BLOOM-176B — the paper's evaluation model (BigScience, ref [3]).

70 transformer blocks, d_model=14336, 112 MHA heads (head_dim 128),
d_ff=57344, vocab=250880, ALiBi positions, LayerNorm, tied embeddings.

Used by the BPRR simulator and benchmarks to reproduce the paper's numbers
(L=70 blocks; s_c = 2*d_model*(l_in+l_out)*dtype_bytes per block per session).
Not part of the assigned 40 dry-run cells.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="bloom-176b",
    family="dense",
    n_layers=70,
    d_model=14336,
    n_heads=112,
    n_kv_heads=112,
    head_dim=128,
    d_ff=57344,
    vocab_size=250880,
    attn_kind="gqa",
    pos_kind="alibi",
    norm_kind="layernorm",
    tie_embeddings=True,
    max_seq_len=2048,
    optimizer="adamw",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="bloom-reduced",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
        max_seq_len=512,
        param_dtype="float32",
        act_dtype="float32",
    )
