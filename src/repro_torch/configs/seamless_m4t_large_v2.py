"""SeamlessM4T-large v2 [arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large].

Encoder-decoder backbone: 24 encoder + 24 decoder layers, d_model=1024,
16H (MHA kv=16, head_dim=64), d_ff=8192, vocab=256206.  "24L" in the
assignment table names the per-stack depth; the BPRR chain has
n_layers = 48 blocks (24 enc then 24 dec).

The speech frontend (fbank + conv subsampling) is a stub per the assignment:
``input_specs()`` provides precomputed frame embeddings of dim ``frame_dim``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=48,
    n_enc_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    attn_kind="gqa",
    rope_theta=10_000.0,
    norm_kind="layernorm",
    frontend="frames",
    frame_dim=160,
    max_seq_len=32768,
    optimizer="adamw",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="seamless-reduced",
        n_layers=4,
        n_enc_layers=2,
        n_dec_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        frame_dim=24,
        max_seq_len=512,
        param_dtype="float32",
        act_dtype="float32",
    )
