"""Chameleon 34B [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=22016 vocab=65536;
early-fusion VLM: VQ-VAE image tokens share the text vocabulary, so the
backbone is a plain decoder-only LM over mixed token streams.  QK-norm
(Chameleon's training-stability fix).

The modality frontend (VQ tokenizer) is a stub per the assignment:
``input_specs()`` provides already-tokenized mixed sequences.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    attn_kind="gqa",
    qk_norm=True,
    rope_theta=10_000.0,
    norm_kind="rmsnorm",
    max_seq_len=32768,
    optimizer="adamw",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="chameleon-reduced",
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
